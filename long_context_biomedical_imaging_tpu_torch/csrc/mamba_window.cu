// Fused Mamba window mixer (K4), forward, for windows of 16 to 64 tokens:
//     out = [x +] out_proj([y | z]),  y = scan(x_proj(x), x) + D x,
//     x | z = SiLU(conv3_same(in_proj([LN](x))))          (see mamba_window.cuh)
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/mamba_window.py
// _make_fwd_kernel (launched by _fwd through _mixer_core_ln and _mixer_core,
// entry mamba_window_mixer).
//
// What bounds it on the H100: the two C x C projections are 4 T C^2 operations
// for T tokens on the tensor cores, x_proj and dt_proj 2 T (C/2)(R + 2N) + 2 T
// R (C/2) more, against 4 T C bytes of x in and out (bf16); the conv, SiLU,
// softplus and the scan (N exps a token and channel) are fp32 work of the
// same order. Once the chain stays on chip the products and the scan's
// latency bound it: the scan walks each window's tokens in order.
//
// The design (bf16), one block of 8 warps per tile of whole windows (64 rows
// or fewer: wb = 64 / V windows, halved until the tile fits), the chain in
// shared memory, only x read and out written:
//   - The rows arrive by 16-byte copies (zeros in the pad rows and columns)
//     beside the ring's first slices, and are LN'd in place in bf16.
//   - in_proj walks xz in chunks of 32 or 64 columns, first the x half, then
//     the z half: a chunk accumulates on mma.sync fragments in registers (a
//     warp per 16 x 16 tile) over win slices 64 to 128 deep, goes to shared
//     memory in fp32, and the conv and SiLU run an element a thread. An x chunk keeps x in
//     fp32 for the scan and rounded to bf16 as the A operand of x_proj, whose
//     (rows, R + 2N) sums accumulate in registers over the chunks, so the
//     per-thread FMA loops of x_proj are gone; a z chunk keeps z in bf16
//     (out_proj rounds it anyway) in the right half of [y | z].
//   - dt_proj is a small product on fragments (depth R padded to 32), its
//     epilogue adds 2 dt_bias and takes the softplus: delta is computed once
//     per token and channel, in fp32 where the rows were.
//   - The scan runs a thread group per (window, channel): L lanes (1 to 8, as
//     many as fill the block) each hold NP / L of the states in registers, and
//     y is their shuffle sum, so a tile of one 64-token window still puts
//     most of its 256 threads on the scan.
//   - out_proj runs in passes of 64 or 128 output columns on fragments in
//     registers over wout slabs 32 or 64 deep; the epilogue adds the residual
//     in fp32 and rounds once.
//   Every weight slice (win, wdbl, wdt, wout) comes through one ring of
//   cp.async copies with the tails past the true widths zeroed
//   (mlp_common.cuh stage16), a few stages ahead of the products; one
//   barrier a slice. The tiles by width (K4Cfg, utils/k34_tiles.py times the
//   alternatives) keep two blocks an SM up to C = 192; beyond, one block an
//   SM (the rows, [y | z] and x take 6 bytes a row and channel).
//
// fp32 (the tests' path), and bf16 where even one window's tile does not fit
// (V = 64 at C = 768 and beyond): the general kernel, one block per wb whole
// windows with the chain in shared memory, its products FMA loops in fp32
// over operands in T (no TF32), the scan a thread per (window, channel)
// computing delta per step. wb starts at 256 / V windows and halves until the
// tiles fit; where one window does not fit, the fp32 accumulator moves to a
// per-block global scratch, and where the rows do not fit either, they follow
// it (mamba_fwd_plan).
//
// Rounding, shared with the plain version: the products take operands in T
// and sum in fp32; LN, the conv, SiLU, softplus (expf, log1pf, threshold 20)
// and the scan in fp32; the output rounded once after the residual.
//
// Operands arrive prepared by the wrapper, as for the TPU kernel: wconv (3, C)
// the conv taps (tap j on token t-1+j), at (N, Dh) = A^T, dtb2 = 2 * dt_bias
// and dskip = D, all fp32. Every operand is at its true C and d_state N.
#include "mamba_window.cuh"
#include "mlp_common.cuh"   // stage16, the mma.sync fragments, cp.async

namespace lcbi {

// ---------------------------------------------------------------------------
// General kernel: fp32, and bf16 past the mma kernel's tiles
// ---------------------------------------------------------------------------

// u = conv3_same(xz) per window (zero outside it), s = SiLU(u), for windows
// [0, nwin) of V rows and channels [0, C); taps (3, C), tap j on row t-1+j.
// s may alias xz: each thread walks one column and has read rows t and t+1
// before it writes row t.
__device__ inline void conv3_silu(const float* xz, int ldx, float* s, int lds,
                                  const float* __restrict__ wconv, int nwin, int V, int C) {
  for (int p = threadIdx.x; p < nwin * C; p += kThreads) {
    const int w = p / C, c = p % C;
    const float w0 = wconv[c], w1 = wconv[C + c], w2 = wconv[2 * C + c];
    const float* xr = xz + (size_t)w * V * ldx + c;
    float* sr = s + (size_t)w * V * lds + c;
    float prev = 0.f, cur = xr[0];
    for (int t = 0; t < V; ++t) {
      const float next = t + 1 < V ? xr[(size_t)(t + 1) * ldx] : 0.f;
      const float u = cur * w1 + prev * w0 + next * w2;
      sr[(size_t)t * lds] = u * sigmoidf(u);
      prev = cur;
      cur = next;
    }
  }
}

// dbl[r, j] = sum_k rnd(s[r, k]) wdbl[k, j] for rows [0, rows), j < W: the
// x_proj product, as FMA loops.
template <typename T>
__device__ inline void x_proj(const float* s, int lds, const T* __restrict__ wdbl, float* dbl,
                              int ldd, int rows, int Dh, int W) {
  for (int p = threadIdx.x; p < rows * W; p += kThreads) {
    const int r = p / W, j = p % W;
    const float* sr = s + (size_t)r * lds;
    float a = 0.f;
    for (int k = 0; k < Dh; ++k) a = fmaf(rnd<T>(sr[k]), to_f32(wdbl[(size_t)k * W + j]), a);
    dbl[(size_t)r * ldd + j] = a;
  }
}

// dtv of channel d at one token: dt (the first R columns of its dbl row)
// rounded to T, times wdt[:, d], plus dtb2[d].
template <typename T>
__device__ __forceinline__ float dt_value(const float* db, const T* __restrict__ wdt, int R,
                                          int Dh, int d, float bias) {
  float a = 0.f;
  for (int r = 0; r < R; ++r) a = fmaf(rnd<T>(db[r]), to_f32(wdt[(size_t)r * Dh + d]), a);
  return a + bias;
}

// C[M x N] (fp32, ld ldc) = A[M x K] @ B[K x N], A (ld lda, shared or
// global) and B (ld ldb, global) in T, as common.cuh's fp32 gemm: a thread
// per output column of 8 rows, FMA loops over fp32 values of the operands.
// M a multiple of 8.
template <typename T>
__device__ void fma_gemm(float* Cm, int ldc, const T* A, int lda, const T* __restrict__ B,
                         int ldb, int M, int N, int K) {
  constexpr int R = 8;
  const int tasks = (M / R) * N;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int n = task % N, r0 = (task / N) * R;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float bv = to_f32(B[(size_t)k * ldb + n]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(to_f32(A[(size_t)(r0 + r) * lda + k]), bv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) Cm[(size_t)(r0 + r) * ldc + n] = acc[r];
  }
}

// Where a tile's arrays live: kShared all in shared memory; kAccGlobal the
// fp32 accumulator in global scratch; kRowsGlobal the rows (ys) too, so that
// only x_proj's columns stay in shared memory.
enum MambaFwdPlace { kShared = 0, kAccGlobal = 1, kRowsGlobal = 2 };

struct MambaFwdLayout {
  int lds, ldacc, ldd;
  size_t ys_bytes, dbl_bytes, acc_bytes;
  size_t smem, work;  // dynamic shared memory and global scratch a block
};

// A tile of rows_pad rows: in shared memory ys (unless kRowsGlobal), then
// dbl, then the fp32 accumulator (unless global); in a block's global
// scratch the accumulator, then ys.
__host__ __device__ inline MambaFwdLayout mamba_fwd_layout(int rows_pad, int C, int W, int elem,
                                                           int place) {
  MambaFwdLayout L;
  L.lds = C + 8;
  L.ldacc = C + 4;
  L.ldd = W;
  L.ys_bytes = align128((size_t)rows_pad * L.lds * elem);
  L.dbl_bytes = align128((size_t)rows_pad * L.ldd * 4);
  L.acc_bytes = align128((size_t)rows_pad * L.ldacc * 4);
  L.smem = L.dbl_bytes + (place < kRowsGlobal ? L.ys_bytes : 0) +
           (place < kAccGlobal ? L.acc_bytes : 0);
  L.work = (place >= kAccGlobal ? L.acc_bytes : 0) + (place >= kRowsGlobal ? L.ys_bytes : 0);
  return L;
}

struct MambaFwdPlan {
  int wb, place;            // wb == 0: the shape does not fit
  size_t smem, work_bytes;  // dynamic shared memory a block; global scratch in all
  long long blocks;
};

// The general kernel's tiling of BW windows: wb windows a block, from 256 /
// V, halving until the tile fits in shared memory. Where one window's fp32
// accumulator does not fit beside its rows (V = 64 at C = 768 in bf16, or C >
// 384 in fp32), the accumulator moves to a per-block scratch in global memory
// (mostly L2-resident); where the rows do not fit either (V = 64 at C > 832 in
// fp32: Swin-base without AMP), they follow it, and only x_proj's columns stay
// in shared memory.
inline MambaFwdPlan mamba_fwd_plan(int BW, int V, int C, int R, int N, int elem) {
  const size_t limit = (size_t)max_dynamic_smem();
  const int W = R + 2 * N;
  MambaFwdPlan P{0, 0, 0, 0, 0};
  for (int place = kShared; place <= kRowsGlobal; ++place) {
    auto layout = [&](int nw) { return mamba_fwd_layout(round_up16(nw * V), C, W, elem, place); };
    int wb = 256 / V;
    while (wb > 1 && layout(wb).smem > limit) wb /= 2;
    const MambaFwdLayout L = layout(wb);
    if (L.smem > limit) continue;
    P.wb = wb;
    P.place = place;
    P.smem = L.smem;
    P.blocks = (BW + wb - 1) / wb;
    P.work_bytes = (size_t)P.blocks * L.work;
    return P;
  }
  return P;
}

// kPlace (a MambaFwdPlace) is a template argument, so that the shared-memory
// variant keeps shared-memory addressing; NP the padded state count (states
// [N, NP) read as zeros).
template <typename T, int kPlace, int NP>
__global__ void __launch_bounds__(kThreads)
mamba_window_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                        const float* __restrict__ ln_b, const T* __restrict__ wxz,
                        const float* __restrict__ wconv, const T* __restrict__ wdbl,
                        const T* __restrict__ wdt, const float* __restrict__ dtb2,
                        const float* __restrict__ at, const float* __restrict__ dskip,
                        const T* __restrict__ wout, T* __restrict__ out,
                        unsigned char* __restrict__ work, int BW, int V, int C, int R, int N,
                        int wb, int rows_pad, int has_ln) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dh = C / 2, W = R + 2 * N;
  const MambaFwdLayout L = mamba_fwd_layout(rows_pad, C, W, sizeof(T), kPlace);
  unsigned char* sp = smem;
  unsigned char* gp = kPlace >= kAccGlobal ? work + (size_t)blockIdx.x * L.work : nullptr;
  float* acc = nullptr;                                  // xz -> s -> out_proj
  if constexpr (kPlace >= kAccGlobal) {
    acc = reinterpret_cast<float*>(gp);
    gp += L.acc_bytes;
  }
  T* ys;                                                 // LN'd rows, then [y | z]
  if constexpr (kPlace >= kRowsGlobal) {
    ys = reinterpret_cast<T*>(gp);
  } else {
    ys = reinterpret_cast<T*>(sp);
    sp += L.ys_bytes;
  }
  float* dbl = reinterpret_cast<float*>(sp);
  sp += L.dbl_bytes;
  if constexpr (kPlace < kAccGlobal) acc = reinterpret_cast<float*>(sp);

  const int w0 = blockIdx.x * wb;
  const int nwin = min(wb, BW - w0);
  const int rows = nwin * V;
  const size_t base = (size_t)w0 * V * C;
  const T* xt = x + base;

  layernorm_rows(xt, rows, rows_pad, C, ln_g, ln_b, has_ln, ys, L.lds);
  __syncthreads();
  fma_gemm(acc, L.ldacc, ys, L.lds, wxz, C, rows_pad, C, C);
  __syncthreads();
  conv3_silu(acc, L.ldacc, acc, L.ldacc, wconv, nwin, V, C);
  __syncthreads();
  x_proj<T>(acc, L.ldacc, wdbl, dbl, L.ldd, rows, Dh, W);
  // z into the right half of [y | z] (ys is dead; its pad rows stay zero)
  for (int i = threadIdx.x; i < rows * Dh; i += kThreads) {
    const int r = i / Dh, c = i % Dh;
    ys[(size_t)r * L.lds + Dh + c] = from_f32<T>(acc[(size_t)r * L.ldacc + Dh + c]);
  }
  __syncthreads();

  // the scan: one thread per (window, channel), tokens in order
  for (int p = threadIdx.x; p < nwin * Dh; p += kThreads) {
    const int w = p / Dh, d = p % Dh;
    float A[NP], h[NP];
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      A[n] = n < N ? at[n * Dh + d] : 0.f;
      h[n] = 0.f;
    }
    const float D = dskip[d], bias = dtb2[d];
    const size_t r0 = (size_t)w * V;
    for (int t = 0; t < V; ++t) {
      const float* db = dbl + (r0 + t) * L.ldd;
      const float delta = softplusf(dt_value<T>(db, wdt, R, Dh, d, bias));
      const float xv = acc[(r0 + t) * L.ldacc + d];
      const float dx = delta * xv;
      float y = 0.f;
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        const bool on = n < N;
        h[n] = expf(delta * A[n]) * h[n] + dx * (on ? db[R + n] : 0.f);
        y = fmaf(h[n], on ? db[R + N + n] : 0.f, y);
      }
      ys[(r0 + t) * L.lds + d] = from_f32<T>(y + xv * D);
    }
  }
  __syncthreads();
  fma_gemm(acc, L.ldacc, ys, L.lds, wout, C, rows_pad, C, C);
  __syncthreads();

  T* ot = out + base;
  for (int i = threadIdx.x; i < rows * C; i += kThreads) {
    const int r = i / C, c = i % C;
    float v = acc[(size_t)r * L.ldacc + c];
    if (has_ln) v += to_f32(xt[i]);
    ot[i] = from_f32<T>(v);
  }
}

template <typename T>
int launch_general(const void* x, const void* ln_g, const void* ln_b, const void* wxz,
                   const void* wconv, const void* wdbl, const void* wdt, const void* dtb2,
                   const void* at, const void* dskip, const void* wout, void* out, void* work,
                   size_t work_bytes, int BW, int V, int C, int R, int N, int has_ln,
                   cudaStream_t stream) {
  const MambaFwdPlan P = mamba_fwd_plan(BW, V, C, R, N, sizeof(T));
  if (P.wb == 0 || P.work_bytes > work_bytes) return (int)cudaErrorInvalidValue;
  const bool wide = mamba_padded_state(N) == 16;
  auto kernel =
      P.place == kShared
          ? (wide ? mamba_window_fwd_kernel<T, kShared, 16> : mamba_window_fwd_kernel<T, kShared, 8>)
      : P.place == kAccGlobal
          ? (wide ? mamba_window_fwd_kernel<T, kAccGlobal, 16>
                  : mamba_window_fwd_kernel<T, kAccGlobal, 8>)
          : (wide ? mamba_window_fwd_kernel<T, kRowsGlobal, 16>
                  : mamba_window_fwd_kernel<T, kRowsGlobal, 8>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)P.blocks, kThreads, P.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<const T*>(wxz), static_cast<const float*>(wconv), static_cast<const T*>(wdbl),
      static_cast<const T*>(wdt), static_cast<const float*>(dtb2), static_cast<const float*>(at),
      static_cast<const float*>(dskip), static_cast<const T*>(wout), static_cast<T*>(out),
      static_cast<unsigned char*>(work), BW, V, C, R, N, P.wb, round_up16(P.wb * V), has_ln);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: mma.sync fragments in registers
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;     // rows of a tile at most (whole windows)
constexpr int kSlabK = 32;       // depth of a staged wdt slab
constexpr int kDtCols = 64;      // dt_proj columns a slab

// The bf16 kernel's tiles by width class: CW in_proj columns a chunk (32 or
// 64), KS the depth of a staged win slice, CP out_proj's columns a pass
// (64 or 128), K2 the depth of a staged wout slab, RING the slots of the
// ring (RING - 1 stages ahead).
template <int CW_, int KS_, int CP_, int K2_, int RING_> struct K4Cfg {
  static constexpr int CW = CW_, KS = KS_, CP = CP_, K2 = K2_, RING = RING_;
  static constexpr int kLdZc = CW + 4;            // the fp32 in_proj chunk
  static constexpr int kLdWin = CW + 8;           // staged win slices
  static constexpr int kLdOut = CP + 8;           // staged wout slabs
  static constexpr int kZUnits = (kMmaRows / 16) * (CW / 16) / kWarps;   // 16 x 16 tiles a warp
  static constexpr int kOutNt = CP / 16;          // 8-column tiles a warp, of its half of a pass
  static_assert(CW % 32 == 0 && KS % 16 == 0 && CP % 32 == 0 && K2 % 16 == 0,
                "whole fragments");
};

struct MambaMmaLayout {
  int ld, ldf, ldd, ldt, wq, slot;   // ld: ys, [y | z]; ldf: xs, delta; ldd: dbl; ldt: dt
  size_t off_yz, off_xs, off_z, off_dt, off_ring, bytes;
};

// ys (BM, ld) bf16, later delta (BM, ldf) fp32 in its place; [y | z] (BM, ld)
// bf16; xs (BM, ldf) fp32; the fp32 in_proj chunk (BM, CW + 4), later dbl
// (BM, ldd) fp32 and dt (BM, ldt) bf16 in its place; the ring.
template <class Cf>
__host__ __device__ inline MambaMmaLayout mamba_mma_layout(int BM, int C, int R, int W) {
  MambaMmaLayout L;
  L.ld = round_up32(max(C, (C / 2 + Cf::CW - 1) / Cf::CW * Cf::CW)) + 8;   // x chunks' columns too
  L.ldf = C / 2 + 4;
  L.wq = round_up16(W);
  L.ldd = L.wq + 4;
  L.ldt = round_up32(R) + 8;
  const int sl = Cf::CW * (L.wq + 8), sw = Cf::KS * Cf::kLdWin, so = Cf::K2 * Cf::kLdOut;
  const int st = kSlabK * (kDtCols + 8);
  L.slot = max(max(sl, sw), max(so, st));
  const size_t ybytes = align128((size_t)BM * L.ld * 2);
  const size_t dbytes = align128((size_t)BM * L.ldd * 4), tbytes = (size_t)BM * L.ldt * 2;
  const size_t zbytes = (size_t)BM * Cf::kLdZc * 4;
  L.off_yz = ybytes;
  L.off_xs = L.off_yz + ybytes;
  L.off_z = L.off_xs + align128((size_t)BM * L.ldf * 4);
  L.off_dt = L.off_z + dbytes;
  L.off_ring = L.off_z + align128(max(zbytes, dbytes + tbytes));
  L.bytes = L.off_ring + align128((size_t)Cf::RING * L.slot * 2);
  return L;
}

// The shared memory and tile of the bf16 kernel: wb windows of V tokens
// (wb V <= 64, BM = wb V rounded up to 16 rows); wb = 0 where one window
// does not fit (the general kernel takes the shape).
struct MambaMmaPlan {
  int wb, bm;
  size_t bytes;
};

template <class Cf> inline MambaMmaPlan mamba_mma_plan(int V, int C, int R, int N) {
  const size_t limit = (size_t)max_dynamic_smem();
  for (int wb = kMmaRows / V; wb >= 1; wb /= 2) {
    const int bm = round_up16(wb * V);
    const size_t bytes = mamba_mma_layout<Cf>(bm, C, R, R + 2 * N).bytes;
    if (bytes <= limit) return MambaMmaPlan{wb, bm, bytes};
  }
  return MambaMmaPlan{0, 0, 0};
}

// The scan of the tile's nwin windows: a group of L lanes per (window,
// channel d), each holding NP / L states; y = C . h summed over the group by
// shuffles. Every thread walks every round, so the shuffles see whole warps.
// Tokens go 8 at a time (V % 8 == 0), unrolled: their loads, exps and sums
// overlap, and only the states' FMAs chain.
template <int NP, int L>
__device__ __forceinline__ void scan_groups(const float* xs, const float* delta, int ldf,
                                            const float* dbl, int ldd, bf16* yz, int ld,
                                            const float* __restrict__ at,
                                            const float* __restrict__ dskip, int nwin, int V,
                                            int Dh, int R, int N) {
  constexpr int S = NP / L;
  const int tasks = nwin * Dh * L, part = threadIdx.x % L;
  for (int b0 = 0; b0 < tasks; b0 += kThreads) {
    const int p = b0 + threadIdx.x;
    const bool live = p < tasks;
    const int q = live ? p / L : 0, w = q / Dh, d = q % Dh;
    float A[S], h[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int n = part * S + s;
      A[s] = live && n < N ? at[n * Dh + d] : 0.f;
      h[s] = 0.f;
    }
    const float D = live ? dskip[d] : 0.f;
    for (int t0 = 0; t0 < V; t0 += 8) {
#pragma unroll
      for (int tt = 0; tt < 8; ++tt) {
        const int r = w * V + t0 + tt;
        const float dl = delta[r * ldf + d], xv = xs[r * ldf + d];
        const float dx = dl * xv;
        const float* db = dbl + r * ldd + R;
        float y = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int n = part * S + s;
          const bool on = n < N;
          h[s] = expf(dl * A[s]) * h[s] + dx * (on ? db[n] : 0.f);
          y = fmaf(h[s], on ? db[N + n] : 0.f, y);
        }
#pragma unroll
        for (int o = L / 2; o > 0; o >>= 1) y += __shfl_xor_sync(0xffffffffu, y, o);
        if (live && part == 0) yz[r * ld + d] = __float2bfloat16(y + xv * D);
      }
    }
  }
}

template <int NP, class Cf>
__global__ void __launch_bounds__(kThreads, 2)
mamba_fwd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_g,
                     const float* __restrict__ ln_b, const bf16* __restrict__ wxz,
                     const float* __restrict__ wconv, const bf16* __restrict__ wdbl,
                     const bf16* __restrict__ wdt, const float* __restrict__ dtb2,
                     const float* __restrict__ at, const float* __restrict__ dskip,
                     const bf16* __restrict__ wout, bf16* __restrict__ out, int BW, int V, int C,
                     int R, int N, int wb, int BM, int has_ln) {
  constexpr int CW = Cf::CW, KS = Cf::KS, CP = Cf::CP, kZU = Cf::kZUnits, kNt = Cf::kOutNt;
  constexpr int kMRing = Cf::RING;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dh = C / 2, W = R + 2 * N;
  const MambaMmaLayout L = mamba_mma_layout<Cf>(BM, C, R, W);
  bf16* ys = reinterpret_cast<bf16*>(smem);
  float* delta = reinterpret_cast<float*>(smem);           // in ys' place, after in_proj
  bf16* yz = reinterpret_cast<bf16*>(smem + L.off_yz);
  float* xs = reinterpret_cast<float*>(smem + L.off_xs);
  float* zc = reinterpret_cast<float*>(smem + L.off_z);
  float* dbl = reinterpret_cast<float*>(smem + L.off_z);   // in zc's place, after in_proj
  bf16* dts = reinterpret_cast<bf16*>(smem + L.off_dt);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.off_ring);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int mtiles = BM / 16, Cs = round_up16(C);
  const long long w0 = (long long)blockIdx.x * wb;
  const int nwin = (int)min((long long)wb, (long long)BW - w0), rows = nwin * V;
  const size_t r0 = (size_t)w0 * V;

  // the stages of the ring: per x chunk its win slices and its wdbl slice,
  // per z chunk its win slices, dt_proj's (column slab, depth slab) pairs,
  // out_proj's (pass, depth slab) pairs
  const int nxc = (Dh + CW - 1) / CW, nks = (C + KS - 1) / KS;
  const int ndc = (Dh + kDtCols - 1) / kDtCols, ndk = (R + kSlabK - 1) / kSlabK;
  const int npass = (C + CP - 1) / CP, nk2 = (C + Cf::K2 - 1) / Cf::K2;
  const int s_x = nxc * (nks + 1), s_in = s_x + nxc * nks, s_dt = s_in + ndc * ndk;
  const int total = s_dt + npass * nk2;
  const bool vec_x = C % 8 == 0, vec_z = C % 16 == 0, vec_l = W % 8 == 0, vec_t = Dh % 8 == 0;
  auto prefetch = [&](int s) {
    bf16* dst = ring + (s % kMRing) * L.slot;
    if (s < s_in) {
      const bool xh = s < s_x;
      const int ch = xh ? s / (nks + 1) : nxc + (s - s_x) / nks;
      const int sub = xh ? s % (nks + 1) : (s - s_x) % nks;
      const int c0 = xh ? ch * CW : Dh + (ch - nxc) * CW;
      if (sub < nks) {     // win[sub KS + KS)[c0 + CW), masked at the half's end
        for (int e = threadIdx.x; e < KS * (CW / 8); e += kThreads) {
          const int r = e / (CW / 8), c = (e % (CW / 8)) * 8;
          stage16(dst + r * Cf::kLdWin + c, wxz, sub * KS + r, C, c0 + c, xh ? Dh : C, C,
                  xh ? vec_x : vec_z);
        }
      } else {             // wdbl[c0 + CW)[0, wq)
        for (int e = threadIdx.x; e < CW * (L.wq / 8); e += kThreads) {
          const int r = e / (L.wq / 8), c = (e % (L.wq / 8)) * 8;
          stage16(dst + r * (L.wq + 8) + c, wdbl, c0 + r, Dh, c, W, W, vec_l);
        }
      }
    } else if (s < s_dt) {  // wdt[kb 32 + 32)[cs 64 + 64)
      const int cs = (s - s_in) / ndk, kb = (s - s_in) % ndk;
      stage_slice16<kSlabK, kDtCols>(dst, kDtCols + 8, wdt, kb * kSlabK, R, cs * kDtCols, Dh, Dh,
                                     vec_t);
    } else {                // wout[kb K2 + K2)[p CP + CP)
      const int p = (s - s_dt) / nk2, kb = (s - s_dt) % nk2;
      stage_slice16<Cf::K2, CP>(dst, Cf::kLdOut, wout, kb * Cf::K2, C, p * CP, C, C, vec_x);
    }
  };
  int s = 0;
  auto next = [&]() -> const bf16* {
    // stage s is in; the slot of stage s + kMRing - 1 was last read at s - 1
    cp_async_wait<kMRing - 2>();
    __syncthreads();
    if (s + kMRing - 1 < total) prefetch(s + kMRing - 1);
    cp_async_commit();
    return ring + (s++ % kMRing) * L.slot;
  };
  // the rows by 16-byte copies (zeros past C and past the tile's windows),
  // then the ring's heads; the LN runs in place once the rows are in
  stage_rows16(ys, L.ld, x + r0 * C, 0, rows, BM, C, Cs, vec_x);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kMRing - 1; ++i) {
    if (i < total) prefetch(i);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < BM * (L.ld - C); i += kThreads)
    yz[(i / (L.ld - C)) * L.ld + C + i % (L.ld - C)] = __float2bfloat16(0.f);
  cp_async_wait<kMRing - 1>();
  __syncthreads();
  layernorm_rows_inplace(ys, L.ld, rows, C, ln_g, ln_b, has_ln);

  // x_proj's (BM, wq) sums: units (m-tile, 16-column pair), unit u = warp +
  // 8 i, in registers over the x chunks
  const int npair = L.wq / 16, units = mtiles * npair;
  float dacc[3][2][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[i][j][e] = 0.f;

  for (int ch = 0; ch < 2 * nxc; ++ch) {
    const bool xh = ch < nxc;
    const int c0 = (xh ? ch : ch - nxc) * CW;   // within its half
    // in_proj: units (m-tile, 16-column pair) of the (BM, CW) chunk, u = warp + 8 i
    float za[kZU][2][4] = {};
    for (int sub = 0; sub < nks; ++sub) {
      const bf16* sl = next();
      const int k0 = sub * KS, kw = min(KS, Cs - k0);
#pragma unroll
      for (int i = 0; i < kZU; ++i) {
        const int u = warp + kWarps * i, mt = u % 4, n0 = (u / 4) * 16;
        if (mt >= mtiles) continue;
        for (int kk = 0; kk < kw; kk += 16) {
          uint32_t a[4], b[4];
          frag_a(a, ys, L.ld, mt * 16, k0 + kk, lane);
          frag_b_cols(b, sl, Cf::kLdWin, kk, n0, lane);
          mma_bf16(za[i][0], a, b[0], b[1]);
          mma_bf16(za[i][1], a, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kZU; ++i) {
      const int u = warp + kWarps * i, mt = u % 4, n0 = (u / 4) * 16;
      if (mt >= mtiles) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(zc + (mt * 16 + g + 8 * hh) * Cf::kLdZc + n0 + j * 8 +
                                     2 * t4) = make_float2(za[i][j][2 * hh], za[i][j][2 * hh + 1]);
    }
    __syncthreads();
    // conv3 (zero outside the window) and SiLU, an element a thread: thread
    // i keeps column i % CW (CW divides the block), its taps in registers
    {
      const int j = threadIdx.x % CW, c = c0 + j, col = xh ? c : Dh + c;
      const bool cl = c < Dh;
      const float w0 = cl ? wconv[col] : 0.f, w1 = cl ? wconv[C + col] : 0.f;
      const float w2 = cl ? wconv[2 * C + col] : 0.f;
      constexpr int kStep = kThreads / CW;   // rows a round; kStep <= 8 < V
      int t = (threadIdx.x / CW) % V;          // the row's token, kept without divisions
#pragma unroll
      for (int k = 0; k < kMmaRows / kStep; ++k, t = t + kStep >= V ? t + kStep - V : t + kStep) {
        const int r = threadIdx.x / CW + k * kStep;
        if (r >= BM) break;
        float sv = 0.f;
        if (cl && r < rows) {
          const float* zr = zc + r * Cf::kLdZc + j;
          const float cur = zr[0];
          const float prev = t > 0 ? zr[-Cf::kLdZc] : 0.f;
          const float nxt = t + 1 < V ? zr[Cf::kLdZc] : 0.f;
          const float u = cur * w1 + prev * w0 + nxt * w2;
          sv = u * sigmoidf(u);
          if (xh) xs[r * L.ldf + c] = sv;
        }
        if (xh) {
          yz[r * L.ld + c] = __float2bfloat16(sv);   // x_proj's operand (the scan overwrites it)
        } else if (cl) {
          yz[r * L.ld + Dh + c] = __float2bfloat16(sv);
        }
      }
    }
    if (xh) {
      // dbl += x[:, c0 + CW) wdbl[c0 + CW)
      const bf16* sl = next();
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int u = warp + kWarps * i;
        if (u >= units) break;
        const int mt = u % mtiles, pr = u / mtiles;
#pragma unroll
        for (int kk = 0; kk < CW; kk += 16) {
          uint32_t a[4], b[4];
          frag_a(a, yz, L.ld, mt * 16, c0 + kk, lane);
          frag_b_cols(b, sl, L.wq + 8, kk, pr * 16, lane);
          mma_bf16(dacc[i][0], a, b[0], b[1]);
          mma_bf16(dacc[i][1], a, b[2], b[3]);
        }
      }
    }
  }
  __syncthreads();   // the last chunk's conv has read zc: dbl and dt go in its place
  // dbl to shared memory in fp32, its dt columns rounded to bf16 (zeros to
  // the depth of dt_proj's slabs)
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int u = warp + kWarps * i;
    if (u >= units) break;
    const int mt = u % mtiles, pr = u / mtiles;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = mt * 16 + g + 8 * hh, col = pr * 16 + j * 8 + 2 * t4;
        const float v0 = dacc[i][j][2 * hh], v1 = dacc[i][j][2 * hh + 1];
        *reinterpret_cast<float2*>(dbl + r * L.ldd + col) = make_float2(v0, v1);
        if (col < L.ldt - 8)
          *reinterpret_cast<uint32_t*>(dts + r * L.ldt + col) =
              pack_bf16(col < R ? v0 : 0.f, col + 1 < R ? v1 : 0.f);
      }
  }
  for (int i = threadIdx.x; i < BM * (L.ldt - 8); i += kThreads) {
    const int r = i / (L.ldt - 8), c = i % (L.ldt - 8);
    if (c >= L.wq) dts[r * L.ldt + c] = __float2bfloat16(0.f);
  }

  // dt_proj: delta = softplus(dt wdt + dtb2), by 64-column slabs; a warp per
  // (m-tile, 32 columns)
  const int omt = warp % 4, oh = warp / 4;
  const bool ow = omt < mtiles;
  for (int cs = 0; cs < ndc; ++cs) {
    float acc[4][4] = {};
    for (int kb = 0; kb < ndk; ++kb) {
      const bf16* sl = next();
      if (!ow) continue;
#pragma unroll
      for (int kk = 0; kk < kSlabK; kk += 16) {
        uint32_t a[4];
        frag_a(a, dts, L.ldt, omt * 16, kb * kSlabK + kk, lane);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t b[4];
          frag_b_cols(b, sl, kDtCols + 8, kk, oh * 32 + 16 * p, lane);
          mma_bf16(acc[2 * p], a, b[0], b[1]);
          mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
        }
      }
    }
    if (!ow) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = cs * kDtCols + oh * 32 + j * 8 + 2 * t4;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = omt * 16 + g + 8 * hh;
        if (col < Dh) delta[r * L.ldf + col] = softplusf(acc[j][2 * hh] + dtb2[col]);
        if (col + 1 < Dh) delta[r * L.ldf + col + 1] = softplusf(acc[j][2 * hh + 1] + dtb2[col + 1]);
      }
    }
  }
  __syncthreads();

  // the scan: as many lanes a (window, channel) as fill the block
  const int pairs = nwin * Dh;
#define K4_SCAN(LANES) \
  scan_groups<NP, LANES>(xs, delta, L.ldf, dbl, L.ldd, yz, L.ld, at, dskip, nwin, V, Dh, R, N)
  if (8 * pairs <= kThreads) {
    K4_SCAN(8);
  } else if (4 * pairs <= kThreads) {
    K4_SCAN(4);
  } else if (2 * pairs <= kThreads) {
    K4_SCAN(2);
  } else {
    K4_SCAN(1);
  }
#undef K4_SCAN

  // out_proj by passes of CP columns: a warp per (m-tile, CP / 2 columns)
  const bf16* xr = x + r0 * C;
  bf16* orow = out + r0 * C;
  for (int p = 0; p < npass; ++p) {
    float acc[kNt][4] = {};
    const int cb = p * CP + oh * (CP / 2);
    for (int kb = 0; kb < nk2; ++kb) {
      const bf16* sl = next();   // its barrier also orders the scan's y before these reads
      if (!ow) continue;
      const int k0 = kb * Cf::K2, kw = min(Cf::K2, Cs - k0);
      for (int kk = 0; kk < kw; kk += 16) {
        uint32_t a[4];
        frag_a(a, yz, L.ld, omt * 16, k0 + kk, lane);
#pragma unroll
        for (int q = 0; q < kNt / 2; ++q) {
          if (cb + 16 * q >= C) break;   // staged zeros: nothing to add
          uint32_t b[4];
          frag_b_cols(b, sl, Cf::kLdOut, kk, oh * (CP / 2) + 16 * q, lane);
          mma_bf16(acc[2 * q], a, b[0], b[1]);
          mma_bf16(acc[2 * q + 1], a, b[2], b[3]);
        }
      }
    }
    if (!ow) continue;
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      const int col = cb + j * 8 + 2 * t4;
      if (col >= C) continue;   // C is even: col + 1 < C too
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = omt * 16 + g + 8 * hh;
        if (r >= rows) continue;
        float v0 = acc[j][2 * hh], v1 = acc[j][2 * hh + 1];
        if (has_ln) {
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(xr + r * C + col);
          v0 += __low2float(xv);
          v1 += __high2float(xv);
        }
        *reinterpret_cast<uint32_t*>(orow + r * C + col) = pack_bf16(v0, v1);
      }
    }
  }
  cp_async_wait<0>();
}

template <class Cf>
int launch_mma(const MambaMmaPlan& P, const void* x, const void* ln_g, const void* ln_b,
               const void* wxz, const void* wconv, const void* wdbl, const void* wdt,
               const void* dtb2, const void* at, const void* dskip, const void* wout, void* out,
               int BW, int V, int C, int R, int N, int has_ln, cudaStream_t stream) {
  auto kernel = mamba_padded_state(N) == 16 ? mamba_fwd_mma_kernel<16, Cf>
                                            : mamba_fwd_mma_kernel<8, Cf>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((BW + P.wb - 1) / P.wb), kThreads, P.bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(wxz),
      static_cast<const float*>(wconv), static_cast<const bf16*>(wdbl),
      static_cast<const bf16*>(wdt), static_cast<const float*>(dtb2),
      static_cast<const float*>(at), static_cast<const float*>(dskip),
      static_cast<const bf16*>(wout), static_cast<bf16*>(out), BW, V, C, R, N, P.wb, P.bm,
      has_ln);
  return (int)cudaGetLastError();
}

// The bf16 kernel's tile by width: wide chunks, deep slices and wide
// out_proj passes (fewer staged slices, fewer barriers) up to C = 96, where
// two blocks an SM still fit; narrower ones up to C = 192 to keep two
// blocks an SM; beyond, one block an SM, wide again.
using K4Narrow = K4Cfg<64, 96, 128, 32, 3>;   // C <= 96
using K4Mid = K4Cfg<32, 64, 64, 32, 3>;       // C <= 192
using K4Wide = K4Cfg<64, 128, 128, 64, 3>;    // C > 192

// The bf16 kernel's plan for the shape (wb = 0: it does not fit).
inline MambaMmaPlan mma_plan(int V, int C, int R, int N) {
  if (C <= 96) return mamba_mma_plan<K4Narrow>(V, C, R, N);
  if (C <= 192) return mamba_mma_plan<K4Mid>(V, C, R, N);
  return mamba_mma_plan<K4Wide>(V, C, R, N);
}

}  // namespace lcbi

// Bytes of global scratch the forward needs for BW windows of V tokens at C
// channels, dt rank R and N states (0 where its tiles fit in shared memory),
// or -1 where it cannot take the shape.
extern "C" long long lcbi_mamba_window_fwd_workspace(int BW, int V, int C, int R, int N,
                                                     int is_bf16) {
  if (!lcbi::mamba_shape_ok(BW, V, C, R, N)) return -1;
  if (is_bf16 && lcbi::mma_plan(V, C, R, N).wb > 0) return 0;
  const lcbi::MambaFwdPlan P = lcbi::mamba_fwd_plan(BW, V, C, R, N, is_bf16 ? 2 : 4);
  return P.wb == 0 ? -1 : (long long)P.work_bytes;
}

// x, out: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); wxz, wout: (C, C),
// wdbl: (C/2, R + 2N) and wdt: (R, C/2) in T; wconv: (3, C), at: (N, C/2),
// dtb2, dskip: (C/2,) fp32; if has_ln, ln_g, ln_b: (C,) fp32; every operand
// at its true C and d_state N (1 <= N <= 16, run at a padded state count of 8
// or 16). work: work_bytes of global scratch, at least
// lcbi_mamba_window_fwd_workspace (NULL where that is 0). 16 <= V <= 64 with
// V % 8 == 0, C even, 1 <= R <= 64, all pointers 16-byte aligned. Returns
// cudaGetLastError() of the launch (or cudaErrorInvalidValue for a shape the
// workspace query refuses).
extern "C" int lcbi_mamba_window_fwd(const void* x, const void* ln_g, const void* ln_b,
                                     const void* wxz, const void* wconv, const void* wdbl,
                                     const void* wdt, const void* dtb2, const void* at,
                                     const void* dskip, const void* wout, void* out, void* work,
                                     long long work_bytes, int BW, int V, int C, int R, int N,
                                     int has_ln, int is_bf16, void* stream) {
  (void)cudaGetLastError();
  if (!lcbi::mamba_shape_ok(BW, V, C, R, N) || work_bytes < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t wbytes = (size_t)work_bytes;
  if (is_bf16) {
    const lcbi::MambaMmaPlan P = lcbi::mma_plan(V, C, R, N);
#define K4_MMA(CFG)                                                                          \
  lcbi::launch_mma<lcbi::CFG>(P, x, ln_g, ln_b, wxz, wconv, wdbl, wdt, dtb2, at, dskip, wout, \
                              out, BW, V, C, R, N, has_ln, s)
    if (P.wb > 0) return C <= 96 ? K4_MMA(K4Narrow) : C <= 192 ? K4_MMA(K4Mid) : K4_MMA(K4Wide);
#undef K4_MMA
    return lcbi::launch_general<__nv_bfloat16>(x, ln_g, ln_b, wxz, wconv, wdbl, wdt, dtb2, at,
                                               dskip, wout, out, work, wbytes, BW, V, C, R, N,
                                               has_ln, s);
  }
  return lcbi::launch_general<float>(x, ln_g, ln_b, wxz, wconv, wdbl, wdt, dtb2, at, dskip, wout,
                                     out, work, wbytes, BW, V, C, R, N, has_ln, s);
}
