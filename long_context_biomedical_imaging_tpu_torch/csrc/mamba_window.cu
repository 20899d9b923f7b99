// Fused Mamba window mixer (K4), forward, for windows of 16 to 64 tokens:
//     out = [x +] out_proj([y | z]),  y = scan(x_proj(x), x) + D x,
//     x | z = SiLU(conv3_same(in_proj([LN](x))))          (see mamba_window.cuh)
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/mamba_window.py
// _make_fwd_kernel (launched by _fwd through _mixer_core_ln and _mixer_core,
// entry mamba_window_mixer).
//
// What bounds it on the H100: the two C x C projections are 4*T*C^2 FLOPs for
// T tokens against 4*T*C bytes of x in and out (bf16), about 2*C/2 FLOPs a
// byte (96 to 384), under the card's ~295, so device memory bounds it; the
// composed chain streams xz, the convolved stream, x_proj's output, dt, the
// scan's y and [y | z] through memory. What the design does about it: a block
// owns wb whole windows (every step acts within a window) and keeps the whole
// chain in shared memory: the (LN'd) rows in T, the in_proj product in fp32
// (convolved and gated in place), x_proj's W columns, then [y | z] in T where
// the rows were, and out_proj's product back into the fp32 tile. Only x is
// read and out written. The scan runs one thread per (window, channel) over
// the window's tokens in order, its NP (8 or 16) states in registers, computing
// delta and exp(delta A) per step (no (V, N, Dh) tensor exists). The TPU
// kernel's 0/1 expander products and channel chunks are a TPU lane-layout
// device and a VMEM limit, and are not copied. wb starts at 256 / V windows
// and halves until the tiles fit in shared memory (C = 384 in fp32 takes one
// window of 64 tokens, 205 KB); where one window does not fit, the fp32
// accumulator moves to global scratch, and where the rows do not fit either,
// they follow it (mamba_fwd_plan).
//
// Operands arrive prepared by the wrapper, as for the TPU kernel: wconv (3, C)
// the conv taps (tap j on token t-1+j), at (N, Dh) = A^T, dtb2 = 2 * dt_bias
// and dskip = D, all fp32.
#include "mamba_window.cuh"

namespace lcbi {

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

// The forward's tiling of BW windows: wb windows a block, from 256 / V,
// halving until the tile fits in shared memory. Where one window's fp32
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
// variant keeps shared-memory addressing; NP the padded state count.
template <typename T, int kPlace, int NP>
__global__ void __launch_bounds__(kThreads)
mamba_window_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                        const float* __restrict__ ln_b, const T* __restrict__ wxz,
                        const float* __restrict__ wconv, const T* __restrict__ wdbl,
                        const T* __restrict__ wdt, const float* __restrict__ dtb2,
                        const float* __restrict__ at, const float* __restrict__ dskip,
                        const T* __restrict__ wout, T* __restrict__ out,
                        unsigned char* __restrict__ work, int BW, int V, int Ct, int R, int wb,
                        int rows_pad, int has_ln) {
  const int C = chunk_padded_channels(Ct);  // the padded width (mamba_window.cuh)
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dh = C / 2, W = R + 2 * NP;
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
  const size_t base = (size_t)w0 * V * Ct;
  const T* xt = x + base;

  layernorm_rows(xt, rows, rows_pad, Ct, ln_g, ln_b, has_ln, ys, L.lds, nullptr, nullptr, C);
  __syncthreads();
  gemm_tile(acc, L.ldacc, ys, L.lds, wxz, C, rows_pad, C, C, false);
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
      A[n] = at[n * Dh + d];
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
        h[n] = expf(delta * A[n]) * h[n] + dx * db[R + n];
        y = fmaf(h[n], db[R + NP + n], y);
      }
      ys[(r0 + t) * L.lds + d] = from_f32<T>(y + xv * D);
    }
  }
  __syncthreads();
  gemm_tile(acc, L.ldacc, ys, L.lds, wout, C, rows_pad, C, C, false);
  __syncthreads();

  T* ot = out + base;
  for (int i = threadIdx.x; i < rows * Ct; i += kThreads) {
    const int r = i / Ct, c = i % Ct;
    float v = acc[(size_t)r * L.ldacc + c];
    if (has_ln) v += to_f32(xt[i]);
    ot[i] = from_f32<T>(v);
  }
}

template <typename T>
int launch(const void* x, const void* ln_g, const void* ln_b, const void* wxz, const void* wconv,
           const void* wdbl, const void* wdt, const void* dtb2, const void* at, const void* dskip,
           const void* wout, void* out, void* work, size_t work_bytes, int BW, int V, int C, int R,
           int N, int has_ln, cudaStream_t stream) {
  const MambaFwdPlan P = mamba_fwd_plan(BW, V, chunk_padded_channels(C), R, N, sizeof(T));
  if (P.wb == 0 || P.work_bytes > work_bytes) return (int)cudaErrorInvalidValue;
  const bool wide = N == 16;
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
      static_cast<unsigned char*>(work), BW, V, C, R, P.wb, round_up16(P.wb * V), has_ln);
  return (int)cudaGetLastError();
}

}  // namespace lcbi

// The padded width this library's kernels run on (common.cuh): the wrapper
// lays the weights, taps and biases out at it.
extern "C" int lcbi_padded_channels(int C) { return lcbi::chunk_padded_channels(C); }

// Bytes of global scratch the forward needs for BW windows of V tokens at C
// channels, dt rank R and N states (0 where its tiles fit in shared memory),
// or -1 where it cannot take the shape.
extern "C" long long lcbi_mamba_window_fwd_workspace(int BW, int V, int C, int R, int N,
                                                     int is_bf16) {
  if (!lcbi::mamba_shape_ok(BW, V, C, R, N) || N != lcbi::mamba_padded_state(N)) return -1;
  const lcbi::MambaFwdPlan P =
      lcbi::mamba_fwd_plan(BW, V, lcbi::chunk_padded_channels(C), R, N, is_bf16 ? 2 : 4);
  return P.wb == 0 ? -1 : (long long)P.work_bytes;
}

// x, out: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); with Cp = C
// rounded up to 32 and every C/2 block padded with zeros to Cp/2 (see
// mamba_window.cuh): wxz, wout: (Cp, Cp), wdbl: (Cp/2, R + 2N) and wdt: (R,
// Cp/2) in T; wconv: (3, Cp), at: (N, Cp/2), dtb2, dskip: (Cp/2,) fp32; if
// has_ln, ln_g, ln_b: (C,) fp32. N is the padded state count, 8 or 16: the
// wrapper pads at's rows and wdbl's B and C blocks with zeros from the true
// d_state (a padded state stays 0). work: work_bytes of global scratch, at
// least lcbi_mamba_window_fwd_workspace (NULL where that is 0). 16 <= V <= 64
// with V % 8 == 0, C even, 1 <= R <= 64, all pointers 32-byte aligned.
// Returns cudaGetLastError() of the launch (or cudaErrorInvalidValue for a
// shape the workspace query refuses).
extern "C" int lcbi_mamba_window_fwd(const void* x, const void* ln_g, const void* ln_b,
                                     const void* wxz, const void* wconv, const void* wdbl,
                                     const void* wdt, const void* dtb2, const void* at,
                                     const void* dskip, const void* wout, void* out, void* work,
                                     long long work_bytes, int BW, int V, int C, int R, int N,
                                     int has_ln, int is_bf16, void* stream) {
  (void)cudaGetLastError();
  if (!lcbi::mamba_shape_ok(BW, V, C, R, N) || N != lcbi::mamba_padded_state(N) || work_bytes < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t wbytes = (size_t)work_bytes;
  if (is_bf16)
    return lcbi::launch<__nv_bfloat16>(x, ln_g, ln_b, wxz, wconv, wdbl, wdt, dtb2, at, dskip, wout,
                                       out, work, wbytes, BW, V, C, R, N, has_ln, s);
  return lcbi::launch<float>(x, ln_g, ln_b, wxz, wconv, wdbl, wdt, dtb2, at, dskip, wout, out,
                             work, wbytes, BW, V, C, R, N, has_ln, s);
}
