// Fused Mamba window mixer (K4), backward, for windows of 16 to 64 tokens:
//     out = [x +] out_proj([y | z]) (see mamba_window.cuh)
//     -> dx, [d ln_g, d ln_b,] dwxz, dwconv, dwdbl, dwdt, d dtb2, d at, d dskip, dwout
//     given do = d out
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/mamba_window.py
// _make_bwd_kernel (launched by _bwd_impl, the custom VJP of _mixer_core and
// _mixer_core_ln, entry mamba_window_mixer).
//
// What bounds it on the H100: the products (in_proj recomputed, gyz = do
// wout^T, dxin = dxz wxz^T and the weight gradients dwxz, dwout: 10 T C^2
// operations for T tokens on the tensor cores) against about 6 T C bytes of
// x, do in and dx out (bf16); between them the scan's fp32 work, about 40 T
// (C/2) N operations. The TPU kernel sums its weight gradients in place over
// its sequential grid and keeps a tile's intermediates in VMEM. This kernel's
// first design kept about ten (rows, C) intermediates per tile in a per-block
// global scratch and summed dwxz and dwout per tile into global slots.
//
// The design, for Hopper, in passes on the stream, each keeping what it
// computes on chip and handing the next pass a stream written once:
//   1. y = LN(x) in T (with the folded LN; else y is x).
//   2. xz = y wxz and gyz = do wout^T in fp32 (mma_gemm.cuh gemm_rows: the
//      tensor cores, weights staged through shared memory with masked tails).
//   3. The scan pass, per tile of tw whole windows and a chunk of ch of the
//      C/2 scan channels (grid: a persistent walk over the tiles x the
//      chunks; tw as many windows as fill 256 threads and shared memory):
//      xz staged by 32 columns with coalesced loads, x = SiLU(conv(xz)) an
//      element a thread, and x_proj (dbl = x wdbl, on the tensor cores in
//      shared memory, W padded to 16) over all channels, dt and dtv
//      = dt wdt once per token and channel (a product in shared memory, kept
//      there), then one thread per (window, channel) runs the scan forward
//      with its NP states in registers, checkpointing h every 16 tokens in
//      shared memory, and backward by blocks of 8 tokens, each block's h
//      recomputed from its checkpoint in groups of 8 states (no spill); the
//      cross-channel sums of dB and dC per token are a warp reduce-scatter
//      (31 shuffles for 32 values), one partial per warp. Out: y (the left
//      half of [y | z]), ddtv and x in T (the dwdt and dwdbl operands), dt in
//      T, the scan's part of dx in fp32, the dB | dC partials. d at, d D and
//      d dtb2 accumulate in registers across the block's tiles.
//   4. The gate pass, per tile and chunk of either half: ddbl = [ddtv wdt^T
//      | sum of the dB | dC partials] (rows, W), dx = dx(scan) + ddbl wdbl^T
//      (both on the tensor cores in shared memory); the chunk's xz and the
//      gradient of its SiLU output staged with coalesced loads, then a thread
//      per (window, channel) walks the tokens once in shared memory,
//      recomputing the conv and SiLU: du, dxz = conv^T(du) in T; the z half
//      takes dz from gyz and writes z (the right half of [y | z]). dwconv
//      accumulates in registers.
//   5. dxin = dxz wxz^T (gemm_rows), then the LayerNorm backward with the
//      residual's do (ln_rows.cuh, on every slot's block), or dx = dxin.
//   6. dwxz = y^T dxz, dwout = [y | z]^T do, dwdt = dt^T ddtv and dwdbl =
//      x^T ddbl from the streams, split-K (mma_gemm.cuh wgrad).
// The small gradients (d at, d D, d dtb2, dwconv, d ln_g, d ln_b) go to one
// fp32 slot per block of a persistent grid, written once per block, summed
// by reduce_slots_kernel in a fixed order. No atomics: two
// launches give the same bits. Operands of every product are rounded to T
// where the TPU kernel rounds them; everything else is fp32. The weights pass
// at the true C (no padded copy); any d_state N <= 16 runs at NP = 8 or 16.
#include "ln_rows.cuh"
#include "mamba_window.cuh"
#include "mma_gemm.cuh"

namespace lcbi {

constexpr int kZ = 32;              // channels per staging step of xz, ddtv (and x_proj's depth)
constexpr int kLdZ = kZ + 4;        // fp32 (rows, 32) staged xz
constexpr int kLdX = kZ + 8;        // T (rows, 32) staged operands

__host__ __device__ __forceinline__ int round_up8(int v) { return (v + 7) & ~7; }

// The scan's tiling: nch chunks of ch (of the C/2 channels), ch32 threads per
// window (ch rounded up to whole warps), tw windows a tile (as many as fill
// a block's 256 threads and fit both passes' shared memory, mamba_bwd_plan).
struct MambaTiles {
  int nch, ch, ch32, tw;
};

__host__ __device__ inline MambaTiles mamba_bwd_chunks(int Dh) {
  MambaTiles t;
  t.nch = (Dh + 127) / 128;
  t.ch = round_up8((Dh + t.nch - 1) / t.nch);
  t.ch32 = round_up32(t.ch);
  t.tw = 1;
  return t;
}

struct ScanLayout {
  int rows_pad, ld_s, ld_dt, ld_dbl, ld_w, ld_dtt, ld_wt;
  size_t off_dbl, off_u, off_ck, off_x, off_w, bytes;
};

// P1's shared memory: S (x of the chunk, fp32) and dbl (fp32) for the whole
// tile, then a union of the phases' arrays: while x_proj runs, the staged xz
// (rows, 32) fp32, x in T and the wdbl slice (32, W16); then Dt (dt wdt,
// fp32) beside, first, dt in T (rows, R16) and the wdt slice (R16, ch16),
// then the scan's checkpoints.
template <typename T>
__host__ __device__ inline ScanLayout scan_layout(const MambaTiles& tl, int V, int R, int W,
                                                  int NP) {
  ScanLayout L;
  const int ch16 = round_up16(tl.ch), w16 = round_up16(W), r16 = round_up16(R);
  L.rows_pad = round_up16(tl.tw * V);
  const size_t rp = L.rows_pad;
  L.ld_s = tl.ch;
  L.ld_dt = ch16 + 4;
  L.ld_dbl = w16 + 4;
  L.ld_w = w16 + 8;
  L.ld_dtt = r16 + 8;
  L.ld_wt = ch16 + 8;
  L.off_dbl = align128(rp * L.ld_s * 4);
  L.off_u = L.off_dbl + align128(rp * L.ld_dbl * 4);
  // phase x_proj: xz at off_u, x at off_x, wdbl at off_w
  L.off_x = L.off_u + align128(rp * kLdZ * 4);
  L.off_w = L.off_x + align128(rp * kLdX * sizeof(T));
  const size_t proj_end = L.off_w + align128((size_t)kZ * L.ld_w * sizeof(T));
  // phases dt and scan: Dt at off_u, then dt and wdt, later the checkpoints
  L.off_ck = L.off_u + align128(rp * L.ld_dt * 4);
  const size_t dt_end = L.off_ck + align128(rp * L.ld_dtt * sizeof(T)) +
                        align128((size_t)r16 * L.ld_wt * sizeof(T));
  const size_t ck_end = L.off_ck + align128((size_t)3 * NP * tl.tw * tl.ch32 * 4);
  L.bytes = proj_end > dt_end ? proj_end : dt_end;
  if (ck_end > L.bytes) L.bytes = ck_end;
  // the end-of-kernel reduction of (tw ch32, NP + 2) floats goes over S onward
  const size_t red = (size_t)tl.tw * tl.ch32 * (NP + 2) * 4;
  if (red > L.bytes) L.bytes = red;
  return L;
}

struct GateLayout {
  int rows_pad, ld_dbl, ld_dblt, ld_dx, ld_wb;
  size_t off_dblt, off_x, off_wd, off_dx, off_wb, off_zg, bytes;
};

// P2's shared memory: ddbl (fp32) and in T, the staged ddtv (rows, 32) and
// wdt slice (R16, 32), dx of the chunk (fp32, rows x ch16; then the gradient
// of the chunk's SiLU output), the wdbl slice of the chunk's channels (ch16,
// W16) and the chunk's xz columns (fp32, rows x ch).
template <typename T>
__host__ __device__ inline GateLayout gate_layout(const MambaTiles& tl, int V, int R, int W) {
  GateLayout L;
  const int ch16 = round_up16(tl.ch), w16 = round_up16(W), r16 = round_up16(R);
  L.rows_pad = round_up16(tl.tw * V);
  const size_t rp = L.rows_pad;
  L.ld_dbl = w16 + 4;
  L.ld_dblt = w16 + 8;
  L.ld_dx = ch16 + 4;
  L.ld_wb = w16 + 8;
  L.off_dblt = align128(rp * L.ld_dbl * 4);
  L.off_x = L.off_dblt + align128(rp * L.ld_dblt * sizeof(T));
  L.off_wd = L.off_x + align128(rp * kLdX * sizeof(T));
  L.off_dx = L.off_wd + align128((size_t)r16 * kLdX * sizeof(T));
  L.off_wb = L.off_dx + align128(rp * L.ld_dx * 4);
  L.off_zg = L.off_wb + align128((size_t)ch16 * L.ld_wb * sizeof(T));
  L.bytes = L.off_zg + align128(rp * tl.ch * 4);
  return L;
}

// The tiling of both passes: tw from 256 / ch32 windows down until both
// layouts fit in shared memory (tw = 0: they do not fit at one window).
template <typename T>
inline MambaTiles mamba_bwd_plan(int V, int Dh, int R, int W, int NP) {
  MambaTiles tl = mamba_bwd_chunks(Dh);
  const size_t limit = (size_t)max_dynamic_smem();
  for (tl.tw = kThreads / tl.ch32; tl.tw >= 1; --tl.tw) {
    if (scan_layout<T>(tl, V, R, W, NP).bytes <= limit &&
        gate_layout<T>(tl, V, R, W).bytes <= limit)
      return tl;
  }
  tl.tw = 0;
  return tl;
}

// Slot offsets (floats) of the small gradients inside one block's slot: the
// scan's and gate's first, the LayerNorm's (dg, dbln) last.
struct MambaSlots {
  int dwconv, ddtb, dat, dd, dg, dbln;
};

// The operands of the passes, and their streams.
template <typename T> struct MambaArgs {
  const T* x;
  const float* ln_g;
  const float* ln_b;
  const T* wxz;
  const float* wconv;
  const T* wdbl;
  const T* wdt;
  const float* dtb2;
  const float* at;
  const float* dskip;
  const T* wout;
  const T* dout;
  T* dx;
  // streams
  const T* ys;       // (rows, C): LN(x), or x
  float* xz;         // (rows, C) fp32: y wxz, later dxin
  float* gyz;        // (rows, C) fp32: do wout^T
  T* yz;             // (rows, C): [y | z]
  T* xs;             // (rows, Dh): x = SiLU(conv(xz))[:, :Dh]
  T* dts;            // (rows, R): dt
  T* ddtv;           // (rows, Dh)
  float* dxscan;     // (rows, Dh) fp32: the scan's part of dx
  float* bc;         // (slices, rows, 2 NP) fp32: dB | dC partials
  T* dxz;            // (rows, C)
  T* ddbl;           // (rows, W)
  float* slots;
  size_t P;
  MambaSlots off;
  int BW, V, C, R, N, has_ln;
};

// Reduce-scatter of K values (K = 16 or 32) over the 32 lanes of a warp: on
// return v[0] of lane l holds the warp's sum of value index l (K = 32) or l /
// 2 (K = 16). Fixed shuffle pattern: the same bits every time.
template <int K>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[K], int lane) {
  int n = K;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    if (n > 1) {
      const int half = n / 2;
      const bool upper = lane & o;
#pragma unroll
      for (int i = 0; i < K / 2; ++i) {
        if (i < half) {
          const float send = upper ? v[i] : v[i + half];
          const float keep = upper ? v[i + half] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      n = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
}

// x = SiLU(conv3_same(xz)) of channel k of window w's V rows, read down a
// column of the fp32 (rows, C) stream from the window's first row.
__device__ __forceinline__ float conv_at(const float* col, int t, int V, int C, float w0, float w1,
                                         float w2) {
  const float prev = t > 0 ? col[(size_t)(t - 1) * C] : 0.f;
  const float next = t + 1 < V ? col[(size_t)(t + 1) * C] : 0.f;
  return col[(size_t)t * C] * w1 + prev * w0 + next * w2;
}

// P1, the scan pass (the design note's pass 3). blockIdx.y is the chunk.
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_kernel(MambaArgs<T> a, MambaTiles tl, long long tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int V = a.V, C = a.C, Dh = C / 2, R = a.R, N = a.N, W = R + 2 * N;
  const ScanLayout L = scan_layout<T>(tl, V, R, W, NP);
  float* S = reinterpret_cast<float*>(smem);
  float* dbl = reinterpret_cast<float*>(smem + L.off_dbl);
  float* Zs = reinterpret_cast<float*>(smem + L.off_u);   // x_proj: the staged xz
  T* Xs = reinterpret_cast<T*>(smem + L.off_x);
  T* Ws = reinterpret_cast<T*>(smem + L.off_w);
  float* Dt = reinterpret_cast<float*>(smem + L.off_u);   // then dt wdt
  T* dtT = reinterpret_cast<T*>(smem + L.off_ck);
  T* Wt = reinterpret_cast<T*>(smem + L.off_ck + align128((size_t)L.rows_pad * L.ld_dtt * sizeof(T)));
  float* ck = reinterpret_cast<float*>(smem + L.off_ck);  // then the checkpoints
  const int w16 = round_up16(W), r16 = round_up16(R), ch16 = round_up16(tl.ch);
  const int c0 = blockIdx.y * tl.ch, cw = min(tl.ch, Dh - c0);
  const int nthr = tl.tw * tl.ch32, tid = threadIdx.x;
  const int sw = tid / tl.ch32, j = tid % tl.ch32, lane = tid % 32;
  const int c = c0 + j;
  const size_t nrows = (size_t)a.BW * V;
  const int slice = blockIdx.y * (tl.ch32 / 32) + j / 32;

  float dA[NP], dD = 0.f, ddtb = 0.f;
#pragma unroll
  for (int n = 0; n < NP; ++n) dA[n] = 0.f;

  const long long t_begin = tiles * blockIdx.x / gridDim.x;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const long long w0 = tile * tl.tw;
    const int nwin = (int)min((long long)tl.tw, (long long)a.BW - w0);
    const int rows = nwin * V;
    const size_t row0 = (size_t)w0 * V;
    const bool active = tid < nthr && sw < nwin && j < cw;

    // ---- x = SiLU(conv(xz)) over all channels; dbl = x wdbl ---------------
    // by 32 channels: xz staged with coalesced loads, then an element each
    for (int kc = 0; kc < Dh; kc += kZ) {
      for (int i = tid; i < L.rows_pad * kZ; i += kThreads) {
        const int r = i / kZ, k = i % kZ;
        Zs[r * kLdZ + k] = r < rows && kc + k < Dh ? a.xz[(row0 + r) * C + kc + k] : 0.f;
      }
      for (int i = tid; i < kZ * w16; i += kThreads) {
        const int k = i / w16, jj = i % w16;
        Ws[k * L.ld_w + jj] = kc + k < Dh && jj < W ? a.wdbl[(size_t)(kc + k) * W + jj]
                                                   : from_f32<T>(0.f);
      }
      __syncthreads();
      for (int i = tid; i < L.rows_pad * kZ; i += kThreads) {
        const int r = i / kZ, cc = i % kZ, k = kc + cc, t = r % V;
        float s = 0.f;
        if (r < rows && k < Dh) {
          const float u = Zs[r * kLdZ + cc] * a.wconv[C + k] +
                          (t > 0 ? Zs[(r - 1) * kLdZ + cc] : 0.f) * a.wconv[k] +
                          (t + 1 < V ? Zs[(r + 1) * kLdZ + cc] : 0.f) * a.wconv[2 * C + k];
          s = u * sigmoidf(u);
          if (k >= c0 && k < c0 + cw) {
            S[r * L.ld_s + k - c0] = s;
            a.xs[(row0 + r) * Dh + k] = from_f32<T>(s);
          }
        }
        Xs[r * kLdX + cc] = from_f32<T>(s);
      }
      __syncthreads();
      gemm<false, false>(dbl, L.ld_dbl, Xs, kLdX, Ws, L.ld_w, L.rows_pad, w16, kZ, kc > 0);
      __syncthreads();
    }

    // ---- dt (T) and Dt = dt wdt[:, chunk] ----------------------------------
    for (int i = tid; i < L.rows_pad * r16; i += kThreads) {
      const int r = i / r16, k = i % r16;
      const T v = from_f32<T>(k < R ? dbl[r * L.ld_dbl + k] : 0.f);
      dtT[r * L.ld_dtt + k] = v;
      if (blockIdx.y == 0 && k < R && r < rows) a.dts[(row0 + r) * R + k] = v;
    }
    for (int i = tid; i < r16 * ch16; i += kThreads) {
      const int k = i / ch16, jj = i % ch16;
      Wt[k * L.ld_wt + jj] =
          k < R && jj < cw ? a.wdt[(size_t)k * Dh + c0 + jj] : from_f32<T>(0.f);
    }
    __syncthreads();
    gemm<false, false>(Dt, L.ld_dt, dtT, L.ld_dtt, Wt, L.ld_wt, L.rows_pad, ch16, r16, false);
    __syncthreads();

    // ---- the scan: a thread per (window, channel) ---------------------------
    if (tid < nthr) {
      const int rw = sw * V;   // the window's first row in the tile
      float A[NP];
#pragma unroll
      for (int n = 0; n < NP; ++n) A[n] = active && n < N ? a.at[n * Dh + c] : 0.f;
      const float D = active ? a.dskip[c] : 0.f, bias = active ? a.dtb2[c] : 0.f;
      const float* dblw = dbl + (size_t)rw * L.ld_dbl;
      auto Bv = [&](int t, int n) { return n < N ? dblw[t * L.ld_dbl + R + n] : 0.f; };
      auto Cv = [&](int t, int n) { return n < N ? dblw[t * L.ld_dbl + R + N + n] : 0.f; };
      // lanes past the chunk read no Dt column (a padded row's tail is not theirs)
      auto dtv_at = [&](int t) { return (j < cw ? Dt[(rw + t) * L.ld_dt + j] : 0.f) + bias; };
      auto delta_at = [&](int t) { return softplusf(dtv_at(t)); };
      auto x_at = [&](int t) { return active ? S[(rw + t) * L.ld_s + j] : 0.f; };
      auto ckp = [&](int slot, int n) -> float& { return ck[(slot * NP + n) * nthr + tid]; };

      // forward: y, and h every 16 tokens
      {
        float h[NP];
#pragma unroll
        for (int n = 0; n < NP; ++n) h[n] = 0.f;
        for (int t = 0; t < V; ++t) {
          if (t % 16 == 0 && t > 0) {
#pragma unroll
            for (int n = 0; n < NP; ++n) ckp(t / 16 - 1, n) = h[n];
          }
          const float delta = delta_at(t), xv = x_at(t), dxv = delta * xv;
          float y = 0.f;
#pragma unroll
          for (int n = 0; n < NP; ++n) {
            h[n] = expf(delta * A[n]) * h[n] + dxv * Bv(t, n);
            y = fmaf(h[n], Cv(t, n), y);
          }
          if (active) a.yz[(row0 + rw + t) * C + c] = from_f32<T>(y + xv * D);
        }
      }

      // backward by blocks of 8 tokens, last first
      float dh[NP], an[NP];
#pragma unroll
      for (int n = 0; n < NP; ++n) dh[n] = an[n] = 0.f;
      for (int b = V / 8 - 1; b >= 0; --b) {
        const int t0 = 8 * b;
        // h before the block: a checkpoint, or the previous block recomputed
        float hst[NP];
#pragma unroll
        for (int n = 0; n < NP; ++n) hst[n] = b >= 2 ? ckp(b / 2 - 1, n) : 0.f;
        if (b % 2 == 1) {
          for (int t = t0 - 8; t < t0; ++t) {
            const float delta = delta_at(t), dxv = delta * x_at(t);
#pragma unroll
            for (int n = 0; n < NP; ++n) hst[n] = expf(delta * A[n]) * hst[n] + dxv * Bv(t, n);
          }
        }
        float ddel[8], dxs[8], gys[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          gys[i] = active ? a.gyz[(row0 + rw + t0 + i) * C + c] : 0.f;
          ddel[i] = 0.f;
          dxs[i] = gys[i] * D;
          dD = fmaf(gys[i], x_at(t0 + i), dD);
        }
#pragma unroll
        for (int ng = 0; ng < NP / 8; ++ng) {
          float hs[8][8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float delta = delta_at(t0 + i), dxv = delta * x_at(t0 + i);
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              const float hp = i == 0 ? hst[ng * 8 + n] : hs[i > 0 ? i - 1 : 0][n];
              hs[i][n] = expf(delta * A[ng * 8 + n]) * hp + dxv * Bv(t0 + i, ng * 8 + n);
            }
          }
#pragma unroll
          for (int i = 7; i >= 0; --i) {
            const int t = t0 + i;
            const float delta = delta_at(t), xv = x_at(t), gy = gys[i];
            float red[16];
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              const int nn = ng * 8 + n;
              const float hp = i == 0 ? hst[nn] : hs[i > 0 ? i - 1 : 0][n];
              const float av = expf(delta * A[nn]);
              const float bv = Bv(t, nn);
              dh[nn] = gy * Cv(t, nn) + an[nn] * dh[nn];
              const float da = dh[nn] * hp * av;
              dA[nn] = fmaf(da, delta, dA[nn]);
              ddel[i] += da * A[nn] + dh[nn] * xv * bv;
              dxs[i] = fmaf(dh[nn] * delta, bv, dxs[i]);
              red[n] = dh[nn] * (delta * xv);   // dB
              red[8 + n] = gy * hs[i][n];        // dC
              an[nn] = av;
            }
            // the warp's sums of dB, dC over its 32 channels, one per lane pair
            warp_reduce_scatter<16>(red, lane);
            if (sw < nwin && lane % 2 == 0) {
              const int idx = lane / 2, k = idx < 8 ? ng * 8 + idx : NP + ng * 8 + idx - 8;
              a.bc[((size_t)slice * nrows + row0 + rw + t) * 2 * NP + k] = red[0];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = t0 + i;
          const float g = ddel[i] * sigmoidf(dtv_at(t));
          if (active) {
            const size_t at_ = (row0 + rw + t) * Dh + c;
            a.ddtv[at_] = from_f32<T>(g);
            a.dxscan[at_] = dxs[i];
            ddtb += g;
          }
        }
      }
    }
    __syncthreads();
  }

  // the block's d at, d D, d dtb2: its windows' threads summed in order
  float* red = S;   // (tw, ch32, NP + 2) over S, Dt, dbl and the checkpoints, all free
  if (tid < nthr) {
#pragma unroll
    for (int n = 0; n < NP; ++n) red[(size_t)tid * (NP + 2) + n] = dA[n];
    red[(size_t)tid * (NP + 2) + NP] = dD;
    red[(size_t)tid * (NP + 2) + NP + 1] = ddtb;
  }
  __syncthreads();
  float* slot = a.slots + (size_t)blockIdx.x * a.P;
  for (int i = tid; i < cw * (N + 2); i += kThreads) {
    const int jj = i % cw, k = i / cw;   // k < N: d at[k]; N: d D; N + 1: d dtb2
    const int kk = k < N ? k : NP + (k - N);
    float s = 0.f;
    for (int w = 0; w < tl.tw; ++w) s += red[(size_t)(w * tl.ch32 + jj) * (NP + 2) + kk];
    const int cc = c0 + jj;
    if (k < N) slot[a.off.dat + k * Dh + cc] = s;
    else if (k == N) slot[a.off.dd + cc] = s;
    else slot[a.off.ddtb + cc] = s;
  }
}

// P2, the gate pass (the design note's pass 4). blockIdx.y < nch: a chunk of
// the x half; else a chunk of the z half.
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
mamba_gate_bwd_kernel(MambaArgs<T> a, MambaTiles tl, long long tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int V = a.V, C = a.C, Dh = C / 2, R = a.R, N = a.N, W = R + 2 * N;
  const GateLayout L = gate_layout<T>(tl, V, R, W);
  float* Dbl = reinterpret_cast<float*>(smem);
  T* DblT = reinterpret_cast<T*>(smem + L.off_dblt);
  T* Xs = reinterpret_cast<T*>(smem + L.off_x);
  T* Wd = reinterpret_cast<T*>(smem + L.off_wd);
  float* Dx = reinterpret_cast<float*>(smem + L.off_dx);   // dx, then d SiLU-output
  T* Wb = reinterpret_cast<T*>(smem + L.off_wb);
  float* Zg = reinterpret_cast<float*>(smem + L.off_zg);   // the chunk's xz columns
  const int w16 = round_up16(W), r16 = round_up16(R), ch16 = round_up16(tl.ch);
  const bool zhalf = (int)blockIdx.y >= tl.nch;
  const int c0 = (zhalf ? blockIdx.y - tl.nch : blockIdx.y) * tl.ch, cw = min(tl.ch, Dh - c0);
  const int nthr = tl.tw * tl.ch32, tid = threadIdx.x;
  const int sw = tid / tl.ch32, j = tid % tl.ch32;
  const size_t nrows = (size_t)a.BW * V;
  const int nslices = tl.nch * (tl.ch32 / 32);
  const int c = (zhalf ? Dh : 0) + c0 + j;   // the column of xz, gyz, yz, dxz
  float g0 = 0.f, g1 = 0.f, g2 = 0.f;        // dwconv of column c

  const long long t_begin = tiles * blockIdx.x / gridDim.x;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const long long w0 = tile * tl.tw;
    const int nwin = (int)min((long long)tl.tw, (long long)a.BW - w0);
    const int rows = nwin * V;
    const size_t row0 = (size_t)w0 * V;
    const bool active = tid < nthr && sw < nwin && j < cw;

    if (!zhalf) {
      // ---- ddbl = [ddtv wdt^T | dB | dC] --------------------------------
      for (int kc = 0; kc < Dh; kc += kZ) {
        for (int i = tid; i < L.rows_pad * kZ; i += kThreads) {
          const int r = i / kZ, k = i % kZ;
          Xs[r * kLdX + k] = r < rows && kc + k < Dh ? a.ddtv[(row0 + r) * Dh + kc + k]
                                                     : from_f32<T>(0.f);
        }
        for (int i = tid; i < r16 * kZ; i += kThreads) {
          const int n = i / kZ, k = i % kZ;
          Wd[n * kLdX + k] = n < R && kc + k < Dh ? a.wdt[(size_t)n * Dh + kc + k]
                                                  : from_f32<T>(0.f);
        }
        __syncthreads();
        gemm<false, true>(Dbl, L.ld_dbl, Xs, kLdX, Wd, kLdX, L.rows_pad, r16, kZ, kc > 0);
        __syncthreads();
      }
      for (int i = tid; i < L.rows_pad * w16; i += kThreads) {
        const int r = i / w16, k = i % w16;
        float v = k < R ? Dbl[r * L.ld_dbl + k] : 0.f;
        if (k >= R && k < W && r < rows) {
          const int n = k - R, idx = n < N ? n : NP + n - N;
          for (int s = 0; s < nslices; ++s)
            v += a.bc[((size_t)s * nrows + row0 + r) * 2 * NP + idx];
        }
        const T vt = from_f32<T>(v);
        DblT[r * L.ld_dblt + k] = vt;
        if (blockIdx.y == 0 && r < rows && k < W) a.ddbl[(row0 + r) * W + k] = vt;
      }
      for (int i = tid; i < ch16 * w16; i += kThreads) {
        const int n = i / w16, k = i % w16;
        Wb[n * L.ld_wb + k] = n < cw && k < W ? a.wdbl[(size_t)(c0 + n) * W + k]
                                              : from_f32<T>(0.f);
      }
      __syncthreads();
      // the x_proj part of dx: ddbl wdbl[chunk, :]^T
      gemm<false, true>(Dx, L.ld_dx, DblT, L.ld_dblt, Wb, L.ld_wb, L.rows_pad, ch16, w16, false);
      __syncthreads();
    }

    // ---- the chunk's xz and the gradient of its SiLU output, staged --------
    // with coalesced loads: x half, dx = the scan's part + the x_proj part
    // (in Dx); z half, dz = gyz
    for (int i = tid; i < L.rows_pad * tl.ch; i += kThreads) {
      const int r = i / tl.ch, jj = i % tl.ch, cc = (zhalf ? Dh : 0) + c0 + jj;
      const bool live = r < rows && jj < cw;
      Zg[i] = live ? a.xz[(row0 + r) * C + cc] : 0.f;
      float* d = Dx + r * L.ld_dx + jj;
      if (zhalf) *d = live ? a.gyz[(row0 + r) * C + cc] : 0.f;
      else if (live) *d += a.dxscan[(row0 + r) * Dh + c0 + jj];
    }
    __syncthreads();

    // ---- SiLU and conv backward, a thread per (window, channel) -----------
    if (active) {
      const int rw = sw * V;
      const float w0c = a.wconv[c], w1c = a.wconv[C + c], w2c = a.wconv[2 * C + c];
      const float* col = Zg + rw * tl.ch + j;
      float prev = 0.f, cur = col[0], dprev = 0.f, dcur = 0.f;
      for (int t = 0; t < V; ++t) {
        const size_t r = row0 + rw + t;
        const float next = t + 1 < V ? col[(t + 1) * tl.ch] : 0.f;
        const float u = cur * w1c + prev * w0c + next * w2c;
        const float sg = sigmoidf(u);
        if (zhalf) a.yz[r * C + c] = from_f32<T>(u * sg);
        const float du = Dx[(rw + t) * L.ld_dx + j] * (sg * (1.f + u * (1.f - sg)));
        g1 = fmaf(du, cur, g1);
        g0 = fmaf(du, prev, g0);
        g2 = fmaf(du, next, g2);
        if (t > 0) {   // dxz[t - 1] = du[t-1] w1 + du[t] w0 + du[t-2] w2
          float v = dcur * w1c + du * w0c;
          if (t > 1) v += dprev * w2c;
          a.dxz[(r - 1) * C + c] = from_f32<T>(v);
        }
        dprev = dcur;
        dcur = du;
        prev = cur;
        cur = next;
      }
      float v = dcur * w1c;
      if (V > 1) v += dprev * w2c;
      a.dxz[(row0 + rw + V - 1) * C + c] = from_f32<T>(v);
    }
    __syncthreads();
  }

  // the block's dwconv: its windows' threads summed in order
  float* red = Dx;   // (tw, ch32, 3), Dx is free
  if (tid < nthr) {
    red[tid * 3] = g0;
    red[tid * 3 + 1] = g1;
    red[tid * 3 + 2] = g2;
  }
  __syncthreads();
  float* slot = a.slots + (size_t)blockIdx.x * a.P;
  for (int i = tid; i < cw * 3; i += kThreads) {
    const int jj = i % cw, k = i / cw;
    float s = 0.f;
    for (int w = 0; w < tl.tw; ++w) s += red[(w * tl.ch32 + jj) * 3 + k];
    slot[a.off.dwconv + k * C + (zhalf ? Dh : 0) + c0 + jj] = s;
  }
}

// Bytes of each stream in the workspace, in order, each 256-byte aligned.
struct MambaWork {
  size_t ys, xz, gyz, yz, xs, dts, ddtv, dxscan, bc, dxz, ddbl, partials, bytes;
};

inline MambaWork mamba_work(long long rows, int C, int R, int N, int elem, int has_ln, int S,
                            size_t total) {
  const int Dh = C / 2, NP = mamba_padded_state(N), W = R + 2 * N;
  const MambaTiles tl = mamba_bwd_chunks(Dh);
  const size_t n = (size_t)rows;
  MambaWork w;
  size_t at = 0;
  auto take = [&](size_t b) { const size_t o = at; at += (b + 255) & ~size_t(255); return o; };
  w.ys = take(has_ln ? n * C * elem : 0);
  w.xz = take(n * C * 4);
  w.gyz = take(n * C * 4);
  w.yz = take(n * C * elem);
  w.xs = take(n * Dh * elem);
  w.dts = take(n * R * elem);
  w.ddtv = take(n * Dh * elem);
  w.dxscan = take(n * Dh * 4);
  w.bc = take((size_t)tl.nch * (tl.ch32 / 32) * n * 2 * NP * 4);
  w.dxz = take(n * C * elem);
  w.ddbl = take(n * W * elem);
  w.partials = take((size_t)S * total * 4);
  w.bytes = at;
  return w;
}

// The weight gradients [dwxz (C, C) | dwout (C, C) | dwdt (R, Dh) | dwdbl (Dh, W)].
inline size_t mamba_wgrad_total(int C, int R, int N) {
  const int Dh = C / 2;
  return (size_t)2 * C * C + (size_t)R * Dh + (size_t)Dh * (R + 2 * N);
}

template <typename T>
Products<T> mamba_products(const MambaArgs<T>& a) {
  const int C = a.C, Dh = C / 2, R = a.R, W = R + 2 * a.N;
  Products<T> ps{};
  ps.count = 4;
  ps.p[0] = Product<T>{a.ys, a.dxz, C, C, C, C, 0};
  ps.p[1] = Product<T>{a.yz, a.dout, C, C, C, C, (size_t)C * C};
  ps.p[2] = Product<T>{a.dts, a.ddtv, R, Dh, R, Dh, (size_t)2 * C * C};
  ps.p[3] = Product<T>{a.xs, a.ddbl, Dh, W, Dh, W, (size_t)2 * C * C + (size_t)R * Dh};
  return ps;
}

// Row splits of the four weight-gradient products at output tiles of `tile`.
inline int mamba_splits(long long rows, int C, int R, int N, int tile) {
  const int Dh = C / 2, W = R + 2 * N;
  const long long tiles = 2LL * ceil_div(C, tile) * ceil_div(C, tile) +
                          (long long)ceil_div(R, tile) * ceil_div(Dh, tile) +
                          (long long)ceil_div(Dh, tile) * ceil_div(W, tile);
  return wgrad_splits_for(rows, tiles);
}

template <typename T, int NP>
int launch_passes(MambaArgs<T>& a, float* partials, int S, float* wgrads, float* red,
                  int max_slots, cudaStream_t stream) {
  const int C = a.C, Dh = C / 2, R = a.R, W = R + 2 * a.N;
  const long long rows = (long long)a.BW * a.V;
  const MambaTiles tl = mamba_bwd_plan<T>(a.V, Dh, R, W, NP);
  if (tl.tw == 0) return (int)cudaErrorInvalidValue;
  const size_t sbytes = scan_layout<T>(tl, a.V, R, W, NP).bytes;
  const size_t gbytes = gate_layout<T>(tl, a.V, R, W).bytes;
  int e = 0;
  const T* xt = a.x;
  if (a.has_ln) {
    if ((e = launch_ln_rows<T>(a.x, a.ln_g, a.ln_b, const_cast<T*>(a.ys), rows, C, stream)) != 0)
      return e;
  } else {
    a.ys = xt;
  }
  if ((e = launch_gemm_rows<T, false>(a.ys, C, a.wxz, C, (int)rows, C, C, a.xz, stream)) != 0)
    return e;
  if ((e = launch_gemm_rows<T, true>(a.dout, C, a.wout, C, (int)rows, C, C, a.gyz, stream)) != 0)
    return e;
  auto scan = mamba_scan_bwd_kernel<T, NP>;
  auto gate = mamba_gate_bwd_kernel<T, NP>;
  cudaError_t err = cudaFuncSetAttribute(scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sbytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gate, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gbytes);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (a.BW + tl.tw - 1) / tl.tw;
  const int sms = device_sms();
  long long G = 2LL * sms;
  if (G > tiles) G = tiles;
  if (G > max_slots) G = max_slots;
  if (G < 1) return (int)cudaErrorInvalidValue;
  scan<<<dim3((unsigned)G, (unsigned)tl.nch), kThreads, sbytes, stream>>>(a, tl, tiles);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  gate<<<dim3((unsigned)G, (unsigned)(2 * tl.nch)), kThreads, gbytes, stream>>>(a, tl, tiles);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  // dxin = dxz wxz^T into xz's space
  if ((e = launch_gemm_rows<T, true>(a.dxz, C, a.wxz, C, (int)rows, C, C, a.xz, stream)) != 0)
    return e;
  // the row pass runs on all max_slots blocks (latency-bound rows want many
  // warps): its slot columns (dg, dbln, the last) sum over max_slots
  if ((e = launch_ln_bwd<T>(a.xz, a.x, a.dout, a.ln_g, a.dx, a.slots, a.P,
                            LnSlots{a.off.dg, a.off.dbln, -1}, max_slots, rows, C, a.has_ln,
                            stream)) != 0)
    return e;
  if ((e = launch_reduce(a.slots, (int)G, a.P, (size_t)a.off.dg, red, stream)) != 0) return e;
  if ((e = launch_reduce(a.slots + a.off.dg, max_slots, a.P, a.P - a.off.dg, red + a.off.dg,
                         stream)) != 0)
    return e;
  return launch_split_k<T>(mamba_products(a), rows, S, mamba_wgrad_total(C, R, a.N), partials,
                         wgrads, stream);
}

template <typename T>
MambaArgs<T> mamba_args(const void* x, const void* ln_g, const void* ln_b, const void* wxz,
                        const void* wconv, const void* wdbl, const void* wdt, const void* dtb2,
                        const void* at, const void* dskip, const void* wout, const void* dout,
                        void* dx, unsigned char* work, const MambaWork& w, float* slots, size_t P,
                        MambaSlots off, int BW, int V, int C, int R, int N, int has_ln) {
  MambaArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.wxz = static_cast<const T*>(wxz);
  a.wconv = static_cast<const float*>(wconv);
  a.wdbl = static_cast<const T*>(wdbl);
  a.wdt = static_cast<const T*>(wdt);
  a.dtb2 = static_cast<const float*>(dtb2);
  a.at = static_cast<const float*>(at);
  a.dskip = static_cast<const float*>(dskip);
  a.wout = static_cast<const T*>(wout);
  a.dout = static_cast<const T*>(dout);
  a.dx = static_cast<T*>(dx);
  a.ys = reinterpret_cast<const T*>(work + w.ys);
  a.xz = reinterpret_cast<float*>(work + w.xz);
  a.gyz = reinterpret_cast<float*>(work + w.gyz);
  a.yz = reinterpret_cast<T*>(work + w.yz);
  a.xs = reinterpret_cast<T*>(work + w.xs);
  a.dts = reinterpret_cast<T*>(work + w.dts);
  a.ddtv = reinterpret_cast<T*>(work + w.ddtv);
  a.dxscan = reinterpret_cast<float*>(work + w.dxscan);
  a.bc = reinterpret_cast<float*>(work + w.bc);
  a.dxz = reinterpret_cast<T*>(work + w.dxz);
  a.ddbl = reinterpret_cast<T*>(work + w.ddbl);
  a.slots = slots;
  a.P = P;
  a.off = off;
  a.BW = BW;
  a.V = V;
  a.C = C;
  a.R = R;
  a.N = N;
  a.has_ln = has_ln;
  return a;
}

}  // namespace lcbi

// Row splits of the weight-gradient products and the bytes of workspace the
// backward needs for BW windows of V tokens at C channels, dt rank R and N
// states: *splits and the return value (-1 where it cannot take the shape).
extern "C" long long lcbi_mamba_window_bwd_workspace(int BW, int V, int C, int R, int N,
                                                     int has_ln, int is_bf16, int* splits) {
  if (!lcbi::mamba_shape_ok(BW, V, C, R, N)) return -1;
  const long long rows = (long long)BW * V;
  const int elem = is_bf16 ? 2 : 4;
  *splits = lcbi::mamba_splits(rows, C, R, N, is_bf16 ? lcbi::kMmaTile : lcbi::kF32Tile);
  if (*splits < 1) return -1;
  return (long long)lcbi::mamba_work(rows, C, R, N, elem, has_ln, *splits,
                                     lcbi::mamba_wgrad_total(C, R, N))
      .bytes;
}

// x, dout, dx: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); at the true
// C: wxz, wout: (C, C), wdbl: (C/2, R + 2N) and wdt: (R, C/2) in T; wconv:
// (3, C), at: (N, C/2), dtb2, dskip: (C/2,) fp32; if has_ln, ln_g, ln_b: (C,)
// fp32. work: work_bytes of scratch (lcbi_mamba_window_bwd_workspace, which
// also gives S). wgrads: fp32 receives [dwxz (C, C) | dwout (C, C) | dwdt (R,
// C/2) | dwdbl (C/2, R + 2N)]. slots: max_slots x P fp32 (P a multiple of 8;
// offsets in floats inside a block's slot: dwconv (3, C), ddtb (C/2), dat (N,
// C/2), dd (C/2), dg, dbln (C)). out: (P,) fp32, the slots summed. 16 <= V <=
// 64 with V % 8 == 0, C even, 1 <= R <= 64, 1 <= N <= 16, all pointers
// 32-byte aligned. Returns cudaGetLastError() of the launches.
extern "C" int lcbi_mamba_window_bwd(const void* x, const void* ln_g, const void* ln_b,
                                     const void* wxz, const void* wconv, const void* wdbl,
                                     const void* wdt, const void* dtb2, const void* at,
                                     const void* dskip, const void* wout, const void* dout,
                                     void* dx, void* work, long long work_bytes, void* wgrads,
                                     int S, void* slots, void* out, int BW, int V, int C, int R,
                                     int N, int has_ln, int is_bf16, int max_slots, long long P,
                                     int off_dwconv, int off_ddtb, int off_dat, int off_dd,
                                     int off_dg, int off_dbln, void* stream) {
  (void)cudaGetLastError();
  if (!lcbi::mamba_shape_ok(BW, V, C, R, N) || max_slots < 1 || P % 8 != 0 || S < 1)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)BW * V;
  const lcbi::MambaWork w = lcbi::mamba_work(rows, C, R, N, is_bf16 ? 2 : 4, has_ln, S,
                                             lcbi::mamba_wgrad_total(C, R, N));
  if ((long long)w.bytes > work_bytes) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const lcbi::MambaSlots off{off_dwconv, off_ddtb, off_dat, off_dd, off_dg, off_dbln};
  unsigned char* wk = static_cast<unsigned char*>(work);
  float* parts = reinterpret_cast<float*>(wk + w.partials);
  float* sl = static_cast<float*>(slots);
  float* o = static_cast<float*>(out);
  float* wg = static_cast<float*>(wgrads);
  const bool wide = lcbi::mamba_padded_state(N) == 16;
  if (is_bf16) {
    auto a = lcbi::mamba_args<__nv_bfloat16>(x, ln_g, ln_b, wxz, wconv, wdbl, wdt, dtb2, at,
                                             dskip, wout, dout, dx, wk, w, sl, (size_t)P, off, BW,
                                             V, C, R, N, has_ln);
    return wide ? lcbi::launch_passes<__nv_bfloat16, 16>(a, parts, S, wg, o, max_slots, s)
                : lcbi::launch_passes<__nv_bfloat16, 8>(a, parts, S, wg, o, max_slots, s);
  }
  auto a = lcbi::mamba_args<float>(x, ln_g, ln_b, wxz, wconv, wdbl, wdt, dtb2, at, dskip, wout,
                                   dout, dx, wk, w, sl, (size_t)P, off, BW, V, C, R, N, has_ln);
  return wide ? lcbi::launch_passes<float, 16>(a, parts, S, wg, o, max_slots, s)
              : lcbi::launch_passes<float, 8>(a, parts, S, wg, o, max_slots, s);
}
