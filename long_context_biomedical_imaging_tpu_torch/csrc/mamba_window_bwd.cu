// Fused Mamba window mixer (K4), backward, for windows of 16 to 64 tokens:
//     out = [x +] out_proj([y | z]) (see mamba_window.cuh)
//     -> dx, [d ln_g, d ln_b,] dwxz, dwconv, dwdbl, dwdt, d dtb2, d at, d dskip, dwout
//     given do = d out
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/mamba_window.py
// _make_bwd_kernel (launched by _bwd_impl, the custom VJP of _mixer_core and
// _mixer_core_ln, entry mamba_window_mixer).
//
// What bounds it on the H100: the products (in_proj recomputed, dyz, dwout,
// dwxz, dxin: 10*T*C^2 FLOPs for T tokens) against 6*T*C bytes of x, do in
// and dx out (bf16), plus about 2*C^2 fp32 of projection gradients that the
// TPU kernel sums in place over its sequential grid; device memory bounds it,
// as the forward. A CUDA grid runs in parallel, so as the K1 backward: a
// persistent grid of G blocks walks contiguous ranges of window tiles, each
// block accumulating its weight gradients into its own fp32 slot, and
// reduce_slots_kernel sums the G slots in a fixed order (deterministic).
//
// A tile is wb whole windows. The backward of one tile holds about ten
// (rows, C) intermediates (the recomputed xz and s, [y | z], do, dyz, du, dxz
// and dxin, in T or fp32): at C = 384 and 64 rows that is about 600 KB, more
// than a block's shared memory. This first design keeps them in a per-block
// scratch in global memory (the wrapper allocates G blocks' worth; most of it
// stays in L2), so every tile shape fits and the code stays simple; moving the
// hot ones into shared memory is later work. The scan's h history of a
// window is V * N fp32 per channel, too large too: the reverse scan keeps h
// at the start of every 8 tokens (in per-thread local memory) and recomputes
// each stretch of 8 into registers before walking it backwards,
//     dh[t] = C[t] gy[t] + a[t+1] dh[t+1],  a[t] = exp(delta[t] A).
// One warp runs 32 channels of one window, so the cross-channel sums of dB
// and dC at each token are warp shuffles in a fixed order, and the warps'
// partials are summed in order afterwards. Operands of every product are
// rounded to T where the TPU kernel rounds them; everything else is fp32.
#include "mamba_window.cuh"

namespace lcbi {

constexpr int kSeg = 8;  // tokens between the reverse scan's checkpoints
constexpr int kMaxTileRows = 512;  // rows of a tile (the LayerNorm statistics' arrays)

struct MambaBwdLayout {
  int Wp, groups;
  size_t ys, dos, yz, dxz, xz, s, gyz, du, dbl, ddbl, ddtv, dxs, part, dd, da, dconv, bytes;
};

// Offsets (bytes) of the tile's intermediates in one block's scratch.
__host__ __device__ inline MambaBwdLayout mamba_bwd_layout(int rows_pad, int wb, int C, int R,
                                                           int elem) {
  MambaBwdLayout L;
  const int Dh = C / 2, N = kMambaN;
  L.Wp = (R + 2 * N + 7) / 8 * 8;
  L.groups = (Dh + 31) / 32;
  const size_t RC = (size_t)rows_pad * C;
  size_t at = 0;
  auto take = [&](size_t bytes) { const size_t o = at; at += align128(bytes); return o; };
  L.ys = take(RC * elem);
  L.dos = take(RC * elem);
  L.yz = take(RC * elem);
  L.dxz = take(RC * elem);
  L.xz = take(RC * 4);
  L.s = take(RC * 4);
  L.gyz = take(RC * 4);
  L.du = take(RC * 4);
  L.dbl = take((size_t)rows_pad * L.Wp * 4);
  L.ddbl = take((size_t)rows_pad * L.Wp * 4);
  L.ddtv = take((size_t)rows_pad * Dh * 4);
  L.dxs = take((size_t)rows_pad * Dh * 4);
  L.part = take((size_t)rows_pad * L.groups * 2 * N * 4);
  L.dd = take((size_t)wb * Dh * 4);
  L.da = take((size_t)wb * N * Dh * 4);
  L.dconv = take((size_t)wb * 3 * C * 4);
  L.bytes = at;
  return L;
}

// Windows a tile: at least 64 rows, and enough windows that the scan's warps
// (one per 32 channels of a window) fill the block's warps where the channels
// are few. At most kMaxTileRows rows (8 windows of 64 at C = 32).
inline int mamba_bwd_tile_windows(int V, int C) {
  const int groups = (C / 2 + 31) / 32;
  const int wb = (kWarps + groups - 1) / groups;
  return 64 / V > wb ? 64 / V : wb;
}

// Slot offsets (floats) of each gradient inside one block's slot; dwxz is at 0.
struct MambaSlots {
  int dwout, dwconv, dwdbl, dwdt, ddtb, dat, dd, dg, dbln;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst = (first ? 0 : dst) + v: a block's slot entry, overwritten by its first tile
__device__ __forceinline__ void slot_add(float* dst, float v, bool first) {
  *dst = (first ? 0.f : *dst) + v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba_window_bwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                        const float* __restrict__ ln_b, const T* __restrict__ wxz,
                        const float* __restrict__ wconv, const T* __restrict__ wdbl,
                        const T* __restrict__ wdt, const float* __restrict__ dtb2,
                        const float* __restrict__ at, const float* __restrict__ dskip,
                        const T* __restrict__ wout, const T* __restrict__ dout,
                        T* __restrict__ dx, unsigned char* __restrict__ work, size_t work_bytes,
                        float* __restrict__ slots, size_t P, MambaSlots off, int BW, int V,
                        int Ct, int R, int wb, int rows_pad, int has_ln, long long tiles) {
  constexpr int N = kMambaN;
  const int C = chunk_padded_channels(Ct);  // the padded width (mamba_window.cuh)
  const int Dh = C / 2, W = R + 2 * N;
  const MambaBwdLayout L = mamba_bwd_layout(rows_pad, wb, C, R, sizeof(T));
  const int Wp = L.Wp, G = L.groups;
  unsigned char* wk = work + (size_t)blockIdx.x * work_bytes;
  T* ys = reinterpret_cast<T*>(wk + L.ys);          // LN'd rows
  T* dos = reinterpret_cast<T*>(wk + L.dos);        // do
  T* yz = reinterpret_cast<T*>(wk + L.yz);          // [y | z]
  T* dxzT = reinterpret_cast<T*>(wk + L.dxz);       // d xz
  float* xz = reinterpret_cast<float*>(wk + L.xz);  // in_proj product, later dxin
  float* s = reinterpret_cast<float*>(wk + L.s);    // SiLU(conv(xz)) = x | z
  float* gyz = reinterpret_cast<float*>(wk + L.gyz);  // do @ wout^T = [gy | dz]
  float* du = reinterpret_cast<float*>(wk + L.du);  // d u (before SiLU)
  float* dbl = reinterpret_cast<float*>(wk + L.dbl);
  float* ddbl = reinterpret_cast<float*>(wk + L.ddbl);
  float* ddtv = reinterpret_cast<float*>(wk + L.ddtv);
  float* dxs = reinterpret_cast<float*>(wk + L.dxs);  // d x, scan part, then total
  float* part = reinterpret_cast<float*>(wk + L.part);  // (rows, G, 2N) dB | dC per warp
  float* dd_part = reinterpret_cast<float*>(wk + L.dd);
  float* da_part = reinterpret_cast<float*>(wk + L.da);
  float* dconv_part = reinterpret_cast<float*>(wk + L.dconv);
  __shared__ float mus[kMaxTileRows], rstds[kMaxTileRows];

  float* slot = slots + (size_t)blockIdx.x * P;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const long long t_begin = tiles * blockIdx.x / gridDim.x;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const bool first = tile == t_begin;
    const int w0 = (int)tile * wb;
    const int nwin = min(wb, BW - w0);
    const int rows = nwin * V;
    const size_t base = (size_t)w0 * V * Ct;
    const T* xt = x + base;
    const T* dot = dout + base;

    // ---- recompute the forward up to the scan; do and dyz ------------------
    layernorm_rows(xt, rows, rows_pad, Ct, ln_g, ln_b, has_ln, ys, C, mus, rstds, C);
    for (int i = threadIdx.x; i < rows_pad * C; i += kThreads) {
      const int r = i / C, c = i % C;
      dos[i] = r < rows && c < Ct ? dot[(size_t)r * Ct + c] : from_f32<T>(0.f);
    }
    __syncthreads();
    gemm<false, false>(xz, C, ys, C, wxz, C, rows_pad, C, C, false);
    gemm<false, true>(gyz, C, dos, C, wout, C, rows_pad, C, C, false);
    __syncthreads();
    conv3_silu(xz, C, s, C, wconv, nwin, V, C);
    __syncthreads();
    x_proj<T>(s, C, wdbl, dbl, Wp, rows, Dh, W);
    for (int i = threadIdx.x; i < rows_pad * Dh; i += kThreads) {
      const int r = i / Dh, c = i % Dh;
      yz[(size_t)r * C + Dh + c] = from_f32<T>(r < rows ? s[(size_t)r * C + Dh + c] : 0.f);
      if (r >= rows) yz[(size_t)r * C + c] = from_f32<T>(0.f);
    }
    __syncthreads();

    // ---- the scan, forward then backward: one warp per 32 channels of a window
    for (int task = warp; task < nwin * G; task += kWarps) {
      const int w = task / G, g = task % G;
      const int d = g * 32 + lane;
      const bool active = d < Dh;
      const int dc = active ? d : Dh - 1;
      const size_t r0 = (size_t)w * V;
      float A[N], h[N], ck[kMambaMaxV / kSeg][N];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        A[n] = at[n * Dh + dc];
        h[n] = 0.f;
      }
      const float D = dskip[dc], bias = dtb2[dc];
      for (int t = 0; t < V; ++t) {
        if (t % kSeg == 0) {
#pragma unroll
          for (int n = 0; n < N; ++n) ck[t / kSeg][n] = h[n];
        }
        const float* db = dbl + (r0 + t) * Wp;
        const float delta = softplusf(dt_value<T>(db, wdt, R, Dh, dc, bias));
        const float xv = s[(r0 + t) * C + dc];
        const float dxv = delta * xv;
        float y = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = expf(delta * A[n]) * h[n] + dxv * db[R + n];
          y = fmaf(h[n], db[R + N + n], y);
        }
        if (active) yz[(r0 + t) * C + d] = from_f32<T>(y + xv * D);
      }

      float dh[N], a_next[N], dA[N], dD = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) dh[n] = a_next[n] = dA[n] = 0.f;
      for (int seg = V / kSeg - 1; seg >= 0; --seg) {
        const int t0 = seg * kSeg;
        float hs[kSeg][N];
#pragma unroll
        for (int i = 0; i < kSeg; ++i) {
          const float* db = dbl + (r0 + t0 + i) * Wp;
          const float delta = softplusf(dt_value<T>(db, wdt, R, Dh, dc, bias));
          const float dxv = delta * s[(r0 + t0 + i) * C + dc];
#pragma unroll
          for (int n = 0; n < N; ++n) {
            const float hp = i == 0 ? ck[seg][n] : hs[i > 0 ? i - 1 : 0][n];
            hs[i][n] = expf(delta * A[n]) * hp + dxv * db[R + n];
          }
        }
#pragma unroll
        for (int i = kSeg - 1; i >= 0; --i) {
          const size_t r = r0 + t0 + i;
          const float* db = dbl + r * Wp;
          const float dtv = dt_value<T>(db, wdt, R, Dh, dc, bias);
          const float delta = softplusf(dtv);
          const float xv = s[r * C + dc];
          const float gy = active ? gyz[r * C + d] : 0.f;
          dD = fmaf(gy, xv, dD);
          float dxsv = gy * D, ddelta = 0.f;
          float red[2 * N];
#pragma unroll
          for (int n = 0; n < N; ++n) {
            const float hp = i == 0 ? ck[seg][n] : hs[i > 0 ? i - 1 : 0][n];
            const float a = expf(delta * A[n]);
            const float b = db[R + n];
            dh[n] = gy * db[R + N + n] + a_next[n] * dh[n];
            const float da = dh[n] * hp * a;
            dA[n] = fmaf(da, delta, dA[n]);
            ddelta += da * A[n] + dh[n] * xv * b;
            dxsv = fmaf(dh[n] * delta, b, dxsv);
            red[n] = dh[n] * (delta * xv);            // dB
            red[N + n] = gy * hs[i][n];               // dC
            a_next[n] = a;
          }
          if (active) {
            ddtv[r * Dh + d] = ddelta * sigmoidf(dtv);
            dxs[r * Dh + d] = dxsv;
          }
#pragma unroll
          for (int k = 0; k < 2 * N; ++k) red[k] = warp_sum(red[k]);
          if (lane == 0) {
#pragma unroll
            for (int k = 0; k < 2 * N; ++k) part[(r * G + g) * 2 * N + k] = red[k];
          }
        }
      }
      if (active) {
        dd_part[w * Dh + d] = dD;
#pragma unroll
        for (int n = 0; n < N; ++n) da_part[((size_t)w * N + n) * Dh + d] = dA[n];
      }
    }
    __syncthreads();

    // ---- d dbl = [d dt | dB | dC]; dt path; dD, dA; dwout ------------------
    for (int i = threadIdx.x; i < rows * W; i += kThreads) {
      const int r = i / W, j = i % W;
      float a = 0.f;
      if (j < R) {
        for (int dd = 0; dd < Dh; ++dd)
          a = fmaf(rnd<T>(ddtv[(size_t)r * Dh + dd]), to_f32(wdt[(size_t)j * Dh + dd]), a);
      } else {
        for (int gg = 0; gg < G; ++gg) a += part[((size_t)r * G + gg) * 2 * N + j - R];
      }
      ddbl[(size_t)r * Wp + j] = a;
    }
    for (int i = threadIdx.x; i < R * Dh; i += kThreads) {
      const int j = i / Dh, dd = i % Dh;
      float a = 0.f;
      for (int r = 0; r < rows; ++r)
        a = fmaf(rnd<T>(dbl[(size_t)r * Wp + j]), rnd<T>(ddtv[(size_t)r * Dh + dd]), a);
      slot_add(slot + off.dwdt + i, a, first);
    }
    for (int dd = threadIdx.x; dd < Dh; dd += kThreads) {
      float sb = 0.f, sd = 0.f;
      for (int r = 0; r < rows; ++r) sb += ddtv[(size_t)r * Dh + dd];
      for (int w = 0; w < nwin; ++w) sd += dd_part[w * Dh + dd];
      slot_add(slot + off.ddtb + dd, sb, first);
      slot_add(slot + off.dd + dd, sd, first);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float sa = 0.f;
        for (int w = 0; w < nwin; ++w) sa += da_part[((size_t)w * N + n) * Dh + dd];
        slot_add(slot + off.dat + n * Dh + dd, sa, first);
      }
    }
    gemm<true, false>(slot + off.dwout, C, yz, C, dos, C, C, C, rows_pad, !first);
    __syncthreads();

    // ---- x_proj backward: dwdbl, and dx = dx(scan) + d dbl @ wdbl^T ---------
    for (int i = threadIdx.x; i < Dh * W; i += kThreads) {
      const int k = i / W, j = i % W;
      float a = 0.f;
      for (int r = 0; r < rows; ++r)
        a = fmaf(rnd<T>(s[(size_t)r * C + k]), rnd<T>(ddbl[(size_t)r * Wp + j]), a);
      slot_add(slot + off.dwdbl + i, a, first);
    }
    for (int i = threadIdx.x; i < rows * Dh; i += kThreads) {
      const int r = i / Dh, k = i % Dh;
      float a = 0.f;
      for (int j = 0; j < W; ++j)
        a = fmaf(rnd<T>(ddbl[(size_t)r * Wp + j]), to_f32(wdbl[(size_t)k * W + j]), a);
      dxs[i] += a;
    }
    __syncthreads();

    // ---- SiLU and conv backward, per (window, channel) ----------------------
    for (int p = threadIdx.x; p < nwin * C; p += kThreads) {
      const int w = p / C, c = p % C;
      const float w0c = wconv[c], w1c = wconv[C + c], w2c = wconv[2 * C + c];
      const size_t r0 = (size_t)w * V;
      float prev = 0.f, cur = xz[r0 * C + c];
      for (int t = 0; t < V; ++t) {
        const size_t r = r0 + t;
        const float next = t + 1 < V ? xz[(r + 1) * C + c] : 0.f;
        const float u = cur * w1c + prev * w0c + next * w2c;
        const float sg = sigmoidf(u);
        const float ds = c < Dh ? dxs[r * Dh + c] : gyz[r * C + c];
        du[r * C + c] = ds * (sg * (1.f + u * (1.f - sg)));
        prev = cur;
        cur = next;
      }
      float g0 = 0.f, g1 = 0.f, g2 = 0.f;
      for (int t = 0; t < V; ++t) {
        const size_t r = r0 + t;
        const float dut = du[r * C + c];
        g1 = fmaf(dut, xz[r * C + c], g1);
        if (t > 0) g0 = fmaf(dut, xz[(r - 1) * C + c], g0);
        if (t + 1 < V) g2 = fmaf(dut, xz[(r + 1) * C + c], g2);
        float v = dut * w1c;
        if (t + 1 < V) v += du[(r + 1) * C + c] * w0c;
        if (t > 0) v += du[(r - 1) * C + c] * w2c;
        dxzT[r * C + c] = from_f32<T>(v);
      }
      dconv_part[((size_t)w * 3 + 0) * C + c] = g0;
      dconv_part[((size_t)w * 3 + 1) * C + c] = g1;
      dconv_part[((size_t)w * 3 + 2) * C + c] = g2;
    }
    for (int i = rows * C + threadIdx.x; i < rows_pad * C; i += kThreads) dxzT[i] = from_f32<T>(0.f);
    __syncthreads();

    // ---- dwconv; in_proj backward: dwxz += ys^T dxz, dxin = dxz wxz^T ------
    for (int i = threadIdx.x; i < 3 * C; i += kThreads) {
      const int j = i / C, c = i % C;
      float a = 0.f;
      for (int w = 0; w < nwin; ++w) a += dconv_part[((size_t)w * 3 + j) * C + c];
      slot_add(slot + off.dwconv + i, a, first);
    }
    gemm<true, false>(slot, C, ys, C, dxzT, C, C, C, rows_pad, !first);
    gemm<false, true>(xz, C, dxzT, C, wxz, C, rows_pad, C, C, false);
    __syncthreads();

    // ---- LayerNorm backward (with the residual's do), or dx = dxin ---------
    const float* dy = xz;
    if (has_ln) {
      for (int c = threadIdx.x; c < Ct; c += kThreads) {
        float sg = 0.f, sb = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float d = dy[(size_t)r * C + c];
          sg += d * (to_f32(xt[(size_t)r * Ct + c]) - mus[r]) * rstds[r];
          sb += d;
        }
        slot_add(slot + off.dg + c, sg, first);
        slot_add(slot + off.dbln + c, sb, first);
      }
    }
    T* dxt = dx + base;
    if (has_ln) {
      const float inv = 1.f / (float)Ct;
      for (int r = warp; r < rows; r += kWarps) {
        const float mu = mus[r], rstd = rstds[r];
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < Ct; c += 32) {
          const float xhat = (to_f32(xt[(size_t)r * Ct + c]) - mu) * rstd;
          const float dxh = dy[(size_t)r * C + c] * ln_g[c];
          s1 += dxh;
          s2 += dxh * xhat;
        }
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        const float m1 = s1 * inv, m2 = s2 * inv;
        for (int c = lane; c < Ct; c += 32) {
          const float xhat = (to_f32(xt[(size_t)r * Ct + c]) - mu) * rstd;
          const float dxh = dy[(size_t)r * C + c] * ln_g[c];
          const float v = rstd * (dxh - m1 - xhat * m2) + to_f32(dos[(size_t)r * C + c]);
          dxt[(size_t)r * Ct + c] = from_f32<T>(v);
        }
      }
    } else {
      for (int i = threadIdx.x; i < rows * Ct; i += kThreads)
        dxt[i] = from_f32<T>(dy[(size_t)(i / Ct) * C + i % Ct]);
    }
    __syncthreads();
  }
}

template <typename T>
int launch_bwd(const void* x, const void* ln_g, const void* ln_b, const void* wxz,
               const void* wconv, const void* wdbl, const void* wdt, const void* dtb2,
               const void* at, const void* dskip, const void* wout, const void* dout, void* dx,
               void* work, size_t work_bytes, float* slots, float* out, size_t P, MambaSlots off,
               int max_slots, int BW, int V, int C, int R, int has_ln, cudaStream_t stream) {
  const int wb = mamba_bwd_tile_windows(V, chunk_padded_channels(C));
  const int rows_pad = round_up16(wb * V);
  if (rows_pad > kMaxTileRows) return (int)cudaErrorInvalidValue;
  if (mamba_bwd_layout(rows_pad, wb, chunk_padded_channels(C), R, sizeof(T)).bytes > work_bytes)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (BW + wb - 1) / wb;
  const int G = persistent_blocks(mamba_window_bwd_kernel<T>, 0, tiles, max_slots);
  if (G <= 0) return (int)cudaErrorInvalidValue;
  mamba_window_bwd_kernel<T><<<G, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<const T*>(wxz), static_cast<const float*>(wconv), static_cast<const T*>(wdbl),
      static_cast<const T*>(wdt), static_cast<const float*>(dtb2), static_cast<const float*>(at),
      static_cast<const float*>(dskip), static_cast<const T*>(wout), static_cast<const T*>(dout),
      static_cast<T*>(dx), static_cast<unsigned char*>(work), work_bytes, slots, P, off, BW, V, C,
      R, wb, rows_pad, has_ln, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(slots, G, P, out, stream);
}

}  // namespace lcbi

// The padded width this library's kernels run on (common.cuh): the wrapper
// lays the weights, taps and biases out at it.
extern "C" int lcbi_padded_channels(int C) { return lcbi::chunk_padded_channels(C); }

// Bytes of global scratch one block of the backward uses (its tile's
// intermediates, MambaBwdLayout) for windows of V tokens at C channels and dt
// rank R, or -1 where the kernel cannot take the shape.
extern "C" long long lcbi_mamba_window_bwd_workspace(int V, int C, int R, int is_bf16) {
  if (!lcbi::mamba_shape_ok(1, V, C, R)) return -1;
  const int Cp = lcbi::chunk_padded_channels(C);
  const int wb = lcbi::mamba_bwd_tile_windows(V, Cp);
  return (long long)lcbi::mamba_bwd_layout(lcbi::round_up16(wb * V), wb, Cp, R, is_bf16 ? 2 : 4)
      .bytes;
}

// x, dout, dx: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); the weights
// and per-channel operands padded as the forward's (Cp = C rounded up to 32):
// wxz, wout: (Cp, Cp), wdbl: (Cp/2, R + 16) and wdt: (R, Cp/2) in T; wconv: (3,
// Cp), at: (8, Cp/2), dtb2, dskip: (Cp/2,) fp32; if has_ln, ln_g, ln_b: (C,)
// fp32. work: max_slots x work_floats fp32 scratch, work_floats at least
// lcbi_mamba_window_bwd_workspace / 4 and a multiple of 32. slots: max_slots x
// P fp32 (P a multiple of 8; offsets in floats inside a block's slot, every
// gradient in the padded layout: dwxz (Cp, Cp) at 0, dwout (Cp, Cp) at
// off_dwout, a multiple of 8, then dwconv (3, Cp), dwdbl (Cp/2, R + 16), dwdt
// (R, Cp/2), ddtb (Cp/2), dat (8, Cp/2), dd (Cp/2), dg, dbln (C, each at least
// Cp floats apart)). out: (P,) fp32, the slots summed. 16 <= V <= 64 with V %
// 8 == 0, C even, 1 <= R <= 64, all pointers 32-byte aligned. Returns
// cudaGetLastError() of the launches.
extern "C" int lcbi_mamba_window_bwd(const void* x, const void* ln_g, const void* ln_b,
                                     const void* wxz, const void* wconv, const void* wdbl,
                                     const void* wdt, const void* dtb2, const void* at,
                                     const void* dskip, const void* wout, const void* dout,
                                     void* dx, void* work, void* slots, void* out, int BW, int V,
                                     int C, int R, int has_ln, int is_bf16, int max_slots,
                                     long long work_floats, long long P, int off_dwout,
                                     int off_dwconv, int off_dwdbl, int off_dwdt, int off_ddtb,
                                     int off_dat, int off_dd, int off_dg, int off_dbln,
                                     void* stream) {
  (void)cudaGetLastError();
  if (!lcbi::mamba_shape_ok(BW, V, C, R) || max_slots < 1 || work_floats % 32 != 0 ||
      P % 8 != 0 || off_dwout % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const lcbi::MambaSlots off{off_dwout, off_dwconv, off_dwdbl, off_dwdt, off_ddtb,
                             off_dat,   off_dd,     off_dg,    off_dbln};
  float* sl = static_cast<float*>(slots);
  float* o = static_cast<float*>(out);
  const size_t wbytes = (size_t)work_floats * 4;
  if (is_bf16)
    return lcbi::launch_bwd<__nv_bfloat16>(x, ln_g, ln_b, wxz, wconv, wdbl, wdt, dtb2, at, dskip,
                                           wout, dout, dx, work, wbytes, sl, o, (size_t)P, off,
                                           max_slots, BW, V, C, R, has_ln, s);
  return lcbi::launch_bwd<float>(x, ln_g, ln_b, wxz, wconv, wdbl, wdt, dtb2, at, dskip, wout,
                                 dout, dx, work, wbytes, sl, o, (size_t)P, off, max_slots, BW, V,
                                 C, R, has_ln, s);
}
