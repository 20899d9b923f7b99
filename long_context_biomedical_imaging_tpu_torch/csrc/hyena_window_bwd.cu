// Fused Hyena window mixer, backward, for windows of V <= 64 tokens:
//     out = [x +] out_proj(x2 * longconv(x1 * v)),  [x1 | x2 | v] = shortconv(in_proj([LN](x)))
//     -> dx, [d ln_g, d ln_b,] dwin, dbin, dws, dbs, dkl, dwo, dbo given do = d out
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/hyena_window.py
// _make_bwd_kernel (launched by _bwd_impl, the custom VJP of _mixer_core and
// _mixer_core_ln, entry hyena_window_mixer).
//
// What bounds it on the H100: the projections' products (the two forward
// ones recomputed, dv2, dwo, dwin, dy: 22*T*C^2 FLOPs for T tokens) against
// 6*T*C bytes of x, do in and dx out (bf16), plus 4*C^2 fp32 of projection
// gradients that the TPU kernel sums in place over its sequential grid. A
// CUDA grid runs in parallel, so the design bounds the partial sums instead:
// a persistent grid of G blocks (at most the blocks resident at once, and as
// many as the caller's slots allow) walks contiguous ranges of window tiles,
// each block accumulating into its own fp32 slot of every gradient in global
// memory; reduce_slots_kernel then sums the G slots in a fixed order, so the
// result is deterministic.
//
// A tile is wb whole windows (wb * V rows, padded to a multiple of 16). Every
// step from dv2 to dz acts per channel, so, as the forward, the block keeps
// the (LN'd) rows y and the tile of do in shared memory and walks the channel
// axis in chunks of 32. For one chunk it recomputes z = y @ win[:, cols] (the
// x1/x2/v columns) and computes dv2 = do @ wo[chunk, :]^T; one thread per
// (window, channel) reruns the short conv, gates and long conv, then takes
// them backward (dvl = dv2 * x2, dx2 = dv2 * vl, the transposed long conv
// for dg, dx1 = dg * v, dv = dg * x1, the transposed short conv for dz) and
// leaves its tap and bias gradients per window in shared memory, which a
// second pass sums over the windows in order. Then dwo[chunk, :] += v2^T do
// and dwin[:, cols] += y^T dz go into the block's slot and dy += dz @
// win[:, cols]^T into an fp32 tile in shared memory. Last, with the folded
// LN, the LayerNorm backward per row plus do for the residual. Operands of
// every product are rounded to T where the TPU kernel rounds them (y, v2,
// dz, do), everything else is fp32.
//
// Taps arrive prepared by the wrapper, as for the forward: ws (K, 3C) in
// causal tap order, kl (V, C) with the skip weight in tap 0. The gradients
// are those of the prepared taps; the wrapper's flip and fold carry them back.
//
// Widths as the forward's (hyena_window.cu): chunks over Cp = C rounded up
// to 32, the rows of x, do and dx and the LayerNorm at the true C; the
// weight, tap and bias gradients come out in the padded layout and the
// wrapper keeps their true blocks.
#include "common.cuh"

namespace lcbi {

constexpr int kChanChunk = 32;
constexpr int kMaxWindow = 64;

struct HyenaBwdLayout {
  int lds, lddy, ldz, ldc, ldv, ldd;
  size_t off_dos, off_dy, off_z, off_zc, off_g, off_vl, off_dv2, off_v2, off_dz, off_wsp, off_bsp,
      off_bip, off_ws, off_bias, off_stats, bytes;
};

__host__ __device__ inline HyenaBwdLayout hyena_bwd_layout(int rows_pad, int wb, int V, int C,
                                                           int K, int elem) {
  constexpr int W3 = 3 * kChanChunk;
  HyenaBwdLayout L;
  L.lds = C + 8;
  L.lddy = C + 4;
  L.ldz = W3 + 4;
  L.ldc = kChanChunk + 4;
  L.ldv = kChanChunk + 8;
  L.ldd = W3 + 8;
  const size_t R = rows_pad;
  L.off_dos = align128(R * L.lds * elem);
  L.off_dy = L.off_dos + align128(R * L.lds * elem);
  L.off_z = L.off_dy + align128(R * L.lddy * 4);
  L.off_zc = L.off_z + align128(R * L.ldz * 4);
  L.off_g = L.off_zc + align128(R * L.ldz * 4);
  L.off_vl = L.off_g + align128(R * L.ldc * 4);
  L.off_dv2 = L.off_vl + align128(R * L.ldc * 4);
  L.off_v2 = L.off_dv2 + align128(R * L.ldc * 4);
  L.off_dz = L.off_v2 + align128(R * L.ldv * elem);
  L.off_wsp = L.off_dz + align128(R * L.ldd * elem);
  L.off_bsp = L.off_wsp + align128((size_t)wb * K * W3 * 4);
  L.off_bip = L.off_bsp + align128((size_t)wb * W3 * 4);
  L.off_ws = L.off_bip + align128((size_t)wb * W3 * 4);
  L.off_bias = L.off_ws + align128((size_t)K * W3 * 4);
  L.off_stats = L.off_bias + align128((size_t)2 * W3 * 4);
  L.bytes = L.off_stats + align128(2 * R * 4);
  return L;
}

// Slot offsets (floats) of each gradient inside one block's slot; dwin is at 0.
struct HyenaSlots {
  int dwo, dws, dbin, dbs, dkl, dbo, dg, dbln;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
hyena_window_bwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                        const float* __restrict__ ln_b, const T* __restrict__ win,
                        const float* __restrict__ bin, const float* __restrict__ ws,
                        const float* __restrict__ bs, const float* __restrict__ kl,
                        const T* __restrict__ wo, const T* __restrict__ dout,
                        T* __restrict__ dx, float* __restrict__ slots, size_t P, HyenaSlots off,
                        int BW, int V, int C, int K, int wb, int rows_pad, int has_ln,
                        long long tiles) {
  constexpr int CC = kChanChunk, W3 = 3 * kChanChunk;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Cp = chunk_padded_channels(C);
  const HyenaBwdLayout L = hyena_bwd_layout(rows_pad, wb, V, Cp, K, sizeof(T));
  T* ys = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + L.off_dos);
  float* dy = reinterpret_cast<float*>(smem + L.off_dy);
  float* z = reinterpret_cast<float*>(smem + L.off_z);      // z + b_in, the short conv's input
  float* zc = reinterpret_cast<float*>(smem + L.off_zc);    // x1 | x2 | v, then dx1 | dx2 | dv
  float* gb = reinterpret_cast<float*>(smem + L.off_g);     // g = v * x1
  float* vlb = reinterpret_cast<float*>(smem + L.off_vl);   // vl = longconv(g), then d kl
  float* dv2 = reinterpret_cast<float*>(smem + L.off_dv2);  // dv2, then dvl
  T* v2s = reinterpret_cast<T*>(smem + L.off_v2);
  T* dzs = reinterpret_cast<T*>(smem + L.off_dz);
  float* wspart = reinterpret_cast<float*>(smem + L.off_wsp); // (wb, K, W3)
  float* bspart = reinterpret_cast<float*>(smem + L.off_bsp); // (wb, W3)
  float* bipart = reinterpret_cast<float*>(smem + L.off_bip); // (wb, W3)
  float* wsc = reinterpret_cast<float*>(smem + L.off_ws);     // (K, W3)
  float* binc = reinterpret_cast<float*>(smem + L.off_bias);
  float* bsc = binc + W3;
  float* mus = reinterpret_cast<float*>(smem + L.off_stats);
  float* rstds = mus + rows_pad;

  float* slot = slots + (size_t)blockIdx.x * P;
  float* s_dwin = slot;
  float* s_dwo = slot + off.dwo;
  float* s_dws = slot + off.dws;
  float* s_dbin = slot + off.dbin;
  float* s_dbs = slot + off.dbs;
  float* s_dkl = slot + off.dkl;
  float* s_dbo = slot + off.dbo;
  float* s_dg = slot + off.dg;
  float* s_dbln = slot + off.dbln;

  const long long t_begin = tiles * blockIdx.x / gridDim.x;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const bool first = tile == t_begin;
    const int w0 = (int)tile * wb;
    const int nwin = min(wb, BW - w0);
    const int rows = nwin * V;
    const size_t base = (size_t)w0 * V * C;
    const T* xt = x + base;
    const T* dot = dout + base;

    layernorm_rows(xt, rows, rows_pad, C, ln_g, ln_b, has_ln, ys, L.lds, mus, rstds, Cp);
    for (int i = threadIdx.x; i < rows_pad * Cp; i += kThreads) {
      const int r = i / Cp, c = i % Cp;
      dos[(size_t)r * L.lds + c] =
          r < rows && c < C ? dot[(size_t)r * C + c] : from_f32<T>(0.f);
    }
    for (int i = threadIdx.x; i < rows_pad * L.lddy; i += kThreads) dy[i] = 0.f;
    // pad rows of v2 and dz are never written per chunk; they must be zero so
    // that the weight-gradient products see nothing there
    for (int i = threadIdx.x; i < rows_pad * L.ldv; i += kThreads) v2s[i] = from_f32<T>(0.f);
    for (int i = threadIdx.x; i < rows_pad * L.ldd; i += kThreads) dzs[i] = from_f32<T>(0.f);

    for (int c0 = 0; c0 < Cp; c0 += CC) {
      // this chunk's short taps and biases (the long taps are read from
      // global memory, through L1); column j of a 3CC-wide chunk is channel
      // c0 + j % CC of block j / CC of the [x1 | x2 | v] projection
      for (int i = threadIdx.x; i < K * W3; i += kThreads) {
        const int m = i / W3, j = i % W3;
        wsc[i] = ws[(size_t)m * 3 * Cp + (j / CC) * Cp + c0 + j % CC];
      }
      for (int j = threadIdx.x; j < W3; j += kThreads) {
        const int col = (j / CC) * Cp + c0 + j % CC;
        binc[j] = bin[col];
        bsc[j] = bs[col];
      }
      __syncthreads();  // also orders the prologue before the first products
      for (int s = 0; s < 3; ++s)
        gemm<false, false>(z + s * CC, L.ldz, ys, L.lds, win + s * Cp + c0, 3 * Cp, rows_pad, CC,
                           Cp, false);
      gemm<false, true>(dv2, L.ldc, dos, L.lds, wo + (size_t)c0 * Cp, Cp, rows_pad, CC, Cp,
                        false);
      __syncthreads();

      for (int p = threadIdx.x; p < nwin * CC; p += kThreads) {
        const int w = p / CC, j = p % CC;
        const size_t r0 = (size_t)w * V;
        float* zr = z + r0 * L.ldz;
        float* cr = zc + r0 * L.ldz;
        float* gr = gb + r0 * L.ldc;
        float* lr = vlb + r0 * L.ldc;
        float* dr = dv2 + r0 * L.ldc;
        const float* klj = kl + c0 + j;   // tap m of this channel: klj[m * Cp]
        // forward recompute: in_proj bias, causal short conv, gates, long conv
        for (int s = 0; s < 3; ++s) {
          const int col = s * CC + j;
          for (int t = 0; t < V; ++t) zr[(size_t)t * L.ldz + col] += binc[col];
          for (int t = 0; t < V; ++t) {
            float a = bsc[col];
            for (int m = 0; m < K && m <= t; ++m)
              a += zr[(size_t)(t - m) * L.ldz + col] * wsc[m * W3 + col];
            cr[(size_t)t * L.ldz + col] = a;
          }
        }
        for (int t = 0; t < V; ++t)
          gr[(size_t)t * L.ldc + j] =
              cr[(size_t)t * L.ldz + 2 * CC + j] * cr[(size_t)t * L.ldz + j];
        for (int t = 0; t < V; ++t) {
          float a = 0.f;
          for (int m = 0; m <= t; ++m)
            a += gr[(size_t)(t - m) * L.ldc + j] * __ldg(klj + (size_t)m * Cp);
          lr[(size_t)t * L.ldc + j] = a;
          v2s[(r0 + t) * L.ldv + j] = from_f32<T>(a * cr[(size_t)t * L.ldz + CC + j]);
        }
        // post-gate backward: dvl = dv2 * x2 (into dv2), dx2 = dv2 * vl (into x2)
        for (int t = 0; t < V; ++t) {
          const float d = dr[(size_t)t * L.ldc + j];
          dr[(size_t)t * L.ldc + j] = d * cr[(size_t)t * L.ldz + CC + j];
          cr[(size_t)t * L.ldz + CC + j] = d * lr[(size_t)t * L.ldc + j];
        }
        // long conv backward: d kl[tau] = sum_t dvl[t] g[t - tau], kept per
        // window in this thread's column of vl, which is dead from here on
        for (int tau = 0; tau < V; ++tau) {
          float a = 0.f;
          for (int t = tau; t < V; ++t)
            a += dr[(size_t)t * L.ldc + j] * gr[(size_t)(t - tau) * L.ldc + j];
          lr[(size_t)tau * L.ldc + j] = a;
        }
        // dg[t] = sum_m kl[m] dvl[t + m]; pre-gate backward dx1 = dg * v, dv = dg * x1
        for (int t = 0; t < V; ++t) {
          float dg = 0.f;
          for (int m = 0; t + m < V; ++m)
            dg += __ldg(klj + (size_t)m * Cp) * dr[(size_t)(t + m) * L.ldc + j];
          const float x1 = cr[(size_t)t * L.ldz + j], v = cr[(size_t)t * L.ldz + 2 * CC + j];
          cr[(size_t)t * L.ldz + j] = dg * v;
          cr[(size_t)t * L.ldz + 2 * CC + j] = dg * x1;
        }
        // short conv backward per column: dbs, d ws[m] = sum_t dzc[t] z[t - m],
        // dz[t] = sum_m ws[m] dzc[t + m], and dbin = sum_t dz[t]
        for (int s = 0; s < 3; ++s) {
          const int col = s * CC + j;
          float sb = 0.f, si = 0.f;
          for (int t = 0; t < V; ++t) sb += cr[(size_t)t * L.ldz + col];
          for (int m = 0; m < K; ++m) {
            float a = 0.f;
            for (int t = m; t < V; ++t)
              a += cr[(size_t)t * L.ldz + col] * zr[(size_t)(t - m) * L.ldz + col];
            wspart[((size_t)w * K + m) * W3 + col] = a;
          }
          for (int t = 0; t < V; ++t) {
            float a = 0.f;
            for (int m = 0; m < K && t + m < V; ++m)
              a += wsc[m * W3 + col] * cr[(size_t)(t + m) * L.ldz + col];
            dzs[(r0 + t) * L.ldd + col] = from_f32<T>(a);
            si += a;
          }
          bspart[(size_t)w * W3 + col] = sb;
          bipart[(size_t)w * W3 + col] = si;
        }
      }
      __syncthreads();

      // per-window tap and bias gradients, summed over the windows in order
      for (int i = threadIdx.x; i < V * CC; i += kThreads) {
        const int tau = i / CC, j = i % CC;
        float a = 0.f;
        for (int w = 0; w < nwin; ++w) a += vlb[((size_t)w * V + tau) * L.ldc + j];
        float* dst = s_dkl + (size_t)tau * Cp + c0 + j;
        *dst = (first ? 0.f : *dst) + a;
      }
      for (int i = threadIdx.x; i < K * W3; i += kThreads) {
        const int m = i / W3, col = i % W3;
        float a = 0.f;
        for (int w = 0; w < nwin; ++w) a += wspart[((size_t)w * K + m) * W3 + col];
        float* dst = s_dws + (size_t)m * 3 * Cp + (col / CC) * Cp + c0 + col % CC;
        *dst = (first ? 0.f : *dst) + a;
      }
      for (int col = threadIdx.x; col < W3; col += kThreads) {
        float a = 0.f, b = 0.f;
        for (int w = 0; w < nwin; ++w) {
          a += bspart[(size_t)w * W3 + col];
          b += bipart[(size_t)w * W3 + col];
        }
        const size_t at = (size_t)(col / CC) * Cp + c0 + col % CC;
        s_dbs[at] = (first ? 0.f : s_dbs[at]) + a;
        s_dbin[at] = (first ? 0.f : s_dbin[at]) + b;
      }
      // dwo[chunk, :] += v2^T do; dwin[:, cols] += y^T dz; dy += dz win[:, cols]^T
      gemm<true, false>(s_dwo + (size_t)c0 * Cp, Cp, v2s, L.ldv, dos, L.lds, CC, Cp, rows_pad,
                        !first);
      for (int s = 0; s < 3; ++s) {
        gemm<true, false>(s_dwin + s * Cp + c0, 3 * Cp, ys, L.lds, dzs + s * CC, L.ldd, Cp, CC,
                          rows_pad, !first);
        gemm<false, true>(dy, L.lddy, dzs + s * CC, L.ldd, win + s * Cp + c0, 3 * Cp, rows_pad,
                          Cp, CC, true);
      }
      __syncthreads();
    }

    // dbo = sum of do over the rows; with the folded LN, d ln_g and d ln_b
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float so = 0.f, sg = 0.f, sb = 0.f;
      for (int r = 0; r < rows; ++r) {
        so += to_f32(dos[(size_t)r * L.lds + c]);
        if (has_ln) {
          const float d = dy[(size_t)r * L.lddy + c];
          sg += d * (to_f32(xt[(size_t)r * C + c]) - mus[r]) * rstds[r];
          sb += d;
        }
      }
      s_dbo[c] = (first ? 0.f : s_dbo[c]) + so;
      if (has_ln) {
        s_dg[c] = (first ? 0.f : s_dg[c]) + sg;
        s_dbln[c] = (first ? 0.f : s_dbln[c]) + sb;
      }
    }
    T* dxt = dx + base;
    if (has_ln) {
      // LayerNorm backward per row (one warp per row), plus do for the residual
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      const float inv = 1.f / (float)C;
      for (int r = warp; r < rows; r += kWarps) {
        const float mu = mus[r], rstd = rstds[r];
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < C; c += 32) {
          const float xhat = (to_f32(xt[(size_t)r * C + c]) - mu) * rstd;
          const float dxh = dy[(size_t)r * L.lddy + c] * ln_g[c];
          s1 += dxh;
          s2 += dxh * xhat;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        const float m1 = s1 * inv, m2 = s2 * inv;
        for (int c = lane; c < C; c += 32) {
          const float xhat = (to_f32(xt[(size_t)r * C + c]) - mu) * rstd;
          const float dxh = dy[(size_t)r * L.lddy + c] * ln_g[c];
          const float v = rstd * (dxh - m1 - xhat * m2) + to_f32(dos[(size_t)r * L.lds + c]);
          dxt[(size_t)r * C + c] = from_f32<T>(v);
        }
      }
    } else {
      for (int i = threadIdx.x; i < rows * C; i += kThreads) {
        const int r = i / C, c = i % C;
        dxt[i] = from_f32<T>(dy[(size_t)r * L.lddy + c]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_bwd(const void* x, const void* ln_g, const void* ln_b, const void* win, const void* bin,
               const void* ws, const void* bs, const void* kl, const void* wo, const void* dout,
               void* dx, float* slots, float* out, size_t P, HyenaSlots off, int max_slots,
               int BW, int V, int C, int K, int has_ln, cudaStream_t stream) {
  const int limit = max_dynamic_smem();
  int wb = kMaxWindow / V;
  auto bytes_for = [&](int nw) {
    return hyena_bwd_layout(round_up16(nw * V), nw, V, chunk_padded_channels(C), K, sizeof(T)).bytes;
  };
  while (wb > 1 && bytes_for(wb) > (size_t)limit) wb /= 2;
  const size_t bytes = bytes_for(wb);
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(hyena_window_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (BW + wb - 1) / wb;
  const int G = persistent_blocks(hyena_window_bwd_kernel<T>, bytes, tiles, max_slots);
  if (G <= 0) return (int)cudaErrorInvalidValue;
  hyena_window_bwd_kernel<T><<<G, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<const T*>(win), static_cast<const float*>(bin), static_cast<const float*>(ws),
      static_cast<const float*>(bs), static_cast<const float*>(kl), static_cast<const T*>(wo),
      static_cast<const T*>(dout), static_cast<T*>(dx), slots, P, off, BW, V, C, K, wb,
      round_up16(wb * V), has_ln, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(slots, G, P, out, stream);
}

}  // namespace lcbi

// The padded width this library's kernels run on (common.cuh): the wrapper
// lays the weights, taps and biases out at it.
extern "C" int lcbi_padded_channels(int C) { return lcbi::chunk_padded_channels(C); }

// x, dout, dx: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); win: (Cp,
// 3Cp) and wo: (Cp, Cp) in T; bin, bs: (3Cp,), ws: (K, 3Cp), kl: (V, Cp), all
// padded as the forward's (Cp = C rounded up to 32), and, if has_ln, ln_g,
// ln_b: (C,), all fp32. slots: max_slots x P fp32 scratch (P a multiple of 8;
// offsets in floats inside a block's slot: dwin (Cp, 3Cp) at 0, dwo (Cp, Cp)
// at off_dwo, a multiple of 8, then dws (K, 3Cp), dbin, dbs (3Cp), dkl (V,
// Cp), dbo, dg, dbln (C, each at least Cp floats apart)). out: (P,) fp32,
// the slots summed. 1 <= V <= 64, C > 0, all pointers 32-byte aligned.
// Returns cudaGetLastError() of the launches.
extern "C" int lcbi_hyena_window_bwd(const void* x, const void* ln_g, const void* ln_b,
                                     const void* win, const void* bin, const void* ws,
                                     const void* bs, const void* kl, const void* wo,
                                     const void* dout, void* dx, void* slots, void* out, int BW,
                                     int V, int C, int K, int has_ln, int is_bf16, int max_slots,
                                     long long P, int off_dwo, int off_dws, int off_dbin,
                                     int off_dbs, int off_dkl, int off_dbo, int off_dg,
                                     int off_dbln, void* stream) {
  (void)cudaGetLastError();
  if (BW <= 0 || V < 1 || V > lcbi::kMaxWindow || C <= 0 || K < 1 || max_slots < 1 ||
      P % 8 != 0 || off_dwo % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const lcbi::HyenaSlots off{off_dwo, off_dws, off_dbin, off_dbs,
                             off_dkl, off_dbo, off_dg, off_dbln};
  float* sl = static_cast<float*>(slots);
  float* o = static_cast<float*>(out);
  if (is_bf16)
    return lcbi::launch_bwd<__nv_bfloat16>(x, ln_g, ln_b, win, bin, ws, bs, kl, wo, dout, dx, sl,
                                           o, (size_t)P, off, max_slots, BW, V, C, K, has_ln, s);
  return lcbi::launch_bwd<float>(x, ln_g, ln_b, win, bin, ws, bs, kl, wo, dout, dx, sl, o,
                                 (size_t)P, off, max_slots, BW, V, C, K, has_ln, s);
}
