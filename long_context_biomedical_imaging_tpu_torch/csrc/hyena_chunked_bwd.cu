// Chunked Hyena window mixer K3, backward, for windows of 64 < V <= 512 tokens:
//     out = [x +] out_proj(x2 * L(x1 * v)),  [x1 | x2 | v] = shortconv(in_proj([LN](x)))
//     -> dx, [d ln_g, d ln_b,] dwin, dbin, dws, dbs, dwo, dbo given do = d out,
//        and the streams g and dvl (both in T, channel-major) for dM
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/hyena_window.py
// _make_bwd_kernel_chunked in its default `stream` dM mode (launched by
// _bwd_impl_chunked, the custom VJP of _mixer_core_chunked[_ln]); dM itself
// is hyena_dm.cu, as the TPU kernel leaves it to _dm_reduce_pallas.
//
// What bounds it on the H100: the products, recomputed forward ones included:
// in_proj 6*T*C^2 (twice: the backward recomputes the short conv's input per
// row tile as well), dv2 2*T*C^2, dwo 2*T*C^2, dwin 6*T*C^2, dy 6*T*C^2, and
// the Toeplitz products twice (vl again and dg), 2*T*C*chunk*(n+1)/2 each
// (emb stage 0: 851 GFLOP, 0.86 ms at 989 TFLOP/s), against 6*T*C bytes of
// x, do in and dx out plus the two streams out (1.6 GB, 0.48 ms). As the
// forward, the chain is split where the math allows:
//   B1. k3_rows_in (hyena_chunked.cuh) with do: per row tile, [LN], in_proj,
//       short conv, pre-gate and dv2 = do @ wo^T -> g (T, also the g stream),
//       x2 and dv2 (fp32), channel-major;
//   B2. k3_toeplitz_bwd: per (16 windows, channel), vl recomputed by the
//       Toeplitz products, then dvl = dv2 * x2 (rounded to T: the dvl stream
//       and the operand of the transposed products), dx2 = dv2 * vl, v2 =
//       vl * x2 (T), and dg[q - d] += dvl[q] @ M[d]^T;
//   B3. k3_rows_bwd: a persistent grid over row tiles (64 tokens with 16
//       rows of halo each side: the short conv's backward reads dzc of the
//       next K - 1 tokens). Per chunk of 32 channels it recomputes z, the
//       short conv and the gates, forms dzc = [dg * v | dx2 | dg * x1] and
//       takes the short conv backward (dws, dbs, dz, dbin), then
//       dwin += y^T dz and dy += dz @ win^T; per tile dwo += v2^T do, dbo and
//       the LayerNorm backward with the residual.
// Weight gradients go to one fp32 slot per block of B3's persistent grid and
// reduce_slots_kernel sums the slots in a fixed order: no atomics, so two
// launches give the same bits. Operands of the products are rounded to T
// where the TPU kernel rounds them (y, dz, v2, do, g, dvl); the rest is fp32.
#include "hyena_chunked.cuh"

namespace lcbi {

template <typename T>
__global__ void __launch_bounds__(kThreads)
k3_toeplitz_bwd_kernel(const T* __restrict__ g, float* __restrict__ x2_dg,
                       float* __restrict__ dv2_dx2, T* __restrict__ dvl_out,
                       T* __restrict__ v2_out, const T* __restrict__ m, int BW, int V, int C,
                       int chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = V / chunk;
  const ToeplitzLayout L = toeplitz_layout(n, chunk, sizeof(T), true);
  T* gs = reinterpret_cast<T*>(smem);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);
  T* dvs = reinterpret_cast<T*>(smem + L.off_dv);
  const int c = blockIdx.y;
  const int w0 = blockIdx.x * kWindowGroup;
  const int nw = min(kWindowGroup, BW - w0);
  load_group_rows(g, c, w0, nw, BW, V, n, chunk, gs, L.ldg);
  __syncthreads();
  toeplitz_products<false>(acc, L.lda, gs, L.ldg, m, c, C, n, chunk);
  const size_t base = (size_t)c * BW * V + (size_t)w0 * V;
  for (int i = threadIdx.x; i < n * kWindowGroup * chunk; i += kThreads) {
    const int row = i / chunk, r = i % chunk;
    const int q = row / kWindowGroup, b = row % kWindowGroup;
    T dvl = from_f32<T>(0.f);
    if (b < nw) {
      const size_t gi = base + (size_t)b * V + q * chunk + r;
      const float vl = acc[(size_t)row * L.lda + r];
      const float x2 = x2_dg[gi], dv2 = dv2_dx2[gi];
      dvl = from_f32<T>(dv2 * x2);
      dvl_out[gi] = dvl;
      dv2_dx2[gi] = dv2 * vl;
      v2_out[gi] = from_f32<T>(vl * x2);
    }
    dvs[(size_t)row * L.ldg + r] = dvl;
  }
  __syncthreads();
  toeplitz_products<true>(acc, L.lda, dvs, L.ldg, m, c, C, n, chunk);
  for (int i = threadIdx.x; i < n * kWindowGroup * chunk; i += kThreads) {
    const int row = i / chunk, r = i % chunk;
    const int q = row / kWindowGroup, b = row % kWindowGroup;
    if (b < nw) x2_dg[base + (size_t)b * V + q * chunk + r] = acc[(size_t)row * L.lda + r];
  }
}

// Slot offsets (floats) of each gradient inside one block's slot; dwin is at 0.
struct ChunkedSlots {
  int dwo, dws, dbin, dbs, dbo, dg, dbln;
};

struct RowsBwdLayout {
  int lds, ldz, ldd, lddy;
  size_t off_z, off_dzc, off_dz, off_dy, off_ws, off_bias, off_stats, off_dos, bytes;
};

// Row tile of the backward: 16 halo rows, 64 tile rows, 16 halo rows.
constexpr int kBwdRows = kHalo + kRowTile + kHalo;

// stage: room for a tile of do (stage_dout).
__host__ __device__ inline RowsBwdLayout rows_bwd_layout(int Cp, int K, int elem, bool stage) {
  constexpr int W3 = 3 * kChunkChannels;
  RowsBwdLayout L;
  L.lds = Cp + 8;
  L.ldz = W3 + 4;
  L.ldd = W3 + 8;
  L.lddy = Cp + 4;
  L.off_z = align128((size_t)kBwdRows * L.lds * elem);
  L.off_dzc = L.off_z + align128((size_t)kBwdRows * L.ldz * 4);
  L.off_dz = L.off_dzc + align128((size_t)(kRowTile + kHalo) * L.ldz * 4);
  L.off_dy = L.off_dz + align128((size_t)kRowTile * L.ldd * elem);
  L.off_ws = L.off_dy + align128((size_t)kRowTile * L.lddy * 4);
  L.off_bias = L.off_ws + align128((size_t)K * W3 * 4);
  L.off_stats = L.off_bias + align128((size_t)2 * W3 * 4);
  L.off_dos = L.off_stats + align128((size_t)2 * kBwdRows * 4);
  L.bytes = L.off_dos + (stage ? align128((size_t)kRowTile * L.lds * elem) : 0);
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
k3_rows_bwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                   const float* __restrict__ ln_b, const T* __restrict__ win,
                   const float* __restrict__ bin, const float* __restrict__ ws,
                   const float* __restrict__ bs, const T* __restrict__ dout,
                   const float* __restrict__ dg_in, const float* __restrict__ dx2_in,
                   const T* __restrict__ v2, T* __restrict__ dx, float* __restrict__ slots,
                   size_t P, ChunkedSlots off, int BW, int V, int C, int K, int has_ln,
                   long long tiles) {
  constexpr int CC = kChunkChannels, W3 = 3 * kChunkChannels, R = kRowTile, H = kHalo;
  constexpr int NE = R + H;  // conv rows whose dzc the tile needs: tokens t0 .. t0 + R + H - 1
  extern __shared__ __align__(128) unsigned char smem[];
  const int Cp = chunk_padded_channels(C);
  const bool stage = stage_dout(C);
  const RowsBwdLayout L = rows_bwd_layout(Cp, K, sizeof(T), stage);
  T* ys = reinterpret_cast<T*>(smem);
  float* z = reinterpret_cast<float*>(smem + L.off_z);      // in_proj without bias
  float* dzc = reinterpret_cast<float*>(smem + L.off_dzc);  // d(short conv out), rows t0..
  T* dzs = reinterpret_cast<T*>(smem + L.off_dz);           // dz of the tile rows, in T
  float* dy = reinterpret_cast<float*>(smem + L.off_dy);
  float* wsc = reinterpret_cast<float*>(smem + L.off_ws);
  float* binc = reinterpret_cast<float*>(smem + L.off_bias);
  float* bsc = binc + W3;
  float* mus = reinterpret_cast<float*>(smem + L.off_stats);
  float* rstds = mus + kBwdRows;
  T* dos = reinterpret_cast<T*>(smem + L.off_dos);          // a staged tile of do, (R, Cp)

  float* slot = slots + (size_t)blockIdx.x * P;
  float* s_dwin = slot;
  float* s_dwo = slot + off.dwo;
  float* s_dws = slot + off.dws;
  float* s_dbin = slot + off.dbin;
  float* s_dbs = slot + off.dbs;
  float* s_dbo = slot + off.dbo;
  float* s_dg = slot + off.dg;
  float* s_dbln = slot + off.dbln;

  const size_t plane = (size_t)BW * V;
  const int tiles_per_window = V / R;
  const long long t_begin = tiles * blockIdx.x / gridDim.x;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const bool first = tile == t_begin;
    const int w = (int)(tile / tiles_per_window);
    const int t0 = (int)(tile % tiles_per_window) * R;
    const size_t base = ((size_t)w * V + t0) * C;
    load_window_rows(x, w, t0, H, kBwdRows, V, C, Cp, ln_g, ln_b, has_ln, ys, L.lds, mus,
                     rstds);
    if (stage) load_dout_rows(dout, (size_t)w * V + t0, R, C, Cp, dos, L.lds);
    for (int i = threadIdx.x; i < R * L.lddy; i += kThreads) dy[i] = 0.f;

    for (int c0 = 0; c0 < Cp; c0 += CC) {
      load_chunk_taps(ws, bin, bs, Cp, K, c0, wsc, binc, bsc);
      __syncthreads();  // also orders the row loads (and the last chunk's reads) before
      for (int s = 0; s < 3; ++s)
        gemm<false, false>(z + s * CC, L.ldz, ys, L.lds, win + s * Cp + c0, 3 * Cp, kBwdRows, CC,
                           Cp, false);
      __syncthreads();
      // dzc at tokens t0 .. t0 + NE - 1 (zero past the window end), tokens fastest
      for (int p = threadIdx.x; p < NE * CC; p += kThreads) {
        const int j = p / NE, e = p % NE;
        const int tg = t0 + e, row = H + e;
        float* d = dzc + (size_t)e * L.ldz;
        if (tg >= V) {
          d[j] = d[CC + j] = d[2 * CC + j] = 0.f;
          continue;
        }
        const float x1 = short_conv_at(z, L.ldz, row, tg, j, wsc, binc[j], bsc[j], K);
        const float v = short_conv_at(z, L.ldz, row, tg, 2 * CC + j, wsc, binc[2 * CC + j],
                                      bsc[2 * CC + j], K);
        const size_t gi = (size_t)(c0 + j) * plane + (size_t)w * V + tg;
        const float dgv = dg_in[gi];
        d[j] = dgv * v;
        d[CC + j] = dx2_in[gi];
        d[2 * CC + j] = dgv * x1;
      }
      __syncthreads();
      // short conv backward per column over the tile rows: dbs, dws[m] =
      // sum_t dzc[t] (z + bin)[t - m], dz[t] = sum_m ws[m] dzc[t + m], dbin
      for (int col = threadIdx.x; col < W3; col += kThreads) {
        const float bi = binc[col];
        float sb = 0.f, si = 0.f;
        for (int e = 0; e < R; ++e) sb += dzc[(size_t)e * L.ldz + col];
        for (int mm = 0; mm < K; ++mm) {
          float a = 0.f;
          for (int e = 0; e < R; ++e) {
            if (t0 + e - mm < 0) continue;
            a += dzc[(size_t)e * L.ldz + col] * (z[(size_t)(H + e - mm) * L.ldz + col] + bi);
          }
          float* dst = s_dws + (size_t)mm * 3 * Cp + (col / CC) * Cp + c0 + col % CC;
          *dst = (first ? 0.f : *dst) + a;
        }
        for (int e = 0; e < R; ++e) {
          float a = 0.f;
          for (int mm = 0; mm < K; ++mm) a += wsc[mm * W3 + col] * dzc[(size_t)(e + mm) * L.ldz + col];
          dzs[(size_t)e * L.ldd + col] = from_f32<T>(a);
          si += a;
        }
        const size_t at = (size_t)(col / CC) * Cp + c0 + col % CC;
        s_dbs[at] = (first ? 0.f : s_dbs[at]) + sb;
        s_dbin[at] = (first ? 0.f : s_dbin[at]) + si;
      }
      __syncthreads();
      // dwin[:, cols] += y^T dz over the tile rows; dy += dz @ win[:, cols]^T
      for (int s = 0; s < 3; ++s) {
        gemm<true, false>(s_dwin + s * Cp + c0, 3 * Cp, ys + (size_t)H * L.lds, L.lds,
                          dzs + s * CC, L.ldd, Cp, CC, R, !first);
        gemm<false, true>(dy, L.lddy, dzs + s * CC, L.ldd, win + s * Cp + c0, 3 * Cp, R, Cp, CC,
                          true);
      }
      __syncthreads();
    }

    // dwo += v2^T do over the tile rows (v2 channel-major: row c of the
    // operand is channel c's tile, stride BW * V between channels), against
    // the staged tile of do (Cp columns) or do's rows in global memory (C
    // columns, a multiple of 16: dwo's columns past C stay unwritten, and the
    // caller keeps the first C)
    if (stage)
      gemm<false, false>(s_dwo, Cp, v2 + (size_t)w * V + t0, (int)plane, dos, L.lds, Cp, Cp, R,
                         !first);
    else
      gemm<false, false>(s_dwo, Cp, v2 + (size_t)w * V + t0, (int)plane, dout + base, C, Cp, C, R,
                         !first);
    // dbo = sum of do over the rows; with the folded LN, d ln_g and d ln_b
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float so = 0.f, sg = 0.f, sb = 0.f;
      for (int r = 0; r < R; ++r) {
        so += to_f32(dout[base + (size_t)r * C + c]);
        if (has_ln) {
          const float d = dy[(size_t)r * L.lddy + c];
          sg += d * (to_f32(x[base + (size_t)r * C + c]) - mus[H + r]) * rstds[H + r];
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
      for (int r = warp; r < R; r += kWarps) {
        const float mu = mus[H + r], rstd = rstds[H + r];
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < C; c += 32) {
          const float xhat = (to_f32(x[base + (size_t)r * C + c]) - mu) * rstd;
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
          const float xhat = (to_f32(x[base + (size_t)r * C + c]) - mu) * rstd;
          const float dxh = dy[(size_t)r * L.lddy + c] * ln_g[c];
          const float v = rstd * (dxh - m1 - xhat * m2) + to_f32(dout[base + (size_t)r * C + c]);
          dxt[(size_t)r * C + c] = from_f32<T>(v);
        }
      }
    } else {
      for (int i = threadIdx.x; i < R * C; i += kThreads)
        dxt[i] = from_f32<T>(dy[(size_t)(i / C) * L.lddy + i % C]);
    }
    __syncthreads();
  }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T>
int launch_bwd(const void* x, const void* ln_g, const void* ln_b, const void* win,
               const void* bin, const void* ws, const void* bs, const void* m, const void* wo,
               const void* dout, void* dx, void* gs, void* dvl, void* v2, void* fa, void* fb,
               float* slots, float* red, size_t P, ChunkedSlots off, int max_slots, int BW, int V,
               int C, int K, int chunk, int has_ln, cudaStream_t stream) {
  const int n = V / chunk, Cp = chunk_padded_channels(C);
  const long long row_tiles = (long long)BW * V / kRowTile;
  const size_t in_bytes = rows_in_layout(Cp, K, sizeof(T), stage_dout(C)).bytes;
  const size_t tp_bytes = toeplitz_layout(n, chunk, sizeof(T), true).bytes;
  const size_t bwd_bytes = rows_bwd_layout(Cp, K, sizeof(T), stage_dout(C)).bytes;
  int err = prepare(k3_rows_in_kernel<T>, in_bytes);
  if (err == 0) err = prepare(k3_toeplitz_bwd_kernel<T>, tp_bytes);
  if (err == 0) err = prepare(k3_rows_bwd_kernel<T>, bwd_bytes);
  if (err != 0) return err;
  const int G = persistent_blocks(k3_rows_bwd_kernel<T>, bwd_bytes, row_tiles, max_slots);
  if (G <= 0) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dout);
  const float* lg = static_cast<const float*>(ln_g);
  const float* lb = static_cast<const float*>(ln_b);
  const T* wint = static_cast<const T*>(win);
  const float* bint = static_cast<const float*>(bin);
  const float* wst = static_cast<const float*>(ws);
  const float* bst = static_cast<const float*>(bs);
  float* fa32 = static_cast<float*>(fa);
  float* fb32 = static_cast<float*>(fb);
  k3_rows_in_kernel<T><<<(unsigned)row_tiles, kThreads, in_bytes, stream>>>(
      xt, lg, lb, wint, bint, wst, bst, dt, static_cast<const T*>(wo), static_cast<T*>(gs), fa32,
      fb32, BW, V, C, K, has_ln);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const dim3 groups((unsigned)((BW + kWindowGroup - 1) / kWindowGroup), (unsigned)Cp);
  k3_toeplitz_bwd_kernel<T><<<groups, kThreads, tp_bytes, stream>>>(
      static_cast<const T*>(gs), fa32, fb32, static_cast<T*>(dvl), static_cast<T*>(v2),
      static_cast<const T*>(m), BW, V, Cp, chunk);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  k3_rows_bwd_kernel<T><<<G, kThreads, bwd_bytes, stream>>>(
      xt, lg, lb, wint, bint, wst, bst, dt, fa32, fb32, static_cast<const T*>(v2),
      static_cast<T*>(dx), slots, P, off, BW, V, C, K, has_ln, row_tiles);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  return launch_reduce(slots, G, P, red, stream);
}

}  // namespace lcbi

// The padded width this library's kernels run on (common.cuh): the wrapper
// lays the weights, taps and biases out at it.
extern "C" int lcbi_padded_channels(int C) { return lcbi::chunk_padded_channels(C); }

// x, dout, dx: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); win: (Cp,
// 3Cp), wo: (Cp, Cp) and m: (V / chunk, Cp, chunk, chunk) in T; bin, bs: (3Cp,),
// ws: (K, 3Cp) fp32, padded as the forward's (Cp = C rounded up to 32), and,
// if has_ln, ln_g, ln_b: (C,) fp32. gs, dvl (out: the streams of g and dvl)
// and v2 (scratch): Cp * BW * V of T; fa, fb: Cp * BW * V fp32 scratch.
// slots: max_slots x P fp32 scratch (P a multiple of 8; offsets in floats
// inside a block's slot: dwin (Cp, 3Cp) at 0, dwo (Cp, Cp) at off_dwo, a
// multiple of 8, then dws (K, 3Cp), dbin, dbs (3Cp), dbo, dg, dbln (C, each
// at least Cp floats apart)). red: (P,) fp32, the slots summed. V % 64 == 0,
// chunk 64 or 128 dividing V, C > 0, 1 <= K <= 16, all pointers 32-byte
// aligned. Returns cudaGetLastError() of the launches.
extern "C" int lcbi_hyena_chunked_bwd(const void* x, const void* ln_g, const void* ln_b,
                                      const void* win, const void* bin, const void* ws,
                                      const void* bs, const void* m, const void* wo,
                                      const void* dout, void* dx, void* gs, void* dvl, void* v2,
                                      void* fa, void* fb, void* slots, void* red, int BW, int V,
                                      int C, int K, int chunk, int has_ln, int is_bf16,
                                      int max_slots, long long P, int off_dwo, int off_dws,
                                      int off_dbin, int off_dbs, int off_dbo, int off_dg,
                                      int off_dbln, void* stream) {
  (void)cudaGetLastError();
  if (BW <= 0 || V <= 0 || V % lcbi::kRowTile != 0 || (chunk != 64 && chunk != 128) ||
      V % chunk != 0 || C <= 0 || K < 1 || K > lcbi::kMaxTaps || max_slots < 1 || P % 8 != 0 ||
      off_dwo % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const lcbi::ChunkedSlots off{off_dwo, off_dws, off_dbin, off_dbs, off_dbo, off_dg, off_dbln};
  float* sl = static_cast<float*>(slots);
  float* r = static_cast<float*>(red);
  if (is_bf16)
    return lcbi::launch_bwd<__nv_bfloat16>(x, ln_g, ln_b, win, bin, ws, bs, m, wo, dout, dx, gs,
                                           dvl, v2, fa, fb, sl, r, (size_t)P, off, max_slots, BW,
                                           V, C, K, chunk, has_ln, s);
  return lcbi::launch_bwd<float>(x, ln_g, ln_b, win, bin, ws, bs, m, wo, dout, dx, gs, dvl, v2,
                                 fa, fb, sl, r, (size_t)P, off, max_slots, BW, V, C, K, chunk,
                                 has_ln, s);
}
