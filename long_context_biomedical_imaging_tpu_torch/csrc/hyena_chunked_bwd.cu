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
// What bounds it on the H100: bytes. The products (in_proj recomputed, dv2,
// dwin, dwo, dy: 20*T*C^2 FLOPs for T tokens, and the Toeplitz products
// twice, 2*T*C*chunk*(n+1)/2 each; emb stage 0: 0.7 TFLOP, 0.7 ms at 989
// TFLOP/s) are few for the streams the chain has to pass between its
// per-token and its per-channel halves. The design, for Hopper: the chain
// splits where the math allows, and every product runs in the shared
// kernels of mma_gemm.cuh (mma.sync fragments fed by a cp.async ring in
// bf16; FMA tiles in fp32) on the true widths, with the tails masked, so the
// weights, taps, biases and Toeplitz blocks are taken as they are:
//   1. [LN] ln_rows_kernel (ln_rows.cuh): y = LN(x) in T (else y = x);
//   2. gemm_rows: z = y @ win, fp32 (T, 3C) row-major (the forward's
//      in_proj without its bias, recomputed once: the gates and dz kernels
//      both read it and recompute the short conv from it);
//   3. gemm_rows: dv2 = do @ wo^T, written channel-major (C, T) fp32 as
//      wo @ do^T;
//   4. k3_gates_kernel: per (64-token tile, 32 channels), the short conv of
//      z + bin and the pre-gate: g = v x1 (T, channel-major: the g stream)
//      and x2 (fp32, channel-major);
//   5. k3_toeplitz_bwd_kernel: per (16 windows, channel), vl recomputed by
//      the Toeplitz products (each block M[d] staged in shared memory), then
//      dvl = dv2 x2 (rounded to T: the dvl stream and the operand of the
//      transposed products), dx2 = dv2 vl, v2 = vl x2 (T), and dg[q - d] +=
//      dvl[q] @ M[d]^T;
//   6. k3_dz_kernel: a persistent grid over (64-token tiles, 32 channels):
//      the short conv recomputed from z (15 rows of halo each side), dzc =
//      [dg v | dx2 | dg x1], the short conv's backward spread over every
//      thread of the block (dz = sum_m ws[m] dzc[t + m], rounded to T, row-
//      major; dws, dbs, dbin summed per block in a fixed order);
//   7. the split-K kernel: dwin = y^T dz and dwo = v2 do (v2 channel-major);
//   8. gemm_rows: dy = dz @ win^T, fp32;
//   9. ln_bwd_kernel (ln_rows.cuh): the LayerNorm backward with the residual
//      (dx = dy without the LN), d ln_g, d ln_b and dbo.
// The small sums go to one fp32 slot per block of the persistent grids and
// reduce_slots_kernel sums the slots in a fixed order; the split-K partials
// are summed in a fixed order too: no atomics, so two launches give the same
// bits. Operands of the products are rounded to T where the TPU kernel rounds
// them (y, dz, v2, do, g, dvl); the rest is fp32.
//
// Streams between the launches, for T tokens at width C: z (12 T C bytes),
// dz (6 T C in bf16), dv2, x2 -> dg, dx2 and dy (4 T C each, fp32), y, g, dvl
// and v2 (2 T C each in bf16): at emb stage 0 (T = 2^21, C = 96, bf16) about
// 7.6 GB of workspace, which the wrapper allocates per call, and about 26 GB
// written and read between the launches (z is read twice, with 15 and 30
// rows of halo a 64-token tile), some 8 ms at 3.35 TB/s.
#include "hyena_chunked.cuh"
#include "ln_rows.cuh"
#include "mma_gemm.cuh"

namespace lcbi {

// acc (fp32) = the causal long conv of the rows in gs: acc[q] = sum_{d <= q}
// gs[q - d] @ M[d][c] (TRANS: acc[q - d] += gs[q] @ M[d][c]^T, the transpose,
// for dg), m holding C channels. Each block M[d][c] is first staged into ms
// (ld chunk + 8) by 16-byte copies of the whole block, so that the products'
// fragments come from shared memory instead of one device-memory round trip
// each. Products in T, fp32 sums; the caller syncs before.
template <bool TRANS, typename T>
__device__ void toeplitz_products(float* acc, int lda, const T* gs, int ldg,
                                  const T* __restrict__ m, int c, int C, int n, int chunk, T* ms) {
  constexpr int G = kWindowGroup, kVec = 16 / sizeof(T);
  const int ldm = chunk + 8, per = chunk / kVec;
  for (int d = 0; d < n; ++d) {
    const T* md = m + ((size_t)d * C + c) * chunk * chunk;
    for (int i = threadIdx.x; i < chunk * per; i += kThreads) {
      const int r = i / per, q = (i % per) * kVec;
      *reinterpret_cast<uint4*>(ms + r * ldm + q) =
          *reinterpret_cast<const uint4*>(md + (size_t)r * chunk + q);
    }
    __syncthreads();
    if (TRANS)
      gemm<false, true>(acc, lda, gs + (size_t)d * G * ldg, ldg, ms, ldm, (n - d) * G, chunk,
                        chunk, d > 0);
    else
      gemm<false, false>(acc + (size_t)d * G * lda, lda, gs, ldg, ms, ldm, (n - d) * G, chunk,
                         chunk, d > 0);
    __syncthreads();  // the next distance restages ms and may give a tile to another warp
  }
}

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
  T* ms = reinterpret_cast<T*>(smem + L.off_m);
  T* dvs = reinterpret_cast<T*>(smem + L.off_dv);
  const int c = blockIdx.y;
  const int w0 = blockIdx.x * kWindowGroup;
  const int nw = min(kWindowGroup, BW - w0);
  load_group_rows(g, c, w0, nw, BW, V, n, chunk, gs, L.ldg);
  __syncthreads();
  toeplitz_products<false>(acc, L.lda, gs, L.ldg, m, c, C, n, chunk, ms);
  const size_t base = (size_t)c * BW * V + (size_t)w0 * V;
  // in batches of 8 elements a thread, all loads of a batch before its
  // stores (a store to dv2_dx2 would otherwise hold back the next load)
  constexpr int kBatch = 8;
  const int total = n * kWindowGroup * chunk;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kThreads) {
    float x2v[kBatch], dv2v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, row = i / chunk, r = i % chunk;
      const int q = row / kWindowGroup, b = row % kWindowGroup;
      x2v[u] = dv2v[u] = 0.f;
      if (i < total && b < nw) {
        const size_t gi = base + (size_t)b * V + q * chunk + r;
        x2v[u] = x2_dg[gi];
        dv2v[u] = dv2_dx2[gi];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, row = i / chunk, r = i % chunk;
      const int q = row / kWindowGroup, b = row % kWindowGroup;
      if (i >= total) break;
      T dvl = from_f32<T>(0.f);
      if (b < nw) {
        const size_t gi = base + (size_t)b * V + q * chunk + r;
        const float vl = acc[(size_t)row * L.lda + r];
        dvl = from_f32<T>(dv2v[u] * x2v[u]);
        dvl_out[gi] = dvl;
        dv2_dx2[gi] = dv2v[u] * vl;
        v2_out[gi] = from_f32<T>(vl * x2v[u]);
      }
      dvs[(size_t)row * L.ldg + r] = dvl;
    }
  }
  __syncthreads();
  toeplitz_products<true>(acc, L.lda, dvs, L.ldg, m, c, C, n, chunk, ms);
  for (int i = threadIdx.x; i < n * kWindowGroup * chunk; i += kThreads) {
    const int row = i / chunk, r = i % chunk;
    const int q = row / kWindowGroup, b = row % kWindowGroup;
    if (b < nw) x2_dg[base + (size_t)b * V + q * chunk + r] = acc[(size_t)row * L.lda + r];
  }
}

constexpr int kConvHalo = 15;                        // rows of halo: K - 1 <= 15
constexpr int kZbLd = 3 * kChunkChannels + 1;        // fp32 (rows, 96) tiles
constexpr int kGateRows = kConvHalo + kRowTile;      // z rows of a gates tile
constexpr int kDzRows = kConvHalo + kRowTile + kConvHalo;   // z rows of a dz tile
constexpr int kDzcRows = kRowTile + kConvHalo;       // dzc rows of a dz tile

// Rows [0, ROWS) of a tile into zb (ld kZbLd): row r holds token t0 -
// kConvHalo + r of window w, column j the chunk's channel c0 + j % 32 of block
// j / 32 of [x1 | x2 | v]: z + bin in fp32, zero for tokens outside [0, V)
// and channels past C (so a tap that reaches before the window start adds
// 0). Where C % 4 == 0 the rows go by 16-byte loads, all of a thread's loads
// issued before its stores.
template <int ROWS>
__device__ __forceinline__ void load_zb(const float* __restrict__ zf,
                                        const float* __restrict__ bin, int w, int t0, int V,
                                        int C, int c0, float* zb) {
  constexpr int W3 = 3 * kChunkChannels, Q4 = W3 / 4;
  const size_t C3 = (size_t)3 * C;
  if (C % 4 == 0) {
    constexpr int kItems = (ROWS * Q4 + kThreads - 1) / kThreads;
    float4 v[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = threadIdx.x + it * kThreads, r = i / Q4, q = i % Q4;
      const int tg = t0 - kConvHalo + r, c = c0 + (q % 8) * 4;
      v[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < ROWS * Q4 && tg >= 0 && tg < V && c < C)
        v[it] = *reinterpret_cast<const float4*>(zf + ((size_t)w * V + tg) * C3 +
                                                 (size_t)(q / 8) * C + c);
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = threadIdx.x + it * kThreads, r = i / Q4, q = i % Q4;
      if (i >= ROWS * Q4) continue;
      const int tg = t0 - kConvHalo + r, c = c0 + (q % 8) * 4;
      const bool live = tg >= 0 && tg < V && c < C;
      const float* b = bin + (q / 8) * C + c;
      float* d = zb + r * kZbLd + q * 4;
      d[0] = live ? v[it].x + b[0] : 0.f;
      d[1] = live ? v[it].y + b[1] : 0.f;
      d[2] = live ? v[it].z + b[2] : 0.f;
      d[3] = live ? v[it].w + b[3] : 0.f;
    }
    return;
  }
  for (int i = threadIdx.x; i < ROWS * W3; i += kThreads) {
    const int r = i / W3, j = i % W3, tg = t0 - kConvHalo + r, c = c0 + j % kChunkChannels;
    const int col = (j / kChunkChannels) * C + c;
    zb[r * kZbLd + j] = tg >= 0 && tg < V && c < C
                            ? zf[((size_t)w * V + tg) * C3 + col] + bin[col]
                            : 0.f;
  }
}

// The chunk's short taps (K, 96) and biases (96), zero past C.
__device__ __forceinline__ void load_taps(const float* __restrict__ ws,
                                          const float* __restrict__ bs, int C, int K, int c0,
                                          float* wsc, float* bsc) {
  constexpr int W3 = 3 * kChunkChannels;
  for (int i = threadIdx.x; i < (K + 1) * W3; i += kThreads) {
    const int m = i / W3, j = i % W3, c = c0 + j % kChunkChannels;
    const int col = (j / kChunkChannels) * C + c;
    const float v = c < C ? (m < K ? ws[(size_t)m * 3 * C + col] : bs[col]) : 0.f;
    if (m < K) wsc[i] = v; else bsc[j] = v;
  }
}

// The causal short conv of column j at zb row `row`: bs + sum_m zb[row - m]
// ws[m], m ascending (the forward's order).
__device__ __forceinline__ float conv_at(const float* zb, int row, int j, const float* wsc,
                                         const float* bsc, int K) {
  constexpr int W3 = 3 * kChunkChannels;
  float a = bsc[j];
  for (int m = 0; m < K; ++m) a += zb[(row - m) * kZbLd + j] * wsc[m * W3 + j];
  return a;
}

// Step 4: g = v x1 (T) and x2 (fp32), channel-major (C, BW V). grid (row
// tiles, ceil(C / 32)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
k3_gates_kernel(const float* __restrict__ zf, const float* __restrict__ bin,
                const float* __restrict__ ws, const float* __restrict__ bs, T* __restrict__ g_out,
                float* __restrict__ x2_out, int BW, int V, int C, int K) {
  constexpr int CC = kChunkChannels, W3 = 3 * kChunkChannels;
  extern __shared__ __align__(128) unsigned char smem[];
  float* zb = reinterpret_cast<float*>(smem);
  float* wsc = zb + kGateRows * kZbLd;
  float* bsc = wsc + K * W3;
  const int tiles_per_window = V / kRowTile;
  const int w = blockIdx.x / tiles_per_window, t0 = (blockIdx.x % tiles_per_window) * kRowTile;
  const int c0 = blockIdx.y * CC;
  const size_t plane = (size_t)BW * V;
  load_taps(ws, bs, C, K, c0, wsc, bsc);
  load_zb<kGateRows>(zf, bin, w, t0, V, C, c0, zb);
  __syncthreads();
  // tokens fastest: a warp's stores are 32 neighbouring tokens of a channel
  for (int p = threadIdx.x; p < kRowTile * CC; p += kThreads) {
    const int j = p / kRowTile, e = p % kRowTile, c = c0 + j;
    if (c >= C) continue;
    const int row = kConvHalo + e;
    const float x1 = conv_at(zb, row, j, wsc, bsc, K);
    const float x2 = conv_at(zb, row, CC + j, wsc, bsc, K);
    const float v = conv_at(zb, row, 2 * CC + j, wsc, bsc, K);
    const size_t gi = (size_t)c * plane + (size_t)w * V + t0 + e;
    g_out[gi] = from_f32<T>(v * x1);
    x2_out[gi] = x2;
  }
}

// Slot offsets (floats) of the small gradients inside one block's slot: the
// short conv's (k3_dz_kernel, over its grid) at dws = 0, dbin, dbs, then
// from dbo on the row pass's (ln_bwd_kernel, over all the slots).
struct ChunkedSlots {
  int dbin, dbs, dbo, dg, dbln;
};

struct DzLayout {
  size_t off_dzc, off_ws, off_bs, off_part, bytes;
};

// The tile's z rows and dzc rows, the taps, and each thread's running sums
// (warp, column block, K + 2, lane).
__host__ __device__ inline DzLayout dz_layout(int K) {
  constexpr int W3 = 3 * kChunkChannels;
  DzLayout L;
  L.off_dzc = align128((size_t)kDzRows * kZbLd * 4);
  L.off_ws = L.off_dzc + align128((size_t)kDzcRows * kZbLd * 4);
  L.off_bs = L.off_ws + align128((size_t)K * W3 * 4);
  L.off_part = L.off_bs + align128((size_t)W3 * 4);
  L.bytes = L.off_part + align128((size_t)kWarps * 3 * (K + 2) * kChunkChannels * 4);
  return L;
}

// Step 6, a persistent grid (G, ceil(C / 32)): block (b, y) walks row tiles
// [tiles b / G, tiles (b + 1) / G) for channels [32 y, 32 y + 32). Per tile:
// dg and dx2 at tokens t0 .. t0 + 78 (zero past the window end) into dzc,
// then lane l of warp q takes column l at tokens [10 q, 10 q + 10): x1 and v
// by the short conv from z rows held in registers, dzc = [dg v | dx2 | dg
// x1]. Then for each column block of [x1 | x2 | v], lane l of warp q takes
// column l at tokens [8 q, 8 q + 8) with its dzc and z rows in registers:
// dz (stored in T, row-major (BW V, 3C)) and its terms of dws, dbs and dbin,
// which the thread adds, per tile and in order, to its own running sums in
// shared memory. At the end the block sums its warps in order and writes its
// slot once. KMAX bounds the taps (8, or 16) so that every register index is
// a constant.
template <typename T, int KMAX>
__global__ void __launch_bounds__(kThreads, KMAX <= 8 ? 2 : 1)
k3_dz_kernel(const float* __restrict__ zf, const float* __restrict__ bin,
             const float* __restrict__ ws, const float* __restrict__ bs,
             const float* __restrict__ dg_in, const float* __restrict__ dx2_in, T* __restrict__ dz,
             float* __restrict__ slots, size_t P, ChunkedSlots off, int BW, int V, int C, int K,
             long long tiles) {
  constexpr int CC = kChunkChannels, W3 = 3 * kChunkChannels, R = kRowTile;
  constexpr int kPer = R / kWarps;                          // dz tokens of a warp
  constexpr int kConvPer = (kDzcRows + kWarps - 1) / kWarps;  // dzc tokens of a warp
  constexpr int kLoadItems = (kDzcRows * CC + kThreads - 1) / kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  const DzLayout L = dz_layout(K);
  float* zb = reinterpret_cast<float*>(smem);
  float* dzc = reinterpret_cast<float*>(smem + L.off_dzc);
  float* wsc = reinterpret_cast<float*>(smem + L.off_ws);
  float* bsc = reinterpret_cast<float*>(smem + L.off_bs);
  const int c0 = blockIdx.y * CC, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tiles_per_window = V / R;
  const size_t plane = (size_t)BW * V, C3 = (size_t)3 * C;
  const bool live = c0 + lane < C;
  // the thread's sums, per column block: dws[m] (m < K), dbs, dbin
  float* part = reinterpret_cast<float*>(smem + L.off_part);
  float* mine = part + (size_t)warp * 3 * (K + 2) * CC + lane;
  load_taps(ws, bs, C, K, c0, wsc, bsc);
  for (int q = 0; q < 3 * (K + 2); ++q) mine[q * CC] = 0.f;
  const long long t_begin = tiles * blockIdx.x / gridDim.x;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const int w = (int)(tile / tiles_per_window);
    const int t0 = (int)(tile % tiles_per_window) * R;
    __syncthreads();   // the last tile's reads of zb and dzc are done
    load_zb<kDzRows>(zf, bin, w, t0, V, C, c0, zb);
    {
      // dg into dzc's x1 column, dx2 into its x2 column; tokens fastest
      float dgv[kLoadItems], dxv[kLoadItems];
#pragma unroll
      for (int it = 0; it < kLoadItems; ++it) {
        const int p = threadIdx.x + it * kThreads, j = p / kDzcRows, e = p % kDzcRows;
        dgv[it] = dxv[it] = 0.f;
        if (p < kDzcRows * CC && t0 + e < V && c0 + j < C) {
          const size_t gi = (size_t)(c0 + j) * plane + (size_t)w * V + t0 + e;
          dgv[it] = dg_in[gi];
          dxv[it] = dx2_in[gi];
        }
      }
#pragma unroll
      for (int it = 0; it < kLoadItems; ++it) {
        const int p = threadIdx.x + it * kThreads, j = p / kDzcRows, e = p % kDzcRows;
        if (p >= kDzcRows * CC) continue;
        dzc[e * kZbLd + j] = dgv[it];
        dzc[e * kZbLd + CC + j] = dxv[it];
      }
    }
    __syncthreads();
    {
      // x1 and v at the warp's dzc tokens from z rows e - KMAX + 1 .. in
      // registers (zero past C and outside the window: dg is zero there too)
      constexpr int kRows = kConvPer + KMAX - 1;
      const int e0 = warp * kConvPer;
      float r1[kRows], rv[kRows], w1[KMAX], wv[KMAX];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = kConvHalo + e0 - (KMAX - 1) + i;
        const bool in = row < kDzRows;
        r1[i] = in ? zb[row * kZbLd + lane] : 0.f;
        rv[i] = in ? zb[row * kZbLd + 2 * CC + lane] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < KMAX; ++m) {
        w1[m] = m < K ? wsc[m * W3 + lane] : 0.f;
        wv[m] = m < K ? wsc[m * W3 + 2 * CC + lane] : 0.f;
      }
      const float b1 = bsc[lane], bv = bsc[2 * CC + lane];
#pragma unroll
      for (int ei = 0; ei < kConvPer; ++ei) {
        const int e = e0 + ei;
        if (e >= kDzcRows) break;
        float x1 = b1, v = bv;
#pragma unroll
        for (int m = 0; m < KMAX; ++m) {
          if (m < K) {
            x1 += r1[ei + KMAX - 1 - m] * w1[m];
            v += rv[ei + KMAX - 1 - m] * wv[m];
          }
        }
        const float dgv = dzc[e * kZbLd + lane];
        dzc[e * kZbLd + lane] = dgv * v;
        dzc[e * kZbLd + 2 * CC + lane] = dgv * x1;
      }
    }
    __syncthreads();
#pragma unroll
    for (int blk = 0; blk < 3; ++blk) {
      constexpr int kRows = kPer + KMAX - 1;
      const int col = blk * CC + lane, e0 = warp * kPer;
      float dr[kRows], zr[kRows], wr[KMAX];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        dr[i] = dzc[(e0 + i) * kZbLd + col];
        zr[i] = zb[(kConvHalo + e0 - (KMAX - 1) + i) * kZbLd + col];
      }
#pragma unroll
      for (int m = 0; m < KMAX; ++m) wr[m] = m < K ? wsc[m * W3 + col] : 0.f;
      T* dzrow = dz + ((size_t)w * V + t0 + e0) * C3 + (size_t)blk * C + c0 + lane;
      float pw[KMAX], pb = 0.f, pi = 0.f;
#pragma unroll
      for (int m = 0; m < KMAX; ++m) pw[m] = 0.f;
#pragma unroll
      for (int ei = 0; ei < kPer; ++ei) {
        const float d = dr[ei];
        float a = 0.f;
#pragma unroll
        for (int m = 0; m < KMAX; ++m) {
          if (m < K) {
            a += wr[m] * dr[ei + m];
            pw[m] += d * zr[ei + KMAX - 1 - m];
          }
        }
        pb += d;
        pi += a;
        if (live) dzrow[(size_t)ei * C3] = from_f32<T>(a);
      }
      float* sums = mine + (size_t)blk * (K + 2) * CC;
#pragma unroll
      for (int m = 0; m < KMAX; ++m)
        if (m < K) sums[m * CC] += pw[m];
      sums[K * CC] += pb;
      sums[(K + 1) * CC] += pi;
    }
  }
  // the warps' sums, (warp, blk, K + 2, 32), summed over the warps in order
  __syncthreads();
  float* slot = slots + (size_t)blockIdx.x * P;
  for (int i = threadIdx.x; i < 3 * (K + 2) * CC; i += kThreads) {
    const int blk = i / ((K + 2) * CC), q = (i / CC) % (K + 2), l = i % CC, c = c0 + l;
    if (c >= C) continue;
    float sum = 0.f;
    for (int wq = 0; wq < kWarps; ++wq) sum += part[(size_t)(wq * 3 + blk) * (K + 2) * CC + q * CC + l];
    const int col = blk * C + c;
    if (q < K) {
      slot[(size_t)q * C3 + col] = sum;
    } else {
      slot[(q == K ? off.dbs : off.dbin) + col] = sum;
    }
  }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// Splits of the weight gradients' rows (mma_gemm.cuh wgrad_splits_for) for
// dwin (C, 3C) and dwo (C, C) at T of the matmul type. 0 on a device error.
template <typename T> int k3_wgrad_splits(long long N, int C) {
  constexpr int kTile = TileOf<T>::v;
  const long long tiles =
      (long long)ceil_div(C, kTile) * (ceil_div(3 * C, kTile) + ceil_div(C, kTile));
  return wgrad_splits_for(N, tiles);
}

// The backward's workspace, carved in this order (each part 256-byte
// aligned): y (with the LN), z, x2/dg, dv2/dx2, v2, dz, dy, the split-K
// partials.
struct K3Work {
  size_t ys, zf, fa, fb, v2, dz, dy, part, bytes;
};

__host__ __device__ inline size_t align256(size_t b) { return (b + 255) & ~size_t(255); }

template <typename T> K3Work k3_work(long long N, int C, int has_ln, int S) {
  K3Work W;
  const size_t e = sizeof(T), nc = (size_t)N * C;
  W.ys = 0;
  W.zf = W.ys + (has_ln ? align256(nc * e) : 0);
  W.fa = W.zf + align256(3 * nc * 4);
  W.fb = W.fa + align256(nc * 4);
  W.v2 = W.fb + align256(nc * 4);
  W.dz = W.v2 + align256(nc * e);
  W.dy = W.dz + align256(3 * nc * e);
  W.part = W.dy + align256(nc * 4);
  W.bytes = W.part + align256((size_t)S * 4 * C * C * 4);
  return W;
}

template <typename T>
int launch_bwd(const void* x, const void* ln_g, const void* ln_b, const void* win,
               const void* bin, const void* ws, const void* bs, const void* m, const void* wo,
               const void* dout, void* dx, void* gs, void* dvl, unsigned char* work,
               float* wgrads, float* slots, float* red, size_t P, ChunkedSlots off,
               int max_slots, int BW, int V, int C, int K, int chunk, int has_ln,
               cudaStream_t stream) {
  const long long N = (long long)BW * V, tiles = N / kRowTile;
  const int S = k3_wgrad_splits<T>(N, C);
  if (S <= 0) return (int)cudaErrorInvalidValue;
  const K3Work W = k3_work<T>(N, C, has_ln, S);
  const int n = V / chunk, chunks = ceil_div(C, kChunkChannels);
  const T* xt = static_cast<const T*>(x);
  const T* dot = static_cast<const T*>(dout);
  const T* wint = static_cast<const T*>(win);
  const T* ys = has_ln ? reinterpret_cast<const T*>(work + W.ys) : xt;
  float* zf = reinterpret_cast<float*>(work + W.zf);
  float* fa = reinterpret_cast<float*>(work + W.fa);
  float* fb = reinterpret_cast<float*>(work + W.fb);
  T* v2 = reinterpret_cast<T*>(work + W.v2);
  T* dzs = reinterpret_cast<T*>(work + W.dz);
  float* dyf = reinterpret_cast<float*>(work + W.dy);
  float* partials = reinterpret_cast<float*>(work + W.part);
  const float* binf = static_cast<const float*>(bin);
  const float* wsf = static_cast<const float*>(ws);
  const float* bsf = static_cast<const float*>(bs);
  const size_t gates_bytes = ((size_t)kGateRows * kZbLd + (K + 1) * 3 * kChunkChannels) * 4;
  const size_t tp_bytes = toeplitz_layout(n, chunk, sizeof(T), true).bytes;
  const size_t dz_bytes = dz_layout(K).bytes;
  // the dz kernel keeps its tap sums in registers: 8 taps (the models' 5) or 16
  auto dz_kernel = K <= 8 ? k3_dz_kernel<T, 8> : k3_dz_kernel<T, kMaxTaps>;
  int e = prepare(k3_gates_kernel<T>, gates_bytes);
  if (e == 0) e = prepare(k3_toeplitz_bwd_kernel<T>, tp_bytes);
  if (e == 0) e = prepare(dz_kernel, dz_bytes);
  if (e != 0) return e;
  // the dz grid: as many blocks as fit at once over all the channel chunks
  int G = persistent_blocks(dz_kernel, dz_bytes, tiles * chunks, max_slots * chunks);
  G = G / chunks > 0 ? G / chunks : 1;
  if (G > tiles) G = (int)tiles;
  if (has_ln &&
      (e = launch_ln_rows<T>(x, ln_g, ln_b, const_cast<T*>(ys), N, C, stream)) != 0)
    return e;
  // z = y @ win (win (C, 3C): stored (K, N))
  if ((e = launch_gemm_rows<T, false>(ys, C, wint, 3 * C, (int)N, 3 * C, C, zf, stream)) != 0)
    return e;
  // dv2 channel-major: (C, T) = wo @ do^T (do stored (N = T, K = C))
  if ((e = launch_gemm_rows<T, true>(static_cast<const T*>(wo), C, dot, C, C, (int)N, C, fb,
                                     stream)) != 0)
    return e;
  k3_gates_kernel<T><<<dim3((unsigned)tiles, (unsigned)chunks), kThreads, gates_bytes, stream>>>(
      zf, binf, wsf, bsf, static_cast<T*>(gs), fa, BW, V, C, K);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  const dim3 groups((unsigned)((BW + kWindowGroup - 1) / kWindowGroup), (unsigned)C);
  k3_toeplitz_bwd_kernel<T><<<groups, kThreads, tp_bytes, stream>>>(
      static_cast<const T*>(gs), fa, fb, static_cast<T*>(dvl), v2, static_cast<const T*>(m), BW,
      V, C, chunk);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  dz_kernel<<<dim3((unsigned)G, (unsigned)chunks), kThreads, dz_bytes, stream>>>(
      zf, binf, wsf, bsf, fa, fb, dzs, slots, P, off, BW, V, C, K, tiles);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  // dwin = y^T dz (C, 3C) at 0, dwo = v2 do (C, C) after it (v2 stored (C, T))
  Products<T> ps{};
  ps.count = 2;
  ps.p[0] = Product<T>{ys, dzs, C, 3 * C, C, 3 * C, 0};
  ps.p[1] = Product<T>{v2, dot, (int)N, C, C, C, (size_t)3 * C * C, true};
  if ((e = launch_split_k<T>(ps, N, S, (size_t)4 * C * C, partials, wgrads, stream)) != 0)
    return e;
  // dy = dz @ win^T (win (C, 3C): stored (N = C, K = 3C))
  if ((e = launch_gemm_rows<T, true>(dzs, 3 * C, wint, 3 * C, (int)N, C, 3 * C, dyf, stream)) !=
      0)
    return e;
  if ((e = launch_ln_bwd<T>(dyf, x, dout, ln_g, dx, slots, P, LnSlots{off.dg, off.dbln, off.dbo},
                            max_slots, N, C, has_ln, stream)) != 0)
    return e;
  if ((e = launch_reduce(slots, G, P, (size_t)off.dbo, red, stream)) != 0) return e;
  return launch_reduce(slots + off.dbo, max_slots, P, P - off.dbo, red + off.dbo, stream);
}

}  // namespace lcbi

// Bytes of workspace lcbi_hyena_chunked_bwd needs (0 on a device error).
extern "C" size_t lcbi_hyena_chunked_bwd_workspace(int BW, int V, int C, int has_ln,
                                                   int is_bf16) {
  const long long N = (long long)BW * V;
  if (is_bf16) {
    const int S = lcbi::k3_wgrad_splits<__nv_bfloat16>(N, C);
    return S > 0 ? lcbi::k3_work<__nv_bfloat16>(N, C, has_ln, S).bytes : 0;
  }
  const int S = lcbi::k3_wgrad_splits<float>(N, C);
  return S > 0 ? lcbi::k3_work<float>(N, C, has_ln, S).bytes : 0;
}

// x, dout, dx: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); win: (C,
// 3C), wo: (C, C) and m: (V / chunk, C, chunk, chunk) in T; bin, bs: (3C,),
// ws: (K, 3C) fp32, and, if has_ln, ln_g, ln_b: (C,) fp32: the true widths.
// gs, dvl (out: the streams of g and dvl): (C, BW, V) of T. work:
// lcbi_hyena_chunked_bwd_workspace bytes. wgrads (out): dwin (C, 3C) then
// dwo (C, C), fp32. slots: max_slots x P fp32 scratch (P a multiple of 8;
// offsets in floats inside a block's slot: dws (K, 3C) at 0, dbin, dbs (3C),
// then dbo, dg, dbln (C each)); red (out): (P,) fp32, the slots summed. V %
// 64 == 0, chunk 64 or 128 dividing V, C > 0, 1 <= K <= 16, all pointers
// 32-byte aligned. Returns cudaGetLastError() of the launches.
extern "C" int lcbi_hyena_chunked_bwd(const void* x, const void* ln_g, const void* ln_b,
                                      const void* win, const void* bin, const void* ws,
                                      const void* bs, const void* m, const void* wo,
                                      const void* dout, void* dx, void* gs, void* dvl, void* work,
                                      void* wgrads, void* slots, void* red, int BW, int V, int C,
                                      int K, int chunk, int has_ln, int is_bf16, int max_slots,
                                      long long P, int off_dbin, int off_dbs, int off_dbo,
                                      int off_dg, int off_dbln, void* stream) {
  (void)cudaGetLastError();
  if (BW <= 0 || V <= 0 || V % lcbi::kRowTile != 0 || (chunk != 64 && chunk != 128) ||
      V % chunk != 0 || C <= 0 || K < 1 || K > lcbi::kMaxTaps || max_slots < 1 || P % 8 != 0 ||
      off_dbo <= 0 || off_dbo >= P)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const lcbi::ChunkedSlots off{off_dbin, off_dbs, off_dbo, off_dg, off_dbln};
  unsigned char* w = static_cast<unsigned char*>(work);
  float* wg = static_cast<float*>(wgrads);
  float* sl = static_cast<float*>(slots);
  float* r = static_cast<float*>(red);
  if (is_bf16)
    return lcbi::launch_bwd<__nv_bfloat16>(x, ln_g, ln_b, win, bin, ws, bs, m, wo, dout, dx, gs,
                                           dvl, w, wg, sl, r, (size_t)P, off, max_slots, BW, V,
                                           C, K, chunk, has_ln, s);
  return lcbi::launch_bwd<float>(x, ln_g, ln_b, win, bin, ws, bs, m, wo, dout, dx, gs, dvl, w, wg,
                                 sl, r, (size_t)P, off, max_slots, BW, V, C, K, chunk, has_ln, s);
}
