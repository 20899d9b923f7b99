// Shared device code of the chunked Hyena mixer K3 (hyena_chunked.cu,
// hyena_chunked_bwd.cu), for windows of 64 < V <= 512 tokens (V % 64 == 0):
//     out = [x +] out_proj(x2 * L(x1 * v)),  [x1 | x2 | v] = shortconv(in_proj([LN](x)))
// where L is the causal V-tap long conv, run as block-Toeplitz products over
// chunks of `chunk` tokens: vl_chunk[q] = sum_{d <= q} g_chunk[q - d] @ M[d]
// per channel, with M (n, C, chunk, chunk) built by the wrapper.
//
// One 512-token window does not fit in shared memory the way K1's windows do
// (x alone is 196 KB at C = 192 in bf16, the 3C-wide projection 1.2 MB in
// fp32). The work splits where the math allows it: in_proj, the 5-tap short
// conv and the gates act per token row with a halo of K - 1 rows (row-tile
// kernels); the long conv acts per channel across a whole window (channel
// kernels). Between them the per-channel streams (g, x2, v2, dvl, ...) go
// through global memory in a channel-major layout (C, BW, V), in which one
// channel of one window is V contiguous values: the row-tile kernels write
// and read it in runs of a tile's tokens, the channel kernels in whole rows.
//
// Widths: the channel axis runs over Cp = C rounded up to 32 (whole chunks
// of 32). The rows of x and do load at the true C (LayerNorm statistics over
// C, zeros in columns [C, Cp)) and only columns [0, C) of out and dx are
// stored; the weights, taps, biases and Toeplitz blocks arrive padded to Cp
// with zeros (the wrapper pads them, never the activations), and the
// channel-major streams hold Cp channels, the padded ones zero.
#pragma once

#include "common.cuh"

namespace lcbi {

constexpr int kChunkChannels = 32;   // channels per in_proj column chunk
constexpr int kHalo = 16;            // halo rows of a row tile (>= K - 1, a WMMA edge)
constexpr int kRowTile = 64;         // tokens per row tile (V % 64 == 0)
constexpr int kWindowGroup = 16;     // windows per channel-kernel block (a WMMA edge)
constexpr int kMaxTaps = 16;

// Rows of a row tile: local row i holds token t0 - hb + i of window w, LN'd
// (or copied) into ys in T, columns [C, Cp) zero; rows whose token lies
// outside [0, V) are zero. mu/rstd (may be null) receive each LN'd row's
// statistics.
template <typename T>
__device__ void load_window_rows(const T* __restrict__ x, int w, int t0, int hb, int rows_pad,
                                 int V, int C, int Cp, const float* __restrict__ ln_g,
                                 const float* __restrict__ ln_b, int has_ln, T* ys, int lds,
                                 float* mu, float* rstd) {
  const int lo = max(0, hb - t0);
  const int hi = min(rows_pad, hb + V - t0);
  const T* src = x + ((size_t)w * V + (t0 - hb + lo)) * C;
  layernorm_rows(src, hi - lo, hi - lo, C, ln_g, ln_b, has_ln, ys + (size_t)lo * lds, lds,
                 mu == nullptr ? nullptr : mu + lo, rstd == nullptr ? nullptr : rstd + lo, Cp);
  for (int i = threadIdx.x; i < rows_pad * Cp; i += kThreads) {
    const int r = i / Cp;
    if (r < lo || r >= hi) ys[(size_t)r * lds + i % Cp] = from_f32<T>(0.f);
  }
}

// The backward's products read do straight from global memory in 16-column
// tiles where C % 16 == 0; otherwise (C = 24, say) a tile of do is staged in
// shared memory with zeros past C, so that no tile reads past a row.
__host__ __device__ __forceinline__ bool stage_dout(int C) { return C % 16 != 0; }

// The R rows of do from token row `row0` of the (BW V, C) stream into a
// (R, Cp) tile (ld lds) in T, columns [C, Cp) zero.
template <typename T>
__device__ void load_dout_rows(const T* __restrict__ dout, size_t row0, int R, int C, int Cp,
                               T* dst, int lds) {
  for (int i = threadIdx.x; i < R * Cp; i += kThreads) {
    const int r = i / Cp, c = i % Cp;
    dst[(size_t)r * lds + c] = c < C ? dout[(row0 + r) * C + c] : from_f32<T>(0.f);
  }
}

// This chunk's short taps and biases into shared memory: column j of the
// 3 * 32-wide chunk is channel c0 + j % 32 of block j / 32 of [x1 | x2 | v].
__device__ __forceinline__ void load_chunk_taps(const float* __restrict__ ws,
                                                const float* __restrict__ bin,
                                                const float* __restrict__ bs, int C, int K, int c0,
                                                float* wsc, float* binc, float* bsc) {
  constexpr int CC = kChunkChannels, W3 = 3 * kChunkChannels;
  for (int i = threadIdx.x; i < K * W3; i += kThreads) {
    const int m = i / W3, j = i % W3;
    wsc[i] = ws[(size_t)m * 3 * C + (j / CC) * C + c0 + j % CC];
  }
  for (int j = threadIdx.x; j < W3; j += kThreads) {
    const int col = (j / CC) * C + c0 + j % CC;
    binc[j] = bin[col];
    bsc[j] = bs[col];
  }
}

// Causal short conv of one column at local row `row` of z (in_proj output
// without its bias): bs + sum_m (z[row - m] + bin) * ws[m], skipping taps
// that reach before the window start (token tg - m < 0).
__device__ __forceinline__ float short_conv_at(const float* z, int ldz, int row, int tg, int col,
                                               const float* wsc, float bi, float bsv, int K) {
  constexpr int W3 = 3 * kChunkChannels;
  float a = bsv;
  for (int m = 0; m < K && m <= tg; ++m) a += (z[(size_t)(row - m) * ldz + col] + bi) * wsc[m * W3 + col];
  return a;
}

struct RowsInLayout {
  int lds, ldz, ldd;
  size_t off_z, off_ws, off_bias, off_dv2, off_dos, bytes;
};

// Cp: the padded width; with stage, room for a tile of do (stage_dout).
__host__ __device__ inline RowsInLayout rows_in_layout(int Cp, int K, int elem, bool stage) {
  RowsInLayout L;
  const int rows_pad = kHalo + kRowTile;
  L.lds = Cp + 8;
  L.ldz = 3 * kChunkChannels + 4;
  L.ldd = kChunkChannels + 4;
  L.off_z = align128((size_t)rows_pad * L.lds * elem);
  L.off_ws = L.off_z + align128((size_t)rows_pad * L.ldz * 4);
  L.off_bias = L.off_ws + align128((size_t)K * 3 * kChunkChannels * 4);
  L.off_dv2 = L.off_bias + align128((size_t)2 * 3 * kChunkChannels * 4);
  L.off_dos = L.off_dv2 + align128((size_t)kRowTile * L.ldd * 4);
  L.bytes = L.off_dos + (stage ? align128((size_t)kRowTile * L.lds * elem) : 0);
  return L;
}

// Row-tile kernel, one block per tile of 64 tokens of one window (plus a
// back halo of 16 rows): [LN], in_proj, the short conv and the pre-gate, in
// chunks of 32 channels over Cp. Writes g = v * x1 (in T, the Toeplitz
// operand) and x2 (fp32) channel-major, Cp channels; with dout given, also
// dv2 = dout @ wo^T (fp32), the start of the backward.
template <typename T>
__global__ void __launch_bounds__(kThreads)
k3_rows_in_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                  const float* __restrict__ ln_b, const T* __restrict__ win,
                  const float* __restrict__ bin, const float* __restrict__ ws,
                  const float* __restrict__ bs, const T* __restrict__ dout,
                  const T* __restrict__ wo, T* __restrict__ g_out, float* __restrict__ x2_out,
                  float* __restrict__ dv2_out, int BW, int V, int C, int K, int has_ln) {
  constexpr int CC = kChunkChannels;
  constexpr int R = kRowTile, rows_pad = kHalo + kRowTile;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Cp = chunk_padded_channels(C);
  const bool stage = dout != nullptr && stage_dout(C);
  const RowsInLayout L = rows_in_layout(Cp, K, sizeof(T), stage);
  T* ys = reinterpret_cast<T*>(smem);
  float* z = reinterpret_cast<float*>(smem + L.off_z);
  float* wsc = reinterpret_cast<float*>(smem + L.off_ws);
  float* binc = reinterpret_cast<float*>(smem + L.off_bias);
  float* bsc = binc + 3 * CC;
  float* dv2c = reinterpret_cast<float*>(smem + L.off_dv2);
  T* dos = reinterpret_cast<T*>(smem + L.off_dos);

  const int tiles_per_window = V / R;
  const int w = blockIdx.x / tiles_per_window;
  const int t0 = (blockIdx.x % tiles_per_window) * R;
  const size_t plane = (size_t)BW * V;
  load_window_rows(x, w, t0, kHalo, rows_pad, V, C, Cp, ln_g, ln_b, has_ln, ys, L.lds,
                   (float*)nullptr, (float*)nullptr);
  if (stage) load_dout_rows(dout, (size_t)w * V + t0, R, C, Cp, dos, L.lds);
  // dv2's A operand: the staged tile (depth Cp) or do's rows in global memory
  // (depth C, a multiple of 16)
  const T* da = stage ? dos : dout + ((size_t)w * V + t0) * C;
  const int lda = stage ? L.lds : C, kd = stage ? Cp : C;

  for (int c0 = 0; c0 < Cp; c0 += CC) {
    load_chunk_taps(ws, bin, bs, Cp, K, c0, wsc, binc, bsc);
    __syncthreads();  // also orders the row loads before the first product
    for (int s = 0; s < 3; ++s)
      gemm<false, false>(z + s * CC, L.ldz, ys, L.lds, win + s * Cp + c0, 3 * Cp, rows_pad, CC,
                         Cp, false);
    if (dout != nullptr)
      gemm<false, true>(dv2c, L.ldd, da, lda, wo + (size_t)c0 * Cp, Cp, R, CC, kd, false);
    __syncthreads();
    // one thread per (token, channel), tokens fastest: the channel-major
    // stores of a warp are 32 neighbouring tokens of one channel
    for (int p = threadIdx.x; p < R * CC; p += kThreads) {
      const int j = p / R, t = p % R;
      const int row = kHalo + t, tg = t0 + t;
      const float x1 = short_conv_at(z, L.ldz, row, tg, j, wsc, binc[j], bsc[j], K);
      const float x2 = short_conv_at(z, L.ldz, row, tg, CC + j, wsc, binc[CC + j], bsc[CC + j], K);
      const float v = short_conv_at(z, L.ldz, row, tg, 2 * CC + j, wsc, binc[2 * CC + j],
                                    bsc[2 * CC + j], K);
      const size_t gi = (size_t)(c0 + j) * plane + (size_t)w * V + tg;
      g_out[gi] = from_f32<T>(v * x1);
      x2_out[gi] = x2;
      if (dout != nullptr) dv2_out[gi] = dv2c[t * L.ldd + j];
    }
    __syncthreads();
  }
}

struct ToeplitzLayout {
  int ldg, lda;
  size_t off_acc, off_dv, bytes;
};

__host__ __device__ inline ToeplitzLayout toeplitz_layout(int n, int chunk, int elem, bool bwd) {
  ToeplitzLayout L;
  const size_t rows = (size_t)n * kWindowGroup;
  L.ldg = chunk + 8;
  L.lda = chunk + 4;
  L.off_acc = align128(rows * L.ldg * elem);
  L.off_dv = L.off_acc + align128(rows * L.lda * 4);
  L.bytes = L.off_dv + (bwd ? align128(rows * L.ldg * elem) : 0);
  return L;
}

// Channel kernels, one block per (group of 16 windows, channel c): the
// group's g rows in shared memory chunk-major (row q * 16 + b is chunk q of
// window b), so that for chunk distance d the inputs are rows [0, (n-d)16)
// and the outputs rows [d * 16, n * 16): one product each, K = chunk.
template <typename T>
__device__ void load_group_rows(const T* __restrict__ src, int c, int w0, int nw, int BW, int V,
                                int n, int chunk, T* dst, int ld) {
  const size_t base = (size_t)c * BW * V + (size_t)w0 * V;
  for (int i = threadIdx.x; i < n * kWindowGroup * chunk; i += kThreads) {
    const int row = i / chunk, r = i % chunk;
    const int q = row / kWindowGroup, b = row % kWindowGroup;
    dst[(size_t)row * ld + r] = b < nw ? src[base + (size_t)b * V + q * chunk + r] : from_f32<T>(0.f);
  }
}

// acc (fp32) = the causal long conv of the rows in gs: acc[q] = sum_{d <= q}
// gs[q - d] @ M[d][c] (TRANS: acc[q - d] += gs[q] @ M[d][c]^T, the transpose,
// for the backward's dg). Products in T, fp32 sums; the caller syncs before.
template <bool TRANS, typename T>
__device__ void toeplitz_products(float* acc, int lda, const T* gs, int ldg,
                                  const T* __restrict__ m, int c, int C, int n, int chunk) {
  constexpr int G = kWindowGroup;
  for (int d = 0; d < n; ++d) {
    const T* md = m + ((size_t)d * C + c) * chunk * chunk;
    if (TRANS)
      gemm<false, true>(acc, lda, gs + (size_t)d * G * ldg, ldg, md, chunk, (n - d) * G, chunk,
                        chunk, d > 0);
    else
      gemm<false, false>(acc + (size_t)d * G * lda, lda, gs, ldg, md, chunk, (n - d) * G, chunk,
                         chunk, d > 0);
    __syncthreads();  // the next distance's product may give a tile to another warp
  }
}

}  // namespace lcbi
