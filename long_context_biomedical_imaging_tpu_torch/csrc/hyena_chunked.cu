// Chunked Hyena window mixer K3, forward, for windows of 64 < V <= 512 tokens:
//     out = [x +] out_proj(x2 * L(x1 * v)),  [x1 | x2 | v] = shortconv(in_proj([LN](x)))
// with the long conv L as block-Toeplitz products (see hyena_chunked.cuh).
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/hyena_window.py
// _make_fwd_kernel_chunked (launched by _fwd_chunked through
// _mixer_core_chunked[_ln], entry hyena_window_mixer).
//
// What bounds it on the H100: the products. For T tokens, in_proj 6*T*C^2,
// out_proj 2*T*C^2 and the Toeplitz products 2*T*C*chunk*(n+1)/2 FLOPs
// (emb stage 0, T = 2^21, C = 96: 284 GFLOP, 0.29 ms at 989 TFLOP/s) against
// 4*T*C bytes of x in and out (0.8 GB, 0.24 ms at 3.35 TB/s). The TPU kernel
// keeps one block of windows in VMEM for the whole chain; a 512-token window
// does not fit in a block's shared memory here, so the chain runs as three
// launches whose per-channel streams cross global memory (L2 holds a good
// part of them):
//   1. k3_rows_in: per 64-token row tile, [LN], in_proj, short conv,
//      pre-gate -> g (T) and x2 (fp32), channel-major;
//   2. k3_toeplitz_fwd: per (16 windows, channel), the long conv as n
//      products (rows (n-d)*16, K = chunk, N = chunk) on tensor cores, then
//      the post-gate -> v2 (T), in place of g;
//   3. k3_rows_out: per row tile, out_proj of v2 plus its bias [and x].
// Every product is WMMA (bf16 operands, fp32 sums) or, in fp32, FMA loops.
//
// Widths: the channel axis runs over Cp = C rounded up to 32 (whole chunks
// of 32). The rows of x load at the true C (LayerNorm statistics over C,
// zeros in columns [C, Cp)) and only columns [0, C) of out are stored; the
// weights, taps, biases and Toeplitz blocks arrive padded to Cp with zeros
// (the wrapper pads them, never the activations), and the channel-major
// streams hold Cp channels, the padded ones zero.
#include "hyena_chunked.cuh"

namespace lcbi {

constexpr int kHalo = 16;            // halo rows of a row tile (>= K - 1, a WMMA edge)

// Rows of a row tile: local row i holds token t0 - hb + i of window w, LN'd
// (or copied) into ys in T, columns [C, Cp) zero; rows whose token lies
// outside [0, V) are zero.
template <typename T>
__device__ void load_window_rows(const T* __restrict__ x, int w, int t0, int hb, int rows_pad,
                                 int V, int C, int Cp, const float* __restrict__ ln_g,
                                 const float* __restrict__ ln_b, int has_ln, T* ys, int lds) {
  const int lo = max(0, hb - t0);
  const int hi = min(rows_pad, hb + V - t0);
  const T* src = x + ((size_t)w * V + (t0 - hb + lo)) * C;
  layernorm_rows(src, hi - lo, hi - lo, C, ln_g, ln_b, has_ln, ys + (size_t)lo * lds, lds,
                 (float*)nullptr, (float*)nullptr, Cp);
  for (int i = threadIdx.x; i < rows_pad * Cp; i += kThreads) {
    const int r = i / Cp;
    if (r < lo || r >= hi) ys[(size_t)r * lds + i % Cp] = from_f32<T>(0.f);
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
  int lds, ldz;
  size_t off_z, off_ws, off_bias, bytes;
};

// Cp: the padded width.
__host__ __device__ inline RowsInLayout rows_in_layout(int Cp, int K, int elem) {
  RowsInLayout L;
  const int rows_pad = kHalo + kRowTile;
  L.lds = Cp + 8;
  L.ldz = 3 * kChunkChannels + 4;
  L.off_z = align128((size_t)rows_pad * L.lds * elem);
  L.off_ws = L.off_z + align128((size_t)rows_pad * L.ldz * 4);
  L.off_bias = L.off_ws + align128((size_t)K * 3 * kChunkChannels * 4);
  L.bytes = L.off_bias + align128((size_t)2 * 3 * kChunkChannels * 4);
  return L;
}

// Row-tile kernel, one block per tile of 64 tokens of one window (plus a
// back halo of 16 rows): [LN], in_proj, the short conv and the pre-gate, in
// chunks of 32 channels over Cp. Writes g = v * x1 (in T, the Toeplitz
// operand) and x2 (fp32) channel-major, Cp channels. In fp32 the bounds ask
// for two blocks an SM: left free, ptxas gave the FMA products 48 registers
// and spilled, and the kernel ran up to 1.6x slower.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
k3_rows_in_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                  const float* __restrict__ ln_b, const T* __restrict__ win,
                  const float* __restrict__ bin, const float* __restrict__ ws,
                  const float* __restrict__ bs, T* __restrict__ g_out, float* __restrict__ x2_out,
                  int BW, int V, int C, int K, int has_ln) {
  constexpr int CC = kChunkChannels;
  constexpr int R = kRowTile, rows_pad = kHalo + kRowTile;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Cp = chunk_padded_channels(C);
  const RowsInLayout L = rows_in_layout(Cp, K, sizeof(T));
  T* ys = reinterpret_cast<T*>(smem);
  float* z = reinterpret_cast<float*>(smem + L.off_z);
  float* wsc = reinterpret_cast<float*>(smem + L.off_ws);
  float* binc = reinterpret_cast<float*>(smem + L.off_bias);
  float* bsc = binc + 3 * CC;

  const int tiles_per_window = V / R;
  const int w = blockIdx.x / tiles_per_window;
  const int t0 = (blockIdx.x % tiles_per_window) * R;
  const size_t plane = (size_t)BW * V;
  load_window_rows(x, w, t0, kHalo, rows_pad, V, C, Cp, ln_g, ln_b, has_ln, ys, L.lds);

  for (int c0 = 0; c0 < Cp; c0 += CC) {
    load_chunk_taps(ws, bin, bs, Cp, K, c0, wsc, binc, bsc);
    __syncthreads();  // also orders the row loads before the first product
    for (int s = 0; s < 3; ++s)
      gemm<false, false>(z + s * CC, L.ldz, ys, L.lds, win + s * Cp + c0, 3 * Cp, rows_pad, CC,
                         Cp, false);
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
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
k3_toeplitz_fwd_kernel(T* __restrict__ gv, const float* __restrict__ x2, const T* __restrict__ m,
                       int BW, int V, int C, int chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = V / chunk;
  const ToeplitzLayout L = toeplitz_layout(n, chunk, sizeof(T), false);
  T* gs = reinterpret_cast<T*>(smem);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);
  const int c = blockIdx.y;
  const int w0 = blockIdx.x * kWindowGroup;
  const int nw = min(kWindowGroup, BW - w0);
  load_group_rows(gv, c, w0, nw, BW, V, n, chunk, gs, L.ldg);
  __syncthreads();
  // acc[q] = sum_{d <= q} gs[q - d] @ M[d][c], M's fragments read from
  // device memory: staging each block in shared memory, as the backward
  // does, measured slower here (the larger block fits fewer blocks an SM)
  for (int d = 0; d < n; ++d) {
    gemm<false, false>(acc + (size_t)d * kWindowGroup * L.lda, L.lda, gs, L.ldg,
                       m + ((size_t)d * C + c) * chunk * chunk, chunk, (n - d) * kWindowGroup,
                       chunk, chunk, d > 0);
    __syncthreads();  // the next distance's product may give a tile to another warp
  }
  // post-gate, v2 = vl * x2, written over this block's g rows
  const size_t base = (size_t)c * BW * V + (size_t)w0 * V;
  for (int i = threadIdx.x; i < n * kWindowGroup * chunk; i += kThreads) {
    const int row = i / chunk, r = i % chunk;
    const int q = row / kWindowGroup, b = row % kWindowGroup;
    if (b < nw) {
      const size_t gi = base + (size_t)b * V + q * chunk + r;
      gv[gi] = from_f32<T>(acc[(size_t)row * L.lda + r] * x2[gi]);
    }
  }
}

struct RowsOutLayout {
  int ldv, ldacc;
  size_t off_acc, bytes;
};

__host__ __device__ inline RowsOutLayout rows_out_layout(int C, int elem) {
  RowsOutLayout L;
  L.ldv = C + 8;
  L.ldacc = C + 4;
  L.off_acc = align128((size_t)kRowTile * L.ldv * elem);
  L.bytes = L.off_acc + align128((size_t)kRowTile * L.ldacc * 4);
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
k3_rows_out_kernel(const T* __restrict__ v2, const T* __restrict__ x, const T* __restrict__ wo,
                   const float* __restrict__ bo, T* __restrict__ out, int BW, int V, int C,
                   int has_ln) {
  constexpr int R = kRowTile;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Cp = chunk_padded_channels(C);
  const RowsOutLayout L = rows_out_layout(Cp, sizeof(T));
  T* vs = reinterpret_cast<T*>(smem);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);
  const int tiles_per_window = V / R;
  const int w = blockIdx.x / tiles_per_window;
  const int t0 = (blockIdx.x % tiles_per_window) * R;
  const size_t plane = (size_t)BW * V;
  // the tile of v2 (Cp channels), channel-major in global memory, row-major here
  for (int i = threadIdx.x; i < R * Cp; i += kThreads) {
    const int c = i / R, t = i % R;
    vs[(size_t)t * L.ldv + c] = v2[(size_t)c * plane + (size_t)w * V + t0 + t];
  }
  __syncthreads();
  gemm<false, false>(acc, L.ldacc, vs, L.ldv, wo, Cp, R, Cp, Cp, false);
  __syncthreads();
  const size_t base = ((size_t)w * V + t0) * C;
  for (int i = threadIdx.x; i < R * C; i += kThreads) {
    const int t = i / C, c = i % C;
    float v = acc[(size_t)t * L.ldacc + c] + bo[c];
    if (has_ln) v += to_f32(x[base + i]);
    out[base + i] = from_f32<T>(v);
  }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T>
int launch_fwd(const void* x, const void* ln_g, const void* ln_b, const void* win,
               const void* bin, const void* ws, const void* bs, const void* m, const void* wo,
               const void* bo, void* out, void* gbuf, void* x2buf, int BW, int V, int C, int K,
               int chunk, int has_ln, cudaStream_t stream) {
  const int n = V / chunk, Cp = chunk_padded_channels(C);
  const unsigned row_tiles = (unsigned)((size_t)BW * V / kRowTile);
  const size_t in_bytes = rows_in_layout(Cp, K, sizeof(T)).bytes;
  const size_t tp_bytes = toeplitz_layout(n, chunk, sizeof(T), false).bytes;
  const size_t out_bytes = rows_out_layout(Cp, sizeof(T)).bytes;
  int err = prepare(k3_rows_in_kernel<T>, in_bytes);
  if (err == 0) err = prepare(k3_toeplitz_fwd_kernel<T>, tp_bytes);
  if (err == 0) err = prepare(k3_rows_out_kernel<T>, out_bytes);
  if (err != 0) return err;
  T* g = static_cast<T*>(gbuf);
  float* x2 = static_cast<float*>(x2buf);
  k3_rows_in_kernel<T><<<row_tiles, kThreads, in_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<const T*>(win), static_cast<const float*>(bin), static_cast<const float*>(ws),
      static_cast<const float*>(bs), g, x2, BW, V, C, K, has_ln);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const dim3 groups((unsigned)((BW + kWindowGroup - 1) / kWindowGroup), (unsigned)Cp);
  k3_toeplitz_fwd_kernel<T><<<groups, kThreads, tp_bytes, stream>>>(
      g, x2, static_cast<const T*>(m), BW, V, Cp, chunk);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  k3_rows_out_kernel<T><<<row_tiles, kThreads, out_bytes, stream>>>(
      g, static_cast<const T*>(x), static_cast<const T*>(wo), static_cast<const float*>(bo),
      static_cast<T*>(out), BW, V, C, has_ln);
  return (int)cudaGetLastError();
}

}  // namespace lcbi

// The padded width this library's kernels run on (common.cuh): the wrapper
// lays the weights, taps and biases out at it.
extern "C" int lcbi_padded_channels(int C) { return lcbi::chunk_padded_channels(C); }

// x, out: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); win: (Cp, 3Cp), wo:
// (Cp, Cp) and m: (V / chunk, Cp, chunk, chunk) in T; bin, bs: (3Cp,), ws:
// (K, 3Cp) fp32, all padded with zeros per C-wide block to Cp = C rounded up
// to 32; bo: (C,) and, if has_ln, ln_g, ln_b: (C,), fp32. gbuf: Cp * BW * V
// of T and x2buf: Cp * BW * V fp32, scratch. V % 64 == 0, chunk 64 or 128
// dividing V, C > 0, 1 <= K <= 16, all pointers 32-byte aligned. Returns
// cudaGetLastError() of the launches.
extern "C" int lcbi_hyena_chunked_fwd(const void* x, const void* ln_g, const void* ln_b,
                                      const void* win, const void* bin, const void* ws,
                                      const void* bs, const void* m, const void* wo,
                                      const void* bo, void* out, void* gbuf, void* x2buf, int BW,
                                      int V, int C, int K, int chunk, int has_ln, int is_bf16,
                                      void* stream) {
  (void)cudaGetLastError();
  if (BW <= 0 || V <= 0 || V % lcbi::kRowTile != 0 || (chunk != 64 && chunk != 128) ||
      V % chunk != 0 || C <= 0 || K < 1 || K > lcbi::kMaxTaps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return lcbi::launch_fwd<__nv_bfloat16>(x, ln_g, ln_b, win, bin, ws, bs, m, wo, bo, out, gbuf,
                                           x2buf, BW, V, C, K, chunk, has_ln, s);
  return lcbi::launch_fwd<float>(x, ln_g, ln_b, win, bin, ws, bs, m, wo, bo, out, gbuf, x2buf, BW,
                                 V, C, K, chunk, has_ln, s);
}
