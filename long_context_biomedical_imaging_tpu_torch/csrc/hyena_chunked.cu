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
//   1. k3_rows_in (hyena_chunked.cuh): per 64-token row tile, [LN], in_proj,
//      short conv, pre-gate -> g (T) and x2 (fp32), channel-major;
//   2. k3_toeplitz_fwd: per (16 windows, channel), the long conv as n
//      products (rows (n-d)*16, K = chunk, N = chunk) on tensor cores, then
//      the post-gate -> v2 (T), in place of g;
//   3. k3_rows_out: per row tile, out_proj of v2 plus its bias [and x].
// Every product is WMMA (bf16 operands, fp32 sums) or, in fp32, FMA loops.
#include "hyena_chunked.cuh"

namespace lcbi {

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
  toeplitz_products<false>(acc, L.lda, gs, L.ldg, m, c, C, n, chunk);
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
  const size_t in_bytes = rows_in_layout(Cp, K, sizeof(T), false).bytes;  // no do
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
      static_cast<const float*>(bs), nullptr, nullptr, g, x2, nullptr, BW, V, C, K, has_ln);
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
