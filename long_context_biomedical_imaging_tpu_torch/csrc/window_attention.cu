// Swin window attention K8, forward: per window of V tokens, H heads of D = 32,
//     qkv = x Wqkv + bqkv (fp32 sums);  q | k | v head-major column blocks
//     s_h = (q_h scale) k_h^T + rel[h] + (region ids differ ? mask_value : 0)
//     o_h = softmax(s_h) v_h;  out = sum_h o_h Wout[hD:(h+1)D, :] + bout
// x, out: (BW, V, C) in T; Wqkv (C, 3C), Wout (C, C) in T; the biases and rel
// (H, V, V) fp32; rid (nW, V) int32 region ids, window w reading row w % nW.
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/window_attention.py
// _fwd_kernel (pallas_call in _call_fwd). Rounds where it rounds: q scale
// log2(e), k and v to T after the fp32 bias add, the probabilities to T
// before p v, o_h to T before the out projection; base-2 softmax.
//
// What bounds it on the H100: the projections, 8 T C^2 of the 8 T C^2 + 4 T V
// C operations of T tokens (ptx stage 2: 1.2 MFLOP a token against 1.5 KB
// read and written), so operations. The TPU kernel fuses G windows into one
// block-diagonal sequence padded to 128 lanes; here a block takes a tile of
// whole windows (64 token rows) and attends within each window directly, with
// no padding or masked blocks. Per head the block projects its q, k, v
// columns from the tile's rows (read from global memory, resident in L1/L2),
// runs the window products on shared-memory tiles and writes o_h, rounded to
// T, to a global (BW V, C) scratch; after the head loop the out projection
// reads the tile's o rows back in 128-column chunks. The scratch keeps the
// fp32 sum over heads out of shared memory, which at C = 768 would not fit.
//
// Windows of other sizes up to 512 tokens take the general path
// (window_attention.cuh): the q | k | v projection into device memory in T
// (q scale log2(e) rounded once, as above), the row kernel per (window,
// head, 64 query rows) on full score rows, and the out projection of o.
// The projections then cost a write and a read of the (T, 3C) stream, and
// each query tile stages its window's k and v again (from L2).
#include "window_attention.cuh"

namespace lcbi {

struct FwdLayout {
  int lds, ldp;
  size_t off_q, off_k, off_v, off_s, off_p, bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int V, int elem) {
  FwdLayout L;
  L.lds = ld_scores(V);
  L.ldp = ld_probs(V);
  const size_t f = align128((size_t)kTileRows * (kLdO > kLdF ? kLdO : kLdF) * 4);
  const size_t t = align128((size_t)kTileRows * kLdT * elem);
  L.off_q = f;
  L.off_k = L.off_q + t;
  L.off_v = L.off_k + t;
  L.off_s = L.off_v + t;
  L.off_p = L.off_s + align128((size_t)kTileRows * L.lds * 4);
  L.bytes = L.off_p + align128((size_t)kTileRows * L.ldp * elem);
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                            const float* __restrict__ bqkv, const T* __restrict__ wout,
                            const float* __restrict__ bout, const float* __restrict__ rel,
                            const int* __restrict__ rid, T* obuf, T* __restrict__ out, int BW,
                            int V, int C, int H, int nW, float scale2, float mask2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout(V, sizeof(T));
  float* F = reinterpret_cast<float*>(smem);
  T* Q = reinterpret_cast<T*>(smem + L.off_q);
  T* K = reinterpret_cast<T*>(smem + L.off_k);
  T* Vt = reinterpret_cast<T*>(smem + L.off_v);
  float* S = reinterpret_cast<float*>(smem + L.off_s);
  T* P = reinterpret_cast<T*>(smem + L.off_p);
  const Tile tl = tile_of(blockIdx.x, BW, V);
  const int M = tl.M, nb = tl.nwin;
  const T* xr = x + tl.row0 * C;
  T* orow = obuf + tl.row0 * C;

  for (int h = 0; h < H; ++h) {
    project_head(F, xr, wqkv, M, C, h);
    for (int e = threadIdx.x; e < M * 3 * kHeadDim; e += kThreads) {
      const int r = e / (3 * kHeadDim), j = e % (3 * kHeadDim);
      const int part = j / kHeadDim, d = j % kHeadDim;
      const float v = F[r * kLdF + j] + bqkv[part * C + h * kHeadDim + d];
      T* dst = part == 0 ? Q : (part == 1 ? K : Vt);
      dst[r * kLdT + d] = from_f32<T>(part == 0 ? v * scale2 : v);
    }
    __syncthreads();
    gemm_batched<false, true>(nb, S, L.lds, V * L.lds, Q, kLdT, V * kLdT, K, kLdT, V * kLdT, V,
                              V, kHeadDim);
    __syncthreads();
    softmax_rows(S, L.lds, P, L.ldp, M, V, rel + (size_t)h * V * V, rid, nW, tl.w0, mask2);
    __syncthreads();
    gemm_batched<false, false>(nb, F, kLdF, V * kLdF, P, L.ldp, V * L.ldp, Vt, kLdT, V * kLdT, V,
                               kHeadDim, V);
    __syncthreads();
    for (int e = threadIdx.x; e < M * kHeadDim; e += kThreads) {
      const int r = e / kHeadDim, d = e % kHeadDim;
      orow[(size_t)r * C + h * kHeadDim + d] = from_f32<T>(F[r * kLdF + d]);
    }
    __syncthreads();
  }

  T* outr = out + tl.row0 * C;
  for (int n0 = 0; n0 < C; n0 += kOutCols) {
    const int nc = min(kOutCols, C - n0);
    gemm<false, false>(F, kLdO, orow, C, wout + n0, C, M, nc, C, false);
    __syncthreads();
    for (int e = threadIdx.x; e < M * nc; e += kThreads) {
      const int r = e / nc, j = e % nc;
      outr[(size_t)r * C + n0 + j] = from_f32<T>(F[r * kLdO + j] + bout[n0 + j]);
    }
    __syncthreads();
  }
}

template <typename T>
int launch_fwd_general(const void* x, const void* wqkv, const float* bqkv, const void* wout,
                       const float* bout, const float* rel, const int* rid, void* obuf,
                       void* qkv, void* out, int BW, int V, int C, int H, int nW, float scale2,
                       float mask2, cudaStream_t stream) {
  const int N = BW * V;
  int err = launch_proj<T>(x, C, wqkv, 3 * C, false, bqkv, qkv, 3 * C, N, 3 * C, C, C, scale2,
                           -1, stream);
  if (err != 0) return err;
  int blocks = 0;
  err = launch_rows<T, false>(qkv, 3 * C, rel, rid, nullptr, nullptr, obuf, nullptr, nullptr,
                              nullptr, 1, BW, V, C, H, nW, 1.f, mask2, &blocks, stream);
  if (err != 0) return err;
  return launch_proj<T>(obuf, C, wout, C, false, bout, out, C, N, C, C, 0, 1.f, -1, stream);
}

template <typename T>
int launch_fwd(const void* x, const void* wqkv, const float* bqkv, const void* wout,
               const float* bout, const float* rel, const int* rid, void* obuf, void* out, int BW,
               int V, int C, int H, int nW, float scale2, float mask2, cudaStream_t stream) {
  const size_t bytes = fwd_layout(V, sizeof(T)).bytes;
  if (bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int tw = kTileRows / V;
  const long long tiles = ((long long)BW + tw - 1) / tw;
  window_attention_fwd_kernel<T><<<(unsigned)tiles, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), bqkv, static_cast<const T*>(wout),
      bout, rel, rid, static_cast<T*>(obuf), static_cast<T*>(out), BW, V, C, H, nW, scale2, mask2);
  return (int)cudaGetLastError();
}

}  // namespace lcbi

// x, out, obuf: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); obuf is
// scratch, and so is qkv (BW V, 3C) in T, which only the general path uses
// (NULL otherwise). wqkv (C, 3C), wout (C, C) in T; bqkv (3C,), bout (C,), rel
// (H, V, V) fp32; rid (nW, V) int32 or NULL (then nW is ignored). C = 32 H,
// 1 <= V <= 512 (V = 16, 32, 48, 64: the whole-window path; the rest the
// general path), all pointers 32-byte aligned. scale2 = scale log2(e), mask2
// = mask_value log2(e). Returns cudaGetLastError() of the launches.
extern "C" int lcbi_window_attention_fwd(const void* x, const void* wqkv, const void* bqkv,
                                         const void* wout, const void* bout, const void* rel,
                                         const void* rid, void* obuf, void* qkv, void* out,
                                         int BW, int V, int C, int H, int nW, float scale2,
                                         float mask2, int is_bf16, void* stream) {
  (void)cudaGetLastError();
  if (!lcbi::attn_shape_ok(BW, V, C, H) || (rid != nullptr && (nW <= 0 || BW % nW != 0)) ||
      (long long)BW * V * 3 * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b3 = static_cast<const float*>(bqkv);
  const float* b1 = static_cast<const float*>(bout);
  const float* r = static_cast<const float*>(rel);
  const int* ids = static_cast<const int*>(rid);
  if (!lcbi::whole_window_path(V)) {
    if (qkv == nullptr) return (int)cudaErrorInvalidValue;
    if (is_bf16)
      return lcbi::launch_fwd_general<__nv_bfloat16>(x, wqkv, b3, wout, b1, r, ids, obuf, qkv,
                                                     out, BW, V, C, H, nW, scale2, mask2, s);
    return lcbi::launch_fwd_general<float>(x, wqkv, b3, wout, b1, r, ids, obuf, qkv, out, BW, V,
                                           C, H, nW, scale2, mask2, s);
  }
  if (is_bf16)
    return lcbi::launch_fwd<__nv_bfloat16>(x, wqkv, b3, wout, b1, r, ids, obuf, out, BW, V, C, H,
                                           nW, scale2, mask2, s);
  return lcbi::launch_fwd<float>(x, wqkv, b3, wout, b1, r, ids, obuf, out, BW, V, C, H, nW,
                                 scale2, mask2, s);
}
