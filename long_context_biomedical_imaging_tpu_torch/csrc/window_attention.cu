// Swin window attention K8, forward: per window of V tokens, H heads of D = C / H
// (any D; window_attention.cuh),
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
// Windows of other sizes up to 512 tokens, and other head dims, take the
// general path: the q | k | v projection into device memory in T (q scale
// log2(e) rounded once, as above), the attention per (head, 64 query rows,
// window), and the out projection of o. In bf16 up to D = 128 those are the
// kernels of window_attention_mma.cuh, designed for Hopper (a two-pass
// softmax on register-resident mma.sync fragments, the bias slice in shared
// memory over many windows, k and v through a cp.async ring); in fp32, and
// in bf16 above D = 128, the shared-memory kernels of window_attention.cuh
// (full score rows per query tile, D walked in chunks).
#include "window_attention_mma.cuh"

namespace lcbi {

struct FwdLayout {
  int lds, ldp;
  size_t off_q, off_k, off_v, off_s, off_p, bytes;
};

template <int KD> __host__ __device__ inline FwdLayout fwd_layout(int V, int elem) {
  FwdLayout L;
  L.lds = ld_scores(V);
  L.ldp = ld_probs(V);
  const size_t f = align128((size_t)kTileRows * ld_wide<KD>() * 4);
  const size_t t = align128((size_t)kTileRows * HeadDims<KD>::kLdT * elem);
  L.off_q = f;
  L.off_k = L.off_q + t;
  L.off_v = L.off_k + t;
  L.off_s = L.off_v + t;
  L.off_p = L.off_s + align128((size_t)kTileRows * L.lds * 4);
  L.bytes = L.off_p + align128((size_t)kTileRows * L.ldp * elem);
  return L;
}

template <typename T, int KD>
__global__ void __launch_bounds__(kThreads)
window_attention_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                            const float* __restrict__ bqkv, const T* __restrict__ wout,
                            const float* __restrict__ bout, const float* __restrict__ rel,
                            const int* __restrict__ rid, T* obuf, T* __restrict__ out, int BW,
                            int V, int C, int H, int nW, float scale2, float mask2) {
  constexpr int kLdT = HeadDims<KD>::kLdT, kLdF = HeadDims<KD>::kLdF, kLdO = kOutCols + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L = fwd_layout<KD>(V, sizeof(T));
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
    project_head<KD>(F, xr, wqkv, M, C, h);
    for (int e = threadIdx.x; e < M * 3 * KD; e += kThreads) {
      const int r = e / (3 * KD), j = e % (3 * KD);
      const int part = j / KD, d = j % KD;
      const float v = F[r * kLdF + j] + bqkv[part * C + h * KD + d];
      T* dst = part == 0 ? Q : (part == 1 ? K : Vt);
      dst[r * kLdT + d] = from_f32<T>(part == 0 ? v * scale2 : v);
    }
    __syncthreads();
    gemm_batched<false, true>(nb, S, L.lds, V * L.lds, Q, kLdT, V * kLdT, K, kLdT, V * kLdT, V,
                              V, KD);
    __syncthreads();
    softmax_rows(S, L.lds, P, L.ldp, M, V, rel + (size_t)h * V * V, rid, nW, tl.w0, mask2);
    __syncthreads();
    gemm_batched<false, false>(nb, F, kLdF, V * kLdF, P, L.ldp, V * L.ldp, Vt, kLdT, V * kLdT, V,
                               KD, V);
    __syncthreads();
    for (int e = threadIdx.x; e < M * KD; e += kThreads) {
      const int r = e / KD, d = e % KD;
      orow[(size_t)r * C + h * KD + d] = from_f32<T>(F[r * kLdF + d]);
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

template <typename T, int KD>
int launch_fwd_general(const void* x, const void* wqkv, const float* bqkv, const void* wout,
                       const float* bout, const float* rel, const int* rid, void* obuf,
                       void* qkv, void* out, int BW, int V, int C, int H, int nW, float scale2,
                       float mask2, cudaStream_t stream) {
  const int N = BW * V;
  int err = launch_projection<T>(x, C, wqkv, 3 * C, false, bqkv, qkv, 3 * C, N, 3 * C, C, C, scale2,
                           -1, stream);
  if (err != 0) return err;
  int blocks = 0;
  err = launch_rows<T, false, KD>(qkv, 3 * C, rel, rid, nullptr, nullptr, obuf, nullptr, nullptr,
                                  nullptr, 1, BW, V, C, H, nW, 1.f, mask2, &blocks, stream);
  if (err != 0) return err;
  return launch_projection<T>(obuf, C, wout, C, false, bout, out, C, N, C, C, 0, 1.f, -1, stream);
}

template <typename T, int KD>
int launch_fwd_whole(const void* x, const void* wqkv, const float* bqkv, const void* wout,
                     const float* bout, const float* rel, const int* rid, void* obuf, void* out,
                     int BW, int V, int C, int H, int nW, float scale2, float mask2,
                     cudaStream_t stream) {
  const size_t bytes = fwd_layout<KD>(V, sizeof(T)).bytes;
  if (bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_attention_fwd_kernel<T, KD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int tw = kTileRows / V;
  const long long tiles = ((long long)BW + tw - 1) / tw;
  window_attention_fwd_kernel<T, KD><<<(unsigned)tiles, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), bqkv, static_cast<const T*>(wout),
      bout, rel, rid, static_cast<T*>(obuf), static_cast<T*>(out), BW, V, C, H, nW, scale2, mask2);
  return (int)cudaGetLastError();
}

// The whole-window path where it takes the shape, else the general path;
// both at the padded head dim KD.
template <typename T, int KD>
int launch_fwd(const void* x, const void* wqkv, const float* bqkv, const void* wout,
               const float* bout, const float* rel, const int* rid, void* obuf, void* qkv,
               void* out, int BW, int V, int C, int H, int nW, float scale2, float mask2,
               cudaStream_t s) {
  if (whole_window_path(V, C, H))
    return launch_fwd_whole<T, KD>(x, wqkv, bqkv, wout, bout, rel, rid, obuf, out, BW, V, C, H,
                                   nW, scale2, mask2, s);
  if (qkv == nullptr) return (int)cudaErrorInvalidValue;
  return launch_fwd_general<T, KD>(x, wqkv, bqkv, wout, bout, rel, rid, obuf, qkv, out, BW, V, C,
                                   H, nW, scale2, mask2, s);
}

// The general path in bf16 at D <= 128 (window_attention_mma.cuh): the q | k
// | v projection, the mma row kernel, the out projection.
template <int KD>
int launch_fwd_mma(const void* x, const void* wqkv, const float* bqkv, const void* wout,
                   const float* bout, const float* rel, const int* rid, void* obuf, void* qkv,
                   void* out, int BW, int V, int C, int H, int nW, float scale2, float mask2,
                   cudaStream_t stream) {
  const int N = BW * V;
  int err = launch_projection<bf16>(x, C, wqkv, 3 * C, false, bqkv, qkv, 3 * C, N, 3 * C, C, C,
                                    scale2, -1, stream);
  if (err != 0) return err;
  const int G = mma_row_blocks<false, KD>(BW, V, H);
  err = launch_rows_mma<false, KD>(qkv, 3 * C, rel, rid, nullptr, nullptr, obuf, nullptr, nullptr,
                                   nullptr, G, BW, V, C, H, nW, 1.f, mask2, stream);
  if (err != 0) return err;
  return launch_projection<bf16>(obuf, C, wout, C, false, bout, out, C, N, C, C, 0, 1.f, -1,
                                 stream);
}

template <typename T>
int launch_fwd_d(const void* x, const void* wqkv, const float* bqkv, const void* wout,
                 const float* bout, const float* rel, const int* rid, void* obuf, void* qkv,
                 void* out, int BW, int V, int C, int H, int nW, float scale2, float mask2,
                 cudaStream_t s) {
  const int D = C / H;
  if (std::is_same<T, bf16>::value && !whole_window_path(V, C, H) && D <= kMmaMaxHeadDim) {
    if (qkv == nullptr) return (int)cudaErrorInvalidValue;
    switch (mma_head_dim(D)) {
      case 16:
        return launch_fwd_mma<16>(x, wqkv, bqkv, wout, bout, rel, rid, obuf, qkv, out, BW, V, C,
                                  H, nW, scale2, mask2, s);
      case 32:
        return launch_fwd_mma<32>(x, wqkv, bqkv, wout, bout, rel, rid, obuf, qkv, out, BW, V, C,
                                  H, nW, scale2, mask2, s);
      case 64:
        return launch_fwd_mma<64>(x, wqkv, bqkv, wout, bout, rel, rid, obuf, qkv, out, BW, V, C,
                                  H, nW, scale2, mask2, s);
      default:
        return launch_fwd_mma<128>(x, wqkv, bqkv, wout, bout, rel, rid, obuf, qkv, out, BW, V, C,
                                   H, nW, scale2, mask2, s);
    }
  }
  switch (launch_head_dim(V, C, H, std::is_same<T, float>::value)) {
    case 16:
      return launch_fwd<T, 16>(x, wqkv, bqkv, wout, bout, rel, rid, obuf, qkv, out, BW, V, C, H,
                               nW, scale2, mask2, s);
    case 32:
      return launch_fwd<T, 32>(x, wqkv, bqkv, wout, bout, rel, rid, obuf, qkv, out, BW, V, C, H,
                               nW, scale2, mask2, s);
    default:
      return launch_fwd<T, 64>(x, wqkv, bqkv, wout, bout, rel, rid, obuf, qkv, out, BW, V, C, H,
                               nW, scale2, mask2, s);
  }
}

}  // namespace lcbi

// x, out, obuf: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); obuf is
// scratch, and so is qkv (BW V, 3C) in T, which only the general path uses
// (NULL otherwise). wqkv (C, 3C), wout (C, C) in T; bqkv (3C,), bout (C,), rel
// (H, V, V) fp32; rid (nW, V) int32 or NULL (then nW is ignored). C = D H
// with any D >= 1, 1 <= V <= 512 (lcbi_window_attention_whole says which
// path takes the shape), all pointers 32-byte aligned. scale2 = scale
// log2(e), mask2 = mask_value log2(e). Returns cudaGetLastError() of the
// launches.
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
  if (is_bf16)
    return lcbi::launch_fwd_d<__nv_bfloat16>(x, wqkv, b3, wout, b1, r, ids, obuf, qkv, out, BW, V,
                                             C, H, nW, scale2, mask2, s);
  return lcbi::launch_fwd_d<float>(x, wqkv, b3, wout, b1, r, ids, obuf, qkv, out, BW, V, C, H,
                                   nW, scale2, mask2, s);
}
