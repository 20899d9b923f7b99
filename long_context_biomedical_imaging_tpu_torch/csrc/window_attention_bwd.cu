// Swin window attention K8, backward: from dout, the gradients of the
// forward of window_attention.cu except the weights' (window_attention_wgrad.cu
// sums those from this kernel's streams):
//     dx (BW, V, C) in T;
//     dqkv (BW V, 3C) in T, the head-major [dq | dk | dv] rows;
//     o (BW V, C) in T, every head's softmax(s_h) v_h;
//     dbqkv (3C), dbout (C) and drel (H, V, V) in fp32, summed over windows.
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/window_attention.py
// _bwd_kernel (pallas_call in _call_bwd). It recomputes the softmax from the
// inputs (no saved statistics) and rounds where that kernel rounds: q, k, v,
// p, o, do and ds to T before their products, dqkv to T, which is also the
// operand of dWqkv = x^T dqkv and of dx = dqkv Wqkv^T (and o of dWout =
// o^T dout); dbqkv sums the fp32 dqkv, drel the fp32 ds (natural units).
//
// What bounds it on the H100: operations, 14 T C^2 + 12 T V C of products
// here (the q | k | v projection recomputed, do, dx) against 6 T C bytes of
// streams in and out. The TPU kernel sums the weight and bias gradients into
// one VMEM block over its sequential grid. Here a persistent grid of G blocks
// walks contiguous ranges of 64-row tiles; dbqkv, dbout and drel, small, go to
// each block's own fp32 slot, summed by reduce_slots_kernel in a fixed order
// (no atomics: two launches give the same bits). The (C, 3C) and (C, C)
// weight gradients would need megabyte slots per block at C = 768, so this
// kernel writes dqkv and o in T instead, and the split-K kernel of
// window_attention_wgrad.cu contracts them.
#include "window_attention.cuh"

namespace lcbi {

constexpr int kLdG = kHeadDim + 4;  // the head's fp32 o product

struct BwdLayout {
  int lds, ldp;
  size_t off_g, off_q, off_qu, off_k, off_v, off_do, off_s, off_dp, off_p, off_ds, bytes;
};

__host__ __device__ inline BwdLayout bwd_layout(int V, int elem) {
  BwdLayout L;
  L.lds = ld_scores(V);
  L.ldp = ld_probs(V);
  const size_t t = align128((size_t)kTileRows * kLdT * elem);
  const size_t s = align128((size_t)kTileRows * L.lds * 4);
  const size_t p = align128((size_t)kTileRows * L.ldp * elem);
  L.off_g = align128((size_t)kTileRows * (kLdO > kLdF ? kLdO : kLdF) * 4);
  L.off_q = L.off_g + align128((size_t)kTileRows * kLdG * 4);
  L.off_qu = L.off_q + t;
  L.off_k = L.off_qu + t;
  L.off_v = L.off_k + t;
  L.off_do = L.off_v + t;
  L.off_s = L.off_do + t;
  L.off_dp = L.off_s + s;
  L.off_p = L.off_dp + s;
  L.off_ds = L.off_p + p;
  L.bytes = L.off_ds + p;
  return L;
}

// Slot layout (floats): dbqkv [0, 3C), dbout [3C, 4C), drel [4C, 4C + H V V).
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_bwd_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                            const float* __restrict__ bqkv, const T* __restrict__ wout,
                            const float* __restrict__ rel, const int* __restrict__ rid,
                            const T* __restrict__ dout, T* __restrict__ dx, T* dqkv,
                            T* __restrict__ o, float* __restrict__ slots, int BW, int V, int C,
                            int H, int nW, float scale, float scale2, float mask2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L = bwd_layout(V, sizeof(T));
  float* F = reinterpret_cast<float*>(smem);
  float* G = reinterpret_cast<float*>(smem + L.off_g);
  T* Q = reinterpret_cast<T*>(smem + L.off_q);
  T* QU = reinterpret_cast<T*>(smem + L.off_qu);
  T* K = reinterpret_cast<T*>(smem + L.off_k);
  T* Vt = reinterpret_cast<T*>(smem + L.off_v);
  T* DO = reinterpret_cast<T*>(smem + L.off_do);
  float* S = reinterpret_cast<float*>(smem + L.off_s);
  float* DP = reinterpret_cast<float*>(smem + L.off_dp);
  T* P = reinterpret_cast<T*>(smem + L.off_p);
  T* DS = reinterpret_cast<T*>(smem + L.off_ds);

  const size_t slot_floats = (size_t)4 * C + (size_t)H * V * V;
  float* slot = slots + (size_t)blockIdx.x * slot_floats;
  for (size_t e = threadIdx.x; e < slot_floats; e += kThreads) slot[e] = 0.f;
  __syncthreads();

  const int tw = kTileRows / V;
  const long long tiles = ((long long)BW + tw - 1) / tw;
  const long long t_begin = tiles * blockIdx.x / gridDim.x;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long t = t_begin; t < t_end; ++t) {
    const Tile tl = tile_of(t, BW, V);
    const int M = tl.M, nb = tl.nwin;
    const T* xr = x + tl.row0 * C;
    const T* gr = dout + tl.row0 * C;
    T* dr = dqkv + tl.row0 * 3 * C;
    T* orow = o + tl.row0 * C;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float acc = 0.f;
      for (int r = 0; r < M; ++r) acc += to_f32(gr[(size_t)r * C + c]);
      slot[3 * C + c] += acc;
    }

    for (int h = 0; h < H; ++h) {
      project_head(F, xr, wqkv, M, C, h);
      for (int e = threadIdx.x; e < M * 3 * kHeadDim; e += kThreads) {
        const int r = e / (3 * kHeadDim), j = e % (3 * kHeadDim);
        const int part = j / kHeadDim, d = j % kHeadDim;
        const float v = F[r * kLdF + j] + bqkv[part * C + h * kHeadDim + d];
        if (part == 0) {
          Q[r * kLdT + d] = from_f32<T>(v * scale2);
          QU[r * kLdT + d] = from_f32<T>(v);
        } else {
          (part == 1 ? K : Vt)[r * kLdT + d] = from_f32<T>(v);
        }
      }
      __syncthreads();
      gemm_batched<false, true>(nb, S, L.lds, V * L.lds, Q, kLdT, V * kLdT, K, kLdT, V * kLdT,
                                V, V, kHeadDim);
      // do_h = dout Wout[hD:(h+1)D, :]^T over the tile's rows
      gemm<false, true>(F, kLdF, gr, C, wout + (size_t)h * kHeadDim * C, C, M, kHeadDim, C,
                        false);
      __syncthreads();
      softmax_rows(S, L.lds, P, L.ldp, M, V, rel + (size_t)h * V * V, rid, nW, tl.w0, mask2);
      for (int e = threadIdx.x; e < M * kHeadDim; e += kThreads) {
        const int r = e / kHeadDim, d = e % kHeadDim;
        DO[r * kLdT + d] = from_f32<T>(F[r * kLdF + d]);
      }
      __syncthreads();
      // o_h = p v; dv = p^T do; dp = do v^T
      gemm_batched<false, false>(nb, G, kLdG, V * kLdG, P, L.ldp, V * L.ldp, Vt, kLdT, V * kLdT,
                                 V, kHeadDim, V);
      gemm_batched<true, false>(nb, F + 2 * kHeadDim, kLdF, V * kLdF, P, L.ldp, V * L.ldp, DO,
                                kLdT, V * kLdT, V, kHeadDim, V);
      gemm_batched<false, true>(nb, DP, L.lds, V * L.lds, DO, kLdT, V * kLdT, Vt, kLdT,
                                V * kLdT, V, V, kHeadDim);
      __syncthreads();
      for (int e = threadIdx.x; e < M * kHeadDim; e += kThreads) {
        const int r = e / kHeadDim, d = e % kHeadDim;
        orow[(size_t)r * C + h * kHeadDim + d] = from_f32<T>(G[r * kLdG + d]);
      }
      // ds = p (dp - rowsum(dp p)), one warp per row
      {
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        for (int r = warp; r < M; r += kWarps) {
          float delta = 0.f;
          for (int j = lane; j < V; j += 32) delta += DP[r * L.lds + j] * S[r * L.lds + j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            delta += __shfl_xor_sync(0xffffffffu, delta, off);
          for (int j = lane; j < V; j += 32) {
            const float ds = S[r * L.lds + j] * (DP[r * L.lds + j] - delta);
            DP[r * L.lds + j] = ds;
            DS[r * L.ldp + j] = from_f32<T>(ds);
          }
        }
      }
      __syncthreads();
      float* drel = slot + 4 * C + (size_t)h * V * V;
      for (int e = threadIdx.x; e < V * V; e += kThreads) {
        const int i = e / V, j = e % V;
        float acc = 0.f;
        for (int w = 0; w < nb; ++w) acc += DP[(w * V + i) * L.lds + j];
        drel[e] += acc;
      }
      // dq = ds k, dk = ds^T q (unscaled q; both times scale below)
      gemm_batched<false, false>(nb, F, kLdF, V * kLdF, DS, L.ldp, V * L.ldp, K, kLdT, V * kLdT,
                                 V, kHeadDim, V);
      gemm_batched<true, false>(nb, F + kHeadDim, kLdF, V * kLdF, DS, L.ldp, V * L.ldp, QU, kLdT,
                                V * kLdT, V, kHeadDim, V);
      __syncthreads();
      for (int j = threadIdx.x; j < 3 * kHeadDim; j += kThreads) {
        const float mul = j < 2 * kHeadDim ? scale : 1.f;
        const int col = (j / kHeadDim) * C + h * kHeadDim + j % kHeadDim;
        float acc = 0.f;
        for (int r = 0; r < M; ++r) {
          const float v = F[r * kLdF + j] * mul;
          acc += v;
          dr[(size_t)r * 3 * C + col] = from_f32<T>(v);
        }
        slot[col] += acc;
      }
      __syncthreads();
    }

    // dx = dqkv Wqkv^T over the tile's rows, in column chunks
    T* dxr = dx + tl.row0 * C;
    for (int n0 = 0; n0 < C; n0 += kOutCols) {
      const int nc = min(kOutCols, C - n0);
      gemm<false, true>(F, kLdO, dr, 3 * C, wqkv + (size_t)n0 * 3 * C, 3 * C, M, nc, 3 * C,
                        false);
      __syncthreads();
      for (int e = threadIdx.x; e < M * nc; e += kThreads) {
        const int r = e / nc, j = e % nc;
        dxr[(size_t)r * C + n0 + j] = from_f32<T>(F[r * kLdO + j]);
      }
      __syncthreads();
    }
  }
}

template <typename T>
int launch_bwd(const void* x, const void* wqkv, const float* bqkv, const void* wout,
               const float* rel, const int* rid, const void* dout, void* dx, void* dqkv, void* o,
               float* slots, float* red, int BW, int V, int C, int H, int nW, float scale,
               float scale2, float mask2, int max_slots, cudaStream_t stream) {
  const size_t bytes = bwd_layout(V, sizeof(T)).bytes;
  if (bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int tw = kTileRows / V;
  const long long tiles = ((long long)BW + tw - 1) / tw;
  const int G = persistent_blocks(window_attention_bwd_kernel<T>, bytes, tiles, max_slots);
  if (G <= 0) return (int)cudaErrorInvalidValue;
  window_attention_bwd_kernel<T><<<G, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), bqkv, static_cast<const T*>(wout),
      rel, rid, static_cast<const T*>(dout), static_cast<T*>(dx), static_cast<T*>(dqkv),
      static_cast<T*>(o), slots, BW, V, C, H, nW, scale, scale2, mask2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(slots, G, (size_t)4 * C + (size_t)H * V * V, red, stream);
}

}  // namespace lcbi

// x, dout, dx: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); dqkv (BW V,
// 3C) and o (BW V, C) in T, written; wqkv (C, 3C), wout (C, C) in T; bqkv (3C,),
// rel (H, V, V) fp32; rid (nW, V) int32 or NULL. slots: max_slots x (4C + H V V)
// fp32 scratch; red (4C + H V V) fp32 receives [dbqkv | dbout | drel]. Shapes
// as lcbi_window_attention_fwd. Returns cudaGetLastError() of the launches.
extern "C" int lcbi_window_attention_bwd(const void* x, const void* wqkv, const void* bqkv,
                                         const void* wout, const void* rel, const void* rid,
                                         const void* dout, void* dx, void* dqkv, void* o,
                                         void* slots, void* red, int BW, int V, int C, int H,
                                         int nW, float scale, float scale2, float mask2,
                                         int max_slots, int is_bf16, void* stream) {
  (void)cudaGetLastError();
  if (!lcbi::attn_shape_ok(BW, V, C, H) || (rid != nullptr && (nW <= 0 || BW % nW != 0)) ||
      (long long)BW * V * 3 * C >= (1LL << 31) || max_slots < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b3 = static_cast<const float*>(bqkv);
  const float* r = static_cast<const float*>(rel);
  const int* ids = static_cast<const int*>(rid);
  float* sl = static_cast<float*>(slots);
  float* rd = static_cast<float*>(red);
  if (is_bf16)
    return lcbi::launch_bwd<__nv_bfloat16>(x, wqkv, b3, wout, r, ids, dout, dx, dqkv, o, sl, rd,
                                           BW, V, C, H, nW, scale, scale2, mask2, max_slots, s);
  return lcbi::launch_bwd<float>(x, wqkv, b3, wout, r, ids, dout, dx, dqkv, o, sl, rd, BW, V, C,
                                 H, nW, scale, scale2, mask2, max_slots, s);
}
