// Flash attention (K5), backward, dq: for each query, the sum over all keys
// of ds k, from the forward's saved lse and delta = rowsum(do * o) (see
// flash_attention.cuh for the formulas and the roundings).
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/flash_attention.py
// _dq_kernel (launched by _flash_bwd). Together with flash_attention_dkv.cu it
// also covers _bwd_fused_kernel, the TPU's single-sweep variant for dq, dk
// and dv, which exists to fit v5e's VMEM budget and is not ported.
//
// What bounds it on the H100: three products per (query tile, key tile) pair
// (qs k^T recomputed, do v^T, ds k), 6 L^2 D FLOPs per head on the tensor
// cores, plus L^2 exp2. What the design does about it: a block owns a tile
// of queries and walks every key tile in order, keeping qs, do, the k and v
// tiles, the recomputed scores and dp, the rounded ds and its fp32 dq
// accumulator in shared memory: no (L, L) tensor exists, and dq is written
// once, with no atomics (deterministic). A simple kernel, as the forward.
#include "flash_attention.cuh"

namespace lcbi {

template <typename T, typename F> __host__ __device__ constexpr size_t flash_dq_smem() {
  return 4 * tile_bytes<T>(F::kTile, F::kLdT) + tile_bytes<T>(F::kTile, F::kLdP) +
         2 * tile_bytes<float>(F::kTile, F::kLdS) + tile_bytes<float>(F::kTile, F::kLdA) +
         2 * F::kTile * 4;
}

// grid (query tiles, BH); q, k, v, do, dq: (BH, L, D) in T; lse, delta: (BH,
// L) fp32; scale_out = scale2 / log2(e), the softmax scale.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int L, float scale2,
                float scale_out) {
  using F = FlashDims<D>;
  constexpr int kTile = F::kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCursor cur{smem};
  T* qs = cur.take<T>(tile_bytes<T>(kTile, F::kLdT));
  T* dos = cur.take<T>(tile_bytes<T>(kTile, F::kLdT));
  T* ks = cur.take<T>(tile_bytes<T>(kTile, F::kLdT));
  T* vs = cur.take<T>(tile_bytes<T>(kTile, F::kLdT));
  T* dst = cur.take<T>(tile_bytes<T>(kTile, F::kLdP));
  float* s = cur.take<float>(tile_bytes<float>(kTile, F::kLdS));
  float* dp = cur.take<float>(tile_bytes<float>(kTile, F::kLdS));
  float* acc = cur.take<float>(tile_bytes<float>(kTile, F::kLdA));
  float* lse_t = cur.take<float>(kTile * 4);
  float* delta_t = cur.take<float>(kTile * 4);

  const int q0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.y * L * D;
  const size_t vbase = (size_t)blockIdx.y * L;

  load_rows<F, T, true>(q + base, q0, L, qs, scale2);
  load_rows<F, T, false>(dout + base, q0, L, dos, 0.f);
  load_vec<F>(lse + vbase, q0, L, lse_t);
  load_vec<F>(delta + vbase, q0, L, delta_t);
  zero_acc<F>(acc);
  for (int k0 = 0; k0 < L; k0 += kTile) {
    load_rows<F, T, false>(k + base, k0, L, ks, 0.f);
    load_rows<F, T, false>(v + base, k0, L, vs, 0.f);
    __syncthreads();
    gemm<false, true>(s, F::kLdS, qs, F::kLdT, ks, F::kLdT, kTile, kTile, D, false);
    gemm<false, true>(dp, F::kLdS, dos, F::kLdT, vs, F::kLdT, kTile, kTile, D, false);
    __syncthreads();
    probs_and_dscores<F, T>(s, dp, lse_t, delta_t, q0, k0, L, nullptr, dst);
    __syncthreads();
    gemm<false, false>(acc, F::kLdA, dst, F::kLdP, ks, F::kLdT, kTile, D, kTile, true);
    __syncthreads();
  }
  store_rows<F, T>(acc, scale_out, q0, L, dq + base);
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int BH, int L, float scale2, float scale_out,
              cudaStream_t stream) {
  using F = FlashDims<D>;
  constexpr size_t smem = flash_dq_smem<T, F>();
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + F::kTile - 1) / F::kTile, BH);
  flash_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), L, scale2, scale_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq_d(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dq, int BH, int L, int D, float scale2,
                float scale_out, cudaStream_t s) {
  if (D == 32) return launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, BH, L, scale2, scale_out, s);
  if (D == 64) return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, BH, L, scale2, scale_out, s);
  return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, BH, L, scale2, scale_out, s);
}

}  // namespace lcbi

// q, k, v, dout, dq: (BH, L, D) contiguous in T (fp32 if is_bf16 == 0, else
// bf16); lse (the forward's) and delta = rowsum(dout * o): (BH, L) fp32. D is
// 32, 64 or 128, 0 < BH < 65536, pointers 32-byte aligned. scale2 = scale *
// log2(e), scale_out = scale. Returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for a shape it does not take).
extern "C" int lcbi_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int BH, int L,
                                 int D, float scale2, float scale_out, int is_bf16,
                                 void* stream) {
  (void)cudaGetLastError();
  if (!lcbi::flash_shape_ok(BH, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return lcbi::launch_dq_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, BH, L, D, scale2,
                                            scale_out, s);
  return lcbi::launch_dq_d<float>(q, k, v, dout, lse, delta, dq, BH, L, D, scale2, scale_out, s);
}
