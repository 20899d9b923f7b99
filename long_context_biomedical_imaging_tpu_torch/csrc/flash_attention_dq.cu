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
// cores, plus L^2 exp2. What the design does about it: a block owns 64
// queries and walks every key tile in order, keeping qs, do, the k and v
// tiles, the recomputed scores and dp, the rounded ds and its fp32 dq
// accumulator in shared memory: no (L, L) tensor exists, and dq is written
// once, with no atomics (deterministic). A simple kernel, as the forward.
#include "flash_attention.cuh"

namespace lcbi {

template <typename T> __host__ __device__ constexpr size_t flash_dq_smem() {
  return 5 * tile_bytes_t<T>() + 3 * tile_bytes_f() + 2 * kFlashTile * 4;
}

// grid (query tiles, BH); q, k, v, do, dq: (BH, L, D) in T; lse, delta: (BH,
// L) fp32; scale_out = scale2 / log2(e), the softmax scale.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int L, float scale2,
                float scale_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCursor cur{smem};
  T* qs = cur.take<T>(tile_bytes_t<T>());
  T* dos = cur.take<T>(tile_bytes_t<T>());
  T* ks = cur.take<T>(tile_bytes_t<T>());
  T* vs = cur.take<T>(tile_bytes_t<T>());
  T* dst = cur.take<T>(tile_bytes_t<T>());
  float* s = cur.take<float>(tile_bytes_f());
  float* dp = cur.take<float>(tile_bytes_f());
  float* acc = cur.take<float>(tile_bytes_f());
  float* lse_t = cur.take<float>(kFlashTile * 4);
  float* delta_t = cur.take<float>(kFlashTile * 4);

  const int q0 = blockIdx.x * kFlashTile;
  const size_t base = (size_t)blockIdx.y * L * kFlashD;
  const size_t vbase = (size_t)blockIdx.y * L;

  load_rows<T, true>(q + base, q0, L, qs, scale2);
  load_rows<T, false>(dout + base, q0, L, dos, 0.f);
  load_vec(lse + vbase, q0, L, lse_t);
  load_vec(delta + vbase, q0, L, delta_t);
  zero_f(acc);
  for (int k0 = 0; k0 < L; k0 += kFlashTile) {
    load_rows<T, false>(k + base, k0, L, ks, 0.f);
    load_rows<T, false>(v + base, k0, L, vs, 0.f);
    __syncthreads();
    gemm<false, true>(s, kLdF, qs, kLdT, ks, kLdT, kFlashTile, kFlashTile, kFlashD, false);
    gemm<false, true>(dp, kLdF, dos, kLdT, vs, kLdT, kFlashTile, kFlashTile, kFlashD, false);
    __syncthreads();
    probs_and_dscores<T>(s, dp, lse_t, delta_t, q0, k0, L, nullptr, dst);
    __syncthreads();
    gemm<false, false>(acc, kLdF, dst, kLdT, ks, kLdT, kFlashTile, kFlashD, kFlashTile, true);
    __syncthreads();
  }
  store_rows<T>(acc, scale_out, q0, L, dq + base);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int BH, int L, float scale2, float scale_out,
              cudaStream_t stream) {
  constexpr size_t smem = flash_dq_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kFlashTile - 1) / kFlashTile, BH);
  flash_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), L, scale2, scale_out);
  return (int)cudaGetLastError();
}

}  // namespace lcbi

// q, k, v, dout, dq: (BH, L, D) contiguous in T (fp32 if is_bf16 == 0, else
// bf16); lse (the forward's) and delta = rowsum(dout * o): (BH, L) fp32. D ==
// 64, 0 < BH < 65536, pointers 32-byte aligned. scale2 = scale * log2(e),
// scale_out = scale. Returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for a shape it does not take).
extern "C" int lcbi_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int BH, int L,
                                 int D, float scale2, float scale_out, int is_bf16,
                                 void* stream) {
  (void)cudaGetLastError();
  if (!lcbi::flash_shape_ok(BH, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return lcbi::launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, BH, L, scale2,
                                          scale_out, s);
  return lcbi::launch_dq<float>(q, k, v, dout, lse, delta, dq, BH, L, scale2, scale_out, s);
}
