// Flash attention (K5), backward, dk and dv: for each key, the sums over all
// queries of ds^T q and p^T do, from the forward's saved lse and delta =
// rowsum(do * o) (see flash_attention.cuh for the formulas and the
// roundings: ds and p are rounded to T, dk is contracted against the
// unscaled q and scaled once at the end).
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/flash_attention.py
// _dkv_kernel (launched by _flash_bwd); with flash_attention_dq.cu it also
// covers the single-sweep _bwd_fused_kernel.
//
// What bounds it on the H100: four products per (key tile, query tile) pair
// (qs k^T and do v^T recomputed, p^T do, ds^T q), 8 L^2 D FLOPs per head on
// the tensor cores, plus L^2 exp2. What the design does about it: a block owns
// a tile of keys and walks every query tile in order, keeping its k and v
// tiles, the query tile (scaled and unscaled), do, the recomputed scores and
// dp, the
// rounded p and ds and the fp32 dk and dv accumulators in shared memory: no
// (L, L) tensor exists, and dk and dv are written once, with no atomics
// (deterministic). A simple kernel, as the forward.
#include "flash_attention.cuh"

namespace lcbi {

template <typename T, typename F> __host__ __device__ constexpr size_t flash_dkv_smem() {
  return 5 * tile_bytes<T>(F::kTile, F::kLdT) + 2 * tile_bytes<T>(F::kTile, F::kLdP) +
         2 * tile_bytes<float>(F::kTile, F::kLdS) + 2 * tile_bytes<float>(F::kTile, F::kLdA) +
         2 * F::kTile * 4;
}

// grid (key tiles, BH); q, k, v, do, dk, dv: (BH, L, D) in T; lse, delta:
// (BH, L) fp32; scale_out = scale2 / log2(e), the softmax scale.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int L,
                 float scale2, float scale_out) {
  using F = FlashDims<D>;
  constexpr int kTile = F::kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCursor cur{smem};
  T* ks = cur.take<T>(tile_bytes<T>(kTile, F::kLdT));
  T* vs = cur.take<T>(tile_bytes<T>(kTile, F::kLdT));
  T* qs = cur.take<T>(tile_bytes<T>(kTile, F::kLdT));
  T* qr = cur.take<T>(tile_bytes<T>(kTile, F::kLdT));
  T* dos = cur.take<T>(tile_bytes<T>(kTile, F::kLdT));
  T* pt = cur.take<T>(tile_bytes<T>(kTile, F::kLdP));
  T* dst = cur.take<T>(tile_bytes<T>(kTile, F::kLdP));
  float* s = cur.take<float>(tile_bytes<float>(kTile, F::kLdS));
  float* dp = cur.take<float>(tile_bytes<float>(kTile, F::kLdS));
  float* dk_acc = cur.take<float>(tile_bytes<float>(kTile, F::kLdA));
  float* dv_acc = cur.take<float>(tile_bytes<float>(kTile, F::kLdA));
  float* lse_t = cur.take<float>(kTile * 4);
  float* delta_t = cur.take<float>(kTile * 4);

  const int k0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.y * L * D;
  const size_t vbase = (size_t)blockIdx.y * L;

  load_rows<F, T, false>(k + base, k0, L, ks, 0.f);
  load_rows<F, T, false>(v + base, k0, L, vs, 0.f);
  zero_acc<F>(dk_acc);
  zero_acc<F>(dv_acc);
  for (int q0 = 0; q0 < L; q0 += kTile) {
    load_rows<F, T, true>(q + base, q0, L, qs, scale2);
    load_rows<F, T, false>(q + base, q0, L, qr, 0.f);
    load_rows<F, T, false>(dout + base, q0, L, dos, 0.f);
    load_vec<F>(lse + vbase, q0, L, lse_t);
    load_vec<F>(delta + vbase, q0, L, delta_t);
    __syncthreads();
    gemm<false, true>(s, F::kLdS, qs, F::kLdT, ks, F::kLdT, kTile, kTile, D, false);
    gemm<false, true>(dp, F::kLdS, dos, F::kLdT, vs, F::kLdT, kTile, kTile, D, false);
    __syncthreads();
    probs_and_dscores<F, T>(s, dp, lse_t, delta_t, q0, k0, L, pt, dst);
    __syncthreads();
    // keys on rows: dv += p^T do, dk += ds^T q (A read column-major)
    gemm<true, false>(dv_acc, F::kLdA, pt, F::kLdP, dos, F::kLdT, kTile, D, kTile, true);
    gemm<true, false>(dk_acc, F::kLdA, dst, F::kLdP, qr, F::kLdT, kTile, D, kTile, true);
    __syncthreads();
  }
  store_rows<F, T>(dk_acc, scale_out, k0, L, dk + base);
  store_rows<F, T>(dv_acc, 1.f, k0, L, dv + base);
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int BH, int L, float scale2,
               float scale_out, cudaStream_t stream) {
  using F = FlashDims<D>;
  constexpr size_t smem = flash_dkv_smem<T, F>();
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + F::kTile - 1) / F::kTile, BH);
  flash_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), L, scale2,
      scale_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv_d(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dk, void* dv, int BH, int L, int D, float scale2,
                 float scale_out, cudaStream_t s) {
  if (D == 32)
    return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, BH, L, scale2, scale_out, s);
  if (D == 64)
    return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, BH, L, scale2, scale_out, s);
  return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, BH, L, scale2, scale_out, s);
}

}  // namespace lcbi

// q, k, v, dout, dk, dv: (BH, L, D) contiguous in T (fp32 if is_bf16 == 0,
// else bf16); lse (the forward's) and delta = rowsum(dout * o): (BH, L) fp32.
// D is 32, 64 or 128, 0 < BH < 65536, pointers 32-byte aligned. scale2 =
// scale * log2(e), scale_out = scale. Returns cudaGetLastError() of the
// launch (or cudaErrorInvalidValue for a shape it does not take).
extern "C" int lcbi_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int BH,
                                  int L, int D, float scale2, float scale_out, int is_bf16,
                                  void* stream) {
  (void)cudaGetLastError();
  if (!lcbi::flash_shape_ok(BH, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return lcbi::launch_dkv_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, BH, L, D, scale2,
                                             scale_out, s);
  return lcbi::launch_dkv_d<float>(q, k, v, dout, lse, delta, dk, dv, BH, L, D, scale2,
                                   scale_out, s);
}
