// Flash attention (K5), forward: o = softmax(q k^T * scale) v over (BH, L, D),
// non-causal, with the base-2 online softmax of flash_attention.cuh; also
// writes lse, the base-2 log-sum-exp of each row, for the backward.
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/flash_attention.py
// _fwd_kernel (launched by _flash_fwd, entry flash_attention).
//
// What bounds it on the H100: the two products, 4 L^2 D FLOPs per head, on
// the tensor cores (989 TFLOP/s in bf16), against 4 L D elements in and out:
// at L = 16,385 and D = 64 some 8,000 FLOPs a byte, so the products bound it,
// plus L^2 exp2 per head (chip_smoke.py kernel_bounds).
// What the design does about it: no (L, L) tensor exists; a block keeps its
// 64 scaled queries, the k and v tiles it walks, the scores, the
// probabilities and its fp32 output accumulator in shared memory, and carries
// the running max m and sum l of each row there, rescaling the accumulator by
// exp2(m_prev - m_new) as the max grows. The products read their operands
// from shared memory through WMMA (bf16); the softmax runs one warp per row.
// A simple kernel: no wgmma, TMA, cp.async or warp specialisation yet.
#include "flash_attention.cuh"

namespace lcbi {

template <typename T> __host__ __device__ constexpr size_t flash_fwd_smem() {
  return 4 * tile_bytes_t<T>() + 2 * tile_bytes_f() + 2 * kFlashTile * 4;
}

// grid (query tiles, BH); q, k, v, o: (BH, L, D) in T; lse: (BH, L) fp32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int L, float scale2) {
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCursor cur{smem};
  T* qs = cur.take<T>(tile_bytes_t<T>());
  T* ks = cur.take<T>(tile_bytes_t<T>());
  T* vs = cur.take<T>(tile_bytes_t<T>());
  T* ps = cur.take<T>(tile_bytes_t<T>());
  float* s = cur.take<float>(tile_bytes_f());
  float* acc = cur.take<float>(tile_bytes_f());
  float* m = cur.take<float>(kFlashTile * 4);
  float* l = cur.take<float>(kFlashTile * 4);

  const int q0 = blockIdx.x * kFlashTile;
  const size_t base = (size_t)blockIdx.y * L * kFlashD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows<T, true>(q + base, q0, L, qs, scale2);
  zero_f(acc);
  for (int r = threadIdx.x; r < kFlashTile; r += kThreads) {
    m[r] = kFlashNegInf;
    l[r] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += kFlashTile) {
    load_rows<T, false>(k + base, k0, L, ks, 0.f);
    load_rows<T, false>(v + base, k0, L, vs, 0.f);
    __syncthreads();
    gemm<false, true>(s, kLdF, qs, kLdT, ks, kLdT, kFlashTile, kFlashTile, kFlashD, false);
    __syncthreads();
    // online softmax, one warp per row; lane j holds columns j and j + 32
    for (int r = warp; r < kFlashTile; r += kWarps) {
      const float* sr = s + r * kLdF;
      const float a = k0 + lane < L ? sr[lane] : kFlashNegInf;
      const float b = k0 + lane + 32 < L ? sr[lane + 32] : kFlashNegInf;
      float mx = fmaxf(a, b);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = exp2f(m_prev - m_new);
      const float pa = exp2f(a - m_new), pb = exp2f(b - m_new);
      float sum = pa + pb;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[r * kLdT + lane] = from_f32<T>(pa);
      ps[r * kLdT + lane + 32] = from_f32<T>(pb);
      float* ar = acc + r * kLdF;
      ar[lane] *= alpha;
      ar[lane + 32] *= alpha;
      if (lane == 0) {
        m[r] = m_new;
        l[r] = l[r] * alpha + sum;
      }
    }
    __syncthreads();
    gemm<false, false>(acc, kLdF, ps, kLdT, vs, kLdT, kFlashTile, kFlashD, kFlashTile, true);
    __syncthreads();
  }
  // o = acc / l (l == 0 guarded as the TPU kernel does), lse = m + log2(l)
  for (int r = threadIdx.x; r < kFlashTile; r += kThreads) {
    const float lr = l[r];
    l[r] = lr == 0.f ? 1.f : lr;
    if (q0 + r < L) lse[(size_t)blockIdx.y * L + q0 + r] = m[r] + log2f(l[r]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kFlashTile * kFlashD; i += kThreads) {
    const int r = i / kFlashD, c = i % kFlashD;
    if (q0 + r < L)
      o[base + (size_t)(q0 + r) * kFlashD + c] = from_f32<T>(acc[r * kLdF + c] / l[r]);
  }
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int L,
               float scale2, cudaStream_t stream) {
  constexpr size_t smem = flash_fwd_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kFlashTile - 1) / kFlashTile, BH);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), L, scale2);
  return (int)cudaGetLastError();
}

}  // namespace lcbi

// q, k, v, o: (BH, L, D) contiguous in T (fp32 if is_bf16 == 0, else bf16);
// lse: (BH, L) fp32. D == 64, 0 < BH < 65536, all pointers 32-byte aligned.
// scale2 = scale * log2(e). Returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for a shape it does not take).
extern "C" int lcbi_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int BH, int L, int D, float scale2, int is_bf16, void* stream) {
  (void)cudaGetLastError();
  if (!lcbi::flash_shape_ok(BH, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return lcbi::launch_fwd<__nv_bfloat16>(q, k, v, o, lse, BH, L, scale2, s);
  return lcbi::launch_fwd<float>(q, k, v, o, lse, BH, L, scale2, s);
}
