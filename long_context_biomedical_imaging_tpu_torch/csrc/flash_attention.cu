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
// tile of scaled queries (64 rows, 32 at D = 128), the k and v tiles it
// walks, the scores, the probabilities and its fp32 output accumulator in
// shared memory, and carries
// the running max m and sum l of each row there, rescaling the accumulator by
// exp2(m_prev - m_new) as the max grows. The products read their operands
// from shared memory through WMMA (bf16); the softmax runs one warp per row.
// A simple kernel: no wgmma, TMA, cp.async or warp specialisation yet.
#include "flash_attention.cuh"

namespace lcbi {

template <typename T, typename F> __host__ __device__ constexpr size_t flash_fwd_smem() {
  return 3 * tile_bytes<T>(F::kTile, F::kLdT) + tile_bytes<T>(F::kTile, F::kLdP) +
         tile_bytes<float>(F::kTile, F::kLdS) + tile_bytes<float>(F::kTile, F::kLdA) +
         2 * F::kTile * 4;
}

// grid (query tiles, BH); q, k, v, o: (BH, L, D) in T; lse: (BH, L) fp32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int L, float scale2) {
  using F = FlashDims<D>;
  constexpr int kTile = F::kTile, kPer = kTile / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCursor cur{smem};
  T* qs = cur.take<T>(tile_bytes<T>(kTile, F::kLdT));
  T* ks = cur.take<T>(tile_bytes<T>(kTile, F::kLdT));
  T* vs = cur.take<T>(tile_bytes<T>(kTile, F::kLdT));
  T* ps = cur.take<T>(tile_bytes<T>(kTile, F::kLdP));
  float* s = cur.take<float>(tile_bytes<float>(kTile, F::kLdS));
  float* acc = cur.take<float>(tile_bytes<float>(kTile, F::kLdA));
  float* m = cur.take<float>(kTile * 4);
  float* l = cur.take<float>(kTile * 4);

  const int q0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.y * L * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows<F, T, true>(q + base, q0, L, qs, scale2);
  zero_acc<F>(acc);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    m[r] = kFlashNegInf;
    l[r] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += kTile) {
    load_rows<F, T, false>(k + base, k0, L, ks, 0.f);
    load_rows<F, T, false>(v + base, k0, L, vs, 0.f);
    __syncthreads();
    gemm<false, true>(s, F::kLdS, qs, F::kLdT, ks, F::kLdT, kTile, kTile, D, false);
    __syncthreads();
    // online softmax, one warp per row; lane j holds columns j, j + 32, ...
    for (int r = warp; r < kTile; r += kWarps) {
      const float* sr = s + r * F::kLdS;
      float sv[kPer];
      float mx = kFlashNegInf;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = lane + 32 * i;
        sv[i] = k0 + c < L ? sr[c] : kFlashNegInf;
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = exp2f(m_prev - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float p = exp2f(sv[i] - m_new);
        sum += p;
        ps[r * F::kLdP + lane + 32 * i] = from_f32<T>(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      float* ar = acc + r * F::kLdA;
      for (int c = lane; c < D; c += 32) ar[c] *= alpha;
      if (lane == 0) {
        m[r] = m_new;
        l[r] = l[r] * alpha + sum;
      }
    }
    __syncthreads();
    gemm<false, false>(acc, F::kLdA, ps, F::kLdP, vs, F::kLdT, kTile, D, kTile, true);
    __syncthreads();
  }
  // o = acc / l (l == 0 guarded as the TPU kernel does), lse = m + log2(l)
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const float lr = l[r];
    l[r] = lr == 0.f ? 1.f : lr;
    if (q0 + r < L) lse[(size_t)blockIdx.y * L + q0 + r] = m[r] + log2f(l[r]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < L) o[base + (size_t)(q0 + r) * D + c] = from_f32<T>(acc[r * F::kLdA + c] / l[r]);
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int L,
               float scale2, cudaStream_t stream) {
  using F = FlashDims<D>;
  constexpr size_t smem = flash_fwd_smem<T, F>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + F::kTile - 1) / F::kTile, BH);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), L, scale2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd_d(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int L,
                 int D, float scale2, cudaStream_t s) {
  if (D == 32) return launch_fwd<T, 32>(q, k, v, o, lse, BH, L, scale2, s);
  if (D == 64) return launch_fwd<T, 64>(q, k, v, o, lse, BH, L, scale2, s);
  return launch_fwd<T, 128>(q, k, v, o, lse, BH, L, scale2, s);
}

}  // namespace lcbi

// q, k, v, o: (BH, L, D) contiguous in T (fp32 if is_bf16 == 0, else bf16);
// lse: (BH, L) fp32. D is 32, 64 or 128, 0 < BH < 65536, all pointers 32-byte
// aligned. scale2 = scale * log2(e). Returns cudaGetLastError() of the launch
// (or cudaErrorInvalidValue for a shape it does not take).
extern "C" int lcbi_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int BH, int L, int D, float scale2, int is_bf16, void* stream) {
  (void)cudaGetLastError();
  if (!lcbi::flash_shape_ok(BH, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return lcbi::launch_fwd_d<__nv_bfloat16>(q, k, v, o, lse, BH, L, D, scale2, s);
  return lcbi::launch_fwd_d<float>(q, k, v, o, lse, BH, L, D, scale2, s);
}
