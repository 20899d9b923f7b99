// Shared device code of K2's (and K2''s) forward and backward (fused_mlp.cu,
// fused_mlp_bwd.cu): the GELU forms, the hidden chunk, and the weight slices
// their bf16 row kernels stage through a ring of cp.async copies with the
// tails past C and H zeroed, so that both take the weights at their true
// widths.
#pragma once

#include "mma_gemm.cuh"   // stage16, the mma.sync fragments, cp.async

namespace lcbi {

constexpr int kHidChunk = 64;                 // hidden columns per chunk
constexpr int kSliceK = 64;                   // depth of a staged bf16 weight slice
constexpr int kLdW = kHidChunk + 8;           // staged slices' leading dimension
constexpr int kSlice = kSliceK * kLdW;        // elements of one staged slice
constexpr int kRing = 3;                      // stages of the bf16 slice rings

constexpr float kTanhC0 = 0.79788456080286536f;   // sqrt(2 / pi)
constexpr float kTanhC1 = 0.044715f;

// GELU in the TPU kernel's forms (_gelu): the tanh form under bf16, the exact
// erf form in fp32.
template <typename T> __device__ __forceinline__ float gelu(float u);
template <> __device__ __forceinline__ float gelu<float>(float u) {
  return 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
}
template <> __device__ __forceinline__ float gelu<__nv_bfloat16>(float u) {
  return 0.5f * u * (1.f + tanhf(kTanhC0 * (u + kTanhC1 * u * u * u)));
}

// GELU and its derivative, in the same forms.
template <typename T> __device__ __forceinline__ void gelu_and_grad(float u, float& g, float& dg);
template <> __device__ __forceinline__ void gelu_and_grad<float>(float u, float& g, float& dg) {
  const float cdf = 0.5f * (1.f + erff(u * 0.70710678118654752f));
  g = u * cdf;
  dg = cdf + u * 0.39894228040143268f * expf(-0.5f * u * u);
}
template <> __device__ __forceinline__ void gelu_and_grad<__nv_bfloat16>(float u, float& g,
                                                                          float& dg) {
  const float th = tanhf(kTanhC0 * (u + kTanhC1 * u * u * u));
  g = 0.5f * u * (1.f + th);
  dg = 0.5f * (1.f + th) + 0.5f * u * (1.f - th * th) * kTanhC0 * (1.f + 3.f * kTanhC1 * u * u);
}

// Rows [r0, r0 + NROWS) and columns [c0, c0 + NCOLS) of a row-major (rows,
// cols) bf16 matrix with leading dimension ld into dst (leading dimension
// ldd), zero past rows and cols; NCOLS a multiple of 8. vec: ld and the
// matrix 16-byte aligned (stage16). The block's kThreads threads share it.
template <int NROWS, int NCOLS>
__device__ __forceinline__ void stage_slice16(bf16* dst, int ldd, const bf16* __restrict__ src,
                                              int r0, int rows, int c0, int cols, int ld,
                                              bool vec) {
  constexpr int kPer = NCOLS / 8;
#pragma unroll
  for (int e = threadIdx.x; e < NROWS * kPer; e += kThreads) {
    const int r = e / kPer, c = (e % kPer) * 8;
    stage16(dst + r * ldd + c, src, r0 + r, rows, c0 + c, cols, ld, vec);
  }
}

}  // namespace lcbi
