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

// Rows [0, rows_pad) of a bf16 tile of cpad columns (cpad a multiple of 8,
// at least C) into ys (leading dimension lds), row r from src + (r - lo) C:
// rows outside [lo, hi) and columns [C, cpad) zero. 16-byte cp.async copies
// where vec (C % 8 == 0 and src 16-byte aligned), else element by element;
// the caller commits the group. The block's kThreads threads share it.
__device__ __forceinline__ void stage_rows16(bf16* ys, int lds, const bf16* __restrict__ src,
                                             int lo, int hi, int rows_pad, int C, int cpad,
                                             bool vec) {
  const int per = cpad / 8;
  for (int e = threadIdx.x; e < rows_pad * per; e += kThreads) {
    const int r = e / per, c = (e % per) * 8;
    const long long sr = r >= lo && r < hi ? r - lo : hi - lo;   // hi - lo: outside, zeros
    stage16(ys + r * lds + c, src, sr, hi - lo, c, C, C, vec);
  }
}

// LayerNorm in place over rows [0, rows) of a bf16 tile in shared memory, as
// common.cuh layernorm_rows computes it from the same bf16 values (fp32
// statistics E[x^2] - mu^2, eps 1e-6, the affine g, b in fp32, rounded to
// bf16 once); nothing with ln == 0. One warp per row.
__device__ __forceinline__ void layernorm_rows_inplace(bf16* ys, int lds, int rows, int C,
                                                       const float* __restrict__ g,
                                                       const float* __restrict__ b, int ln) {
  if (!ln) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float inv = 1.f / (float)C;
  // two rows a warp at a time (r and r + kWarps), their sums interleaved
  for (int r0 = warp; r0 < rows; r0 += 2 * kWarps) {
    const bool two = r0 + kWarps < rows;
    bf16* yr[2] = {ys + (size_t)r0 * lds, ys + (size_t)(two ? r0 + kWarps : r0) * lds};
    float s[2] = {0.f, 0.f}, ss[2] = {0.f, 0.f};
    for (int c = lane; c < C; c += 32) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v = __bfloat162float(yr[i][c]);
        s[i] += v;
        ss[i] += v * v;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
        ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], o);
      }
    float mu[2], rstd[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mu[i] = s[i] * inv;
      rstd[i] = rsqrtf(ss[i] * inv - mu[i] * mu[i] + kLnEps);
    }
    for (int c = lane; c < C; c += 32) {
      const float gc = g[c], bc = b[c];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 1 && !two) break;
        const float xhat = (__bfloat162float(yr[i][c]) - mu[i]) * rstd[i];
        yr[i][c] = __float2bfloat16(xhat * gc + bc);
      }
    }
  }
}

}  // namespace lcbi
