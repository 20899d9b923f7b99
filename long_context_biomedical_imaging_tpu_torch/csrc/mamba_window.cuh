// Shared device code of the fused Mamba window mixer kernels (K4):
// mamba_window.cu (forward) and mamba_window_bwd.cu (backward).
//
// Per window of V tokens (16 <= V <= 64, V % 8 == 0), C channels, Dh = C / 2,
// dt rank R, N <= 16 states, W = R + 2N columns of x_proj:
//     xz = [LN](x) @ wxz;  u = conv3_same(xz);  s = u * sigmoid(u);  x | z = s
//     dbl = x @ wdbl = [dt | B | C];  dtv = dt @ wdt + dtb2;  delta = softplus(dtv)
//     h[t] = exp(delta[t] A) h[t-1] + delta[t] x[t] B[t];  y[t] = C[t] . h[t] + D x[t]
//     out = [x +] [y | z] @ wout
// The four products take operands rounded to the stream type T (bf16 under
// AMP) and sum in fp32; everything else is fp32.
//
// States: the kernels take the true d_state N at run time and run on a
// padded state count NP (8 or 16, a template argument) that holds it, reading
// the padded states' A, B and C as zeros, so a padded state's h stays 0 and
// adds nothing to y (the pattern of K5's and K8's padded head dims).
//
// Widths: both kernels take any even C and every operand at its true C and
// N, with no padded copy: the rows of x, do and dx load and store at the true
// C (LayerNorm statistics over C), the forward's bf16 kernel and the
// backward stage their weight slices through shared memory with the tails
// past C, C/2, R and R + 2N zeroed, and the forward's general kernel (fp32,
// and bf16 past the bf16 kernel's tiles) reads its weights at their true
// widths in FMA loops.
#pragma once

#include "common.cuh"

namespace lcbi {

constexpr int kMambaMaxN = 16;    // the largest d_state the kernels take
constexpr int kMambaMaxV = 64;

// The padded state count that holds N: 8 (MambaVisionMixer's d_state) or 16.
__host__ __device__ __forceinline__ int mamba_padded_state(int N) { return N <= 8 ? 8 : 16; }

// The shapes both kernels take (besides the shared-memory fit of the forward).
inline bool mamba_shape_ok(int BW, int V, int C, int R, int N) {
  return BW > 0 && V >= 16 && V <= kMambaMaxV && V % 8 == 0 && C % 2 == 0 && C > 0 && R >= 1 &&
         R <= 64 && N >= 1 && N <= kMambaMaxN;
}

__device__ __forceinline__ float softplusf(float v) { return v > 20.f ? v : log1pf(expf(v)); }
__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// v rounded to T and back (the products' operand rounding)
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

}  // namespace lcbi
