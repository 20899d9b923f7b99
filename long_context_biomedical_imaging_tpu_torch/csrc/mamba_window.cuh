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
// States: the kernels run on a padded state count NP (8 or 16, a template
// argument) that holds the true N: a padded state has A = 0, B = 0 and C =
// 0, so its h stays 0 and it adds nothing to y (the pattern of K5's and K8's
// padded head dims). The forward takes its state blocks padded with zeros by
// the wrapper, as it takes its channels; the backward takes the true N at
// run time, reads the padded states as zeros and never stores their
// gradients.
//
// Widths: the forward takes any even C. Its tiles and weights run on Cp = C
// rounded up to 32 (Dhp = Cp / 2 per half): the rows of x, do and dx load
// and store at the true C (LayerNorm statistics over C, zeros in columns
// [C, Cp)), and the weights and per-channel operands arrive with each Dh
// block padded with zeros to Dhp (the wrapper pads the weights, never the
// activations), so a padded channel's x and z are SiLU(0) = 0, its scan state
// stays 0 and it adds nothing to out_proj. Inside the forward C names the
// padded width and Ct the true one. The backward takes the weights at the
// true C (mamba_window_bwd.cu).
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

// u = conv3_same(xz) per window (zero outside it), s = SiLU(u), for windows
// [0, nwin) of V rows and channels [0, C); taps (3, C), tap j on row t-1+j.
// s may alias xz: each thread walks one column and has read rows t and t+1
// before it writes row t.
__device__ inline void conv3_silu(const float* xz, int ldx, float* s, int lds,
                                  const float* __restrict__ wconv, int nwin, int V, int C) {
  for (int p = threadIdx.x; p < nwin * C; p += kThreads) {
    const int w = p / C, c = p % C;
    const float w0 = wconv[c], w1 = wconv[C + c], w2 = wconv[2 * C + c];
    const float* xr = xz + (size_t)w * V * ldx + c;
    float* sr = s + (size_t)w * V * lds + c;
    float prev = 0.f, cur = xr[0];
    for (int t = 0; t < V; ++t) {
      const float next = t + 1 < V ? xr[(size_t)(t + 1) * ldx] : 0.f;
      const float u = cur * w1 + prev * w0 + next * w2;
      sr[(size_t)t * lds] = u * sigmoidf(u);
      prev = cur;
      cur = next;
    }
  }
}

// dbl[r, j] = sum_k rnd(s[r, k]) wdbl[k, j] for rows [0, rows), j < W: the
// x_proj product, as FMA loops (W is 22 to 40 columns, too narrow to tile).
template <typename T>
__device__ inline void x_proj(const float* s, int lds, const T* __restrict__ wdbl, float* dbl,
                              int ldd, int rows, int Dh, int W) {
  for (int p = threadIdx.x; p < rows * W; p += kThreads) {
    const int r = p / W, j = p % W;
    const float* sr = s + (size_t)r * lds;
    float a = 0.f;
    for (int k = 0; k < Dh; ++k) a = fmaf(rnd<T>(sr[k]), to_f32(wdbl[(size_t)k * W + j]), a);
    dbl[(size_t)r * ldd + j] = a;
  }
}

// dtv of channel d at one token: dt (the first R columns of its dbl row)
// rounded to T, times wdt[:, d], plus dtb2[d].
template <typename T>
__device__ __forceinline__ float dt_value(const float* db, const T* __restrict__ wdt, int R,
                                          int Dh, int d, float bias) {
  float a = 0.f;
  for (int r = 0; r < R; ++r) a = fmaf(rnd<T>(db[r]), to_f32(wdt[(size_t)r * Dh + d]), a);
  return a + bias;
}

}  // namespace lcbi
