// Row passes shared by the K2 and K4 backwards (fused_mlp_bwd.cu,
// mamba_window_bwd.cu): the pre-LayerNorm's rows as a stream, and the
// LayerNorm backward with the residual.
//
//   ln_rows_kernel:  y = LN(x) in T, the folded LayerNorm's output (the left
//                    operand of the in_proj weight gradient).
//   ln_bwd_kernel:   given dy (N, C) fp32, the gradient of the LN'd rows,
//                    dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) + do,
//                    dxhat = dy g, with the statistics recomputed from x as the
//                    forward computes them (layernorm_rows); without the LN,
//                    dx = dy. Column sums d ln_g = sum dy xhat, d ln_b = sum dy
//                    and (optionally) d b_out = sum do.
//
// What bounds them: bytes (x, do, dx in T and dy in fp32, each read or
// written once; a row's second walk hits L1). A row takes LPR lanes (8 up to
// C = 128, else 32), so that a warp walks 32 / LPR rows at once and a row's
// sums need log2(LPR) shuffle steps; the kernel is persistent: block b of G
// walks rows [N b / G, N (b + 1) / G), each row group of a warp its own rows
// in order, summing its columns into its own fp32 rows of shared memory; at
// the end the block sums its groups in order and writes its slot once, and
// reduce_slots_kernel sums the G slots in a fixed order. No atomics.
#pragma once

#include "common.cuh"

namespace lcbi {

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
               T* __restrict__ y, long long N, int C) {
  for (long long r0 = (long long)blockIdx.x * kWarps; r0 < N; r0 += (long long)gridDim.x * kWarps) {
    const int rows = (int)min((long long)kWarps, N - r0);
    layernorm_rows(x + (size_t)r0 * C, rows, rows, C, g, b, 1, y + (size_t)r0 * C, C);
  }
}

// Slot offsets (floats) of the column sums; -1 where not wanted.
struct LnSlots {
  int dg, dbln, dsum;
};

template <int LPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int LPR>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const float* __restrict__ dy, const T* __restrict__ x, const T* __restrict__ dout,
              const float* __restrict__ ln_g, T* __restrict__ dx, float* __restrict__ slots,
              size_t P, LnSlots off, long long N, int C, int has_ln) {
  constexpr int kGroups = kThreads / LPR;        // rows walked at once by the block
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);   // (kGroups, 3, C)
  const int grp = threadIdx.x / LPR, lane = threadIdx.x % LPR;
  float* mine = acc + (size_t)grp * 3 * C;
  for (int i = lane; i < 3 * C; i += LPR) mine[i] = 0.f;
  const long long r_begin = N * blockIdx.x / gridDim.x, r_end = N * (blockIdx.x + 1) / gridDim.x;
  const float inv = 1.f / (float)C;
  // every lane of a warp runs the same number of iterations (the shuffles
  // take the whole warp): a row group past the end reads row 0 and stores
  // nothing
  const long long span = (r_end - r_begin + kGroups - 1) / kGroups * kGroups;
  for (long long i = grp; i < span; i += kGroups) {
    const long long r = r_begin + i;
    const bool live = r < r_end;
    if (!live && !has_ln) continue;
    const size_t rr = live ? (size_t)r : 0;
    const float* dyr = dy + rr * C;
    const T* xr = x + rr * C;
    const T* dor = dout + rr * C;
    T* dxr = dx + rr * C;
    if (!has_ln) {
      for (int c = lane; c < C; c += LPR) {
        dxr[c] = from_f32<T>(dyr[c]);
        mine[2 * C + c] += to_f32(dor[c]);
      }
      continue;
    }
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < C; c += LPR) {
      const float v = to_f32(xr[c]);
      s += v;
      ss += v * v;
    }
    s = group_sum<LPR>(s);
    ss = group_sum<LPR>(ss);
    const float mu = s * inv;
    const float rstd = rsqrtf(ss * inv - mu * mu + kLnEps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += LPR) {
      const float xhat = (to_f32(xr[c]) - mu) * rstd;
      const float dxh = dyr[c] * ln_g[c];
      s1 += dxh;
      s2 += dxh * xhat;
    }
    s1 = group_sum<LPR>(s1);
    s2 = group_sum<LPR>(s2);
    if (!live) continue;
    const float m1 = s1 * inv, m2 = s2 * inv;
    for (int c = lane; c < C; c += LPR) {
      const float xhat = (to_f32(xr[c]) - mu) * rstd;
      const float d = dyr[c], dov = to_f32(dor[c]);
      const float dxh = d * ln_g[c];
      dxr[c] = from_f32<T>(rstd * (dxh - m1 - xhat * m2) + dov);
      mine[c] += d * xhat;
      mine[C + c] += d;
      mine[2 * C + c] += dov;
    }
  }
  __syncthreads();
  float* slot = slots + (size_t)blockIdx.x * P;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float a[3] = {0.f, 0.f, 0.f};
    for (int w = 0; w < kGroups; ++w)
#pragma unroll
      for (int k = 0; k < 3; ++k) a[k] += acc[((size_t)w * 3 + k) * C + c];
    if (off.dg >= 0) slot[off.dg + c] = a[0];
    if (off.dbln >= 0) slot[off.dbln + c] = a[1];
    if (off.dsum >= 0) slot[off.dsum + c] = a[2];
  }
}

template <typename T>
int launch_ln_rows(const void* x, const void* g, const void* b, void* y, long long N, int C,
                   cudaStream_t stream) {
  long long blocks = (N + kWarps - 1) / kWarps;
  if (blocks > 65535) blocks = 65535;
  ln_rows_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<T*>(y), N, C);
  return (int)cudaGetLastError();
}

// The LayerNorm backward over N rows on G blocks (G slots of P floats).
template <typename T>
int launch_ln_bwd(const float* dy, const void* x, const void* dout, const void* ln_g, void* dx,
                  float* slots, size_t P, LnSlots off, int G, long long N, int C, int has_ln,
                  cudaStream_t stream) {
  const bool narrow = C <= 128;
  const size_t bytes = (size_t)(kThreads / (narrow ? 8 : 32)) * 3 * C * sizeof(float);
  if (bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  auto kernel = narrow ? ln_bwd_kernel<T, 8> : ln_bwd_kernel<T, 32>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<G, kThreads, bytes, stream>>>(
      dy, static_cast<const T*>(x), static_cast<const T*>(dout), static_cast<const float*>(ln_g),
      static_cast<T*>(dx), slots, P, off, N, C, has_ln);
  return (int)cudaGetLastError();
}

}  // namespace lcbi
