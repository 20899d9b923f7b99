// The weight gradients of K8 (window_attention_wgrad.cu, from the K8
// backward's streams) and K1's backward (hyena_window_bwd.cu, from its y, v2
// and dz streams): over N rows,
//     out[:3C^2] = A^T B  (C, 3C),   out[3C^2:] = O^T Dout  (C, C),
// A, O, Dout: (N, C) and B: (N, 3C) in T; fp32 sums and results. They are
// two products of one split-K grid of mma_gemm.cuh (the kernel that K2's and
// K4's backwards run too: mma.sync fragments fed by a cp.async ring in bf16),
// the S partials summed in a fixed order: no atomics, two launches give the
// same bits.
#pragma once

#include "mma_gemm.cuh"

namespace lcbi {

template <typename T>
int launch_wgrad(const void* x, const void* dqkv, const void* o, const void* dout,
                 float* partials, float* out, long long N, int C, int S, cudaStream_t stream) {
  Products<T> ps{};
  ps.count = 2;
  ps.p[0] = Product<T>{static_cast<const T*>(x), static_cast<const T*>(dqkv), C, 3 * C, C,
                       3 * C, 0};
  ps.p[1] = Product<T>{static_cast<const T*>(o), static_cast<const T*>(dout), C, C, C, C,
                       (size_t)3 * C * C};
  return launch_split_k<T>(ps, N, S, (size_t)4 * C * C, partials, out, stream);
}

// Splits of the row axis for the two products at C (mma_gemm.cuh
// wgrad_splits_for). 0 on a device query error.
inline int wgrad_splits(long long N, int C) {
  const long long tiles =
      (long long)ceil_div(C, kMmaTile) * (ceil_div(3 * C, kMmaTile) + ceil_div(C, kMmaTile));
  return wgrad_splits_for(N, tiles);
}

}  // namespace lcbi
