// The split-K weight-gradient kernel shared by K8 (window_attention_wgrad.cu,
// from the K8 backward's streams) and K1's backward (hyena_window_bwd.cu, from
// its y, v2 and dz streams): over N rows,
//     out[:3C^2] = A^T B  (C, 3C),   out[3C^2:] = O^T Dout  (C, C),
// A, O, Dout: (N, C) and B: (N, 3C) in T; fp32 sums and results.
//
// What bounds it on the H100: 8 N C^2 operations against (6 N C + 4 C^2 S)
// bytes, so operations from C = 96 on (ptx stage 0: 0.2 GFLOP per MB). A
// block per (64 x 64 output tile, split s) walks its split's share of the N
// rows in 128-row chunks staged in shared memory (16-byte loads where C is a
// multiple of 16 bytes' worth of T) and adds each chunk's product
// (WMMA, fp32 sums) to a 64 x 64 fp32 tile; it writes the tile as its
// partial, and reduce_slots_kernel sums the S partials in a fixed order. No
// atomics: two launches give the same bits. Both products run in one grid;
// blocks of one split go out together, so the rows they share meet in L2.
#pragma once

#include "common.cuh"

namespace lcbi {

constexpr int kWgTile = 64;
constexpr int kWgChunk = 128;
constexpr int kWgLd = kWgTile + 8;       // staged chunks (T)
constexpr int kWgLdAcc = kWgTile + 4;    // fp32 tile

struct WgLayout {
  size_t off_b, off_acc, bytes;
};

__host__ __device__ inline WgLayout wg_layout(int elem) {
  WgLayout L;
  L.off_b = align128((size_t)kWgChunk * kWgLd * elem);
  L.off_acc = L.off_b + align128((size_t)kWgChunk * kWgLd * elem);
  L.bytes = L.off_acc + align128((size_t)kWgTile * kWgLdAcc * 4);
  return L;
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Output tiles of the two products: dWqkv's cdiv(C, 64) x cdiv(3C, 64)
// first, then dWout's cdiv(C, 64) x cdiv(C, 64).
__host__ __device__ __forceinline__ int wg_tiles(int C) {
  return cdiv(C, kWgTile) * (cdiv(3 * C, kWgTile) + cdiv(C, kWgTile));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dqkv,
                              const T* __restrict__ o, const T* __restrict__ dout,
                              float* __restrict__ partials, long long N, int C, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WgLayout L = wg_layout(sizeof(T));
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + L.off_b);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);

  const int mt = cdiv(C, kWgTile), first = mt * cdiv(3 * C, kWgTile);
  int t = blockIdx.x;
  const bool qkv = t < first;
  if (!qkv) t -= first;
  const int ncols = qkv ? 3 * C : C;
  const int ntn = cdiv(ncols, kWgTile);
  const int m0 = (t / ntn) * kWgTile, n0 = (t % ntn) * kWgTile;
  const T* A = qkv ? x : o;
  const T* B = qkv ? dqkv : dout;
  const int s = blockIdx.y;
  const long long r_begin = N * s / S, r_end = N * (s + 1) / S;
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = C % kVec == 0;

  bool started = false;
  for (long long r0 = r_begin; r0 < r_end; r0 += kWgChunk) {
    const int rows = (int)min((long long)kWgChunk, r_end - r0);
    const int kt = round_up16(rows);
    if (vec) {
      // 16-byte loads, kVec columns a thread (C, 3C and the tile origins are
      // multiples of kVec, so a vector lies wholly inside or past the width)
      for (int e = threadIdx.x; e < kt * (kWgTile / kVec); e += kThreads) {
        const int row = e / (kWgTile / kVec), j = (e % (kWgTile / kVec)) * kVec;
        uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
        if (row < rows) {
          const size_t at = (size_t)(r0 + row);
          if (m0 + j < C) a = *reinterpret_cast<const uint4*>(A + at * C + m0 + j);
          if (n0 + j < ncols) b = *reinterpret_cast<const uint4*>(B + at * ncols + n0 + j);
        }
        *reinterpret_cast<uint4*>(As + row * kWgLd + j) = a;
        *reinterpret_cast<uint4*>(Bs + row * kWgLd + j) = b;
      }
    } else {
      for (int e = threadIdx.x; e < kt * kWgTile; e += kThreads) {
        const int row = e / kWgTile, j = e % kWgTile;
        T a = from_f32<T>(0.f), b = from_f32<T>(0.f);
        if (row < rows) {
          const size_t at = (size_t)(r0 + row);
          if (m0 + j < C) a = A[at * C + m0 + j];
          if (n0 + j < ncols) b = B[at * ncols + n0 + j];
        }
        As[row * kWgLd + j] = a;
        Bs[row * kWgLd + j] = b;
      }
    }
    __syncthreads();
    // acc[i][j] += sum_k As[k][i] Bs[k][j]
    gemm<true, false>(acc, kWgLdAcc, As, kWgLd, Bs, kWgLd, kWgTile, kWgTile, kt, started);
    __syncthreads();
    started = true;
  }
  const size_t total = (size_t)4 * C * C;
  float* out = partials + (size_t)s * total + (qkv ? 0 : (size_t)3 * C * C);
  for (int e = threadIdx.x; e < kWgTile * kWgTile; e += kThreads) {
    const int i = e / kWgTile, j = e % kWgTile;
    if (m0 + i < C && n0 + j < ncols)
      out[(size_t)(m0 + i) * ncols + n0 + j] = started ? acc[i * kWgLdAcc + j] : 0.f;
  }
}

template <typename T>
int launch_wgrad(const void* x, const void* dqkv, const void* o, const void* dout,
                 float* partials, float* out, long long N, int C, int S, cudaStream_t stream) {
  const size_t bytes = wg_layout(sizeof(T)).bytes;
  if (bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_attention_wgrad_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  window_attention_wgrad_kernel<T><<<dim3((unsigned)wg_tiles(C), (unsigned)S), kThreads, bytes,
                                     stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dqkv), static_cast<const T*>(o),
      static_cast<const T*>(dout), partials, N, C, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partials, S, (size_t)4 * C * C, out, stream);
}

// Splits of the row axis: enough blocks for four per SM over the output
// tiles, each split at least 512 rows. 0 on a device query error.
inline int wgrad_splits(long long N, int C) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  const long long tiles = wg_tiles(C);
  long long s = (4LL * sms + tiles - 1) / tiles;
  if (s > N / 512) s = N / 512;
  if (s > 65535) s = 65535;
  return (int)(s < 1 ? 1 : s);
}

}  // namespace lcbi
