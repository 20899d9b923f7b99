// Shared device code of the fused block kernels (K1-K4 and K8's shared-memory
// paths, and every kernel library's error string).
//
// The fused block kernels keep one tile of token rows in shared memory for
// their whole chain: a pre-LayerNorm writes the normalised rows once, cast to
// the matmul type T; matrix products read those rows from shared memory and
// the weights from global memory (resident in L2) or from staged slices, and
// accumulate in fp32. T = __nv_bfloat16 runs the products of these helpers on
// the tensor cores through WMMA 16x16x16 fragments; T = float runs them as
// fp32 FMA loops, so that fp32 inputs keep full fp32 precision (no TF32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace lcbi {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as jnp.astype
}

__host__ __device__ __forceinline__ size_t align128(size_t bytes) {
  return (bytes + 127) & ~size_t(127);
}

__host__ __device__ __forceinline__ int round_up16(int v) { return (v + 15) & ~15; }
__host__ __device__ __forceinline__ int round_up32(int v) { return (v + 31) & ~31; }

// Rows [0, rows) of the (rows, C) tile x -> ys (leading dimension lds) in T:
// LayerNorm with fp32 statistics in the fast-variance form E[x^2] - mu^2,
// eps 1e-6, then the affine g, b (both fp32). With ln == 0 the rows are
// copied unchanged. Rows [rows, rows_pad) are zeroed: they are padding that
// the products carry but the epilogue never stores. Columns [C, cpad) are
// zeroed too (a kernel whose tiles are wider than the true C: the statistics
// still divide by C). One warp per row.
// With mu/rstd given, each normalised row's statistics are kept there too
// (the backward kernels need them for the LayerNorm backward).
template <typename T>
__device__ void layernorm_rows(const T* __restrict__ x, int rows, int rows_pad, int C,
                               const float* __restrict__ g, const float* __restrict__ b,
                               int ln, T* ys, int lds, float* mu_out = nullptr,
                               float* rstd_out = nullptr, int cpad = 0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows_pad; r += kWarps) {
    T* yrow = ys + (size_t)r * lds;
    for (int c = C + lane; c < cpad; c += 32) yrow[c] = from_f32<T>(0.f);
    if (r >= rows) {
      for (int c = lane; c < C; c += 32) yrow[c] = from_f32<T>(0.f);
      continue;
    }
    const T* xrow = x + (size_t)r * C;
    if (!ln) {
      for (int c = lane; c < C; c += 32) yrow[c] = xrow[c];
      continue;
    }
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = to_f32(xrow[c]);
      s += v;
      ss += v * v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float inv = 1.f / (float)C;
    const float mu = s * inv;
    const float rstd = rsqrtf(ss * inv - mu * mu + kLnEps);
    if (mu_out != nullptr && lane == 0) {
      mu_out[r] = mu;
      rstd_out[r] = rstd;
    }
    for (int c = lane; c < C; c += 32) {
      const float xhat = (to_f32(xrow[c]) - mu) * rstd;
      yrow[c] = from_f32<T>(xhat * g[c] + b[c]);
    }
  }
}

// C[M x N] (fp32, ld ldc) = (accumulate ? C : 0) + A[M x K] @ B[K x N], all
// operands in T. A is row-major (element (i, k) at A[i * lda + k]) or, with
// A_COL, column-major (at A[k * lda + i]), which reads the transpose of a
// row-major tile; likewise B (element (k, n) at B[k * ldb + n], or with B_COL
// at B[n * ldb + k]). Any operand may live in shared or global memory: the
// backward kernels accumulate weight gradients straight into their global
// slots. Products round nothing: the operands arrive in T and sums are fp32.
template <bool COL> struct WmmaLayout { using type = nvcuda::wmma::row_major; };
template <> struct WmmaLayout<true> { using type = nvcuda::wmma::col_major; };

// bf16: one warp per 16x16 output tile on WMMA fragments; M, N and K are
// multiples of 16, every tile pointer is 32-byte aligned (the callers pad
// their leading dimensions so), lda/ldb multiples of 8 and ldc of 4.
template <bool A_COL, bool B_COL>
__device__ __forceinline__ void gemm(float* Cp, int ldc, const __nv_bfloat16* A, int lda,
                                     const __nv_bfloat16* B, int ldb, int M, int N, int K,
                                     bool accumulate) {
  using namespace nvcuda;
  using LA = typename WmmaLayout<A_COL>::type;
  using LB = typename WmmaLayout<B_COL>::type;
  const int warp = threadIdx.x / 32;
  const int tn = N / 16, tiles = (M / 16) * tn;
  for (int t = warp; t < tiles; t += kWarps) {
    const int i = t / tn, j = t % tn;
    float* c = Cp + (size_t)i * 16 * ldc + j * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (accumulate) {
      wmma::load_matrix_sync(acc, c, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(acc, 0.f);
    }
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> bf;
      const __nv_bfloat16* ap = A_COL ? A + (size_t)k * lda + i * 16 : A + (size_t)i * 16 * lda + k;
      const __nv_bfloat16* bp = B_COL ? B + (size_t)j * 16 * ldb + k : B + (size_t)k * ldb + j * 16;
      wmma::load_matrix_sync(a, ap, lda);
      wmma::load_matrix_sync(bf, bp, ldb);
      wmma::mma_sync(acc, a, bf, acc);
    }
    wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
  }
}

// fp32: each thread owns one output column of 8 consecutive rows and walks K
// with FMAs. Lanes of a warp take neighbouring columns, so row-major B reads
// coalesce and A reads are broadcasts. M is a multiple of 8.
template <bool A_COL, bool B_COL>
__device__ __forceinline__ void gemm(float* Cp, int ldc, const float* A, int lda, const float* B,
                                     int ldb, int M, int N, int K, bool accumulate) {
  constexpr int R = 8;
  const int tasks = (M / R) * N;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int n = task % N, r0 = (task / N) * R;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = accumulate ? Cp[(size_t)(r0 + r) * ldc + n] : 0.f;
    for (int k = 0; k < K; ++k) {
      const float bv = B_COL ? B[(size_t)n * ldb + k] : B[(size_t)k * ldb + n];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float av = A_COL ? A[(size_t)k * lda + r0 + r] : A[(size_t)(r0 + r) * lda + k];
        acc[r] = fmaf(av, bv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) Cp[(size_t)(r0 + r) * ldc + n] = acc[r];
  }
}

// Largest dynamic shared memory a block of this device may opt in to.
inline int max_dynamic_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

// A backward kernel runs a persistent grid of G blocks; block g walks a
// contiguous range of row tiles and accumulates its weight gradients into its
// own fp32 slot, slots + g * P. This second kernel sums the first n floats of
// the G slots in a fixed order, so the result is the same from run to run.
// out: (n,) fp32.
__global__ void __launch_bounds__(kThreads)
reduce_slots_kernel(const float* __restrict__ slots, int G, size_t P, size_t n,
                    float* __restrict__ out) {
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (size_t)gridDim.x * kThreads) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += slots[(size_t)g * P + e];
    out[e] = s;
  }
}

// Number of slots (= blocks) a persistent backward grid runs: no more than its
// tiles, than the slots the caller allocated, or than fit on the device at
// once (so no block waits for a second wave). 0 on a device query error.
template <typename Kernel>
int persistent_blocks(Kernel kernel, size_t smem_bytes, long long tiles, int max_slots) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes) !=
      cudaSuccess)
    return 0;
  long long g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (g > tiles) g = tiles;
  if (g > max_slots) g = max_slots;
  return (int)g;
}

// Reduce the first n floats of the G slots of P floats into out on the
// stream; returns the launch's error code.
inline int launch_reduce(const float* slots, int G, size_t P, size_t n, float* out,
                         cudaStream_t stream) {
  size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  reduce_slots_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(slots, G, P, n, out);
  return (int)cudaGetLastError();
}

// Reduce the G slots of P floats, whole.
inline int launch_reduce(const float* slots, int G, size_t P, float* out, cudaStream_t stream) {
  return launch_reduce(slots, G, P, P, out, stream);
}

}  // namespace lcbi

// Message of a code returned by a kernel entry point (each kernel library
// compiles this file once and exports this symbol).
extern "C" const char* lcbi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
