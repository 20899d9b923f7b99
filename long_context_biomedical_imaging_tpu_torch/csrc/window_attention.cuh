// Shared device code of the Swin window-attention kernels K8
// (window_attention.cu, window_attention_bwd.cu).
//
// A block takes a tile of whole windows, 64 token rows (64 / V windows of V
// = 16, 32, 48 or 64 tokens), and walks the heads one by one. Per head it
// projects its q, k, v columns (a C x 3D slice of Wqkv, D = 32) from the
// tile's token rows, read straight from global memory, into fp32 shared
// memory, adds the bias and rounds them to the stream type T; then scores,
// the base-2 softmax and the value products run per window on shared-memory
// tiles. Products run on the tensor cores (WMMA 16x16x16, fp32 sums) for
// bf16 and as fp32 FMA loops for fp32 (common.cuh).
#pragma once

#include <math.h>

#include "common.cuh"

namespace lcbi {

constexpr int kHeadDim = 32;               // D, every Swin preset's head dim
constexpr int kTileRows = 64;              // token rows per tile
constexpr int kLdT = kHeadDim + 8;         // q, k, v, do tiles (T)
constexpr int kLdF = 3 * kHeadDim + 4;     // the head's fp32 q | k | v product
constexpr int kOutCols = 128;              // column chunk of the C-wide products
constexpr int kLdO = kOutCols + 4;         // its fp32 accumulator
constexpr float kLog2e = 1.4426950408889634f;

// Scores and probabilities of a window: fp32 (V x V, ld V + 4) and T (ld V + 8).
__host__ __device__ __forceinline__ int ld_scores(int V) { return V + 4; }
__host__ __device__ __forceinline__ int ld_probs(int V) { return V + 8; }

// C_b = A_b @ B_b for b in [0, nb): M x N outputs (fp32, ld ldc, batch stride
// sc) over depth K; A_b and B_b in T with leading dimensions lda, ldb and
// batch strides sa, sb, each row- or (with *_COL) column-major as in
// common.cuh gemm. bf16: one warp per 16x16 output tile, M, N, K multiples
// of 16.
template <bool A_COL, bool B_COL>
__device__ __forceinline__ void gemm_batched(int nb, float* Cp, int ldc, int sc,
                                             const __nv_bfloat16* A, int lda, int sa,
                                             const __nv_bfloat16* B, int ldb, int sb, int M,
                                             int N, int K) {
  using namespace nvcuda;
  using LA = typename WmmaLayout<A_COL>::type;
  using LB = typename WmmaLayout<B_COL>::type;
  const int warp = threadIdx.x / 32;
  const int tn = N / 16, per = (M / 16) * tn, tiles = nb * per;
  for (int t = warp; t < tiles; t += kWarps) {
    const int b = t / per, i = (t % per) / tn, j = t % tn;
    const __nv_bfloat16* Ab = A + (size_t)b * sa;
    const __nv_bfloat16* Bb = B + (size_t)b * sb;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> bf;
      const __nv_bfloat16* ap =
          A_COL ? Ab + (size_t)k * lda + i * 16 : Ab + (size_t)i * 16 * lda + k;
      const __nv_bfloat16* bp =
          B_COL ? Bb + (size_t)j * 16 * ldb + k : Bb + (size_t)k * ldb + j * 16;
      wmma::load_matrix_sync(a, ap, lda);
      wmma::load_matrix_sync(bf, bp, ldb);
      wmma::mma_sync(acc, a, bf, acc);
    }
    wmma::store_matrix_sync(Cp + (size_t)b * sc + (size_t)i * 16 * ldc + j * 16, acc, ldc,
                            wmma::mem_row_major);
  }
}

// fp32: each thread owns one output column of 8 consecutive rows of one
// batch entry; M is a multiple of 8.
template <bool A_COL, bool B_COL>
__device__ __forceinline__ void gemm_batched(int nb, float* Cp, int ldc, int sc, const float* A,
                                             int lda, int sa, const float* B, int ldb, int sb,
                                             int M, int N, int K) {
  constexpr int R = 8;
  const int per = (M / R) * N, tasks = nb * per;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int b = task / per, n = task % N, r0 = ((task % per) / N) * R;
    const float* Ab = A + (size_t)b * sa;
    const float* Bb = B + (size_t)b * sb;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float bv = B_COL ? Bb[(size_t)n * ldb + k] : Bb[(size_t)k * ldb + n];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float av = A_COL ? Ab[(size_t)k * lda + r0 + r] : Ab[(size_t)(r0 + r) * lda + k];
        acc[r] = fmaf(av, bv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) Cp[(size_t)b * sc + (size_t)(r0 + r) * ldc + n] = acc[r];
  }
}

// The head's q | k | v product of the tile's M token rows xr (global, ld C):
// F[:, 0:D] = xr @ Wqkv[:, hD:(h+1)D], F[:, D:2D] and F[:, 2D:3D] from the
// k and v column blocks at C + hD and 2C + hD. Ends with a barrier.
template <typename T>
__device__ __forceinline__ void project_head(float* F, const T* xr, const T* wqkv, int M, int C,
                                             int h) {
#pragma unroll
  for (int part = 0; part < 3; ++part)
    gemm<false, false>(F + part * kHeadDim, kLdF, xr, C, wqkv + part * C + h * kHeadDim, 3 * C, M,
                       kHeadDim, C, false);
  __syncthreads();
}

// Scores to probabilities, rows [0, M) of the tile, in base 2 as the TPU
// kernel: s = S + rel[h] log2(e) + (region ids differ ? mask2 : 0), where S
// holds (q scale log2(e)) k^T and mask2 = mask_value log2(e); p = exp2(s -
// max) / sum. p stays in S in fp32 and goes to P in T. Window w of the tile
// is window w0 + w of the call, whose region ids are rid[(w0 + w) % nW]
// (rid == nullptr: no mask). One warp per row.
template <typename T>
__device__ __forceinline__ void softmax_rows(float* S, int lds, T* P, int ldp, int M, int V,
                                             const float* __restrict__ rel_h,
                                             const int* __restrict__ rid, int nW, long long w0,
                                             float mask2) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < M; r += kWarps) {
    const int w = r / V, i = r % V;
    const int* rr = rid == nullptr ? nullptr : rid + (size_t)((w0 + w) % nW) * V;
    float s[2];
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      s[u] = -INFINITY;
      if (j < V) {
        s[u] = S[(size_t)r * lds + j] + rel_h[i * V + j] * kLog2e;
        if (rr != nullptr) s[u] += rr[i] != rr[j] ? mask2 : 0.f;
        m = fmaxf(m, s[u]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      s[u] = lane + 32 * u < V ? exp2f(s[u] - m) : 0.f;
      l += s[u];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      if (j < V) {
        const float p = s[u] / l;
        S[(size_t)r * lds + j] = p;
        P[(size_t)r * ldp + j] = from_f32<T>(p);
      }
    }
  }
}

// The tile of a block: windows [w0, w0 + nwin) of BW, token rows [row0,
// row0 + M) of the (BW * V, C) stream.
struct Tile {
  long long w0;
  size_t row0;
  int nwin, M;
};

__device__ __forceinline__ Tile tile_of(long long t, int BW, int V) {
  const int tw = kTileRows / V;
  Tile tl;
  tl.w0 = t * tw;
  tl.nwin = (int)min((long long)tw, (long long)BW - tl.w0);
  tl.M = tl.nwin * V;
  tl.row0 = (size_t)tl.w0 * V;
  return tl;
}

// Shapes the kernels take: V in {16, 32, 48, 64}, H heads of D = 32.
__host__ __forceinline__ bool attn_shape_ok(int BW, int V, int C, int H) {
  return BW > 0 && V >= 16 && V <= kTileRows && V % 16 == 0 && H > 0 && C == H * kHeadDim;
}

}  // namespace lcbi
