// Shared device code of the Swin window-attention kernels K8
// (window_attention.cu, window_attention_bwd.cu). Two paths:
//
// The whole-window path, for V = 16, 32, 48 or 64 tokens (2D windows 4x4 to
// 8x8): a block takes a tile of whole windows, 64 token rows (64 / V
// windows), and walks the heads one by one. Per head it projects its q, k,
// v columns (a C x 3D slice of Wqkv, D = 32) from the tile's token rows,
// read straight from global memory, into fp32 shared memory, adds the bias
// and rounds them to the stream type T; then scores, the base-2 softmax and
// the value products run per window on shared-memory tiles.
//
// The general path, for every other V up to 512 (3D windows, shrunk and
// ragged windows): one block cannot hold a window's every head, so the
// projections run as tiled matrix products (proj_gemm_kernel) that write q,
// k, v to device memory once, rounded to T where the TPU kernel rounds them;
// the attention then runs per (window, head, tile of query rows) on
// full score rows (window_attention_rows_kernel), so the softmax normalises
// each row before it rounds p, as the TPU kernel does.
//
// Products run on the tensor cores (WMMA 16x16x16, fp32 sums) for bf16 and
// as fp32 FMA loops for fp32 (common.cuh).
#pragma once

#include <math.h>

#include "common.cuh"

namespace lcbi {

constexpr int kHeadDim = 32;               // D, every Swin preset's head dim
constexpr int kTileRows = 64;              // token rows per tile
constexpr int kLdT = kHeadDim + 8;         // q, k, v, do tiles (T)
constexpr int kLdF = 3 * kHeadDim + 4;     // the head's fp32 q | k | v product
constexpr int kLdG = kHeadDim + 4;         // a head's fp32 (rows x D) product
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

// Shapes the kernels take: V in [1, 512], H heads of D = 32.
constexpr int kMaxTokens = 512;
__host__ __forceinline__ bool attn_shape_ok(int BW, int V, int C, int H) {
  return BW > 0 && V >= 1 && V <= kMaxTokens && H > 0 && C == H * kHeadDim;
}

// Windows the whole-window path takes; every other V takes the general path.
__host__ __forceinline__ bool whole_window_path(int V) {
  return V >= 16 && V <= kTileRows && V % 16 == 0;
}

// ---------------------------------------------------------------------------
// The general path
// ---------------------------------------------------------------------------

constexpr int kProjTile = 64;   // output tile of the projections
constexpr int kProjK = 32;      // depth staged per step
constexpr int kKeyChunk = 128;  // keys staged per step of the row kernel

// Query rows of a tile of the row kernel: the backward holds dP beside S.
template <bool BWD> struct RowTile { static constexpr int rows = BWD ? 32 : 64; };

struct ProjLayout {
  size_t off_b, off_acc, bytes;
};

// A: 64 x 32 (ld 40); B: 32 x 64 (ld 72) or its transpose 64 x 32 (ld 40),
// both within 64 x 40 elements; the fp32 tile 64 x 68.
__host__ __device__ inline ProjLayout proj_layout(int elem) {
  ProjLayout L;
  L.off_b = align128((size_t)kProjTile * (kProjK + 8) * elem);
  L.off_acc = L.off_b + align128((size_t)kProjTile * (kProjK + 8) * elem);
  L.bytes = L.off_acc + align128((size_t)kProjTile * (kProjTile + 4) * 4);
  return L;
}

// out = epilogue(A @ B) over M x N: A (M x K, row-major, ld lda) in T; B (K x
// N, row-major, ld ldb) or, with B_COL, the transpose of a row-major (N x K)
// matrix. The epilogue adds bias[n] (if given) in fp32; a column n < nscale
// is stored as T(v * scale) and, with dup >= 0, also as T(v) at column dup +
// n; every other column as T(v). K % 32 == 0. A block per 64 x 64 output
// tile walks K in steps of 32 staged in shared memory.
// dst[r * ldd + c] = src[r * lds + c] for r < rows, c < width, and zero for
// rows <= r < n, in 16-byte vectors: width a multiple of 16 / sizeof(T), every
// row start 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_rows16(T* dst, int ldd, const T* __restrict__ src,
                                            size_t lds, int rows, int n, int width) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = width / kVec;
  for (int e = threadIdx.x; e < n * per_row; e += kThreads) {
    const int r = e / per_row, c = (e % per_row) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) v = *reinterpret_cast<const uint4*>(src + (size_t)r * lds + c);
    *reinterpret_cast<uint4*>(dst + (size_t)r * ldd + c) = v;
  }
}

template <typename T, bool B_COL>
__global__ void __launch_bounds__(kThreads)
proj_gemm_kernel(const T* __restrict__ A, int lda, const T* __restrict__ B, int ldb,
                 const float* __restrict__ bias, T* __restrict__ out, int ldo, int M, int N,
                 int K, int nscale, float scale, int dup) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ProjLayout L = proj_layout(sizeof(T));
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + L.off_b);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);
  constexpr int kLdA = kProjK + 8, kLdB = B_COL ? kProjK + 8 : kProjTile + 8;
  constexpr int kLdC = kProjTile + 4;
  const long long m0 = (long long)blockIdx.x * kProjTile;
  const int n0 = blockIdx.y * kProjTile;
  constexpr int kVec = 16 / sizeof(T);
  const int rows_a = (int)min((long long)kProjTile, (long long)M - m0);
  for (int k0 = 0; k0 < K; k0 += kProjK) {
    load_rows16(As, kLdA, A + (size_t)m0 * lda + k0, lda, rows_a, kProjTile, kProjK);
    if (B_COL) {
      load_rows16(Bs, kLdB, B + (size_t)n0 * ldb + k0, ldb, min(kProjTile, N - n0), kProjTile,
                  kProjK);
    } else {
      // N is a multiple of 32: a vector lies wholly inside or past it
      for (int e = threadIdx.x; e < kProjK * (kProjTile / kVec); e += kThreads) {
        const int kk = e / (kProjTile / kVec), n = (e % (kProjTile / kVec)) * kVec;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + n < N) v = *reinterpret_cast<const uint4*>(B + (size_t)(k0 + kk) * ldb + n0 + n);
        *reinterpret_cast<uint4*>(Bs + kk * kLdB + n) = v;
      }
    }
    __syncthreads();
    gemm<false, B_COL>(acc, kLdC, As, kLdA, Bs, kLdB, kProjTile, kProjTile, kProjK, k0 > 0);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < kProjTile * kProjTile; e += kThreads) {
    const int r = e / kProjTile, n = n0 + e % kProjTile;
    if (m0 + r >= M || n >= N) continue;
    const float v = acc[r * kLdC + n - n0] + (bias != nullptr ? bias[n] : 0.f);
    T* orow = out + (size_t)(m0 + r) * ldo;
    if (n < nscale) {
      orow[n] = from_f32<T>(v * scale);
      if (dup >= 0) orow[dup + n] = from_f32<T>(v);
    } else {
      orow[n] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch_proj(const void* A, int lda, const void* B, int ldb, bool b_col, const float* bias,
                void* out, int ldo, int M, int N, int K, int nscale, float scale, int dup,
                cudaStream_t stream) {
  const size_t bytes = proj_layout(sizeof(T)).bytes;
  const dim3 grid((unsigned)((M + kProjTile - 1) / kProjTile),
                  (unsigned)((N + kProjTile - 1) / kProjTile));
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  T* o = static_cast<T*>(out);
  if (b_col)
    proj_gemm_kernel<T, true><<<grid, kThreads, bytes, stream>>>(a, lda, b, ldb, bias, o, ldo, M,
                                                                 N, K, nscale, scale, dup);
  else
    proj_gemm_kernel<T, false><<<grid, kThreads, bytes, stream>>>(a, lda, b, ldb, bias, o, ldo,
                                                                  M, N, K, nscale, scale, dup);
  return (int)cudaGetLastError();
}

// Shared memory of the row kernel at Vp = V rounded up to 16 for a tile of
// R query rows: the scores S (R x Vp fp32, ld Vp + 4), on whose rows the
// probabilities are written in T in place; in the backward also dP, where
// ds goes in place; a chunk of k and of v (kKeyChunk x D, T); the q tile
// and (backward) the do tile (R x D, T); the fp32 o and (backward) dq
// products (R x D).
struct RowLayout {
  int lds, ldp;
  size_t off_dp, off_k, off_v, off_q, off_do, off_o, off_dq, bytes;
};

__host__ __device__ inline RowLayout row_layout(int V, int elem, bool bwd) {
  const int kRows = bwd ? RowTile<true>::rows : RowTile<false>::rows;
  RowLayout L;
  L.lds = round_up16(V) + 4;
  L.ldp = L.lds * 4 / elem;
  const size_t s = align128((size_t)kRows * L.lds * 4);
  const size_t chunk = align128((size_t)kKeyChunk * kLdT * elem);
  const size_t tile = align128((size_t)kRows * kLdT * elem);
  const size_t f = align128((size_t)kRows * kLdG * 4);
  L.off_dp = s;
  L.off_k = L.off_dp + (bwd ? s : 0);
  L.off_v = L.off_k + chunk;
  L.off_q = L.off_v + chunk;
  L.off_do = L.off_q + tile;
  L.off_o = L.off_do + (bwd ? tile : 0);
  L.off_dq = L.off_o + f;
  L.bytes = L.off_dq + (bwd ? f : 0);
  return L;
}

// Rows [0, rows) of a (rows x D) tile of a head from a token-major stream
// (ld ld, the head's columns from col) into shared memory (ld kLdT); rows
// [rows, n) are zeroed.
template <typename T>
__device__ __forceinline__ void load_head_rows(T* dst, const T* __restrict__ src, size_t ld,
                                               int col, int rows, int n) {
  load_rows16(dst, kLdT, src + col, ld, rows, n, kHeadDim);
}

// The attention of the general path, per item (window w, head h, query tile
// qt) of R = RowTile<BWD>::rows rows: qkv holds q scale log2(e) at column h D, k at C + h D
// and v at 2C + h D of each token row (ld ldq), in T. Sweep 1 stages k (and,
// backward, v) in chunks of kKeyChunk keys and fills the full score rows S
// = q k^T (and dP = do v^T); then one warp per row takes s = S + rel[h]
// log2(e) + (region ids differ ? mask2 : 0), p = exp2(s - max) / sum, and
// writes p in T over S; backward, also delta = sum_j p dp and ds = p (dp -
// delta) in T over dP, and keeps (max, sum, delta) in stats. Sweep 2 stages
// v (and k) again: o = p v, written in T at column h D of o (ld C);
// backward, dq = ds k scale, written in T at column h D of dqkv (ld 3C).
// Keys past V are zero rows and get p = 0; rows past the window are zero
// rows, never stored. The backward also sums dq (fp32) over its rows into
// the block's slot at [0, C) and, for h = 0, the rows of dout at [C, 2C).
// Blocks walk contiguous ranges of the BW H ceil(V / R) items.
template <typename T, bool BWD>
__global__ void __launch_bounds__(kThreads)
window_attention_rows_kernel(const T* __restrict__ qkv, int ldq, const float* __restrict__ rel,
                             const int* __restrict__ rid, const T* __restrict__ dO,
                             const T* __restrict__ dout, T* __restrict__ o, T* __restrict__ dqkv,
                             float* __restrict__ stats, float* __restrict__ slots, int BW, int V,
                             int C, int H, int nW, float scale, float mask2) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kRows = RowTile<BWD>::rows;
  const RowLayout L = row_layout(V, sizeof(T), BWD);
  float* S = reinterpret_cast<float*>(smem);
  T* P = reinterpret_cast<T*>(smem);
  float* DP = reinterpret_cast<float*>(smem + L.off_dp);
  T* DS = reinterpret_cast<T*>(smem + L.off_dp);
  T* Kc = reinterpret_cast<T*>(smem + L.off_k);
  T* Vc = reinterpret_cast<T*>(smem + L.off_v);
  T* Q = reinterpret_cast<T*>(smem + L.off_q);
  T* DOt = reinterpret_cast<T*>(smem + L.off_do);
  float* OA = reinterpret_cast<float*>(smem + L.off_o);
  float* DQA = reinterpret_cast<float*>(smem + L.off_dq);
  const int Vp = round_up16(V);
  const int nqt = (V + kRows - 1) / kRows;
  const long long items = (long long)BW * H * nqt;
  const long long it_begin = items * blockIdx.x / gridDim.x;
  const long long it_end = items * (blockIdx.x + 1) / gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* slot = BWD ? slots + (size_t)blockIdx.x * 2 * C : nullptr;
  if (BWD) {
    for (int e = threadIdx.x; e < 2 * C; e += kThreads) slot[e] = 0.f;
  }

  for (long long item = it_begin; item < it_end; ++item) {
    const int qt = (int)(item % nqt);
    const int h = (int)((item / nqt) % H);
    const long long w = item / ((long long)nqt * H);
    const int i0 = qt * kRows, rows = min(kRows, V - i0);
    const size_t row0 = (size_t)w * V;
    const T* qrow = qkv + row0 * ldq;
    load_head_rows(Q, qrow + (size_t)i0 * ldq, ldq, h * kHeadDim, rows, kRows);
    if (BWD) load_head_rows(DOt, dO + (row0 + i0) * C, C, h * kHeadDim, rows, kRows);
    for (int j0 = 0; j0 < Vp; j0 += kKeyChunk) {
      const int kw = min(kKeyChunk, Vp - j0), keys = min(kKeyChunk, V - j0);
      load_head_rows(Kc, qrow + (size_t)j0 * ldq, ldq, C + h * kHeadDim, keys, kw);
      if (BWD) load_head_rows(Vc, qrow + (size_t)j0 * ldq, ldq, 2 * C + h * kHeadDim, keys, kw);
      __syncthreads();
      gemm<false, true>(S + j0, L.lds, Q, kLdT, Kc, kLdT, kRows, kw, kHeadDim, false);
      if (BWD) gemm<false, true>(DP + j0, L.lds, DOt, kLdT, Vc, kLdT, kRows, kw, kHeadDim, false);
      __syncthreads();
    }

    const int* rr = rid == nullptr ? nullptr : rid + (size_t)(w % nW) * V;
    for (int r = warp; r < kRows; r += kWarps) {
      float* srow = S + (size_t)r * L.lds;
      T* prow = P + (size_t)r * L.ldp;
      float* dprow = DP + (size_t)r * L.lds;
      T* dsrow = DS + (size_t)r * L.ldp;
      if (r >= rows) {
        for (int j = lane; j < Vp; j += 32) {
          prow[j] = from_f32<T>(0.f);
          if (BWD) dsrow[j] = from_f32<T>(0.f);
        }
        continue;
      }
      const int i = i0 + r;
      const float* relr = rel + ((size_t)h * V + i) * V;
      float s[kMaxTokens / 32], dp[kMaxTokens / 32];
      float m = -INFINITY;
#pragma unroll
      for (int u = 0; u < kMaxTokens / 32; ++u) {
        const int j = lane + 32 * u;
        s[u] = -INFINITY;
        if (j < V) {
          s[u] = srow[j] + relr[j] * kLog2e;
          if (rr != nullptr) s[u] += rr[i] != rr[j] ? mask2 : 0.f;
          m = fmaxf(m, s[u]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float l = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxTokens / 32; ++u) {
        s[u] = lane + 32 * u < V ? exp2f(s[u] - m) : 0.f;
        l += s[u];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
      float delta = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxTokens / 32; ++u) {
        const int j = lane + 32 * u;
        s[u] = s[u] / l;
        dp[u] = 0.f;
        if (BWD && j < V) {
          dp[u] = dprow[j];
          delta += dp[u] * s[u];
        }
      }
      if (BWD) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          delta += __shfl_xor_sync(0xffffffffu, delta, off);
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kMaxTokens / 32; ++u) {
        const int j = lane + 32 * u;
        if (j < Vp) {
          prow[j] = from_f32<T>(s[u]);
          if (BWD) dsrow[j] = from_f32<T>(s[u] * (dp[u] - delta));
        }
      }
      if (BWD && lane == 0) {
        const size_t at = ((size_t)w * H + h) * V + i;
        const size_t plane = (size_t)BW * H * V;
        stats[at] = m;
        stats[plane + at] = l;
        stats[2 * plane + at] = delta;
      }
    }
    __syncthreads();

    for (int j0 = 0; j0 < Vp; j0 += kKeyChunk) {
      const int kw = min(kKeyChunk, Vp - j0), keys = min(kKeyChunk, V - j0);
      load_head_rows(Vc, qrow + (size_t)j0 * ldq, ldq, 2 * C + h * kHeadDim, keys, kw);
      if (BWD) load_head_rows(Kc, qrow + (size_t)j0 * ldq, ldq, C + h * kHeadDim, keys, kw);
      __syncthreads();
      gemm<false, false>(OA, kLdG, P + j0, L.ldp, Vc, kLdT, kRows, kHeadDim, kw, j0 > 0);
      if (BWD) gemm<false, false>(DQA, kLdG, DS + j0, L.ldp, Kc, kLdT, kRows, kHeadDim, kw, j0 > 0);
      __syncthreads();
    }
    for (int e = threadIdx.x; e < rows * kHeadDim; e += kThreads) {
      const int r = e / kHeadDim, d = e % kHeadDim;
      o[(row0 + i0 + r) * C + h * kHeadDim + d] = from_f32<T>(OA[r * kLdG + d]);
      if (BWD)
        dqkv[(row0 + i0 + r) * 3 * C + h * kHeadDim + d] = from_f32<T>(DQA[r * kLdG + d] * scale);
    }
    if (BWD) {
      for (int d = threadIdx.x; d < kHeadDim; d += kThreads) {
        float acc = 0.f;
        for (int r = 0; r < rows; ++r) acc += DQA[r * kLdG + d] * scale;
        slot[h * kHeadDim + d] += acc;
      }
      if (h == 0) {
        for (int c = threadIdx.x; c < C; c += kThreads) {
          float acc = 0.f;
          for (int r = 0; r < rows; ++r) acc += to_f32(dout[(row0 + i0 + r) * C + c]);
          slot[C + c] += acc;
        }
      }
    }
    __syncthreads();
  }
}

// Blocks of the row kernel: one per item in the forward; in the backward a
// persistent grid of at most max_slots blocks, each with its own slot.
template <typename T, bool BWD>
int launch_rows(const void* qkv, int ldq, const float* rel, const int* rid, const void* dO,
                const void* dout, void* o, void* dqkv, float* stats, float* slots, int max_slots,
                int BW, int V, int C, int H, int nW, float scale, float mask2, int* blocks,
                cudaStream_t stream) {
  const size_t bytes = row_layout(V, sizeof(T), BWD).bytes;
  if (bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_attention_rows_kernel<T, BWD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int kRows = RowTile<BWD>::rows;
  const long long items = (long long)BW * H * ((V + kRows - 1) / kRows);
  long long G = items;
  if (BWD) G = persistent_blocks(window_attention_rows_kernel<T, BWD>, bytes, items, max_slots);
  if (G <= 0 || G > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *blocks = (int)G;
  window_attention_rows_kernel<T, BWD><<<(unsigned)G, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), ldq, rel, rid, static_cast<const T*>(dO),
      static_cast<const T*>(dout), static_cast<T*>(o), static_cast<T*>(dqkv), stats, slots, BW,
      V, C, H, nW, scale, mask2);
  return (int)cudaGetLastError();
}

}  // namespace lcbi
