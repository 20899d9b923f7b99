// Shared device code of the Swin window-attention kernels K8
// (window_attention.cu, window_attention_bwd.cu). Two paths:
//
// The whole-window path, for V = 16, 32, 48 or 64 tokens (2D windows 4x4 to
// 8x8) at a head dim D of 16, 32 or 64 and C % 16 == 0, in bf16: passes over
// streams, the projections written to device memory, then a core kernel in
// which one warp owns a (head, window) (window_attention_whole.cuh; the
// forward's in window_attention.cu, the backward's in
// window_attention_bwd.cu). fp32 at those shapes takes the general path.
//
// The general path, for every other V up to 512 (3D windows, shrunk and
// ragged windows), every other head dim and fp32: one block cannot hold a
// window's every head, so the projections run as tiled matrix products
// (proj_gemm_kernel, in bf16 window_attention_mma.cuh proj_rows_kernel)
// that write q, k, v to device memory once, rounded to T where the TPU
// kernel rounds them; the attention then runs per (window, head, tile of
// query rows). In bf16 up to D = 128 it runs on the register-resident
// mma.sync kernels of window_attention_mma.cuh (designed for Hopper); in
// fp32, and in bf16 above D = 128, on the shared-memory kernels below: full
// score rows per query tile (window_attention_rows_kernel), so the softmax
// normalises each row before it rounds p, as the TPU kernel does, and a
// key-tile kernel for dk, dv and drel (window_attention_bwd.cu).
//
// Head dims: the true D = C / H is any value from 1 up. The shared-memory
// kernels take a chunk width KD in {16, 32, 64} (the least that holds D, or
// 64; 32 in fp32) as a template argument and walk D in chunks of KD
// columns: scores are summed over the chunks, outputs written a chunk at a
// time; a chunk past D loads zeros (they add nothing to q k^T) and stores
// only its D columns.
//
// The shared-memory kernels' products run on the tensor cores (WMMA
// 16x16x16, fp32 sums) for bf16 and as fp32 FMA loops for fp32 (common.cuh).
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace lcbi {

constexpr float kLog2e = 1.4426950408889634f;

// Leading dimensions of the tiles at padded head dim KD.
template <int KD> struct HeadDims {
  static constexpr int kLdT = KD + 8;       // q, k, v, do tiles (T)
  static constexpr int kLdG = KD + 4;       // a head's fp32 (rows x KD) product
};
// Shapes the kernels take: V in [1, 512], H heads of any D = C / H.
constexpr int kMaxTokens = 512;
__host__ __forceinline__ bool attn_shape_ok(int BW, int V, int C, int H) {
  return BW > 0 && V >= 1 && V <= kMaxTokens && H > 0 && C > 0 && C % H == 0;
}


// Shapes the whole-window path takes in bf16; every other shape, and fp32,
// takes the general path. A warp of its core holds a window's tiles of one
// head, 16 query rows at a time, read by 16-byte copies: V % 16 == 0 up to
// 64, C % 16 == 0 (every head's row 16-byte aligned) and D one of the
// fragment widths 16, 32, 64.
__host__ __forceinline__ bool whole_window_path(int V, int C, int H) {
  const int D = C / H;
  return V >= 16 && V <= 64 && V % 16 == 0 && C % 16 == 0 && (D == 16 || D == 32 || D == 64);
}

// The chunk width of the shared-memory kernels at head dim D: the least of
// 16, 32 and 64 that holds D, else 64 (D walked in chunks); in fp32 at most
// 32, so that a 512-token window's score rows and chunks fit.
__host__ __forceinline__ int padded_head_dim(int D, bool fp32) {
  return D <= 16 ? 16 : D <= 32 || fp32 ? 32 : 64;
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

// dst[r * ldd + c] = src[r * lds + c] for r < rows, c < width, and zero for
// rows <= r < n or width <= c < wpad (wpad a multiple of 16 / sizeof(T)); in
// 16-byte vectors where width and lds are multiples of 16 / sizeof(T) and src
// is 16-byte aligned (a uniform test: the whole block takes one branch),
// element by element otherwise.
template <typename T>
__device__ __forceinline__ void load_rows16(T* dst, int ldd, const T* __restrict__ src,
                                            size_t lds, int rows, int n, int width, int wpad) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = wpad / kVec;
  const bool vec = width % kVec == 0 && lds % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  for (int e = threadIdx.x; e < n * per_row; e += kThreads) {
    const int r = e / per_row, c = (e % per_row) * kVec;
    T* d = dst + (size_t)r * ldd + c;
    if (vec) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c < width) v = *reinterpret_cast<const uint4*>(src + (size_t)r * lds + c);
      *reinterpret_cast<uint4*>(d) = v;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        d[i] = r < rows && c + i < width ? src[(size_t)r * lds + c + i] : from_f32<T>(0.f);
    }
  }
}

// The general path's projections in fp32 (bf16: window_attention_mma.cuh
// proj_rows_kernel, the same function and rounding).
// out = epilogue(A @ B) over M x N: A (M x K, row-major, ld lda) in T; B (K x
// N, row-major, ld ldb) or, with B_COL, the transpose of a row-major (N x K)
// matrix. The epilogue adds bias[n] (if given) in fp32; a column n < nscale
// is stored as T(v * scale) and, with dup >= 0, also as T(v) at column dup +
// n; every other column as T(v). Any M, N, K: the staged tiles are zero past
// them. A block per 64 x 64 output tile walks K in steps of 32 staged in
// shared memory.

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
  const int rows_a = (int)min((long long)kProjTile, (long long)M - m0);
  for (int k0 = 0; k0 < K; k0 += kProjK) {
    const int kw = min(kProjK, K - k0);
    load_rows16(As, kLdA, A + (size_t)m0 * lda + k0, lda, rows_a, kProjTile, kw, kProjK);
    if (B_COL) {
      load_rows16(Bs, kLdB, B + (size_t)n0 * ldb + k0, ldb, min(kProjTile, N - n0), kProjTile,
                  kw, kProjK);
    } else {
      load_rows16(Bs, kLdB, B + (size_t)k0 * ldb + n0, ldb, kw, kProjK, min(kProjTile, N - n0),
                  kProjTile);
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

template <int KD>
__host__ __device__ inline RowLayout row_layout(int V, int elem, bool bwd) {
  constexpr int kLdT = HeadDims<KD>::kLdT, kLdG = HeadDims<KD>::kLdG;
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
// (ld ld, the head's columns from col) into shared memory (ld KD + 8);
// columns [D, KD) and rows [rows, n) are zeroed.
template <int KD, typename T>
__device__ __forceinline__ void load_head_rows(T* dst, const T* __restrict__ src, size_t ld,
                                               int col, int D, int rows, int n) {
  load_rows16(dst, HeadDims<KD>::kLdT, src + col, ld, rows, n, D, KD);
}

// The shared-memory attention of the general path (fp32; bf16 above D =
// 128), per item (window w, head h, query tile qt) of R = RowTile<BWD>::rows
// rows: qkv holds q scale log2(e) at column h D, k at C + h D and v at 2C + h
// D of each token row (ld ldq), in T. Sweep 1 stages q (and, backward, do)
// a chunk of KD columns of D at a time, and for each k (and v) in chunks of
// kKeyChunk keys, summing the full score rows S = q k^T (and dP = do v^T)
// over the chunks of D; then one warp per row takes s = S + rel[h]
// log2(e) + (region ids differ ? mask2 : 0), p = exp2(s - max) / sum, and
// writes p in T over S; backward, also delta = sum_j p dp and ds = p (dp -
// delta) in T over dP, and keeps (max, sum, delta) in stats. Sweep 2 stages
// v (and k) again, a chunk of D at a time: o = p v, written in T at column h
// D of o (ld C); backward, dq = ds k scale, written in T at column h D of
// dqkv (ld 3C).
// Keys past V are zero rows and get p = 0; rows past the window are zero
// rows, never stored. The backward also sums dq (fp32) over its rows into
// the block's slot at [0, C) and, for h = 0, the rows of dout at [C, 2C).
// Blocks walk contiguous ranges of the BW H ceil(V / R) items. Head h's
// columns are [h D, (h + 1) D) of each C-wide block; tiles are KD wide.
template <typename T, bool BWD, int KD>
__global__ void __launch_bounds__(kThreads)
window_attention_rows_kernel(const T* __restrict__ qkv, int ldq, const float* __restrict__ rel,
                             const int* __restrict__ rid, const T* __restrict__ dO,
                             const T* __restrict__ dout, T* __restrict__ o, T* __restrict__ dqkv,
                             float* __restrict__ stats, float* __restrict__ slots, int BW, int V,
                             int C, int H, int nW, float scale, float mask2) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kRows = RowTile<BWD>::rows;
  constexpr int kLdT = HeadDims<KD>::kLdT, kLdG = HeadDims<KD>::kLdG;
  const int D = C / H, nch = (D + KD - 1) / KD;
  const RowLayout L = row_layout<KD>(V, sizeof(T), BWD);
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
    // S (and dP) summed over the chunks of D
    for (int c = 0; c < nch; ++c) {
      const int dc = h * D + c * KD, dw = min(KD, D - c * KD);
      load_head_rows<KD>(Q, qrow + (size_t)i0 * ldq, ldq, dc, dw, rows, kRows);
      if (BWD) load_head_rows<KD>(DOt, dO + (row0 + i0) * C, C, dc, dw, rows, kRows);
      for (int j0 = 0; j0 < Vp; j0 += kKeyChunk) {
        const int kw = min(kKeyChunk, Vp - j0), keys = min(kKeyChunk, V - j0);
        load_head_rows<KD>(Kc, qrow + (size_t)j0 * ldq, ldq, C + dc, dw, keys, kw);
        if (BWD) load_head_rows<KD>(Vc, qrow + (size_t)j0 * ldq, ldq, 2 * C + dc, dw, keys, kw);
        __syncthreads();
        gemm<false, true>(S + j0, L.lds, Q, kLdT, Kc, kLdT, kRows, kw, KD, c > 0);
        if (BWD) gemm<false, true>(DP + j0, L.lds, DOt, kLdT, Vc, kLdT, kRows, kw, KD, c > 0);
        __syncthreads();
      }
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

    // o = p v (and dq = ds k) a chunk of D at a time
    for (int c = 0; c < nch; ++c) {
      const int dc = h * D + c * KD, dw = min(KD, D - c * KD);
      for (int j0 = 0; j0 < Vp; j0 += kKeyChunk) {
        const int kw = min(kKeyChunk, Vp - j0), keys = min(kKeyChunk, V - j0);
        load_head_rows<KD>(Vc, qrow + (size_t)j0 * ldq, ldq, 2 * C + dc, dw, keys, kw);
        if (BWD) load_head_rows<KD>(Kc, qrow + (size_t)j0 * ldq, ldq, C + dc, dw, keys, kw);
        __syncthreads();
        gemm<false, false>(OA, kLdG, P + j0, L.ldp, Vc, kLdT, kRows, KD, kw, j0 > 0);
        if (BWD) gemm<false, false>(DQA, kLdG, DS + j0, L.ldp, Kc, kLdT, kRows, KD, kw, j0 > 0);
        __syncthreads();
      }
      for (int e = threadIdx.x; e < rows * dw; e += kThreads) {
        const int r = e / dw, d = e % dw;
        o[(row0 + i0 + r) * C + dc + d] = from_f32<T>(OA[r * kLdG + d]);
        if (BWD) dqkv[(row0 + i0 + r) * 3 * C + dc + d] = from_f32<T>(DQA[r * kLdG + d] * scale);
      }
      if (BWD) {
        for (int d = threadIdx.x; d < dw; d += kThreads) {
          float acc = 0.f;
          for (int r = 0; r < rows; ++r) acc += DQA[r * kLdG + d] * scale;
          slot[dc + d] += acc;
        }
      }
    }
    if (BWD) {
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
template <typename T, bool BWD, int KD>
int launch_rows(const void* qkv, int ldq, const float* rel, const int* rid, const void* dO,
                const void* dout, void* o, void* dqkv, float* stats, float* slots, int max_slots,
                int BW, int V, int C, int H, int nW, float scale, float mask2, int* blocks,
                cudaStream_t stream) {
  const size_t bytes = row_layout<KD>(V, sizeof(T), BWD).bytes;
  if (bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_attention_rows_kernel<T, BWD, KD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int kRows = RowTile<BWD>::rows;
  const long long items = (long long)BW * H * ((V + kRows - 1) / kRows);
  long long G = items;
  if (BWD)
    G = persistent_blocks(window_attention_rows_kernel<T, BWD, KD>, bytes, items, max_slots);
  if (G <= 0 || G > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *blocks = (int)G;
  window_attention_rows_kernel<T, BWD, KD><<<(unsigned)G, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), ldq, rel, rid, static_cast<const T*>(dO),
      static_cast<const T*>(dout), static_cast<T*>(o), static_cast<T*>(dqkv), stats, slots, BW,
      V, C, H, nW, scale, mask2);
  return (int)cudaGetLastError();
}

}  // namespace lcbi
