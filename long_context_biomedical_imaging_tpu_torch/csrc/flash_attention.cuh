// Shared device code of the flash attention kernels (K5): flash_attention.cu
// (forward), flash_attention_dq.cu and flash_attention_dkv.cu (backward).
//
// Non-causal softmax attention of one (batch x head) slice, q, k, v: (L, D),
// in the base-2 form of the TPU kernel (long_context_biomedical_imaging_tpu/
// ops/flash_attention.py), with scale2 = scale * log2(e):
//     qs = round_T(q * scale2);  s = qs k^T  (fp32);  s[:, j >= L] = -1e30
//     p = exp2(s - m);  l = rowsum(p);  o = round_T(p) v / l;  lse = m + log2(l)
// and its backward from the saved (o, lse), with delta = rowsum(do * o):
//     p = exp2(qs k^T - lse);  dp = do v^T;  ds = p (dp - delta)
//     dq = round_T(ds) k * scale;  dk = round_T(ds)^T q * scale;  dv = round_T(p)^T do
// T is the stream type (bf16 under AMP, fp32 in the tests). Every product
// takes operands in T and sums in fp32. l == 0 is guarded as the TPU kernel
// guards it (l taken as 1).
//
// Head dims: the kernels take any true D as a runtime argument. Up to 256, a
// padded head dim DP in {16, 32, 64, 128, 256} (the least that holds D) is a
// template argument and sets the tiles. Columns [D, DP) load as zeros, so
// they add nothing to q k^T, and the output columns past D are never stored.
// Above 256 the wide variant below walks D in chunks of 64 columns.
//
// Two variants up to D = 256, one per stream type:
//
// bf16, designed for Hopper (the vit16k path). The products run on the
// tensor cores through mma.sync.m16n8k16 with operands fed from registers
// (ldmatrix, .trans for a row-major B); the score tile, the probabilities,
// the online-softmax statistics and the fp32 accumulators stay in registers
// as mma fragments; tiles of the walked axis come through a two-stage ring of
// cp.async 16-byte copies, so the next tile's copy overlaps this tile's
// products. Shared-memory rows are padded by 16 bytes (DP + 8 elements), so
// the eight 16-byte rows an ldmatrix phase reads fall in distinct banks.
//
// fp32: full-fp32 FMA loops on the CUDA cores (no TF32), every tile in
// shared memory (common.cuh gemm). It is the card's path for fp32 tensors,
// which only the tests and the correctness checks send, and is not
// redesigned; FlashDims below sets its tiles.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace lcbi {

constexpr float kFlashNegInf = -1e30f;  // NEG_INF of the TPU kernel
constexpr int kFlashMaxPadded = 256;    // the largest padded head dim DP

// The shapes every K5 kernel takes.
inline bool flash_shape_ok(int BH, int L, int D) {
  return BH > 0 && BH < 65536 && L > 0 && D >= 1;
}

// The least padded head dim that holds D.
inline int flash_padded_dim(int D) {
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

// Bytes of a (rows, ld) tile of U, a multiple of 128.
template <typename U> __host__ __device__ constexpr size_t tile_bytes(int rows, int ld) {
  return (rows * ld * sizeof(U) + 127) & ~size_t(127);
}

// Carves consecutive tiles out of the block's dynamic shared memory.
struct SmemCursor {
  unsigned char* p;
  template <typename U> __device__ U* take(size_t bytes) {
    U* out = reinterpret_cast<U*>(p);
    p += bytes;
    return out;
  }
};

// ---------------------------------------------------------------------------
// fp32 variant: every tile in shared memory
// ---------------------------------------------------------------------------

// Tile geometry of the fp32 kernels at padded head dim DP, with tiles of
// kTile rows (a multiple of 8, the fp32 gemm's row block).
template <int DP, int TILE> struct FlashDims {
  static constexpr int kD = DP;
  static constexpr int kTile = TILE;
  static constexpr int kLdT = DP + 8;              // (kTile, DP) tiles: q, k, v, do
  static constexpr int kLdP = kTile + 8;           // (kTile, kTile) tiles: p, ds
  static constexpr int kLdS = kTile + 4;           // (kTile, kTile) fp32: scores, dp
  static constexpr int kLdA = DP + 4;              // (kTile, DP) fp32 accumulators
  static_assert(kTile % 8 == 0, "the fp32 gemm's row block");
};

// Rows [r0, r0 + kTile) of a row-major (L, D) matrix into a (kTile, kLdT)
// tile; rows at or past L and columns at or past D are zero. With kScaled
// each element is multiplied by scale (the TPU kernel's q * scale2).
template <typename F, bool kScaled>
__device__ void load_rows(const float* __restrict__ src, int r0, int L, int D, float* dst,
                          float scale) {
  for (int i = threadIdx.x; i < F::kTile * F::kD; i += kThreads) {
    const int r = i / F::kD, c = i % F::kD;
    float v = 0.f;
    if (r0 + r < L && c < D) {
      v = src[(size_t)(r0 + r) * D + c];
      if (kScaled) v *= scale;
    }
    dst[r * F::kLdT + c] = v;
  }
}

// kTile values of a per-row fp32 vector from row r0 (zero at or past L).
template <typename F>
__device__ void load_vec(const float* __restrict__ src, int r0, int L, float* dst) {
  for (int r = threadIdx.x; r < F::kTile; r += kThreads) dst[r] = r0 + r < L ? src[r0 + r] : 0.f;
}

// Zero a (kTile, kLdA) fp32 accumulator.
template <typename F> __device__ void zero_acc(float* t) {
  for (int i = threadIdx.x; i < F::kTile * F::kLdA; i += kThreads) t[i] = 0.f;
}

// Rows [r0, r0 + kTile) and columns [0, D) of a (kTile, kLdA) accumulator
// times mul into the row-major (L, D) dst; rows at or past L are not written.
template <typename F>
__device__ void store_rows(const float* t, float mul, int r0, int L, int D,
                           float* __restrict__ dst) {
  for (int i = threadIdx.x; i < F::kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (r0 + r < L) dst[(size_t)(r0 + r) * D + c] = t[r * F::kLdA + c] * mul;
  }
}

// The backward's probabilities and score gradients of one (query tile, key
// tile) pair, from s = qs k^T and dp = do v^T (both (kTile, kLdS) fp32,
// queries on rows): p = exp2(s - lse) and ds = p (dp - delta), zero where the
// query (row) or the key (column) lies at or past L, into pt and dst
// ((kTile, kLdP), queries on rows). lse and delta are the query tile's.
template <typename F>
__device__ void probs_and_dscores(const float* s, const float* dp, const float* lse,
                                  const float* delta, int q0, int k0, int L, float* pt,
                                  float* dst) {
  for (int i = threadIdx.x; i < F::kTile * F::kTile; i += kThreads) {
    const int r = i / F::kTile, c = i % F::kTile;
    const bool live = q0 + r < L && k0 + c < L;
    const float p = live ? exp2f(s[r * F::kLdS + c] - lse[r]) : 0.f;
    if (pt != nullptr) pt[r * F::kLdP + c] = p;
    dst[r * F::kLdP + c] = p * (dp[r * F::kLdS + c] - delta[r]);
  }
}

// ---------------------------------------------------------------------------
// bf16 variant: tensor-core fragments in registers
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives matrix i with lane l
// holding row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 (with .trans, the
// transpose: rows 2 (l % 4), 2 (l % 4) + 1 of column l / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, col-major).
// Fragments (g = lane / 4, t = lane % 4): a[0] rows g, cols 2t..2t+1; a[1]
// row g + 8; a[2] row g, cols 2t + 8..; a[3] row g + 8, cols 2t + 8..; b0
// rows (k) 2t..2t+1 of column g, b1 rows 2t + 8..; c[0..1] row g, cols
// 2t..2t+1, c[2..3] row g + 8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest even into a bf16 pair, lo in the low half
// (the element of the lower column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A bf16 pair times s in fp32, rounded back to bf16 (round_T(q * scale2)).
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float s) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  const float2 f = __bfloat1622float2(h);
  return pack_bf16(f.x * s, f.y * s);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + ROWS) of a row-major (L, D) bf16 matrix into a (ROWS, DP + 8)
// shared tile; rows at or past L and columns at or past D are zero. With vec
// (D % 8 == 0, so every 16-byte chunk lies wholly inside or past a row and
// starts 16-byte aligned) the copies are cp.async and complete at the
// caller's wait; otherwise plain loads and stores. nthreads threads share it.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* __restrict__ src, int r0,
                                               int L, int D, bool vec, int nthreads) {
  constexpr int kLd = DP + 8, kChunks = DP / 8;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += nthreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    bf16* d = dst + r * kLd + c;
    const bool row_live = r0 + r < L;
    if (vec) {
      const bool live = row_live && c < D;
      const bf16* s = live ? src + (size_t)(r0 + r) * D + c : src;
      cp_async16(smem_addr(d), s, live ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float lo = 0.f, hi = 0.f;
        if (row_live && c + 2 * i < D) lo = __bfloat162float(src[(size_t)(r0 + r) * D + c + 2 * i]);
        if (row_live && c + 2 * i + 1 < D)
          hi = __bfloat162float(src[(size_t)(r0 + r) * D + c + 2 * i + 1]);
        w[i] = pack_bf16(lo, hi);  // exact: bf16 values round to themselves
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The same rows, each element multiplied by scale in fp32 and rounded to bf16
// (the TPU kernel's q * scale2 cast to k's dtype); plain loads.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile_scaled_bf16(bf16* dst, const bf16* __restrict__ src,
                                                      int r0, int L, int D, bool vec,
                                                      float scale, int nthreads) {
  constexpr int kLd = DP + 8, kChunks = DP / 8;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += nthreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool row_live = r0 + r < L;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (vec) {
      if (row_live && c < D) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
        w[0] = scale_bf16x2(raw.x, scale);
        w[1] = scale_bf16x2(raw.y, scale);
        w[2] = scale_bf16x2(raw.z, scale);
        w[3] = scale_bf16x2(raw.w, scale);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float lo = 0.f, hi = 0.f;
        if (row_live && c + 2 * i < D)
          lo = __bfloat162float(src[(size_t)(r0 + r) * D + c + 2 * i]) * scale;
        if (row_live && c + 2 * i + 1 < D)
          hi = __bfloat162float(src[(size_t)(r0 + r) * D + c + 2 * i + 1]) * scale;
        w[i] = pack_bf16(lo, hi);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Rows [0, ROWS) and columns [0, D) of a staged (ROWS, DP + 8) bf16 tile to
// rows [r0, r0 + ROWS) of the row-major (L, D) dst, 16 bytes at a time where
// D % 8 == 0; rows at or past L are not written. Threads [t0, t0 + n) share it.
template <int DP, int ROWS>
__device__ __forceinline__ void store_tile_bf16(bf16* __restrict__ dst, const bf16* src, int r0,
                                                int L, int D, bool vec, int t, int n) {
  constexpr int kLd = DP + 8, kChunks = DP / 8;
  for (int e = t; e < ROWS * kChunks; e += n) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    if (r0 + r >= L || c >= D) continue;
    const bf16* s = src + r * kLd + c;
    bf16* d = dst + (size_t)(r0 + r) * D + c;
    if (vec) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int i = 0; i < 8 && c + i < D; ++i) d[i] = s[i];
    }
  }
}

// A fragments (16 x 16) of rows [row0, row0 + 16) and columns [col0, col0 +
// 16) of a row-major shared tile with leading dimension ld (elements).
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile, int ld, int row0,
                                       int col0, int lane) {
  ldsm_x4(a, smem_addr(tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8));
}

// B fragments of two 8-column tiles for B = X^T, X row-major in shared memory
// with the n axis on its rows: rows [n0, n0 + 16), columns (the k axis)
// [k0, k0 + 16). b[0], b[1] serve columns n0..n0+7 of B, b[2], b[3] n0+8..
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[4], const bf16* tile, int ld, int n0,
                                            int k0, int lane) {
  ldsm_x4(b, smem_addr(tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                       ((lane >> 3) & 1) * 8));
}

// B fragments of two 8-column tiles for B = X, X row-major in shared memory
// with the k axis on its rows: rows (k) [k0, k0 + 16), columns (n) [n0, n0 +
// 16), transposed by ldmatrix. b[0], b[1] serve n0..n0+7, b[2], b[3] n0+8..
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[4], const bf16* tile, int ld, int k0,
                                            int n0, int lane) {
  ldsm_x4_trans(b, smem_addr(tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                             (lane >> 4) * 8));
}

// The A fragment of a 16 x 16 bf16 operand from two 16 x 8 fp32 accumulator
// fragments (columns 0-7 and 8-15), rounded to bf16 in registers.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// ---------------------------------------------------------------------------
// Wide head dims (D > 256), both stream types
// ---------------------------------------------------------------------------
//
// No padded head dim holds the whole of D, so the kernels walk D in chunks of
// kWideChunk columns: a score (q k^T, and in the backward do v^T) is the sum
// of its chunks' products, taken in chunk order into one fp32 tile; an output
// (o, dq, dk, dv) is written a chunk of columns at a time, by its own block
// (grid axis z), which recomputes the scores. That costs D / 64 times the
// score products for the output columns a block writes, and keeps the
// per-block state (tiles of kWideTile rows, one column chunk of each operand,
// fp32 scores and accumulator) within shared memory at any D; the design is
// the fp32 variant's (shared-memory tiles, common.cuh gemm: WMMA for bf16)
// and rounds where the other variants round. No model of the repo reaches it
// (ROADMAP.md: the ViT widths with D > 256 are custom ones).

constexpr int kWideChunk = 64;              // columns of D per chunk
constexpr int kWideTile = 64;               // query or key rows per tile
constexpr int kWideLdT = kWideChunk + 8;    // (kWideTile, kWideChunk) tiles in T, and p, ds
constexpr int kWideLdF = kWideChunk + 4;    // fp32 (kWideTile, kWideChunk) scores, accumulators
static_assert(kWideChunk == kWideTile, "p and ds tiles share the operand tiles' layout");

__host__ __device__ inline int wide_chunks(int D) { return (D + kWideChunk - 1) / kWideChunk; }

// Rows [r0, r0 + kWideTile) and columns [c0, c0 + kWideChunk) of a row-major
// (L, D) matrix into dst (ld kWideLdT); zero at or past L and D. With kScaled
// each element is multiplied by scale in fp32 and rounded to T (the TPU
// kernel's q * scale2 cast to k's dtype).
template <typename T, bool kScaled>
__device__ void load_wide(T* dst, const T* __restrict__ src, int r0, int L, int c0, int D,
                          float scale) {
  for (int e = threadIdx.x; e < kWideTile * kWideChunk; e += kThreads) {
    const int r = e / kWideChunk, c = e % kWideChunk;
    float v = 0.f;
    if (r0 + r < L && c0 + c < D) {
      v = to_f32(src[(size_t)(r0 + r) * D + c0 + c]);
      if (kScaled) v *= scale;
    }
    dst[r * kWideLdT + c] = from_f32<T>(v);
  }
}

// kWideTile values of a per-row fp32 vector from row r0 (zero at or past L).
__device__ __forceinline__ void load_wide_vec(const float* __restrict__ src, int r0, int L,
                                              float* dst) {
  for (int r = threadIdx.x; r < kWideTile; r += kThreads) dst[r] = r0 + r < L ? src[r0 + r] : 0.f;
}

// Columns [c0, c0 + kWideChunk) of rows [r0, r0 + kWideTile) of the row-major
// (L, D) dst from an fp32 (kWideTile, kWideLdF) tile times mul (row r divided
// by div[r] if div is given); nothing at or past L or D.
template <typename T>
__device__ void store_wide(T* __restrict__ dst, const float* acc, float mul,
                           const float* div, int r0, int L, int c0, int D) {
  for (int e = threadIdx.x; e < kWideTile * kWideChunk; e += kThreads) {
    const int r = e / kWideChunk, c = e % kWideChunk;
    if (r0 + r >= L || c0 + c >= D) continue;
    float v = acc[r * kWideLdF + c] * mul;
    if (div != nullptr) v /= div[r];
    dst[(size_t)(r0 + r) * D + c0 + c] = from_f32<T>(v);
  }
}

// Sets the dynamic shared memory a kernel may use; the launchers call it
// before every launch (cheap; no state to keep).
template <typename K> inline cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace lcbi
