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
// takes operands in T and sums in fp32: on the tensor cores through WMMA for
// bf16, as fp32 FMA loops for fp32 (common.cuh gemm; no TF32).
//
// Tiles: a block owns kTile rows (queries in the forward and dq kernels, keys
// in the dkv kernel) and walks the other axis in tiles of kTile inside the
// block, which takes the place of the TPU kernel's sequential grid axis. The
// head dim D is a template argument (32, 64 or 128: every ViT preset and the
// usual custom widths); the tile edge is 64 rows up to D = 64 and 32 at D =
// 128, where dkv's tiles of 64 rows would outgrow shared memory. Every (kTile,
// D) tile of T lives in shared memory with a leading dimension of D + 8, every
// (kTile, kTile) tile of T with kTile + 8, every fp32 tile with its width + 4
// (WMMA's alignment; see common.cuh). Rows at or past L load as zeros and are
// never stored; keys at or past L score -1e30 before the softmax, so a
// zero-padded key never enters it.
#pragma once

#include "common.cuh"

namespace lcbi {

constexpr float kFlashNegInf = -1e30f;  // NEG_INF of the TPU kernel

// Tile geometry of the kernels for head dim D.
template <int D> struct FlashDims {
  static constexpr int kD = D;
  // rows of a block's tile and of each tile it walks
  static constexpr int kTile = D <= 64 ? 64 : 32;
  static constexpr int kLdT = D + 8;               // (kTile, D) tiles of T: q, k, v, do
  static constexpr int kLdP = kTile + 8;           // (kTile, kTile) tiles of T: p, ds
  static constexpr int kLdS = kTile + 4;           // (kTile, kTile) fp32: scores, dp
  static constexpr int kLdA = D + 4;               // (kTile, D) fp32 accumulators
  static_assert(kTile % 32 == 0 && D % 16 == 0, "WMMA tiles and the softmax's warp rows");
};

// The shapes every K5 kernel takes.
inline bool flash_shape_ok(int BH, int L, int D) {
  return BH > 0 && BH < 65536 && L > 0 && (D == 32 || D == 64 || D == 128);
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

// Rows [r0, r0 + kTile) of a row-major (L, D) matrix into a (kTile, kLdT)
// tile of T; rows at or past L are zero. With kScaled each element is
// multiplied by scale in fp32 and rounded to T (the TPU kernel's q * scale2,
// cast to k's dtype).
template <typename F, typename T, bool kScaled>
__device__ void load_rows(const T* __restrict__ src, int r0, int L, T* dst, float scale) {
  for (int i = threadIdx.x; i < F::kTile * F::kD; i += kThreads) {
    const int r = i / F::kD, c = i % F::kD;
    T v = from_f32<T>(0.f);
    if (r0 + r < L) {
      v = src[(size_t)(r0 + r) * F::kD + c];
      if (kScaled) v = from_f32<T>(to_f32(v) * scale);
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

// Rows [r0, r0 + kTile) of a (kTile, kLdA) fp32 accumulator times mul,
// rounded to T, into the row-major (L, D) dst; rows at or past L are not
// written.
template <typename F, typename T>
__device__ void store_rows(const float* t, float mul, int r0, int L, T* __restrict__ dst) {
  for (int i = threadIdx.x; i < F::kTile * F::kD; i += kThreads) {
    const int r = i / F::kD, c = i % F::kD;
    if (r0 + r < L) dst[(size_t)(r0 + r) * F::kD + c] = from_f32<T>(t[r * F::kLdA + c] * mul);
  }
}

// The backward's probabilities and score gradients of one (query tile, key
// tile) pair, from s = qs k^T and dp = do v^T (both (kTile, kLdS) fp32,
// queries on rows): p = exp2(s - lse) and ds = p (dp - delta), zero where the
// query (row) or the key (column) lies at or past L, rounded to T into pt and
// dst ((kTile, kLdP), queries on rows). lse and delta are the query tile's.
template <typename F, typename T>
__device__ void probs_and_dscores(const float* s, const float* dp, const float* lse,
                                  const float* delta, int q0, int k0, int L, T* pt, T* dst) {
  for (int i = threadIdx.x; i < F::kTile * F::kTile; i += kThreads) {
    const int r = i / F::kTile, c = i % F::kTile;
    const bool live = q0 + r < L && k0 + c < L;
    const float p = live ? exp2f(s[r * F::kLdS + c] - lse[r]) : 0.f;
    if (pt != nullptr) pt[r * F::kLdP + c] = from_f32<T>(p);
    dst[r * F::kLdP + c] = from_f32<T>(p * (dp[r * F::kLdS + c] - delta[r]));
  }
}

}  // namespace lcbi
