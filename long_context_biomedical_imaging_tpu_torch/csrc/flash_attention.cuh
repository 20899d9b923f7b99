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
// Tiles: a block owns 64 rows (queries in the forward and dq kernels, keys in
// the dkv kernel) and walks the other axis in tiles of 64 inside the block,
// which takes the place of the TPU kernel's sequential grid axis. Every tile
// of T lives in shared memory with a leading dimension of D + 8, every fp32
// tile with 64 + 4 (WMMA's alignment; see common.cuh). Rows at or past L load
// as zeros and are never stored; keys at or past L score -1e30 before the
// softmax, so a zero-padded key never enters it.
#pragma once

#include "common.cuh"

namespace lcbi {

constexpr int kFlashTile = 64;   // rows of a block's tile and of each tile it walks
constexpr int kFlashD = 64;      // the head dim the kernels take (both ViT presets)
constexpr int kLdT = kFlashD + 8;
constexpr int kLdF = kFlashTile + 4;
constexpr float kFlashNegInf = -1e30f;  // NEG_INF of the TPU kernel

static_assert(kFlashD == kFlashTile, "the fp32 tiles share one leading dimension");

// The shapes every K5 kernel takes.
inline bool flash_shape_ok(int BH, int L, int D) {
  return BH > 0 && BH < 65536 && L > 0 && D == kFlashD;
}

// Bytes of a (64, kLdT) tile of T and of a (64, kLdF) fp32 tile, each a
// multiple of 128.
template <typename T> __host__ __device__ constexpr size_t tile_bytes_t() {
  return (kFlashTile * kLdT * sizeof(T) + 127) & ~size_t(127);
}
__host__ __device__ constexpr size_t tile_bytes_f() {
  return (kFlashTile * kLdF * 4 + 127) & ~size_t(127);
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

// Rows [r0, r0 + 64) of a row-major (L, D) matrix into a (64, kLdT) tile of
// T; rows at or past L are zero. With kScaled each element is multiplied by
// scale in fp32 and rounded to T (the TPU kernel's q * scale2, cast to k's
// dtype).
template <typename T, bool kScaled>
__device__ void load_rows(const T* __restrict__ src, int r0, int L, T* dst, float scale) {
  for (int i = threadIdx.x; i < kFlashTile * kFlashD; i += kThreads) {
    const int r = i / kFlashD, c = i % kFlashD;
    T v = from_f32<T>(0.f);
    if (r0 + r < L) {
      v = src[(size_t)(r0 + r) * kFlashD + c];
      if (kScaled) v = from_f32<T>(to_f32(v) * scale);
    }
    dst[r * kLdT + c] = v;
  }
}

// 64 values of a per-row fp32 vector from row r0 (zero at or past L).
__device__ inline void load_vec(const float* __restrict__ src, int r0, int L, float* dst) {
  for (int r = threadIdx.x; r < kFlashTile; r += kThreads) dst[r] = r0 + r < L ? src[r0 + r] : 0.f;
}

__device__ inline void zero_f(float* t) {
  for (int i = threadIdx.x; i < kFlashTile * kLdF; i += kThreads) t[i] = 0.f;
}

// Rows [r0, r0 + 64) of a (64, kLdF) fp32 tile times mul, rounded to T, into
// the row-major (L, D) dst; rows at or past L are not written.
template <typename T>
__device__ void store_rows(const float* t, float mul, int r0, int L, T* __restrict__ dst) {
  for (int i = threadIdx.x; i < kFlashTile * kFlashD; i += kThreads) {
    const int r = i / kFlashD, c = i % kFlashD;
    if (r0 + r < L) dst[(size_t)(r0 + r) * kFlashD + c] = from_f32<T>(t[r * kLdF + c] * mul);
  }
}

// The backward's probabilities and score gradients of one (query tile, key
// tile) pair, from s = qs k^T and dp = do v^T (both (64, kLdF) fp32, queries
// on rows): p = exp2(s - lse) and ds = p (dp - delta), zero where the query
// (row) or the key (column) lies at or past L, rounded to T into pt and dst
// ((64, kLdT), queries on rows). lse and delta are the query tile's.
template <typename T>
__device__ void probs_and_dscores(const float* s, const float* dp, const float* lse,
                                  const float* delta, int q0, int k0, int L, T* pt, T* dst) {
  for (int i = threadIdx.x; i < kFlashTile * kFlashTile; i += kThreads) {
    const int r = i / kFlashTile, c = i % kFlashTile;
    const bool live = q0 + r < L && k0 + c < L;
    const float p = live ? exp2f(s[r * kLdF + c] - lse[r]) : 0.f;
    if (pt != nullptr) pt[r * kLdT + c] = from_f32<T>(p);
    dst[r * kLdT + c] = from_f32<T>(p * (dp[r * kLdF + c] - delta[r]));
  }
}

}  // namespace lcbi
