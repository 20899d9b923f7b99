// Long-sequence selective scan (K7), shared device code of its three kernels
// (selective_scan_long.cu, selective_scan_long_carry_bwd.cu,
// selective_scan_long_bwd.cu); the windowed scan K9 (selective_scan_window.cu,
// selective_scan_window_bwd.cu) shares its step, softplus, sigmoid and warp
// sum. Per batch row of u, delta (b, L, D) and B, C (b, L, N), all fp32,
// with A^T = at (N, D) and delta before softplus:
//     d_t = softplus(delta_t);  h_t = exp(d_t A) h_{t-1} + d_t u_t B_t;  y_t = C_t . h_t
// The sequence is cut into segments of kScanSeg tokens; segment s of batch
// row i is row i * nseg + s, and its carries (a state per row) are (rows, N,
// D) fp32, element (row, n, d) at (row * N + n) * D + d. The last segment of a
// batch row may be short (L % kScanSeg != 0): its steps past L do not exist.
//
// The design is the simple one: one thread per (row, channel) with its N = 8
// states in registers; a block of at most kScanMaxGroup threads covers a group
// of channels of one row and stages the row's B and C (kScanSeg x N values)
// once in shared memory. exp(d A) is computed as exp2(d A log2 e) and softplus
// as max(v, 0) + log1p(exp(-|v|)), JAX's logaddexp(v, 0).
#pragma once

#include "common.cuh"

namespace lcbi {

constexpr int kScanSeg = 64;        // tokens per segment row (the TPU kernel's SEG)
constexpr int kScanN = 8;           // states per channel (MambaVisionMixer's d_state)
constexpr int kScanMaxGroup = 128;  // channels (threads) of a block at most
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float scan_softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}
__device__ __forceinline__ float scan_sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Geometry of a call: the channels split into `groups` groups of at most
// `threads` (a multiple of 32, at most kScanMaxGroup) channels.
struct ScanGeom {
  int b, L, D, nseg, rows, groups, threads;
};

inline bool scan_geom(int b, int L, int D, int N, ScanGeom* g) {
  if (b < 1 || L < 1 || D < 1 || N != kScanN) return false;
  if ((long long)b * L * (D > N ? D : N) >= (1LL << 31)) return false;
  g->b = b;
  g->L = L;
  g->D = D;
  g->nseg = (L + kScanSeg - 1) / kScanSeg;
  g->rows = b * g->nseg;
  g->groups = (D + kScanMaxGroup - 1) / kScanMaxGroup;
  g->threads = ((D + g->groups - 1) / g->groups + 31) / 32 * 32;
  return true;
}

// Row `row`'s segment: its first token's index in the flattened (b * L)
// tokens and its length.
struct ScanRow {
  size_t tok0;
  int len;
};

__device__ __forceinline__ ScanRow scan_row(const ScanGeom& g, int row) {
  const int t0 = (row % g.nseg) * kScanSeg;
  return {(size_t)(row / g.nseg) * g.L + t0, min(kScanSeg, g.L - t0)};
}

// Stage the row's (len, N) values of x (B or C) in s (kScanSeg x N).
__device__ __forceinline__ void stage_row(float* s, const float* __restrict__ x, ScanRow r) {
  for (int i = threadIdx.x; i < r.len * kScanN; i += blockDim.x) s[i] = x[r.tok0 * kScanN + i];
}

// h <- exp(dt A) h + dt u B over the N states (a2 = A log2 e).
__device__ __forceinline__ void scan_step(float* h, const float* a2, float dt, float du,
                                          const float* Bt) {
#pragma unroll
  for (int n = 0; n < kScanN; ++n) h[n] = fmaf(exp2f(dt * a2[n]), h[n], du * Bt[n]);
}

// Sum of each of the 16 values v over the warp's 32 lanes: after it, v[0] of
// lanes 2k and 2k + 1 holds the sum of value k. Each level swaps half of the
// values still held with the partner lane, in a fixed order.
__device__ __forceinline__ void warp_sum16(float* v, int lane) {
#pragma unroll
  for (int half = 8, bit = 16; half >= 1; half /= 2, bit /= 2) {
    const bool up = lane & bit;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
    }
  }
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
}

}  // namespace lcbi
