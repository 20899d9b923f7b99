// Long-sequence selective scan (K7), shared device code of its four kernels
// (selective_scan_long.cu, selective_scan_long_carry_bwd.cu,
// selective_scan_long_bwd.cu, selective_scan_long_stitch.cu) and of the
// windowed scan K9 (selective_scan_window.cu, selective_scan_window_bwd.cu):
// K7's forward and carry backward and K9's forward stream their rows through
// selective_scan_long_stream.cuh, and both backwards share
// selective_scan_bwd.cuh. Per batch row of u, delta (b,
// L, D) and B, C (b, L, N), all fp32, with A^T = at (N, D):
//     d_t = softplus(delta_t) (or delta_t itself without softplus)
//     h_t = exp(d_t A) h_{t-1} + d_t u_t B_t;  y_t = C_t . h_t
// The sequence is cut into segments of kScanSeg tokens; segment s of batch
// row i is row i * nseg + s, and its carries (a state per row) are (rows, N,
// D) fp32, element (row, n, d) at (row * N + n) * D + d. The last segment of a
// batch row may be short (L % kScanSeg != 0): its steps past L do not exist.
//
// N is any d_state from 1 to kScanMaxState. The kernels are templates over a
// padded state count NP (8 or 16, scan_np): a thread keeps NP states in
// registers, and the states n >= N have A = 0 and B = C = 0, so that they stay
// zero and add nothing to any sum. exp(d A) is computed as exp2(d A log2 e)
// and softplus as max(v, 0) + log1p(exp(-|v|)), JAX's logaddexp(v, 0).
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace lcbi {

constexpr int kScanSeg = 64;        // tokens per segment row (the TPU kernel's SEG)
constexpr int kScanMaxState = 16;   // d_state at most
constexpr float kLog2e = 1.4426950408889634f;

// The padded state count of a call's kernels.
__host__ __device__ inline int scan_np(int N) { return N <= 8 ? 8 : 16; }

__device__ __forceinline__ float scan_softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}
__device__ __forceinline__ float scan_sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Geometry of a call: rows = b * nseg segment rows of at most kScanSeg tokens.
struct ScanGeom {
  int b, L, D, N, nseg, rows;
};

inline bool scan_geom(int b, int L, int D, int N, ScanGeom* g) {
  if (b < 1 || L < 1 || D < 1 || N < 1 || N > kScanMaxState) return false;
  if ((long long)b * L * (D > N ? D : N) >= (1LL << 31)) return false;
  g->b = b;
  g->L = L;
  g->D = D;
  g->N = N;
  g->nseg = (L + kScanSeg - 1) / kScanSeg;
  g->rows = b * g->nseg;
  return true;
}

// Row `row`'s segment: its first token's index in the flattened (b * L)
// tokens and its length.
struct ScanRow {
  size_t tok0;
  int len;
};

__device__ __forceinline__ ScanRow scan_row(int L, int nseg, int row) {
  const int t0 = (row % nseg) * kScanSeg;
  return {(size_t)(row / nseg) * L + t0, min(kScanSeg, L - t0)};
}

__device__ __forceinline__ uint32_t scan_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// Copy 4 (or 16) bytes to shared memory asynchronously, or zeros where !live
// (src must still be a valid address).
__device__ __forceinline__ void scan_cp4(float* dst, const float* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(scan_smem(dst)), "l"(src),
               "r"(live ? 4 : 0));
}
__device__ __forceinline__ void scan_cp16(float* dst, const float* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(scan_smem(dst)), "l"(src),
               "r"(live ? 16 : 0));
}
__device__ __forceinline__ void scan_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most PENDING of this thread's committed copy groups are in
// flight.
template <int PENDING>
__device__ __forceinline__ void scan_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}
__device__ __forceinline__ void scan_cp_wait_all() {
  scan_cp_commit();
  scan_cp_wait<0>();
}

// A = at[n, d] log2 e over the NP states of channel d, zero for n >= N.
template <int NP>
__device__ __forceinline__ void load_a2(float* a2, const float* __restrict__ at, int d, int D,
                                        int N) {
#pragma unroll
  for (int n = 0; n < NP; ++n) a2[n] = n < N ? at[n * D + d] * kLog2e : 0.f;
}

// Launch a kernel template instantiated for the call's padded state count
// and softplus flag: f(std::integral_constant<int, NP>, std::integral_constant<bool, SP>).
template <class F>
int with_np_softplus(int N, bool softplus, F&& f) {
  using I8 = std::integral_constant<int, 8>;
  using I16 = std::integral_constant<int, 16>;
  using T = std::true_type;
  using Fl = std::false_type;
  if (N <= 8) return softplus ? f(I8{}, T{}) : f(I8{}, Fl{});
  return softplus ? f(I16{}, T{}) : f(I16{}, Fl{});
}

}  // namespace lcbi
