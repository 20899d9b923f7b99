// Windowed selective scan (K9), the forward: per window w (a sequence of L <=
// 64 tokens), channel d and state n, from h = 0 over t = 0 .. L - 1:
//     d_t = softplus(delta[w, t, d])          (without softplus: delta itself)
//     h_n = exp(d_t A[d, n]) h_n + d_t u[w, t, d] B[w, t, n]
//     y[w, t, d] = sum_n h_n C[w, t, n]
// u, delta, y: (BW, L, D); B, C: (BW, L, N); A^T = at (N, D); all fp32, as
// the JAX package casts them at the kernel boundary (the D skip and the
// delta bias stay outside the kernel, in the wrapper).
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/selective_scan_pallas.py
// _make_fwd_kernel (launched by _fwd). The TPU kernel lays the N x Dc state of
// a row block on the lanes, broadcasts B and C over the channels and sums
// over the states with constant 0/1 matrix products, and cuts wide channel
// counts into chunks on a second grid axis. None of that is carried over:
// here one thread owns one (window, channel) and its N = 8 states in
// registers, and the states are summed in registers.
//
// What bounds it on the H100: device memory. It reads u and delta and writes
// y, 12 bytes per (token, channel), and reads B and C, 64 bytes per token,
// against some 7 fp32 operations per (token, channel, state)
// (chip_smoke.py k9_bounds). The design, simply: a block takes a tile of
// whole windows of one group of at most 128 channels (several windows when
// the channels are few, so that a block holds up to 256 threads); it stages
// the tile's B and C once in shared memory, where every channel of a window
// reads them; each thread reads u and delta of its channel once per token
// (the warp's reads of one token coalesce) and writes y once. L is any value
// from 1 to 64.
#include "selective_scan_long.cuh"

namespace lcbi {

constexpr int kWinMaxGroup = 128;   // channels of a block at most
constexpr int kWinFwdThreads = 256; // threads of a block at most
constexpr int kWinMaxTile = 8;      // windows of a block at most

// Geometry of a call: the channels split into `groups` groups of `dg`
// channels; a block covers `wpb` windows of one group, dg threads each.
struct WinFwd {
  int BW, L, D, groups, dg, wpb;
};

inline bool win_fwd_geom(int BW, int L, int D, int N, WinFwd* g) {
  if (BW < 1 || L < 1 || L > kScanSeg || D < 1 || N != kScanN || N * D > 8192) return false;
  if ((long long)BW * L * D >= (1LL << 31)) return false;
  g->BW = BW;
  g->L = L;
  g->D = D;
  g->groups = (D + kWinMaxGroup - 1) / kWinMaxGroup;
  g->dg = (D + g->groups - 1) / g->groups;
  g->wpb = kWinFwdThreads / g->dg;
  if (g->wpb > kWinMaxTile) g->wpb = kWinMaxTile;
  if (g->wpb < 1) g->wpb = 1;
  return true;
}

template <bool SOFTPLUS>
__global__ void __launch_bounds__(kWinFwdThreads)
window_scan_fwd_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                       const float* __restrict__ at, const float* __restrict__ Bm,
                       const float* __restrict__ Cm, float* __restrict__ y, WinFwd g) {
  __shared__ float sB[kWinMaxTile * kScanSeg * kScanN], sC[kWinMaxTile * kScanSeg * kScanN];
  const int LN = g.L * kScanN;
  const int w0 = blockIdx.x * g.wpb;
  const int nw = min(g.wpb, g.BW - w0);
  for (int i = threadIdx.x; i < nw * LN; i += blockDim.x) {
    sB[i] = Bm[(size_t)w0 * LN + i];
    sC[i] = Cm[(size_t)w0 * LN + i];
  }
  __syncthreads();
  const int wl = threadIdx.x / g.dg, c = threadIdx.x % g.dg;
  const int d = blockIdx.y * g.dg + c;
  if (wl >= nw || d >= g.D) return;
  const int D = g.D;
  float a2[kScanN], h[kScanN];
#pragma unroll
  for (int n = 0; n < kScanN; ++n) {
    a2[n] = at[n * D + d] * kLog2e;
    h[n] = 0.f;
  }
  const float* sb = sB + wl * LN;
  const float* sc = sC + wl * LN;
  const size_t base = (size_t)(w0 + wl) * g.L * D + d;
  for (int t = 0; t < g.L; ++t) {
    const size_t o = base + (size_t)t * D;
    const float raw = delta[o];
    const float dt = SOFTPLUS ? scan_softplus(raw) : raw;
    scan_step(h, a2, dt, dt * u[o], sb + t * kScanN);
    float acc = 0.f;
#pragma unroll
    for (int n = 0; n < kScanN; ++n) acc = fmaf(sc[t * kScanN + n], h[n], acc);
    y[o] = acc;
  }
}

}  // namespace lcbi

// u, delta, y: (BW, L, D); at: (N, D); B, C: (BW, L, N); all fp32,
// contiguous. N must be 8, L at most 64 and N D at most 8192; softplus != 0
// applies softplus to delta. Returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for a shape it does not take).
extern "C" int lcbi_window_scan_fwd(const void* u, const void* delta, const void* at,
                                    const void* B, const void* C, void* y, int BW, int L, int D,
                                    int N, int softplus, void* stream) {
  (void)cudaGetLastError();
  lcbi::WinFwd g;
  if (!lcbi::win_fwd_geom(BW, L, D, N, &g)) return (int)cudaErrorInvalidValue;
  const dim3 grid((BW + g.wpb - 1) / g.wpb, g.groups);
  const int threads = g.wpb * g.dg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *uf = static_cast<const float*>(u), *df = static_cast<const float*>(delta),
              *af = static_cast<const float*>(at), *bf = static_cast<const float*>(B),
              *cf = static_cast<const float*>(C);
  float* yf = static_cast<float*>(y);
  if (softplus)
    lcbi::window_scan_fwd_kernel<true><<<grid, threads, 0, s>>>(uf, df, af, bf, cf, yf, g);
  else
    lcbi::window_scan_fwd_kernel<false><<<grid, threads, 0, s>>>(uf, df, af, bf, cf, yf, g);
  return (int)cudaGetLastError();
}
