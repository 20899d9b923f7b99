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
// here one thread owns one (window, channel) and its NP = 8 or 16 padded
// states in registers (the states n >= N zero), and the states are summed in
// registers.
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
constexpr int kWinStage = 64;       // windows x padded states a block stages at most

// Geometry of a call: the channels split into `groups` groups of `dg`
// channels; a block covers `wpb` windows of one group, dg threads each.
struct WinFwd {
  int BW, L, D, N, groups, dg, wpb;
};

inline bool win_fwd_geom(int BW, int L, int D, int N, WinFwd* g) {
  if (BW < 1 || L < 1 || L > kScanSeg || D < 1 || N < 1 || N > kScanMaxState || N * D > 8192)
    return false;
  if ((long long)BW * L * D >= (1LL << 31)) return false;
  g->BW = BW;
  g->L = L;
  g->D = D;
  g->N = N;
  g->groups = (D + kWinMaxGroup - 1) / kWinMaxGroup;
  g->dg = (D + g->groups - 1) / g->groups;
  g->wpb = kWinFwdThreads / g->dg;
  const int tile = kWinStage / scan_np(N);
  if (g->wpb > tile) g->wpb = tile;
  if (g->wpb < 1) g->wpb = 1;
  return true;
}

template <int NP, bool SOFTPLUS>
__global__ void __launch_bounds__(kWinFwdThreads)
window_scan_fwd_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                       const float* __restrict__ at, const float* __restrict__ Bm,
                       const float* __restrict__ Cm, float* __restrict__ y, WinFwd g) {
  __shared__ float sB[kWinStage * kScanSeg], sC[kWinStage * kScanSeg];
  const int N = g.N, LP = g.L * NP;
  const int w0 = blockIdx.x * g.wpb;
  const int nw = min(g.wpb, g.BW - w0);
  for (int i = threadIdx.x; i < nw * LP; i += blockDim.x) {
    const int q = i / NP, n = i % NP;
    const size_t src = ((size_t)w0 * g.L + q) * N + n;
    sB[i] = n < N ? Bm[src] : 0.f;
    sC[i] = n < N ? Cm[src] : 0.f;
  }
  __syncthreads();
  const int wl = threadIdx.x / g.dg, c = threadIdx.x % g.dg;
  const int d = blockIdx.y * g.dg + c;
  if (wl >= nw || d >= g.D) return;
  const int D = g.D;
  float a2[NP], h[NP];
  load_a2<NP>(a2, at, d, D, N);
#pragma unroll
  for (int n = 0; n < NP; ++n) h[n] = 0.f;
  const float* sb = sB + wl * LP;
  const float* sc = sC + wl * LP;
  const size_t base = (size_t)(w0 + wl) * g.L * D + d;
  for (int t = 0; t < g.L; ++t) {
    const size_t o = base + (size_t)t * D;
    const float dt = scan_dt<SOFTPLUS>(delta[o]);
    scan_step<NP>(h, a2, dt, dt * u[o], sb + t * NP);
    float acc = 0.f;
#pragma unroll
    for (int n = 0; n < NP; ++n) acc = fmaf(sc[t * NP + n], h[n], acc);
    y[o] = acc;
  }
}

}  // namespace lcbi

// u, delta, y: (BW, L, D); at: (N, D); B, C: (BW, L, N); all fp32,
// contiguous. N from 1 to 16, L at most 64 and N D at most 8192; softplus !=
// 0 applies softplus to delta. Returns cudaGetLastError() of the launch (or
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
  return lcbi::with_np_softplus(N, softplus != 0, [&](auto np, auto sp) {
    lcbi::window_scan_fwd_kernel<decltype(np)::value, decltype(sp)::value>
        <<<grid, threads, 0, s>>>(static_cast<const float*>(u), static_cast<const float*>(delta),
                                  static_cast<const float*>(at), static_cast<const float*>(B),
                                  static_cast<const float*>(C), static_cast<float*>(y), g);
    return (int)cudaGetLastError();
  });
}
