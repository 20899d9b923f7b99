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
// this is K7's seeded forward pass with zero carries and no carry loads, each
// window one row (long_scan_stream_kernel's kWinFwd mode,
// selective_scan_long_stream.cuh): a thread owns one (window, channel) and its
// NP = 8 or 16 padded states in registers, a block takes several narrow
// windows at once, and the windows stream through a ring of cp.async stages
// of 8 tokens, ceil(L / 8) stages a window, the ragged last one computing
// its live tokens alone.
//
// What bounds it on the H100: device memory. It reads u and delta and writes
// y, 12 bytes per (token, channel), and reads B and C, 64 bytes per token,
// against some 7 fp32 operations per (token, channel, state)
// (chip_smoke.py k9_bounds), NP exponentials among them on the
// special-function unit; at micro_w7's stage 0 a byte floor of 0.205 ms. The
// per-thread kernel this replaces reached 57% of it; memory, the
// special-function unit and issue each hold the streamed pass about equally
// (the ablations of utils/k7_stream_tiles.py).
#include "selective_scan_long_stream.cuh"

// u, delta, y: (BW, L, D); at: (N, D); B, C: (BW, L, N); all fp32,
// contiguous, 16-byte aligned. N from 1 to 16, L at most 64 and N D at most
// 8192; softplus != 0 applies softplus to delta. Returns cudaGetLastError()
// of the launch (or cudaErrorInvalidValue for a shape it does not take).
extern "C" int lcbi_window_scan_fwd(const void* u, const void* delta, const void* at,
                                    const void* B, const void* C, void* y, int BW, int L, int D,
                                    int N, int softplus, void* stream) {
  (void)cudaGetLastError();
  lcbi::StreamGeom g;
  if (N * D > 8192 || !lcbi::stream_geom(BW, L, D, N, lcbi::kWinFwd, &g))
    return (int)cudaErrorInvalidValue;
  const lcbi::StreamArgs a{static_cast<const float*>(u), static_cast<const float*>(delta),
                           static_cast<const float*>(at), static_cast<const float*>(B),
                           static_cast<const float*>(C), nullptr,
                           static_cast<float*>(y),       nullptr,
                           nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lcbi::stream_launch<lcbi::kWinFwd>(g, softplus != 0, [&](auto kernel) {
    kernel<<<dim3(g.blocks, g.tiles), lcbi::stream_threads(g), g.smem, s>>>(a, g);
    return (int)cudaGetLastError();
  });
}
