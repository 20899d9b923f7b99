// Windowed selective scan (K9), the backward: for the cotangent g of y (see
// selective_scan_window.cu), per window from h = 0 and a zero tail, du,
// ddelta, dB, dC and dA, with or without softplus, on the lane-group core of
// selective_scan_bwd.cuh that K7's backward runs too (the equations, the
// bound and the design are there; a window is a row with no carries). dB and
// dC sum over the channels, dA over every token of every window. A block
// takes as many whole windows as keep it within kBwdTileThreads threads, and
// a window's channels split into lane-group tiles with no padding past the
// next multiple of 32 / LG channels (48 channels at LG = 8: two tiles of 24).
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/selective_scan_pallas.py
// _make_bwd_kernel (launched by _bwd), which keeps the h history of a block
// of rows in VMEM, sums dB and dC over its sequential channel-chunk grid axis
// inside their VMEM-resident output block, and writes one dA partial per grid
// cell, summed by XLA.
#include <climits>

#include "selective_scan_bwd.cuh"

namespace {

inline bool window_shape(int BW, int L, int D, int N) {
  return BW >= 1 && L >= 1 && L <= lcbi::kScanSeg && D >= 1 && N >= 1 &&
         N <= lcbi::kScanMaxState && N * D <= 8192 && (long long)BW * L * D < (1LL << 31);
}

}  // namespace

// The number of dA slots (rows of N * D floats) that lcbi_window_scan_bwd
// needs for this call, or -1 for a shape it does not take.
extern "C" long long lcbi_window_scan_bwd_slots(int BW, int L, int D, int N, int softplus) {
  lcbi::ScanBwdGeom g;
  if (!window_shape(BW, L, D, N) ||
      lcbi::scan_bwd_plan(BW, L, 1, D, N, softplus != 0, LLONG_MAX, &g))
    return -1;
  return (long long)g.blocks * g.wpb;
}

// Floats of the per-tile dB | dC partials (the `parts` scratch) that
// lcbi_window_scan_bwd needs for this call: 0 with one channel tile, -1 for
// a shape it does not take.
extern "C" long long lcbi_window_scan_bwd_parts(int BW, int L, int D, int N) {
  lcbi::ScanBwdGeom g;
  if (!window_shape(BW, L, D, N) || !lcbi::scan_bwd_geom(BW, L, 1, D, N, true, &g)) return -1;
  return lcbi::scan_bwd_parts(g);
}

// u, delta, g, du, dd: (BW, L, D); at, dat: (N, D); B, C, dB, dC: (BW, L, N);
// slots: n_slots x (N D) scratch, n_slots from lcbi_window_scan_bwd_slots;
// parts: lcbi_window_scan_bwd_parts floats of scratch (or NULL when that is
// 0). All fp32, contiguous; N from 1 to 16, L at most 64 and N D at most
// 8192; softplus != 0 applies softplus to delta. dat receives the sum over
// every token of every window of the dA terms (the gradient of at). Returns
// cudaGetLastError() of the first launch that fails (or
// cudaErrorInvalidValue for a shape or slot count it does not take).
extern "C" int lcbi_window_scan_bwd(const void* u, const void* delta, const void* at,
                                    const void* B, const void* C, const void* g, void* du,
                                    void* dd, void* dB, void* dC, void* slots, void* parts,
                                    void* dat, int BW, int L, int D, int N, int softplus,
                                    int n_slots, void* stream) {
  (void)cudaGetLastError();
  if (!window_shape(BW, L, D, N)) return (int)cudaErrorInvalidValue;
  lcbi::ScanBwdGeom geom;
  const int err = lcbi::scan_bwd_plan(BW, L, 1, D, N, softplus != 0, LLONG_MAX, &geom);
  if (err) return err;
  if ((long long)geom.blocks * geom.wpb != n_slots || (geom.tiles > 1 && parts == nullptr))
    return (int)cudaErrorInvalidValue;
  const lcbi::ScanBwdArgs args{
      static_cast<const float*>(u),  static_cast<const float*>(delta),
      static_cast<const float*>(at), static_cast<const float*>(B),
      static_cast<const float*>(C),  static_cast<const float*>(g),
      nullptr,                       nullptr,
      static_cast<float*>(du),       static_cast<float*>(dd),
      static_cast<float*>(dB),       static_cast<float*>(dC),
      static_cast<float*>(slots),    static_cast<float*>(parts),
      static_cast<float*>(dat)};
  return lcbi::scan_bwd_launch(args, geom, static_cast<cudaStream_t>(stream));
}
