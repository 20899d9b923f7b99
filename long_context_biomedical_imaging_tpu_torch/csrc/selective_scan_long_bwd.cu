// Long-sequence selective scan (K7), the backward pass: for every segment row,
// given its true initial carry h0 and the true cotangent dht of its final
// state, du, ddelta, dB, dC and dA for the cotangent g of y, with or without
// softplus, on the lane-group core of selective_scan_bwd.cuh (the equations,
// the bound and the design are there). dB and dC sum over the channels, dA
// over every token of every row.
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/selective_scan_long.py
// _make_bwd_kernel (launched by _bwd_call), which keeps a segment's whole h
// history in VMEM and sums dB, dC over its sequential channel-chunk grid axis
// and dA over its row blocks. Here the history is a lane's checkpoints and
// one recomputed stretch in registers, and the sums are shuffles, warp
// partials and per-tile partials summed in order.
#include "selective_scan_bwd.cuh"

// Floats of the per-tile dB | dC partials (the `parts` scratch) that
// lcbi_long_scan_bwd needs for this shape: 0 with one channel tile, -1 for a
// shape it does not take.
extern "C" long long lcbi_long_scan_bwd_parts(int b, int L, int D, int N) {
  lcbi::ScanGeom sg;
  lcbi::ScanBwdGeom g;
  if (!lcbi::scan_geom(b, L, D, N, &sg) ||
      !lcbi::scan_bwd_geom(sg.rows, L, sg.nseg, D, N, true, &g))
    return -1;
  return lcbi::scan_bwd_parts(g);
}

// u, delta, g, du, dd: (b, L, D); at, dat: (N, D); B, C, dB, dC: (b, L, N);
// h0, dht: (b * ceil(L / 64), N, D); slots: max_slots x (N D) scratch; parts:
// lcbi_long_scan_bwd_parts floats of scratch (or NULL when that is 0). All
// fp32, contiguous; N from 1 to 16; softplus != 0 applies softplus to delta.
// dat receives the sum over every token of the dA terms (the gradient of
// at). Returns cudaGetLastError() of the first launch that fails (or
// cudaErrorInvalidValue for a shape it does not take).
extern "C" int lcbi_long_scan_bwd(const void* u, const void* delta, const void* at, const void* B,
                                  const void* C, const void* g, const void* h0, const void* dht,
                                  void* du, void* dd, void* dB, void* dC, void* slots, void* parts,
                                  void* dat, int b, int L, int D, int N, int softplus,
                                  int max_slots, void* stream) {
  (void)cudaGetLastError();
  lcbi::ScanGeom sg;
  if (!lcbi::scan_geom(b, L, D, N, &sg) || max_slots < 1) return (int)cudaErrorInvalidValue;
  lcbi::ScanBwdGeom geom;
  const int err =
      lcbi::scan_bwd_plan(sg.rows, L, sg.nseg, D, N, softplus != 0, max_slots, &geom);
  if (err) return err;
  if (geom.tiles > 1 && parts == nullptr) return (int)cudaErrorInvalidValue;
  const lcbi::ScanBwdArgs args{
      static_cast<const float*>(u),    static_cast<const float*>(delta),
      static_cast<const float*>(at),   static_cast<const float*>(B),
      static_cast<const float*>(C),    static_cast<const float*>(g),
      static_cast<const float*>(h0),   static_cast<const float*>(dht),
      static_cast<float*>(du),         static_cast<float*>(dd),
      static_cast<float*>(dB),         static_cast<float*>(dC),
      static_cast<float*>(slots),      static_cast<float*>(parts),
      static_cast<float*>(dat)};
  return lcbi::scan_bwd_launch(args, geom, static_cast<cudaStream_t>(stream));
}
