// Long-sequence selective scan (K7), the forward pass: every segment row from
// its carry h0 (zero without h0), either each row's final state hl and decay
// product ap = prod_t exp(d_t A), or y and nothing else (see
// selective_scan_long.cuh), on NP = 8 or 16 padded states and with or without
// softplus. The forward of the op runs it twice: from zero carries (hl and ap
// only), then seeded with the carries stitched from the first pass
// (selective_scan_long_stitch.cu; y only, since that pass's hl and ap are
// needed by nothing).
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/selective_scan_long.py
// _make_fwd_kernel (launched by _fwd_call). The TPU kernel lays channel chunks
// on the lanes and expands B and C over the channels with 0/1 matrix
// products; here each thread owns one channel of a tile of a row and its NP
// states, and the rows stream through a ring of shared-memory stages
// (selective_scan_long_stream.cuh: the bound and the design).
#include "selective_scan_long_stream.cuh"

// u, delta, y: (b, L, D); at: (N, D); B, C: (b, L, N); h0 (or NULL for zero
// carries), hl, ap: (b * ceil(L / 64), N, D); all fp32, contiguous, 16-byte
// aligned. Give either y (hl and ap NULL: writes y only) or hl and ap (y
// NULL: writes them only). N from 1 to 16; softplus != 0 applies softplus to
// delta. Returns cudaGetLastError() of the launch (or cudaErrorInvalidValue
// for a shape it does not take).
extern "C" int lcbi_long_scan_fwd(const void* u, const void* delta, const void* at,
                                  const void* B, const void* C, const void* h0, void* y, void* hl,
                                  void* ap, int b, int L, int D, int N, int softplus,
                                  void* stream) {
  (void)cudaGetLastError();
  const bool emit_y = y != nullptr;
  lcbi::StreamGeom g;
  if (!lcbi::stream_geom(b, L, D, N, emit_y ? lcbi::kFwdSeeded : lcbi::kFwdZero, &g) ||
      emit_y != (hl == nullptr) || (hl == nullptr) != (ap == nullptr))
    return (int)cudaErrorInvalidValue;
  const lcbi::StreamArgs a{static_cast<const float*>(u), static_cast<const float*>(delta),
                           static_cast<const float*>(at), static_cast<const float*>(B),
                           static_cast<const float*>(C), static_cast<const float*>(h0),
                           static_cast<float*>(y),       static_cast<float*>(hl),
                           static_cast<float*>(ap)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    kernel<<<dim3(g.blocks, g.tiles), lcbi::stream_threads(g), g.smem, s>>>(a, g);
    return (int)cudaGetLastError();
  };
  return emit_y ? lcbi::stream_launch<lcbi::kFwdSeeded>(g, softplus != 0, launch)
                : lcbi::stream_launch<lcbi::kFwdZero>(g, softplus != 0, launch);
}
