// Long-sequence selective scan (K7), the carry backward: for every segment
// row, the cotangent of its initial state from a zero tail, the reverse chain
//     dh_{t-1} = exp(d_t A) (dh_t + C_t g_t)
// over the row's tokens (see selective_scan_long.cuh), into dh0 (rows, N, D).
// It needs neither u nor B nor the h history.
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/selective_scan_long.py
// _make_carry_bwd_kernel (launched by _carry_bwd_call). One thread per
// channel of a tile of a row, its NP (8 or 16) dh in registers; delta, g and
// C stream through the forward's ring of shared-memory stages, each row's
// chunks from its end (selective_scan_long_stream.cuh: the bound and the
// design).
#include "selective_scan_long_stream.cuh"

// delta, g: (b, L, D); at: (N, D); C: (b, L, N); dh0: (b * ceil(L / 64), N,
// D); all fp32, contiguous, 16-byte aligned; N from 1 to 16; softplus != 0
// applies softplus to delta. Returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for a shape it does not take).
extern "C" int lcbi_long_scan_carry_bwd(const void* delta, const void* at, const void* C,
                                        const void* g, void* dh0, int b, int L, int D, int N,
                                        int softplus, void* stream) {
  (void)cudaGetLastError();
  lcbi::StreamGeom geom;
  if (!lcbi::stream_geom(b, L, D, N, lcbi::kCarryBwd, &geom)) return (int)cudaErrorInvalidValue;
  const lcbi::StreamArgs a{static_cast<const float*>(delta), static_cast<const float*>(g),
                           static_cast<const float*>(at),    nullptr,
                           static_cast<const float*>(C),     nullptr,
                           nullptr,                          static_cast<float*>(dh0),
                           nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lcbi::stream_launch<lcbi::kCarryBwd>(geom, softplus != 0, [&](auto kernel) {
    kernel<<<dim3(geom.blocks, geom.tiles), lcbi::stream_threads(geom), geom.smem, s>>>(a, geom);
    return (int)cudaGetLastError();
  });
}
