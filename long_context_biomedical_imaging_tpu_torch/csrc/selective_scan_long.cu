// Long-sequence selective scan (K7), the forward pass: every segment row from
// its carry h0 (zero without h0), templated on EMIT_Y: either each row's final
// state hl and decay product ap = prod_t exp(d_t A), or y and nothing else
// (see selective_scan_long.cuh), on NP = 8 or 16 padded states and with or
// without softplus. The forward of the op runs it twice: from
// zero carries (hl and ap only), then seeded with the carries stitched from
// the first pass (y only; that pass's hl and ap are needed by nothing).
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/selective_scan_long.py
// _make_fwd_kernel (launched by _fwd_call). The TPU kernel lays channel chunks
// on the lanes and expands B and C over the channels with 0/1 matrix
// products; here each thread owns one channel of one row and its NP states.
//
// What bounds it on the H100: device memory. It reads u and delta (and B, C,
// the carries in) and writes y or the carries out, 12 bytes per (token,
// channel) with y, against 6 or 7 fp32 operations per (token, channel, state)
// (chip_smoke.py kernel_bounds). What the design does about it: each value is
// read once, the reads of one token coalesce across a warp's channels, the
// states never leave registers, B and C come from shared memory.
#include "selective_scan_long.cuh"

namespace lcbi {

template <int NP, bool EMIT_Y, bool SOFTPLUS>
__global__ void __launch_bounds__(kScanMaxGroup)
long_scan_fwd_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                     const float* __restrict__ at, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, const float* __restrict__ h0,
                     float* __restrict__ y, float* __restrict__ hl, float* __restrict__ ap,
                     ScanGeom g) {
  __shared__ float sB[kScanSeg * NP], sC[kScanSeg * NP];
  const int row = blockIdx.x, N = g.N;
  const ScanRow r = scan_row(g.L, g.nseg, row);
  stage_row<NP>(sB, Bm, r, N);
  if (EMIT_Y) stage_row<NP>(sC, Cm, r, N);
  __syncthreads();
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  if (d >= g.D) return;
  const int D = g.D;
  float a2[NP], h[NP], p[NP];
  load_a2<NP>(a2, at, d, D, N);
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    h[n] = h0 != nullptr && n < N ? h0[((size_t)row * N + n) * D + d] : 0.f;
    p[n] = 1.f;
  }
  const float* up = u + r.tok0 * D + d;
  const float* dp = delta + r.tok0 * D + d;
  for (int t = 0; t < r.len; ++t) {
    const float dt = scan_dt<SOFTPLUS>(dp[(size_t)t * D]);
    const float du = dt * up[(size_t)t * D];
    float acc = 0.f;
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const float a = exp2f(dt * a2[n]);
      h[n] = fmaf(a, h[n], du * sB[t * NP + n]);
      if (EMIT_Y)
        acc = fmaf(sC[t * NP + n], h[n], acc);
      else
        p[n] *= a;
    }
    if (EMIT_Y) y[(r.tok0 + t) * D + d] = acc;
  }
  if (EMIT_Y) return;
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    if (n >= N) break;
    const size_t o = ((size_t)row * N + n) * D + d;
    hl[o] = h[n];
    ap[o] = p[n];
  }
}

}  // namespace lcbi

// u, delta, y: (b, L, D); at: (N, D); B, C: (b, L, N); h0 (or NULL for zero
// carries), hl, ap: (b * ceil(L / 64), N, D); all fp32, contiguous. Give
// either y (hl and ap NULL: writes y only) or hl and ap (y NULL: writes them
// only). N from 1 to 16; softplus != 0 applies softplus to delta. Returns
// cudaGetLastError() of the launch (or cudaErrorInvalidValue for a shape it
// does not take).
extern "C" int lcbi_long_scan_fwd(const void* u, const void* delta, const void* at,
                                  const void* B, const void* C, const void* h0, void* y, void* hl,
                                  void* ap, int b, int L, int D, int N, int softplus,
                                  void* stream) {
  (void)cudaGetLastError();
  lcbi::ScanGeom g;
  if (!lcbi::scan_geom(b, L, D, N, &g) || (y != nullptr) != (hl == nullptr) ||
      (hl == nullptr) != (ap == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(g.rows, g.groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *uf = static_cast<const float*>(u), *df = static_cast<const float*>(delta),
              *af = static_cast<const float*>(at), *bf = static_cast<const float*>(B),
              *cf = static_cast<const float*>(C), *hf = static_cast<const float*>(h0);
  float *yf = static_cast<float*>(y), *lf = static_cast<float*>(hl), *pf = static_cast<float*>(ap);
  return lcbi::with_np_softplus(N, softplus != 0, [&](auto np, auto sp) {
    constexpr int NP = decltype(np)::value;
    constexpr bool SP = decltype(sp)::value;
    if (yf != nullptr)
      lcbi::long_scan_fwd_kernel<NP, true, SP><<<grid, g.threads, 0, s>>>(uf, df, af, bf, cf, hf,
                                                                          yf, lf, pf, g);
    else
      lcbi::long_scan_fwd_kernel<NP, false, SP><<<grid, g.threads, 0, s>>>(uf, df, af, bf, cf,
                                                                           hf, yf, lf, pf, g);
    return (int)cudaGetLastError();
  });
}
