// Long-sequence selective scan (K7), the carry backward: for every segment
// row, the cotangent of its initial state from a zero tail, the reverse chain
//     dh_{t-1} = exp(d_t A) (dh_t + C_t g_t)
// over the row's tokens (see selective_scan_long.cuh), into dh0 (rows, N, D).
// It needs neither u nor B nor the h history.
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/selective_scan_long.py
// _make_carry_bwd_kernel (launched by _carry_bwd_call).
//
// What bounds it on the H100: device memory, delta and g read once (8 bytes
// per (token, channel)) against 5 fp32 operations per (token, channel,
// state). One thread per (row, channel), its NP (8 or 16) dh in registers, C
// from shared memory; a warp's reads of one token coalesce.
#include "selective_scan_long.cuh"

namespace lcbi {

template <int NP, bool SOFTPLUS>
__global__ void __launch_bounds__(kScanMaxGroup)
long_scan_carry_bwd_kernel(const float* __restrict__ delta, const float* __restrict__ at,
                           const float* __restrict__ Cm, const float* __restrict__ gy,
                           float* __restrict__ dh0, ScanGeom g) {
  __shared__ float sC[kScanSeg * NP];
  const int row = blockIdx.x, N = g.N;
  const ScanRow r = scan_row(g.L, g.nseg, row);
  stage_row<NP>(sC, Cm, r, N);
  __syncthreads();
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  if (d >= g.D) return;
  const int D = g.D;
  float a2[NP], dh[NP];
  load_a2<NP>(a2, at, d, D, N);
#pragma unroll
  for (int n = 0; n < NP; ++n) dh[n] = 0.f;
  const float* dp = delta + r.tok0 * D + d;
  const float* gp = gy + r.tok0 * D + d;
  // counted up, indexed down: the count-down loop `for (t = r.len - 1; t >=
  // 0; --t)` built by nvcc 12.8 left one-token rows all zero at NP = 8
  // without softplus (tests/test_torch_cuda.py)
  for (int k = 0; k < r.len; ++k) {
    const int t = r.len - 1 - k;
    const float dt = scan_dt<SOFTPLUS>(dp[(size_t)t * D]);
    const float gt = gp[(size_t)t * D];
#pragma unroll
    for (int n = 0; n < NP; ++n) dh[n] = exp2f(dt * a2[n]) * fmaf(sC[t * NP + n], gt, dh[n]);
  }
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    if (n >= N) break;
    dh0[((size_t)row * N + n) * D + d] = dh[n];
  }
}

}  // namespace lcbi

// delta, g: (b, L, D); at: (N, D); C: (b, L, N); dh0: (b * ceil(L / 64), N,
// D); all fp32, contiguous; N from 1 to 16; softplus != 0 applies softplus to
// delta. Returns cudaGetLastError() of the launch (or cudaErrorInvalidValue
// for a shape it does not take).
extern "C" int lcbi_long_scan_carry_bwd(const void* delta, const void* at, const void* C,
                                        const void* g, void* dh0, int b, int L, int D, int N,
                                        int softplus, void* stream) {
  (void)cudaGetLastError();
  lcbi::ScanGeom geom;
  if (!lcbi::scan_geom(b, L, D, N, &geom)) return (int)cudaErrorInvalidValue;
  return lcbi::with_np_softplus(N, softplus != 0, [&](auto np, auto sp) {
    lcbi::long_scan_carry_bwd_kernel<decltype(np)::value, decltype(sp)::value>
        <<<dim3(geom.rows, geom.groups), geom.threads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(delta), static_cast<const float*>(at),
            static_cast<const float*>(C), static_cast<const float*>(g), static_cast<float*>(dh0),
            geom);
    return (int)cudaGetLastError();
  });
}
