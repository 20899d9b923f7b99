// Spectral causal convolution (K6), the filter gradient: dk[d, tau] =
// sum_b sum_t g[b, d, t] u[b, d, t - tau], (D, L) fp32, for the cotangent g
// and input u, both (B, D, L); the cross-correlation of g and u as
// iF(sum_b F(g) conj(F(u))) through the passes of spectral_conv.cuh, all fp32.
// dbias is dk[:, 0] (the caller slices it).
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/spectral_conv.py
// _dk_kernel (launched by _dk_call), whose sequential batch axis accumulates
// the spectra in VMEM. Here one block owns a channel's rows and sums the
// batch's spectra in a fixed order (b ascending) in shared memory before the
// inverse: no atomics, and two launches give the same bits.
//
// What bounds it on the H100: 2.5 n log2 n fp32 operations per real transform
// of n = 2L points, two forward transforms per cell and one inverse per
// channel, against g and u read and dk written once: at (1, 384, 65536) some
// 0.10 ms of operations (chip_smoke.py kernel_bounds). What the design does
// about it, simply: the column passes of g and u into a global fp32 scratch of
// 2 B D n complex values, a row pass that transforms, multiplies and sums over
// the batch and inverts, and the inverse column pass.
#include "spectral_conv.cuh"

namespace lcbi {

// Row pass of dk: per channel d and rows [p0, p0 + rows), the sum over b of
// F(g) conj(F(u)) of the cells (b, d), b ascending; then the inverse row FFT
// and twiddle, written over zg's cell (0, d). grid (D, n1 / rows).
__global__ void __launch_bounds__(kThreads)
spec_row_dk_kernel(float2* __restrict__ zg, const float2* __restrict__ zu, int B, int D,
                   SpecShape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n2 = s.n2, rows = kSpecRowElems / s.n2, p0 = blockIdx.y * rows;
  const int elems = rows * n2;
  float2* tw = reinterpret_cast<float2*>(smem);
  float2* acc = tw + n2 / 2;
  float2* gb = acc + elems;   // g's rows, then u's rows: one FFT over 2 * rows lines
  float2* ub = gb + elems;
  const size_t off = (size_t)p0 * n2;
  make_table(tw, n2);
  for (int b = 0; b < B; ++b) {
    const size_t cell = (size_t)b * D + blockIdx.x;
    const float2* gp = zg + cell * s.n + off;
    const float2* up = zu + cell * s.n + off;
    for (int t = threadIdx.x; t < elems; t += kThreads) {
      gb[t] = gp[t];
      ub[t] = up[t];
    }
    __syncthreads();
    fft_dif(gb, n2, 2 * rows, s.log2, n2 / 2, tw);
    for (int t = threadIdx.x; t < elems; t += kThreads) {
      const float2 prod = cmulc(gb[t], ub[t]);
      acc[t] = b == 0 ? prod : cadd(acc[t], prod);
    }
    __syncthreads();
  }
  spec_row_inverse_store(acc, tw, p0, zg + (size_t)blockIdx.x * s.n + off, s);
}

template <typename T>
int launch_dk(const T* g, const T* u, float* dk, float2* ws, int B, int D, const SpecShape& s,
              cudaStream_t stream) {
  const int cells = B * D;
  float2* zg = ws;                           // (B D, n1, n2)
  float2* zu = ws + (size_t)cells * s.n;     // (B D, n1, n2)
  const size_t col_smem = spec_col_smem(s), row_smem = spec_row_smem(s, 3);
  const dim3 col_grid(cells, s.n2 / kSpecCols), row_grid(D, s.n1 / spec_rows(s));
  const dim3 out_grid(D, s.n2 / kSpecCols);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(spec_col_fwd_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)col_smem)) ||
      (err = cudaFuncSetAttribute(spec_col_inv_kernel<float, float>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)col_smem)) ||
      (err = cudaFuncSetAttribute(spec_row_dk_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)row_smem)))
    return (int)err;
  spec_col_fwd_kernel<T><<<col_grid, kThreads, col_smem, stream>>>(g, zg, s);
  if ((err = cudaGetLastError())) return (int)err;
  spec_col_fwd_kernel<T><<<col_grid, kThreads, col_smem, stream>>>(u, zu, s);
  if ((err = cudaGetLastError())) return (int)err;
  spec_row_dk_kernel<<<row_grid, kThreads, row_smem, stream>>>(zg, zu, B, D, s);
  if ((err = cudaGetLastError())) return (int)err;
  spec_col_inv_kernel<float, float><<<out_grid, kThreads, col_smem, stream>>>(
      zg, nullptr, nullptr, dk, D, s);
  return (int)cudaGetLastError();
}

}  // namespace lcbi

// Bytes of scratch lcbi_spectral_conv_dk needs (0 for a shape it does not take).
extern "C" size_t lcbi_spectral_conv_dk_workspace(int B, int D, int L) {
  lcbi::SpecShape s;
  if (B <= 0 || D <= 0 || !lcbi::spec_shape(L, &s)) return 0;
  return sizeof(float2) * 2 * (size_t)B * D * s.n;
}

// g, u: (B, D, L) contiguous in T (fp32 if is_bf16 == 0, else bf16); dk: (D,
// L) fp32; ws: lcbi_spectral_conv_dk_workspace bytes, 16-byte aligned. 8192
// <= L <= 131072 a power of two, B D < 2^31. Returns cudaGetLastError() of
// the first launch that fails (or cudaErrorInvalidValue for a shape it does
// not take).
extern "C" int lcbi_spectral_conv_dk(const void* g, const void* u, void* dk, void* ws, int B,
                                     int D, int L, int is_bf16, void* stream) {
  (void)cudaGetLastError();
  lcbi::SpecShape s;
  if (B <= 0 || D <= 0 || (long long)B * D >= (1LL << 31) || !lcbi::spec_shape(L, &s))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dk);
  float2* w = static_cast<float2*>(ws);
  if (is_bf16)
    return lcbi::launch_dk<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(g),
                                          static_cast<const __nv_bfloat16*>(u), out, w, B, D, s,
                                          st);
  return lcbi::launch_dk<float>(static_cast<const float*>(g), static_cast<const float*>(u), out,
                                w, B, D, s, st);
}
