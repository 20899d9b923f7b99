// Spectral causal convolution (K6), the convolution: per cell (b, d) of u
// (B, D, L), y = causal(k[d] * u[b, d]) + bias[d] u[b, d], or with conj the
// correlation y[t] = sum_tau k[d, tau] u[b, d, t + tau] + bias[d] u[b, d, t]
// (du of the convolution, for the cotangent in place of u). Every value is
// fp32 (see spectral_conv.cuh for the passes); y is rounded once to u's type.
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/spectral_conv.py
// _conv_kernel (launched by _conv_call). The TPU kernel computes its DFTs as
// bf16 matrix products, because a TPU has a matrix unit and no FFT; this card
// runs the same function as an fp32 FFT, some 70 times less arithmetic at L =
// 65,536 and exact to fp32 round-off instead of 1e-3 to 1e-2.
//
// What bounds it on the H100: 2.5 n log2 n fp32 operations per real transform
// of n = 2L points, three transforms per cell (u's and k's forward and the
// inverse), against u, k and y read or written once: at (1, 384, 65536) some
// 0.10 ms of operations against 0.06 ms of bytes (chip_smoke.py
// kernel_bounds). What the design does about it, simply: five passes over the
// cells (the filter's column and row passes, u's column pass, the row pass
// that multiplies, the inverse column pass), each holding a few lines in
// shared memory and its planes in a global fp32 scratch of (D + B D) n complex
// values; the transforms are complex (the imaginary half of a real input is
// zero), so the passes move about 17 times the bytes of the bound. No atomics:
// two launches give the same bits.
#include "spectral_conv.cuh"

namespace lcbi {

// Row pass of the convolution: per row of u's planes, the forward FFT, times
// the filter spectrum of the cell's channel (its conjugate with conj), then
// the inverse FFT and twiddle; in place. kspec: (D, n1, n2) as
// spec_row_fwd_kernel leaves it. grid (cells, n1 / rows).
__global__ void __launch_bounds__(kThreads)
spec_row_mul_kernel(float2* __restrict__ z, const float2* __restrict__ kspec, int D, int conj,
                    SpecShape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n2 = s.n2, rows = kSpecRowElems / s.n2, p0 = blockIdx.y * rows;
  float2* tw = reinterpret_cast<float2*>(smem);
  float2* buf = tw + n2 / 2;
  const size_t off = (size_t)p0 * n2;
  float2* zp = z + (size_t)blockIdx.x * s.n + off;
  const float2* kp = kspec + (size_t)(blockIdx.x % D) * s.n + off;
  make_table(tw, n2);
  for (int t = threadIdx.x; t < rows * n2; t += kThreads) buf[t] = zp[t];
  __syncthreads();
  fft_dif(buf, n2, rows, s.log2, n2 / 2, tw);
  for (int t = threadIdx.x; t < rows * n2; t += kThreads)
    buf[t] = conj ? cmulc(buf[t], kp[t]) : cmul(buf[t], kp[t]);
  __syncthreads();
  spec_row_inverse_store(buf, tw, p0, zp, s);
}

// Every pass of one call, on its stream; the first error ends the call.
template <typename T>
int launch_conv(const T* u, const float* k, const float* bias, T* y, float2* ws, int B, int D,
                const SpecShape& s, int conj, cudaStream_t stream) {
  float2* kspec = ws;                       // (D, n1, n2)
  float2* z = ws + (size_t)D * s.n;         // (B D, n1, n2)
  const int cells = B * D;
  const size_t col_smem = spec_col_smem(s), row_smem = spec_row_smem(s, 1);
  const dim3 col_grid_k(D, s.n2 / kSpecCols), row_grid_k(D, s.n1 / spec_rows(s));
  const dim3 col_grid(cells, s.n2 / kSpecCols), row_grid(cells, s.n1 / spec_rows(s));
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(spec_col_fwd_kernel<float>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)col_smem)) ||
      (err = cudaFuncSetAttribute(spec_col_fwd_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)col_smem)) ||
      (err = cudaFuncSetAttribute(spec_col_inv_kernel<T, T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)col_smem)) ||
      (err = cudaFuncSetAttribute(spec_row_mul_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)row_smem)))
    return (int)err;
  spec_col_fwd_kernel<float><<<col_grid_k, kThreads, col_smem, stream>>>(k, kspec, s);
  if ((err = cudaGetLastError())) return (int)err;
  spec_row_fwd_kernel<<<row_grid_k, kThreads, row_smem, stream>>>(kspec, s);
  if ((err = cudaGetLastError())) return (int)err;
  spec_col_fwd_kernel<T><<<col_grid, kThreads, col_smem, stream>>>(u, z, s);
  if ((err = cudaGetLastError())) return (int)err;
  spec_row_mul_kernel<<<row_grid, kThreads, row_smem, stream>>>(z, kspec, D, conj, s);
  if ((err = cudaGetLastError())) return (int)err;
  spec_col_inv_kernel<T, T><<<col_grid, kThreads, col_smem, stream>>>(z, u, bias, y, D, s);
  return (int)cudaGetLastError();
}

}  // namespace lcbi

// Bytes of scratch lcbi_spectral_conv needs (0 for a shape it does not take).
extern "C" size_t lcbi_spectral_conv_workspace(int B, int D, int L) {
  lcbi::SpecShape s;
  if (B <= 0 || D <= 0 || !lcbi::spec_shape(L, &s)) return 0;
  return sizeof(float2) * (size_t)(D + (size_t)B * D) * s.n;
}

// u, y: (B, D, L) contiguous in T (fp32 if is_bf16 == 0, else bf16); k: (D,
// L) fp32; bias: (D,) fp32 or NULL; ws: lcbi_spectral_conv_workspace bytes,
// 16-byte aligned. 8192 <= L <= 131072 a power of two, B D < 2^31. Returns
// cudaGetLastError() of the first launch that fails (or
// cudaErrorInvalidValue for a shape it does not take).
extern "C" int lcbi_spectral_conv(const void* u, const void* k, const void* bias, void* y,
                                  void* ws, int B, int D, int L, int conj, int is_bf16,
                                  void* stream) {
  (void)cudaGetLastError();
  lcbi::SpecShape s;
  if (B <= 0 || D <= 0 || (long long)B * D >= (1LL << 31) || !lcbi::spec_shape(L, &s))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kf = static_cast<const float*>(k);
  const float* bf = static_cast<const float*>(bias);
  float2* w = static_cast<float2*>(ws);
  if (is_bf16)
    return lcbi::launch_conv<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(u), kf, bf,
                                            static_cast<__nv_bfloat16*>(y), w, B, D, s, conj, st);
  return lcbi::launch_conv<float>(static_cast<const float*>(u), kf, bf, static_cast<float*>(y), w,
                                  B, D, s, conj, st);
}
