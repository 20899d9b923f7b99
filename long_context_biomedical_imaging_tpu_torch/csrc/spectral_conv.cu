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
// kernel_bounds). What the design does about it: real transforms at half
// length (the planes hold L complex values per cell, not 2L), radix-16 and
// radix-8 passes in registers, and three passes over u's planes (column FFT,
// the row pass that transforms, multiplies and inverts, the inverse column
// FFT). The filter's spectrum costs two more passes over (D, L) planes when
// the call makes it; the autograd Function makes it once in the forward and
// hands it to the du call of the backward. No atomics: two launches give the
// same bits.
#include "spectral_conv.cuh"

namespace lcbi {

// Row pass of the convolution: per pair of rows of u's planes, the forward
// FFT, the split into the real spectrum, times the filter's (its conjugate
// with conj), the packing back, the inverse FFT and twiddle; in place.
// kspec: (D, n1, n2) as spec_row_spectrum_kernel leaves it. grid (cells, n1 /
// kRows).
template <int N2>
__global__ void __launch_bounds__(kThreads, 2)
spec_row_mul_kernel(float2* __restrict__ z, const float2* __restrict__ kspec, int D, int conj,
                    SpecShape s) {
  constexpr int kItems = RowBlock<N2>::kItems;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* buf = reinterpret_cast<float2*>(smem);
  const RowLines lines{row_ld(N2)};
  const SpecTables tw = make_tables(buf + RowBlock<N2>::kRows * row_ld(N2), N2, s);
  float2* zp = z + (size_t)blockIdx.x * s.N;
  const float2* kp = kspec + (size_t)(blockIdx.x % D) * s.N;
  load_slot_rows<N2>(buf, lines, 0, zp, s);
  __syncthreads();
  fft_lines<N2, false, RowBlock<N2>::kRows>(buf, tw.twM, lines);
  // each pair {k, N - k} is split, multiplied and packed in place by the
  // thread of its first element in buf
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const SpecPair p = spec_pair<N2>(threadIdx.x + it * kThreads, s);
    const int ie = lines.at(p.l, p.k2), ip = lines.at(p.lp, p.k2p);
    if (ip < ie) continue;
    const float2 w = tw2n(tw, p.k);
    float2 xk, xp;
    real_split(buf[ie], buf[ip], w, xk, xp);
    float2 kk = kp[(size_t)p.k1 * s.n2 + p.k2], kq;
    if (p.k == 0) {
      kq = make_float2(kk.y, 0.f);
      kk = make_float2(kk.x, 0.f);
    } else {
      kq = kp[(size_t)p.k1p * s.n2 + p.k2p];
    }
    const float2 yk = conj ? cmulc(xk, kk) : cmul(xk, kk);
    const float2 yp = conj ? cmulc(xp, kq) : cmul(xp, kq);
    buf[ie] = real_pack(yk, yp, w);
    if (ip != ie) buf[ip] = real_pack(yp, yk, make_float2(-w.x, w.y));   // w_2N^{N-k} = -conj(w)
  }
  __syncthreads();
  spec_row_inverse_store<N2>(buf, lines, tw, zp, s);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Every pass of one call, on its stream; the first error ends the call. Given
// k, the call first transforms it into kspec; else (k null) kspec holds it.
template <int N1, int N2, typename T>
int launch_conv(const T* u, const float* k, float2* kspec, const float* bias, T* y, float2* z,
                int B, int D, const SpecShape& s, int conj, cudaStream_t stream) {
  constexpr size_t col_smem = spec_col_smem<N1>(), row_smem = spec_row_smem<N2>(1);
  const int cells = B * D;
  const dim3 col_grid_k(D, s.n2 / kSpecCols), row_grid_k(D, s.n1 / RowBlock<N2>::kRows);
  const dim3 col_grid(cells, s.n2 / kSpecCols), row_grid(cells, s.n1 / RowBlock<N2>::kRows);
  cudaError_t err;
  if ((err = allow_smem(spec_col_fwd_kernel<N1, float>, col_smem)) ||
      (err = allow_smem(spec_col_fwd_kernel<N1, T>, col_smem)) ||
      (err = allow_smem(spec_col_inv_kernel<N1, T, T>, col_smem)) ||
      (err = allow_smem(spec_row_spectrum_kernel<N2>, row_smem)) ||
      (err = allow_smem(spec_row_mul_kernel<N2>, row_smem)))
    return (int)err;
  if (k != nullptr) {
    spec_col_fwd_kernel<N1, float><<<col_grid_k, kThreads, col_smem, stream>>>(k, kspec, s);
    if ((err = cudaGetLastError())) return (int)err;
    spec_row_spectrum_kernel<N2><<<row_grid_k, kThreads, row_smem, stream>>>(kspec, s);
    if ((err = cudaGetLastError())) return (int)err;
  }
  spec_col_fwd_kernel<N1, T><<<col_grid, kThreads, col_smem, stream>>>(u, z, s);
  if ((err = cudaGetLastError())) return (int)err;
  spec_row_mul_kernel<N2><<<row_grid, kThreads, row_smem, stream>>>(z, kspec, D, conj, s);
  if ((err = cudaGetLastError())) return (int)err;
  spec_col_inv_kernel<N1, T, T><<<col_grid, kThreads, col_smem, stream>>>(z, u, bias, y, D, s);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_conv(const T* u, const float* k, float2* kspec, const float* bias, T* y, float2* z,
                  int B, int D, const SpecShape& s, int conj, cudaStream_t st) {
  switch (s.log1 * 16 + s.log2) {
    case 7 * 16 + 6: return launch_conv<128, 64>(u, k, kspec, bias, y, z, B, D, s, conj, st);
    case 7 * 16 + 7: return launch_conv<128, 128>(u, k, kspec, bias, y, z, B, D, s, conj, st);
    case 8 * 16 + 7: return launch_conv<256, 128>(u, k, kspec, bias, y, z, B, D, s, conj, st);
    case 8 * 16 + 8: return launch_conv<256, 256>(u, k, kspec, bias, y, z, B, D, s, conj, st);
    case 9 * 16 + 8: return launch_conv<512, 256>(u, k, kspec, bias, y, z, B, D, s, conj, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace lcbi

// Bytes of scratch lcbi_spectral_conv needs (0 for a shape it does not take):
// u's planes, (B D, L) complex fp32.
extern "C" size_t lcbi_spectral_conv_workspace(int B, int D, int L) {
  lcbi::SpecShape s;
  if (B <= 0 || D <= 0 || !lcbi::spec_shape(L, &s)) return 0;
  return sizeof(float2) * (size_t)B * D * s.N;
}

// Bytes of a filter spectrum (D, L) complex fp32 (0 for a shape it does not
// take).
extern "C" size_t lcbi_spectral_conv_spectrum_bytes(int D, int L) {
  lcbi::SpecShape s;
  if (D <= 0 || !lcbi::spec_shape(L, &s)) return 0;
  return sizeof(float2) * (size_t)D * s.N;
}

// u, y: (B, D, L) contiguous in T (fp32 if is_bf16 == 0, else bf16); k: (D,
// L) fp32 or NULL; kspec: lcbi_spectral_conv_spectrum_bytes, the filter's
// spectrum, written from k first when k is given (else as an earlier call
// with k left it); bias: (D,) fp32 or NULL; ws:
// lcbi_spectral_conv_workspace bytes, 16-byte aligned. 8192 <= L <= 131072 a
// power of two, B D < 2^31. Returns cudaGetLastError() of the first launch
// that fails (or cudaErrorInvalidValue for a shape it does not take).
extern "C" int lcbi_spectral_conv(const void* u, const void* k, void* kspec, const void* bias,
                                  void* y, void* ws, int B, int D, int L, int conj, int is_bf16,
                                  void* stream) {
  (void)cudaGetLastError();
  lcbi::SpecShape s;
  if (B <= 0 || D <= 0 || (long long)B * D >= (1LL << 31) || !lcbi::spec_shape(L, &s))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kf = static_cast<const float*>(k);
  const float* bf = static_cast<const float*>(bias);
  float2* ks = static_cast<float2*>(kspec);
  float2* w = static_cast<float2*>(ws);
  if (is_bf16)
    return lcbi::dispatch_conv<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(u), kf, ks, bf,
                                              static_cast<__nv_bfloat16*>(y), w, B, D, s, conj,
                                              st);
  return lcbi::dispatch_conv<float>(static_cast<const float*>(u), kf, ks, bf,
                                    static_cast<float*>(y), w, B, D, s, conj, st);
}
