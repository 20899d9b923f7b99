// Spectral causal convolution (K6), the filter gradient: dk[d, tau] =
// sum_b sum_t g[b, d, t] u[b, d, t - tau], (D, L) fp32, for the cotangent g
// and input u, both (B, D, L); the cross-correlation of g and u as
// iF(sum_b G conj(U)) of their real spectra through the passes of
// spectral_conv.cuh, all fp32. dbias is dk[:, 0] (the caller slices it).
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/spectral_conv.py
// _dk_kernel (launched by _dk_call), whose sequential batch axis accumulates
// the spectra in VMEM. Here one block owns a channel's pairs of rows and sums
// the batch's products in registers in a fixed order (b ascending) before the
// inverse: no atomics, and two launches give the same bits.
//
// What bounds it on the H100: 2.5 n log2 n fp32 operations per real transform
// of n = 2L points, two forward transforms per cell and one inverse per
// channel, against g and u read and dk written once: at (1, 384, 65536) some
// 0.10 ms of operations (chip_smoke.py kernel_bounds). The design: the column
// passes of g and u into a global fp32 scratch of 2 B D L complex values
// (half-length real transforms), a row pass that transforms both, splits the
// real spectra, multiplies and sums over the batch, packs and inverts, and the
// inverse column pass.
#include "spectral_conv.cuh"

namespace lcbi {

// Row pass of dk: per channel d and the block's pairs of rows, the sum over b
// of G conj(U) of the cells (b, d), b ascending (for k = 0 the real X[0] and
// X[N] products side by side); then the packing, the inverse row FFT and
// twiddle, written over zg's cell (0, d). grid (D, n1 / kRows).
template <int N2>
__global__ void __launch_bounds__(kThreads)
spec_row_dk_kernel(float2* __restrict__ zg, const float2* __restrict__ zu, int B, int D,
                   SpecShape s) {
  constexpr int kRows = RowBlock<N2>::kRows, kItems = RowBlock<N2>::kItems;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* buf = reinterpret_cast<float2*>(smem);   // g's rows (lines [0, kRows)), then u's
  const RowLines lines{row_ld(N2)};
  const SpecTables tw = make_tables(buf + 2 * kRows * row_ld(N2), N2, s);
  float2 acc[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) acc[it] = make_float2(0.f, 0.f);
  for (int b = 0; b < B; ++b) {
    const size_t cell = (size_t)b * D + blockIdx.x;
    load_slot_rows<N2>(buf, lines, 0, zg + cell * s.N, s);
    load_slot_rows<N2>(buf, lines, kRows, zu + cell * s.N, s);
    __syncthreads();
    fft_lines<N2, false, 2 * kRows>(buf, tw.twM, lines);
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const SpecPair p = spec_pair<N2>(threadIdx.x + it * kThreads, s);
      const float2 w = tw2n(tw, p.k);
      float2 gk, gp, uk, up;
      real_split(buf[lines.at(p.l, p.k2)], buf[lines.at(p.lp, p.k2p)], w, gk, gp);
      real_split(buf[lines.at(kRows + p.l, p.k2)], buf[lines.at(kRows + p.lp, p.k2p)], w, uk, up);
      acc[it] = cadd(acc[it], p.k == 0 ? make_float2(gk.x * uk.x, gp.x * up.x) : cmulc(gk, uk));
    }
    __syncthreads();   // the next cell's rows overwrite buf
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int e = threadIdx.x + it * kThreads;
    buf[lines.at(e / N2, e % N2)] = acc[it];
  }
  __syncthreads();
  // each pair {k, N - k} packed in place by the thread of its first element
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const SpecPair p = spec_pair<N2>(threadIdx.x + it * kThreads, s);
    const int ie = lines.at(p.l, p.k2), ip = lines.at(p.lp, p.k2p);
    if (ip < ie) continue;
    const float2 pk = buf[ie];
    if (p.k == 0) {
      buf[ie] = real_pack(make_float2(pk.x, 0.f), make_float2(pk.y, 0.f), make_float2(1.f, 0.f));
      continue;
    }
    const float2 pp = buf[ip], w = tw2n(tw, p.k);
    buf[ie] = real_pack(pk, pp, w);
    if (ip != ie) buf[ip] = real_pack(pp, pk, make_float2(-w.x, w.y));   // w_2N^{N-k} = -conj(w)
  }
  __syncthreads();
  spec_row_inverse_store<N2>(buf, lines, tw, zg + (size_t)blockIdx.x * s.N, s);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int N1, int N2, typename T>
int launch_dk(const T* g, const T* u, float* dk, float2* ws, int B, int D, const SpecShape& s,
              cudaStream_t stream) {
  constexpr size_t col_smem = spec_col_smem<N1>(), row_smem = spec_row_smem<N2>(2);
  const int cells = B * D;
  float2* zg = ws;                           // (B D, n1, n2)
  float2* zu = ws + (size_t)cells * s.N;     // (B D, n1, n2)
  const dim3 col_grid(cells, s.n2 / kSpecCols), row_grid(D, s.n1 / RowBlock<N2>::kRows);
  const dim3 out_grid(D, s.n2 / kSpecCols);
  cudaError_t err;
  if ((err = allow_smem(spec_col_fwd_kernel<N1, T>, col_smem)) ||
      (err = allow_smem(spec_col_inv_kernel<N1, float, float>, col_smem)) ||
      (err = allow_smem(spec_row_dk_kernel<N2>, row_smem)))
    return (int)err;
  spec_col_fwd_kernel<N1, T><<<col_grid, kThreads, col_smem, stream>>>(g, zg, s);
  if ((err = cudaGetLastError())) return (int)err;
  spec_col_fwd_kernel<N1, T><<<col_grid, kThreads, col_smem, stream>>>(u, zu, s);
  if ((err = cudaGetLastError())) return (int)err;
  spec_row_dk_kernel<N2><<<row_grid, kThreads, row_smem, stream>>>(zg, zu, B, D, s);
  if ((err = cudaGetLastError())) return (int)err;
  spec_col_inv_kernel<N1, float, float><<<out_grid, kThreads, col_smem, stream>>>(
      zg, nullptr, nullptr, dk, D, s);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dk(const T* g, const T* u, float* dk, float2* ws, int B, int D, const SpecShape& s,
                cudaStream_t st) {
  switch (s.log1 * 16 + s.log2) {
    case 7 * 16 + 6: return launch_dk<128, 64>(g, u, dk, ws, B, D, s, st);
    case 7 * 16 + 7: return launch_dk<128, 128>(g, u, dk, ws, B, D, s, st);
    case 8 * 16 + 7: return launch_dk<256, 128>(g, u, dk, ws, B, D, s, st);
    case 8 * 16 + 8: return launch_dk<256, 256>(g, u, dk, ws, B, D, s, st);
    case 9 * 16 + 8: return launch_dk<512, 256>(g, u, dk, ws, B, D, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace lcbi

// Bytes of scratch lcbi_spectral_conv_dk needs (0 for a shape it does not take).
extern "C" size_t lcbi_spectral_conv_dk_workspace(int B, int D, int L) {
  lcbi::SpecShape s;
  if (B <= 0 || D <= 0 || !lcbi::spec_shape(L, &s)) return 0;
  return sizeof(float2) * 2 * (size_t)B * D * s.N;
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
    return lcbi::dispatch_dk<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(g),
                                            static_cast<const __nv_bfloat16*>(u), out, w, B, D, s,
                                            st);
  return lcbi::dispatch_dk<float>(static_cast<const float*>(g), static_cast<const float*>(u), out,
                                  w, B, D, s, st);
}
