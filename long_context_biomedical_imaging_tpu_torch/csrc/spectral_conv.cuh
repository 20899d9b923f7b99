// Shared device code of the spectral causal convolution kernels (K6):
// spectral_conv.cu (y = causal(k * u) + bias u, or with conj the correlation
// that gives du) and spectral_conv_dk.cu (dk, summed over the batch).
//
// A cell (b, d) is one length-L sequence. Its causal convolution is the first
// L points of the cyclic convolution of length n = 2L of the zero-padded
// sequences, a product of their spectra. The length-n transform runs as a
// four-step FFT on the (n1, n2) view, n = n1 n2 (spec_shape: n1 = 2^ceil(e/2)
// >= n2, the TPU kernel's split), with j = j1 n2 + j2 and k = k1 + n1 k2:
//   1. column pass: per column j2, a length-n1 FFT over j1 (only rows
//      j1 < n1/2 hold data, so the pad is never read: the first stage is
//      folded into the load), then the twiddle w_n^{k1 j2}; written to a
//      global fp32 scratch, one (n1, n2) complex plane per cell;
//   2. row pass: per row, a length-n2 FFT over j2, which leaves the spectrum
//      X[k1 + n1 k2]; times the filter's spectrum (conjugated for the
//      correlation), the inverse row FFT and the inverse twiddle w_n^{-k1 j2};
//   3. inverse column pass: per column, the inverse length-n1 FFT over k1,
//      rows j1 < n1/2 only (the causal trim: the last stage computes half its
//      outputs), times 1/n.
// The forward FFTs are decimation in frequency (natural order in, bit-reversed
// out) and the inverse ones decimation in time (bit-reversed in, natural out):
// a spectrum lives in a fixed scrambled order (plane row p holds k1 =
// bitrev(p), column q holds k2 = bitrev(q)) that the inverse undoes, so no
// bit-reversal pass is ever paid, as in the TPU kernel. The filter spectrum
// comes from the same passes, in the same order. Every value is fp32: the
// radix-2 butterflies run in shared memory, the twiddles come from sincospif
// (exact arguments, n a power of two).
#pragma once

#include "common.cuh"

namespace lcbi {

constexpr int kSpecMinLen = 8192;      // SPECTRAL_MIN_LEN of the TPU kernel
constexpr int kSpecMaxLen = 131072;    // SPECTRAL_MAX_LEN
constexpr int kSpecCols = 16;          // columns of a block in the column passes
constexpr int kSpecRowElems = 2048;    // complex values of a block's rows in the row passes

struct SpecShape {
  int L, n, n1, n2, log1, log2;  // n = 2L = n1 n2, n1 = 2^log1 >= n2 = 2^log2
};

// The lengths the kernels take (the TPU kernel's spectral_supported: 8192 <=
// L <= 131072 and 2L a power of two) and their split (its _split).
inline bool spec_shape(int L, SpecShape* s) {
  if (L < kSpecMinLen || L > kSpecMaxLen || (L & (L - 1))) return false;
  int e = 0;
  while ((1 << e) < 2 * L) ++e;
  s->L = L;
  s->n = 2 * L;
  s->log1 = (e + 1) / 2;
  s->log2 = e - s->log1;
  s->n1 = 1 << s->log1;
  s->n2 = 1 << s->log2;
  return true;
}

inline int spec_rows(const SpecShape& s) { return kSpecRowElems / s.n2; }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// w_n^m = exp(-2 pi i m / n) for 0 <= m < n; two_over_n = 2 / n, a power of
// two, so m * two_over_n is exact.
__device__ __forceinline__ float2 twiddle(int m, float two_over_n) {
  float s, c;
  sincospif((float)m * two_over_n, &s, &c);
  return make_float2(c, -s);
}

__device__ __forceinline__ int bitrev(int p, int bits) { return (int)(__brev((unsigned)p) >> (32 - bits)); }

// tw[k] = w_N^k for k < N/2.
__device__ inline void make_table(float2* tw, int N) {
  const float t = 2.f / (float)N;
  for (int k = threadIdx.x; k < N / 2; k += kThreads) tw[k] = twiddle(k, t);
}

// In place, the forward FFT of `lines` lines of length N = 2^logN at buf +
// l * ld, decimation in frequency from span h0 down to 1 (h0 = N/2 for a whole
// transform): natural order in, bit-reversed order out. Ends synchronised.
__device__ inline void fft_dif(float2* buf, int ld, int lines, int logN, int h0,
                               const float2* tw) {
  const int half = 1 << (logN - 1);
  for (int h = h0; h >= 1; h >>= 1) {
    const int tstep = half / h;
    for (int t = threadIdx.x; t < lines * half; t += kThreads) {
      const int b = t & (half - 1), j = b & (h - 1);
      float2* x = buf + (size_t)(t >> (logN - 1)) * ld;
      const int i0 = ((b - j) << 1) + j;
      const float2 a = x[i0], c = x[i0 + h];
      x[i0] = cadd(a, c);
      x[i0 + h] = cmul(csub(a, c), tw[j * tstep]);
    }
    __syncthreads();
  }
}

// In place, the unscaled inverse FFT of the lines, decimation in time from
// span 1 up to h1 (h1 = N/2 for a whole transform): bit-reversed order in,
// natural order out. Ends synchronised.
__device__ inline void ifft_dit(float2* buf, int ld, int lines, int logN, int h1,
                                const float2* tw) {
  const int half = 1 << (logN - 1);
  for (int h = 1; h <= h1; h <<= 1) {
    const int tstep = half / h;
    for (int t = threadIdx.x; t < lines * half; t += kThreads) {
      const int b = t & (half - 1), j = b & (h - 1);
      float2* x = buf + (size_t)(t >> (logN - 1)) * ld;
      const int i0 = ((b - j) << 1) + j;
      const float2 a = x[i0], c = cmulc(x[i0 + h], tw[j * tstep]);
      x[i0] = cadd(a, c);
      x[i0 + h] = csub(a, c);
    }
    __syncthreads();
  }
}

// Shared memory of the passes, in bytes: a twiddle table and the lines (a
// column line padded by one value, so that the column-major loads and stores
// fall in distinct banks).
inline size_t spec_col_smem(const SpecShape& s) {
  return sizeof(float2) * (s.n1 / 2 + (size_t)kSpecCols * (s.n1 + 1));
}
inline size_t spec_row_smem(const SpecShape& s, int buffers) {
  return sizeof(float2) * (s.n2 / 2 + (size_t)buffers * kSpecRowElems);
}

// Column pass: x (cells, L) real in T -> z (cells, n1, n2) complex fp32, row p
// of a cell's plane holding k1 = bitrev(p), twiddled by w_n^{k1 j2}.
// grid (cells, n2 / kSpecCols).
template <typename T>
__global__ void __launch_bounds__(kThreads)
spec_col_fwd_kernel(const T* __restrict__ x, float2* __restrict__ z, SpecShape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n1 = s.n1, n2 = s.n2, n1h = s.n1 / 2, ld = s.n1 + 1;
  float2* tw = reinterpret_cast<float2*>(smem);
  float2* buf = tw + n1h;
  const size_t cell = blockIdx.x;
  const int c0 = blockIdx.y * kSpecCols;
  const T* xc = x + cell * (size_t)s.L;
  make_table(tw, n1);
  __syncthreads();
  // rows j1 < n1/2 and the first stage (span n1/2): the pad rows are zero, so
  // the pair is (x, x w^j1)
  for (int t = threadIdx.x; t < n1h * kSpecCols; t += kThreads) {
    const int j1 = t / kSpecCols, c = t % kSpecCols;
    const float v = to_f32(xc[(size_t)j1 * n2 + c0 + c]);
    float2* line = buf + c * ld;
    line[j1] = make_float2(v, 0.f);
    line[j1 + n1h] = make_float2(v * tw[j1].x, v * tw[j1].y);
  }
  __syncthreads();
  fft_dif(buf, ld, kSpecCols, s.log1, n1 / 4, tw);
  const float two_over_n = 2.f / (float)s.n;
  float2* zc = z + cell * (size_t)s.n;
  for (int t = threadIdx.x; t < n1 * kSpecCols; t += kThreads) {
    const int p = t / kSpecCols, c = t % kSpecCols;
    zc[(size_t)p * n2 + c0 + c] =
        cmul(buf[c * ld + p], twiddle(bitrev(p, s.log1) * (c0 + c), two_over_n));
  }
}

// Inverse column pass: z (cells, n1, n2) as the row pass leaves it -> out
// (cells, L) in OutT: the inverse over k1, rows j1 < n1/2, times 1/n, plus
// bias[cell % D] * x (x the call's input, read in InT) where bias is given.
// grid (cells, n2 / kSpecCols).
template <typename InT, typename OutT>
__global__ void __launch_bounds__(kThreads)
spec_col_inv_kernel(const float2* __restrict__ z, const InT* __restrict__ x,
                    const float* __restrict__ bias, OutT* __restrict__ out, int D, SpecShape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n1 = s.n1, n2 = s.n2, n1h = s.n1 / 2, ld = s.n1 + 1;
  float2* tw = reinterpret_cast<float2*>(smem);
  float2* buf = tw + n1h;
  const size_t cell = blockIdx.x;
  const int c0 = blockIdx.y * kSpecCols;
  const float2* zc = z + cell * (size_t)s.n;
  make_table(tw, n1);
  for (int t = threadIdx.x; t < n1 * kSpecCols; t += kThreads) {
    const int p = t / kSpecCols, c = t % kSpecCols;
    buf[c * ld + p] = zc[(size_t)p * n2 + c0 + c];
  }
  __syncthreads();
  ifft_dit(buf, ld, kSpecCols, s.log1, n1 / 4, tw);
  // the last stage (span n1/2) for outputs j1 < n1/2 only, real part
  const float inv_n = 1.f / (float)s.n;
  const float b = bias != nullptr ? bias[cell % D] : 0.f;
  for (int t = threadIdx.x; t < n1h * kSpecCols; t += kThreads) {
    const int j1 = t / kSpecCols, c = t % kSpecCols;
    const float2* line = buf + c * ld;
    const float2 hi = line[j1 + n1h], w = tw[j1];
    const float v = line[j1].x + hi.x * w.x + hi.y * w.y;
    const size_t idx = cell * (size_t)s.L + (size_t)j1 * n2 + c0 + c;
    float y = v * inv_n;
    if (bias != nullptr) y += b * to_f32(x[idx]);
    out[idx] = from_f32<OutT>(y);
  }
}

// Row pass, forward only: each row of the planes -> its length-n2 FFT (the
// spectrum in scrambled order), in place. grid (cells, n1 / rows).
__global__ void __launch_bounds__(kThreads)
spec_row_fwd_kernel(float2* __restrict__ z, SpecShape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n2 = s.n2, rows = kSpecRowElems / s.n2;
  float2* tw = reinterpret_cast<float2*>(smem);
  float2* buf = tw + n2 / 2;
  float2* zp = z + (size_t)blockIdx.x * s.n + (size_t)blockIdx.y * rows * n2;
  make_table(tw, n2);
  for (int t = threadIdx.x; t < rows * n2; t += kThreads) buf[t] = zp[t];
  __syncthreads();
  fft_dif(buf, n2, rows, s.log2, n2 / 2, tw);
  for (int t = threadIdx.x; t < rows * n2; t += kThreads) zp[t] = buf[t];
}

// The inverse row FFT of rows [p0, p0 + rows) of a plane in buf (scrambled
// order in), then the inverse twiddle w_n^{-k1 j2}, stored to zp.
__device__ inline void spec_row_inverse_store(float2* buf, const float2* tw, int p0,
                                              float2* __restrict__ zp, const SpecShape& s) {
  const int n2 = s.n2, rows = kSpecRowElems / s.n2;
  ifft_dit(buf, n2, rows, s.log2, n2 / 2, tw);
  const float two_over_n = 2.f / (float)s.n;
  for (int t = threadIdx.x; t < rows * n2; t += kThreads) {
    const int k1 = bitrev(p0 + t / n2, s.log1);
    zp[t] = cmulc(buf[t], twiddle(k1 * (t % n2), two_over_n));
  }
}

}  // namespace lcbi
