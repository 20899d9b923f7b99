// Shared device code of the spectral causal convolution kernels (K6):
// spectral_conv.cu (y = causal(k * u) + bias u, or with conj the correlation
// that gives du) and spectral_conv_dk.cu (dk, summed over the batch).
//
// A cell (b, d) is one real length-L sequence x. Its causal convolution is the
// first L points of the cyclic convolution of length n = 2L of the zero-padded
// sequences, a product of their real spectra X[k], k = 0 .. L. The transform
// is the half-length complex one: z[j] = x[2j] + i x[2j+1] (j < N = L; zero
// for j >= N/2, the pad), Z = FFT_N(z), and X[k] = A + w B, X[N-k] = conj(A -
// w B) with A = (Z[k] + conj Z[N-k]) / 2, B = (Z[k] - conj Z[N-k]) / 2i and w
// = w_2N^k. The inverse packs a product spectrum Y back the same way, Zy[k] =
// (Y[k] + conj Y[N-k]) / 2 + i conj(w) (Y[k] - conj Y[N-k]) / 2, and
// IFFT_N(Zy) / N = y[2j] + i y[2j+1]. A spectrum holds N complex values per
// cell, X[0] and X[N] (both real) sharing element 0.
//
// FFT_N runs as a four-step FFT on the (n1, n2) view, N = n1 n2 (n1 =
// 2^ceil(e/2) >= n2), j = j1 n2 + j2 and k = k1 + n1 k2, in three passes over
// a global fp32 plane per cell:
//   1. column pass (spec_col_fwd_kernel): per column j2, the length-n1 FFT
//      over j1 (rows j1 >= n1/2 are the pad: zeros, never read), times w_N^{k1
//      j2}: plane[k1][j2];
//   2. row pass: per row k1, the length-n2 FFT over j2, which leaves Z[k1 +
//      n1 k2] at plane[k1][k2], in natural order. Its partner Z[N-k] lies in
//      row n1 - k1 (row 0 and row n1/2 pair with themselves), so a block holds
//      rows in pairs (slot q: rows q and n1 - q; slot 0: rows 0 and n1/2) and
//      splits, multiplies and packs in registers; then the inverse row FFT and
//      w_N^{-k1 j2};
//   3. inverse column pass (spec_col_inv_kernel): per column, the inverse
//      length-n1 FFT over k1, rows j1 < n1/2 only (the causal trim), times
//      1/N, unpacked into y[2j], y[2j+1].
// Each FFT runs in shared memory as Stockham passes (natural order in and out)
// of radix 8 or 16: a thread loads R points of a line, twiddles them, takes
// their DFT in registers (radix-2 butterflies on compile-time twiddles) and
// writes them back; one barrier pair per pass, two or three passes per line.
// Twiddles come from tables built per block: w_M^m for the passes, and w_2N^q
// as the product of two tables of 512 entries (w_2N^{q mod 512} and
// w_2N^{512 floor(q / 512)}). Every value is fp32.
#pragma once

#include "common.cuh"

namespace lcbi {

constexpr int kSpecMinLen = 8192;      // SPECTRAL_MIN_LEN of the TPU kernel
constexpr int kSpecMaxLen = 131072;    // SPECTRAL_MAX_LEN
constexpr int kSpecCols = 16;          // columns of a block in the column passes
constexpr int kSpecRowElems = 4096;    // complex values of a block's rows in the row passes
constexpr int kTwLo = 512;             // entries of each w_2N table

struct SpecShape {
  int L, N, n1, n2, log1, log2;  // N = L = n1 n2, n1 = 2^log1 >= n2 = 2^log2
};

// The lengths the kernels take (the TPU kernel's spectral_supported: 8192 <=
// L <= 131072 and L a power of two) and the split of the half-length
// transform N = L.
inline bool spec_shape(int L, SpecShape* s) {
  if (L < kSpecMinLen || L > kSpecMaxLen || (L & (L - 1))) return false;
  int e = 0;
  while ((1 << e) < L) ++e;
  s->L = L;
  s->N = L;
  s->log1 = (e + 1) / 2;
  s->log2 = e - s->log1;
  s->n1 = 1 << s->log1;
  s->n2 = 1 << s->log2;
  return true;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}
__device__ __forceinline__ float2 conjf2(float2 a) { return make_float2(a.x, -a.y); }

// w_n^m = exp(-2 pi i m / n) for 0 <= m < n; two_over_n = 2 / n, a power of
// two, so m * two_over_n is exact.
__device__ __forceinline__ float2 twiddle(int m, float two_over_n) {
  float s, c;
  sincospif((float)m * two_over_n, &s, &c);
  return make_float2(c, -s);
}

// cos and sin of 2 pi e / 16, for the butterflies' compile-time twiddles.
__device__ __forceinline__ constexpr float cos16(int e) {
  return e == 0 ? 1.f : e == 1 ? 0.92387953251128674f : e == 2 ? 0.70710678118654752f
       : e == 3 ? 0.38268343236508977f : e == 4 ? 0.f : e == 5 ? -0.38268343236508977f
       : e == 6 ? -0.70710678118654752f : -0.92387953251128674f;
}
__device__ __forceinline__ constexpr float sin16(int e) { return cos16(e < 4 ? 4 - e : e - 4); }

// b * w_16^E (forward, exp(-2 pi i E / 16)) or b * conj(w_16^E) (INV), E < 8.
template <bool INV, int E>
__device__ __forceinline__ float2 rot16(float2 b) {
  if constexpr (E == 0) {
    return b;
  } else if constexpr (E == 4) {
    return INV ? make_float2(-b.y, b.x) : make_float2(b.y, -b.x);
  } else {
    const float c = cos16(E), s = INV ? -sin16(E) : sin16(E);
    return make_float2(b.x * c + b.y * s, b.y * c - b.x * s);
  }
}

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }
__host__ __device__ constexpr int brev_c(int i, int bits) {
  return bits == 0 ? 0 : ((i & 1) << (bits - 1)) | brev_c(i >> 1, bits - 1);
}

// The DFT of R points in registers, natural order in and out: the bit
// reversal as register renaming, then radix-2 decimation in time. Every
// register index is a template constant (unrolled by recursion), so the
// points never leave the registers.
template <int R, int I>
__device__ __forceinline__ void bitrev_regs(float2 (&v)[R]) {
  if constexpr (I < R) {
    constexpr int r = brev_c(I, ilog2(R));
    if constexpr (I < r) {
      const float2 t = v[I];
      v[I] = v[r];
      v[r] = t;
    }
    bitrev_regs<R, I + 1>(v);
  }
}
// Butterfly IDX (of R / 2) of the stage of span H.
template <int R, bool INV, int H, int IDX>
__device__ __forceinline__ void butterflies(float2 (&v)[R]) {
  if constexpr (IDX < R / 2) {
    constexpr int j = IDX % H, i = (IDX / H) * 2 * H + j;
    const float2 b = rot16<INV, j * (16 / (2 * H))>(v[i + H]);
    v[i + H] = csub(v[i], b);
    v[i] = cadd(v[i], b);
    butterflies<R, INV, H, IDX + 1>(v);
  }
}
template <int R, bool INV, int H>
__device__ __forceinline__ void dit_stages(float2 (&v)[R]) {
  if constexpr (H < R) {
    butterflies<R, INV, H, 0>(v);
    dit_stages<R, INV, 2 * H>(v);
  }
}
template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  bitrev_regs<R, 0>(v);
  dit_stages<R, INV, 1>(v);
}

// Lines in shared memory. Column passes: kSpecCols lines, element i of line
// c at i * kSpecCols + c (a warp's accesses are neighbouring columns of one
// element). Row passes: line l at l * ld, element i at i + i / 16 (the pad
// spreads a radix pass's strided stores over the banks).
struct ColLines {
  __device__ __forceinline__ void item(int w, int /*Q*/, int& line, int& j) const {
    line = w % kSpecCols;
    j = w / kSpecCols;
  }
  __device__ __forceinline__ int at(int line, int i) const { return i * kSpecCols + line; }
};
struct RowLines {
  int ld;
  __device__ __forceinline__ void item(int w, int Q, int& line, int& j) const {
    line = w / Q;
    j = w % Q;
  }
  __device__ __forceinline__ int at(int line, int i) const { return line * ld + i + (i >> 4); }
};
__host__ __device__ constexpr int row_ld(int n2) { return n2 + n2 / 16; }

// One Stockham pass of radix R over LINES lines of length M in buf: stride NS
// (the product of the earlier passes' radices). Ends synchronised.
template <int M, int R, int NS, bool INV, int LINES, class Lines>
__device__ __forceinline__ void fft_pass(float2* buf, const float2* twM, const Lines& lines) {
  constexpr int Q = M / R, TOTAL = LINES * Q, ITEMS = (TOTAL + kThreads - 1) / kThreads;
  float2 v[ITEMS][R];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int w = threadIdx.x + it * kThreads;
    if (TOTAL % kThreads == 0 || w < TOTAL) {
      int line, j;
      lines.item(w, Q, line, j);
#pragma unroll
      for (int r = 0; r < R; ++r) v[it][r] = buf[lines.at(line, j + r * Q)];
      if (NS > 1) {
        const int jn = j & (NS - 1);
#pragma unroll
        for (int r = 1; r < R; ++r) {
          const float2 t = twM[jn * r * (M / (NS * R))];
          v[it][r] = INV ? cmulc(v[it][r], t) : cmul(v[it][r], t);
        }
      }
      dft<R, INV>(v[it]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int w = threadIdx.x + it * kThreads;
    if (TOTAL % kThreads == 0 || w < TOTAL) {
      int line, j;
      lines.item(w, Q, line, j);
      const int jn = j & (NS - 1), base = (j - jn) * R + jn;
#pragma unroll
      for (int r = 0; r < R; ++r) buf[lines.at(line, base + r * NS)] = v[it][r];
    }
  }
  __syncthreads();
}

// The FFT (INV: unscaled inverse) of LINES lines of length M in buf, natural
// order in and out: radix 16 x 16 (256), 16 x 8 (128), 8 x 8 (64) or 8 x 8 x
// 8 (512). The caller syncs before. Ends synchronised.
template <int M, bool INV, int LINES, class Lines>
__device__ __forceinline__ void fft_lines(float2* buf, const float2* twM, const Lines& lines) {
  static_assert(M == 64 || M == 128 || M == 256 || M == 512, "line length");
  if constexpr (M == 256) {
    fft_pass<M, 16, 1, INV, LINES>(buf, twM, lines);
    fft_pass<M, 16, 16, INV, LINES>(buf, twM, lines);
  } else if constexpr (M == 128) {
    fft_pass<M, 16, 1, INV, LINES>(buf, twM, lines);
    fft_pass<M, 8, 16, INV, LINES>(buf, twM, lines);
  } else if constexpr (M == 64) {
    fft_pass<M, 8, 1, INV, LINES>(buf, twM, lines);
    fft_pass<M, 8, 8, INV, LINES>(buf, twM, lines);
  } else {
    fft_pass<M, 8, 1, INV, LINES>(buf, twM, lines);
    fft_pass<M, 8, 8, INV, LINES>(buf, twM, lines);
    fft_pass<M, 8, 64, INV, LINES>(buf, twM, lines);
  }
}

// A block's twiddle tables: w_M^m (m < M) for its passes and the two w_2N
// tables. Not synchronised.
struct SpecTables {
  float2* twM;
  float2* lo;
  float2* hi;
};
__device__ __forceinline__ SpecTables make_tables(float2* at, int M, const SpecShape& s) {
  SpecTables t{at, at + M, at + M + kTwLo};
  const float two_over_m = 2.f / (float)M, inv_n = 1.f / (float)s.N;
  for (int m = threadIdx.x; m < M; m += kThreads) t.twM[m] = twiddle(m, two_over_m);
  for (int m = threadIdx.x; m < kTwLo; m += kThreads) t.lo[m] = twiddle(m, inv_n);
  for (int m = threadIdx.x; m < 2 * s.N / kTwLo; m += kThreads) t.hi[m] = twiddle(m * kTwLo, inv_n);
  return t;
}
__host__ __device__ constexpr size_t tables_bytes(int M) {
  return sizeof(float2) * (size_t)(M + 2 * kTwLo);
}
// w_2N^q, 0 <= q < 2N.
__device__ __forceinline__ float2 tw2n(const SpecTables& t, int q) {
  return cmul(t.lo[q & (kTwLo - 1)], t.hi[q / kTwLo]);
}

// Column pass: x (cells, L) real in T -> z (cells, n1, n2) complex fp32, the
// column FFTs of the packed pairs times w_N^{k1 j2}. grid (cells, n2 /
// kSpecCols).
template <int N1, typename T>
__global__ void __launch_bounds__(kThreads)
spec_col_fwd_kernel(const T* __restrict__ x, float2* __restrict__ z, SpecShape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* buf = reinterpret_cast<float2*>(smem);
  const SpecTables tw = make_tables(buf + N1 * kSpecCols, N1, s);
  const int n2 = s.n2, c0 = blockIdx.y * kSpecCols;
  const size_t cell = blockIdx.x;
  const T* xc = x + cell * (size_t)s.L;
  for (int t = threadIdx.x; t < N1 * kSpecCols; t += kThreads) {
    const int j1 = t / kSpecCols, c = t % kSpecCols;
    float2 v = make_float2(0.f, 0.f);
    if (j1 < N1 / 2) {
      const size_t j = (size_t)j1 * n2 + c0 + c;
      v = make_float2(to_f32(xc[2 * j]), to_f32(xc[2 * j + 1]));
    }
    buf[t] = v;
  }
  __syncthreads();
  fft_lines<N1, false, kSpecCols>(buf, tw.twM, ColLines{});
  float2* zc = z + cell * (size_t)s.N;
  for (int t = threadIdx.x; t < N1 * kSpecCols; t += kThreads) {
    const int k1 = t / kSpecCols, c = t % kSpecCols;
    zc[(size_t)k1 * n2 + c0 + c] = cmul(buf[t], tw2n(tw, 2 * k1 * (c0 + c)));
  }
}

// Inverse column pass: z (cells, n1, n2) as the row pass leaves it -> out
// (cells, L) in OutT: the inverse over k1, rows j1 < n1/2, times 1/N,
// unpacked, plus bias[cell % D] * x (x the call's input, read in InT) where
// bias is given. grid (cells, n2 / kSpecCols).
template <int N1, typename InT, typename OutT>
__global__ void __launch_bounds__(kThreads)
spec_col_inv_kernel(const float2* __restrict__ z, const InT* __restrict__ x,
                    const float* __restrict__ bias, OutT* __restrict__ out, int D, SpecShape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* buf = reinterpret_cast<float2*>(smem);
  const SpecTables tw = make_tables(buf + N1 * kSpecCols, N1, s);
  const int n2 = s.n2, c0 = blockIdx.y * kSpecCols;
  const size_t cell = blockIdx.x;
  const float2* zc = z + cell * (size_t)s.N;
  for (int t = threadIdx.x; t < N1 * kSpecCols; t += kThreads) {
    const int k1 = t / kSpecCols, c = t % kSpecCols;
    buf[t] = zc[(size_t)k1 * n2 + c0 + c];
  }
  __syncthreads();
  fft_lines<N1, true, kSpecCols>(buf, tw.twM, ColLines{});
  const float inv_n = 1.f / (float)s.N;
  const float b = bias != nullptr ? bias[cell % D] : 0.f;
  for (int t = threadIdx.x; t < (N1 / 2) * kSpecCols; t += kThreads) {
    const int j1 = t / kSpecCols, c = t % kSpecCols;
    const size_t idx = cell * (size_t)s.L + 2 * ((size_t)j1 * n2 + c0 + c);
    float y0 = buf[t].x * inv_n, y1 = buf[t].y * inv_n;
    if (bias != nullptr) {
      y0 += b * to_f32(x[idx]);
      y1 += b * to_f32(x[idx + 1]);
    }
    out[idx] = from_f32<OutT>(y0);
    out[idx + 1] = from_f32<OutT>(y1);
  }
}

// The row passes hold kSpecRowElems / N2 rows in slots of two: local line l
// of block y holds row spec_row_of(...) of the plane.
template <int N2> struct RowBlock {
  static constexpr int kRows = kSpecRowElems / N2;
  static constexpr int kSlots = kRows / 2;
  static constexpr int kItems = kSpecRowElems / kThreads;   // elements per thread
};
__device__ __forceinline__ int spec_row_of(int slot, int h, int n1) {
  return slot == 0 ? (h ? n1 / 2 : 0) : (h ? n1 - slot : slot);
}

// Load the block's rows of a plane zp (n1, n2) into line l0 + l of buf.
template <int N2>
__device__ __forceinline__ void load_slot_rows(float2* buf, const RowLines& lines, int l0,
                                               const float2* __restrict__ zp, const SpecShape& s) {
  constexpr int kRows = RowBlock<N2>::kRows;
  for (int t = threadIdx.x; t < kRows * N2; t += kThreads) {
    const int l = t / N2, i = t % N2;
    const int k1 = spec_row_of(blockIdx.y * RowBlock<N2>::kSlots + l / 2, l & 1, s.n1);
    buf[lines.at(l0 + l, i)] = zp[(size_t)k1 * s.n2 + i];
  }
}

// The pair of element e (local line l, column k2) of the block: its line and
// column, its row k1 and its frequency k.
struct SpecPair {
  int l, k2, lp, k2p, k1, k1p, k;
};
template <int N2>
__device__ __forceinline__ SpecPair spec_pair(int e, const SpecShape& s) {
  SpecPair p;
  p.l = e / N2;
  p.k2 = e % N2;
  const int slot = blockIdx.y * RowBlock<N2>::kSlots + p.l / 2, h = p.l & 1;
  p.k1 = spec_row_of(slot, h, s.n1);
  p.lp = slot == 0 ? p.l : p.l ^ 1;
  p.k2p = slot == 0 && h == 0 ? (N2 - p.k2) & (N2 - 1) : N2 - 1 - p.k2;
  p.k1p = spec_row_of(slot, slot == 0 ? h : h ^ 1, s.n1);
  p.k = p.k1 + s.n1 * p.k2;
  return p;
}

// The real spectrum at k and N - k from the packed Z[k] and Z[N - k]: for k
// = 0, X[0] and X[N] (both real) as the real parts.
__device__ __forceinline__ void real_split(float2 zk, float2 zp, float2 w, float2& xk,
                                           float2& xp) {
  const float2 a = make_float2(0.5f * (zk.x + zp.x), 0.5f * (zk.y - zp.y));   // (Z[k] + conj Z[p]) / 2
  const float2 b = make_float2(0.5f * (zk.y + zp.y), -0.5f * (zk.x - zp.x));  // (Z[k] - conj Z[p]) / 2i
  const float2 wb = cmul(w, b);
  xk = cadd(a, wb);
  xp = conjf2(csub(a, wb));
}

// Zy[k] from the product spectrum at k and N - k.
__device__ __forceinline__ float2 real_pack(float2 yk, float2 yp, float2 w) {
  const float2 e = make_float2(0.5f * (yk.x + yp.x), 0.5f * (yk.y - yp.y));
  const float2 o = cmulc(make_float2(0.5f * (yk.x - yp.x), 0.5f * (yk.y + yp.y)), w);
  return make_float2(e.x - o.y, e.y + o.x);   // e + i o
}

// The inverse row FFT of the block's rows in buf (lines [0, kRows)), then
// w_N^{-k1 j2}, stored to the plane zp.
template <int N2>
__device__ __forceinline__ void spec_row_inverse_store(float2* buf, const RowLines& lines,
                                                       const SpecTables& tw,
                                                       float2* __restrict__ zp,
                                                       const SpecShape& s) {
  constexpr int kRows = RowBlock<N2>::kRows;
  fft_lines<N2, true, kRows>(buf, tw.twM, lines);
  for (int t = threadIdx.x; t < kRows * N2; t += kThreads) {
    const int l = t / N2, j2 = t % N2;
    const int k1 = spec_row_of(blockIdx.y * RowBlock<N2>::kSlots + l / 2, l & 1, s.n1);
    zp[(size_t)k1 * s.n2 + j2] = cmulc(buf[lines.at(l, j2)], tw2n(tw, 2 * k1 * j2));
  }
}

// Shared memory of the passes, in bytes.
template <int N1> constexpr size_t spec_col_smem() {
  return sizeof(float2) * (size_t)N1 * kSpecCols + tables_bytes(N1);
}
template <int N2> constexpr size_t spec_row_smem(int buffers) {
  return sizeof(float2) * (size_t)buffers * RowBlock<N2>::kRows * row_ld(N2) + tables_bytes(N2);
}

// Row pass of a filter: the plane of k's column pass -> its real spectrum
// (stored as spec_pair lays it out), in place. grid (D, n1 / kRows).
template <int N2>
__global__ void __launch_bounds__(kThreads)
spec_row_spectrum_kernel(float2* __restrict__ kz, SpecShape s) {
  constexpr int kItems = RowBlock<N2>::kItems;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* buf = reinterpret_cast<float2*>(smem);
  const RowLines lines{row_ld(N2)};
  const SpecTables tw = make_tables(buf + RowBlock<N2>::kRows * row_ld(N2), N2, s);
  float2* zp = kz + (size_t)blockIdx.x * s.N;
  load_slot_rows<N2>(buf, lines, 0, zp, s);
  __syncthreads();
  fft_lines<N2, false, RowBlock<N2>::kRows>(buf, tw.twM, lines);
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const SpecPair p = spec_pair<N2>(threadIdx.x + it * kThreads, s);
    float2 xk, xp;
    real_split(buf[lines.at(p.l, p.k2)], buf[lines.at(p.lp, p.k2p)], tw2n(tw, p.k), xk, xp);
    zp[(size_t)p.k1 * s.n2 + p.k2] = p.k == 0 ? make_float2(xk.x, xp.x) : xk;
  }
}

}  // namespace lcbi
