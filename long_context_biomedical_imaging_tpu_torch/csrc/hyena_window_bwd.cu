// Fused Hyena window mixer, backward, for windows of V <= 64 tokens:
//     out = [x +] out_proj(x2 * longconv(x1 * v)),  [x1 | x2 | v] = shortconv(in_proj([LN](x)))
//     -> dx, [d ln_g, d ln_b,] dwin, dbin, dws, dbs, dkl, dwo, dbo given do = d out
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/hyena_window.py
// _make_bwd_kernel (launched by _bwd_impl, the custom VJP of _mixer_core and
// _mixer_core_ln, entry hyena_window_mixer).
//
// What bounds it on the H100: the projections' products (the two forward
// ones recomputed, dv2, dwo, dwin, dy: 22*T*C^2 FLOPs for T tokens) against
// 6*T*C bytes of x, do in and dx out (bf16), plus 4*C^2 fp32 of projection
// gradients that the TPU kernel sums in place over its sequential grid.
//
// The design, for Hopper:
//   - The weight gradients leave the tile loop (no per-tile read-modify-write
//     of 4 C^2 fp32 slot floats in device memory). The kernel writes the
//     operands of dwin = y^T dz and dwo = v2^T do as streams in T, rounded
//     where the TPU kernel rounds them (y, the LN'd rows, only with the
//     folded LN: without it y is x itself; v2; dz), and the split-K kernel of
//     wgrad.cuh (mma_gemm.cuh's, shared with K8, K2 and K4) contracts them in
//     the same call: fp32 partials per split, summed in a fixed order.
//   - Weights come through shared memory: per channel chunk, slices of
//     win[:, chunk columns] and wo[chunk rows, :] (64 deep; 32 in fp32) for
//     z and dv2, and of win[:, chunk columns]^T (as many output columns) for
//     dy, with the tails past C zeroed, through two buffers: the next
//     slice's cp.async copies run while this slice's products do. The
//     weights, taps and biases stay at the true C: the wrapper passes them
//     as they are, with no padded copy.
//   - The conv chain of a (window, channel) runs in registers for the ptx
//     windows (V = 16 and the models' 5 short taps, both compile-time, every
//     loop unrolled, no dependent shared-memory loads); any other window runs
//     it in passes over (row, channel) items with a barrier between them.
//     Both sum every term in the same order.
// The small gradients (taps, the conv and out biases, LN) go to each block's
// own fp32 slot of a persistent grid, summed over the blocks by
// reduce_slots_kernel in a fixed order. No atomics: two launches give the
// same bits. Products run on the tensor cores (WMMA 16x16x16 from shared
// memory, fp32 sums) in bf16 and as fp32 FMA loops in fp32 (common.cuh).
//
// A tile is wb whole windows (wb * V rows, padded to a multiple of 16; wb =
// 64 / V, halved until the tile fits in shared memory). Operands of every
// product are rounded to T where the TPU kernel rounds them (y, v2, dz, do),
// everything else is fp32. Taps arrive prepared by the wrapper, as for the
// forward: ws (K, 3C) in causal tap order, kl (V, C) with the skip weight in
// tap 0; the gradients are those of the prepared taps.
#include "flash_attention.cuh"   // cp.async
#include "wgrad.cuh"

namespace lcbi {

constexpr int kChanChunk = 32;
constexpr int kMaxWindow = 64;
constexpr int kW3 = 3 * kChanChunk;
// Depth of a staged slice of win or wo, and output columns of a staged slice
// of win^T: 64 in bf16, 32 in fp32 (whose tiles take twice the bytes).
template <typename T> __host__ __device__ constexpr int slice_rows() {
  return sizeof(T) == 2 ? 64 : 32;
}
constexpr int kLdZ = kW3 + 4;           // fp32 (R, 96) tiles
constexpr int kLdC = kChanChunk + 4;    // fp32 (R, 32) tiles
constexpr int kLdV = kChanChunk + 8;    // T (R, 32)
constexpr int kLdD = kW3 + 8;           // T (R, 96), and the staged win slices' rows

struct HyenaBwdLayout {
  int cs, lds, lddy;
  size_t off_dos, off_dy, off_z, off_zc, off_g, off_vl, off_dv2, off_v2, off_dz, off_w, wbuf,
      wo_in, off_wsp, off_bsp, off_bip, off_ws, off_bias, off_stats, bytes;
};

template <typename T>
__host__ __device__ inline HyenaBwdLayout hyena_bwd_layout(int rows_pad, int wb, int C, int K) {
  constexpr int elem = sizeof(T), kKStep = slice_rows<T>(), kLdO = kKStep + 8;
  HyenaBwdLayout L;
  L.cs = round_up16(C);
  L.lds = L.cs + 8;
  L.lddy = L.cs + 4;
  const size_t R = rows_pad;
  L.off_dos = align128(R * L.lds * elem);
  L.off_dy = L.off_dos + align128(R * L.lds * elem);
  L.off_z = L.off_dy + align128(R * L.lddy * 4);
  // the chain's zc, g and vl, dead while the products run, share their
  // space with the two buffers of staged slices (each win (kKStep x 96) and
  // wo (32 x kKStep, ld kKStep + 8) together, or win^T (kKStep x 96))
  L.off_zc = L.off_z + align128(R * kLdZ * 4);
  L.off_g = L.off_zc + align128(R * kLdZ * 4);
  L.off_vl = L.off_g + align128(R * kLdC * 4);
  L.off_w = L.off_zc;
  L.wo_in = align128((size_t)kKStep * kLdD * elem);
  L.wbuf = L.wo_in + align128((size_t)kChanChunk * kLdO * elem);
  const size_t chain_end = L.off_vl + align128(R * kLdC * 4), slices_end = L.off_w + 2 * L.wbuf;
  L.off_dv2 = chain_end > slices_end ? chain_end : slices_end;
  L.off_v2 = L.off_dv2 + align128(R * kLdC * 4);
  L.off_dz = L.off_v2 + align128(R * kLdV * elem);
  L.off_wsp = L.off_dz + align128(R * kLdD * elem);
  L.off_bsp = L.off_wsp + align128((size_t)wb * K * kW3 * 4);
  L.off_bip = L.off_bsp + align128((size_t)wb * kW3 * 4);
  L.off_ws = L.off_bip + align128((size_t)wb * kW3 * 4);
  L.off_bias = L.off_ws + align128((size_t)K * kW3 * 4);
  L.off_stats = L.off_bias + align128((size_t)2 * kW3 * 4);
  L.bytes = L.off_stats + align128(2 * R * 4);
  return L;
}

// Slot offsets (floats) of each gradient inside one block's slot; dws is at 0.
struct HyenaSlots {
  int dbin, dbs, dkl, dbo, dg, dbln;
};

// Column j of a 96-wide chunk is channel c0 + j % 32 of block j / 32 of the
// [x1 | x2 | v] axis: its column of a 3C-wide row, or -1 past C.
__device__ __forceinline__ int chunk_col(int j, int c0, int C) {
  const int c = c0 + j % kChanChunk;
  return c < C ? (j / kChanChunk) * C + c : -1;
}

// Rows [r0, r0 + n) of win's chunk columns (block j / 32, channel c0 + j %
// 32 of the [x1 | x2 | v] axis) into dst (n x 96, ld kLdD), zero past C on
// either axis; by 16-byte vectors where vec (C a multiple of 16 bytes' worth
// of T, so a vector lies wholly inside or past C).
// With vec the copies are cp.async, complete at the caller's wait.
template <typename T>
__device__ __forceinline__ void stage_win(T* dst, const T* __restrict__ win, int r0, int n, int C,
                                          int c0, bool vec) {
  constexpr int kVec = 16 / sizeof(T), kPer = kW3 / kVec;
  const size_t C3 = (size_t)3 * C;
  if (vec) {
    for (int i = threadIdx.x; i < n * kPer; i += kThreads) {
      const int r = i / kPer, j = (i % kPer) * kVec, c = c0 + j % kChanChunk;
      const bool live = r0 + r < C && c < C;
      cp_async16(smem_addr(dst + r * kLdD + j),
                 live ? win + (size_t)(r0 + r) * C3 + (j / kChanChunk) * C + c : win,
                 live ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n * kW3; i += kThreads) {
      const int r = i / kW3, j = i % kW3, col = chunk_col(j, c0, C);
      dst[r * kLdD + j] = col >= 0 && r0 + r < C ? win[(size_t)(r0 + r) * C3 + col]
                                                 : from_f32<T>(0.f);
    }
  }
}

// Rows [0, rows) of a (rows, width) slice of a row-major stream with leading
// dimension ld (from src) into dst (ld ldd), columns [width, wpad) and rows
// [rows, n) zero; or (store) the reverse, dst's rows and columns [0, width)
// to the stream. By 16-byte vectors where vec (ld, width, the column offsets
// and ldd multiples of 16 bytes' worth of T); with kAsync a load's vectors
// are cp.async, complete at the caller's wait.
template <typename T, bool kStore, bool kAsync = false>
__device__ __forceinline__ void copy_rows(T* smem_t, int ldd, T* __restrict__ g, size_t ld,
                                          int rows, int n, int width, int wpad, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    const int per = wpad / kVec;
    for (int i = threadIdx.x; i < (kStore ? rows : n) * per; i += kThreads) {
      const int r = i / per, c = (i % per) * kVec;
      if (kStore) {
        if (c < width)
          *reinterpret_cast<uint4*>(g + (size_t)r * ld + c) =
              *reinterpret_cast<const uint4*>(smem_t + r * ldd + c);
      } else if (kAsync) {
        const bool live = r < rows && c < width;
        cp_async16(smem_addr(smem_t + r * ldd + c), live ? g + (size_t)r * ld + c : g,
                   live ? 16 : 0);
      } else {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows && c < width) v = *reinterpret_cast<const uint4*>(g + (size_t)r * ld + c);
        *reinterpret_cast<uint4*>(smem_t + r * ldd + c) = v;
      }
    }
  } else {
    for (int i = threadIdx.x; i < (kStore ? rows : n) * wpad; i += kThreads) {
      const int r = i / wpad, c = i % wpad;
      if (kStore) {
        if (c < width) g[(size_t)r * ld + c] = smem_t[r * ldd + c];
      } else {
        smem_t[r * ldd + c] = r < rows && c < width ? g[(size_t)r * ld + c] : from_f32<T>(0.f);
      }
    }
  }
}

// The conv chain of one (window, channel) of a chunk with its V tokens in
// registers (V and K compile-time: the ptx windows, 4x4 tokens, and the
// models' 5 short taps): in_proj bias, causal short conv, gates, long conv,
// v2 = vl x2 (T); then backward, dvl = dv2 x2, dx2 = dv2 vl, d kl per
// window, dg, dx1 = dg v, dv = dg x1, the short conv's backward dz (T) and
// its tap and bias gradients per window. Every sum runs in the order of the
// pass-by-pass chain in the kernel, so both give the same values. z, dv2
// hold the chunk's products (fp32, ld kLdZ and kLdC); kl the long taps (V, C).
template <int kV, int kK, typename T>
__device__ __forceinline__ void chain_regs(int w, int j, int cw, int c0, int C, const float* z,
                                           const float* dv2, const float* __restrict__ kl,
                                           const float* wsc, const float* binc,
                                           const float* bsc, T* v2s, T* dzs, float* vlb,
                                           float* wspart, float* bspart, float* bipart) {
  constexpr int CC = kChanChunk, W3 = kW3;
  const int r0 = w * kV;
  float zr[3][kV], c[3][kV], g[kV], dvl[kV], klr[kV];
#pragma unroll
  for (int sb = 0; sb < 3; ++sb) {
    const int col = sb * CC + j;
#pragma unroll
    for (int t = 0; t < kV; ++t) zr[sb][t] = z[(r0 + t) * kLdZ + col] + binc[col];
#pragma unroll
    for (int t = 0; t < kV; ++t) {
      float a = bsc[col];
#pragma unroll
      for (int m = 0; m < kK && m <= t; ++m) a += zr[sb][t - m] * wsc[m * W3 + col];
      c[sb][t] = a;
    }
  }
#pragma unroll
  for (int t = 0; t < kV; ++t) {
    g[t] = c[2][t] * c[0][t];
    klr[t] = j < cw ? __ldg(kl + (size_t)t * C + c0 + j) : 0.f;
  }
#pragma unroll
  for (int t = 0; t < kV; ++t) {
    float a = 0.f;
    if (j < cw) {
#pragma unroll
      for (int m = 0; m <= t; ++m) a += g[t - m] * klr[m];
    }
    const float x2 = c[1][t], d = dv2[(r0 + t) * kLdC + j];
    v2s[(r0 + t) * kLdV + j] = from_f32<T>(a * x2);
    dvl[t] = d * x2;
    c[1][t] = d * a;
  }
#pragma unroll
  for (int tau = 0; tau < kV; ++tau) {
    float a = 0.f;
#pragma unroll
    for (int t = tau; t < kV; ++t) a += dvl[t] * g[t - tau];
    vlb[(r0 + tau) * kLdC + j] = a;
  }
#pragma unroll
  for (int t = 0; t < kV; ++t) {
    float dg = 0.f;
    if (j < cw) {
#pragma unroll
      for (int m = 0; t + m < kV; ++m) dg += klr[m] * dvl[t + m];
    }
    const float x1 = c[0][t], v = c[2][t];
    c[0][t] = dg * v;
    c[2][t] = dg * x1;
  }
#pragma unroll
  for (int sb = 0; sb < 3; ++sb) {
    const int col = sb * CC + j;
    float bsum = 0.f, isum = 0.f;
#pragma unroll
    for (int t = 0; t < kV; ++t) bsum += c[sb][t];
#pragma unroll
    for (int m = 0; m < kK; ++m) {
      float a = 0.f;
#pragma unroll
      for (int t = m; t < kV; ++t) a += c[sb][t] * zr[sb][t - m];
      wspart[((size_t)w * kK + m) * W3 + col] = a;
    }
#pragma unroll
    for (int t = 0; t < kV; ++t) {
      float a = 0.f;
#pragma unroll
      for (int m = 0; m < kK && t + m < kV; ++m) a += wsc[m * W3 + col] * c[sb][t + m];
      dzs[(r0 + t) * kLdD + col] = from_f32<T>(a);
      isum += a;
    }
    bspart[(size_t)w * W3 + col] = bsum;
    bipart[(size_t)w * W3 + col] = isum;
  }
}

// x, dout, dx: (BW, V, C) in T; win (C, 3C), wo (C, C) in T; bin, bs (3C),
// ws (K, 3C), kl (V, C), ln_g, ln_b (C) fp32. Writes dx, the streams ys (the
// LN'd rows, only if has_ln), v2s (N, C) and dzs (N, 3C) in T, and its slot.
template <typename T>
__global__ void __launch_bounds__(kThreads)
hyena_window_bwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                        const float* __restrict__ ln_b, const T* __restrict__ win,
                        const float* __restrict__ bin, const float* __restrict__ ws,
                        const float* __restrict__ bs, const float* __restrict__ kl,
                        const T* __restrict__ wo, const T* __restrict__ dout,
                        T* __restrict__ dx, T* __restrict__ y_out, T* __restrict__ v2_out,
                        T* __restrict__ dz_out, float* __restrict__ slots, size_t P,
                        HyenaSlots off, int BW, int V, int C, int K, int wb, int rows_pad,
                        int has_ln, long long tiles) {
  constexpr int CC = kChanChunk, W3 = kW3;
  extern __shared__ __align__(128) unsigned char smem[];
  const HyenaBwdLayout L = hyena_bwd_layout<T>(rows_pad, wb, C, K);
  constexpr int kKStep = slice_rows<T>(), kDyCols = kKStep, kLdO = kKStep + 8;
  const int Cs = L.cs;
  T* ys = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + L.off_dos);
  float* dy = reinterpret_cast<float*>(smem + L.off_dy);
  float* z = reinterpret_cast<float*>(smem + L.off_z);      // z + b_in, the short conv's input
  float* zc = reinterpret_cast<float*>(smem + L.off_zc);    // x1 | x2 | v, then dx1 | dx2 | dv
  float* gb = reinterpret_cast<float*>(smem + L.off_g);     // g = v * x1
  float* vlb = reinterpret_cast<float*>(smem + L.off_vl);   // vl = longconv(g), then d kl
  float* dv2 = reinterpret_cast<float*>(smem + L.off_dv2);  // dv2, then dvl
  T* v2s = reinterpret_cast<T*>(smem + L.off_v2);
  T* dzs = reinterpret_cast<T*>(smem + L.off_dz);
  unsigned char* wbufs = smem + L.off_w;   // two buffers of staged slices, over zc, g, vl
  float* wspart = reinterpret_cast<float*>(smem + L.off_wsp); // (wb, K, W3)
  float* bspart = reinterpret_cast<float*>(smem + L.off_bsp); // (wb, W3)
  float* bipart = reinterpret_cast<float*>(smem + L.off_bip); // (wb, W3)
  float* wsc = reinterpret_cast<float*>(smem + L.off_ws);     // (K, W3)
  float* binc = reinterpret_cast<float*>(smem + L.off_bias);
  float* bsc = binc + W3;
  float* mus = reinterpret_cast<float*>(smem + L.off_stats);
  float* rstds = mus + rows_pad;

  float* slot = slots + (size_t)blockIdx.x * P;
  float* s_dws = slot;
  float* s_dbin = slot + off.dbin;
  float* s_dbs = slot + off.dbs;
  float* s_dkl = slot + off.dkl;
  float* s_dbo = slot + off.dbo;
  float* s_dg = slot + off.dg;
  float* s_dbln = slot + off.dbln;
  const size_t C3 = (size_t)3 * C;
  const bool vec = C % (16 / sizeof(T)) == 0;   // 16-byte rows of x, do, the weights, the streams

  const long long t_begin = tiles * blockIdx.x / gridDim.x;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const bool first = tile == t_begin;
    const long long w0 = tile * wb;
    const int nwin = (int)min((long long)wb, (long long)BW - w0);
    const int rows = nwin * V;
    const size_t row0 = (size_t)w0 * V;
    const T* xt = x + row0 * C;
    const T* dot = dout + row0 * C;

    layernorm_rows(xt, rows, rows_pad, C, ln_g, ln_b, has_ln, ys, L.lds, mus, rstds, Cs);
    copy_rows<T, false>(dos, L.lds, const_cast<T*>(dot), C, rows, rows_pad, C, Cs, vec);
    for (int i = threadIdx.x; i < rows_pad * L.lddy; i += kThreads) dy[i] = 0.f;
    // pad rows of v2 and dz are never written per chunk; they must be zero so
    // that the dy products see nothing there
    for (int i = threadIdx.x; i < rows_pad * kLdV; i += kThreads) v2s[i] = from_f32<T>(0.f);
    for (int i = threadIdx.x; i < rows_pad * kLdD; i += kThreads) dzs[i] = from_f32<T>(0.f);
    __syncthreads();
    if (has_ln)   // the stream y: the LN'd rows in T, dwin's left operand
      copy_rows<T, true>(ys, L.lds, y_out + row0 * C, C, rows, rows, C, Cs, vec);

    for (int c0 = 0; c0 < C; c0 += CC) {
      const int cw = min(CC, C - c0);
      for (int i = threadIdx.x; i < K * W3; i += kThreads) {
        const int m = i / W3, col = chunk_col(i % W3, c0, C);
        wsc[i] = col >= 0 ? ws[(size_t)m * C3 + col] : 0.f;
      }
      for (int j = threadIdx.x; j < W3; j += kThreads) {
        const int col = chunk_col(j, c0, C);
        binc[j] = col >= 0 ? bin[col] : 0.f;
        bsc[j] = col >= 0 ? bs[col] : 0.f;
      }
      // z = ys @ win[:, chunk] and dv2 = dos @ wo[chunk, :]^T over depth
      // slices staged in shared memory (zeros past C), the next slice's
      // copies in flight while this one's products run
      const int nks = (Cs + kKStep - 1) / kKStep;
      auto stage_k = [&](int i) {
        const int k0 = i * kKStep, kw = min(kKStep, Cs - k0);
        T* wb = reinterpret_cast<T*>(wbufs + (i & 1) * L.wbuf);
        stage_win(wb, win, k0, kw, C, c0, vec);
        copy_rows<T, false, true>(reinterpret_cast<T*>(wbufs + (i & 1) * L.wbuf + L.wo_in), kLdO,
                                  const_cast<T*>(wo) + (size_t)c0 * C + k0, C, cw, CC,
                                  min(kw, C - k0), kw, vec);
      };
      stage_k(0);
      cp_async_commit();
      for (int i = 0; i < nks; ++i) {
        if (i + 1 < nks) {
          stage_k(i + 1);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const int k0 = i * kKStep, kw = min(kKStep, Cs - k0);
        const T* wb = reinterpret_cast<const T*>(wbufs + (i & 1) * L.wbuf);
        gemm<false, false>(z, kLdZ, ys + k0, L.lds, wb, kLdD, rows_pad, W3, kw, k0 > 0);
        gemm<false, true>(dv2, kLdC, dos + k0, L.lds,
                          reinterpret_cast<const T*>(wbufs + (i & 1) * L.wbuf + L.wo_in), kLdO,
                          rows_pad, CC, kw, k0 > 0);
        __syncthreads();
      }

      // the conv chain: in registers, a thread per (window, channel), for the
      // ptx windows (V = 16, K = 5); otherwise in passes over (row, column)
      // items of the valid rows (row r is token t = r % V of window r / V),
      // a barrier between passes
      if (V == 16 && K == 5) {
        for (int p = threadIdx.x; p < nwin * CC; p += kThreads)
          chain_regs<16, 5>(p / CC, p % CC, cw, c0, C, z, dv2, kl, wsc, binc, bsc, v2s, dzs,
                            vlb, wspart, bspart, bipart);
        __syncthreads();
      } else {
        for (int i = threadIdx.x; i < rows * W3; i += kThreads) {   // in_proj bias
          const int r = i / W3, col = i % W3;
          z[r * kLdZ + col] += binc[col];
        }
        __syncthreads();
        for (int i = threadIdx.x; i < rows * W3; i += kThreads) {   // causal short conv
          const int r = i / W3, col = i % W3, t = r % V;
          float a = bsc[col];
          for (int m = 0; m < K && m <= t; ++m) a += z[(r - m) * kLdZ + col] * wsc[m * W3 + col];
          zc[r * kLdZ + col] = a;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < rows * CC; i += kThreads) {   // g = v * x1
          const int r = i / CC, j = i % CC;
          gb[r * kLdC + j] = zc[r * kLdZ + 2 * CC + j] * zc[r * kLdZ + j];
        }
        __syncthreads();
        for (int i = threadIdx.x; i < rows * CC; i += kThreads) {
          // long conv vl, v2 = vl x2; post-gate backward dvl = dv2 x2, dx2 = dv2 vl
          const int r = i / CC, j = i % CC, t = r % V;
          float a = 0.f;
          if (j < cw) {
            for (int m = 0; m <= t; ++m)
              a += gb[(r - m) * kLdC + j] * __ldg(kl + (size_t)m * C + c0 + j);
          }
          vlb[r * kLdC + j] = a;
          const float x2 = zc[r * kLdZ + CC + j], d = dv2[r * kLdC + j];
          v2s[r * kLdV + j] = from_f32<T>(a * x2);
          dv2[r * kLdC + j] = d * x2;
          zc[r * kLdZ + CC + j] = d * a;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < rows * CC; i += kThreads) {
          // d kl[tau] = sum_t dvl[t] g[t - tau] (per window, over vl's dead
          // column); dg[t] = sum_m kl[m] dvl[t + m]; dx1 = dg v, dv = dg x1
          const int r = i / CC, j = i % CC, t = r % V, rw = r - t;
          float a = 0.f, dg = 0.f;
          for (int tt = t; tt < V; ++tt)
            a += dv2[(rw + tt) * kLdC + j] * gb[(rw + tt - t) * kLdC + j];
          if (j < cw) {
            for (int m = 0; t + m < V; ++m)
              dg += __ldg(kl + (size_t)m * C + c0 + j) * dv2[(r + m) * kLdC + j];
          }
          vlb[r * kLdC + j] = a;
          const float x1 = zc[r * kLdZ + j], v = zc[r * kLdZ + 2 * CC + j];
          zc[r * kLdZ + j] = dg * v;
          zc[r * kLdZ + 2 * CC + j] = dg * x1;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < rows * W3; i += kThreads) {
          // short conv backward: dz[t] = sum_m ws[m] dzc[t + m]
          const int r = i / W3, col = i % W3, t = r % V;
          float a = 0.f;
          for (int m = 0; m < K && t + m < V; ++m)
            a += wsc[m * W3 + col] * zc[(r + m) * kLdZ + col];
          dzs[r * kLdD + col] = from_f32<T>(a);
        }
        for (int i = threadIdx.x; i < nwin * (K + 1) * W3; i += kThreads) {
          // per window: d ws[m] = sum_t dzc[t] z[t - m] (item m < K), and dbs =
          // sum_t dzc[t], dbin = sum_t dz[t] (item m == K)
          const int col = i % W3, m = (i / W3) % (K + 1), w = i / (W3 * (K + 1)), rw = w * V;
          if (m < K) {
            float a = 0.f;
            for (int t = m; t < V; ++t)
              a += zc[(rw + t) * kLdZ + col] * z[(rw + t - m) * kLdZ + col];
            wspart[((size_t)w * K + m) * W3 + col] = a;
          } else {
            float sb = 0.f, si = 0.f;
            for (int t = 0; t < V; ++t) sb += zc[(rw + t) * kLdZ + col];
            for (int t = 0; t < V; ++t) {
              float a = 0.f;
              for (int mm = 0; mm < K && t + mm < V; ++mm)
                a += wsc[mm * W3 + col] * zc[(rw + t + mm) * kLdZ + col];
              si += a;
            }
            bspart[(size_t)w * W3 + col] = sb;
            bipart[(size_t)w * W3 + col] = si;
          }
        }
        __syncthreads();
      }

      // per-window tap and bias gradients, summed over the windows in order
      for (int i = threadIdx.x; i < V * cw; i += kThreads) {
        const int tau = i / cw, j = i % cw;
        float a = 0.f;
        for (int w = 0; w < nwin; ++w) a += vlb[(w * V + tau) * kLdC + j];
        float* dst = s_dkl + (size_t)tau * C + c0 + j;
        *dst = (first ? 0.f : *dst) + a;
      }
      for (int i = threadIdx.x; i < K * W3; i += kThreads) {
        const int m = i / W3, j = i % W3, col = chunk_col(j, c0, C);
        if (col < 0) continue;
        float a = 0.f;
        for (int w = 0; w < nwin; ++w) a += wspart[((size_t)w * K + m) * W3 + j];
        float* dst = s_dws + (size_t)m * C3 + col;
        *dst = (first ? 0.f : *dst) + a;
      }
      for (int j = threadIdx.x; j < W3; j += kThreads) {
        const int col = chunk_col(j, c0, C);
        if (col < 0) continue;
        float a = 0.f, b = 0.f;
        for (int w = 0; w < nwin; ++w) {
          a += bspart[(size_t)w * W3 + j];
          b += bipart[(size_t)w * W3 + j];
        }
        s_dbs[col] = (first ? 0.f : s_dbs[col]) + a;
        s_dbin[col] = (first ? 0.f : s_dbin[col]) + b;
      }
      // the streams v2 and dz of this chunk's columns
      copy_rows<T, true>(v2s, kLdV, v2_out + row0 * C + c0, C, rows, rows, cw, CC, vec);
      for (int sb = 0; sb < 3; ++sb)
        copy_rows<T, true>(dzs + sb * CC, kLdD, dz_out + row0 * C3 + sb * C + c0, C3, rows, rows,
                           cw, CC, vec);
      // dy += dz win[:, chunk]^T, by slices of kDyCols output columns, the
      // next slice's copies in flight while this one's product runs
      const int nds = (Cs + kDyCols - 1) / kDyCols;
      __syncthreads();   // vl (the d kl partials) is read; its space takes the slices
      stage_win(reinterpret_cast<T*>(wbufs), win, 0, min(kDyCols, Cs), C, c0, vec);
      cp_async_commit();
      for (int i = 0; i < nds; ++i) {
        const int n0 = i * kDyCols, nw = min(kDyCols, Cs - n0);
        if (i + 1 < nds) {
          stage_win(reinterpret_cast<T*>(wbufs + ((i + 1) & 1) * L.wbuf), win, n0 + kDyCols,
                    min(kDyCols, Cs - n0 - kDyCols), C, c0, vec);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        gemm<false, true>(dy + n0, L.lddy, dzs, kLdD,
                          reinterpret_cast<const T*>(wbufs + (i & 1) * L.wbuf), kLdD, rows_pad,
                          nw, W3, true);
        __syncthreads();
      }
    }

    // dbo = sum of do over the rows; with the folded LN, d ln_g and d ln_b
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float so = 0.f, sg = 0.f, sb = 0.f;
      for (int r = 0; r < rows; ++r) {
        so += to_f32(dos[(size_t)r * L.lds + c]);
        if (has_ln) {
          const float d = dy[(size_t)r * L.lddy + c];
          sg += d * (to_f32(xt[(size_t)r * C + c]) - mus[r]) * rstds[r];
          sb += d;
        }
      }
      s_dbo[c] = (first ? 0.f : s_dbo[c]) + so;
      if (has_ln) {
        s_dg[c] = (first ? 0.f : s_dg[c]) + sg;
        s_dbln[c] = (first ? 0.f : s_dbln[c]) + sb;
      }
    }
    T* dxt = dx + row0 * C;
    if (has_ln) {
      // LayerNorm backward per row (one warp per row), plus do for the residual
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      const float inv = 1.f / (float)C;
      for (int r = warp; r < rows; r += kWarps) {
        const float mu = mus[r], rstd = rstds[r];
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < C; c += 32) {
          const float xhat = (to_f32(xt[(size_t)r * C + c]) - mu) * rstd;
          const float dxh = dy[(size_t)r * L.lddy + c] * ln_g[c];
          s1 += dxh;
          s2 += dxh * xhat;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        const float m1 = s1 * inv, m2 = s2 * inv;
        for (int c = lane; c < C; c += 32) {
          const float xhat = (to_f32(xt[(size_t)r * C + c]) - mu) * rstd;
          const float dxh = dy[(size_t)r * L.lddy + c] * ln_g[c];
          const float v = rstd * (dxh - m1 - xhat * m2) + to_f32(dos[(size_t)r * L.lds + c]);
          dxt[(size_t)r * C + c] = from_f32<T>(v);
        }
      }
    } else {
      for (int i = threadIdx.x; i < rows * C; i += kThreads) {
        const int r = i / C, c = i % C;
        dxt[i] = from_f32<T>(dy[(size_t)r * L.lddy + c]);
      }
    }
    __syncthreads();
  }
}

template <typename T> int tile_windows(int V, int C, int K, size_t* bytes) {
  const int limit = max_dynamic_smem();
  int wb = kMaxWindow / V;
  auto bytes_for = [&](int nw) {
    return hyena_bwd_layout<T>(round_up16(nw * V), nw, C, K).bytes;
  };
  while (wb > 1 && bytes_for(wb) > (size_t)limit) wb /= 2;
  *bytes = bytes_for(wb);
  return *bytes > (size_t)limit ? 0 : wb;
}

template <typename T>
int launch_bwd(const void* x, const void* ln_g, const void* ln_b, const void* win, const void* bin,
               const void* ws, const void* bs, const void* kl, const void* wo, const void* dout,
               void* dx, void* ys, void* v2s, void* dzs, float* partials, float* wgrads, int S,
               float* slots, float* out, size_t P, HyenaSlots off, int max_slots, int BW, int V,
               int C, int K, int has_ln, cudaStream_t stream) {
  size_t bytes = 0;
  const int wb = tile_windows<T>(V, C, K, &bytes);
  if (wb == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(hyena_window_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (BW + wb - 1) / wb;
  const int G = persistent_blocks(hyena_window_bwd_kernel<T>, bytes, tiles, max_slots);
  if (G <= 0) return (int)cudaErrorInvalidValue;
  hyena_window_bwd_kernel<T><<<G, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<const T*>(win), static_cast<const float*>(bin), static_cast<const float*>(ws),
      static_cast<const float*>(bs), static_cast<const float*>(kl), static_cast<const T*>(wo),
      static_cast<const T*>(dout), static_cast<T*>(dx), static_cast<T*>(ys),
      static_cast<T*>(v2s), static_cast<T*>(dzs), slots, P, off, BW, V, C, K, wb,
      round_up16(wb * V), has_ln, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int e = launch_reduce(slots, G, P, out, stream);
  if (e != 0) return e;
  // dwin = y^T dz, dwo = v2^T do (y = x without the folded LN)
  return launch_wgrad<T>(has_ln ? ys : x, dzs, v2s, dout, partials, wgrads, (long long)BW * V, C,
                         S, stream);
}

}  // namespace lcbi

// Row splits of the weight-gradient products for BW V rows of C channels: the
// wrapper allocates that many partials of 4 C^2 floats. 0 on a device query
// error.
extern "C" int lcbi_hyena_window_wgrad_splits(long long N, int C) {
  return lcbi::wgrad_splits(N, C);
}

// x, dout, dx: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); win: (C,
// 3C) and wo: (C, C) in T; bin, bs: (3C,), ws: (K, 3C), kl: (V, C) and, if
// has_ln, ln_g, ln_b: (C,), all fp32, at the true C. ys (only if has_ln, else
// NULL), v2s: (BW V, C) and dzs: (BW V, 3C) in T, scratch streams. partials:
// S x 4C^2 fp32 scratch (S from lcbi_hyena_window_wgrad_splits); wgrads: 4C^2
// fp32 receives [dwin (C, 3C) | dwo (C, C)]. slots: max_slots x P fp32
// scratch (P a multiple of 8; offsets in floats inside a block's slot: dws
// (K, 3C) at 0, then dbin, dbs (3C), dkl (V, C), dbo, dg, dbln (C)). out:
// (P,) fp32, the slots summed. 1 <= V <= 64, C > 0, all pointers 32-byte
// aligned. Returns cudaGetLastError() of the launches.
extern "C" int lcbi_hyena_window_bwd(const void* x, const void* ln_g, const void* ln_b,
                                     const void* win, const void* bin, const void* ws,
                                     const void* bs, const void* kl, const void* wo,
                                     const void* dout, void* dx, void* ys, void* v2s, void* dzs,
                                     void* partials, void* wgrads, int S, void* slots, void* out,
                                     int BW, int V, int C, int K, int has_ln, int is_bf16,
                                     int max_slots, long long P, int off_dbin, int off_dbs,
                                     int off_dkl, int off_dbo, int off_dg, int off_dbln,
                                     void* stream) {
  (void)cudaGetLastError();
  if (BW <= 0 || V < 1 || V > lcbi::kMaxWindow || C <= 0 || K < 1 || max_slots < 1 ||
      P % 8 != 0 || S < 1 || S > (long long)BW * V || (has_ln && ys == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const lcbi::HyenaSlots off{off_dbin, off_dbs, off_dkl, off_dbo, off_dg, off_dbln};
  float* sl = static_cast<float*>(slots);
  float* o = static_cast<float*>(out);
  float* pa = static_cast<float*>(partials);
  float* wg = static_cast<float*>(wgrads);
  if (is_bf16)
    return lcbi::launch_bwd<__nv_bfloat16>(x, ln_g, ln_b, win, bin, ws, bs, kl, wo, dout, dx, ys,
                                           v2s, dzs, pa, wg, S, sl, o, (size_t)P, off, max_slots,
                                           BW, V, C, K, has_ln, s);
  return lcbi::launch_bwd<float>(x, ln_g, ln_b, win, bin, ws, bs, kl, wo, dout, dx, ys, v2s, dzs,
                                 pa, wg, S, sl, o, (size_t)P, off, max_slots, BW, V, C, K, has_ln,
                                 s);
}
