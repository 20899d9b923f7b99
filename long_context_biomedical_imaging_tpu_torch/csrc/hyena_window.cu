// Fused Hyena window mixer, forward, for windows of V <= 64 tokens:
//     out = [x +] out_proj(x2 * longconv(x1 * v)),  [x1 | x2 | v] = shortconv(in_proj([LN](x)))
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/hyena_window.py
// _make_fwd_kernel / _fwd_body (launched by _fwd through _mixer_core_ln and
// _mixer_core, entry hyena_window_mixer).
//
// What bounds it on the H100: the two projections, 8 T C^2 operations on the
// tensor cores for T tokens, against 4 T C bytes of x in and out (bf16):
// some 2 C operations a byte, 192 at C = 96, near the card's ~295, so once
// the 3C-wide intermediates stay on chip the products bound it, and in
// practice the latency between them: every block streams all of win and wo
// (8 C^2 bytes) through shared memory for its rows, one barrier a staged
// slice. The convolutions and gates act per channel within one window,
// about 3 (2K + V) fp32 operations per (token, channel).
//
// The design (bf16), one block of 8 warps per tile of whole windows:
//   - The (LN'd) rows go to shared memory once, in bf16 (common.cuh
//     layernorm_rows: fp32 statistics, zeros in the pad rows and columns).
//   - The channel axis runs in chunks of 32. For one chunk, z = y win[:, the
//     chunk's x1 | x2 | v columns] (96 columns) accumulates in registers as
//     mma.sync.m16n8k16 fragments over deep slices of win (as deep as C up
//     to C = 96, 64 to 256 rows beyond: fewer slices, fewer barriers), and
//     the chunk's 32 rows of wo follow in slabs of 16 or 32 rows of the
//     output columns; both come through one three-slot ring of cp.async
//     copies with the tails past C zeroed (mlp_common.cuh stage16), two
//     stages ahead of the products, so the weights pass at their true C
//     and no dtype pads a weight.
//   - The conv chain crosses a window's rows, which a fragment spreads over
//     lanes, so z goes to shared memory in fp32 (one barrier a chunk) and
//     the chain reads it with one thread per (window, channel): at the ptx
//     windows (V = 16 and the models' 5 short taps, both compile-time) in
//     registers, for every other V and K in passes (short conv, pre-gate,
//     long conv with the post-gate).
//   - v2 = vl x2 is rounded to bf16 once; it is the A operand of the out
//     projection, whose fp32 output tile stays in registers over the whole
//     channel loop, split over the warps by column groups as K2's forward
//     splits it (launch_bf16 has the tiles). Where that tile takes 48
//     registers a thread or fewer, two blocks share an SM. (A first layout
//     in which each warp owned a window's 16 rows, all 96 columns of z and
//     its chain, with no barrier for the chain, measured 1.6x slower at C =
//     96: its 128 rows a block spilled at two blocks an SM and ran 1.3x
//     slower at one.)
//   - The epilogue adds b_out and the residual in fp32 on the fragments and
//     rounds once.
//
// fp32 (the tests' path): the same chain on the FMA products of common.cuh
// (full fp32, no TF32) over slices of win and wo staged with the tails
// masked, the output tile in shared memory.
//
// Rounding, as the TPU kernel: the products take operands in T (y, win, v2,
// wo) and sum in fp32; z, the short conv, the gates, the long conv and every
// sum in fp32, each term in the parent's order (the short conv's taps from
// the token itself back, then its bias; the long conv from tap 0 up); the
// output rounded once after the residual.
//
// Taps arrive prepared by the wrapper, as for the TPU kernel: ws (K, 3C) is
// the short filter flipped to causal tap order, kl (V, C) the long filter
// with the skip weight added to tap 0. Every operand is at its true C.
#include "mlp_common.cuh"   // stage16, stage_slice16, the mma.sync fragments, cp.async

namespace lcbi {

constexpr int kChanChunk = 32;
constexpr int kMaxWindow = 64;
constexpr int kW3 = 3 * kChanChunk;     // z columns of a chunk: x1 | x2 | v
constexpr int kLdZ = kW3 + 4;           // fp32 z chunk
constexpr int kLdV2 = kChanChunk + 8;   // bf16 v2 chunk
constexpr int kK1Ring = 3;              // slots of the bf16 ring: kK1Ring - 1 stages ahead

// ---------------------------------------------------------------------------
// The conv chain of one channel chunk, from z (fp32, ld kLdZ, columns [32 s,
// 32 s + 32) the chunk's channels of block s of [x1 | x2 | v]) to v2 (T, ld
// ldv). Column j is channel c0 + j; past C every tap and bias reads 0.
// ---------------------------------------------------------------------------

// One (window, channel) with its V tokens in registers (V and K compile-time:
// the ptx windows, 4x4 tokens, and the models' 5 short taps). zr, v2r: the
// window's first row.
template <int kV, int kK, typename T>
__device__ __forceinline__ void chain_regs(const float* zr, T* v2r, int ldv, int j, int c0, int C,
                                           const float* __restrict__ bin,
                                           const float* __restrict__ ws,
                                           const float* __restrict__ bs,
                                           const float* __restrict__ kl) {
  const int c = c0 + j;
  const bool live = c < C;
  // block sb of [x1 | x2 | v]: in_proj bias, causal short conv, its bias
  auto short_conv = [&](int sb, float (&o)[kV]) {
    const int col = sb * C + c;
    const float bi = live ? __ldg(bin + col) : 0.f, bsv = live ? __ldg(bs + col) : 0.f;
    float w[kK], zb[kV];
#pragma unroll
    for (int m = 0; m < kK; ++m) w[m] = live ? __ldg(ws + (size_t)m * 3 * C + col) : 0.f;
#pragma unroll
    for (int t = 0; t < kV; ++t) zb[t] = zr[t * kLdZ + sb * kChanChunk + j] + bi;
#pragma unroll
    for (int t = 0; t < kV; ++t) {
      float a = zb[t] * w[0];
#pragma unroll
      for (int m = 1; m < kK && m <= t; ++m) a += zb[t - m] * w[m];
      o[t] = a + bsv;
    }
  };
  // x1 and v, then the pre-gate g = v x1 (x2 after them: fewer live registers)
  float g[kV], v[kV], x2[kV], klr[kV];
  short_conv(0, g);
  short_conv(2, v);
#pragma unroll
  for (int t = 0; t < kV; ++t) g[t] = v[t] * g[t];
  short_conv(1, x2);
#pragma unroll
  for (int t = 0; t < kV; ++t) klr[t] = live ? __ldg(kl + (size_t)t * C + c) : 0.f;
  // the long conv, then the post-gate with x2
#pragma unroll
  for (int t = 0; t < kV; ++t) {
    float a = g[t] * klr[0];
#pragma unroll
    for (int m = 1; m <= t; ++m) a += g[t - m] * klr[m];
    v2r[t * ldv + j] = from_f32<T>(a * x2[t]);
  }
}

// Any V and K, in passes over the tile's nwin windows (row r of window w: r
// = w V + t), every thread of the block, a barrier between passes: the short
// conv in place from the last token down (so every read of an earlier token
// sees its unconvolved value), the pre-gate g = v x1 into the v column, the
// long conv times x2 to v2.
template <typename T>
__device__ __forceinline__ void chain_passes(float* z, T* v2, int ldv, int nwin, int V, int K,
                                             int c0, int C, const float* __restrict__ bin,
                                             const float* __restrict__ ws,
                                             const float* __restrict__ bs,
                                             const float* __restrict__ kl) {
  for (int i = threadIdx.x; i < nwin * kW3; i += kThreads) {
    const int w = i / kW3, col = i % kW3, j = col % kChanChunk;
    const bool live = c0 + j < C;
    const int gcol = (col / kChanChunk) * C + c0 + j;
    const float bi = live ? bin[gcol] : 0.f, bsv = live ? bs[gcol] : 0.f;
    float* zr = z + (size_t)w * V * kLdZ + col;
    for (int t = V - 1; t >= 0; --t) {
      float a = (zr[t * kLdZ] + bi) * (live ? ws[gcol] : 0.f);
      for (int m = 1; m < K && m <= t; ++m)
        a += (zr[(t - m) * kLdZ] + bi) * (live ? ws[(size_t)m * 3 * C + gcol] : 0.f);
      zr[t * kLdZ] = a + bsv;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nwin * V * kChanChunk; i += kThreads) {
    const int r = i / kChanChunk, j = i % kChanChunk;
    z[r * kLdZ + 2 * kChanChunk + j] *= z[r * kLdZ + j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nwin * V * kChanChunk; i += kThreads) {
    const int r = i / kChanChunk, j = i % kChanChunk, t = r % V;
    const bool live = c0 + j < C;
    const float* gr = z + (size_t)r * kLdZ + 2 * kChanChunk + j;
    float a = gr[0] * (live ? kl[c0 + j] : 0.f);
    for (int m = 1; m <= t; ++m) a += gr[-m * kLdZ] * (live ? kl[(size_t)m * C + c0 + j] : 0.f);
    v2[r * ldv + j] = from_f32<T>(a * z[r * kLdZ + kChanChunk + j]);
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync fragments in registers
// ---------------------------------------------------------------------------

// Warps WR x (8 / WR) over the output: WR groups of 16 MR rows (MR m-tiles a
// warp), 8 / WR groups of NO 16-column tiles (CW = 16 NO columns); a pass
// covers CP output columns. z's (BM x 96) tile splits over the warps as ZN
// 8-column n-tiles of one m-tile each (ZG warps an m-tile). KS: depth of a
// staged win slice; W2: rows of a staged wo slab. Where the output tile
// takes 48 accumulator registers a thread or fewer, two blocks share an SM.
template <int WR, int NO, int MR, int KS, int W2> struct K1FwdCfg {
  static constexpr int kBM = 16 * MR * WR, kWC = 8 / WR, kCW = 16 * NO, kCP = kWC * kCW;
  static constexpr int kZN = 12 * (kBM / 16) / 8 > 2 ? 12 * (kBM / 16) / 8 : 2;
  static constexpr int kZG = 12 / kZN, kZWarps = (kBM / 16) * kZG;
  static constexpr int kLdU = kW3 + 8;   // staged win slices (bf16)
  static constexpr int kLdW2 = kCP + 8;  // staged wo slabs
  static constexpr int kSlot = KS * kLdU > W2 * kLdW2 ? KS * kLdU : W2 * kLdW2;
  static constexpr int kMinBlocks = MR * NO <= 6 ? 2 : 1;
  static_assert(12 % kZN == 0 && kZWarps <= 8, "z's n-tiles split evenly over the warps");
  static_assert(kChanChunk % W2 == 0 && W2 % 16 == 0, "a chunk's rows of wo in whole slabs");
};

struct K1FwdLayout {
  int lds;
  size_t off_ring, off_z, off_v2, bytes;
};

// ys (BM, Cs + 8) bf16, the ring's slots, z (BM, 96) fp32, v2 (BM, 32) bf16.
template <class Cf> __host__ __device__ inline K1FwdLayout k1_fwd_layout(int C) {
  K1FwdLayout L;
  L.lds = round_up16(C) + 8;
  L.off_ring = align128((size_t)Cf::kBM * L.lds * 2);
  L.off_z = L.off_ring + align128((size_t)kK1Ring * Cf::kSlot * 2);
  L.off_v2 = L.off_z + align128((size_t)Cf::kBM * kLdZ * 4);
  L.bytes = L.off_v2 + align128((size_t)Cf::kBM * kLdV2 * 2);
  return L;
}

// x, out: (BW, V, C) bf16; a block takes wb whole windows (wb V <= BM rows).
template <int WR, int NO, int MR, int KS, int W2>
__global__ void __launch_bounds__(kThreads, (K1FwdCfg<WR, NO, MR, KS, W2>::kMinBlocks))
hyena_fwd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_g,
                     const float* __restrict__ ln_b, const bf16* __restrict__ win,
                     const float* __restrict__ bin, const float* __restrict__ ws,
                     const float* __restrict__ bs, const float* __restrict__ kl,
                     const bf16* __restrict__ wo, const float* __restrict__ bo,
                     bf16* __restrict__ out, int BW, int V, int C, int K, int wb, int has_ln) {
  using Cf = K1FwdCfg<WR, NO, MR, KS, W2>;
  constexpr int kBM = Cf::kBM, kWC = Cf::kWC, kCW = Cf::kCW, kCP = Cf::kCP, kZN = Cf::kZN;
  constexpr int kLdU = Cf::kLdU;
  extern __shared__ __align__(128) unsigned char smem[];
  const K1FwdLayout L = k1_fwd_layout<Cf>(C);
  bf16* ys = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.off_ring);
  float* zs = reinterpret_cast<float*>(smem + L.off_z);
  bf16* v2s = reinterpret_cast<bf16*>(smem + L.off_v2);
  const int Cs = round_up16(C);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = warp / kWC, wc = warp % kWC, m0 = wr * 16 * MR;   // the warp's out tile
  const bool zw = warp < Cf::kZWarps;                              // and its z tile
  const int zmt = warp / Cf::kZG, zn0 = (warp % Cf::kZG) * kZN;
  const bool vec = C % 8 == 0;   // 16-byte rows and column blocks of win, wo, x, out
  const int nks = (Cs + KS - 1) / KS, nch = (C + kChanChunk - 1) / kChanChunk;
  const int per = nks + kChanChunk / W2;   // stages of a chunk: win slices, wo slabs
  const int npass = (C + kCP - 1) / kCP, total = npass * nch * per;
  const long long w0 = (long long)blockIdx.x * wb;
  const int nwin = (int)min((long long)wb, (long long)BW - w0), rows = nwin * V;
  const size_t r0 = (size_t)w0 * V;
  const bool fast = V == 16 && K == 5;   // the chain in registers

  // stage s: pass s / (nch per), chunk (s / per) % nch, step s % per
  auto prefetch = [&](int s) {
    const int sub = s % per, c0 = ((s / per) % nch) * kChanChunk, p = s / per / nch;
    bf16* dst = ring + (s % kK1Ring) * Cf::kSlot;
    if (sub < nks) {   // win[k0 + KS)[the chunk's columns of x1, x2, v]
      for (int e = threadIdx.x; e < KS * 12; e += kThreads) {
        const int r = e / 12, q = e % 12;
        stage16(dst + r * kLdU + q * 8, win + (q / 4) * C + c0, sub * KS + r, C, (q % 4) * 8,
                C - c0, 3 * C, vec);
      }
    } else {           // wo[c0 + W2 q + W2)[p CP + CP)
      stage_slice16<W2, kCP>(dst, Cf::kLdW2, wo, c0 + (sub - nks) * W2, C, p * kCP, C, C, vec);
    }
  };

#pragma unroll
  for (int s = 0; s < kK1Ring - 1; ++s) {
    if (s < total) prefetch(s);
    cp_async_commit();
  }
  layernorm_rows(x + r0 * C, rows, kBM, C, ln_g, ln_b, has_ln, ys, L.lds, nullptr, nullptr, Cs);

  float acc[MR][2 * NO][4], za[kZN][4];
  for (int s = 0; s < total; ++s) {
    // stage s is in; the slot of stage s + kK1Ring - 1 was last read at s - 1
    cp_async_wait<kK1Ring - 2>();
    __syncthreads();
    if (s + kK1Ring - 1 < total) prefetch(s + kK1Ring - 1);
    cp_async_commit();
    const int sub = s % per, ch = (s / per) % nch, c0 = ch * kChanChunk;
    const int cbase = (s / per / nch) * kCP;
    const bf16* sl = ring + (s % kK1Ring) * Cf::kSlot;
    if (sub == 0 && ch == 0) {
#pragma unroll
      for (int mi = 0; mi < MR; ++mi)
#pragma unroll
        for (int j = 0; j < 2 * NO; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    }
    if (sub < nks) {
      // z += y[:, k0 + KS) win[k0 + KS)[this warp's n-tiles of the chunk]
      if (sub == 0) {
#pragma unroll
        for (int j = 0; j < kZN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) za[j][e] = 0.f;
      }
      if (zw) {
        const int k0 = sub * KS, kw = min(KS, Cs - k0);
        auto step = [&](int kk) {
          uint32_t a[4];
          frag_a(a, ys, L.lds, zmt * 16, k0 + kk, lane);
#pragma unroll
          for (int q = 0; q < (kZN + 1) / 2; ++q) {
            uint32_t b[4];
            frag_b_cols(b, sl, kLdU, kk, (zn0 + 2 * q) * 8, lane);
            mma_bf16(za[2 * q], a, b[0], b[1]);
            if (2 * q + 1 < kZN) mma_bf16(za[2 * q + 1], a, b[2], b[3]);
          }
        };
        if (kw == KS) {
#pragma unroll
          for (int kk = 0; kk < KS; kk += 16) step(kk);
        } else {
          for (int kk = 0; kk < kw; kk += 16) step(kk);
        }
      }
      if (sub == nks - 1) {
        // z to shared memory in fp32, then the chain to v2 (bf16)
        if (zw) {
#pragma unroll
          for (int j = 0; j < kZN; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              *reinterpret_cast<float2*>(zs + (zmt * 16 + g + 8 * hh) * kLdZ + (zn0 + j) * 8 +
                                         2 * t) = make_float2(za[j][2 * hh], za[j][2 * hh + 1]);
        }
        __syncthreads();
        if (fast) {
          for (int p = threadIdx.x; p < nwin * kChanChunk; p += kThreads) {
            const int w = p / kChanChunk;
            chain_regs<16, 5>(zs + w * 16 * kLdZ, v2s + w * 16 * kLdV2, kLdV2, p % kChanChunk, c0,
                              C, bin, ws, bs, kl);
          }
        } else {
          chain_passes(zs, v2s, kLdV2, nwin, V, K, c0, C, bin, ws, bs, kl);
        }
      }
    } else {
      // acc[:, this warp's columns] += v2[:, W2 q + W2) wo[c0 + W2 q + W2)[columns]
      const int q = sub - nks;
#pragma unroll
      for (int k2 = 0; k2 < W2 / 16; ++k2) {
        uint32_t a[MR][4];
#pragma unroll
        for (int mi = 0; mi < MR; ++mi)
          frag_a(a[mi], v2s, kLdV2, m0 + 16 * mi, q * W2 + k2 * 16, lane);
#pragma unroll
        for (int p = 0; p < NO; ++p) {
          if (cbase + wc * kCW + 16 * p >= C) break;   // staged zeros: nothing to add
          uint32_t b[4];
          frag_b_cols(b, sl, Cf::kLdW2, k2 * 16, wc * kCW + 16 * p, lane);
#pragma unroll
          for (int mi = 0; mi < MR; ++mi) {
            mma_bf16(acc[mi][2 * p], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][2 * p + 1], a[mi], b[2], b[3]);
          }
        }
      }
      if (sub == per - 1 && ch == nch - 1) {
        // the pass's columns: + b_out (+ the residual), rounded once
#pragma unroll
        for (int j = 0; j < 2 * NO; ++j) {
          const int col = cbase + wc * kCW + j * 8 + 2 * t;
          if (col >= C) continue;
          const bool two = col + 1 < C;
          const float bb0 = bo[col], bb1 = two ? bo[col + 1] : 0.f;
#pragma unroll
          for (int mi = 0; mi < MR; ++mi)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = m0 + 16 * mi + g + 8 * hh;
              if (r >= rows) continue;
              const size_t at = (r0 + r) * C + col;
              float v0 = acc[mi][j][2 * hh] + bb0, v1 = acc[mi][j][2 * hh + 1] + bb1;
              if (has_ln) {
                v0 += __bfloat162float(x[at]);
                if (two) v1 += __bfloat162float(x[at + 1]);
              }
              if (vec && two) {
                *reinterpret_cast<uint32_t*>(out + at) = pack_bf16(v0, v1);
              } else {
                out[at] = __float2bfloat16(v0);
                if (two) out[at + 1] = __float2bfloat16(v1);
              }
            }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int WR, int NO, int MR, int KS, int W2>
int launch_mma(const void* x, const void* ln_g, const void* ln_b, const void* win, const void* bin,
               const void* ws, const void* bs, const void* kl, const void* wo, const void* bo,
               void* out, int BW, int V, int C, int K, int has_ln, cudaStream_t stream) {
  using Cf = K1FwdCfg<WR, NO, MR, KS, W2>;
  const size_t bytes = k1_fwd_layout<Cf>(C).bytes;
  if (V > Cf::kBM || bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  auto kernel = hyena_fwd_mma_kernel<WR, NO, MR, KS, W2>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int wb = Cf::kBM / V;
  kernel<<<(unsigned)((BW + wb - 1) / wb), kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(win),
      static_cast<const float*>(bin), static_cast<const float*>(ws),
      static_cast<const float*>(bs), static_cast<const float*>(kl), static_cast<const bf16*>(wo),
      static_cast<const float*>(bo), static_cast<bf16*>(out), BW, V, C, K, wb, has_ln);
  return (int)cudaGetLastError();
}

template <int WR, int NO, int MR, int KS, int W2> bool k1_fits(int C) {
  return k1_fwd_layout<K1FwdCfg<WR, NO, MR, KS, W2>>(C).bytes <= (size_t)max_dynamic_smem();
}

// The bf16 tile by width (utils/k1_tiles.py times the alternatives): up to
// C = 96, 64 rows a block in two column groups of 16 NO columns (NO the
// least of 1, 2, 3 that holds C) and win in one slice as deep as C, two
// blocks an SM; beyond, column groups of two m-tiles: 64 rows and four
// groups of 48 columns up to C = 192 (win slices 64 deep, two blocks an SM),
// of 96 up to 384 (slices 192 deep); 32 rows and eight groups of 96 beyond,
// in passes of 768 columns, with win slices 256 deep where they fit and wo
// in slabs of 16 rows; 16 rows where 32 no longer fit. A window longer than
// 32 tokens at C > 384 takes 64 rows in passes of 384 columns.
int launch_bf16(const void* x, const void* ln_g, const void* ln_b, const void* win,
                const void* bin, const void* ws, const void* bs, const void* kl, const void* wo,
                const void* bo, void* out, int BW, int V, int C, int K, int has_ln,
                cudaStream_t s) {
#define K1_LAUNCH(WR, NO, MR, KS, W2) \
  launch_mma<WR, NO, MR, KS, W2>(x, ln_g, ln_b, win, bin, ws, bs, kl, wo, bo, out, BW, V, C, K, \
                                 has_ln, s)
  if (C <= 32) return K1_LAUNCH(4, 1, 1, 32, 32);
  if (C <= 64) return K1_LAUNCH(4, 2, 1, 64, 32);
  if (C <= 96) return K1_LAUNCH(4, 3, 1, 96, 32);
  if (C <= 192) return K1_LAUNCH(2, 3, 2, 64, 32);
  if (C <= 384) return K1_LAUNCH(2, 6, 2, 192, 32);
  if (V > 32) return K1_LAUNCH(2, 6, 2, 64, 32);
  if (k1_fits<1, 6, 2, 256, 16>(C)) return K1_LAUNCH(1, 6, 2, 256, 16);
  if (V > 16 || k1_fits<1, 6, 2, 64, 16>(C)) return K1_LAUNCH(1, 6, 2, 64, 16);
  return K1_LAUNCH(1, 6, 1, 64, 16);
#undef K1_LAUNCH
}

// ---------------------------------------------------------------------------
// fp32: FMA products in shared memory
// ---------------------------------------------------------------------------

constexpr int kF32K = 16;                // depth of a staged win slice
constexpr int kLdV2f = kChanChunk + 4;   // v2 and the staged wo slices (32 x 32)

struct K1F32Layout {
  int lds;
  size_t off_acc, off_z, off_v2, off_w, off_o, bytes;
};

// ys and the output tile (rows, C + 4), z (rows, 96), v2 (rows, 32), a win
// slice (16, 96) and a wo slice (32, 32), all fp32.
__host__ __device__ inline K1F32Layout k1_f32_layout(int rows_pad, int C) {
  K1F32Layout L;
  L.lds = C + 4;
  L.off_acc = align128((size_t)rows_pad * L.lds * 4);
  L.off_z = L.off_acc + align128((size_t)rows_pad * L.lds * 4);
  L.off_v2 = L.off_z + align128((size_t)rows_pad * kLdZ * 4);
  L.off_w = L.off_v2 + align128((size_t)rows_pad * kLdV2f * 4);
  L.off_o = L.off_w + align128((size_t)kF32K * kLdZ * 4);
  L.bytes = L.off_o + align128((size_t)kChanChunk * kLdV2f * 4);
  return L;
}

__host__ __device__ __forceinline__ int round_up8(int v) { return (v + 7) & ~7; }

__global__ void __launch_bounds__(kThreads)
hyena_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ ln_g,
                     const float* __restrict__ ln_b, const float* __restrict__ win,
                     const float* __restrict__ bin, const float* __restrict__ ws,
                     const float* __restrict__ bs, const float* __restrict__ kl,
                     const float* __restrict__ wo, const float* __restrict__ bo,
                     float* __restrict__ out, int BW, int V, int C, int K, int wb, int has_ln) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows_pad = round_up8(wb * V);
  const K1F32Layout L = k1_f32_layout(rows_pad, C);
  float* ys = reinterpret_cast<float*>(smem);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);
  float* zs = reinterpret_cast<float*>(smem + L.off_z);
  float* v2s = reinterpret_cast<float*>(smem + L.off_v2);
  float* wsl = reinterpret_cast<float*>(smem + L.off_w);
  float* wos = reinterpret_cast<float*>(smem + L.off_o);
  const long long w0 = (long long)blockIdx.x * wb;
  const int nwin = (int)min((long long)wb, (long long)BW - w0), rows = nwin * V;
  const float* xt = x + (size_t)w0 * V * C;
  const size_t C3 = (size_t)3 * C;

  layernorm_rows(xt, rows, rows_pad, C, ln_g, ln_b, has_ln, ys, L.lds);
  for (int i = threadIdx.x; i < rows_pad * L.lds; i += kThreads) acc[i] = 0.f;
  for (int c0 = 0; c0 < C; c0 += kChanChunk) {
    // z = y win[:, the chunk's columns] over 16-deep slices (zeros past C)
    for (int k0 = 0; k0 < C; k0 += kF32K) {
      const int kw = min(kF32K, C - k0);
      __syncthreads();
      for (int e = threadIdx.x; e < kF32K * kW3; e += kThreads) {
        const int k = e / kW3, j = e % kW3, c = c0 + j % kChanChunk;
        wsl[k * kLdZ + j] =
            k < kw && c < C ? win[(size_t)(k0 + k) * C3 + (j / kChanChunk) * C + c] : 0.f;
      }
      __syncthreads();
      gemm<false, false>(zs, kLdZ, ys + k0, L.lds, wsl, kLdZ, rows_pad, kW3, kw, k0 > 0);
    }
    __syncthreads();
    if (V == 16 && K == 5) {
      for (int p = threadIdx.x; p < nwin * kChanChunk; p += kThreads) {
        const int w = p / kChanChunk;
        chain_regs<16, 5>(zs + w * 16 * kLdZ, v2s + w * 16 * kLdV2f, kLdV2f, p % kChanChunk, c0,
                          C, bin, ws, bs, kl);
      }
    } else {
      chain_passes(zs, v2s, kLdV2f, nwin, V, K, c0, C, bin, ws, bs, kl);
    }
    // acc[:, n0 + 32) += v2 wo[chunk][n0 + 32)
    for (int n0 = 0; n0 < C; n0 += kChanChunk) {
      const int nw = min(kChanChunk, C - n0);
      __syncthreads();
      for (int e = threadIdx.x; e < kChanChunk * kChanChunk; e += kThreads) {
        const int j = e / kChanChunk, c = e % kChanChunk;
        wos[j * kLdV2f + c] = c < nw && c0 + j < C ? wo[(size_t)(c0 + j) * C + n0 + c] : 0.f;
      }
      __syncthreads();
      gemm<false, false>(acc + n0, L.lds, v2s, kLdV2f, wos, kLdV2f, rows_pad, nw, kChanChunk,
                         true);
    }
  }
  __syncthreads();
  float* ot = out + (size_t)w0 * V * C;
  for (int i = threadIdx.x; i < rows * C; i += kThreads) {
    const int r = i / C, c = i % C;
    ot[i] = acc[(size_t)r * L.lds + c] + bo[c] + (has_ln ? xt[i] : 0.f);
  }
}

// fp32: 64 / V windows a block, halved until the tiles fit.
int launch_f32(const void* x, const void* ln_g, const void* ln_b, const void* win,
               const void* bin, const void* ws, const void* bs, const void* kl, const void* wo,
               const void* bo, void* out, int BW, int V, int C, int K, int has_ln,
               cudaStream_t stream) {
  const size_t limit = (size_t)max_dynamic_smem();
  int wb = kMaxWindow / V;
  while (wb > 1 && k1_f32_layout(round_up8(wb * V), C).bytes > limit) wb /= 2;
  const size_t bytes = k1_f32_layout(round_up8(wb * V), C).bytes;
  if (bytes > limit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(hyena_fwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  hyena_fwd_f32_kernel<<<(unsigned)((BW + wb - 1) / wb), kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const float*>(win),
      static_cast<const float*>(bin), static_cast<const float*>(ws),
      static_cast<const float*>(bs), static_cast<const float*>(kl), static_cast<const float*>(wo),
      static_cast<const float*>(bo), static_cast<float*>(out), BW, V, C, K, wb, has_ln);
  return (int)cudaGetLastError();
}

}  // namespace lcbi

// x, out: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); win: (C, 3C) and
// wo: (C, C) in T; bin, bs: (3C,), ws: (K, 3C), kl: (V, C) fp32; bo and, if
// has_ln, ln_g, ln_b: (C,) fp32; every operand at the true C. 1 <= V <= 64,
// C > 0, all pointers 16-byte aligned. Returns cudaGetLastError() of the
// launch.
extern "C" int lcbi_hyena_window_fwd(const void* x, const void* ln_g, const void* ln_b,
                                     const void* win, const void* bin, const void* ws,
                                     const void* bs, const void* kl, const void* wo,
                                     const void* bo, void* out, int BW, int V, int C, int K,
                                     int has_ln, int is_bf16, void* stream) {
  (void)cudaGetLastError();
  if (BW <= 0 || V < 1 || V > lcbi::kMaxWindow || C <= 0 || K < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return lcbi::launch_bf16(x, ln_g, ln_b, win, bin, ws, bs, kl, wo, bo, out, BW, V, C, K,
                             has_ln, s);
  return lcbi::launch_f32(x, ln_g, ln_b, win, bin, ws, bs, kl, wo, bo, out, BW, V, C, K, has_ln,
                          s);
}
