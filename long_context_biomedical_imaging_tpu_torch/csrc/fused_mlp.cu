// Fused pre-LN transformer MLP with residual, forward:
//     out = x + GELU(LN(x) @ w1 + b1) @ w2 + b2
// and, with the template argument LN false, the plain MLP (K2'):
//     out = GELU(x @ w1 + b1) @ w2 + b2
//
// Replaces the TPU kernels long_context_biomedical_imaging_tpu/ops/fused_mlp.py
// _make_ln_fwd_kernel (launched by _ln_fwd_call, entry fused_ln_mlp_residual)
// and, as K2', _make_fwd_kernel (launched by _fwd, entry fused_mlp).
//
// What bounds it on the H100: 4 N C H operations on the tensor cores against
// 4 N C bytes of x in and out (bf16): at H = 4C some 4 C operations a byte,
// 384 at C = 96, above the card's ~295, so the tensor cores bound it once the
// hidden activation stays on chip. Every block reads all of w1 and w2 (4 C H
// bytes) from L2 for its BM rows: BM operations per byte of L2 traffic, so
// the row tile must be as tall as the accumulators allow.
//
// The design (bf16), one block of 8 warps per tile of BM rows:
//   - The LN'd rows go to shared memory once, in bf16 (common.cuh
//     layernorm_rows: fp32 statistics, zeros in the pad rows and columns).
//   - The hidden width runs in chunks of 64 or 128 columns. u = y w1[:, chunk]
//     accumulates in registers as mma.sync.m16n8k16 fragments over 64-deep
//     slices of w1, and the chunk's rows of w2 follow in 32-deep slabs of the
//     output columns; both come through one three-slot ring of cp.async
//     copies with the tails past C and H zeroed (mlp_common.cuh), two
//     stages ahead of the products, so the weights pass at their true
//     widths.
//   - The bias and GELU run on u's fragments (the tanh form under bf16).
//   - The fp32 output tile stays in registers across the whole hidden loop:
//     96 accumulator registers a thread at most, which sets the tile. Where a
//     warp owns its 16 rows' whole output width (C <= 96: 8 warps x 16 = 128
//     rows a block, two blocks an SM), h passes from u's accumulator
//     fragments straight to the A fragments of the second product. At wider
//     C the warps split the output columns and each owns two 16-row m-tiles,
//     so that a staged B fragment feeds two products (C <= 192 and 384: 64
//     rows, 4 column groups of 48 or 96; beyond, 32 rows and 8 groups of 96,
//     the output columns walked in passes of 768 that recompute u); h then
//     crosses shared memory once a chunk, in bf16, for the groups to share.
//     (A warp owning 16 rows of C = 192 measured a third slower: one block
//     an SM at 206 registers.)
//   - The epilogue adds b2 and the residual in fp32 on the fragments and
//     rounds once.
// Registers bound the blocks an SM (one at 96 accumulators, two at 48).
//
// fp32 (the tests' path): the same chain on FMA products in shared memory
// (common.cuh gemm, full fp32, no TF32) over slices of w1 and w2 staged with
// the tails masked, and the exact erf GELU.
//
// Rounding, as the TPU kernel: the products take bf16 operands (the LN'd
// rows, w1, h, w2) and sum in fp32; the biases, GELU and the residual are
// fp32; the output is rounded once. Any C (up to what the row tile's shared
// memory holds) and any H >= 1.
#include "mlp_common.cuh"

namespace lcbi {

// Warps WR x (8 / WR): WR groups of 16 MR rows (MR m-tiles of 16 a warp),
// 8 / WR groups of NO 16-column output tiles (CW = 16 NO columns each); a
// pass covers CP output columns. A warp owning its rows' whole width (MR =
// 1) takes hidden chunks of 64 columns (its h stays in registers, 16
// A-fragment registers); column groups take chunks of 128, so that each
// warp's share of u keeps four or eight independent accumulators and a
// chunk's barriers serve twice the products, and with MR = 2 each staged B
// fragment feeds two m-tiles (half the shared-memory reads a product).
// Where the registers allow (96 accumulator registers or fewer with room
// for u), two blocks share an SM.
template <int WR, int NO, int MR> struct MlpFwdCfg {
  static constexpr int kBM = 16 * MR * WR, kWC = 8 / WR, kCW = 16 * NO, kCP = kWC * kCW;
  static constexpr int kChunk = kWC == 1 ? 64 : 128;   // hidden columns of a chunk
  static constexpr int kHC = kChunk / kWC;              // u columns a warp computes
  static constexpr int kLdU = kChunk + 8;               // w1 slices and h (bf16)
  static constexpr int kW2Rows = 32;                    // hidden rows of a staged w2 slab
  static constexpr int kLdW2 = kCP + 8;
  static constexpr int kSlot = kSliceK * kLdU > kW2Rows * kLdW2 ? kSliceK * kLdU
                                                                : kW2Rows * kLdW2;
  static constexpr int kMinBlocks = MR * NO <= 6 ? 2 : 1;
  static_assert(kHC % 16 == 0, "warps take pairs of 8-column tiles of u");
  static_assert(kWC > 1 || (MR == 1 && kChunk == 2 * kW2Rows),
                "a warp owning its rows' width keeps h's A fragments, two slabs of them");
};

struct MlpFwdLayout {
  int lds;
  size_t off_ring, off_h, bytes;
};

// ys (BM, Cs + 8), the ring's slots, h (BM, chunk) when the column groups
// share it.
template <int WR, int NO, int MR> __host__ __device__ inline MlpFwdLayout mlp_fwd_layout(int C) {
  using Cf = MlpFwdCfg<WR, NO, MR>;
  MlpFwdLayout L;
  L.lds = round_up16(C) + 8;
  L.off_ring = align128((size_t)Cf::kBM * L.lds * 2);
  L.off_h = L.off_ring + align128((size_t)kRing * Cf::kSlot * 2);
  L.bytes = L.off_h + (Cf::kWC > 1 ? align128((size_t)Cf::kBM * Cf::kLdU * 2) : 0);
  return L;
}

template <int WR, int NO, int MR, bool LN>
__global__ void __launch_bounds__(kThreads, MlpFwdCfg<WR, NO, MR>::kMinBlocks)
mlp_fwd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_g,
                   const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const bf16* __restrict__ w2,
                   const float* __restrict__ b2, bf16* __restrict__ out, int N, int C, int H) {
  using Cf = MlpFwdCfg<WR, NO, MR>;
  constexpr int kBM = Cf::kBM, kWC = Cf::kWC, kCW = Cf::kCW, kCP = Cf::kCP, kHC = Cf::kHC;
  constexpr int kChunk = Cf::kChunk, kLdU = Cf::kLdU, kW2Rows = Cf::kW2Rows;
  constexpr int kUT = kHC / 8;   // 8-column tiles of u a warp holds per m-tile
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpFwdLayout L = mlp_fwd_layout<WR, NO, MR>(C);
  bf16* ys = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.off_ring);
  bf16* hs = reinterpret_cast<bf16*>(smem + L.off_h);
  const int Cs = round_up16(C);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / kWC, wc = warp % kWC, g = lane / 4, t = lane % 4;
  const int m0 = wr * 16 * MR;   // the warp's first row in the tile
  const bool vec_h = H % 8 == 0, vec_c = C % 8 == 0, pair = C % 2 == 0;
  const int nks = (Cs + kSliceK - 1) / kSliceK, nch = (H + kChunk - 1) / kChunk;
  const int per = nks + kChunk / kW2Rows;   // stages of a chunk: w1 slices, w2 slabs
  const int npass = (C + kCP - 1) / kCP;
  const int total = npass * nch * per;
  const size_t r0 = (size_t)blockIdx.x * kBM;
  const int rows = min(kBM, N - (int)r0);

  // stage s: pass s / (nch per), chunk (s / per) % nch, step s % per
  auto prefetch = [&](int s) {
    const int sub = s % per, ch = (s / per) % nch, p = s / per / nch;
    bf16* dst = ring + (s % kRing) * Cf::kSlot;
    const int h0 = ch * kChunk;
    if (sub < nks) {   // w1[k0 + 64)[h0 + chunk)
      stage_slice16<kSliceK, kChunk>(dst, kLdU, w1, sub * kSliceK, C, h0, H, H, vec_h);
    } else {           // w2[h0 + 32 q + 32)[p CP + CP)
      stage_slice16<kW2Rows, kCP>(dst, Cf::kLdW2, w2, h0 + (sub - nks) * kW2Rows, H, p * kCP, C,
                                  C, vec_c);
    }
  };

  prefetch(0);
  cp_async_commit();
  if (total > 1) prefetch(1);
  cp_async_commit();
  layernorm_rows(x + r0 * C, rows, kBM, C, ln_g, ln_b, LN ? 1 : 0, ys, L.lds, nullptr, nullptr,
                 Cs);

  float acc[MR][2 * NO][4], u[MR][kUT][4];
  uint32_t ha[kChunk / 16][4];   // h as A fragments (a warp owning its rows' whole width)
  for (int s = 0; s < total; ++s) {
    // stage s is in; the slot of stage s + 2 was last read at s - 1
    cp_async_wait<1>();
    __syncthreads();
    if (s + 2 < total) prefetch(s + 2);
    cp_async_commit();
    const int sub = s % per, ch = (s / per) % nch, c0 = (s / per / nch) * kCP;
    const bf16* sl = ring + (s % kRing) * Cf::kSlot;
    if (sub == 0 && ch == 0) {
#pragma unroll
      for (int mi = 0; mi < MR; ++mi)
#pragma unroll
        for (int j = 0; j < 2 * NO; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    }
    if (sub < nks) {
      // u += y[:, k0 + 64) w1[k0 + 64)[this warp's columns of the chunk]
      const int k0 = sub * kSliceK, kw = min(kSliceK, Cs - k0);
      if (sub == 0) {
#pragma unroll
        for (int mi = 0; mi < MR; ++mi)
#pragma unroll
          for (int j = 0; j < kUT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) u[mi][j][e] = 0.f;
      }
      auto step = [&](int kk) {
        uint32_t a[MR][4];
#pragma unroll
        for (int mi = 0; mi < MR; ++mi) frag_a(a[mi], ys, L.lds, m0 + 16 * mi, k0 + kk, lane);
#pragma unroll
        for (int p = 0; p < kUT / 2; ++p) {
          uint32_t b[4];
          frag_b_cols(b, sl, kLdU, kk, wc * kHC + 16 * p, lane);
#pragma unroll
          for (int mi = 0; mi < MR; ++mi) {
            mma_bf16(u[mi][2 * p], a[mi], b[0], b[1]);
            mma_bf16(u[mi][2 * p + 1], a[mi], b[2], b[3]);
          }
        }
      };
      if (kw == kSliceK) {
#pragma unroll
        for (int kk = 0; kk < kSliceK; kk += 16) step(kk);
      } else {
        for (int kk = 0; kk < kw; kk += 16) step(kk);
      }
      if (sub == nks - 1) {
        // bias and GELU on the fragments; columns past H have zero weights
        // and bias, so h = GELU(0) = 0 there
        const int hc = ch * kChunk + wc * kHC;
#pragma unroll
        for (int j = 0; j < kUT; ++j) {
          const int col = hc + j * 8 + 2 * t;
          const float bb0 = col < H ? b1[col] : 0.f, bb1 = col + 1 < H ? b1[col + 1] : 0.f;
#pragma unroll
          for (int mi = 0; mi < MR; ++mi)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              u[mi][j][2 * hh] = gelu<bf16>(u[mi][j][2 * hh] + bb0);
              u[mi][j][2 * hh + 1] = gelu<bf16>(u[mi][j][2 * hh + 1] + bb1);
            }
        }
        if constexpr (kWC == 1) {
#pragma unroll
          for (int q = 0; q < kChunk / 16; ++q) acc_to_a(ha[q], u[0][2 * q], u[0][2 * q + 1]);
        } else {
          // h to shared memory for the column groups (read after the next barrier)
#pragma unroll
          for (int mi = 0; mi < MR; ++mi)
#pragma unroll
            for (int j = 0; j < kUT; ++j)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                *reinterpret_cast<uint32_t*>(hs + (m0 + 16 * mi + g + 8 * hh) * kLdU +
                                             wc * kHC + j * 8 + 2 * t) =
                    pack_bf16(u[mi][j][2 * hh], u[mi][j][2 * hh + 1]);
        }
      }
    } else {
      // acc[:, this warp's columns] += h[:, 32 q + 32) w2[32 q + 32)[columns]
      auto step = [&](const uint32_t (&a)[MR][4], int k2) {
#pragma unroll
        for (int p = 0; p < NO; ++p) {
          if (c0 + wc * kCW + 16 * p >= C) break;   // staged zeros: nothing to add
          uint32_t b[4];
          frag_b_cols(b, sl, Cf::kLdW2, k2 * 16, wc * kCW + 16 * p, lane);
#pragma unroll
          for (int mi = 0; mi < MR; ++mi) {
            mma_bf16(acc[mi][2 * p], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][2 * p + 1], a[mi], b[2], b[3]);
          }
        }
      };
      const int q = sub - nks;
      if constexpr (kWC == 1) {   // h's A fragments at static indices
        auto one = [&](const uint32_t (&a)[4], int k2) {
          const uint32_t (&am)[MR][4] = *reinterpret_cast<const uint32_t (*)[MR][4]>(&a);
          step(am, k2);
        };
        if (q == 0) {
          one(ha[0], 0);
          one(ha[1], 1);
        } else {
          one(ha[2], 0);
          one(ha[3], 1);
        }
      } else {
#pragma unroll
        for (int k2 = 0; k2 < kW2Rows / 16; ++k2) {
          uint32_t a[MR][4];
#pragma unroll
          for (int mi = 0; mi < MR; ++mi)
            frag_a(a[mi], hs, kLdU, m0 + 16 * mi, q * kW2Rows + k2 * 16, lane);
          step(a, k2);
        }
      }
      if (sub == per - 1 && ch == nch - 1) {
        // the pass's columns: + b2 (+ the residual), rounded once
#pragma unroll
        for (int j = 0; j < 2 * NO; ++j) {
          const int col = c0 + wc * kCW + j * 8 + 2 * t;
          if (col >= C) continue;
          const bool two = col + 1 < C;
          const float bb0 = b2[col], bb1 = two ? b2[col + 1] : 0.f;
#pragma unroll
          for (int mi = 0; mi < MR; ++mi)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = m0 + 16 * mi + g + 8 * hh;
              if (r >= rows) continue;
              const size_t at = (r0 + r) * C + col;
              float v0 = acc[mi][j][2 * hh] + bb0, v1 = acc[mi][j][2 * hh + 1] + bb1;
              if (LN) {
                v0 += __bfloat162float(x[at]);
                if (two) v1 += __bfloat162float(x[at + 1]);
              }
              if (pair && two) {
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

// fp32: the rows, the fp32 output tile, u (h in place) and the staged slices
// of w1 (32 deep x 64) and w2 (64 x 32 columns) in shared memory.
constexpr int kF32K = 32;
constexpr int kLdUf = kHidChunk + 4;
constexpr int kLdW2f = kF32K + 4;

struct MlpF32Layout {
  int lds;
  size_t off_acc, off_u, off_w1, off_w2, bytes;
};

__host__ __device__ inline MlpF32Layout mlp_f32_layout(int bm, int C) {
  MlpF32Layout L;
  L.lds = C + 4;
  L.off_acc = align128((size_t)bm * L.lds * 4);
  L.off_u = L.off_acc + align128((size_t)bm * L.lds * 4);
  L.off_w1 = L.off_u + align128((size_t)bm * kLdUf * 4);
  L.off_w2 = L.off_w1 + align128((size_t)kF32K * kLdUf * 4);
  L.bytes = L.off_w2 + align128((size_t)kHidChunk * kLdW2f * 4);
  return L;
}

template <bool LN>
__global__ void __launch_bounds__(kThreads)
mlp_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ ln_g,
                   const float* __restrict__ ln_b, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ out, int N, int C, int H,
                   int bm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpF32Layout L = mlp_f32_layout(bm, C);
  float* ys = reinterpret_cast<float*>(smem);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);
  float* u = reinterpret_cast<float*>(smem + L.off_u);
  float* w1s = reinterpret_cast<float*>(smem + L.off_w1);
  float* w2s = reinterpret_cast<float*>(smem + L.off_w2);
  const size_t r0 = (size_t)blockIdx.x * bm;
  const int rows = min(bm, N - (int)r0);
  const float* xt = x + r0 * C;

  layernorm_rows(xt, rows, bm, C, ln_g, ln_b, LN ? 1 : 0, ys, L.lds);
  for (int i = threadIdx.x; i < bm * L.lds; i += kThreads) acc[i] = 0.f;
  for (int h0 = 0; h0 < H; h0 += kHidChunk) {
    // u = y w1[:, chunk] over 32-deep slices, then h = GELU(u + b1) in place
    for (int k0 = 0; k0 < C; k0 += kF32K) {
      const int kw = min(kF32K, C - k0);
      __syncthreads();
      for (int e = threadIdx.x; e < kF32K * kHidChunk; e += kThreads) {
        const int k = e / kHidChunk, j = e % kHidChunk;
        w1s[k * kLdUf + j] = k < kw && h0 + j < H ? w1[(size_t)(k0 + k) * H + h0 + j] : 0.f;
      }
      __syncthreads();
      gemm<false, false>(u, kLdUf, ys + k0, L.lds, w1s, kLdUf, bm, kHidChunk, kw, k0 > 0);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < bm * kHidChunk; e += kThreads) {
      const int r = e / kHidChunk, j = e % kHidChunk;
      u[r * kLdUf + j] = gelu<float>(u[r * kLdUf + j] + (h0 + j < H ? b1[h0 + j] : 0.f));
    }
    // acc[:, k0 + 32) += h w2[chunk][k0 + 32)
    for (int k0 = 0; k0 < C; k0 += kF32K) {
      const int nw = min(kF32K, C - k0);
      __syncthreads();
      for (int e = threadIdx.x; e < kHidChunk * kF32K; e += kThreads) {
        const int j = e / kF32K, c = e % kF32K;
        w2s[j * kLdW2f + c] = c < nw && h0 + j < H ? w2[(size_t)(h0 + j) * C + k0 + c] : 0.f;
      }
      __syncthreads();
      gemm<false, false>(acc + k0, L.lds, u, kLdUf, w2s, kLdW2f, bm, nw, kHidChunk, true);
    }
  }
  __syncthreads();
  float* ot = out + r0 * C;
  for (int i = threadIdx.x; i < rows * C; i += kThreads) {
    const int r = i / C, c = i % C;
    ot[i] = acc[(size_t)r * L.lds + c] + b2[c] + (LN ? xt[i] : 0.f);
  }
}

template <int WR, int NO, int MR, bool LN>
int launch_mma(const void* x, const void* ln_g, const void* ln_b, const void* w1, const void* b1,
               const void* w2, const void* b2, void* out, int N, int C, int H,
               cudaStream_t stream) {
  const size_t bytes = mlp_fwd_layout<WR, NO, MR>(C).bytes;
  if (bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  auto kernel = mlp_fwd_mma_kernel<WR, NO, MR, LN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int kBM = MlpFwdCfg<WR, NO, MR>::kBM;
  kernel<<<(unsigned)((N + kBM - 1) / kBM), kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), N, C, H);
  return (int)cudaGetLastError();
}

// The bf16 tile by width: a warp owns its 16 rows' whole output width up to
// C = 96 (NO the least of 2, 4, 6 tiles of 16 that holds C, 128 rows a
// block); beyond, column groups: 64 rows in two row groups of two m-tiles
// and four groups of 48 columns up to C = 192, of 96 up to 384; 32 rows and
// eight groups of 96 beyond, in passes of 768 columns, and 16 rows where
// the 32 rows' LN'd tile no longer fits beside the ring (C > 1160).
template <bool LN>
int launch_bf16(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                const void* b1, const void* w2, const void* b2, void* out, int N, int C, int H,
                cudaStream_t s) {
  if (C <= 32) return launch_mma<8, 2, 1, LN>(x, ln_g, ln_b, w1, b1, w2, b2, out, N, C, H, s);
  if (C <= 64) return launch_mma<8, 4, 1, LN>(x, ln_g, ln_b, w1, b1, w2, b2, out, N, C, H, s);
  if (C <= 96) return launch_mma<8, 6, 1, LN>(x, ln_g, ln_b, w1, b1, w2, b2, out, N, C, H, s);
  if (C <= 192) return launch_mma<2, 3, 2, LN>(x, ln_g, ln_b, w1, b1, w2, b2, out, N, C, H, s);
  if (C <= 384) return launch_mma<2, 6, 2, LN>(x, ln_g, ln_b, w1, b1, w2, b2, out, N, C, H, s);
  if (mlp_fwd_layout<1, 6, 2>(C).bytes <= (size_t)max_dynamic_smem())
    return launch_mma<1, 6, 2, LN>(x, ln_g, ln_b, w1, b1, w2, b2, out, N, C, H, s);
  return launch_mma<1, 6, 1, LN>(x, ln_g, ln_b, w1, b1, w2, b2, out, N, C, H, s);
}

// fp32: rows a tile the most of 64, 32, 16 whose layout fits.
template <bool LN>
int launch_f32(const void* x, const void* ln_g, const void* ln_b, const void* w1, const void* b1,
               const void* w2, const void* b2, void* out, int N, int C, int H,
               cudaStream_t stream) {
  const size_t limit = (size_t)max_dynamic_smem();
  int bm = 64;
  while (bm > 16 && mlp_f32_layout(bm, C).bytes > limit) bm /= 2;
  const size_t bytes = mlp_f32_layout(bm, C).bytes;
  if (bytes > limit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mlp_fwd_f32_kernel<LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  mlp_fwd_f32_kernel<LN><<<(unsigned)((N + bm - 1) / bm), kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), N, C, H, bm);
  return (int)cudaGetLastError();
}

template <bool LN>
int launch(const void* x, const void* ln_g, const void* ln_b, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int N, int C, int H, int is_bf16,
           void* stream) {
  (void)cudaGetLastError();
  if (N <= 0 || C <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_bf16<LN>(x, ln_g, ln_b, w1, b1, w2, b2, out, N, C, H, s);
  return launch_f32<LN>(x, ln_g, ln_b, w1, b1, w2, b2, out, N, C, H, s);
}

}  // namespace lcbi

// x, out: (N, C) in T (fp32 if is_bf16 == 0, else bf16); w1: (C, H) and w2:
// (H, C) in T at the true widths; ln_g, ln_b, b2: (C,) and b1: (H,) fp32. Any
// C > 0 whose row tile fits in shared memory, any H > 0; all pointers 16-byte
// aligned. Returns cudaGetLastError() of the launch.
extern "C" int lcbi_fused_ln_mlp_fwd(const void* x, const void* ln_g, const void* ln_b,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* out, int N, int C, int H,
                                     int is_bf16, void* stream) {
  return lcbi::launch<true>(x, ln_g, ln_b, w1, b1, w2, b2, out, N, C, H, is_bf16, stream);
}

// K2', the MLP without LayerNorm or residual: out = GELU(x @ w1 + b1) @ w2 +
// b2. Operands as lcbi_fused_ln_mlp_fwd without ln_g and ln_b.
extern "C" int lcbi_fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* out, int N, int C, int H, int is_bf16,
                                  void* stream) {
  return lcbi::launch<false>(x, nullptr, nullptr, w1, b1, w2, b2, out, N, C, H, is_bf16, stream);
}
