// Flash attention (K5), forward: o = softmax(q k^T * scale) v over (BH, L, D),
// non-causal, with the base-2 online softmax of flash_attention.cuh; also
// writes lse, the base-2 log-sum-exp of each row, for the backward.
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/flash_attention.py
// _fwd_kernel (launched by _flash_fwd, entry flash_attention).
//
// What bounds it on the H100: the two products, 4 L^2 D FLOPs per head, on
// the tensor cores (989 TFLOP/s in bf16), against 4 L D elements in and out:
// at L = 16,385 and D = 64 some 8,000 FLOPs a byte, so the products bound
// it; at D = 64 the L^2 exp2 per head (one per score, on the SFU at a
// sixteenth of the FMA rate) cost nearly as much as the products
// (chip_smoke.py kernel_bounds).
//
// What the bf16 design does about it: a block of 4 warps owns a tile of
// query rows, each warp its own 16 or 32 rows; the scaled q tile is loaded
// once into shared memory. For each key tile, which a two-stage cp.async ring
// brings in while the previous tile is being multiplied, a warp computes its
// score fragment s = qs k^T with mma.sync.m16n8k16 (operands by ldmatrix),
// masks keys at or past L on the fragment, runs the online softmax on it
// (row max and sum across the four lanes of a row by shuffles, alpha =
// exp2(m_prev - m_new) rescaling the fp32 output accumulator in registers),
// rounds p to bf16 in registers and feeds it straight in as the A operand of
// p v (v's B fragments by ldmatrix.trans). Nothing of s, p or the accumulator
// touches shared memory; the output leaves through a per-warp staging tile
// as 16-byte stores. A warp holding 32 rows reuses each k and v fragment for
// two mma row tiles, halving the shared-memory reads per product.
// Tile heights by padded head dim (registers are the limit: the accumulator
// takes DP / 2 floats per thread for each 16 rows, the score tile BN / 2;
// the longer the key tile, the fewer the rescales and row reductions):
//     DP <= 64: 32 rows a warp (128 a block), 128 keys a tile;
//     DP = 128: 16 rows a warp (64 a block), 32 keys (accumulator 64 floats);
//     DP = 256: 16 rows a warp, 32 keys (accumulator 128 floats, scores 16);
// shared memory stays under 110 KB (q tile and two stages of k and v). The
// heights are the fastest of the variants that utils/k5_tiles.py times at
// (12, 16385, D) for D = 64, 128 and 256 (PERF.md).
//
// fp32 (tests and checks only): every tile in shared memory, full-fp32 FMA
// loops, one warp per softmax row (flash_attention.cuh); not redesigned.
#include "flash_attention.cuh"

namespace lcbi {

// ---------------------------------------------------------------------------
// bf16: tensor-core fragments
// ---------------------------------------------------------------------------

template <int DP> struct FwdCfg {
  static constexpr int kWarps = 4, kThreads = kWarps * 32;
  static constexpr int kMT = DP <= 64 ? 2 : 1;          // 16-row mma tiles per warp
  static constexpr int kBM = kWarps * 16 * kMT;         // query rows per block
  static constexpr int kBN = DP <= 64 ? 128 : 32;       // keys per tile
  static constexpr int kLd = DP + 8;
  static constexpr size_t kSmem = (size_t)(kBM + 4 * kBN) * kLd * sizeof(bf16);
};

// grid (query tiles, BH); q, k, v, o: (BH, L, D) bf16; lse: (BH, L) fp32.
template <int DP>
__global__ void __launch_bounds__(FwdCfg<DP>::kThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int L, int D, float scale2) {
  using C = FwdCfg<DP>;
  constexpr int kMT = C::kMT, kBM = C::kBM, kBN = C::kBN, kLd = C::kLd;
  constexpr int kNT = kBN / 8, kDT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBM * kLd;
  bf16* Vs = Ks + 2 * kBN * kLd;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * kBM;
  const size_t base = (size_t)blockIdx.y * L * D;
  const bool vec = D % 8 == 0;
  const int nkt = (L + kBN - 1) / kBN;

  load_tile_bf16<DP, kBN>(Ks, k + base, 0, L, D, vec, C::kThreads);
  load_tile_bf16<DP, kBN>(Vs, v + base, 0, L, D, vec, C::kThreads);
  cp_async_commit();
  load_tile_scaled_bf16<DP, kBM>(Qs, q + base, m0, L, D, vec, scale2, C::kThreads);

  float acc[kMT][kDT][4];
  float m_run[kMT][2], l_run[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dt][e] = 0.f;
    m_run[mt][0] = m_run[mt][1] = kFlashNegInf;
    l_run[mt][0] = l_run[mt][1] = 0.f;  // this lane's part of each row sum
  }
  const int wrow = warp * 16 * kMT;

  for (int j = 0; j < nkt; ++j) {
    if (j + 1 < nkt) {
      const int st = (j + 1) & 1;
      load_tile_bf16<DP, kBN>(Ks + st * kBN * kLd, k + base, (j + 1) * kBN, L, D, vec,
                              C::kThreads);
      load_tile_bf16<DP, kBN>(Vs + st * kBN * kLd, v + base, (j + 1) * kBN, L, D, vec,
                              C::kThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + (j & 1) * kBN * kLd;
    const bf16* Vt = Vs + (j & 1) * kBN * kLd;

    // s = qs k^T
    float s[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) frag_a(a[mt], Qs, kLd, wrow + mt * 16, kk * 16, lane);
#pragma unroll
      for (int n2 = 0; n2 < kNT / 2; ++n2) {
        uint32_t b[4];
        frag_b_rows(b, Kt, kLd, n2 * 16, kk * 16, lane);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][2 * n2], a[mt], b[0], b[1]);
          mma_bf16(s[mt][2 * n2 + 1], a[mt], b[2], b[3]);
        }
      }
    }
    // keys at or past L score -1e30 (the last tile only)
    if ((j + 1) * kBN > L) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * kBN + nt * 8 + 2 * (lane & 3) + (e & 1);
          if (col >= L) {
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) s[mt][nt][e] = kFlashNegInf;
          }
        }
    }
    // online softmax on the fragments: half h of a row tile is row g + 8 h
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kFlashNegInf;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mx = fmaxf(mx, fmaxf(s[mt][nt][2 * h], s[mt][nt][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[mt][h], mx);
        const float alpha = fast_exp2(m_run[mt][h] - m_new);
        m_run[mt][h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = fast_exp2(s[mt][nt][2 * h + e] - m_new);
            s[mt][nt][2 * h + e] = p;
            sum += p;
          }
        l_run[mt][h] = l_run[mt][h] * alpha + sum;
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          acc[mt][dt][2 * h] *= alpha;
          acc[mt][dt][2 * h + 1] *= alpha;
        }
      }
    // acc += round(p) v
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) acc_to_a(a[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < DP / 16; ++d2) {
        uint32_t b[4];
        frag_b_cols(b, Vt, kLd, kk * 16, d2 * 16, lane);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * d2], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * d2 + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the stage read here is the one the next step refills
  }

  // o = acc / l (l == 0 guarded as the TPU kernel does), lse = m + log2(l);
  // the warp stages its rows of o over its own rows of the q tile
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[mt][h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float l_safe = l == 0.f ? 1.f : l;
      const int r = wrow + mt * 16 + g + 8 * h;
      if (t == 0 && m0 + r < L) lse[(size_t)blockIdx.y * L + m0 + r] = m_run[mt][h] + log2f(l_safe);
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<uint32_t*>(Qs + r * kLd + dt * 8 + 2 * t) =
            pack_bf16(acc[mt][dt][2 * h] / l_safe, acc[mt][dt][2 * h + 1] / l_safe);
    }
  __syncwarp();
  store_tile_bf16<DP, 16 * kMT>(o + base, Qs + wrow * kLd, m0 + wrow, L, D, vec, lane, 32);
}

template <int DP>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                   int L, int D, float scale2, cudaStream_t stream) {
  using C = FwdCfg<DP>;
  cudaError_t err = set_smem(flash_fwd_mma_kernel<DP>, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + C::kBM - 1) / C::kBM, BH);
  flash_fwd_mma_kernel<DP><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), L, D, scale2);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core loops on shared-memory tiles
// ---------------------------------------------------------------------------

template <int DP> using FwdDims32 = FlashDims<DP, DP <= 64 ? 64 : 32>;

template <typename F> constexpr size_t flash_fwd_smem32() {
  return 3 * tile_bytes<float>(F::kTile, F::kLdT) + tile_bytes<float>(F::kTile, F::kLdP) +
         tile_bytes<float>(F::kTile, F::kLdS) + tile_bytes<float>(F::kTile, F::kLdA) +
         2 * F::kTile * 4;
}

// grid (query tiles, BH); q, k, v, o: (BH, L, D) fp32; lse: (BH, L) fp32.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int L, int D, float scale2) {
  using F = FwdDims32<DP>;
  constexpr int kTile = F::kTile, kPer = kTile / 32;
  static_assert(kTile % 32 == 0, "one warp per softmax row, lane j on columns j, j + 32, ..");
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCursor cur{smem};
  float* qs = cur.take<float>(tile_bytes<float>(kTile, F::kLdT));
  float* ks = cur.take<float>(tile_bytes<float>(kTile, F::kLdT));
  float* vs = cur.take<float>(tile_bytes<float>(kTile, F::kLdT));
  float* ps = cur.take<float>(tile_bytes<float>(kTile, F::kLdP));
  float* s = cur.take<float>(tile_bytes<float>(kTile, F::kLdS));
  float* acc = cur.take<float>(tile_bytes<float>(kTile, F::kLdA));
  float* m = cur.take<float>(kTile * 4);
  float* l = cur.take<float>(kTile * 4);

  const int q0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.y * L * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows<F, true>(q + base, q0, L, D, qs, scale2);
  zero_acc<F>(acc);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    m[r] = kFlashNegInf;
    l[r] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += kTile) {
    load_rows<F, false>(k + base, k0, L, D, ks, 0.f);
    load_rows<F, false>(v + base, k0, L, D, vs, 0.f);
    __syncthreads();
    gemm<false, true>(s, F::kLdS, qs, F::kLdT, ks, F::kLdT, kTile, kTile, DP, false);
    __syncthreads();
    // online softmax, one warp per row; lane j holds columns j, j + 32, ...
    for (int r = warp; r < kTile; r += kWarps) {
      const float* sr = s + r * F::kLdS;
      float sv[kPer];
      float mx = kFlashNegInf;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = lane + 32 * i;
        sv[i] = k0 + c < L ? sr[c] : kFlashNegInf;
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = exp2f(m_prev - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float p = exp2f(sv[i] - m_new);
        sum += p;
        ps[r * F::kLdP + lane + 32 * i] = p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      float* ar = acc + r * F::kLdA;
      for (int c = lane; c < DP; c += 32) ar[c] *= alpha;
      if (lane == 0) {
        m[r] = m_new;
        l[r] = l[r] * alpha + sum;
      }
    }
    __syncthreads();
    gemm<false, false>(acc, F::kLdA, ps, F::kLdP, vs, F::kLdT, kTile, DP, kTile, true);
    __syncthreads();
  }
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const float lr = l[r];
    l[r] = lr == 0.f ? 1.f : lr;
    if (q0 + r < L) lse[(size_t)blockIdx.y * L + q0 + r] = m[r] + log2f(l[r]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < L) o[base + (size_t)(q0 + r) * D + c] = acc[r * F::kLdA + c] / l[r];
  }
}

template <int DP>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                   int L, int D, float scale2, cudaStream_t stream) {
  using F = FwdDims32<DP>;
  constexpr size_t smem = flash_fwd_smem32<F>();
  cudaError_t err = set_smem(flash_fwd_f32_kernel<DP>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + F::kTile - 1) / F::kTile, BH);
  flash_fwd_f32_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), L, D, scale2);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int L,
               int D, float scale2, int is_bf16, cudaStream_t s) {
  return is_bf16 ? launch_fwd_mma<DP>(q, k, v, o, lse, BH, L, D, scale2, s)
                 : launch_fwd_f32<DP>(q, k, v, o, lse, BH, L, D, scale2, s);
}

// ---------------------------------------------------------------------------
// D > 256: column chunks (flash_attention.cuh, wide head dims)
// ---------------------------------------------------------------------------

// grid (query tiles, BH, column chunks); the block writes columns [z 64, z 64
// + 64) of its query rows of o, and chunk 0 also lse. Scores s = qs k^T are
// summed over every chunk of D; the online softmax runs on them one warp per
// row, p is rounded to T before p v as in the other variants.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, float* __restrict__ lse, int L, int D, float scale2) {
  constexpr int kT = kWideTile, kC = kWideChunk, kLdT = kWideLdT, kLdF = kWideLdF;
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCursor cur{smem};
  T* qs = cur.take<T>(tile_bytes<T>(kT, kLdT));
  T* ks = cur.take<T>(tile_bytes<T>(kT, kLdT));
  T* vs = cur.take<T>(tile_bytes<T>(kT, kLdT));
  T* ps = cur.take<T>(tile_bytes<T>(kT, kLdT));
  float* s = cur.take<float>(tile_bytes<float>(kT, kLdF));
  float* acc = cur.take<float>(tile_bytes<float>(kT, kLdF));
  float* m = cur.take<float>(kT * 4);
  float* l = cur.take<float>(kT * 4);

  const int q0 = blockIdx.x * kT, c_out = blockIdx.z * kC, nch = wide_chunks(D);
  const size_t base = (size_t)blockIdx.y * L * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < kT * kLdF; i += kThreads) acc[i] = 0.f;
  for (int r = threadIdx.x; r < kT; r += kThreads) {
    m[r] = kFlashNegInf;
    l[r] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += kT) {
    for (int c = 0; c < nch; ++c) {
      load_wide<T, true>(qs, q + base, q0, L, c * kC, D, scale2);
      load_wide<T, false>(ks, k + base, k0, L, c * kC, D, 1.f);
      __syncthreads();
      gemm<false, true>(s, kLdF, qs, kLdT, ks, kLdT, kT, kT, kC, c > 0);
      __syncthreads();
    }
    load_wide<T, false>(vs, v + base, k0, L, c_out, D, 1.f);
    // online softmax, one warp per row; lane j holds columns j and j + 32
    for (int r = warp; r < kT; r += kWarps) {
      float sv[kT / 32];
      float mx = kFlashNegInf;
#pragma unroll
      for (int i = 0; i < kT / 32; ++i) {
        const int c = lane + 32 * i;
        sv[i] = k0 + c < L ? s[r * kLdF + c] : kFlashNegInf;
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kT / 32; ++i) {
        const float p = exp2f(sv[i] - m_new);
        sum += p;
        ps[r * kLdT + lane + 32 * i] = from_f32<T>(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      for (int c = lane; c < kC; c += 32) acc[r * kLdF + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m[r] = m_new;
        l[r] = l[r] * alpha + sum;
      }
    }
    __syncthreads();
    gemm<false, false>(acc, kLdF, ps, kLdT, vs, kLdT, kT, kC, kT, true);
    __syncthreads();
  }
  for (int r = threadIdx.x; r < kT; r += kThreads) {
    const float lr = l[r] == 0.f ? 1.f : l[r];
    l[r] = lr;
    if (blockIdx.z == 0 && q0 + r < L) lse[(size_t)blockIdx.y * L + q0 + r] = m[r] + log2f(lr);
  }
  __syncthreads();
  store_wide<T>(o + base, acc, 1.f, l, q0, L, c_out, D);
}

template <typename T>
int launch_fwd_wide(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                    int L, int D, float scale2, cudaStream_t stream) {
  const size_t smem = 4 * tile_bytes<T>(kWideTile, kWideLdT) +
                      2 * tile_bytes<float>(kWideTile, kWideLdF) + 2 * kWideTile * 4;
  cudaError_t err = set_smem(flash_fwd_wide_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kWideTile - 1) / kWideTile, BH, wide_chunks(D));
  flash_fwd_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), L, D, scale2);
  return (int)cudaGetLastError();
}

}  // namespace lcbi

// q, k, v, o: (BH, L, D) contiguous in T (fp32 if is_bf16 == 0, else bf16);
// lse: (BH, L) fp32. D >= 1, 0 < BH < 65536, all pointers 32-byte aligned.
// scale2 = scale * log2(e). Returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for a shape it does not take).
extern "C" int lcbi_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int BH, int L, int D, float scale2, int is_bf16, void* stream) {
  (void)cudaGetLastError();
  if (!lcbi::flash_shape_ok(BH, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > lcbi::kFlashMaxPadded)
    return is_bf16 ? lcbi::launch_fwd_wide<lcbi::bf16>(q, k, v, o, lse, BH, L, D, scale2, s)
                   : lcbi::launch_fwd_wide<float>(q, k, v, o, lse, BH, L, D, scale2, s);
  switch (lcbi::flash_padded_dim(D)) {
    case 16: return lcbi::launch_fwd<16>(q, k, v, o, lse, BH, L, D, scale2, is_bf16, s);
    case 32: return lcbi::launch_fwd<32>(q, k, v, o, lse, BH, L, D, scale2, is_bf16, s);
    case 64: return lcbi::launch_fwd<64>(q, k, v, o, lse, BH, L, D, scale2, is_bf16, s);
    case 128: return lcbi::launch_fwd<128>(q, k, v, o, lse, BH, L, D, scale2, is_bf16, s);
    default: return lcbi::launch_fwd<256>(q, k, v, o, lse, BH, L, D, scale2, is_bf16, s);
  }
}
