// Flash attention (K5), backward, dk and dv: for each key, the sums over all
// queries of ds^T q and p^T do, from the forward's saved lse and delta =
// rowsum(do * o) (see flash_attention.cuh for the formulas and the
// roundings: ds and p are rounded to T, dk is contracted against the
// unscaled q and scaled once at the end).
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/flash_attention.py
// _dkv_kernel (launched by _flash_bwd); with flash_attention_dq.cu it also
// covers the single-sweep _bwd_fused_kernel.
//
// What bounds it on the H100: four products per (key tile, query tile) pair
// (qs k^T and do v^T recomputed, p^T do, ds^T q), 8 L^2 D FLOPs per head on
// the tensor cores, plus L^2 exp2 (at D = 64 nearly as costly as the
// products).
//
// What the bf16 design does about it: a block owns a tile of keys whose k
// and v stay resident in shared memory, and walks every query tile in order,
// q, do, lse and delta coming through a two-stage ring (q and do by cp.async)
// that overlaps the next tile's copy with this tile's products. Once per
// tile the block writes qs = round_T(q * scale2) (the forward's qs) beside
// the unscaled q, which dk contracts against. Each warp owns 16 or 32 keys
// and computes the transposed score s^T = k qs^T and dp^T = v do^T as
// mma.sync fragments (operands by ldmatrix); p^T = exp2(s^T - lse) and ds^T
// = p^T (dp^T - delta) are computed on the fragments and rounded to bf16 in
// registers as the A operands of dv += p^T do and dk += ds^T q (B by
// ldmatrix.trans), whose fp32 accumulators stay in registers. dk and dv are
// written once through a staging tile as 16-byte stores, with no atomics
// (deterministic). Registers and the ldmatrix reads bound the tiles: a warp's
// dk and dv take 2 kDPg floats a thread per 16 keys, and a warp with 16 keys
// reads each q and do fragment for one mma row tile only, so
//     DP <= 64: 4 warps of 32 keys (128 a block), 64 queries a tile walked
//               in steps of 32, G = 1;
//     DP = 128: 8 warps, 64 keys, 64 queries, G = 2 (64 columns a warp);
//     DP = 256: 8 warps, 32 keys, 64 queries, G = 4 (64 columns a warp),
// where above DP = 64 the accumulator columns split among G warps that share
// a key row tile, each recomputing s^T and dp^T; shared memory stays at or
// under 199 KiB. The heights are the fastest of the variants that
// utils/k5_tiles.py times at (12, 16385, D) for D = 64, 128 and 256
// (PERF.md), but at DP <= 64, where 32-query tiles read 0.5-3% faster in
// two runs and the shipped 64 stays.
//
// fp32 (tests and checks only): every tile in shared memory, full-fp32 FMA
// loops; not redesigned.
#include "flash_attention.cuh"

namespace lcbi {

// ---------------------------------------------------------------------------
// bf16: tensor-core fragments
// ---------------------------------------------------------------------------

template <int DP> struct DkvCfg {
  static constexpr int kG = DP <= 64 ? 1 : DP / 64;       // warps sharing a key row tile
  static constexpr int kDPg = DP / kG;                     // accumulator columns a warp
  static constexpr int kMT = DP <= 64 ? 2 : 1;             // 16-key mma tiles per warp
  static constexpr int kWarps = DP <= 64 ? 4 : 8, kThreads = kWarps * 32;
  static constexpr int kBN = kWarps / kG * 16 * kMT;       // keys per block
  static constexpr int kBM = 64;                           // queries per staged tile
  static constexpr int kSub = DP <= 64 ? 32 : kBM;         // queries per step of the products
  static constexpr int kLd = DP + 8;
  static constexpr size_t kSmem =
      (size_t)(2 * kBN + 5 * kBM) * kLd * sizeof(bf16) + 4 * kBM * sizeof(float);
};

// grid (key tiles, BH); q, k, v, do, dk, dv: (BH, L, D) bf16; lse, delta:
// (BH, L) fp32; scale_out = scale2 / log2(e), the softmax scale.
template <int DP>
__global__ void __launch_bounds__(DkvCfg<DP>::kThreads)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int D, float scale2,
                     float scale_out) {
  using C = DkvCfg<DP>;
  constexpr int kG = C::kG, kDPg = C::kDPg, kMT = C::kMT, kBN = C::kBN, kBM = C::kBM;
  constexpr int kSub = C::kSub, kLd = C::kLd;
  constexpr int kNT = kSub / 8, kDT = kDPg / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBN * kLd;
  bf16* Qs = Vs + kBN * kLd;          // q as loaded, two stages
  bf16* Ds = Qs + 2 * kBM * kLd;      // do, two stages
  bf16* Ss = Ds + 2 * kBM * kLd;      // round_T(q * scale2) of the current tile
  float* Ls = reinterpret_cast<float*>(Ss + kBM * kLd);  // lse, two stages
  float* Es = Ls + 2 * kBM;                               // delta, two stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kw = (warp / kG) * 16 * kMT, c0 = (warp % kG) * kDPg;
  const int n0 = blockIdx.x * kBN;
  const size_t base = (size_t)blockIdx.y * L * D;
  const float* lse_b = lse + (size_t)blockIdx.y * L;
  const float* delta_b = delta + (size_t)blockIdx.y * L;
  const bool vec = D % 8 == 0;
  const int nqt = (L + kBM - 1) / kBM;

  // lse and delta of query q0 + threadIdx.x (threads below kBM <= kThreads);
  // queries at or past L take lse = +inf and delta = 0: their p is exactly 0
  static_assert(kBM <= C::kThreads, "one thread per query of a tile");
  auto fetch_stats = [&](int q0, float& ls, float& dl) {
    const int r = q0 + threadIdx.x;
    ls = r < L ? lse_b[r] : INFINITY;
    dl = r < L ? delta_b[r] : 0.f;
  };
  load_tile_bf16<DP, kBN>(Ks, k + base, n0, L, D, vec, C::kThreads);
  load_tile_bf16<DP, kBN>(Vs, v + base, n0, L, D, vec, C::kThreads);
  load_tile_bf16<DP, kBM>(Qs, q + base, 0, L, D, vec, C::kThreads);
  load_tile_bf16<DP, kBM>(Ds, dout + base, 0, L, D, vec, C::kThreads);
  cp_async_commit();
  if (threadIdx.x < kBM) fetch_stats(0, Ls[threadIdx.x], Es[threadIdx.x]);

  float dka[kMT][kDT][4], dva[kMT][kDT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[mt][dt][e] = dva[mt][dt][e] = 0.f;

  for (int j = 0; j < nqt; ++j) {
    // the next tile's lse and delta go to registers now and to their stage
    // at the end of this step, so their load's latency hides behind it
    float next_ls = 0.f, next_dl = 0.f;
    if (j + 1 < nqt) {
      const int st = (j + 1) & 1;
      load_tile_bf16<DP, kBM>(Qs + st * kBM * kLd, q + base, (j + 1) * kBM, L, D, vec,
                              C::kThreads);
      load_tile_bf16<DP, kBM>(Ds + st * kBM * kLd, dout + base, (j + 1) * kBM, L, D, vec,
                              C::kThreads);
      cp_async_commit();
      if (threadIdx.x < kBM) fetch_stats((j + 1) * kBM, next_ls, next_dl);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + (j & 1) * kBM * kLd;
    const bf16* Dt = Ds + (j & 1) * kBM * kLd;
    const float* lse_t = Ls + (j & 1) * kBM;
    const float* delta_t = Es + (j & 1) * kBM;
    // qs = round_T(q * scale2), once per tile for all warps
    for (int e = threadIdx.x; e < kBM * DP / 8; e += C::kThreads) {
      const int r = e / (DP / 8), c = (e % (DP / 8)) * 8;
      uint4 w = *reinterpret_cast<const uint4*>(Qt + r * kLd + c);
      w.x = scale_bf16x2(w.x, scale2);
      w.y = scale_bf16x2(w.y, scale2);
      w.z = scale_bf16x2(w.z, scale2);
      w.w = scale_bf16x2(w.w, scale2);
      *reinterpret_cast<uint4*>(Ss + r * kLd + c) = w;
    }
    __syncthreads();

#pragma unroll 1
    for (int sub = 0; sub < kBM / kSub; ++sub) {
      const int r0 = sub * kSub;
      // s^T = k qs^T and dp^T = v do^T: keys on rows, queries on columns
      float s[kMT][kNT][4], dp[kMT][kNT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][nt][e] = dp[mt][nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t ak[kMT][4], av[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          frag_a(ak[mt], Ks, kLd, kw + mt * 16, kk * 16, lane);
          frag_a(av[mt], Vs, kLd, kw + mt * 16, kk * 16, lane);
        }
#pragma unroll
        for (int n2 = 0; n2 < kNT / 2; ++n2) {
          uint32_t bq[4], bd[4];
          frag_b_rows(bq, Ss, kLd, r0 + n2 * 16, kk * 16, lane);
          frag_b_rows(bd, Dt, kLd, r0 + n2 * 16, kk * 16, lane);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(s[mt][2 * n2], ak[mt], bq[0], bq[1]);
            mma_bf16(s[mt][2 * n2 + 1], ak[mt], bq[2], bq[3]);
            mma_bf16(dp[mt][2 * n2], av[mt], bd[0], bd[1]);
            mma_bf16(dp[mt][2 * n2 + 1], av[mt], bd[2], bd[3]);
          }
        }
      }
      // p^T = exp2(s^T - lse), ds^T = p^T (dp^T - delta), per query column
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int c = r0 + nt * 8 + 2 * t + e2;
          const float ls = lse_t[c], dl = delta_t[c];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int e = 2 * h + e2;
              const float p = fast_exp2(s[mt][nt][e] - ls);
              s[mt][nt][e] = p;
              dp[mt][nt][e] = p * (dp[mt][nt][e] - dl);
            }
        }
      // dv += round(p^T) do, dk += round(ds^T) q (the unscaled q)
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t ap[kMT][4], ad[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          acc_to_a(ap[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
          acc_to_a(ad[mt], dp[mt][2 * kk], dp[mt][2 * kk + 1]);
        }
#pragma unroll
        for (int d2 = 0; d2 < kDPg / 16; ++d2) {
          uint32_t bo[4], bq[4];
          frag_b_cols(bo, Dt, kLd, r0 + kk * 16, c0 + d2 * 16, lane);
          frag_b_cols(bq, Qt, kLd, r0 + kk * 16, c0 + d2 * 16, lane);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(dva[mt][2 * d2], ap[mt], bo[0], bo[1]);
            mma_bf16(dva[mt][2 * d2 + 1], ap[mt], bo[2], bo[3]);
            mma_bf16(dka[mt][2 * d2], ad[mt], bq[0], bq[1]);
            mma_bf16(dka[mt][2 * d2 + 1], ad[mt], bq[2], bq[3]);
          }
        }
      }
    }
    if (j + 1 < nqt && threadIdx.x < kBM) {
      Ls[((j + 1) & 1) * kBM + threadIdx.x] = next_ls;
      Es[((j + 1) & 1) * kBM + threadIdx.x] = next_dl;
    }
    __syncthreads();  // the stage and qs read here are the ones the next step refills
  }

  // dk = dka * scale and dv, staged over the k and v tiles (no warp reads
  // them any more), then stored by the whole block
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = kw + mt * 16 + g + 8 * h;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        const int c = c0 + dt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(Ks + r * kLd + c) =
            pack_bf16(dka[mt][dt][2 * h] * scale_out, dka[mt][dt][2 * h + 1] * scale_out);
        *reinterpret_cast<uint32_t*>(Vs + r * kLd + c) =
            pack_bf16(dva[mt][dt][2 * h], dva[mt][dt][2 * h + 1]);
      }
    }
  __syncthreads();
  store_tile_bf16<DP, kBN>(dk + base, Ks, n0, L, D, vec, threadIdx.x, C::kThreads);
  store_tile_bf16<DP, kBN>(dv + base, Vs, n0, L, D, vec, threadIdx.x, C::kThreads);
}

template <int DP>
int launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int BH, int L, int D,
                   float scale2, float scale_out, cudaStream_t stream) {
  using C = DkvCfg<DP>;
  cudaError_t err = set_smem(flash_dkv_mma_kernel<DP>, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + C::kBN - 1) / C::kBN, BH);
  flash_dkv_mma_kernel<DP><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, D,
      scale2, scale_out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core loops on shared-memory tiles
// ---------------------------------------------------------------------------

// 16-row tiles at DP = 256, where 32 rows of its eleven tiles outgrow 227 KB.
template <int DP> using DkvDims32 = FlashDims<DP, DP <= 64 ? 64 : DP == 128 ? 32 : 16>;

template <typename F> constexpr size_t flash_dkv_smem32() {
  return 5 * tile_bytes<float>(F::kTile, F::kLdT) + 2 * tile_bytes<float>(F::kTile, F::kLdP) +
         2 * tile_bytes<float>(F::kTile, F::kLdS) + 2 * tile_bytes<float>(F::kTile, F::kLdA) +
         2 * F::kTile * 4;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int L, int D, float scale2,
                     float scale_out) {
  using F = DkvDims32<DP>;
  constexpr int kTile = F::kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCursor cur{smem};
  float* ks = cur.take<float>(tile_bytes<float>(kTile, F::kLdT));
  float* vs = cur.take<float>(tile_bytes<float>(kTile, F::kLdT));
  float* qs = cur.take<float>(tile_bytes<float>(kTile, F::kLdT));
  float* qr = cur.take<float>(tile_bytes<float>(kTile, F::kLdT));
  float* dos = cur.take<float>(tile_bytes<float>(kTile, F::kLdT));
  float* pt = cur.take<float>(tile_bytes<float>(kTile, F::kLdP));
  float* dst = cur.take<float>(tile_bytes<float>(kTile, F::kLdP));
  float* s = cur.take<float>(tile_bytes<float>(kTile, F::kLdS));
  float* dp = cur.take<float>(tile_bytes<float>(kTile, F::kLdS));
  float* dk_acc = cur.take<float>(tile_bytes<float>(kTile, F::kLdA));
  float* dv_acc = cur.take<float>(tile_bytes<float>(kTile, F::kLdA));
  float* lse_t = cur.take<float>(kTile * 4);
  float* delta_t = cur.take<float>(kTile * 4);

  const int k0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.y * L * D;
  const size_t vbase = (size_t)blockIdx.y * L;

  load_rows<F, false>(k + base, k0, L, D, ks, 0.f);
  load_rows<F, false>(v + base, k0, L, D, vs, 0.f);
  zero_acc<F>(dk_acc);
  zero_acc<F>(dv_acc);
  for (int q0 = 0; q0 < L; q0 += kTile) {
    load_rows<F, true>(q + base, q0, L, D, qs, scale2);
    load_rows<F, false>(q + base, q0, L, D, qr, 0.f);
    load_rows<F, false>(dout + base, q0, L, D, dos, 0.f);
    load_vec<F>(lse + vbase, q0, L, lse_t);
    load_vec<F>(delta + vbase, q0, L, delta_t);
    __syncthreads();
    gemm<false, true>(s, F::kLdS, qs, F::kLdT, ks, F::kLdT, kTile, kTile, DP, false);
    gemm<false, true>(dp, F::kLdS, dos, F::kLdT, vs, F::kLdT, kTile, kTile, DP, false);
    __syncthreads();
    probs_and_dscores<F>(s, dp, lse_t, delta_t, q0, k0, L, pt, dst);
    __syncthreads();
    // keys on rows: dv += p^T do, dk += ds^T q (A read column-major)
    gemm<true, false>(dv_acc, F::kLdA, pt, F::kLdP, dos, F::kLdT, kTile, DP, kTile, true);
    gemm<true, false>(dk_acc, F::kLdA, dst, F::kLdP, qr, F::kLdT, kTile, DP, kTile, true);
    __syncthreads();
  }
  store_rows<F>(dk_acc, scale_out, k0, L, D, dk + base);
  store_rows<F>(dv_acc, 1.f, k0, L, D, dv + base);
}

template <int DP>
int launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, void* dk, void* dv, int BH, int L, int D, float scale2,
                   float scale_out, cudaStream_t stream) {
  using F = DkvDims32<DP>;
  constexpr size_t smem = flash_dkv_smem32<F>();
  cudaError_t err = set_smem(flash_dkv_f32_kernel<DP>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + F::kTile - 1) / F::kTile, BH);
  flash_dkv_f32_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), L, D,
      scale2, scale_out);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int BH, int L, int D, float scale2,
               float scale_out, int is_bf16, cudaStream_t s) {
  return is_bf16 ? launch_dkv_mma<DP>(q, k, v, dout, lse, delta, dk, dv, BH, L, D, scale2,
                                      scale_out, s)
                 : launch_dkv_f32<DP>(q, k, v, dout, lse, delta, dk, dv, BH, L, D, scale2,
                                      scale_out, s);
}

// ---------------------------------------------------------------------------
// D > 256: column chunks (flash_attention.cuh, wide head dims)
// ---------------------------------------------------------------------------

// grid (key tiles, BH, column chunks); the block writes columns [z 64, z 64 +
// 64) of its keys' rows of dk and dv. s^T = k qs^T and dp^T = v do^T are
// summed over every chunk of D; p^T and ds^T are rounded to T before dv +=
// p^T do and dk += ds^T q (the unscaled q), dk scaled once at the end.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int L, int D, float scale2, float scale_out) {
  constexpr int kT = kWideTile, kC = kWideChunk, kLdT = kWideLdT, kLdF = kWideLdF;
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCursor cur{smem};
  T* ks = cur.take<T>(tile_bytes<T>(kT, kLdT));
  T* vs = cur.take<T>(tile_bytes<T>(kT, kLdT));
  T* qs = cur.take<T>(tile_bytes<T>(kT, kLdT));
  T* dos = cur.take<T>(tile_bytes<T>(kT, kLdT));
  T* pt = cur.take<T>(tile_bytes<T>(kT, kLdT));
  T* dst = cur.take<T>(tile_bytes<T>(kT, kLdT));
  float* st = cur.take<float>(tile_bytes<float>(kT, kLdF));
  float* dpt = cur.take<float>(tile_bytes<float>(kT, kLdF));
  float* dk_acc = cur.take<float>(tile_bytes<float>(kT, kLdF));
  float* dv_acc = cur.take<float>(tile_bytes<float>(kT, kLdF));
  float* lse_t = cur.take<float>(kT * 4);
  float* delta_t = cur.take<float>(kT * 4);

  const int k0 = blockIdx.x * kT, c_out = blockIdx.z * kC, nch = wide_chunks(D);
  const size_t base = (size_t)blockIdx.y * L * D;
  for (int i = threadIdx.x; i < kT * kLdF; i += kThreads) dk_acc[i] = dv_acc[i] = 0.f;
  for (int q0 = 0; q0 < L; q0 += kT) {
    load_wide_vec(lse + (size_t)blockIdx.y * L, q0, L, lse_t);
    load_wide_vec(delta + (size_t)blockIdx.y * L, q0, L, delta_t);
    for (int c = 0; c < nch; ++c) {
      load_wide<T, false>(ks, k + base, k0, L, c * kC, D, 1.f);
      load_wide<T, false>(vs, v + base, k0, L, c * kC, D, 1.f);
      load_wide<T, true>(qs, q + base, q0, L, c * kC, D, scale2);
      load_wide<T, false>(dos, dout + base, q0, L, c * kC, D, 1.f);
      __syncthreads();
      gemm<false, true>(st, kLdF, ks, kLdT, qs, kLdT, kT, kT, kC, c > 0);
      gemm<false, true>(dpt, kLdF, vs, kLdT, dos, kLdT, kT, kT, kC, c > 0);
      __syncthreads();
    }
    // keys on rows, queries on columns
    for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
      const int j = i / kT, r = i % kT;
      const bool live = k0 + j < L && q0 + r < L;
      const float p = live ? exp2f(st[j * kLdF + r] - lse_t[r]) : 0.f;
      pt[j * kLdT + r] = from_f32<T>(p);
      dst[j * kLdT + r] = from_f32<T>(p * (dpt[j * kLdF + r] - delta_t[r]));
    }
    load_wide<T, false>(qs, q + base, q0, L, c_out, D, 1.f);
    load_wide<T, false>(dos, dout + base, q0, L, c_out, D, 1.f);
    __syncthreads();
    gemm<false, false>(dv_acc, kLdF, pt, kLdT, dos, kLdT, kT, kC, kT, true);
    gemm<false, false>(dk_acc, kLdF, dst, kLdT, qs, kLdT, kT, kC, kT, true);
    __syncthreads();
  }
  store_wide<T>(dk + base, dk_acc, scale_out, nullptr, k0, L, c_out, D);
  store_wide<T>(dv + base, dv_acc, 1.f, nullptr, k0, L, c_out, D);
}

template <typename T>
int launch_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int BH, int L, int D,
                    float scale2, float scale_out, cudaStream_t stream) {
  const size_t smem = 6 * tile_bytes<T>(kWideTile, kWideLdT) +
                      4 * tile_bytes<float>(kWideTile, kWideLdF) + 2 * kWideTile * 4;
  cudaError_t err = set_smem(flash_dkv_wide_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kWideTile - 1) / kWideTile, BH, wide_chunks(D));
  flash_dkv_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), L, D, scale2,
      scale_out);
  return (int)cudaGetLastError();
}

}  // namespace lcbi

// q, k, v, dout, dk, dv: (BH, L, D) contiguous in T (fp32 if is_bf16 == 0,
// else bf16); lse (the forward's) and delta = rowsum(dout * o): (BH, L) fp32.
// D >= 1, 0 < BH < 65536, pointers 32-byte aligned. scale2 = scale *
// log2(e), scale_out = scale. Returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for a shape it does not take).
extern "C" int lcbi_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int BH,
                                  int L, int D, float scale2, float scale_out, int is_bf16,
                                  void* stream) {
  (void)cudaGetLastError();
  if (!lcbi::flash_shape_ok(BH, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > lcbi::kFlashMaxPadded)
    return is_bf16 ? lcbi::launch_dkv_wide<lcbi::bf16>(q, k, v, dout, lse, delta, dk, dv, BH, L,
                                                       D, scale2, scale_out, s)
                   : lcbi::launch_dkv_wide<float>(q, k, v, dout, lse, delta, dk, dv, BH, L, D,
                                                  scale2, scale_out, s);
  switch (lcbi::flash_padded_dim(D)) {
    case 16:
      return lcbi::launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, BH, L, D, scale2, scale_out,
                                  is_bf16, s);
    case 32:
      return lcbi::launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, BH, L, D, scale2, scale_out,
                                  is_bf16, s);
    case 64:
      return lcbi::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, BH, L, D, scale2, scale_out,
                                  is_bf16, s);
    case 128:
      return lcbi::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, BH, L, D, scale2,
                                   scale_out, is_bf16, s);
    default:
      return lcbi::launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, BH, L, D, scale2,
                                   scale_out, is_bf16, s);
  }
}
