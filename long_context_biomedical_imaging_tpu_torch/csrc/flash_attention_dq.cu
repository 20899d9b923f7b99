// Flash attention (K5), backward, dq: for each query, the sum over all keys
// of ds k, from the forward's saved lse and delta = rowsum(do * o) (see
// flash_attention.cuh for the formulas and the roundings).
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/flash_attention.py
// _dq_kernel (launched by _flash_bwd). Together with flash_attention_dkv.cu it
// also covers _bwd_fused_kernel, the TPU's single-sweep variant for dq, dk
// and dv, which exists to fit v5e's VMEM budget and is not ported.
//
// What bounds it on the H100: three products per (query tile, key tile) pair
// (qs k^T recomputed, do v^T, ds k), 6 L^2 D FLOPs per head on the tensor
// cores, plus L^2 exp2 (at D = 64 nearly as costly as the products).
//
// What the bf16 design does about it: a block of 4 warps owns a tile of
// queries, each warp its own rows, with its scaled q and do tiles loaded once
// into shared memory and each row's lse and delta in registers. It walks
// every key tile in order, k and v coming through a two-stage cp.async ring
// that overlaps the next tile's copy with this tile's products. Per step of
// kSub keys a warp computes s
// = qs k^T and dp = do v^T as mma.sync fragments (operands by ldmatrix),
// p = exp2(s - lse) and ds = p (dp - delta) on those fragments (keys at or
// past L score -1e30, so p = 0), rounds ds to bf16 in registers and feeds
// it straight in as the A operand of ds k (k's B fragments by
// ldmatrix.trans) into an fp32 accumulator in registers. dq is written once,
// scaled, through a staging tile as 16-byte stores, with no atomics
// (deterministic). The ldmatrix reads of shared memory, not the tensor
// cores, bound a warp that owns 16 rows (each k and v fragment feeds one mma
// row tile), so up to DP = 64 a warp owns 32 rows (128 a block) and walks a
// 64-key tile in two steps of 32 keys, which keeps its score, dp and dq
// fragments within the registers; DP = 128 and 256: 16 rows a warp, 64
// keys a step (at DP = 256 the accumulator alone takes 128 registers). The
// heights are the fastest of the variants that utils/k5_tiles.py times at
// (12, 16385, D) for D = 64, 128 and 256 (PERF.md).
//
// fp32 (tests and checks only): every tile in shared memory, full-fp32 FMA
// loops; not redesigned.
#include "flash_attention.cuh"

namespace lcbi {

// ---------------------------------------------------------------------------
// bf16: tensor-core fragments
// ---------------------------------------------------------------------------

template <int DP> struct DqCfg {
  static constexpr int kWarps = 4, kThreads = kWarps * 32;
  static constexpr int kMT = DP <= 64 ? 2 : 1;            // 16-row mma tiles per warp
  static constexpr int kBM = kWarps * 16 * kMT;           // queries per block
  static constexpr int kBN = 64;                          // keys per staged tile
  static constexpr int kSub = DP <= 64 ? 32 : kBN;        // keys per step of the products
  static constexpr int kLd = DP + 8;
  static constexpr size_t kSmem = (size_t)(2 * kBM + 4 * kBN) * kLd * sizeof(bf16);
};

// grid (query tiles, BH); q, k, v, do, dq: (BH, L, D) bf16; lse, delta: (BH,
// L) fp32; scale_out = scale2 / log2(e), the softmax scale.
template <int DP>
__global__ void __launch_bounds__(DqCfg<DP>::kThreads)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int L, int D, float scale2, float scale_out) {
  using C = DqCfg<DP>;
  constexpr int kMT = C::kMT, kBM = C::kBM, kBN = C::kBN, kSub = C::kSub, kLd = C::kLd;
  constexpr int kNT = kSub / 8, kDT = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = Qs + kBM * kLd;
  bf16* Ks = Ds + kBM * kLd;
  bf16* Vs = Ks + 2 * kBN * kLd;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBM;
  const size_t base = (size_t)blockIdx.y * L * D;
  const bool vec = D % 8 == 0;
  const int nkt = (L + kBN - 1) / kBN;
  const int wrow = warp * 16 * kMT;

  load_tile_bf16<DP, kBM>(Ds, dout + base, m0, L, D, vec, C::kThreads);
  load_tile_bf16<DP, kBN>(Ks, k + base, 0, L, D, vec, C::kThreads);
  load_tile_bf16<DP, kBN>(Vs, v + base, 0, L, D, vec, C::kThreads);
  cp_async_commit();
  load_tile_scaled_bf16<DP, kBM>(Qs, q + base, m0, L, D, vec, scale2, C::kThreads);

  // rows g and g + 8 of each of the warp's row tiles; rows at or past L take
  // 0, so their p and ds stay finite (their dq is never stored)
  float lse_r[kMT][2], delta_r[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wrow + mt * 16 + g + 8 * h;
      lse_r[mt][h] = r < L ? lse[(size_t)blockIdx.y * L + r] : 0.f;
      delta_r[mt][h] = r < L ? delta[(size_t)blockIdx.y * L + r] : 0.f;
    }
  float acc[kMT][kDT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dt][e] = 0.f;

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

#pragma unroll 1
    for (int sub = 0; sub < kBN / kSub; ++sub) {
      const bf16* Kt = Ks + ((j & 1) * kBN + sub * kSub) * kLd;
      const bf16* Vt = Vs + ((j & 1) * kBN + sub * kSub) * kLd;
      const int k0 = j * kBN + sub * kSub;
      // s = qs k^T, dp = do v^T over kSub keys
      float s[kMT][kNT][4], dp[kMT][kNT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][nt][e] = dp[mt][nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t aq[kMT][4], ad[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          frag_a(aq[mt], Qs, kLd, wrow + mt * 16, kk * 16, lane);
          frag_a(ad[mt], Ds, kLd, wrow + mt * 16, kk * 16, lane);
        }
#pragma unroll
        for (int n2 = 0; n2 < kNT / 2; ++n2) {
          uint32_t bk[4], bv[4];
          frag_b_rows(bk, Kt, kLd, n2 * 16, kk * 16, lane);
          frag_b_rows(bv, Vt, kLd, n2 * 16, kk * 16, lane);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(s[mt][2 * n2], aq[mt], bk[0], bk[1]);
            mma_bf16(s[mt][2 * n2 + 1], aq[mt], bk[2], bk[3]);
            mma_bf16(dp[mt][2 * n2], ad[mt], bv[0], bv[1]);
            mma_bf16(dp[mt][2 * n2 + 1], ad[mt], bv[2], bv[3]);
          }
        }
      }
      // p = exp2(s - lse) (keys at or past L score -1e30: p = 0); ds = p (dp - delta)
      const bool ragged = k0 + kSub > L;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool dead = ragged && k0 + nt * 8 + 2 * t + (e & 1) >= L;
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            const int h = e >> 1;
            const float p = fast_exp2((dead ? kFlashNegInf : s[mt][nt][e]) - lse_r[mt][h]);
            s[mt][nt][e] = p * (dp[mt][nt][e] - delta_r[mt][h]);
          }
        }
      // acc += round(ds) k
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t a[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) acc_to_a(a[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
        for (int d2 = 0; d2 < DP / 16; ++d2) {
          uint32_t b[4];
          frag_b_cols(b, Kt, kLd, kk * 16, d2 * 16, lane);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(acc[mt][2 * d2], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * d2 + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // the stage read here is the one the next step refills
  }

  // dq = acc * scale, staged over the warp's own rows of the q tile
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wrow + mt * 16 + g + 8 * h;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<uint32_t*>(Qs + r * kLd + dt * 8 + 2 * t) =
            pack_bf16(acc[mt][dt][2 * h] * scale_out, acc[mt][dt][2 * h + 1] * scale_out);
    }
  __syncwarp();
  store_tile_bf16<DP, 16 * kMT>(dq + base, Qs + wrow * kLd, m0 + wrow, L, D, vec, lane, 32);
}

template <int DP>
int launch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, int BH, int L, int D,
                  float scale2, float scale_out, cudaStream_t stream) {
  using C = DqCfg<DP>;
  cudaError_t err = set_smem(flash_dq_mma_kernel<DP>, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + C::kBM - 1) / C::kBM, BH);
  flash_dq_mma_kernel<DP><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), L, D, scale2, scale_out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core loops on shared-memory tiles
// ---------------------------------------------------------------------------

template <int DP> using DqDims32 = FlashDims<DP, DP <= 64 ? 64 : 32>;

template <typename F> constexpr size_t flash_dq_smem32() {
  return 4 * tile_bytes<float>(F::kTile, F::kLdT) + tile_bytes<float>(F::kTile, F::kLdP) +
         2 * tile_bytes<float>(F::kTile, F::kLdS) + tile_bytes<float>(F::kTile, F::kLdA) +
         2 * F::kTile * 4;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int L, int D, float scale2, float scale_out) {
  using F = DqDims32<DP>;
  constexpr int kTile = F::kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCursor cur{smem};
  float* qs = cur.take<float>(tile_bytes<float>(kTile, F::kLdT));
  float* dos = cur.take<float>(tile_bytes<float>(kTile, F::kLdT));
  float* ks = cur.take<float>(tile_bytes<float>(kTile, F::kLdT));
  float* vs = cur.take<float>(tile_bytes<float>(kTile, F::kLdT));
  float* dst = cur.take<float>(tile_bytes<float>(kTile, F::kLdP));
  float* s = cur.take<float>(tile_bytes<float>(kTile, F::kLdS));
  float* dp = cur.take<float>(tile_bytes<float>(kTile, F::kLdS));
  float* acc = cur.take<float>(tile_bytes<float>(kTile, F::kLdA));
  float* lse_t = cur.take<float>(kTile * 4);
  float* delta_t = cur.take<float>(kTile * 4);

  const int q0 = blockIdx.x * kTile;
  const size_t base = (size_t)blockIdx.y * L * D;
  const size_t vbase = (size_t)blockIdx.y * L;

  load_rows<F, true>(q + base, q0, L, D, qs, scale2);
  load_rows<F, false>(dout + base, q0, L, D, dos, 0.f);
  load_vec<F>(lse + vbase, q0, L, lse_t);
  load_vec<F>(delta + vbase, q0, L, delta_t);
  zero_acc<F>(acc);
  for (int k0 = 0; k0 < L; k0 += kTile) {
    load_rows<F, false>(k + base, k0, L, D, ks, 0.f);
    load_rows<F, false>(v + base, k0, L, D, vs, 0.f);
    __syncthreads();
    gemm<false, true>(s, F::kLdS, qs, F::kLdT, ks, F::kLdT, kTile, kTile, DP, false);
    gemm<false, true>(dp, F::kLdS, dos, F::kLdT, vs, F::kLdT, kTile, kTile, DP, false);
    __syncthreads();
    probs_and_dscores<F>(s, dp, lse_t, delta_t, q0, k0, L, nullptr, dst);
    __syncthreads();
    gemm<false, false>(acc, F::kLdA, dst, F::kLdP, ks, F::kLdT, kTile, DP, kTile, true);
    __syncthreads();
  }
  store_rows<F>(acc, scale_out, q0, L, D, dq + base);
}

template <int DP>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* delta, void* dq, int BH, int L, int D, float scale2,
                  float scale_out, cudaStream_t stream) {
  using F = DqDims32<DP>;
  constexpr size_t smem = flash_dq_smem32<F>();
  cudaError_t err = set_smem(flash_dq_f32_kernel<DP>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + F::kTile - 1) / F::kTile, BH);
  flash_dq_f32_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), L, D, scale2, scale_out);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int BH, int L, int D, float scale2, float scale_out,
              int is_bf16, cudaStream_t s) {
  return is_bf16 ? launch_dq_mma<DP>(q, k, v, dout, lse, delta, dq, BH, L, D, scale2, scale_out, s)
                 : launch_dq_f32<DP>(q, k, v, dout, lse, delta, dq, BH, L, D, scale2, scale_out, s);
}

// ---------------------------------------------------------------------------
// D > 256: column chunks (flash_attention.cuh, wide head dims)
// ---------------------------------------------------------------------------

// grid (query tiles, BH, column chunks); the block writes columns [z 64, z 64
// + 64) of its rows of dq. s = qs k^T and dp = do v^T are summed over every
// chunk of D; ds = p (dp - delta) is rounded to T before ds k.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq, int L, int D,
                     float scale2, float scale_out) {
  constexpr int kT = kWideTile, kC = kWideChunk, kLdT = kWideLdT, kLdF = kWideLdF;
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCursor cur{smem};
  T* qs = cur.take<T>(tile_bytes<T>(kT, kLdT));
  T* dos = cur.take<T>(tile_bytes<T>(kT, kLdT));
  T* ks = cur.take<T>(tile_bytes<T>(kT, kLdT));
  T* vs = cur.take<T>(tile_bytes<T>(kT, kLdT));
  T* dss = cur.take<T>(tile_bytes<T>(kT, kLdT));
  float* s = cur.take<float>(tile_bytes<float>(kT, kLdF));
  float* dp = cur.take<float>(tile_bytes<float>(kT, kLdF));
  float* acc = cur.take<float>(tile_bytes<float>(kT, kLdF));
  float* lse_t = cur.take<float>(kT * 4);
  float* delta_t = cur.take<float>(kT * 4);

  const int q0 = blockIdx.x * kT, c_out = blockIdx.z * kC, nch = wide_chunks(D);
  const size_t base = (size_t)blockIdx.y * L * D;
  load_wide_vec(lse + (size_t)blockIdx.y * L, q0, L, lse_t);
  load_wide_vec(delta + (size_t)blockIdx.y * L, q0, L, delta_t);
  for (int i = threadIdx.x; i < kT * kLdF; i += kThreads) acc[i] = 0.f;
  for (int k0 = 0; k0 < L; k0 += kT) {
    for (int c = 0; c < nch; ++c) {
      load_wide<T, true>(qs, q + base, q0, L, c * kC, D, scale2);
      load_wide<T, false>(dos, dout + base, q0, L, c * kC, D, 1.f);
      load_wide<T, false>(ks, k + base, k0, L, c * kC, D, 1.f);
      load_wide<T, false>(vs, v + base, k0, L, c * kC, D, 1.f);
      __syncthreads();
      gemm<false, true>(s, kLdF, qs, kLdT, ks, kLdT, kT, kT, kC, c > 0);
      gemm<false, true>(dp, kLdF, dos, kLdT, vs, kLdT, kT, kT, kC, c > 0);
      __syncthreads();
    }
    load_wide<T, false>(ks, k + base, k0, L, c_out, D, 1.f);
    for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
      const int r = i / kT, c = i % kT;
      const bool live = q0 + r < L && k0 + c < L;
      const float p = live ? exp2f(s[r * kLdF + c] - lse_t[r]) : 0.f;
      dss[r * kLdT + c] = from_f32<T>(p * (dp[r * kLdF + c] - delta_t[r]));
    }
    __syncthreads();
    gemm<false, false>(acc, kLdF, dss, kLdT, ks, kLdT, kT, kC, kT, true);
    __syncthreads();
  }
  store_wide<T>(dq + base, acc, scale_out, nullptr, q0, L, c_out, D);
}

template <typename T>
int launch_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int BH, int L, int D,
                   float scale2, float scale_out, cudaStream_t stream) {
  const size_t smem = 5 * tile_bytes<T>(kWideTile, kWideLdT) +
                      3 * tile_bytes<float>(kWideTile, kWideLdF) + 2 * kWideTile * 4;
  cudaError_t err = set_smem(flash_dq_wide_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kWideTile - 1) / kWideTile, BH, wide_chunks(D));
  flash_dq_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), L, D, scale2, scale_out);
  return (int)cudaGetLastError();
}

}  // namespace lcbi

// q, k, v, dout, dq: (BH, L, D) contiguous in T (fp32 if is_bf16 == 0, else
// bf16); lse (the forward's) and delta = rowsum(dout * o): (BH, L) fp32.
// D >= 1, 0 < BH < 65536, pointers 32-byte aligned. scale2 = scale *
// log2(e), scale_out = scale. Returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for a shape it does not take).
extern "C" int lcbi_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int BH, int L,
                                 int D, float scale2, float scale_out, int is_bf16,
                                 void* stream) {
  (void)cudaGetLastError();
  if (!lcbi::flash_shape_ok(BH, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > lcbi::kFlashMaxPadded)
    return is_bf16 ? lcbi::launch_dq_wide<lcbi::bf16>(q, k, v, dout, lse, delta, dq, BH, L, D,
                                                      scale2, scale_out, s)
                   : lcbi::launch_dq_wide<float>(q, k, v, dout, lse, delta, dq, BH, L, D,
                                                 scale2, scale_out, s);
  switch (lcbi::flash_padded_dim(D)) {
    case 16:
      return lcbi::launch_dq<16>(q, k, v, dout, lse, delta, dq, BH, L, D, scale2, scale_out,
                                 is_bf16, s);
    case 32:
      return lcbi::launch_dq<32>(q, k, v, dout, lse, delta, dq, BH, L, D, scale2, scale_out,
                                 is_bf16, s);
    case 64:
      return lcbi::launch_dq<64>(q, k, v, dout, lse, delta, dq, BH, L, D, scale2, scale_out,
                                 is_bf16, s);
    case 128:
      return lcbi::launch_dq<128>(q, k, v, dout, lse, delta, dq, BH, L, D, scale2, scale_out,
                                  is_bf16, s);
    default:
      return lcbi::launch_dq<256>(q, k, v, dout, lse, delta, dq, BH, L, D, scale2, scale_out,
                                  is_bf16, s);
  }
}
