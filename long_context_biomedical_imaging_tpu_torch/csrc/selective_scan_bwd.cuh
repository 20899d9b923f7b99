// The selective scan's backward on lane groups: the device core of K7's
// backward (selective_scan_long_bwd.cu: 64-token segments, each from its true
// start carry h0 and with the true cotangent dht of its final state) and K9's
// (selective_scan_window_bwd.cu: windows of L <= 64 tokens from h = 0 and a
// zero tail). For a row (a segment or a window) and the cotangent g of y (see
// selective_scan_long.cuh):
//     dh_t   = dh_t' + C_t g_t       (dh_t' = a_{t+1} dh_{t+1}, dht after the last token)
//     du_t   = d_t sum_n dh_t B_t           dC_t = sum_d h_t g_t
//     dd_t   = (u_t sum_n dh_t B_t + sum_n dh_t h_{t-1} a_t A) sigmoid(delta_t)
//     dB_t   = sum_d dh_t d_t u_t           dA  += sum_t dh_t h_{t-1} a_t d_t
// with a_t = exp(d_t A); without softplus d_t = delta_t and dd_t lacks the
// sigmoid. dB and dC sum over the channels, dA over every token of every row.
//
// What bounds it on the H100: device memory, u, delta, g read and du, dd
// written once (20 bytes per (token, channel)), against some 25 fp32
// operations per (token, channel, state) with the h recompute (chip_smoke.py
// kernel_bounds). The design:
//   * Lane groups. A channel's NP = LG x S padded states lie on LG lanes, S a
//     lane (N <= 1, 2, 4: LG = N rounded up to a power of two and S = 1; N <=
//     8: LG = 4, S = 2; N <= 16: LG = 8, S = 2), so a warp holds 32 / LG
//     channels. Two states a lane halve the shared-memory loads and shuffles
//     a state costs: 17% faster than 8 lanes of one state at d_state 8 (K7;
//     9% for K9, utils/k79_tiles.py). A block takes
//     a tile of tc channels (at most kBwdTileThreads threads, the tiles by
//     width) of wpb whole rows, a lane group per (row, channel), and walks
//     its range of row groups.
//   * One read of each operand. The block stages its rows' u, delta and g
//     (64 tokens x tc channels each) and B^T, C^T by cp.async, then
//     softplus(delta) once into a fourth plane; both sweeps read them there.
//     du and dd go back into the u and delta planes in place and leave once
//     per row group, coalesced along the channels. A row's own threads stage,
//     store and flush it, each a fixed 16-byte column of every 4 LG-th token:
//     no integer division in those loops (runtime divisions there cost 38%
//     at K7's main shape).
//   * Checkpoints. The forward sweep keeps each lane's states at the start
//     of every stretch of 8 tokens (in shared memory, one store and one load
//     a stretch); the reverse sweep recomputes one stretch's states and
//     decays into registers and walks it backwards. Only the 8 tokens of a
//     stretch are unrolled (every index into those arrays folds to a
//     constant, and so does every token's offset in the planes, whose
//     leading dimension is a constant): unrolling all 64 tokens spilled at
//     64 registers and cost 18% at K7's main shape (utils/k79_tiles.py).
//     Stretches wholly past a row's end are skipped, and the tokens past it
//     in the last stretch are staged as zeros, which the chain passes
//     through unchanged.
//   * Sums. Over the states (sum_n dh B and sum_n dh h a A): a lane's share
//     for the stretch's 8 tokens, summed within the lane group by a
//     transposing butterfly that leaves token j's two sums on lane j of the
//     group (on lanes j / (8 / LG) for LG < 8), so the group writes 8
//     tokens' du and dd at once. Over the channels (dB, dC): per token a
//     transposing butterfly across the warp's lane groups, the warps'
//     partials in shared memory, summed in warp order once per 16 tokens (a
//     smaller buffer than 32 tokens' lets four blocks of 256 threads share an
//     SM; utils/k79_tiles.py), and
//     across the channel tiles of a row through per-tile fp32 partials summed
//     in tile order by scan_bc_tiles_kernel. dA: each lane sums its states
//     over its rows in registers, into its (block, row of the group) fp32
//     slot; reduce_slots_kernel sums the slots in a fixed order. Two launches
//     give the same bits.
#pragma once

#include "selective_scan_long.cuh"

namespace lcbi {

constexpr int kBwdStretch = 8;                         // tokens between checkpoints
constexpr int kBwdStretches = kScanSeg / kBwdStretch;
constexpr int kBwdFlush = 2;                           // stretches per dB | dC flush
constexpr int kBwdHalf = kBwdFlush * kBwdStretch;      // tokens of partials a block holds
constexpr int kBwdLdBC = kScanSeg + 4;                 // leading dimension of B^T, C^T
constexpr int kBwdTileThreads = 256;                   // threads of a block at most
constexpr size_t kBwdMaxSmem = 100 * 1024;             // shared memory of a block of rows at most

// Blocks an SM the registers allow: 64 registers a thread with one state a
// lane, 128 with two.
constexpr int bwd_min_blocks(int S) { return 65536 / (kBwdTileThreads * (S == 1 ? 64 : 128)); }

// The widest channel tile of lane groups of lg lanes, and the leading
// dimension of the u, delta, g and d planes: a constant, so that every
// token's offset in them folds into the load. At most 64 channels, so that
// a row's planes leave room for more than one block an SM.
__host__ __device__ constexpr int bwd_ldp(int lg) {
  return kBwdTileThreads / lg < 64 ? kBwdTileThreads / lg : 64;
}

// Floats of a row's planes (u, delta, g and with softplus d; kScanSeg x
// bwd_ldp each) and its B^T, C^T (NP x kBwdLdBC each).
__host__ __device__ constexpr int bwd_row_floats(int lg, int s, bool softplus) {
  return (softplus ? 4 : 3) * kScanSeg * bwd_ldp(lg) + 2 * lg * s * kBwdLdBC;
}

__device__ __forceinline__ float f4at(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// One level of a transposing butterfly over lane bit BIT on the K values v:
// with K > 1, a lane keeps the lower half of them (BIT clear in its lane
// index) or the upper half (BIT set) and adds its partner's copy of that
// half, so K / 2 values remain; with K = 1 it adds its partner's value.
template <int K, int BIT>
__device__ __forceinline__ void tb_level(float* v, int lane) {
  if constexpr (K == 1) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], BIT);
  } else {
    const bool up = lane & BIT;
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const float send = up ? v[i] : v[i + K / 2];
      const float keep = up ? v[i + K / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
    }
  }
}

// The sums of the K values v over the lanes that differ in lane bits HI, HI /
// 2, .., LO (none when HI < LO), transposing while more than one value is
// left: afterwards v[i] holds the sum of value tb_first<K, HI, LO>(lane) + i,
// for i < max(1, K >> levels).
template <int K, int HI, int LO>
__device__ __forceinline__ void tb_sum(float* v, int lane) {
  if constexpr (HI >= LO && LO >= 1) {
    tb_level<K, HI>(v, lane);
    tb_sum<(K > 1 ? K / 2 : 1), HI / 2, LO>(v, lane);
  }
}

// The index of the first value tb_sum<K, HI, LO> leaves on this lane; dup
// receives the lane bits whose levels only added (lanes differing in them
// hold the same sums).
template <int K, int HI, int LO>
__device__ __forceinline__ int tb_first(int lane, int* dup) {
  int first = 0, k = K;
  *dup = 0;
  for (int bit = HI; bit >= LO && bit >= 1; bit /= 2) {
    if (k > 1) {
      if (lane & bit) first += k / 2;
      k /= 2;
    } else {
      *dup |= bit;
    }
  }
  return first;
}

struct ScanBwdArgs {
  const float *u, *delta, *at, *B, *C, *g, *h0, *dht;  // h0, dht NULL: zero carries
  float *du, *dd, *dB, *dC, *slots, *parts, *dat;
};

// Geometry of a call. Row r holds the tokens from (r / nseg) L + (r % nseg)
// 64 on, min(64, L - (r % nseg) 64) of them (K9: nseg = 1, L <= 64).
struct ScanBwdGeom {
  int rows, L, nseg, D, N;
  int lg, s, np;              // lanes a channel, states a lane, padded states
  int tc, tiles, wpb, wpr;    // channels a tile, tiles, rows a block, warps a row
  int groups, threads;        // row groups (wpb rows each), threads a block
  int blocks, per;            // blocks a tile (the grid's x), row groups a block
  size_t smem, ntok;          // shared-memory bytes a block; tokens of the call
  bool softplus;
};

inline bool scan_bwd_geom(int rows, int L, int nseg, int D, int N, bool softplus,
                          ScanBwdGeom* g) {
  if (rows < 1 || L < 1 || nseg < 1 || D < 1 || N < 1 || N > kScanMaxState) return false;
  g->rows = rows;
  g->L = L;
  g->nseg = nseg;
  g->D = D;
  g->N = N;
  g->softplus = softplus;
  g->lg = N <= 1 ? 1 : N <= 2 ? 2 : N <= 8 ? 4 : 8;
  g->s = N <= 4 ? 1 : 2;
  g->np = g->lg * g->s;
  // tiles by width: as few as keep a tile within bwd_ldp channels, each a
  // whole number of warps
  const int cl = 32 / g->lg, tc_max = bwd_ldp(g->lg);
  g->tiles = (D + tc_max - 1) / tc_max;
  g->tc = ((D + g->tiles - 1) / g->tiles + cl - 1) / cl * cl;
  g->wpr = g->tc * g->lg / 32;
  // a row's planes, B^T, C^T, its warps' dB | dC partials and its threads'
  // checkpoints
  const size_t row_bytes =
      sizeof(float) * ((size_t)bwd_row_floats(g->lg, g->s, softplus) +
                       g->wpr * kBwdHalf * 2 * g->np + g->tc * g->lg * kBwdStretches * g->s);
  // as many whole rows as keep the block within its threads and shared memory
  g->wpb = kBwdTileThreads / (g->tc * g->lg);
  if ((size_t)g->wpb * row_bytes > kBwdMaxSmem) g->wpb = (int)(kBwdMaxSmem / row_bytes);
  if (g->wpb > rows) g->wpb = rows;
  if (g->wpb < 1) g->wpb = 1;
  g->threads = g->wpb * g->tc * g->lg;
  g->groups = (rows + g->wpb - 1) / g->wpb;
  g->smem = g->wpb * row_bytes;
  g->ntok = (size_t)(rows / nseg) * L;
  g->blocks = g->per = 0;
  return true;
}

// Floats of the per-tile dB | dC partials a call needs (none with one tile).
inline long long scan_bwd_parts(const ScanBwdGeom& g) {
  return g.tiles > 1 ? (long long)g.tiles * 2 * g.ntok * g.N : 0;
}

template <int LG, int S, bool SOFTPLUS>
__global__ void __launch_bounds__(kBwdTileThreads, bwd_min_blocks(S))
scan_bwd_lanes_kernel(ScanBwdArgs a, ScanBwdGeom g) {
  constexpr int NP = LG * S, V = 2 * S, CL = 32 / LG;
  constexpr int VF = V > CL ? V / CL : 1;      // dB | dC values a lane holds after the sum
  constexpr int TPL = kBwdStretch / LG;        // tokens of a stretch whose du, dd a lane writes
  constexpr int kPlanes = SOFTPLUS ? 4 : 3;
  constexpr int LDP = bwd_ldp(LG), kPlane = kScanSeg * LDP;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid % 32, T = blockDim.x;
  const int tc = g.tc, D = g.D, N = g.N;
  const int rowth = tc * LG;
  const int wr = tid / rowth, rt = tid % rowth;
  const int c = rt / LG, sl = rt % LG, wrw = rt / 32;
  const int c0 = blockIdx.y * tc, d = c0 + c;
  const bool on = d < D;
  const int rowf = bwd_row_floats(LG, S, SOFTPLUS);
  float* base = smem + wr * rowf;
  float* up = base + c;                                   // u, then du
  float* rp = base + kPlane + c;                          // delta, then dd
  const float* gp = base + 2 * kPlane + c;                // g
  const float* tp = SOFTPLUS ? base + 3 * kPlane + c : rp;  // d = softplus(delta)
  const float* bt = base + kPlanes * kPlane;              // B^T (NP, kBwdLdBC)
  const float* ct = bt + NP * kBwdLdBC;                   // C^T
  float* pbuf = smem + g.wpb * rowf;                      // (wpb wpr warps, kBwdHalf, 2 NP)
  float* ck = pbuf + g.wpb * g.wpr * kBwdHalf * 2 * NP + tid;  // (stretches x S, T)

  float af[S], a2[S], dA[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = sl * S + s;
    af[s] = on && n < N ? a.at[n * D + d] : 0.f;
    a2[s] = af[s] * kLog2e;
    dA[s] = 0.f;
  }
  int dup;
  const int vfirst = tb_first<V, 16, LG>(lane, &dup);
  const bool vb_writer = (lane & dup) == 0;
  float* pw = pbuf + (wr * g.wpr + wrw) * kBwdHalf * 2 * NP;
  const bool vec = D % 4 == 0;

  // this thread's share of its row's staging, softplus and stores: 16-byte
  // chunk sq of tokens st0, st0 + 4 LG, ... (a row's tc LG threads cover its
  // tc / 4 chunks x 64 tokens); of its B^T, C^T: state sn of tokens sb0,
  // sb0 + tc / S, ...; of its dB | dC flush: column fc of tokens fc0, fc0 +
  // tc / (2 S), ...
  const int nq = tc / 4, sq = rt % nq, st0 = rt / nq;
  const int sn = rt % NP, sb0 = rt / NP, fc = rt % (2 * NP), fc0 = rt / (2 * NP);
  const int ldc = c0 + 4 * sq;                            // the chunk's first channel
  float* own = base + st0 * LDP + 4 * sq;                 // the chunk in the u plane at st0

  const int g0 = blockIdx.x * g.per, g1 = min(g.groups, g0 + g.per);
  for (int grp = g0; grp < g1; ++grp) {
    const int row = grp * g.wpb + wr;
    const ScanRow r = row < g.rows ? scan_row(g.L, g.nseg, row) : ScanRow{0, 0};
    const bool out = on && row < g.rows;
    __syncthreads();  // the previous group's readers of the planes and pbuf are done
    // stage u, delta, g (16-byte copies along the channels where D allows)
    // and B^T, C^T of this thread's row, the states n >= N and the tokens
    // past the row's end zero
    for (int t = st0; t < kScanSeg; t += 4 * LG) {
      const size_t o = (r.tok0 + t) * D + ldc;
      float* dst = own + (t - st0) * LDP;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const float* src = p == 0 ? a.u : p == 1 ? a.delta : a.g;
        if (vec) {
          const bool live = t < r.len && ldc < D;
          scan_cp16(dst + p * kPlane, live ? src + o : src, live);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool live = t < r.len && ldc + i < D;
            scan_cp4(dst + p * kPlane + i, live ? src + o + i : src, live);
          }
        }
      }
    }
    for (int t = sb0; t < kScanSeg; t += tc / S) {
      const bool live = t < r.len && sn < N;
      const size_t o = (r.tok0 + t) * N + sn;
      scan_cp4(base + kPlanes * kPlane + sn * kBwdLdBC + t, live ? a.B + o : a.B, live);
      scan_cp4(base + kPlanes * kPlane + (NP + sn) * kBwdLdBC + t, live ? a.C + o : a.C, live);
    }
    scan_cp_wait_all();
    if (SOFTPLUS) {  // on this thread's own copies; d past the row's end stays 0,
                     // so that those steps keep dh as it is
      for (int t = st0; t < kScanSeg; t += 4 * LG) {
        float* p = own + (t - st0) * LDP;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[3 * kPlane + i] = t < r.len ? scan_softplus(p[kPlane + i]) : 0.f;
      }
    }
    __syncthreads();
    int maxlen = 0;  // the group's longest row: every thread walks as many stretches
    for (int rw = 0; rw < g.wpb; ++rw) {
      const int row2 = grp * g.wpb + rw;
      if (row2 < g.rows) maxlen = max(maxlen, scan_row(g.L, g.nseg, row2).len);
    }
    const int nst = (maxlen + kBwdStretch - 1) / kBwdStretch;

    float h[S], dh[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int n = sl * S + s;
      const size_t co = ((size_t)row * N + n) * D + d;  // carry (row, n, d)
      const bool live = out && n < N;
      h[s] = live && a.h0 != nullptr ? a.h0[co] : 0.f;
      dh[s] = live && a.dht != nullptr ? a.dht[co] : 0.f;
    }
    // the forward sweep: each stretch's start state, to ck
    for (int k = 0; k < nst; ++k) {
#pragma unroll
      for (int s = 0; s < S; ++s) ck[(k * S + s) * T] = h[s];
      const int t0 = k * kBwdStretch;
      const float *tpk = tp + t0 * LDP, *upk = up + t0 * LDP;
#pragma unroll
      for (int j4 = 0; j4 < kBwdStretch; j4 += 4) {
        float4 b4[S];
#pragma unroll
        for (int s = 0; s < S; ++s)
          b4[s] = *reinterpret_cast<const float4*>(bt + (sl * S + s) * kBwdLdBC + t0 + j4);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j4 + q;
          const float dt = tpk[j * LDP], dtu = dt * upk[j * LDP];
#pragma unroll
          for (int s = 0; s < S; ++s) h[s] = fmaf(exp2f(dt * a2[s]), h[s], dtu * f4at(b4[s], q));
        }
      }
    }
    // the reverse sweep, stretch by stretch from the end
    for (int k = nst - 1; k >= 0; --k) {
      const int t0 = k * kBwdStretch;
      const float *tpk = tp + t0 * LDP, *upk = up + t0 * LDP, *gpk = gp + t0 * LDP;
      float h0k[S], hs[kBwdStretch][S], as[kBwdStretch][S];
#pragma unroll
      for (int s = 0; s < S; ++s) h[s] = h0k[s] = ck[(k * S + s) * T];
#pragma unroll
      for (int j4 = 0; j4 < kBwdStretch; j4 += 4) {
        float4 b4[S];
#pragma unroll
        for (int s = 0; s < S; ++s)
          b4[s] = *reinterpret_cast<const float4*>(bt + (sl * S + s) * kBwdLdBC + t0 + j4);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j4 + q;
          const float dt = tpk[j * LDP], dtu = dt * upk[j * LDP];
#pragma unroll
          for (int s = 0; s < S; ++s) {
            as[j][s] = exp2f(dt * a2[s]);
            h[s] = fmaf(as[j][s], h[s], dtu * f4at(b4[s], q));
            hs[j][s] = h[s];
          }
        }
      }
      float pd[2 * kBwdStretch];  // per token: this lane's share of sum_n dh B, sum_n dh h a A
      float* pwk = pw + (k % kBwdFlush) * kBwdStretch * 2 * NP;
#pragma unroll
      for (int j4 = kBwdStretch - 4; j4 >= 0; j4 -= 4) {
        float4 b4[S], c4[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          b4[s] = *reinterpret_cast<const float4*>(bt + (sl * S + s) * kBwdLdBC + t0 + j4);
          c4[s] = *reinterpret_cast<const float4*>(ct + (sl * S + s) * kBwdLdBC + t0 + j4);
        }
#pragma unroll
        for (int q = 3; q >= 0; --q) {
          const int j = j4 + q;
          const float dt = tpk[j * LDP], dtu = dt * upk[j * LDP], gt = gpk[j * LDP];
          float sdb = 0.f, sda = 0.f, v[V];  // v: this lane's share of dB_t | dC_t
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const float dhn = fmaf(f4at(c4[s], q), gt, dh[s]);
            const float hprev = j > 0 ? hs[j - 1][s] : h0k[s];
            const float daa = dhn * hprev * as[j][s];
            dA[s] = fmaf(daa, dt, dA[s]);
            sdb = fmaf(dhn, f4at(b4[s], q), sdb);
            sda = fmaf(daa, af[s], sda);
            v[s] = dhn * dtu;
            v[S + s] = hs[j][s] * gt;
            dh[s] = as[j][s] * dhn;
          }
          pd[2 * j] = sdb;
          pd[2 * j + 1] = sda;
          tb_sum<V, 16, LG>(v, lane);
          if (vb_writer) {
#pragma unroll
            for (int i = 0; i < VF; ++i) {
              const int idx = vfirst + i;
              pwk[j * 2 * NP + idx / S * NP + sl * S + idx % S] = v[i];
            }
          }
        }
      }
      tb_sum<2 * kBwdStretch, LG / 2, 1>(pd, lane);
      __syncwarp();  // the group's reads of this stretch's u and delta are done
#pragma unroll
      for (int q = 0; q < TPL; ++q) {
        const int j = sl * TPL + q;
        if (out && t0 + j < r.len) {
          const float sdb = pd[2 * q], sda = pd[2 * q + 1];
          const float dt = tpk[j * LDP], ddt = fmaf(upk[j * LDP], sdb, sda);
          const float ddv = SOFTPLUS ? ddt * scan_sigmoid(rp[(t0 + j) * LDP]) : ddt;
          up[(t0 + j) * LDP] = dt * sdb;
          rp[(t0 + j) * LDP] = ddv;
        }
      }
      if (k % kBwdFlush == 0) {
        // the row's warps' partials of these 32 tokens, in warp order, to dB |
        // dC (or to this tile's partials)
        __syncthreads();
        const int n = fc % NP, isC = fc / NP;
        const float* pr = pbuf + wr * g.wpr * kBwdHalf * 2 * NP + fc;
        for (int tl = fc0; tl < kBwdHalf && row < g.rows && n < N; tl += tc / (2 * S)) {
          if (t0 + tl >= r.len) break;
          float sum = 0.f;
          for (int w = 0; w < g.wpr; ++w) sum += pr[(w * kBwdHalf + tl) * 2 * NP];
          const size_t tok = r.tok0 + t0 + tl;
          if (g.tiles == 1)
            (isC ? a.dC : a.dB)[tok * N + n] = sum;
          else
            a.parts[((size_t)(blockIdx.y * 2 + isC) * g.ntok + tok) * N + n] = sum;
        }
        __syncthreads();
      }
    }
    // du and dd of this thread's chunk, from the u and delta planes
    for (int t = st0; t < r.len; t += 4 * LG) {
      const float* srcp = own + (t - st0) * LDP;
      const size_t o = (r.tok0 + t) * D + ldc;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float* dst = (p == 0 ? a.du : a.dd) + o;
        if (vec) {
          if (ldc < D)
            *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(srcp + p * kPlane);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (ldc + i < D) dst[i] = srcp[p * kPlane + i];
        }
      }
    }
  }
  if (on) {
    float* slot = a.slots + ((size_t)blockIdx.x * g.wpb + wr) * N * D;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int n = sl * S + s;
      if (n < N) slot[(size_t)n * D + d] = dA[s];
    }
  }
}

// dB | dC = the sum over the tiles of the per-tile partials, in tile order:
// parts (tiles, 2, n) -> dB, dC (n each).
__global__ void __launch_bounds__(kThreads)
scan_bc_tiles_kernel(const float* __restrict__ parts, int tiles, size_t n, float* __restrict__ dB,
                     float* __restrict__ dC) {
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < 2 * n;
       e += (size_t)gridDim.x * kThreads) {
    float s = 0.f;
    for (int i = 0; i < tiles; ++i) s += parts[(size_t)i * 2 * n + e];
    if (e < n)
      dB[e] = s;
    else
      dC[e - n] = s;
  }
}

template <int LG_, int S_, bool SP_>
struct BwdCfg {
  static constexpr int LG = LG_, S = S_;
  static constexpr bool SP = SP_;
};

template <bool SP, class F>
int bwd_with_lanes(int lg, int s, F&& f) {
  switch (lg) {
    case 1: return f(BwdCfg<1, 1, SP>{});
    case 2: return f(BwdCfg<2, 1, SP>{});
    case 4: return s == 1 ? f(BwdCfg<4, 1, SP>{}) : f(BwdCfg<4, 2, SP>{});
    default: return f(BwdCfg<8, 2, SP>{});
  }
}

// f(BwdCfg<LG, S, SP>) for the call's lane groups and softplus flag.
template <class F>
int scan_bwd_with(const ScanBwdGeom& g, F&& f) {
  return g.softplus ? bwd_with_lanes<true>(g.lg, g.s, f) : bwd_with_lanes<false>(g.lg, g.s, f);
}

// Plan a call: its geometry and its grid, every tile's blocks walking the
// same number of row groups (the last ones fewer), as many blocks as fit on
// the device at once and at most max_slots / wpb a tile (each block's rows
// take a dA slot each). Returns a CUDA error code.
inline int scan_bwd_plan(int rows, int L, int nseg, int D, int N, bool softplus,
                         long long max_slots, ScanBwdGeom* g) {
  if (!scan_bwd_geom(rows, L, nseg, D, N, softplus, g)) return (int)cudaErrorInvalidValue;
  return scan_bwd_with(*g, [&](auto cfg) {
    using C = decltype(cfg);
    auto kernel = scan_bwd_lanes_kernel<C::LG, C::S, C::SP>;
    cudaError_t err;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)g->smem)))
      return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, g->threads,
                                                             g->smem)))
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    long long blocks = (long long)sms * per_sm / g->tiles;
    if (blocks > max_slots / g->wpb) blocks = max_slots / g->wpb;
    if (blocks > g->groups) blocks = g->groups;
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    g->per = (int)((g->groups + blocks - 1) / blocks);
    g->blocks = (g->groups + g->per - 1) / g->per;
    return 0;
  });
}

// Launch a planned call: the scan kernel, the tiles' dB | dC sum (more than
// one tile), the ordered dA slot sum. Returns cudaGetLastError() of the first
// launch that fails.
inline int scan_bwd_launch(const ScanBwdArgs& a, const ScanBwdGeom& g, cudaStream_t s) {
  return scan_bwd_with(g, [&](auto cfg) {
    using C = decltype(cfg);
    scan_bwd_lanes_kernel<C::LG, C::S, C::SP>
        <<<dim3(g.blocks, g.tiles), g.threads, g.smem, s>>>(a, g);
    cudaError_t err;
    if ((err = cudaGetLastError())) return (int)err;
    if (g.tiles > 1) {
      const size_t n = g.ntok * g.N;
      size_t blocks = (2 * n + kThreads - 1) / kThreads;
      if (blocks > 4096) blocks = 4096;
      scan_bc_tiles_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(a.parts, g.tiles, n, a.dB, a.dC);
      if ((err = cudaGetLastError())) return (int)err;
    }
    return launch_reduce(a.slots, g.blocks * g.wpb, (size_t)g.N * g.D, a.dat, s);
  });
}

}  // namespace lcbi
