// K8's general path in bf16 up to D = 128, designed for Hopper: the
// attention of window_attention.cu's forward and window_attention_bwd.cu's
// backward on register-resident mma.sync fragments (the building blocks of
// flash_attention.cuh), for the windows the whole-window path does not take
// (3D windows of up to 8x8x8 = 512 tokens, shrunk and ragged windows, head
// dims other than 16, 32, 64 on 2D windows).
//
// Replaces, with the projections of the .cu files, the TPU kernels
// long_context_biomedical_imaging_tpu/ops/window_attention.py _fwd_kernel
// (pallas_call in _call_fwd) and _bwd_kernel (pallas_call in _call_bwd) on
// those shapes.
//
// What bounds it on the H100: per (window, head) the score products, 2 V^2 D
// operations each (three of them in the forward counting the recomputed
// pass, five in the backward's row pass and four in its key pass) and V^2
// exp2 per pass, against 8 V D bytes of q, k, v, o: at V = 512, D = 32 some
// 100 operations a byte, so the tensor cores and the exp2 units, not the
// streams, bound it; but only if the bias and the region ids cost no device
// memory per score, and the score rows stay out of shared memory.
//
// The design:
//   - Items. The row kernels take items (head h, query tile of 64 rows,
//     window w), ordered head, tile, window; a persistent grid of as many
//     blocks as fit at once gives each block a contiguous range. A block
//     keeps the bias slice rel[h, tile rows, :] log2(e) (64 x V fp32, 128 KB
//     at V = 512) in shared memory while it walks its windows, and reloads it
//     only where its range crosses into another (head, tile): rel does not
//     depend on the window.
//   - Registers. Each warp owns 16 query rows; its q (and do) fragments
//     are loaded once per item by ldmatrix, and the scores, the
//     probabilities, dp and the o or dq accumulator stay in registers as
//     mma.sync.m16n8k16 fragments (fp32 sums). Nothing of a score row
//     touches shared memory.
//   - Rounding where the TPU kernel rounds: p is normalised before it is
//     rounded to bf16. A two-pass softmax keeps that without score rows in
//     memory: pass 1 takes each row's max and sum over all keys (online,
//     fp32), pass 2 recomputes s and takes p = exp2(s - m) / l, rounds it in
//     registers as the A operand of p v. The backward's row kernel takes a
//     third pass for ds = p (dp - delta), delta summed in pass 2 from the
//     fp32 p and dp, and rounds ds for dq = ds k. p is exp2(s - m) times
//     1 / l, rounded once per row, in both the row and the key pass.
//   - Streams. k and v come through a ring of cp.async 16-byte copies (3
//     stages, 2 at KD = 128), each stage carrying its keys' and the query
//     tile's region ids, the copies of the stages ahead overlapping this
//     stage's products; a window's k is read once per pass and query tile,
//     v once per pass after the first. The next item's q (do) tile arrives
//     with the steps ahead, double-buffered by item parity.
//   - Warps. A scheduler with one warp stalls on every latency, so at KD <=
//     32 a block runs two groups of 4 warps: in the row kernel they split a
//     stage's 128 keys, combine each row's max and sum, and meet for o, dq
//     and delta in shared memory (group 0's part, then group 1's); in the
//     key kernel they split a stage's queries and meet for dk and dv.
//   - The key pass (dk, dv, drel). Items (head h, key tile of 64 keys (32 at
//     KD = 128), window w). Each warp owns 16 keys; their k and v fragments
//     are loaded once per item, and the block reads each window's q, q
//     unscaled, do and row statistics once, through the ring (32 queries a
//     step, 16 at KD = 128), beside the bias tile rel[h, step rows, keys]
//     (cp.async). drel's columns of the key tile (V x 64 fp32) stay in
//     shared memory over the block's windows, each element owned by the
//     thread that holds its fragment, added in window order; where the
//     range leaves a (head, key tile), the block writes it out as one
//     segment, and wattn_drel_reduce_kernel sums each (head, key tile)'s
//     segments in block order. The bias gradients (dq, dk, dv column sums)
//     go to each block's fp32 slot, summed in a fixed order. No atomics: two
//     launches give the same bits.
//
// A block has 256 threads at KD <= 32, 128 at KD = 64 (64 at KD = 128 in the
// key pass), and one block an SM fits at V = 512 (the bias slice or drel
// tile); registers at KD = 128 run near the limit.
#pragma once

#include <type_traits>

#include "flash_attention.cuh"
#include "mma_gemm.cuh"
#include "window_attention.cuh"

namespace lcbi {

constexpr float kAttnNegInf = -1e30f;   // masked keys; finite so that alpha stays defined

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// Ring depths are what fits beside the bias slice (rows) or the drel tile
// (keys) in shared memory; one stage's copies are in flight for each stage
// past the one being read.
// At KD <= 32 a block runs two groups of 4 warps (kSplit = 2), so that each
// of the SM's four schedulers has two warps to switch between: in the row
// kernel the groups split each stage's keys, in the key kernel its queries,
// and the partial sums of the two groups meet in shared memory in a fixed
// order (group 0's, then group 1's).
template <int KD> struct MmaRowCfg {
  static constexpr int kSplit = KD <= 32 ? 2 : 1;   // warp groups splitting a stage's keys
  static constexpr int kWarps = 4 * kSplit, kThreads = kWarps * 32;
  static constexpr int kBM = 64;                    // query rows per item (16 a warp)
  static constexpr int kBN = KD <= 64 ? 64 : 32;    // keys per ring stage and warp group
  static constexpr int kLd = KD + 8;                // bf16 tiles (16-byte row padding)
  static constexpr int kStages = KD <= 64 ? 3 : 2;
  static constexpr int kQBufs = kStages > 2 ? 2 : 1;   // q (do) tiles, by item parity
};

template <int KD> struct MmaKeyCfg {
  static constexpr int kSplit = KD <= 32 ? 2 : 1;   // warp groups splitting a stage's queries
  static constexpr int kBK = KD <= 64 ? 64 : 32;    // keys per item (16 a warp)
  static constexpr int kKW = kBK / 16;              // warps per group
  static constexpr int kWarps = kKW * kSplit, kThreads = kWarps * 32;
  static constexpr int kBQ = KD <= 64 ? 32 : 16;    // queries per ring stage and warp group
  static constexpr int kLd = KD + 8;
  static constexpr int kLdK = kBK + 4;              // fp32 (query x key) tiles: bias^T, drel
  static constexpr int kStages = KD <= 64 ? 2 : 3;
};

// The mma kernels' head dims: KD in {16, 32, 64, 128}, the least that holds D.
constexpr int kMmaMaxHeadDim = 128;
__host__ __forceinline__ int mma_head_dim(int D) {
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128;
}

// V rounded up to 128 (a whole number of query tiles and of the row kernel's
// key stages): the width of the bias slice, the rows of drel.
__host__ __device__ __forceinline__ int mma_vp(int V) { return (V + 127) & ~127; }

__host__ __device__ __forceinline__ size_t bf16_tile_bytes(int rows, int ld) {
  return align128((size_t)rows * ld * 2);
}

// The row kernel's shared memory: the bias slice, kQBufs q (and do) tiles,
// kStages ring stages of [k | v | the key tile's region ids | the query
// tile's region ids], the column-sum exchange.
struct MmaRowLayout {
  int ldb;
  size_t tile_elems, qtile_elems, off_q, off_do, off_ring, stage, off_rid, off_xo, off_xs,
      off_red, bytes;
};

template <int KD> __host__ __device__ inline MmaRowLayout mma_row_layout(int V, bool bwd) {
  using Cf = MmaRowCfg<KD>;
  MmaRowLayout L;
  L.ldb = mma_vp(V) + 8;   // = 8 mod 32 floats: a fragment's float2 reads take two wavefronts
  const size_t tile = bf16_tile_bytes(Cf::kBM, Cf::kLd);
  const size_t ring_tile = bf16_tile_bytes(Cf::kSplit * Cf::kBN, Cf::kLd);
  L.tile_elems = ring_tile / 2;
  L.qtile_elems = tile / 2;
  L.off_rid = 2 * ring_tile;                         // inside a stage
  L.stage = L.off_rid + align128((size_t)(Cf::kSplit * Cf::kBN + Cf::kBM) * 4);
  L.off_q = align128((size_t)Cf::kBM * L.ldb * 4);
  L.off_do = L.off_q + Cf::kQBufs * tile;
  L.off_ring = L.off_do + (bwd ? Cf::kQBufs * tile : 0);
  // the groups' exchange: o or dq fragments of 4 warps, and (m, l, delta)
  L.off_xo = L.off_ring + Cf::kStages * L.stage;
  L.off_xs = L.off_xo + (Cf::kSplit > 1 ? align128((size_t)4 * 16 * KD * 4) : 0);
  L.off_red = L.off_xs + (Cf::kSplit > 1 ? align128((size_t)2 * 3 * Cf::kBM * 4) : 0);
  L.bytes = L.off_red + align128((size_t)4 * KD * 4);
  return L;
}

// The key kernel's shared memory: the drel tile, kStages ring stages of [q
// scaled | q | do | bias^T | (m, 1/l, delta) | the step's query region ids |
// the item's key region ids], two k | v tiles (by item parity), the
// column-sum exchange.
struct MmaKeyLayout {
  size_t tile_elems, stage, off_ring, off_kv, off_red, bytes;
  size_t off_qu, off_do, off_bt, off_st, off_rq, off_rk;   // inside a ring stage
};

template <int KD> __host__ __device__ inline MmaKeyLayout mma_key_layout(int V) {
  using Cf = MmaKeyCfg<KD>;
  MmaKeyLayout L;
  constexpr int kQ = Cf::kSplit * Cf::kBQ;   // queries per stage
  const size_t qt = bf16_tile_bytes(kQ, Cf::kLd);
  L.off_qu = qt;
  L.off_do = 2 * qt;
  L.off_bt = 3 * qt;
  L.off_st = L.off_bt + align128((size_t)kQ * Cf::kLdK * 4);
  L.off_rq = L.off_st + align128((size_t)3 * kQ * 4);
  L.off_rk = L.off_rq + align128((size_t)kQ * 4);
  L.stage = L.off_rk + align128((size_t)Cf::kBK * 4);
  L.off_ring = align128((size_t)mma_vp(V) * Cf::kLdK * 4);   // drel first
  L.off_kv = L.off_ring + Cf::kStages * L.stage;
  const size_t kv = bf16_tile_bytes(Cf::kBK, Cf::kLd);
  L.tile_elems = kv / 2;
  L.off_red = L.off_kv + 4 * kv;
  L.bytes = L.off_red + align128((size_t)Cf::kKW * 2 * KD * 4);
  return L;
}

// Rows [0, rows) and columns [col, col + width) of a bf16 stream with leading
// dimension ld into a (n, KD + 8) shared tile; zero at or past rows and
// width. With vec (ld, col and width multiples of 8, the stream 16-byte
// aligned) by cp.async, complete at the caller's wait; otherwise plain loads.
template <int KD>
__device__ __forceinline__ void load_head_async(bf16* dst, const bf16* __restrict__ src,
                                                size_t ld, int col, int width, int rows, int n,
                                                bool vec, int nthreads) {
  constexpr int kLd = KD + 8, kChunks = KD / 8;
  for (int e = threadIdx.x; e < n * kChunks; e += nthreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    bf16* d = dst + r * kLd + c;
    if (vec) {
      const bool live = r < rows && c < width;
      cp_async16(smem_addr(d), live ? src + (size_t)r * ld + col + c : src, live ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float lo = 0.f, hi = 0.f;
        if (r < rows && c + 2 * i < width)
          lo = __bfloat162float(src[(size_t)r * ld + col + c + 2 * i]);
        if (r < rows && c + 2 * i + 1 < width)
          hi = __bfloat162float(src[(size_t)r * ld + col + c + 2 * i + 1]);
        w[i] = pack_bf16(lo, hi);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Window w's region ids [j0, j0 + n) (row w % nW of rid) into dst, zero past V.
__device__ __forceinline__ void load_rid_async(int* dst, const int* __restrict__ rid, long long w,
                                               int nW, int V, int j0, int n, int nthreads) {
  const int* row = rid + (size_t)(w % nW) * V;
  for (int j = threadIdx.x; j < n; j += nthreads)
    cp_async4(smem_addr(dst + j), row + (j0 + j < V ? j0 + j : 0), j0 + j < V ? 4 : 0);
}

// Two values of one fragment row at columns col, col + 1 of a bf16 row (the
// second only if col + 1 < D): one 4-byte store where pair (the row start and
// col even), else element by element.
__device__ __forceinline__ void store_pair(bf16* row, int col, int D, float v0, float v1,
                                           bool pair) {
  if (col >= D) return;
  if (pair && col + 1 < D) {
    *reinterpret_cast<uint32_t*>(row + col) = pack_bf16(v0, v1);
  } else {
    row[col] = __float2bfloat16(v0);
    if (col + 1 < D) row[col + 1] = __float2bfloat16(v1);
  }
}

// The block whose range [floor(N g / G), floor(N (g + 1) / G)) holds item it.
__host__ __device__ __forceinline__ int block_of(long long it, long long N, int G) {
  int g = (int)(it * G / N);
  while (g + 1 < G && N * (g + 1) / G <= it) ++g;
  while (g > 0 && N * g / G > it) --g;
  return g;
}

// ---------------------------------------------------------------------------
// Row kernel: forward (o) and the backward's row pass (o, dq, statistics)
// ---------------------------------------------------------------------------

// qkv: q scale log2(e) at column h D, k at C + h D, v at 2C + h D of each
// token row (ld ldq), bf16. Forward: writes o (BW V, C). Backward: also reads
// dO (do per head, ld C) and dout (for dbout), writes o, dq scale at column
// h D of dqkv (ld 3C), (m, l, delta) per (window, head, row) in three planes
// of stats, and its slot's [dbq (C) | dbout (C)] (zeroed here).
template <bool BWD, int KD>
__global__ void __launch_bounds__(MmaRowCfg<KD>::kThreads)
wattn_rows_mma_kernel(const bf16* __restrict__ qkv, int ldq, const float* __restrict__ rel,
                      const int* __restrict__ rid, const bf16* __restrict__ dO,
                      const bf16* __restrict__ dout, bf16* __restrict__ o, bf16* __restrict__ dqkv,
                      float* __restrict__ stats, float* __restrict__ slots, int BW, int V, int C,
                      int H, int nW, float scale, float mask2) {
  using Cf = MmaRowCfg<KD>;
  constexpr int kBM = Cf::kBM, kBN = Cf::kBN, kLd = Cf::kLd, kThr = Cf::kThreads;
  constexpr int kNT = kBN / 8, kDT = KD / 8, kKK = KD / 16, kSplit = Cf::kSplit;
  constexpr int kSN = kSplit * kBN;   // keys per stage
  extern __shared__ __align__(128) unsigned char smem[];
  const MmaRowLayout L = mma_row_layout<KD>(V, BWD);
  constexpr int kS = Cf::kStages;
  float* bias = reinterpret_cast<float*>(smem);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.off_q);
  bf16* DOs = reinterpret_cast<bf16*>(smem + L.off_do);
  unsigned char* ring = smem + L.off_ring;
  float* xo = reinterpret_cast<float*>(smem + L.off_xo);
  float* xs = reinterpret_cast<float*>(smem + L.off_xs);
  float* red = reinterpret_cast<float*>(smem + L.off_red);

  const int D = C / H, Vp = mma_vp(V);
  const int nkt = (V + kSN - 1) / kSN, nqt = (V + kBM - 1) / kBM;
  const int nsteps = (BWD ? 3 : 2) * nkt;
  // items < 2^31 (BW V 4C < 2^31 is checked on the host), so int from here on
  const long long items = (long long)H * nqt * BW;
  const int it_begin = (int)(items * blockIdx.x / gridDim.x);
  const int it_end = (int)(items * (blockIdx.x + 1) / gridDim.x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int wr = warp % 4, kg = warp / 4;   // the warp's 16 rows; its key group
  const int kb = kg * kBN;                  // the group's keys in a stage
  const bool vec = ldq % 8 == 0 && C % 8 == 0 && D % 8 == 0;
  const bool pair = C % 2 == 0 && D % 2 == 0;
  const size_t plane = (size_t)BW * H * V;
  float* slot = BWD ? slots + (size_t)blockIdx.x * 2 * C : nullptr;
  if (BWD) {
    for (int e = threadIdx.x; e < 2 * C; e += kThr) slot[e] = 0.f;
  }
  if (it_begin >= it_end) return;

  // step s of item it into ring stage st: key tile s % nkt of pass s / nkt
  // (k, and v after pass 0) and the region ids of those keys and of the
  // item's query rows; step 0 also brings the item's q (do) tile
  auto prefetch = [&](int it, int s, int st) {
    const int w = it % BW;
    const int qt = (it / BW) % nqt, h = it / BW / nqt;
    const bf16* base = qkv + (size_t)w * V * ldq;
    const int j0 = (s % nkt) * kSN, keys = min(kSN, V - j0), i0 = qt * kBM;
    unsigned char* S = ring + st * L.stage;
    bf16* Kt = reinterpret_cast<bf16*>(S);
    load_head_async<KD>(Kt, base + (size_t)j0 * ldq, ldq, C + h * D, D, keys, kSN, vec, kThr);
    if (s >= nkt)
      load_head_async<KD>(Kt + L.tile_elems, base + (size_t)j0 * ldq, ldq, 2 * C + h * D, D,
                          keys, kSN, vec, kThr);
    if (rid != nullptr) {
      int* rk = reinterpret_cast<int*>(S + L.off_rid);
      load_rid_async(rk, rid, w, nW, V, j0, kSN, kThr);
      load_rid_async(rk + kSN, rid, w, nW, V, i0, kBM, kThr);
    }
    if (s == 0) {
      const int rows = min(kBM, V - i0);
      const size_t qb = (size_t)(it % Cf::kQBufs) * L.qtile_elems;
      load_head_async<KD>(Qs + qb, base + (size_t)i0 * ldq, ldq, h * D, D, rows, kBM, vec, kThr);
      if (BWD)
        load_head_async<KD>(DOs + qb, dO + ((size_t)w * V + i0) * C, C, h * D, D, rows, kBM, vec,
                            kThr);
    }
  };

  uint32_t qa[kKK][4], da[BWD ? kKK : 1][4];
  float m_r[2], l_r[2], dl_r[2], acc[kDT][4];
  int cur = -1, h = 0, i0 = 0, w = 0, it = it_begin, pit = it_begin;
  int s = 0, ps = 0, gs = 0;
  // the ring runs kS - 1 steps ahead of the step being computed
  for (int i = 0; i < kS - 1; ++i) {
    if (pit < it_end) {
      prefetch(pit, ps, i);
      if (++ps == nsteps) {
        ps = 0;
        ++pit;
      }
    }
    cp_async_commit();
  }
  while (true) {
    cp_async_wait<kS - 2>();
    __syncthreads();
    if (s == 0) {
      w = it % BW;
      const int hq = it / BW;
      h = hq / nqt;
      i0 = (hq % nqt) * kBM;
      if (hq != cur) {   // rows [i0, i0 + 64) of rel[h] times log2(e), zero past V
        for (int e = threadIdx.x; e < kBM * Vp; e += kThr) {
          const int r = e / Vp, j = e % Vp, i = i0 + r;
          bias[r * L.ldb + j] = i < V && j < V ? rel[((size_t)h * V + i) * V + j] * kLog2e : 0.f;
        }
        cur = hq;
      }
      const size_t qb = (size_t)(it % Cf::kQBufs) * L.qtile_elems;
#pragma unroll
      for (int kk = 0; kk < kKK; ++kk) {
        frag_a(qa[kk], Qs + qb, kLd, wr * 16, kk * 16, lane);
        if (BWD) frag_a(da[kk], DOs + qb, kLd, wr * 16, kk * 16, lane);
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        m_r[h2] = kAttnNegInf;
        l_r[h2] = dl_r[h2] = 0.f;
      }
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
      __syncthreads();   // the q (do) tile and the bias are read; the next item may refill
    }
    if (pit < it_end) {
      prefetch(pit, ps, (gs + kS - 1) % kS);
      if (++ps == nsteps) {
        ps = 0;
        ++pit;
      }
    }
    cp_async_commit();

    const int pass = s / nkt, kt = s % nkt, j0 = kt * kSN + kb;   // the group's first key
    const unsigned char* S = ring + (gs % kS) * L.stage;
    const bf16* Kt = reinterpret_cast<const bf16*>(S);
    const bf16* Vt = Kt + L.tile_elems;
    const int* rk = reinterpret_cast<const int*>(S + L.off_rid);   // the key tile's region ids
    const int rl = wr * 16 + g;     // this lane's rows: rl and rl + 8 of the tile

    // s = q k^T + bias + mask (keys past V: -1e30)
    float sc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKK; ++kk)
#pragma unroll
      for (int n2 = 0; n2 < kNT / 2; ++n2) {
        uint32_t b[4];
        frag_b_rows(b, Kt, kLd, kb + n2 * 16, kk * 16, lane);
        mma_bf16(sc[2 * n2], qa[kk], b[0], b[1]);
        mma_bf16(sc[2 * n2 + 1], qa[kk], b[2], b[3]);
      }
    int rq[2] = {0, 0};
    if (rid != nullptr) {
      rq[0] = rk[kSN + rl];
      rq[1] = rk[kSN + rl + 8];
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int j = j0 + nt * 8 + 2 * t;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const float2 bb = *reinterpret_cast<const float2*>(bias + (rl + 8 * h2) * L.ldb + j);
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          float& v = sc[nt][2 * h2 + e2];
          if (j + e2 < V) {
            v += e2 ? bb.y : bb.x;
            if (rid != nullptr) v += rq[h2] != rk[kb + j - j0 + e2] ? mask2 : 0.f;
          } else {
            v = kAttnNegInf;
          }
        }
      }
    }

    if (pass == 0) {
      // row max and sum, online over the key tiles
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float mx = kAttnNegInf;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mx = fmaxf(mx, fmaxf(sc[nt][2 * h2], sc[nt][2 * h2 + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[h2], mx);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          sum += fast_exp2(sc[nt][2 * h2] - m_new) + fast_exp2(sc[nt][2 * h2 + 1] - m_new);
        l_r[h2] = l_r[h2] * fast_exp2(m_r[h2] - m_new) + sum;
        m_r[h2] = m_new;
      }
      if (kt == nkt - 1) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          l_r[h2] += __shfl_xor_sync(0xffffffffu, l_r[h2], 1);
          l_r[h2] += __shfl_xor_sync(0xffffffffu, l_r[h2], 2);
        }
        if (kSplit > 1) {   // both groups take the row's max and sum over all keys
          if (t == 0) {
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              xs[(kg * 3) * kBM + rl + 8 * h2] = m_r[h2];
              xs[(kg * 3 + 1) * kBM + rl + 8 * h2] = l_r[h2];
            }
          }
          __syncthreads();
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int r = rl + 8 * h2;
            const float m0 = xs[r], l0 = xs[kBM + r], m1 = xs[3 * kBM + r], l1 = xs[4 * kBM + r];
            m_r[h2] = fmaxf(m0, m1);
            l_r[h2] = l0 * fast_exp2(m0 - m_r[h2]) + l1 * fast_exp2(m1 - m_r[h2]);
          }
        }
      }
    } else {
      // p = exp2(s - m) / l in fp32 (times 1 / l, rounded once per row), then
      // rounded to T where it feeds a product
      const float il[2] = {1.f / l_r[0], 1.f / l_r[1]};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = fast_exp2(sc[nt][e] - m_r[e >> 1]) * il[e >> 1];
      float dp[BWD ? kNT : 1][4];
      if (BWD) {
        // dp = do v^T
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKK; ++kk)
#pragma unroll
          for (int n2 = 0; n2 < kNT / 2; ++n2) {
            uint32_t b[4];
            frag_b_rows(b, Vt, kLd, kb + n2 * 16, kk * 16, lane);
            mma_bf16(dp[2 * n2], da[kk], b[0], b[1]);
            mma_bf16(dp[2 * n2 + 1], da[kk], b[2], b[3]);
          }
      }
      if (pass == 1) {
        if (BWD) {
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dl_r[e >> 1] += sc[nt][e] * dp[nt][e];
        }
        // o += round(p) v
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          uint32_t a[4];
          acc_to_a(a, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
          for (int d2 = 0; d2 < KD / 16; ++d2) {
            uint32_t b[4];
            frag_b_cols(b, Vt, kLd, kb + kk * 16, d2 * 16, lane);
            mma_bf16(acc[2 * d2], a, b[0], b[1]);
            mma_bf16(acc[2 * d2 + 1], a, b[2], b[3]);
          }
        }
      } else if (BWD) {
        // dq += round(p (dp - delta)) k
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = sc[nt][e] * (dp[nt][e] - dl_r[e >> 1]);
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          uint32_t a[4];
          acc_to_a(a, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
          for (int d2 = 0; d2 < KD / 16; ++d2) {
            uint32_t b[4];
            frag_b_cols(b, Kt, kLd, kb + kk * 16, d2 * 16, lane);
            mma_bf16(acc[2 * d2], a, b[0], b[1]);
            mma_bf16(acc[2 * d2 + 1], a, b[2], b[3]);
          }
        }
      }
    }

    if (kt == nkt - 1 && pass >= 1) {
      const size_t row0 = (size_t)w * V;
      if (kSplit > 1) {   // group 1's o (pass 1) or dq (pass 2) to group 0, in order
        if (kg == 1) {
#pragma unroll
          for (int dt = 0; dt < kDT; ++dt)
            *reinterpret_cast<float4*>(xo + ((wr * kDT + dt) * 32 + lane) * 4) =
                make_float4(acc[dt][0], acc[dt][1], acc[dt][2], acc[dt][3]);
        }
        if (BWD && pass == 1) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            dl_r[h2] += __shfl_xor_sync(0xffffffffu, dl_r[h2], 1);
            dl_r[h2] += __shfl_xor_sync(0xffffffffu, dl_r[h2], 2);
            if (t == 0) xs[(kg * 3 + 2) * kBM + rl + 8 * h2] = dl_r[h2];
          }
        }
        __syncthreads();
        if (kg == 0) {
#pragma unroll
          for (int dt = 0; dt < kDT; ++dt) {
            const float4 o1 =
                *reinterpret_cast<const float4*>(xo + ((wr * kDT + dt) * 32 + lane) * 4);
            acc[dt][0] += o1.x;
            acc[dt][1] += o1.y;
            acc[dt][2] += o1.z;
            acc[dt][3] += o1.w;
          }
        }
        if (BWD && pass == 1) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            dl_r[h2] = xs[2 * kBM + rl + 8 * h2] + xs[5 * kBM + rl + 8 * h2];
        }
      } else if (BWD && pass == 1) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          dl_r[h2] += __shfl_xor_sync(0xffffffffu, dl_r[h2], 1);
          dl_r[h2] += __shfl_xor_sync(0xffffffffu, dl_r[h2], 2);
        }
      }
      if (pass == 1) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int i = i0 + rl + 8 * h2;
          if (i >= V || kg > 0) continue;
          bf16* orow = o + (row0 + i) * C + h * D;
#pragma unroll
          for (int dt = 0; dt < kDT; ++dt)
            store_pair(orow, dt * 8 + 2 * t, D, acc[dt][2 * h2], acc[dt][2 * h2 + 1], pair);
          if (BWD && t == 0) {   // the key pass takes p = exp2(s - m) (1 / l) as here
            const size_t at = ((size_t)w * H + h) * V + i;
            stats[at] = m_r[h2];
            stats[plane + at] = 1.f / l_r[h2];
            stats[2 * plane + at] = dl_r[h2];
          }
        }
        if (BWD) {
#pragma unroll
          for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
        }
      } else {
        // dq scale to dqkv, and its column sums over the valid rows
        float cs[kDT][2];
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) cs[dt][0] = cs[dt][1] = 0.f;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int i = i0 + rl + 8 * h2;
          if (i >= V || kg > 0) continue;
          bf16* drow = dqkv + (row0 + i) * 3 * C + h * D;
#pragma unroll
          for (int dt = 0; dt < kDT; ++dt) {
            const float v0 = acc[dt][2 * h2] * scale, v1 = acc[dt][2 * h2 + 1] * scale;
            store_pair(drow, dt * 8 + 2 * t, D, v0, v1, pair);
            cs[dt][0] += v0;
            cs[dt][1] += v1;
          }
        }
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
              cs[dt][e] += __shfl_xor_sync(0xffffffffu, cs[dt][e], off);
            if (g == 0 && kg == 0) red[wr * KD + dt * 8 + 2 * t + e] = cs[dt][e];
          }
        __syncthreads();
        for (int d = threadIdx.x; d < D; d += kThr) {
          float a = 0.f;
#pragma unroll
          for (int wp = 0; wp < 4; ++wp) a += red[wp * KD + d];
          slot[h * D + d] += a;
        }
        if (h == 0) {
          const int rows = min(kBM, V - i0);
          for (int c = threadIdx.x; c < C; c += kThr) {
            float a = 0.f;
            for (int r = 0; r < rows; ++r) a += __bfloat162float(dout[(row0 + i0 + r) * C + c]);
            slot[C + c] += a;
          }
        }
      }
    }
    if (s + 1 == nsteps && it + 1 >= it_end) break;
    if (++s == nsteps) {
      s = 0;
      ++it;
    }
    ++gs;
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Key kernel: the backward's key pass (dk, dv, drel)
// ---------------------------------------------------------------------------

// qkvu: q scale log2(e) | k | v | q per token row (ld 4C); dO: do per head
// (ld C); stats from the row kernel. Writes dk scale and dv at columns C + h
// D and 2C + h D of dqkv (ld 3C), drel segments (V x BK fp32 each, segment
// blockIdx.x + head h nkt + key tile) to kseg, and its slot's [dbk (C) |
// dbv (C)] (zeroed here).
template <int KD>
__global__ void __launch_bounds__(MmaKeyCfg<KD>::kThreads)
wattn_keys_mma_kernel(const bf16* __restrict__ qkvu, const bf16* __restrict__ dO,
                      const float* __restrict__ rel, const int* __restrict__ rid,
                      const float* __restrict__ stats, bf16* __restrict__ dqkv,
                      float* __restrict__ kseg, float* __restrict__ kslots, int BW, int V, int C,
                      int H, int nW, float scale, float mask2) {
  using Cf = MmaKeyCfg<KD>;
  constexpr int kBK = Cf::kBK, kBQ = Cf::kBQ, kLd = Cf::kLd, kLdK = Cf::kLdK;
  constexpr int kThr = Cf::kThreads, kNT = kBQ / 8, kDT = KD / 8, kKK = KD / 16;
  constexpr int kSplit = Cf::kSplit, kKW = Cf::kKW;
  constexpr int kQ = kSplit * kBQ;   // queries per stage
  extern __shared__ __align__(128) unsigned char smem[];
  const MmaKeyLayout L = mma_key_layout<KD>(V);
  float* drel = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + L.off_ring;
  bf16* KVs = reinterpret_cast<bf16*>(smem + L.off_kv);   // two [k | v], by item parity
  float* red = reinterpret_cast<float*>(smem + L.off_red);

  const int D = C / H, Vp = mma_vp(V);
  const int nkt = (V + kBK - 1) / kBK, nq = (V + kQ - 1) / kQ;
  // the ring's depth: kStages, unless an item has so few steps that the k, v
  // tile of the item after next would arrive before this item's is read
  const int nS = 2 * nq >= Cf::kStages - 1 ? Cf::kStages : 2;
  // items < 2^31 (BW V 4C < 2^31 is checked on the host), so int from here on
  const long long items = (long long)H * nkt * BW;
  const int it_begin = (int)(items * blockIdx.x / gridDim.x);
  const int it_end = (int)(items * (blockIdx.x + 1) / gridDim.x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int wk = warp % kKW, qg = warp / kKW;   // the warp's 16 keys; its query group
  const int qb = qg * kBQ;                      // the group's queries in a stage
  const size_t ld = (size_t)4 * C;
  const bool vec = C % 8 == 0 && D % 8 == 0;
  const bool vec_rel = V % 4 == 0;
  const bool pair = C % 2 == 0 && D % 2 == 0;
  const size_t plane = (size_t)BW * H * V;
  float* slot = kslots + (size_t)blockIdx.x * 2 * C;
  for (int e = threadIdx.x; e < 2 * C; e += kThr) slot[e] = 0.f;
  for (int e = threadIdx.x; e < Vp * kLdK; e += kThr) drel[e] = 0.f;
  if (it_begin >= it_end) return;

  // step s of item it: query rows [s kBQ, s kBQ + kBQ) into ring stage st
  // (qs, q unscaled, do, the bias tile rel[h, rows, keys], the rows'
  // statistics and the region ids of those rows and of the item's keys);
  // step 0 also brings the item's k, v tile
  auto prefetch = [&](int it, int s, int st) {
    const int w = it % BW;
    const int kt = (it / BW) % nkt, h = it / BW / nkt;
    const int j0 = kt * kBK, q0 = s * kQ, rows = min(kQ, V - q0);
    const bf16* base = qkvu + (size_t)w * V * ld;
    unsigned char* S = ring + st * L.stage;
    load_head_async<KD>(reinterpret_cast<bf16*>(S), base + (size_t)q0 * ld, ld, h * D, D, rows,
                        kQ, vec, kThr);
    load_head_async<KD>(reinterpret_cast<bf16*>(S + L.off_qu), base + (size_t)q0 * ld, ld,
                        3 * C + h * D, D, rows, kQ, vec, kThr);
    load_head_async<KD>(reinterpret_cast<bf16*>(S + L.off_do), dO + ((size_t)w * V + q0) * C, C,
                        h * D, D, rows, kQ, vec, kThr);
    float* bt = reinterpret_cast<float*>(S + L.off_bt);
    const float* rrow = rel + ((size_t)h * V + q0) * V + j0;
    if (vec_rel) {
      for (int e = threadIdx.x; e < kQ * (kBK / 4); e += kThr) {
        const int r = e / (kBK / 4), jj = (e % (kBK / 4)) * 4;
        const int n = r < rows ? max(0, min(4, V - j0 - jj)) : 0;
        cp_async16(smem_addr(bt + r * kLdK + jj), n > 0 ? rrow + (size_t)r * V + jj : rel, 4 * n);
      }
    } else {
      for (int e = threadIdx.x; e < kQ * kBK; e += kThr) {
        const int r = e / kBK, jj = e % kBK;
        const bool live = r < rows && j0 + jj < V;
        cp_async4(smem_addr(bt + r * kLdK + jj), live ? rrow + (size_t)r * V + jj : rel,
                  live ? 4 : 0);
      }
    }
    float* st_s = reinterpret_cast<float*>(S + L.off_st);
    const size_t srow = ((size_t)w * H + h) * V + q0;
    for (int e = threadIdx.x; e < 3 * kQ; e += kThr) {
      const int k = e / kQ, r = e % kQ;
      cp_async4(smem_addr(st_s + e), r < rows ? stats + k * plane + srow + r : stats,
                r < rows ? 4 : 0);
    }
    if (rid != nullptr) {
      load_rid_async(reinterpret_cast<int*>(S + L.off_rq), rid, w, nW, V, q0, kQ, kThr);
      load_rid_async(reinterpret_cast<int*>(S + L.off_rk), rid, w, nW, V, j0, kBK, kThr);
    }
    if (s == 0) {
      const int keys = min(kBK, V - j0);
      bf16* Ks = KVs + (size_t)(it & 1) * 2 * L.tile_elems;
      load_head_async<KD>(Ks, base + (size_t)j0 * ld, ld, C + h * D, D, keys, kBK, vec, kThr);
      load_head_async<KD>(Ks + L.tile_elems, base + (size_t)j0 * ld, ld, 2 * C + h * D, D, keys,
                          kBK, vec, kThr);
    }
  };

  uint32_t ka[kKK][4], va[kKK][4];
  float dk[kDT][4], dv[kDT][4];
  int h = 0, j0 = 0, w = 0, it = it_begin, pit = it_begin;
  int s = 0, ps = 0, gs = 0;
  // the ring runs nS - 1 steps ahead of the step being computed
  for (int i = 0; i < nS - 1; ++i) {
    if (pit < it_end) {
      prefetch(pit, ps, i);
      if (++ps == nq) {
        ps = 0;
        ++pit;
      }
    }
    cp_async_commit();
  }
  while (true) {
    if (nS == Cf::kStages)
      cp_async_wait<Cf::kStages - 2>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (s == 0) {
      w = it % BW;
      h = it / BW / nkt;
      j0 = (it / BW) % nkt * kBK;
      const bf16* Ks = KVs + (size_t)(it & 1) * 2 * L.tile_elems;
#pragma unroll
      for (int kk = 0; kk < kKK; ++kk) {
        frag_a(ka[kk], Ks, kLd, wk * 16, kk * 16, lane);
        frag_a(va[kk], Ks + L.tile_elems, kLd, wk * 16, kk * 16, lane);
      }
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
      __syncthreads();   // k and v are in registers; the next item may refill them
    }
    if (pit < it_end) {
      prefetch(pit, ps, (gs + nS - 1) % nS);
      if (++ps == nq) {
        ps = 0;
        ++pit;
      }
    }
    cp_async_commit();

    const unsigned char* S = ring + (gs % nS) * L.stage;
    const bf16* Qs = reinterpret_cast<const bf16*>(S);
    const bf16* QUs = reinterpret_cast<const bf16*>(S + L.off_qu);
    const bf16* DOs = reinterpret_cast<const bf16*>(S + L.off_do);
    const float* bt = reinterpret_cast<const float*>(S + L.off_bt);
    const float* st_s = reinterpret_cast<const float*>(S + L.off_st);
    const int* rq = reinterpret_cast<const int*>(S + L.off_rq);   // the step's query region ids
    const int q0 = s * kQ + qb;     // the group's first query
    const int jl = wk * 16 + g;     // this lane's keys: jl and jl + 8 of the tile

    // s^T = k qs^T, dp^T = v do^T (keys on rows, queries on columns)
    float sc[kNT][4], dp[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKK; ++kk)
#pragma unroll
      for (int n2 = 0; n2 < kNT / 2; ++n2) {
        uint32_t bq[4], bd[4];
        frag_b_rows(bq, Qs, kLd, qb + n2 * 16, kk * 16, lane);
        frag_b_rows(bd, DOs, kLd, qb + n2 * 16, kk * 16, lane);
        mma_bf16(sc[2 * n2], ka[kk], bq[0], bq[1]);
        mma_bf16(sc[2 * n2 + 1], ka[kk], bq[2], bq[3]);
        mma_bf16(dp[2 * n2], va[kk], bd[0], bd[1]);
        mma_bf16(dp[2 * n2 + 1], va[kk], bd[2], bd[3]);
      }
    int rk[2] = {0, 0};
    if (rid != nullptr) {
      const int* rks = reinterpret_cast<const int*>(S + L.off_rk);
      rk[0] = rks[jl];
      rk[1] = rks[jl + 8];
    }
    // p^T = exp2(s^T + bias^T + mask - m) / l, ds^T = p^T (dp^T - delta),
    // drel^T += ds^T; both zero past V
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = qb + nt * 8 + 2 * t + (e & 1), kl = jl + 8 * (e >> 1);   // in the stage
        const int i = q0 - qb + ql, j = j0 + kl;
        float p = 0.f, ds = 0.f;
        if (i < V && j < V) {
          float v = sc[nt][e] + bt[ql * kLdK + kl] * kLog2e;
          if (rid != nullptr) v += rq[ql] != rk[e >> 1] ? mask2 : 0.f;
          p = fast_exp2(v - st_s[ql]) * st_s[kQ + ql];
          ds = p * (dp[nt][e] - st_s[2 * kQ + ql]);
          drel[i * kLdK + kl] += ds;
        }
        sc[nt][e] = p;
        dp[nt][e] = ds;
      }
    // dv += round(p^T) do, dk += round(ds^T) q (unscaled)
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t ap[4], ad[4];
      acc_to_a(ap, sc[2 * kk], sc[2 * kk + 1]);
      acc_to_a(ad, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < KD / 16; ++d2) {
        uint32_t bo[4], bq[4];
        frag_b_cols(bo, DOs, kLd, qb + kk * 16, d2 * 16, lane);
        frag_b_cols(bq, QUs, kLd, qb + kk * 16, d2 * 16, lane);
        mma_bf16(dv[2 * d2], ap, bo[0], bo[1]);
        mma_bf16(dv[2 * d2 + 1], ap, bo[2], bo[3]);
        mma_bf16(dk[2 * d2], ad, bq[0], bq[1]);
        mma_bf16(dk[2 * d2 + 1], ad, bq[2], bq[3]);
      }
    }

    if (s == nq - 1) {
      if (kSplit > 1) {
        // group 1's dk and dv to group 0, in order, through this step's ring
        // stage (read by every warp before the barrier, refilled only after
        // the next step's)
        float* xo = reinterpret_cast<float*>(ring + (gs % nS) * L.stage);
        __syncthreads();
        if (qg == 1) {
#pragma unroll
          for (int dt = 0; dt < kDT; ++dt) {
            *reinterpret_cast<float4*>(xo + ((wk * kDT + dt) * 32 + lane) * 4) =
                make_float4(dk[dt][0], dk[dt][1], dk[dt][2], dk[dt][3]);
            *reinterpret_cast<float4*>(xo + (((kKW + wk) * kDT + dt) * 32 + lane) * 4) =
                make_float4(dv[dt][0], dv[dt][1], dv[dt][2], dv[dt][3]);
          }
        }
        __syncthreads();
        if (qg == 0) {
#pragma unroll
          for (int dt = 0; dt < kDT; ++dt) {
            const float4 a =
                *reinterpret_cast<const float4*>(xo + ((wk * kDT + dt) * 32 + lane) * 4);
            const float4 b =
                *reinterpret_cast<const float4*>(xo + (((kKW + wk) * kDT + dt) * 32 + lane) * 4);
            dk[dt][0] += a.x;
            dk[dt][1] += a.y;
            dk[dt][2] += a.z;
            dk[dt][3] += a.w;
            dv[dt][0] += b.x;
            dv[dt][1] += b.y;
            dv[dt][2] += b.z;
            dv[dt][3] += b.w;
          }
        }
      }
      // dk scale and dv to dqkv, and their column sums over the valid keys
      const size_t row0 = (size_t)w * V;
      float cs[2][kDT][2];
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        cs[0][dt][0] = cs[0][dt][1] = cs[1][dt][0] = cs[1][dt][1] = 0.f;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int j = j0 + jl + 8 * h2;
        if (j >= V || qg > 0) continue;
        bf16* drow = dqkv + (row0 + j) * 3 * C + h * D;
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          const float k0 = dk[dt][2 * h2] * scale, k1 = dk[dt][2 * h2 + 1] * scale;
          store_pair(drow + C, dt * 8 + 2 * t, D, k0, k1, pair);
          store_pair(drow + 2 * C, dt * 8 + 2 * t, D, dv[dt][2 * h2], dv[dt][2 * h2 + 1], pair);
          cs[0][dt][0] += k0;
          cs[0][dt][1] += k1;
          cs[1][dt][0] += dv[dt][2 * h2];
          cs[1][dt][1] += dv[dt][2 * h2 + 1];
        }
      }
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
              cs[part][dt][e] += __shfl_xor_sync(0xffffffffu, cs[part][dt][e], off);
            if (g == 0 && qg == 0) red[(wk * 2 + part) * KD + dt * 8 + 2 * t + e] = cs[part][dt][e];
          }
      __syncthreads();
      for (int e = threadIdx.x; e < 2 * D; e += kThr) {
        const int part = e / D, d = e % D;
        float a = 0.f;
#pragma unroll
        for (int wp = 0; wp < kKW; ++wp) a += red[(wp * 2 + part) * KD + d];
        slot[part * C + h * D + d] += a;
      }
      // where the range leaves this (head, key tile): its drel segment out
      const int combo = it / BW;
      if (it + 1 >= it_end || (it + 1) / BW != combo) {
        float* seg = kseg + ((size_t)blockIdx.x + combo) * V * kBK;
        for (int e = threadIdx.x; e < V * kBK; e += kThr) {
          const int i = e / kBK, jj = e % kBK;
          seg[e] = drel[i * kLdK + jj];
          drel[i * kLdK + jj] = 0.f;
        }
      }
      if (it + 1 >= it_end) break;
    }
    if (++s == nq) {
      s = 0;
      ++it;
    }
    ++gs;
  }
  cp_async_wait<0>();
}

// drel (H, V, V) from the key kernel's segments: element (h, i, j) of combo
// c = h nkt + j / BK sums the segments (g, c), g over the blocks whose range
// holds an item of c, in block order (segment g + c, V x BK floats).
__global__ void __launch_bounds__(kThreads)
wattn_drel_reduce_kernel(const float* __restrict__ kseg, float* __restrict__ out, int BW, int V,
                         int H, int BK, int G) {
  const int nkt = (V + BK - 1) / BK;
  const long long N = (long long)H * nkt * BW;
  const size_t total = (size_t)H * V * V;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int j = (int)(e % V), i = (int)((e / V) % V), h = (int)(e / ((size_t)V * V));
    const long long c = (long long)h * nkt + j / BK;
    const int g_lo = block_of(c * BW, N, G), g_hi = block_of(c * BW + BW - 1, N, G);
    float a = 0.f;
    for (int gg = g_lo; gg <= g_hi; ++gg)
      a += kseg[(((size_t)gg + c) * V + i) * BK + j % BK];
    out[e] = a;
  }
}

// ---------------------------------------------------------------------------
// The projections of the bf16 paths
// ---------------------------------------------------------------------------

// out = epilogue(A @ B) as proj_gemm_kernel (window_attention.cuh) computes
// it, and rounding where it rounds, for the bf16 paths: mma_gemm.cuh's
// row-tiled product (128 x 128 output tiles, 8 warps of 64 x 32 on mma.sync
// fragments, a three-stage cp.async ring of 32-deep slices with the tails
// masked), the epilogue on the fragments: bias in fp32, columns n < nscale
// stored as bf16(v scale) (and bf16(v) at column dup + n), the rest as
// bf16(v), two neighbouring columns in one 4-byte store. B_NK: B is stored
// (N, K) (x W^T); else (K, N). The block walks output tiles, columns fastest.
template <bool B_NK>
__global__ void __launch_bounds__(kThreads)
proj_rows_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
                 const float* __restrict__ bias, bf16* __restrict__ out, int ldo, int M, int N,
                 int K, int nscale, float scale, int dup) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Product<bf16> pr{A, B, lda, ldb, M, N, 0};
  const bool pair = ldo % 2 == 0 && (dup < 0 || dup % 2 == 0) &&
                    reinterpret_cast<uintptr_t>(out) % 4 == 0;
  auto put = [&](bf16* o, int c, float v0, float v1, bool two) {
    if (two && pair) {
      *reinterpret_cast<uint32_t*>(o + c) = pack_bf16(v0, v1);
    } else {
      o[c] = __float2bfloat16(v0);
      if (two) o[c + 1] = __float2bfloat16(v1);
    }
  };
  auto store = [&](int row, int col, float v0, float v1) {
    const bool two = col + 1 < N;
    if (bias != nullptr) {
      v0 += bias[col];
      if (two) v1 += bias[col + 1];
    }
    bf16* o = out + (size_t)row * ldo;
    if (col + 1 < nscale || !two) {
      if (col < nscale) {
        put(o, col, v0 * scale, v1 * scale, two);
        if (dup >= 0) put(o + dup, col, v0, v1, two);
      } else {
        put(o, col, v0, v1, two);
      }
    } else if (col >= nscale) {
      put(o, col, v0, v1, two);
    } else {   // the pair straddles nscale
      put(o, col, v0 * scale, 0.f, false);
      if (dup >= 0) put(o + dup, col, v0, 0.f, false);
      put(o, col + 1, v1, 0.f, false);
    }
  };
  const int tn = ceil_div(N, kMmaTile);
  const long long tiles = (long long)ceil_div(M, kMmaTile) * tn;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x)
    mma_tile<false, B_NK>(pr, 0, K, (int)(t / tn) * kMmaTile, (int)(t % tn) * kMmaTile, store,
                          smem);
}

inline int launch_proj_rows(const void* A, int lda, const void* B, int ldb, bool b_nk,
                            const float* bias, void* out, int ldo, int M, int N, int K,
                            int nscale, float scale, int dup, cudaStream_t stream) {
  constexpr size_t bytes = product_smem<bf16>();
  auto kernel = b_nk ? proj_rows_kernel<true> : proj_rows_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)ceil_div(M, kMmaTile) * ceil_div(N, kMmaTile);
  const long long grid = tiles < 65535LL * 16 ? tiles : 65535LL * 16;
  kernel<<<(unsigned)grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(A), lda, static_cast<const bf16*>(B), ldb, bias,
      static_cast<bf16*>(out), ldo, M, N, K, nscale, scale, dup);
  return (int)cudaGetLastError();
}

// The projections: proj_rows_kernel in bf16, proj_gemm_kernel
// (window_attention.cuh) in fp32.
template <typename T>
int launch_projection(const void* A, int lda, const void* B, int ldb, bool b_col,
                      const float* bias, void* out, int ldo, int M, int N, int K, int nscale,
                      float scale, int dup, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value)
    return launch_proj_rows(A, lda, B, ldb, b_col, bias, out, ldo, M, N, K, nscale, scale, dup,
                            stream);
  else
    return launch_proj<T>(A, lda, B, ldb, b_col, bias, out, ldo, M, N, K, nscale, scale, dup,
                          stream);
}

// Blocks of a persistent grid over items: as many as fit on the card at once,
// at most the items. 0 on a device query error.
template <typename Kernel>
int mma_blocks(Kernel kernel, int threads, size_t bytes, long long items) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) !=
      cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes) !=
      cudaSuccess)
    return 0;
  long long g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (g > items) g = items;
  return (int)g;
}

template <bool BWD, int KD> int mma_row_blocks(int BW, int V, int H) {
  using Cf = MmaRowCfg<KD>;
  const long long items = (long long)H * ((V + Cf::kBM - 1) / Cf::kBM) * BW;
  return mma_blocks(wattn_rows_mma_kernel<BWD, KD>, Cf::kThreads,
                    mma_row_layout<KD>(V, BWD).bytes, items);
}

template <int KD> int mma_key_blocks(int BW, int V, int H) {
  using Cf = MmaKeyCfg<KD>;
  const long long items = (long long)H * ((V + Cf::kBK - 1) / Cf::kBK) * BW;
  return mma_blocks(wattn_keys_mma_kernel<KD>, Cf::kThreads, mma_key_layout<KD>(V).bytes, items);
}

// The row kernel on G blocks (mma_row_blocks).
template <bool BWD, int KD>
int launch_rows_mma(const void* qkv, int ldq, const float* rel, const int* rid, const void* dO,
                    const void* dout, void* o, void* dqkv, float* stats, float* slots, int G,
                    int BW, int V, int C, int H, int nW, float scale, float mask2,
                    cudaStream_t stream) {
  const size_t bytes = mma_row_layout<KD>(V, BWD).bytes;
  if (G <= 0 || bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wattn_rows_mma_kernel<BWD, KD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  wattn_rows_mma_kernel<BWD, KD><<<G, MmaRowCfg<KD>::kThreads, bytes, stream>>>(
      static_cast<const bf16*>(qkv), ldq, rel, rid, static_cast<const bf16*>(dO),
      static_cast<const bf16*>(dout), static_cast<bf16*>(o), static_cast<bf16*>(dqkv), stats,
      slots, BW, V, C, H, nW, scale, mask2);
  return (int)cudaGetLastError();
}

// The key kernel on G blocks (mma_key_blocks), then drel's segment sums into
// drel_out (H, V, V).
template <int KD>
int launch_keys_mma(const void* qkvu, const void* dO, const float* rel, const int* rid,
                    const float* stats, void* dqkv, float* kseg, float* kslots, float* drel_out,
                    int G, int BW, int V, int C, int H, int nW, float scale, float mask2,
                    cudaStream_t stream) {
  const size_t bytes = mma_key_layout<KD>(V).bytes;
  if (G <= 0 || bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wattn_keys_mma_kernel<KD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  wattn_keys_mma_kernel<KD><<<G, MmaKeyCfg<KD>::kThreads, bytes, stream>>>(
      static_cast<const bf16*>(qkvu), static_cast<const bf16*>(dO), rel, rid, stats,
      static_cast<bf16*>(dqkv), kseg, kslots, BW, V, C, H, nW, scale, mask2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t blocks = ((size_t)H * V * V + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  wattn_drel_reduce_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(kseg, drel_out, BW, V, H,
                                                                      MmaKeyCfg<KD>::kBK, G);
  return (int)cudaGetLastError();
}

}  // namespace lcbi
