// K7's forward passes and carry backward, and K9's forward, on rows streamed
// through shared memory: the device code of selective_scan_long.cu (the
// forward from zero carries, writing each row's final state hl and decay
// product ap, and the forward seeded with the stitched carries h0, writing
// y), selective_scan_long_carry_bwd.cu (each row's dh at its start from a
// zero tail, dh_{t-1} = exp(d_t A) (dh_t + C_t g_t)) and
// selective_scan_window.cu (K9: the forward writing y from zero carries, with
// no carry loads, each window of L <= 64 tokens one row); see
// selective_scan_long.cuh.
//
// What bounds them on the H100: device memory and the special-function
// unit about equally, then instruction issue. Each reads two (b, L, D) fp32
// planes (u and delta, or delta and g; 8 bytes per (token, channel)), the
// seeded pass writes y (4 more): at the vit65k_mamba call a byte floor of
// 0.069 ms (zero carries), 0.096 (seeded), 0.065 (carry backward). Each
// takes NP + 1 exponentials per (token, channel) on the SM's 16-a-clock
// special-function unit (the states' decays and softplus's exp), about
// 0.06-0.07 ms there, and some 50 instructions. The per-thread kernel this
// replaces (a thread per (row, channel), blocks of 96) reached 48-60% of
// the byte floors; the ablations of utils/k7_stream_tiles.py show a pass
// without its loads, without its states' exponentials or without softplus
// each within 7-12% of the whole. The design:
//   * Wide persistent blocks. A block takes a tile of tc channels (the whole
//     row's channels up to kStreamMaxTile; wider rows are cut into tiles of
//     equal width, a multiple of 32), one thread a channel with its NP states
//     in registers, and walks the rows blockIdx.x, blockIdx.x + gridDim.x, ...
//     of its tile. The grid holds as many blocks as fit on the device at once.
//   * A ring of stages. The rows' tokens reach the block in chunks of
//     kStreamChunk tokens: both planes (tc channels each) and B and/or C of
//     the chunk, by cp.async (16 bytes a copy along the channels where D % 4
//     == 0), into a ring of 3 or 4 stages. A block keeps the next 2 or 3
//     chunks in flight, across its row boundaries, while it computes one:
//     120-150 KB in flight an SM at the vit65k_mamba call. Each thread
//     stages a fixed 16-byte column of every fourth token, so the staging
//     loops hold no division; a row's geometry (one division by nseg) is
//     taken once a row.
//   * Few instructions a token. exp2 by ex2.approx.ftz, one instruction
//     (the library's exp2f wraps the same one in a rescale); softplus with
//     one exponential and a polynomial on the FMA pipe (stream_softplus); a
//     chunk's tokens unrolled, so that their exponentials interleave. The
//     states' arithmetic is the per-thread kernel's, in its order (NP exp2s
//     per (token, channel) per pass), so the carries and y are the same
//     values within a few fp32 roundings.
//   * Ragged rows. Tokens past a row's end are staged as zeros and given d =
//     0 (a multiply, not a branch, so that the tokens of a chunk interleave),
//     so their steps are the identity: every K7 row streams all of its
//     kScanSeg / kStreamChunk chunks, and only the last row of a batch row
//     can be short. The carry backward streams a row's chunks from its end
//     and walks each chunk's tokens backwards.
//   * The seeded pass loads the next row's carries into registers when it
//     starts a row, so that they have arrived when the row ends.
//   * K9's windows (kWinFwd). Every window is short (49 tokens at micro_w7's
//     7x7 windows), so a row streams ceil(L / kStreamChunk) chunks, not all
//     kScanSeg / kStreamChunk, and its ragged last chunk (one token at L =
//     49) runs its live tokens alone, a branch the same for every thread of
//     the block: the special-function unit does no work past a window's end
//     (the ragged chunk computed in full cost 15-17%, streaming all 8 chunks
//     1-4%). Narrow windows (D <= kWinMaxTile) put `groups` windows'
//     channel tiles of D threads in one block, as many as fit in
//     kStreamMaxTile threads (5 x 48 = 240 at micro_w7's stage 0, a warp
//     holding two windows' channels; the fewest or most windows that fill
//     whole warps, 96 or 192 threads there, were 0-7% slower); each group
//     walks its own window of the block's unit of windows, and a block's
//     groups share the ring's stages and barriers. Wide windows take tiles
//     of at most kWinMaxTile channels, so that stage 3's 400 windows make
//     enough units. Two stages (one chunk in flight) and registers for three
//     blocks of 256 an SM (80) beat K7's seeded pass's four stages and
//     natural registers (112) here by 3-15% (utils/k7_stream_tiles.py).
#pragma once

#include "selective_scan_long.cuh"

namespace lcbi {

constexpr int kStreamChunk = 8;                         // tokens of a stage
constexpr int kStreamChunks = kScanSeg / kStreamChunk;  // stages of a row
constexpr int kStreamMaxTile = 256;                     // channels (threads) of a block at most
// The ring's stages and the blocks of kStreamMaxTile an SM its registers
// are budgeted for: the zero-carry pass and the carry backward at NP = 8
// ("lean") at 64 registers a thread and three stages, so that five blocks of
// 192 threads share an SM; the seeded pass, and every pass at NP = 16, at
// their natural register counts (80 for the seeded pass at NP = 8) and four
// stages (utils/k7_stream_tiles.py).
constexpr int kStreamStages = 4;
constexpr int kStreamLeanStages = 3;
constexpr int kStreamLeanBlocks = 4;
// K9: the channels of a tile at most (narrower windows share a block), the
// windows a block walks at once at most (their state planes, 2 x
// kStreamChunk x NP floats a window a stage, bound the block's shared memory
// at narrow D), and the forward's stages and the blocks of kStreamMaxTile
// an SM its registers are budgeted for (utils/k7_stream_tiles.py)
constexpr int kWinMaxTile = 128;
constexpr int kWinMaxGroups = 8;
constexpr int kWinStages = 2;
constexpr int kWinBlocks = 3;

// 2^x on the special-function unit, subnormal results flushed to zero (the
// library's exp2f adds a rescale of its argument and result around the same
// instruction to keep them)
__device__ __forceinline__ float stream_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// softplus(v) = max(v, 0) + log(1 + e), e = exp(-|v|) in (0, 1]: e on the
// special-function unit, log(1 + e) = e q(e) with q the degree-8 Chebyshev
// interpolant of log(1 + e) / e on [0, 1] on the FMA pipe, which has room
// where the special-function unit, with its NP exp2s a token, has none.
// Relative accuracy matters: the model's steps are small (its dt bias puts
// softplus near 0.001-0.1), where an absolute error of 1e-7 in log(1 + e)
// moved its dt bias gradient by 2e-4 of its max (chip_smoke.py phase 31);
// e q(e) is within 2.5e-7 of log(1 + e) relative to it in fp32.
__device__ __forceinline__ float stream_softplus(float v) {
  const float e = stream_exp2(-fabsf(v) * kLog2e);
  float q = 0.0051261018961668015f;
  q = fmaf(q, e, -0.029074065387248993f);
  q = fmaf(q, e, 0.0775160863995552f);
  q = fmaf(q, e, -0.13602247834205627f);
  q = fmaf(q, e, 0.19076880812644958f);
  q = fmaf(q, e, -0.2483539879322052f);
  q = fmaf(q, e, 0.3331812024116516f);
  q = fmaf(q, e, -0.4999944567680359f);
  q = fmaf(q, e, 0.9999999403953552f);
  return fmaf(e, q, fmaxf(v, 0.f));
}
template <bool SOFTPLUS>
__device__ __forceinline__ float stream_dt(float v) {
  return SOFTPLUS ? stream_softplus(v) : v;
}

enum StreamMode { kFwdZero = 0, kFwdSeeded = 1, kCarryBwd = 2, kWinFwd = 3 };

// x0, x1: the streamed (b, L, D) planes, u and delta (forward) or delta and g
// (carry backward); the state planes B and C (b, L, N); the carries h0 in
// (seeded) and hl, ap out (zero carries; the carry backward writes dh0 to hl).
struct StreamArgs {
  const float *x0, *x1, *at, *B, *C, *h0;
  float *y, *hl, *ap;
};

struct StreamGeom {
  int L, D, N, nseg, rows;
  int tc, tiles, blocks;  // channels of a tile, tiles, blocks of a tile
  int groups, cpr;        // rows a block walks at once (a tile of tc threads each), chunks a row
  size_t smem;            // shared-memory bytes of a block
  bool vec;               // 16-byte copies (D % 4 == 0)
};

// B and/or C planes a stage holds.
__host__ __device__ constexpr int stream_states(int mode) {
  return mode == kFwdSeeded || mode == kWinFwd ? 2 : 1;
}
__host__ __device__ constexpr bool stream_lean(int mode, int np) {
  return (mode == kFwdZero || mode == kCarryBwd) && np == 8;
}
__host__ __device__ constexpr int stream_stages(int mode, int np) {
  return mode == kWinFwd ? kWinStages : stream_lean(mode, np) ? kStreamLeanStages : kStreamStages;
}
__host__ __device__ constexpr int stream_min_blocks(int mode, int np) {
  return mode == kWinFwd ? kWinBlocks : stream_lean(mode, np) ? kStreamLeanBlocks : 1;
}

inline bool stream_geom(int b, int L, int D, int N, int mode, StreamGeom* g) {
  ScanGeom sg;
  if (!scan_geom(b, L, D, N, &sg)) return false;
  g->L = L;
  g->D = D;
  g->N = N;
  g->nseg = sg.nseg;
  g->rows = sg.rows;
  const int max_tile = mode == kWinFwd ? kWinMaxTile : kStreamMaxTile;
  g->tiles = (D + max_tile - 1) / max_tile;
  g->tc = round_up32((D + g->tiles - 1) / g->tiles);
  g->groups = 1;
  g->cpr = kStreamChunks;
  if (mode == kWinFwd) {
    if (L > kScanSeg) return false;
    g->cpr = (L + kStreamChunk - 1) / kStreamChunk;
    if (D <= kWinMaxTile) {
      // tiles of exactly D threads, as many as fit in kStreamMaxTile threads
      // (a warp may hold two windows' channels), kWinMaxGroups at most
      const int groups = kStreamMaxTile / D;
      g->tc = D;
      g->groups = groups < kWinMaxGroups ? groups : kWinMaxGroups;
    }
  }
  const int stage =
      g->groups * kStreamChunk * (2 * g->tc + stream_states(mode) * scan_np(N));
  g->smem = sizeof(float) * stream_stages(mode, scan_np(N)) * stage;
  g->vec = D % 4 == 0;
  g->blocks = 0;
  return true;
}

// Threads of a block, and the units (groups of `groups` rows) its tiles walk.
inline int stream_threads(const StreamGeom& g) { return g.tc * g.groups; }
inline int stream_units(const StreamGeom& g) { return (g.rows + g.groups - 1) / g.groups; }

// A row's geometry (see scan_row), taken when an item opens a row; a row past
// the call's last (the last unit of K9's windows may hold fewer than
// `groups`) has no tokens.
struct StreamRow {
  int row;
  ScanRow r;
};

template <int NP, int MODE, bool SP>
__global__ void __launch_bounds__(kStreamMaxTile, stream_min_blocks(MODE, NP))
long_scan_stream_kernel(StreamArgs a, StreamGeom g) {
  constexpr int K = kStreamChunk, S = stream_stages(MODE, NP);
  constexpr int NS = stream_states(MODE);
  constexpr bool WIN = MODE == kWinFwd;
  constexpr bool EMIT_Y = MODE == kFwdSeeded || WIN;
  extern __shared__ __align__(16) float smem[];
  const int tc = g.tc, D = g.D, N = g.N;
  // K7's rows: one group, all kScanSeg / K chunks of a row (compile-time)
  const int G = WIN ? g.groups : 1, CPR = WIN ? g.cpr : kStreamChunks;
  const int grp = WIN ? threadIdx.x / tc : 0, tid = threadIdx.x - grp * tc;
  const int c0 = blockIdx.y * tc, d = c0 + tid;
  const bool on = d < D;
  // a stage: plane x0 and plane x1 (G x K x tc each), then each group's NS
  // state planes (K x NP each); this thread's group's parts of them
  const int plane = G * K * tc, stage = 2 * plane + G * NS * K * NP;
  const int gx = grp * K * tc, gs = 2 * plane + grp * NS * K * NP;
  // this thread's share of its group's staging: with vec, the 16-byte column
  // q of tokens j0, j0 + 4, ... of a chunk, else its own channel of every
  // token; state e % NP of token e / NP for e = tid, tid + tc, ...
  const int nq = g.vec ? tc / 4 : 1, q = tid % nq, j0 = tid / nq;
  const int ldc = c0 + 4 * q;
  const bool col = g.vec ? ldc < D : on;
  float a2[NP];
  load_a2<NP>(a2, a.at, on ? d : 0, D, on ? N : 0);

  // the block's units (K7: rows) blockIdx.x, + gridDim.x, ...: CPR items
  // (chunks) each. Item i is chunk i % CPR of the block's unit i / CPR: K7
  // divides by its constant CPR; K9, whose CPR is the call's, walks the
  // items in order twice, by the copies (issue) and by the arithmetic, each
  // with its own (unit, chunk) counter
  const int units = (g.rows + G - 1) / G;
  const int nunits = units > (int)blockIdx.x ? (units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int items = nunits * CPR;
  auto open_row = [&](int k) {
    const int row = (blockIdx.x + k * gridDim.x) * G + grp;
    return StreamRow{row, !WIN || row < g.rows ? scan_row(g.L, g.nseg, row) : ScanRow{0, 0}};
  };
  // chunk c of its row: counted from the row's end in the carry backward
  auto chunk_of = [&](int c) { return MODE == kCarryBwd ? CPR - 1 - c : c; };

  StreamRow irow{0, {0, 0}};
  int iu = 0, ic = 0;  // K9: the next item to issue, its unit and chunk
  auto issue = [&](int i) {
    const int c = WIN ? ic : i % CPR;
    if (c == 0) irow = open_row(WIN ? iu : i / CPR);
    if (WIN && ++ic == CPR) {
      ic = 0;
      ++iu;
    }
    const int t0 = chunk_of(c) * K, lim = irow.r.len - t0;  // the chunk's tokens in the row
    const size_t tok = irow.r.tok0 + t0;
    const float *x0 = a.x0 + tok * D, *x1 = a.x1 + tok * D;
    float* st = smem + (i % S) * stage;
    if (g.vec) {
#pragma unroll
      for (int jj = 0; jj < K / 4; ++jj) {
        const int j = j0 + 4 * jj, o = j * D + ldc, so = gx + j * tc + 4 * q;
        const bool live = col && j < lim;
        scan_cp16(st + so, live ? x0 + o : a.x0, live);
        scan_cp16(st + plane + so, live ? x1 + o : a.x1, live);
      }
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const bool live = col && j < lim;
        const int o = j * D + d;
        scan_cp4(st + gx + j * tc + tid, live ? x0 + o : a.x0, live);
        scan_cp4(st + plane + gx + j * tc + tid, live ? x1 + o : a.x1, live);
      }
    }
    const float *sb = a.B + tok * N, *sc = a.C + tok * N;
    for (int e = tid; e < K * NP; e += tc) {
      const int j = e / NP, n = e % NP, o = j * N + n;
      const bool live = j < lim && n < N;
      float* sp = st + gs + e;
      if (MODE == kCarryBwd) {
        scan_cp4(sp, live ? sc + o : a.C, live);
      } else {
        scan_cp4(sp, live ? sb + o : a.B, live);
        if (NS == 2) scan_cp4(sp + K * NP, live ? sc + o : a.C, live);
      }
    }
  };

  float h[NP], p[NP], hn[NP];
  auto load_carry = [&](int row) {
#pragma unroll
    for (int n = 0; n < NP; ++n)
      hn[n] = on && n < N && row < g.rows ? a.h0[((size_t)row * N + n) * D + d] : 0.f;
  };
  if (MODE == kFwdSeeded && items > 0) load_carry(blockIdx.x);

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < items) issue(i);
    scan_cp_commit();
  }
  StreamRow crow{0, {0, 0}};
  int cu = 0, cc = 0;  // K9: item i's unit and chunk
  for (int i = 0; i < items; ++i) {
    scan_cp_wait<S - 2>();
    __syncthreads();  // item i has landed; item i - 1's stage is free
    if (i + S - 1 < items) issue(i + S - 1);
    scan_cp_commit();
    const int c = WIN ? cc : i % CPR;
    if (c == 0) {
      crow = open_row(WIN ? cu : i / CPR);
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        h[n] = MODE == kFwdSeeded ? hn[n] : 0.f;
        p[n] = 1.f;
      }
      if (MODE == kFwdSeeded) load_carry(crow.row + gridDim.x);
    }
    const ScanRow r = crow.r;
    const int t0 = chunk_of(c) * K, lim = r.len - t0;  // tokens of the chunk in the row
    const float* st = smem + (i % S) * stage;
    const float* sx0 = st + gx + tid;
    const float* sx1 = st + plane + gx + tid;
    const float* ss = st + gs;
    float* yp = EMIT_Y ? a.y + (r.tok0 + t0) * D + d : nullptr;
    if (MODE == kCarryBwd) {
      // counted up, indexed down: the count-down loop `for (t = r.len - 1; t
      // >= 0; --t)` built by nvcc 12.8 left one-token rows all zero at NP =
      // 8 without softplus (tests/test_torch_cuda.py)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = K - 1 - k;
        const float dt = stream_dt<SP>(sx0[j * tc]) * (j < lim ? 1.f : 0.f);
        const float gt = sx1[j * tc];
        float cn[NP];
#pragma unroll
        for (int n4 = 0; n4 < NP; n4 += 4)
          *reinterpret_cast<float4*>(cn + n4) = *reinterpret_cast<const float4*>(ss + j * NP + n4);
#pragma unroll
        for (int n = 0; n < NP; ++n) h[n] = stream_exp2(dt * a2[n]) * fmaf(cn[n], gt, h[n]);
      }
    } else {
      // token j of the chunk, its d scaled by live (0 past the row's end)
      auto step = [&](int j, float live) {
        const float dt = stream_dt<SP>(sx1[j * tc]) * live;
        const float du = dt * sx0[j * tc];
        float bn[NP], cn[NP];
#pragma unroll
        for (int n4 = 0; n4 < NP; n4 += 4) {
          *reinterpret_cast<float4*>(bn + n4) = *reinterpret_cast<const float4*>(ss + j * NP + n4);
          if (EMIT_Y)
            *reinterpret_cast<float4*>(cn + n4) =
                *reinterpret_cast<const float4*>(ss + (K + j) * NP + n4);
        }
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          const float an = stream_exp2(dt * a2[n]);
          h[n] = fmaf(an, h[n], du * bn[n]);
          if (EMIT_Y)
            acc = fmaf(cn[n], h[n], acc);
          else
            p[n] *= an;
        }
        if (EMIT_Y && on && j < lim) yp[j * D] = acc;
      };
      if (WIN && lim < K) {
        // a window's ragged last chunk (the same for every group of the
        // block): its live tokens alone
        for (int j = 0; j < lim; ++j) step(j, 1.f);
      } else {
#pragma unroll
        for (int j = 0; j < K; ++j) step(j, j < lim ? 1.f : 0.f);
      }
    }
    // the row's last chunk: its carries out
    if (!EMIT_Y && c == CPR - 1 && on) {
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        if (n >= N) break;
        const size_t o = ((size_t)crow.row * N + n) * D + d;
        a.hl[o] = h[n];
        if (MODE == kFwdZero) a.ap[o] = p[n];
      }
    }
    if (WIN && ++cc == CPR) {
      cc = 0;
      ++cu;
    }
  }
}

// f(std::integral_constant<int, NP>, std::integral_constant<bool, SP>) for
// the call's padded states and softplus flag (with_np_softplus), after
// planning the call's grid: as many blocks of each tile as fit on the device
// at once, at most one a unit (stream_units). Returns a CUDA error code.
template <int MODE, class F>
int stream_launch(StreamGeom& g, bool softplus, F&& f) {
  return with_np_softplus(g.N, softplus, [&](auto np, auto sp) {
    constexpr int NP = decltype(np)::value;
    constexpr bool SP = decltype(sp)::value;
    auto kernel = long_scan_stream_kernel<NP, MODE, SP>;
    // the device's answer for the last (device, block, shared memory) of this
    // instance, so that a call repeating a shape queries nothing
    static int last_dev = -1, last_threads = 0, last_blocks = 0;
    static size_t last_smem = 0;
    cudaError_t err;
    int dev = 0;
    const int threads = stream_threads(g);
    if ((err = cudaGetDevice(&dev))) return (int)err;
    if (dev != last_dev || threads != last_threads || g.smem != last_smem) {
      int sms = 0, per_sm = 0;
      if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)g.smem)) ||
          (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, g.smem)))
        return (int)err;
      if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      last_dev = dev;
      last_threads = threads;
      last_smem = g.smem;
      last_blocks = sms * per_sm;
    }
    long long blocks = last_blocks / g.tiles;
    if (blocks > stream_units(g)) blocks = stream_units(g);
    g.blocks = blocks < 1 ? 1 : (int)blocks;
    return f(kernel);
  });
}

}  // namespace lcbi
