// K7's forward passes and carry backward on segment rows streamed through
// shared memory: the device code of selective_scan_long.cu (the forward from
// zero carries, writing each row's final state hl and decay product ap, and
// the forward seeded with the stitched carries h0, writing y) and
// selective_scan_long_carry_bwd.cu (each row's dh at its start from a zero
// tail, dh_{t-1} = exp(d_t A) (dh_t + C_t g_t)); see selective_scan_long.cuh.
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
//     so their steps are the identity: every row streams all of its
//     kScanSeg / kStreamChunk chunks, and only the last row of a batch row
//     can be short. The carry backward streams a row's chunks from its end
//     and walks each chunk's tokens backwards.
//   * The seeded pass loads the next row's carries into registers when it
//     starts a row, so that they have arrived when the row ends.
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

enum StreamMode { kFwdZero = 0, kFwdSeeded = 1, kCarryBwd = 2 };

// x0, x1: the streamed (b, L, D) planes, u and delta (forward) or delta and g
// (carry backward); the state planes B and C (b, L, N); the carries h0 in
// (seeded) and hl, ap out (zero carries; the carry backward writes dh0 to hl).
struct StreamArgs {
  const float *x0, *x1, *at, *B, *C, *h0;
  float *y, *hl, *ap;
};

struct StreamGeom {
  int L, D, N, nseg, rows;
  int tc, tiles, blocks;  // channels of a tile (= threads of a block), tiles, blocks of a tile
  size_t smem;            // shared-memory bytes of a block
  bool vec;               // 16-byte copies (D % 4 == 0)
};

// B and/or C planes a stage holds.
__host__ __device__ constexpr int stream_states(int mode) { return mode == kFwdSeeded ? 2 : 1; }
__host__ __device__ constexpr bool stream_lean(int mode, int np) {
  return mode != kFwdSeeded && np == 8;
}
__host__ __device__ constexpr int stream_stages(int mode, int np) {
  return stream_lean(mode, np) ? kStreamLeanStages : kStreamStages;
}

inline bool stream_geom(int b, int L, int D, int N, int mode, StreamGeom* g) {
  ScanGeom sg;
  if (!scan_geom(b, L, D, N, &sg)) return false;
  g->L = L;
  g->D = D;
  g->N = N;
  g->nseg = sg.nseg;
  g->rows = sg.rows;
  g->tiles = (D + kStreamMaxTile - 1) / kStreamMaxTile;
  g->tc = round_up32((D + g->tiles - 1) / g->tiles);
  const int stage = 2 * kStreamChunk * g->tc + stream_states(mode) * kStreamChunk * scan_np(N);
  g->smem = sizeof(float) * stream_stages(mode, scan_np(N)) * stage;
  g->vec = D % 4 == 0;
  g->blocks = 0;
  return true;
}

// A row's geometry (see scan_row), taken when an item opens a row.
struct StreamRow {
  int row;
  ScanRow r;
};

template <int NP, int MODE, bool SP>
__global__ void __launch_bounds__(kStreamMaxTile, stream_lean(MODE, NP) ? kStreamLeanBlocks : 1)
long_scan_stream_kernel(StreamArgs a, StreamGeom g) {
  constexpr int K = kStreamChunk, CPR = kStreamChunks, S = stream_stages(MODE, NP);
  constexpr int NS = stream_states(MODE);
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tc = g.tc, D = g.D, N = g.N;
  const int c0 = blockIdx.y * tc, d = c0 + tid;
  const bool on = d < D;
  const int plane = K * tc, stage = 2 * plane + NS * K * NP;
  // this thread's share of the staging: with vec, the 16-byte column q of
  // tokens j0, j0 + 4, ... of a chunk, else its own channel of every token;
  // state e % NP of token e / NP for e = tid, tid + tc, ...
  const int nq = tc / 4, q = tid % nq, j0 = tid / nq;
  const int ldc = c0 + 4 * q;
  const bool col = g.vec ? ldc < D : on;
  float a2[NP];
  load_a2<NP>(a2, a.at, on ? d : 0, D, on ? N : 0);

  // the block's rows blockIdx.x, + gridDim.x, ...: CPR items (chunks) each
  const int nrows = g.rows > (int)blockIdx.x ? (g.rows - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int items = nrows * CPR;
  auto open_row = [&](int i) {
    const int row = blockIdx.x + (i / CPR) * gridDim.x;
    return StreamRow{row, scan_row(g.L, g.nseg, row)};
  };
  // item i's chunk of its row: counted from the row's end in the carry
  // backward
  auto chunk_of = [](int i) { return MODE == kCarryBwd ? CPR - 1 - i % CPR : i % CPR; };

  StreamRow irow{0, {0, 0}};
  auto issue = [&](int i) {
    if (i % CPR == 0) irow = open_row(i);
    const int t0 = chunk_of(i) * K, lim = irow.r.len - t0;  // the chunk's tokens in the row
    const size_t tok = irow.r.tok0 + t0;
    const float *x0 = a.x0 + tok * D, *x1 = a.x1 + tok * D;
    float* st = smem + (i % S) * stage;
    if (g.vec) {
#pragma unroll
      for (int jj = 0; jj < K / 4; ++jj) {
        const int j = j0 + 4 * jj, o = j * D + ldc, so = j * tc + 4 * q;
        const bool live = col && j < lim;
        scan_cp16(st + so, live ? x0 + o : a.x0, live);
        scan_cp16(st + plane + so, live ? x1 + o : a.x1, live);
      }
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const bool live = col && j < lim;
        const int o = j * D + d;
        scan_cp4(st + j * tc + tid, live ? x0 + o : a.x0, live);
        scan_cp4(st + plane + j * tc + tid, live ? x1 + o : a.x1, live);
      }
    }
    const float *sb = a.B + tok * N, *sc = a.C + tok * N;
    for (int e = tid; e < K * NP; e += tc) {
      const int j = e / NP, n = e % NP, o = j * N + n;
      const bool live = j < lim && n < N;
      float* sp = st + 2 * plane + e;
      if (MODE == kCarryBwd) {
        scan_cp4(sp, live ? sc + o : a.C, live);
      } else {
        scan_cp4(sp, live ? sb + o : a.B, live);
        if (MODE == kFwdSeeded) scan_cp4(sp + K * NP, live ? sc + o : a.C, live);
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
  for (int i = 0; i < items; ++i) {
    scan_cp_wait<S - 2>();
    __syncthreads();  // item i has landed; item i - 1's stage is free
    if (i + S - 1 < items) issue(i + S - 1);
    scan_cp_commit();
    if (i % CPR == 0) {
      crow = open_row(i);
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        h[n] = MODE == kFwdSeeded ? hn[n] : 0.f;
        p[n] = 1.f;
      }
      if (MODE == kFwdSeeded) load_carry(crow.row + gridDim.x);
    }
    const ScanRow r = crow.r;
    const int t0 = chunk_of(i) * K, lim = r.len - t0;  // tokens of the chunk in the row
    const float* st = smem + (i % S) * stage;
    const float* sx0 = st + tid;
    const float* sx1 = st + plane + tid;
    const float* ss = st + 2 * plane;
    float* yp = MODE == kFwdSeeded ? a.y + (r.tok0 + t0) * D + d : nullptr;
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
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float dt = stream_dt<SP>(sx1[j * tc]) * (j < lim ? 1.f : 0.f);
        const float du = dt * sx0[j * tc];
        float bn[NP], cn[NP];
#pragma unroll
        for (int n4 = 0; n4 < NP; n4 += 4) {
          *reinterpret_cast<float4*>(bn + n4) = *reinterpret_cast<const float4*>(ss + j * NP + n4);
          if (MODE == kFwdSeeded)
            *reinterpret_cast<float4*>(cn + n4) =
                *reinterpret_cast<const float4*>(ss + (K + j) * NP + n4);
        }
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          const float an = stream_exp2(dt * a2[n]);
          h[n] = fmaf(an, h[n], du * bn[n]);
          if (MODE == kFwdSeeded)
            acc = fmaf(cn[n], h[n], acc);
          else
            p[n] *= an;
        }
        if (MODE == kFwdSeeded && on && j < lim) yp[j * D] = acc;
      }
    }
    // the row's last chunk: its carries out
    if (MODE != kFwdSeeded && i % CPR == CPR - 1 && on) {
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        if (n >= N) break;
        const size_t o = ((size_t)crow.row * N + n) * D + d;
        a.hl[o] = h[n];
        if (MODE == kFwdZero) a.ap[o] = p[n];
      }
    }
  }
}

// f(std::integral_constant<int, NP>, std::integral_constant<bool, SP>) for
// the call's padded states and softplus flag (with_np_softplus), after
// planning the call's grid: as many blocks of each tile as fit on the device
// at once, at most one a row. Returns a CUDA error code.
template <int MODE, class F>
int stream_launch(StreamGeom& g, bool softplus, F&& f) {
  return with_np_softplus(g.N, softplus, [&](auto np, auto sp) {
    constexpr int NP = decltype(np)::value;
    constexpr bool SP = decltype(sp)::value;
    auto kernel = long_scan_stream_kernel<NP, MODE, SP>;
    // the device's answer for the last (device, tile, shared memory) of this
    // instance, so that a call repeating a shape queries nothing
    static int last_dev = -1, last_tc = 0, last_blocks = 0;
    static size_t last_smem = 0;
    cudaError_t err;
    int dev = 0;
    if ((err = cudaGetDevice(&dev))) return (int)err;
    if (dev != last_dev || g.tc != last_tc || g.smem != last_smem) {
      int sms = 0, per_sm = 0;
      if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)g.smem)) ||
          (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, g.tc, g.smem)))
        return (int)err;
      if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      last_dev = dev;
      last_tc = g.tc;
      last_smem = g.smem;
      last_blocks = sms * per_sm;
    }
    long long blocks = last_blocks / g.tiles;
    if (blocks > g.rows) blocks = g.rows;
    g.blocks = blocks < 1 ? 1 : (int)blocks;
    return f(kernel);
  });
}

}  // namespace lcbi
