// Windowed selective scan (K9), the backward: for the cotangent g of y (see
// selective_scan_window.cu), per window from h = 0 and a zero tail,
//     dh_t   = a_{t+1} dh_{t+1} + C_t g_t        (a_t = exp(d_t A))
//     du_t   = d_t sum_n dh_t B_t               dC_t = sum_d h_t g_t
//     dd_t   = (u_t sum_n dh_t B_t + sum_n dh_t h_{t-1} a_t A) sigmoid(delta_t)
//     dB_t   = sum_d dh_t d_t u_t               dA  += sum_t dh_t h_{t-1} a_t d_t
// (without softplus, dd_t lacks the sigmoid). dB and dC sum over the
// channels, dA over every token of every window.
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/selective_scan_pallas.py
// _make_bwd_kernel (launched by _bwd), which keeps the h history of a block
// of rows in VMEM, sums dB and dC over its sequential channel-chunk grid axis
// inside their VMEM-resident output block, and writes one dA partial per grid
// cell, summed by XLA.
//
// What bounds it on the H100: device memory, u, delta, g read and du, dd
// written once (20 bytes per (token, channel)), against some 20 fp32
// operations per (token, channel, state) with the h recompute (chip_smoke.py
// k9_bounds). The design, simply:
//   * A persistent grid: block k walks a contiguous range of tiles, a tile
//     being `wpb` whole windows; a block holds every channel of its windows,
//     one thread per channel of a group of at most 128, the groups in turn.
//     Each window's channels take whole warps (the group padded to a
//     multiple of 32 threads, the pad threads idle).
//   * The h history of a window is 64 tokens x 8 states per channel, too
//     much for registers. Pass 1 runs the recurrence forward and keeps h at
//     the start of every stretch of 8 tokens (shared memory); the reverse
//     pass recomputes each stretch's 8 states from its checkpoint into shared
//     memory and walks it backwards, as the long scan K7 does.
//   * dB and dC at each token sum over the channels without atomics: a
//     transposing butterfly leaves the warp's sum of each of the 16 values at
//     two lanes, a window's warps' partials are summed in order after each
//     stretch, and the groups add into the window's sums in order.
//   * dA: each thread sums its channel's 8 values over its windows in the
//     fp32 slot of its (block, window of the tile); reduce_slots_kernel sums
//     the slots in a fixed order. Two launches give the same bits.
#include "selective_scan_long.cuh"

namespace lcbi {

constexpr int kWinBwdThreads = 128;                 // threads of a block at most
constexpr int kWinGroup = 128;                      // channels of a group at most
constexpr int kWinStretch = 8;                      // tokens between checkpoints
constexpr int kWinStretches = kScanSeg / kWinStretch;

// Geometry of a call: the channels split into `groups` groups of `dg`
// channels, each taking `dgp` threads (dg rounded up to whole warps); a tile
// is `wpb` windows, a block wpb * dgp threads.
struct WinBwd {
  int BW, L, D, groups, dg, dgp, wpb, tiles;
};

inline bool win_bwd_geom(int BW, int L, int D, int N, WinBwd* g) {
  if (BW < 1 || L < 1 || L > kScanSeg || D < 1 || N != kScanN || N * D > 8192) return false;
  if ((long long)BW * L * D >= (1LL << 31)) return false;
  g->BW = BW;
  g->L = L;
  g->D = D;
  g->groups = (D + kWinGroup - 1) / kWinGroup;
  g->dg = (D + g->groups - 1) / g->groups;
  g->dgp = (g->dg + 31) / 32 * 32;
  g->wpb = kWinBwdThreads / g->dgp;
  g->tiles = (BW + g->wpb - 1) / g->wpb;
  return true;
}

// Shared memory of a block, in floats: B and C of the tile, the tile's dB |
// dC sums (wpb x kScanSeg x 16), the warps' partials of one stretch, the
// checkpoints (kWinStretches x N x T) and one stretch's states (kWinStretch x
// N x T), T = wpb * dgp threads.
inline size_t win_bwd_smem_floats(const WinBwd& g) {
  const int T = g.wpb * g.dgp;
  return (size_t)g.wpb * kScanSeg * kScanN * 4 + (T / 32) * kWinStretch * 2 * kScanN +
         (size_t)(kWinStretches + kWinStretch) * kScanN * T;
}

template <bool SOFTPLUS>
__global__ void __launch_bounds__(kWinBwdThreads)
window_scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                       const float* __restrict__ at, const float* __restrict__ Bm,
                       const float* __restrict__ Cm, const float* __restrict__ gy,
                       float* __restrict__ du, float* __restrict__ dd, float* __restrict__ dB,
                       float* __restrict__ dC, float* __restrict__ slots, int tiles_per_block,
                       WinBwd g) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = g.D, L = g.L, LN = g.L * kScanN;
  const int wl = tid / g.dgp, c = tid % g.dgp, wpw = g.dgp / 32;
  constexpr int kPart = kWinStretch * 2 * kScanN;     // one warp's partials of a stretch
  float* sB = smem;                                    // (wpb, L, N)
  float* sC = sB + g.wpb * kScanSeg * kScanN;          // (wpb, L, N)
  float* acc = sC + g.wpb * kScanSeg * kScanN;         // (wpb, kScanSeg, 16): dB | dC
  float* part = acc + g.wpb * kScanSeg * 2 * kScanN;   // (warps, kWinStretch, 16)
  float* ck = part + (T / 32) * kPart;                 // (kWinStretches, N, T)
  float* hs = ck + kWinStretches * kScanN * T;         // (kWinStretch, N, T)
  float* slot = slots + ((size_t)blockIdx.x * g.wpb + wl) * kScanN * D;
  const int nst = (L + kWinStretch - 1) / kWinStretch;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(g.tiles, t0 + tiles_per_block);
  const float* sb = sB + wl * LN;
  const float* sc = sC + wl * LN;
  for (int tile = t0; tile < t1; ++tile) {
    const int w0 = tile * g.wpb, nw = min(g.wpb, g.BW - w0);
    __syncthreads();  // the previous tile's readers of sB, sC and acc are done
    for (int i = tid; i < nw * LN; i += T) {
      sB[i] = Bm[(size_t)w0 * LN + i];
      sC[i] = Cm[(size_t)w0 * LN + i];
    }
    __syncthreads();
    for (int grp = 0; grp < g.groups; ++grp) {
      const int d = grp * g.dg + c;
      const bool chan = c < g.dg && d < D;
      const bool on = chan && wl < nw;
      float af[kScanN], a2[kScanN], h[kScanN], dh[kScanN], dA[kScanN];
#pragma unroll
      for (int n = 0; n < kScanN; ++n) {
        af[n] = chan ? at[n * D + d] : 0.f;
        a2[n] = af[n] * kLog2e;
        h[n] = 0.f;
        dh[n] = 0.f;
        dA[n] = chan && tile > t0 ? slot[n * D + d] : 0.f;
      }
      const size_t base = on ? (size_t)(w0 + wl) * L * D + d : 0;
      // pass 1: forward, keeping the state at the start of each stretch
      for (int k = 0; k < nst; ++k) {
#pragma unroll
        for (int n = 0; n < kScanN; ++n) ck[(k * kScanN + n) * T + tid] = h[n];
        const int jn = min(kWinStretch, L - k * kWinStretch);
        for (int j = 0; j < jn && on; ++j) {
          const size_t o = base + (size_t)(k * kWinStretch + j) * D;
          const float raw = delta[o];
          const float dt = SOFTPLUS ? scan_softplus(raw) : raw;
          scan_step(h, a2, dt, dt * u[o], sb + (k * kWinStretch + j) * kScanN);
        }
      }
      // pass 2: stretch by stretch from the end, recompute, then walk back
      for (int k = nst - 1; k >= 0; --k) {
        const int jn = min(kWinStretch, L - k * kWinStretch);
#pragma unroll
        for (int n = 0; n < kScanN; ++n) h[n] = ck[(k * kScanN + n) * T + tid];
        for (int j = 0; j < jn && on; ++j) {
          const size_t o = base + (size_t)(k * kWinStretch + j) * D;
          const float raw = delta[o];
          const float dt = SOFTPLUS ? scan_softplus(raw) : raw;
          scan_step(h, a2, dt, dt * u[o], sb + (k * kWinStretch + j) * kScanN);
#pragma unroll
          for (int n = 0; n < kScanN; ++n) hs[(j * kScanN + n) * T + tid] = h[n];
        }
        for (int j = kWinStretch - 1; j >= 0; --j) {
          float v[2 * kScanN];  // this channel's share of dB_t | dC_t
#pragma unroll
          for (int i = 0; i < 2 * kScanN; ++i) v[i] = 0.f;
          if (on && j < jn) {
            const int t = k * kWinStretch + j;
            const size_t o = base + (size_t)t * D;
            const float raw = delta[o], ut = u[o], gt = gy[o];
            const float dt = SOFTPLUS ? scan_softplus(raw) : raw;
            const float* hprev = j > 0 ? hs + (j - 1) * kScanN * T : ck + k * kScanN * T;
            float sdb = 0.f, sda = 0.f;
#pragma unroll
            for (int n = 0; n < kScanN; ++n) {
              const float a = exp2f(dt * a2[n]);
              const float dhn = fmaf(sc[t * kScanN + n], gt, dh[n]);
              const float daa = dhn * hprev[n * T + tid] * a;
              dA[n] = fmaf(daa, dt, dA[n]);
              sdb = fmaf(dhn, sb[t * kScanN + n], sdb);
              sda = fmaf(daa, af[n], sda);
              v[n] = dhn * (dt * ut);
              v[kScanN + n] = hs[(j * kScanN + n) * T + tid] * gt;
              dh[n] = a * dhn;
            }
            du[o] = dt * sdb;
            const float ddt = fmaf(ut, sdb, sda);
            dd[o] = SOFTPLUS ? ddt * scan_sigmoid(raw) : ddt;
          }
          warp_sum16(v, lane);
          if ((lane & 1) == 0) part[warp * kPart + j * 2 * kScanN + lane / 2] = v[0];
        }
        __syncthreads();
        // each window's warps' partials of this stretch, in warp order, into
        // the window's sums
        for (int e = tid; e < g.wpb * kPart; e += T) {
          const int we = e / kPart, r = e % kPart;
          float s = 0.f;
          for (int i = 0; i < wpw; ++i) s += part[(we * wpw + i) * kPart + r];
          float* a = acc + (we * kScanSeg + k * kWinStretch) * 2 * kScanN + r;
          *a = grp == 0 ? s : *a + s;
        }
        __syncthreads();
      }
      if (chan) {
#pragma unroll
        for (int n = 0; n < kScanN; ++n) slot[n * D + d] = dA[n];
      }
    }
    __syncthreads();
    for (int i = tid; i < nw * LN; i += T) {
      const int we = i / LN, r = i % LN, t = r / kScanN, n = r % kScanN;
      const float* a = acc + (we * kScanSeg + t) * 2 * kScanN;
      dB[(size_t)w0 * LN + i] = a[n];
      dC[(size_t)w0 * LN + i] = a[kScanN + n];
    }
  }
}

// The launch of a call: its geometry, shared memory, blocks and tiles per
// block (every block walks the same number of tiles, the last one fewer, and
// no block waits for a second wave). Returns a CUDA error code.
inline int win_bwd_launch(int BW, int L, int D, int N, int softplus, WinBwd* g, size_t* smem,
                          int* blocks, int* per) {
  if (!win_bwd_geom(BW, L, D, N, g)) return (int)cudaErrorInvalidValue;
  *smem = win_bwd_smem_floats(*g) * sizeof(float);
  const int threads = g->wpb * g->dgp;
  auto kernel = softplus ? window_scan_bwd_kernel<true> : window_scan_bwd_kernel<false>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)*smem)))
    return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, *smem)))
    return (int)err;
  long long b = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (b > g->tiles) b = g->tiles;
  *per = (int)((g->tiles + b - 1) / b);
  *blocks = (g->tiles + *per - 1) / *per;
  return 0;
}

}  // namespace lcbi

// The number of dA slots (rows of N * D floats) that lcbi_window_scan_bwd
// needs for this call, or -1 for a shape it does not take.
extern "C" long long lcbi_window_scan_bwd_slots(int BW, int L, int D, int N, int softplus) {
  lcbi::WinBwd g;
  size_t smem;
  int blocks, per;
  if (lcbi::win_bwd_launch(BW, L, D, N, softplus, &g, &smem, &blocks, &per)) return -1;
  return (long long)blocks * g.wpb;
}

// u, delta, g, du, dd: (BW, L, D); at, dat: (N, D); B, C, dB, dC: (BW, L, N);
// slots: n_slots x (N D) scratch, n_slots from lcbi_window_scan_bwd_slots. All
// fp32, contiguous; N must be 8, L at most 64 and N D at most 8192. dat
// receives the sum over every token of every window of the dA terms (the
// gradient of at). Returns cudaGetLastError() of the first launch that fails
// (or cudaErrorInvalidValue for a shape or slot count it does not take).
extern "C" int lcbi_window_scan_bwd(const void* u, const void* delta, const void* at,
                                    const void* B, const void* C, const void* g, void* du,
                                    void* dd, void* dB, void* dC, void* slots, void* dat, int BW,
                                    int L, int D, int N, int softplus, int n_slots,
                                    void* stream) {
  (void)cudaGetLastError();
  lcbi::WinBwd geom;
  size_t smem;
  int blocks, per;
  int err = lcbi::win_bwd_launch(BW, L, D, N, softplus, &geom, &smem, &blocks, &per);
  if (err) return err;
  if ((long long)blocks * geom.wpb != n_slots) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sl = static_cast<float*>(slots);
  auto kernel = softplus ? lcbi::window_scan_bwd_kernel<true>
                         : lcbi::window_scan_bwd_kernel<false>;
  kernel<<<(unsigned)blocks, geom.wpb * geom.dgp, smem, s>>>(
      static_cast<const float*>(u), static_cast<const float*>(delta),
      static_cast<const float*>(at), static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<const float*>(g), static_cast<float*>(du), static_cast<float*>(dd),
      static_cast<float*>(dB), static_cast<float*>(dC), sl, per, geom);
  if ((err = (int)cudaGetLastError())) return err;
  return lcbi::launch_reduce(sl, n_slots, (size_t)lcbi::kScanN * D, static_cast<float*>(dat), s);
}
