// Long-sequence selective scan (K7), the backward pass: for every segment row,
// given its true initial carry h0 and the true cotangent dht of its final
// state, the gradients of y for the cotangent g (see selective_scan_long.cuh):
//     dh_t   = dh_t' + C_t g_t       (dh_t' = a_{t+1} dh_{t+1}, dht at the end)
//     du_t   = d_t sum_n dh_t B_t           dC_t = sum_d h_t g_t
//     dd_t   = (u_t sum_n dh_t B_t + sum_n dh_t h_{t-1} a_t A) sigmoid(delta_t)
//     dB_t   = sum_d dh_t d_t u_t           dA  += sum_t dh_t h_{t-1} a_t d_t
// with a_t = exp(d_t A). dB and dC sum over the channels, dA over every token
// of every row.
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/selective_scan_long.py
// _make_bwd_kernel (launched by _bwd_call), which keeps a segment's whole h
// history in VMEM and sums dB, dC over its sequential channel-chunk grid axis
// and dA over its row blocks.
//
// What bounds it on the H100: device memory, u, delta, g read and du, dd
// written once (20 bytes per (token, channel)), against some 20 fp32
// operations per (token, channel, state) with the h recompute (chip_smoke.py
// kernel_bounds). The design, simply:
//   * One block per row at a time (a persistent grid: block k walks a
//     contiguous range of rows), one thread per channel of a group of at most
//     128 channels, the groups of a row in turn.
//   * The h history of a row is 64 tokens x 8 states per channel, too much
//     for registers or (at 128 channels, 256 KB) shared memory. Pass 1 runs
//     the recurrence forward and keeps h at the start of every stretch of 8
//     tokens (shared memory); the reverse pass recomputes each stretch's 8
//     states from its checkpoint into shared memory and walks it backwards.
//   * dB and dC at each token sum over the channels without atomics: a
//     transposing butterfly leaves the warp's sum of each of the 16 values at
//     two lanes (16 shuffles), the warps' partials are summed in order after
//     each stretch, and the groups add into the row's sums in order.
//   * dA: each thread sums its channel's 8 values over its block's rows in
//     registers and its block's fp32 slot; reduce_slots_kernel sums the slots
//     in a fixed order. Two launches give the same bits.
#include "selective_scan_long.cuh"

namespace lcbi {

constexpr int kStretch = 8;                        // tokens between checkpoints
constexpr int kStretches = kScanSeg / kStretch;

// Shared memory of a block of T threads, in floats: B and C of the row, the
// row's dB | dC sums (kScanSeg x 16), the warps' partials of one stretch, the
// checkpoints (kStretches x N x T) and one stretch's states (kStretch x N x T).
__host__ __device__ inline size_t bwd_smem_floats(int T) {
  return 2 * kScanSeg * kScanN + kScanSeg * 2 * kScanN + (T / 32) * kStretch * 2 * kScanN +
         (size_t)(kStretches + kStretch) * kScanN * T;
}

// h <- exp(dt A) h + dt u B over the N states (a2 = A log2 e).
__device__ __forceinline__ void scan_step(float* h, const float* a2, float dt, float du,
                                          const float* Bt) {
#pragma unroll
  for (int n = 0; n < kScanN; ++n) h[n] = fmaf(exp2f(dt * a2[n]), h[n], du * Bt[n]);
}

// Sum of each of the 16 values v over the warp's 32 lanes: after it, v[0] of
// lanes 2k and 2k + 1 holds the sum of value k. Each level swaps half of the
// values still held with the partner lane, in a fixed order.
__device__ __forceinline__ void warp_sum16(float* v, int lane) {
#pragma unroll
  for (int half = 8, bit = 16; half >= 1; half /= 2, bit /= 2) {
    const bool up = lane & bit;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
    }
  }
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
}

__global__ void __launch_bounds__(kScanMaxGroup)
long_scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                     const float* __restrict__ at, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, const float* __restrict__ gy,
                     const float* __restrict__ h0, const float* __restrict__ dht,
                     float* __restrict__ du, float* __restrict__ dd, float* __restrict__ dB,
                     float* __restrict__ dC, float* __restrict__ slots, int rows_per_block,
                     ScanGeom g) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = g.D;
  float* sB = smem;
  float* sC = sB + kScanSeg * kScanN;
  float* acc = sC + kScanSeg * kScanN;                  // (kScanSeg, 16): dB | dC
  float* part = acc + kScanSeg * 2 * kScanN;            // (warps, kStretch, 16)
  float* ck = part + (T / 32) * kStretch * 2 * kScanN;  // (kStretches, N, T)
  float* hs = ck + kStretches * kScanN * T;             // (kStretch, N, T)
  float* slot = slots + (size_t)blockIdx.x * kScanN * D;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(g.rows, r0 + rows_per_block);
  for (int row = r0; row < r1; ++row) {
    const ScanRow r = scan_row(g, row);
    __syncthreads();  // the previous row's readers of sB, sC and acc are done
    stage_row(sB, Bm, r);
    stage_row(sC, Cm, r);
    __syncthreads();
    const int nst = (r.len + kStretch - 1) / kStretch;
    for (int grp = 0; grp < g.groups; ++grp) {
      const int d = grp * T + tid;
      const bool on = d < D;
      const size_t co = (size_t)row * kScanN * D + d;  // carry (row, 0, d)
      float af[kScanN], a2[kScanN], h[kScanN], dh[kScanN], dA[kScanN];
#pragma unroll
      for (int n = 0; n < kScanN; ++n) {
        af[n] = on ? at[n * D + d] : 0.f;
        a2[n] = af[n] * kLog2e;
        h[n] = on ? h0[co + (size_t)n * D] : 0.f;
        dh[n] = on ? dht[co + (size_t)n * D] : 0.f;
        dA[n] = on && row > r0 ? slot[n * D + d] : 0.f;
      }
      const size_t base = r.tok0 * D + (on ? d : 0);
      // pass 1: forward, keeping the state at the start of each stretch
      for (int k = 0; k < nst; ++k) {
#pragma unroll
        for (int n = 0; n < kScanN; ++n) ck[(k * kScanN + n) * T + tid] = h[n];
        const int jn = min(kStretch, r.len - k * kStretch);
        for (int j = 0; j < jn && on; ++j) {
          const size_t o = base + (size_t)(k * kStretch + j) * D;
          const float dt = scan_softplus(delta[o]);
          scan_step(h, a2, dt, dt * u[o], sB + (k * kStretch + j) * kScanN);
        }
      }
      // pass 2: stretch by stretch from the end, recompute, then walk back
      for (int k = nst - 1; k >= 0; --k) {
        const int jn = min(kStretch, r.len - k * kStretch);
#pragma unroll
        for (int n = 0; n < kScanN; ++n) h[n] = ck[(k * kScanN + n) * T + tid];
        for (int j = 0; j < jn && on; ++j) {
          const size_t o = base + (size_t)(k * kStretch + j) * D;
          const float dt = scan_softplus(delta[o]);
          scan_step(h, a2, dt, dt * u[o], sB + (k * kStretch + j) * kScanN);
#pragma unroll
          for (int n = 0; n < kScanN; ++n) hs[(j * kScanN + n) * T + tid] = h[n];
        }
        for (int j = kStretch - 1; j >= 0; --j) {
          float v[2 * kScanN];  // this channel's share of dB_t | dC_t
#pragma unroll
          for (int i = 0; i < 2 * kScanN; ++i) v[i] = 0.f;
          if (on && j < jn) {
            const int t = k * kStretch + j;
            const size_t o = base + (size_t)t * D;
            const float raw = delta[o], dt = scan_softplus(raw), ut = u[o], gt = gy[o];
            const float* hprev = j > 0 ? hs + (j - 1) * kScanN * T : ck + k * kScanN * T;
            float sdb = 0.f, sda = 0.f;
#pragma unroll
            for (int n = 0; n < kScanN; ++n) {
              const float a = exp2f(dt * a2[n]);
              const float dhn = fmaf(sC[t * kScanN + n], gt, dh[n]);
              const float daa = dhn * hprev[n * T + tid] * a;
              dA[n] = fmaf(daa, dt, dA[n]);
              sdb = fmaf(dhn, sB[t * kScanN + n], sdb);
              sda = fmaf(daa, af[n], sda);
              v[n] = dhn * (dt * ut);
              v[kScanN + n] = hs[(j * kScanN + n) * T + tid] * gt;
              dh[n] = a * dhn;
            }
            du[o] = dt * sdb;
            dd[o] = fmaf(ut, sdb, sda) * scan_sigmoid(raw);
          }
          warp_sum16(v, lane);
          if ((lane & 1) == 0) part[(warp * kStretch + j) * 2 * kScanN + lane / 2] = v[0];
        }
        __syncthreads();
        // the warps' partials of this stretch, in warp order, into the row's sums
        for (int e = tid; e < kStretch * 2 * kScanN; e += T) {
          float s = 0.f;
          for (int w = 0; w < T / 32; ++w) s += part[w * kStretch * 2 * kScanN + e];
          float* a = acc + k * kStretch * 2 * kScanN + e;
          *a = grp == 0 ? s : *a + s;
        }
        __syncthreads();
      }
      if (on) {
#pragma unroll
        for (int n = 0; n < kScanN; ++n) slot[n * D + d] = dA[n];
      }
    }
    __syncthreads();
    for (int i = tid; i < r.len * kScanN; i += T) {
      const int t = i / kScanN, n = i % kScanN;
      dB[r.tok0 * kScanN + i] = acc[t * 2 * kScanN + n];
      dC[r.tok0 * kScanN + i] = acc[t * 2 * kScanN + kScanN + n];
    }
  }
}

}  // namespace lcbi

// u, delta, g, du, dd: (b, L, D); at: (N, D); B, C, dB, dC: (b, L, N); h0, dht:
// (b * ceil(L / 64), N, D); slots: max_slots x (N D) scratch; dat: (N, D). All
// fp32, contiguous; N must be 8. dat receives sum over every token of the dA
// terms (the gradient of at). Returns cudaGetLastError() of the first launch
// that fails (or cudaErrorInvalidValue for a shape it does not take).
extern "C" int lcbi_long_scan_bwd(const void* u, const void* delta, const void* at, const void* B,
                                  const void* C, const void* g, const void* h0, const void* dht,
                                  void* du, void* dd, void* dB, void* dC, void* slots, void* dat,
                                  int b, int L, int D, int N, int max_slots, void* stream) {
  (void)cudaGetLastError();
  lcbi::ScanGeom geom;
  if (!lcbi::scan_geom(b, L, D, N, &geom) || max_slots < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = lcbi::bwd_smem_floats(geom.threads) * sizeof(float);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(lcbi::long_scan_bwd_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lcbi::long_scan_bwd_kernel,
                                                           geom.threads, smem)))
    return (int)err;
  // every block walks the same number of rows (the last one fewer), and no
  // block waits for a second wave
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > max_slots) blocks = max_slots;
  if (blocks > geom.rows) blocks = geom.rows;
  const int per = (int)((geom.rows + blocks - 1) / blocks);
  blocks = (geom.rows + per - 1) / per;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sl = static_cast<float*>(slots);
  lcbi::long_scan_bwd_kernel<<<(unsigned)blocks, geom.threads, smem, s>>>(
      static_cast<const float*>(u), static_cast<const float*>(delta),
      static_cast<const float*>(at), static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<const float*>(g), static_cast<const float*>(h0),
      static_cast<const float*>(dht), static_cast<float*>(du), static_cast<float*>(dd),
      static_cast<float*>(dB), static_cast<float*>(dC), sl, per, geom);
  if ((err = cudaGetLastError())) return (int)err;
  return lcbi::launch_reduce(sl, (int)blocks, (size_t)lcbi::kScanN * D, static_cast<float*>(dat),
                             s);
}
