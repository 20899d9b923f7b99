// Swin window attention K8, backward: from dout, the gradients of the
// forward of window_attention.cu except the weights' (window_attention_wgrad.cu
// sums those from this kernel's streams):
//     dx (BW, V, C) in T;
//     dqkv (BW V, 3C) in T, the head-major [dq | dk | dv] rows;
//     o (BW V, C) in T, every head's softmax(s_h) v_h;
//     dbqkv (3C), dbout (C) and drel (H, V, V) in fp32, summed over windows.
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/window_attention.py
// _bwd_kernel (pallas_call in _call_bwd). It recomputes the softmax from the
// inputs (no saved statistics) and rounds where that kernel rounds: q (times
// scale log2(e)), the unscaled q, k, v, p, o, do and ds to T before their
// products, dqkv to T, which is also the operand of dWqkv = x^T dqkv and of
// dx = dqkv Wqkv^T (and o of dWout = o^T dout); dbqkv sums the fp32 dqkv,
// drel the fp32 ds (natural units). The TPU kernel sums the weight and bias
// gradients into one VMEM block over its sequential grid; here the (C, 3C)
// and (C, C) weight gradients leave as the streams dqkv and o for the split-K
// kernel, and the small gradients go to per-block (or per-warp) fp32 slots
// summed in a fixed order: no atomics, two launches give the same bits.
//
// Every path runs as passes over streams: the q | k | v projection
// recomputed into device memory (q scale log2(e), k, v and the unscaled q,
// all in T: qkvu, 4C wide) and do = dout Wout^T (T), both with the bias,
// scale and duplicate in the projection's epilogue (in bf16
// window_attention_mma.cuh proj_rows_kernel, on mma_gemm.cuh's row-tiled
// product); the attention core; dx = dqkv Wqkv^T by the same projection
// kernel; and the fixed-order sums of the slots. What bounds the whole call
// on the H100 is bytes at the models' widths (14 T C of streams at T = BW V
// tokens against 14 T C^2 + 12 T V C operations); the streams add 10 T C
// more bytes, written and read once.
//
// The whole-window path (bf16; V = 16, 32, 48 or 64 at D = 16, 32 or 64 and
// C % 16 == 0, the ptx_attn windows) runs the attention core in one kernel,
// wattn_whole_bwd_kernel, in which one warp owns one (head, window) item, on
// the code it shares with the forward's core (window_attention_whole.cuh):
//   - Its five (V, D) tiles (q scaled, q, k, v, do) arrive by cp.async 16-byte
//     copies into the warp's own shared memory, the next item's while this
//     one computes (two buffers, at V = 16; one above).
//   - Per 16 query rows: s = q k^T on mma.sync.m16n8k16 fragments, the bias
//     rel[h] log2(e) and the region-id mask added on the fragments, the
//     base-2 softmax over the V keys held in the warp's registers (a row's
//     max and sum by two shuffles), as the forward computes p from the same
//     streams; then dp = do v^T, delta = sum p dp, ds = p (dp - delta), all
//     fp32 in registers; p and ds pass from the accumulator fragments to A
//     fragments (rounded to bf16 once) for o = p v and dq = ds k, which are
//     stored from their fragments.
//   - The same rounded p and ds go to the warp's shared memory (V x V bf16
//     each), from which dv = p^T do and dk = ds^T q (unscaled) read them
//     transposed through ldmatrix.trans: the transposed scores are not
//     recomputed, and both products take exactly the p and ds of o and dq.
//   - drel accumulates the fp32 ds in the warp's shared memory (each element
//     owned by one lane), and the bias gradients' column sums in registers,
//     over the warp's items of one head. Items are ordered head, window, and
//     a warp walks a contiguous range of them, so where its range leaves a
//     head it writes one segment [drel (V, V) | dbq | dbk | dbv (D each)];
//     wattn_whole_reduce_kernel sums each head's segments in warp order.
//     dbout, the column sums of dout, comes from col_sums_kernel's per-block
//     slots.
//   - No __syncthreads: a warp shares nothing with the other warps of its
//     block. Blocks of up to 4 warps, as many as fit an SM; at V = 16, D = 32
//     (ptx_attn) a warp takes 15.6 KB of shared memory and 72 registers,
//     so 3 blocks (12 warps) an SM, each warp with its next item's copies
//     in flight.
//
// fp32 at those shapes, and every other shape, take the general path:
// windows of other sizes up to 512 tokens and other head dims (and fp32
// everywhere). After the projections, a row pass writes o, dq and each row's
// softmax statistics; a key pass recomputes p and ds from those statistics
// and sums dk, dv over every query row of a window and drel over windows. In
// bf16 up to D = 128 the passes are the kernels of window_attention_mma.cuh,
// designed for Hopper (the key pass keeps drel's columns of a 64-key tile for
// all query rows in shared memory over its windows and reads each window's q
// and do once per key tile of 64); in fp32, and in bf16 above D = 128, the
// shared-memory kernels below (full score rows, a key-tile kernel of 32 keys
// with drel's columns of its tile, D walked in chunks). drel, H V^2 floats,
// does not fit a block's shared memory whole at V = 512 (3 MB at 3 heads),
// hence the key tiles.
#include <algorithm>
#include <type_traits>

#include "window_attention_whole.cuh"

namespace lcbi {

constexpr int kKeyTile = 32;   // keys of a key-tile block
constexpr int kQRows = 64;     // query rows per step of a key-tile block
constexpr int kLdSt = kQRows + 4;
constexpr int kLdPt = kQRows + 8;
constexpr int kLdDr = kKeyTile + 4;

struct KvLayout {
  size_t off_k, off_v, off_q, off_qu, off_do, off_s, off_dp, off_p, off_ds, off_dk, off_dv, off_st,
      bytes;
};

template <int KD>

// drel's columns of the key tile for every query row (V x 32 fp32) first,
// then the k, v tile, the q, unscaled q and do rows of a step, the
// transposed scores and dp (fp32) and p, ds (T) of a step, the fp32 dk, dv
// sums and the step's row statistics.
__host__ __device__ inline KvLayout kv_layout(int V, int elem) {
  constexpr int kLdT = HeadDims<KD>::kLdT, kLdG = HeadDims<KD>::kLdG;
  KvLayout L;
  const size_t kv = align128((size_t)kKeyTile * kLdT * elem);
  const size_t q = align128((size_t)kQRows * kLdT * elem);
  const size_t st = align128((size_t)kKeyTile * kLdSt * 4);
  const size_t pt = align128((size_t)kKeyTile * kLdPt * elem);
  const size_t acc = align128((size_t)kKeyTile * kLdG * 4);
  L.off_k = align128((size_t)round_up16(V) * kLdDr * 4);
  L.off_v = L.off_k + kv;
  L.off_q = L.off_v + kv;
  L.off_qu = L.off_q + q;
  L.off_do = L.off_qu + q;
  L.off_s = L.off_do + q;
  L.off_dp = L.off_s + st;
  L.off_p = L.off_dp + st;
  L.off_ds = L.off_p + pt;
  L.off_dk = L.off_ds + pt;
  L.off_dv = L.off_dk + acc;
  L.off_st = L.off_dv + acc;
  L.bytes = L.off_st + align128((size_t)3 * kQRows * 4);
  return L;
}

// Block (kt + nkt oc, h, g): keys [kt 32, kt 32 + 32) of head h in the
// windows [BW g / G, BW (g + 1) / G), output columns [oc KD, oc KD + KD) of
// the head's D. For each window it walks the query rows in steps of kQRows:
// s^T = k q^T and dp^T = v do^T summed over the chunks of D, p^T =
// exp2(s^T + rel^T log2(e) + mask - max) / sum from the row kernel's
// statistics, ds^T = p^T (dp^T - delta); dv += p^T do, dk += ds^T qu
// (unscaled q) on its output columns, and (oc == 0) drel's tile += ds. It
// writes dk scale and dv in T to dqkv (columns C + h D and 2C + h D), the
// column sums of dk scale and dv over its keys and windows to ksums[g nkt +
// kt] ([dbk | dbv], 2C floats, the head's columns), and (oc == 0) the drel
// tile to rows [0, V) and columns of its keys in kslots[g] (H V V floats).
// qkvu: q scale log2(e) | k | v | q per token row (ld 4C); dO: do per head
// (ld C). Head h's D columns sit at h D of each C-wide block; tiles are KD
// wide. This is the fp32 path (and bf16 above D = 128); the bf16 path up to
// D = 128 is window_attention_mma.cuh's.
template <typename T, int KD>
__global__ void __launch_bounds__(kThreads)
window_attention_keys_kernel(const T* __restrict__ qkvu, const T* __restrict__ dO,
                             const float* __restrict__ rel, const int* __restrict__ rid,
                             const float* __restrict__ stats, T* __restrict__ dqkv,
                             float* __restrict__ kslots, float* __restrict__ ksums, int BW,
                             int V, int C, int H, int nW, float scale, float mask2) {
  constexpr int kLdT = HeadDims<KD>::kLdT, kLdG = HeadDims<KD>::kLdG;
  extern __shared__ __align__(128) unsigned char smem[];
  const KvLayout L = kv_layout<KD>(V, sizeof(T));
  float* Dr = reinterpret_cast<float*>(smem);
  T* Kt = reinterpret_cast<T*>(smem + L.off_k);
  T* Vt = reinterpret_cast<T*>(smem + L.off_v);
  T* Q2 = reinterpret_cast<T*>(smem + L.off_q);
  T* QU = reinterpret_cast<T*>(smem + L.off_qu);
  T* DOt = reinterpret_cast<T*>(smem + L.off_do);
  float* St = reinterpret_cast<float*>(smem + L.off_s);
  float* DPt = reinterpret_cast<float*>(smem + L.off_dp);
  T* Pt = reinterpret_cast<T*>(smem + L.off_p);
  T* DSt = reinterpret_cast<T*>(smem + L.off_ds);
  float* DKA = reinterpret_cast<float*>(smem + L.off_dk);
  float* DVA = reinterpret_cast<float*>(smem + L.off_dv);
  float* Mst = reinterpret_cast<float*>(smem + L.off_st);
  float* Lst = Mst + kQRows;
  float* Dst = Lst + kQRows;

  const int D = C / H, nch = (D + KD - 1) / KD;
  const int nkt = (V + kKeyTile - 1) / kKeyTile;
  const int kt = blockIdx.x % nkt, oc = blockIdx.x / nkt, h = blockIdx.y, g = blockIdx.z;
  const int G = gridDim.z;
  const int oc0 = h * D + oc * KD, ow = min(KD, D - oc * KD);   // this block's output columns
  const int j0 = kt * kKeyTile, keys = min(kKeyTile, V - j0);
  const long long w_begin = (long long)BW * g / G, w_end = (long long)BW * (g + 1) / G;
  const size_t ld = (size_t)4 * C;
  const size_t plane = (size_t)BW * H * V;
  const int nq = (V + kQRows - 1) / kQRows;
  for (int e = threadIdx.x; e < V * kLdDr; e += kThreads) Dr[e] = 0.f;
  float colsum = 0.f;   // thread t < 2 ow: column t of [dk | dv] over the block's keys

  for (long long w = w_begin; w < w_end; ++w) {
    const size_t row0 = (size_t)w * V;
    const T* base = qkvu + row0 * ld;
    const int* rr = rid == nullptr ? nullptr : rid + (size_t)(w % nW) * V;
    const size_t srow = ((size_t)w * H + h) * V;
    for (int qs = 0; qs < nq; ++qs) {
      const int i0 = qs * kQRows, rows = min(kQRows, V - i0);
      for (int r = threadIdx.x; r < kQRows; r += kThreads) {
        Mst[r] = r < rows ? stats[srow + i0 + r] : 0.f;
        Lst[r] = r < rows ? stats[plane + srow + i0 + r] : 1.f;
        Dst[r] = r < rows ? stats[2 * plane + srow + i0 + r] : 0.f;
      }
      // s^T = k q^T and dp^T = v do^T, summed over the chunks of D
      for (int c = 0; c < nch; ++c) {
        const int dc = h * D + c * KD, dw = min(KD, D - c * KD);
        load_head_rows<KD>(Kt, base + (size_t)j0 * ld, ld, C + dc, dw, keys, kKeyTile);
        load_head_rows<KD>(Vt, base + (size_t)j0 * ld, ld, 2 * C + dc, dw, keys, kKeyTile);
        load_head_rows<KD>(Q2, base + (size_t)i0 * ld, ld, dc, dw, rows, kQRows);
        load_head_rows<KD>(DOt, dO + (row0 + i0) * C, C, dc, dw, rows, kQRows);
        __syncthreads();
        gemm<false, true>(St, kLdSt, Kt, kLdT, Q2, kLdT, kKeyTile, kQRows, KD, c > 0);
        gemm<false, true>(DPt, kLdSt, Vt, kLdT, DOt, kLdT, kKeyTile, kQRows, KD, c > 0);
        __syncthreads();
      }
      for (int e = threadIdx.x; e < kKeyTile * kQRows; e += kThreads) {
        const int jj = e % kKeyTile, r = e / kKeyTile;
        const int i = i0 + r, j = j0 + jj;
        float p = 0.f, ds = 0.f;
        if (jj < keys && r < rows) {
          float s = St[jj * kLdSt + r] + rel[((size_t)h * V + i) * V + j] * kLog2e;
          if (rr != nullptr) s += rr[i] != rr[j] ? mask2 : 0.f;
          p = exp2f(s - Mst[r]) / Lst[r];
          ds = p * (DPt[jj * kLdSt + r] - Dst[r]);
          if (oc == 0) Dr[i * kLdDr + jj] += ds;
        }
        Pt[jj * kLdPt + r] = from_f32<T>(p);
        DSt[jj * kLdPt + r] = from_f32<T>(ds);
      }
      load_head_rows<KD>(QU, base + (size_t)i0 * ld, ld, 3 * C + oc0, ow, rows, kQRows);
      load_head_rows<KD>(DOt, dO + (row0 + i0) * C, C, oc0, ow, rows, kQRows);
      __syncthreads();
      gemm<false, false>(DVA, kLdG, Pt, kLdPt, DOt, kLdT, kKeyTile, KD, kQRows, qs > 0);
      gemm<false, false>(DKA, kLdG, DSt, kLdPt, QU, kLdT, kKeyTile, KD, kQRows, qs > 0);
      __syncthreads();
    }
    for (int e = threadIdx.x; e < keys * ow; e += kThreads) {
      const int jj = e / ow, d = e % ow;
      T* drow = dqkv + (row0 + j0 + jj) * 3 * C + oc0 + d;
      drow[C] = from_f32<T>(DKA[jj * kLdG + d] * scale);
      drow[2 * C] = from_f32<T>(DVA[jj * kLdG + d]);
    }
    if (threadIdx.x < 2 * ow) {
      const int d = threadIdx.x % ow;
      const float* A = threadIdx.x < ow ? DKA : DVA;
      const float mul = threadIdx.x < ow ? scale : 1.f;
      for (int jj = 0; jj < keys; ++jj) colsum += A[jj * kLdG + d] * mul;
    }
    __syncthreads();
  }
  if (oc == 0) {
    float* drel = kslots + (size_t)g * H * V * V + (size_t)h * V * V;
    for (int e = threadIdx.x; e < V * keys; e += kThreads) {
      const int i = e / keys, jj = e % keys;
      drel[(size_t)i * V + j0 + jj] = Dr[i * kLdDr + jj];
    }
  }
  if (threadIdx.x < 2 * ow) {
    const int part = threadIdx.x / ow, d = threadIdx.x % ow;
    ksums[((size_t)g * nkt + kt) * 2 * C + part * C + oc0 + d] = colsum;
  }
}

// Window ranges of the key-tile grid: enough that its nkt nch H blocks per
// range fill the card's resident blocks four times over, at most max_gw and
// BW. The kernel's shared memory must be set (cudaFuncSetAttribute) first.
template <typename T, int KD>
int key_ranges(int BW, int V, int C, int H, int max_gw) {
  const size_t bytes = kv_layout<KD>(V, sizeof(T)).bytes;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_attention_keys_kernel<T, KD>,
                                                    kThreads, bytes) != cudaSuccess)
    return 0;
  const int D = C / H;
  const long long per_range =
      (long long)((V + kKeyTile - 1) / kKeyTile) * ((D + KD - 1) / KD) * H;
  long long g = (4LL * sms * (per_sm > 0 ? per_sm : 1) + per_range - 1) / per_range;
  if (g < 1) g = 1;
  if (g > BW) g = BW;
  if (g > max_gw) g = max_gw;
  return (int)g;
}

// ---------------------------------------------------------------------------
// The whole-window path's attention core (bf16)
// ---------------------------------------------------------------------------

// V = 16 NQ tokens a window, head dim KD. Per warp: the tiles of its item(s)
// [q scaled | q | k | v | do] (V x (KD + 8) bf16 each), p and ds (V x (V +
// 8) bf16 each), the drel accumulator (V x (V + 8) fp32).
template <int NQ, int KD> struct WholeCfg {
  static constexpr int kV = 16 * NQ;
  static constexpr int kLd = KD + 8;
  static constexpr int kLdP = kV + 8;
  static constexpr int kLdR = kV + 8;   // float2 accesses of a fragment row: no bank conflicts
  static constexpr int kTile = kV * kLd;
  static constexpr int kStage = 5 * kTile;
  static constexpr int kBufs = NQ == 1 ? 2 : 1;   // the next item's copies in flight
  static constexpr size_t kOffP = (size_t)kBufs * kStage * 2;
  static constexpr size_t kOffR = kOffP + (size_t)2 * kV * kLdP * 2;
  static constexpr size_t kWarpBytes = (kOffR + (size_t)kV * kLdR * 4 + 127) / 128 * 128;
  static constexpr int kFit = (int)((200 * 1024) / kWarpBytes);
  static constexpr int kWarps = kFit < 1 ? 1 : kFit > 4 ? 4 : kFit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSeg = kV * kV + 3 * KD;   // a segment: drel (V, V) | dbq | dbk | dbv
};

// qkvu: q scale log2(e) | k | v | q per token row (ld 4C); dO: do per head
// (ld C); D = KD, C % 16 == 0. Warp gw of GW walks items [N gw / GW, N (gw +
// 1) / GW) of the N = H BW items (head h = it / BW, window w = it % BW).
// Writes o (ld C) and dq scale, dk scale, dv at columns h D, C + h D, 2C + h D
// of dqkv (ld 3C), and a segment gw + h of seg for each head of its range.
template <int NQ, int KD>
__global__ void __launch_bounds__(WholeCfg<NQ, KD>::kThreads)
wattn_whole_bwd_kernel(const bf16* __restrict__ qkvu, const bf16* __restrict__ dO,
                       const float* __restrict__ rel, const int* __restrict__ rid,
                       bf16* __restrict__ o, bf16* __restrict__ dqkv, float* __restrict__ seg,
                       int BW, int C, int H, int nW, int GW, float scale, float mask2) {
  using Cf = WholeCfg<NQ, KD>;
  constexpr int V = Cf::kV, kLd = Cf::kLd, kLdP = Cf::kLdP, kLdR = Cf::kLdR, kTile = Cf::kTile;
  constexpr int kNT = V / 8, kKT = V / 16, kDT = KD / 8, kKK = KD / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int gw = blockIdx.x * Cf::kWarps + warp;
  if (gw >= GW) return;
  unsigned char* mine = smem + (size_t)warp * Cf::kWarpBytes;
  bf16* bufs = reinterpret_cast<bf16*>(mine);
  bf16* Ps = reinterpret_cast<bf16*>(mine + Cf::kOffP);
  bf16* DSs = Ps + V * kLdP;
  float* dr = reinterpret_cast<float*>(mine + Cf::kOffR);
  const long long N = (long long)H * BW;
  const int it_begin = (int)(N * gw / GW), it_end = (int)(N * (gw + 1) / GW);
  const size_t ld = (size_t)4 * C;

  // item it's five tiles into buffer b: q scale log2(e), q, k, v, do
  auto prefetch = [&](int it, int b) {
    const int h = it / BW, w = it % BW;
    bf16* S = bufs + b * Cf::kStage;
    const bf16* base = qkvu + (size_t)w * V * ld + h * KD;
    whole_tile_async<V, KD>(S, base, ld, lane);
    whole_tile_async<V, KD>(S + kTile, base + 3 * C, ld, lane);
    whole_tile_async<V, KD>(S + 2 * kTile, base + C, ld, lane);
    whole_tile_async<V, KD>(S + 3 * kTile, base + 2 * C, ld, lane);
    whole_tile_async<V, KD>(S + 4 * kTile, dO + (size_t)w * V * C + h * KD, C, lane);
  };

  for (int e = lane; e < V * kLdR; e += 32) dr[e] = 0.f;
  float cs[3][kDT][2];   // this lane's column sums of dq, dk, dv (its rows or keys)
#pragma unroll
  for (int part = 0; part < 3; ++part)
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) cs[part][dt][0] = cs[part][dt][1] = 0.f;
  if (Cf::kBufs == 2) {
    prefetch(it_begin, 0);
    cp_async_commit();
  }
  __syncwarp();

  for (int it = it_begin; it < it_end; ++it) {
    int b = 0;
    if constexpr (Cf::kBufs == 2) {
      b = (it - it_begin) & 1;
      if (it + 1 < it_end) prefetch(it + 1, b ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      prefetch(it, 0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncwarp();
    const int h = it / BW, w = it % BW;
    const bf16* Q = bufs + b * Cf::kStage;
    const bf16* QU = Q + kTile;
    const bf16* K = Q + 2 * kTile;
    const bf16* Vt = Q + 3 * kTile;
    const bf16* DOt = Q + 4 * kTile;
    const int* rr = rid == nullptr ? nullptr : rid + (size_t)(w % nW) * V;
    const float* relh = rel + (size_t)h * V * V;
    const size_t row0 = (size_t)w * V;

    // the query rows, 16 at a time: s, p, dp, ds in registers; o and dq
#pragma unroll
    for (int qt = 0; qt < NQ; ++qt) {
      const int i0 = qt * 16 + g;   // this lane's rows: i0 and i0 + 8
      // s, then p = softmax2(s + rel[h] log2(e) + mask), as the forward
      float sc[kNT][4], dp[kNT][4];
      whole_scores<V, KD>(sc, Q, K, qt, lane);
      whole_softmax<V>(sc, relh, rr, i0, t, mask2);
      // dp = do v^T, delta = sum p dp
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKK; ++kk) {
        uint32_t da[4];
        frag_a(da, DOt, kLd, qt * 16, kk * 16, lane);
#pragma unroll
        for (int n2 = 0; n2 < kKT; ++n2) {
          uint32_t bv[4];
          frag_b_rows(bv, Vt, kLd, n2 * 16, kk * 16, lane);
          mma_bf16(dp[2 * n2], da, bv[0], bv[1]);
          mma_bf16(dp[2 * n2 + 1], da, bv[2], bv[3]);
        }
      }
      float delta[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float dl = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          dl += sc[nt][2 * h2] * dp[nt][2 * h2] + sc[nt][2 * h2 + 1] * dp[nt][2 * h2 + 1];
        dl += __shfl_xor_sync(0xffffffffu, dl, 1);
        dl += __shfl_xor_sync(0xffffffffu, dl, 2);
        delta[h2] = dl;
      }
      // ds = p (dp - delta) in fp32 (into dp), drel += ds
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float d0 = sc[nt][2 * h2] * (dp[nt][2 * h2] - delta[h2]);
          const float d1 = sc[nt][2 * h2 + 1] * (dp[nt][2 * h2 + 1] - delta[h2]);
          dp[nt][2 * h2] = d0;
          dp[nt][2 * h2 + 1] = d1;
          float2* acc = reinterpret_cast<float2*>(dr + (i0 + 8 * h2) * kLdR + nt * 8 + 2 * t);
          const float2 a = *acc;
          *acc = make_float2(a.x + d0, a.y + d1);
        }
      // p and ds rounded once: A fragments here, and to shared memory for
      // the transposed products
      uint32_t pa[kKT][4], sa[kKT][4];
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        acc_to_a(pa[kk], sc[2 * kk], sc[2 * kk + 1]);
        acc_to_a(sa[kk], dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int at = (i0 + 8 * (q & 1)) * kLdP + kk * 16 + 8 * (q >> 1) + 2 * t;
          *reinterpret_cast<uint32_t*>(Ps + at) = pa[kk][q];
          *reinterpret_cast<uint32_t*>(DSs + at) = sa[kk][q];
        }
      }
      // o = p v, then dq = ds k (scale)
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        float acc[kDT][4];
        if (pass == 0) {
          whole_rows_times<V, KD>(acc, pa, Vt, lane);
        } else {
          whole_rows_times<V, KD>(acc, sa, K, lane);
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const size_t row = row0 + i0 + 8 * h2;
#pragma unroll
          for (int dt = 0; dt < kDT; ++dt) {
            const int col = h * KD + dt * 8 + 2 * t;
            float v0 = acc[dt][2 * h2], v1 = acc[dt][2 * h2 + 1];
            if (pass == 0) {
              *reinterpret_cast<uint32_t*>(o + row * C + col) = pack_bf16(v0, v1);
            } else {
              v0 *= scale;
              v1 *= scale;
              *reinterpret_cast<uint32_t*>(dqkv + row * 3 * C + col) = pack_bf16(v0, v1);
              cs[0][dt][0] += v0;
              cs[0][dt][1] += v1;
            }
          }
        }
      }
    }
    __syncwarp();   // p and ds are in shared memory

    // the keys, 16 at a time: dv = p^T do, then dk = ds^T q (scale)
#pragma unroll
    for (int kt = 0; kt < NQ; ++kt) {
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        const bf16* At = pass == 0 ? Ps : DSs;
        const bf16* Bt = pass == 0 ? DOt : QU;
        float acc[kDT][4];
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKT; ++kk) {
          uint32_t a[4];
          frag_a_trans(a, At, kLdP, kk * 16, kt * 16, lane);
#pragma unroll
          for (int d2 = 0; d2 < KD / 16; ++d2) {
            uint32_t bf[4];
            frag_b_cols(bf, Bt, kLd, kk * 16, d2 * 16, lane);
            mma_bf16(acc[2 * d2], a, bf[0], bf[1]);
            mma_bf16(acc[2 * d2 + 1], a, bf[2], bf[3]);
          }
        }
        const float mul = pass == 0 ? 1.f : scale;
        const int part = pass == 0 ? 2 : 1;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const size_t row = row0 + kt * 16 + g + 8 * h2;
#pragma unroll
          for (int dt = 0; dt < kDT; ++dt) {
            const int col = part * C + h * KD + dt * 8 + 2 * t;
            const float v0 = acc[dt][2 * h2] * mul, v1 = acc[dt][2 * h2 + 1] * mul;
            *reinterpret_cast<uint32_t*>(dqkv + row * 3 * C + col) = pack_bf16(v0, v1);
            cs[part][dt][0] += v0;
            cs[part][dt][1] += v1;
          }
        }
      }
    }
    __syncwarp();   // the item's buffer, p and ds are free

    // where the range leaves head h: its segment
    if (it + 1 == it_end || (it + 1) / BW != h) {
      float* sg = seg + (size_t)(gw + h) * Cf::kSeg;
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = cs[part][dt][e];
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
            if (g == 0) sg[V * V + part * KD + dt * 8 + 2 * t + e] = v;
            cs[part][dt][e] = 0.f;
          }
      for (int e = lane; e < V * V; e += 32) {
        float* a = dr + (e / V) * kLdR + e % V;
        sg[e] = *a;
        *a = 0.f;
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
}

// red [dbqkv (3C) | . | drel (H V V)] from the whole-window segments: an
// element of head h sums the segments gw + h of the warps gw whose range
// holds an item of h, in warp order.
__global__ void __launch_bounds__(kThreads)
wattn_whole_reduce_kernel(const float* __restrict__ seg, float* __restrict__ red, int BW, int V,
                          int C, int H, int KD, int GW) {
  const long long N = (long long)H * BW;
  const int vv = V * V, sz = vv + 3 * KD;
  const size_t total = (size_t)3 * C + (size_t)H * vv;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    int h, off;
    float* dst;
    if (e < (size_t)3 * C) {
      const int part = (int)(e / C), col = (int)(e % C);
      h = col / KD;
      off = vv + part * KD + col % KD;
      dst = red + e;
    } else {
      const size_t f = e - (size_t)3 * C;
      h = (int)(f / vv);
      off = (int)(f % vv);
      dst = red + 4 * (size_t)C + f;
    }
    const int g_lo = block_of((long long)h * BW, N, GW);
    const int g_hi = block_of((long long)h * BW + BW - 1, N, GW);
    float a = 0.f;
    for (int gg = g_lo; gg <= g_hi; ++gg) a += seg[((size_t)gg + h) * sz + off];
    *dst = a;
  }
}

// The column sums of a (N, C) bf16 stream, C even: block b sums rows [N b /
// G, N (b + 1) / G) into slots[b C, (b + 1) C), its row groups combined in
// order (reduce_slots_kernel then sums the G slots).
__global__ void __launch_bounds__(kThreads)
col_sums_kernel(const bf16* __restrict__ x, long long N, int C, float* __restrict__ slots) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);   // (groups, C)
  const int pairs = C / 2, width = pairs < kThreads ? pairs : kThreads;
  const int groups = kThreads / width;
  const long long r_begin = N * blockIdx.x / gridDim.x, r_end = N * (blockIdx.x + 1) / gridDim.x;
  const int grp = threadIdx.x / width;
  if (grp < groups) {
    for (int p = threadIdx.x % width; p < pairs; p += width) {
      float sx = 0.f, sy = 0.f;
      for (long long r = r_begin + grp; r < r_end; r += groups) {
        const float2 v =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + r * C + 2 * p));
        sx += v.x;
        sy += v.y;
      }
      part[grp * C + 2 * p] = sx;
      part[grp * C + 2 * p + 1] = sy;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float a = 0.f;
    for (int gi = 0; gi < groups; ++gi) a += part[gi * C + c];
    slots[(size_t)blockIdx.x * C + c] = a;
  }
}

inline size_t col_sums_smem(int C) {
  const int pairs = C / 2, width = pairs < kThreads ? pairs : kThreads;
  return (size_t)(kThreads / width) * C * sizeof(float);
}

// The grids and scratch of one backward call. The size query
// (lcbi_window_attention_bwd_scratch) and the launch compute the same plan
// from the shape, the stream type and the slot budget.
struct BwdPlan {
  int path;                       // 0: whole-window (bf16); 1: shared-memory general; 2: mma general
  int G1, G2;                     // path 0: warps of the core, column-sum blocks; else row
                                  // blocks, key blocks or window ranges
  long long slots, kslots, ksums, stats;   // floats of the four scratch buffers
};

template <int NQ, int KD> int plan_whole(int BW, int V, int C, int H, int sms, BwdPlan* P) {
  using Cf = WholeCfg<NQ, KD>;
  const size_t bytes = (size_t)Cf::kWarps * Cf::kWarpBytes;
  if (bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  auto kernel = wattn_whole_bwd_kernel<NQ, KD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Cf::kThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)H * BW;
  const long long gw = std::min((long long)sms * std::max(per_sm, 1) * Cf::kWarps, items);
  P->path = 0;
  P->G1 = (int)gw;
  P->G2 = (int)std::min(4LL * sms, (long long)BW * V);
  P->slots = (long long)P->G2 * C;
  P->kslots = (gw + H) * Cf::kSeg;
  P->ksums = P->stats = 0;
  return 0;
}

template <typename T, int KD>
int plan_smem(int BW, int V, int C, int H, long long budget, int sms, BwdPlan* P) {
  const size_t rbytes = row_layout<KD>(V, sizeof(T), true).bytes;
  const size_t kbytes = kv_layout<KD>(V, sizeof(T)).bytes;
  if (rbytes > (size_t)max_dynamic_smem() || kbytes > (size_t)max_dynamic_smem())
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_attention_rows_kernel<T, true, KD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rbytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(window_attention_keys_kernel<T, KD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kbytes);
  if (err != cudaSuccess) return (int)err;
  const long long max_slots = std::max(1LL, std::min(4LL * sms, budget / (8LL * C)));
  const long long max_gw = std::max(1LL, budget / (4LL * H * V * V));
  const int nkt = (V + kKeyTile - 1) / kKeyTile;
  P->path = 1;
  constexpr int kRows = RowTile<true>::rows;
  P->G1 = persistent_blocks(window_attention_rows_kernel<T, true, KD>, rbytes,
                            (long long)BW * H * ((V + kRows - 1) / kRows), (int)max_slots);
  P->G2 = key_ranges<T, KD>(BW, V, C, H, (int)std::min(max_gw, (long long)BW));
  P->slots = 2LL * C * P->G1;
  P->kslots = (long long)P->G2 * H * V * V;
  P->ksums = (long long)P->G2 * nkt * 2 * C;
  P->stats = 3LL * BW * H * V;
  return P->G1 > 0 && P->G2 > 0 ? 0 : (int)cudaErrorInvalidValue;
}

template <int KD> int plan_mma(int BW, int V, int C, int H, BwdPlan* P) {
  const int nkt = (V + MmaKeyCfg<KD>::kBK - 1) / MmaKeyCfg<KD>::kBK;
  P->path = 2;
  P->G1 = mma_row_blocks<true, KD>(BW, V, H);
  P->G2 = mma_key_blocks<KD>(BW, V, H);
  P->slots = 2LL * C * P->G1;
  P->kslots = ((long long)P->G2 + (long long)H * nkt) * V * MmaKeyCfg<KD>::kBK;
  P->ksums = 2LL * C * P->G2;
  P->stats = 3LL * BW * H * V;
  return P->G1 > 0 && P->G2 > 0 ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T>
int make_plan(int BW, int V, int C, int H, long long budget, BwdPlan* P) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return (int)cudaErrorInvalidValue;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  const int D = C / H;
  if constexpr (std::is_same<T, bf16>::value) {
    if (whole_window_path(V, C, H))
      return whole_dispatch(V, D, [&](auto nq, auto kd) {
        return plan_whole<decltype(nq)::value, decltype(kd)::value>(BW, V, C, H, sms, P);
      });
    if (D <= kMmaMaxHeadDim) {
      switch (mma_head_dim(D)) {
        case 16: return plan_mma<16>(BW, V, C, H, P);
        case 32: return plan_mma<32>(BW, V, C, H, P);
        case 64: return plan_mma<64>(BW, V, C, H, P);
        default: return plan_mma<128>(BW, V, C, H, P);
      }
    }
  }
  switch (padded_head_dim(D, std::is_same<T, float>::value)) {
    case 16: return plan_smem<T, 16>(BW, V, C, H, budget, sms, P);
    case 32: return plan_smem<T, 32>(BW, V, C, H, budget, sms, P);
    default: return plan_smem<T, 64>(BW, V, C, H, budget, sms, P);
  }
}

// The projection streams of every path: qkvu = [q scale log2(e) | k | v | q]
// (x Wqkv + bqkv, ld 4C) and dob = dout Wout^T (ld C), both in T.
template <typename T>
int launch_streams(const void* x, const void* wqkv, const float* bqkv, const void* wout,
                   const void* dout, void* qkvu, void* dob, int N, int C, float scale2,
                   cudaStream_t stream) {
  const int err = launch_projection<T>(x, C, wqkv, 3 * C, false, bqkv, qkvu, 4 * C, N, 3 * C, C,
                                       C, scale2, 3 * C, stream);
  if (err != 0) return err;
  return launch_projection<T>(dout, C, wout, C, true, nullptr, dob, C, N, C, C, 0, 1.f, -1,
                              stream);
}

// dx = dqkv Wqkv^T, in T.
template <typename T>
int launch_dx(const void* dqkv, const void* wqkv, void* dx, int N, int C, cudaStream_t stream) {
  return launch_projection<T>(dqkv, 3 * C, wqkv, 3 * C, true, nullptr, dx, C, N, C, 3 * C, 0, 1.f,
                              -1, stream);
}

// The whole-window path's backward (bf16): the streams, the core
// (wattn_whole_bwd_kernel on G1 warps), dx, the column sums of dout on G2
// blocks, the sums of the slots and segments into red.
template <int NQ, int KD>
int launch_bwd_whole(const void* x, const void* wqkv, const float* bqkv, const void* wout,
                     const float* rel, const int* rid, const void* dout, void* dx, void* dqkv,
                     void* o, float* slots, float* red, void* qkvu, void* dob, float* seg,
                     int BW, int C, int H, int nW, float scale, float scale2, float mask2,
                     const BwdPlan& P, cudaStream_t stream) {
  using Cf = WholeCfg<NQ, KD>;
  constexpr int V = Cf::kV;
  const int N = BW * V;
  int err = launch_streams<bf16>(x, wqkv, bqkv, wout, dout, qkvu, dob, N, C, scale2, stream);
  if (err != 0) return err;
  const size_t bytes = (size_t)Cf::kWarps * Cf::kWarpBytes;
  cudaError_t cerr = cudaFuncSetAttribute(wattn_whole_bwd_kernel<NQ, KD>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (cerr != cudaSuccess) return (int)cerr;
  wattn_whole_bwd_kernel<NQ, KD><<<(unsigned)((P.G1 + Cf::kWarps - 1) / Cf::kWarps),
                                   Cf::kThreads, bytes, stream>>>(
      static_cast<const bf16*>(qkvu), static_cast<const bf16*>(dob), rel, rid,
      static_cast<bf16*>(o), static_cast<bf16*>(dqkv), seg, BW, C, H, nW, P.G1, scale, mask2);
  if ((cerr = cudaGetLastError()) != cudaSuccess) return (int)cerr;
  if ((err = launch_dx<bf16>(dqkv, wqkv, dx, N, C, stream)) != 0) return err;
  col_sums_kernel<<<P.G2, kThreads, col_sums_smem(C), stream>>>(static_cast<const bf16*>(dout),
                                                                  N, C, slots);
  if ((cerr = cudaGetLastError()) != cudaSuccess) return (int)cerr;
  if ((err = launch_reduce(slots, P.G2, C, C, red + 3 * C, stream)) != 0) return err;
  size_t blocks = ((size_t)3 * C + (size_t)H * V * V + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  wattn_whole_reduce_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(seg, red, BW, V, C, H, KD,
                                                                      P.G1);
  return (int)cudaGetLastError();
}

// The shared-memory general path's backward (see the top of this file). red
// receives [dbqkv (3C) | dbout (C) | drel (H V V)], as every path's.
template <typename T, int KD>
int launch_bwd_general(const void* x, const void* wqkv, const float* bqkv, const void* wout,
                       const float* rel, const int* rid, const void* dout, void* dx, void* dqkv,
                       void* o, float* slots, float* red, void* qkvu, void* dob, float* stats,
                       float* kslots, float* ksums, int BW, int V, int C, int H, int nW,
                       float scale, float scale2, float mask2, const BwdPlan& P,
                       cudaStream_t stream) {
  const int N = BW * V;
  int err = launch_streams<T>(x, wqkv, bqkv, wout, dout, qkvu, dob, N, C, scale2, stream);
  if (err != 0) return err;
  int G1 = 0;
  err = launch_rows<T, true, KD>(qkvu, 4 * C, rel, rid, dob, dout, o, dqkv, stats, slots, P.G1,
                                 BW, V, C, H, nW, scale, mask2, &G1, stream);
  if (err != 0) return err;
  if (G1 != P.G1) return (int)cudaErrorInvalidValue;
  const size_t bytes = kv_layout<KD>(V, sizeof(T)).bytes;
  cudaError_t cerr = cudaFuncSetAttribute(window_attention_keys_kernel<T, KD>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (cerr != cudaSuccess) return (int)cerr;
  const int nkt = (V + kKeyTile - 1) / kKeyTile, nch = (C / H + KD - 1) / KD;
  const int Gw = P.G2;
  window_attention_keys_kernel<T, KD><<<dim3((unsigned)(nkt * nch), (unsigned)H, (unsigned)Gw),
                                        kThreads, bytes, stream>>>(
      static_cast<const T*>(qkvu), static_cast<const T*>(dob), rel, rid, stats,
      static_cast<T*>(dqkv), kslots, ksums, BW, V, C, H, nW, scale, mask2);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;
  if ((err = launch_dx<T>(dqkv, wqkv, dx, N, C, stream)) != 0) return err;
  // red: dbq from the row slots' [0, C), dbk | dbv from the key sums, dbout
  // from the row slots' [C, 2C), drel from the key slots
  if ((err = launch_reduce(slots, G1, 2 * C, C, red, stream)) != 0) return err;
  if ((err = launch_reduce(ksums, Gw * nkt, 2 * C, 2 * C, red + C, stream)) != 0) return err;
  if ((err = launch_reduce(slots + C, G1, 2 * C, C, red + 3 * C, stream)) != 0) return err;
  return launch_reduce(kslots, Gw, (size_t)H * V * V, (size_t)H * V * V, red + 4 * C, stream);
}

// The mma general path's backward (bf16, D <= 128; window_attention_mma.cuh):
// the projections as the shared-memory path's, the mma row kernel (o, dq,
// statistics, the dbq and dbout slots), the mma key kernel (dk, dv, the drel
// segments and their sums, the dbk | dbv slots), dx, the slot sums.
template <int KD>
int launch_bwd_mma(const void* x, const void* wqkv, const float* bqkv, const void* wout,
                   const float* rel, const int* rid, const void* dout, void* dx, void* dqkv,
                   void* o, float* slots, float* red, void* qkvu, void* dob, float* stats,
                   float* kseg, float* kslots, int BW, int V, int C, int H, int nW, float scale,
                   float scale2, float mask2, const BwdPlan& P, cudaStream_t stream) {
  const int N = BW * V;
  int err = launch_streams<bf16>(x, wqkv, bqkv, wout, dout, qkvu, dob, N, C, scale2, stream);
  if (err != 0) return err;
  err = launch_rows_mma<true, KD>(qkvu, 4 * C, rel, rid, dob, dout, o, dqkv, stats, slots, P.G1,
                                  BW, V, C, H, nW, scale, mask2, stream);
  if (err != 0) return err;
  err = launch_keys_mma<KD>(qkvu, dob, rel, rid, stats, dqkv, kseg, kslots, red + 4 * C, P.G2, BW,
                            V, C, H, nW, scale, mask2, stream);
  if (err != 0) return err;
  if ((err = launch_dx<bf16>(dqkv, wqkv, dx, N, C, stream)) != 0) return err;
  if ((err = launch_reduce(slots, P.G1, 2 * C, C, red, stream)) != 0) return err;
  if ((err = launch_reduce(kslots, P.G2, 2 * C, 2 * C, red + C, stream)) != 0) return err;
  return launch_reduce(slots + C, P.G1, 2 * C, C, red + 3 * C, stream);
}

template <typename T>
int launch_bwd_d(const void* x, const void* wqkv, const float* bqkv, const void* wout,
                 const float* rel, const int* rid, const void* dout, void* dx, void* dqkv,
                 void* o, float* slots, float* red, void* qkvu, void* dob, float* stats,
                 float* kslots, float* ksums, int BW, int V, int C, int H, int nW, float scale,
                 float scale2, float mask2, const BwdPlan& P, cudaStream_t s) {
  const int D = C / H;
  if (P.path == 0) {
    return whole_dispatch(V, D, [&](auto nq, auto kd) {
      return launch_bwd_whole<decltype(nq)::value, decltype(kd)::value>(
          x, wqkv, bqkv, wout, rel, rid, dout, dx, dqkv, o, slots, red, qkvu, dob, kslots, BW, C,
          H, nW, scale, scale2, mask2, P, s);
    });
  }
  if (P.path == 2) {
    switch (mma_head_dim(D)) {
      case 16:
        return launch_bwd_mma<16>(x, wqkv, bqkv, wout, rel, rid, dout, dx, dqkv, o, slots, red,
                                  qkvu, dob, stats, kslots, ksums, BW, V, C, H, nW, scale, scale2,
                                  mask2, P, s);
      case 32:
        return launch_bwd_mma<32>(x, wqkv, bqkv, wout, rel, rid, dout, dx, dqkv, o, slots, red,
                                  qkvu, dob, stats, kslots, ksums, BW, V, C, H, nW, scale, scale2,
                                  mask2, P, s);
      case 64:
        return launch_bwd_mma<64>(x, wqkv, bqkv, wout, rel, rid, dout, dx, dqkv, o, slots, red,
                                  qkvu, dob, stats, kslots, ksums, BW, V, C, H, nW, scale, scale2,
                                  mask2, P, s);
      default:
        return launch_bwd_mma<128>(x, wqkv, bqkv, wout, rel, rid, dout, dx, dqkv, o, slots, red,
                                   qkvu, dob, stats, kslots, ksums, BW, V, C, H, nW, scale,
                                   scale2, mask2, P, s);
    }
  }
  switch (padded_head_dim(D, std::is_same<T, float>::value)) {
    case 16:
      return launch_bwd_general<T, 16>(x, wqkv, bqkv, wout, rel, rid, dout, dx, dqkv, o, slots,
                                       red, qkvu, dob, stats, kslots, ksums, BW, V, C, H, nW,
                                       scale, scale2, mask2, P, s);
    case 32:
      return launch_bwd_general<T, 32>(x, wqkv, bqkv, wout, rel, rid, dout, dx, dqkv, o, slots,
                                       red, qkvu, dob, stats, kslots, ksums, BW, V, C, H, nW,
                                       scale, scale2, mask2, P, s);
    default:
      return launch_bwd_general<T, 64>(x, wqkv, bqkv, wout, rel, rid, dout, dx, dqkv, o, slots,
                                       red, qkvu, dob, stats, kslots, ksums, BW, V, C, H, nW,
                                       scale, scale2, mask2, P, s);
  }
}

}  // namespace lcbi

// Every path writes the 4C-wide stream qkvu.
static bool bwd_shape_ok(int BW, int V, int C, int H) {
  return lcbi::attn_shape_ok(BW, V, C, H) && (long long)BW * V * 4 * C < (1LL << 31);
}

// The scratch of a backward call, in floats: sizes[0] for slots, sizes[1]
// for kslots, sizes[2] for ksums, sizes[3] for stats (0: pass NULL), for this
// shape, stream type and budget (bytes of fp32 slots the caller allows).
// Returns 0, or a CUDA error code (a shape the kernels do not take, a device
// query that failed). Launches nothing.
extern "C" int lcbi_window_attention_bwd_scratch(int BW, int V, int C, int H,
                                                 long long budget, int is_bf16,
                                                 long long* sizes) {
  if (!bwd_shape_ok(BW, V, C, H) || budget < 1) return (int)cudaErrorInvalidValue;
  lcbi::BwdPlan P;
  const int err = is_bf16 ? lcbi::make_plan<__nv_bfloat16>(BW, V, C, H, budget, &P)
                          : lcbi::make_plan<float>(BW, V, C, H, budget, &P);
  if (err != 0) return err;
  sizes[0] = P.slots;
  sizes[1] = P.kslots;
  sizes[2] = P.ksums;
  sizes[3] = P.stats;
  return 0;
}

// x, dout, dx: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); dqkv (BW V,
// 3C) and o (BW V, C) in T, written; wqkv (C, 3C), wout (C, C) in T; bqkv (3C,),
// rel (H, V, V) fp32; rid (nW, V) int32 or NULL. red (4C + H V V) fp32
// receives [dbqkv | dbout | drel]. Scratch: qkvu (BW V, 4C) and dob (BW V,
// C) in T; slots, kslots, ksums and stats fp32 of the sizes
// lcbi_window_attention_bwd_scratch gives for the same shape, type and budget
// (NULL where 0). Shapes as lcbi_window_attention_fwd. Returns
// cudaGetLastError() of the launches.
extern "C" int lcbi_window_attention_bwd(const void* x, const void* wqkv, const void* bqkv,
                                         const void* wout, const void* rel, const void* rid,
                                         const void* dout, void* dx, void* dqkv, void* o,
                                         void* slots, void* red, void* qkvu, void* dob,
                                         void* stats, void* kslots, void* ksums, int BW, int V,
                                         int C, int H, int nW, float scale, float scale2,
                                         float mask2, long long budget, int is_bf16,
                                         void* stream) {
  (void)cudaGetLastError();
  if (!bwd_shape_ok(BW, V, C, H) || (rid != nullptr && (nW <= 0 || BW % nW != 0)) || budget < 1)
    return (int)cudaErrorInvalidValue;
  lcbi::BwdPlan P;
  int err = is_bf16 ? lcbi::make_plan<__nv_bfloat16>(BW, V, C, H, budget, &P)
                    : lcbi::make_plan<float>(BW, V, C, H, budget, &P);
  if (err != 0) return err;
  if (qkvu == nullptr || dob == nullptr || slots == nullptr || kslots == nullptr ||
      (P.ksums > 0 && ksums == nullptr) || (P.stats > 0 && stats == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b3 = static_cast<const float*>(bqkv);
  const float* r = static_cast<const float*>(rel);
  const int* ids = static_cast<const int*>(rid);
  float* sl = static_cast<float*>(slots);
  float* rd = static_cast<float*>(red);
  float* st = static_cast<float*>(stats);
  float* ks = static_cast<float*>(kslots);
  float* ku = static_cast<float*>(ksums);
  if (is_bf16)
    return lcbi::launch_bwd_d<__nv_bfloat16>(x, wqkv, b3, wout, r, ids, dout, dx, dqkv, o, sl, rd,
                                             qkvu, dob, st, ks, ku, BW, V, C, H, nW, scale,
                                             scale2, mask2, P, s);
  return lcbi::launch_bwd_d<float>(x, wqkv, b3, wout, r, ids, dout, dx, dqkv, o, sl, rd, qkvu, dob,
                                   st, ks, ku, BW, V, C, H, nW, scale, scale2, mask2, P, s);
}
