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
// inputs (no saved statistics) and rounds where that kernel rounds: q, k, v,
// p, o, do and ds to T before their products, dqkv to T, which is also the
// operand of dWqkv = x^T dqkv and of dx = dqkv Wqkv^T (and o of dWout =
// o^T dout); dbqkv sums the fp32 dqkv, drel the fp32 ds (natural units).
//
// What bounds it on the H100: operations, 14 T C^2 + 12 T V C of products
// here (the q | k | v projection recomputed, do, dx) against 6 T C bytes of
// streams in and out. The TPU kernel sums the weight and bias gradients into
// one VMEM block over its sequential grid. Here a persistent grid of G blocks
// walks contiguous ranges of 64-row tiles; dbqkv, dbout and drel, small, go to
// each block's own fp32 slot, summed by reduce_slots_kernel in a fixed order
// (no atomics: two launches give the same bits). The (C, 3C) and (C, C)
// weight gradients would need megabyte slots per block at C = 768, so this
// kernel writes dqkv and o in T instead, and the split-K kernel of
// window_attention_wgrad.cu contracts them.
//
// Windows of other sizes up to 512 tokens take the general path
// (window_attention.cuh). Its backward is six launches: the q | k | v
// projection recomputed into device memory (q scale log2(e), k, v and the
// unscaled q, all in T) and do = dout Wout^T per head (T); the row kernel
// on full score rows, which writes o, dq and each row's (max, sum, delta);
// the key-tile kernel below, which recomputes p and ds from those statistics
// for one tile of kKeyTile keys at a time and sums dk, dv over every query
// row of a window and drel over the windows of its range; dx = dqkv Wqkv^T;
// and the fixed-order sums of the blocks' slots. drel, H V^2 floats, does
// not fit a block's shared memory whole at V = 512 (3 MB at 3 heads), so
// each block keeps the columns of its key tile (V x 32 floats) for all its
// windows, and the q, do rows of each window are read once per key tile.
#include "window_attention.cuh"

namespace lcbi {

struct BwdLayout {
  int lds, ldp;
  size_t off_g, off_q, off_qu, off_k, off_v, off_do, off_s, off_dp, off_p, off_ds, bytes;
};

__host__ __device__ inline BwdLayout bwd_layout(int V, int elem) {
  BwdLayout L;
  L.lds = ld_scores(V);
  L.ldp = ld_probs(V);
  const size_t t = align128((size_t)kTileRows * kLdT * elem);
  const size_t s = align128((size_t)kTileRows * L.lds * 4);
  const size_t p = align128((size_t)kTileRows * L.ldp * elem);
  L.off_g = align128((size_t)kTileRows * (kLdO > kLdF ? kLdO : kLdF) * 4);
  L.off_q = L.off_g + align128((size_t)kTileRows * kLdG * 4);
  L.off_qu = L.off_q + t;
  L.off_k = L.off_qu + t;
  L.off_v = L.off_k + t;
  L.off_do = L.off_v + t;
  L.off_s = L.off_do + t;
  L.off_dp = L.off_s + s;
  L.off_p = L.off_dp + s;
  L.off_ds = L.off_p + p;
  L.bytes = L.off_ds + p;
  return L;
}

// Slot layout (floats): dbqkv [0, 3C), dbout [3C, 4C), drel [4C, 4C + H V V).
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_bwd_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                            const float* __restrict__ bqkv, const T* __restrict__ wout,
                            const float* __restrict__ rel, const int* __restrict__ rid,
                            const T* __restrict__ dout, T* __restrict__ dx, T* dqkv,
                            T* __restrict__ o, float* __restrict__ slots, int BW, int V, int C,
                            int H, int nW, float scale, float scale2, float mask2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L = bwd_layout(V, sizeof(T));
  float* F = reinterpret_cast<float*>(smem);
  float* G = reinterpret_cast<float*>(smem + L.off_g);
  T* Q = reinterpret_cast<T*>(smem + L.off_q);
  T* QU = reinterpret_cast<T*>(smem + L.off_qu);
  T* K = reinterpret_cast<T*>(smem + L.off_k);
  T* Vt = reinterpret_cast<T*>(smem + L.off_v);
  T* DO = reinterpret_cast<T*>(smem + L.off_do);
  float* S = reinterpret_cast<float*>(smem + L.off_s);
  float* DP = reinterpret_cast<float*>(smem + L.off_dp);
  T* P = reinterpret_cast<T*>(smem + L.off_p);
  T* DS = reinterpret_cast<T*>(smem + L.off_ds);

  const size_t slot_floats = (size_t)4 * C + (size_t)H * V * V;
  float* slot = slots + (size_t)blockIdx.x * slot_floats;
  for (size_t e = threadIdx.x; e < slot_floats; e += kThreads) slot[e] = 0.f;
  __syncthreads();

  const int tw = kTileRows / V;
  const long long tiles = ((long long)BW + tw - 1) / tw;
  const long long t_begin = tiles * blockIdx.x / gridDim.x;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long t = t_begin; t < t_end; ++t) {
    const Tile tl = tile_of(t, BW, V);
    const int M = tl.M, nb = tl.nwin;
    const T* xr = x + tl.row0 * C;
    const T* gr = dout + tl.row0 * C;
    T* dr = dqkv + tl.row0 * 3 * C;
    T* orow = o + tl.row0 * C;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float acc = 0.f;
      for (int r = 0; r < M; ++r) acc += to_f32(gr[(size_t)r * C + c]);
      slot[3 * C + c] += acc;
    }

    for (int h = 0; h < H; ++h) {
      project_head(F, xr, wqkv, M, C, h);
      for (int e = threadIdx.x; e < M * 3 * kHeadDim; e += kThreads) {
        const int r = e / (3 * kHeadDim), j = e % (3 * kHeadDim);
        const int part = j / kHeadDim, d = j % kHeadDim;
        const float v = F[r * kLdF + j] + bqkv[part * C + h * kHeadDim + d];
        if (part == 0) {
          Q[r * kLdT + d] = from_f32<T>(v * scale2);
          QU[r * kLdT + d] = from_f32<T>(v);
        } else {
          (part == 1 ? K : Vt)[r * kLdT + d] = from_f32<T>(v);
        }
      }
      __syncthreads();
      gemm_batched<false, true>(nb, S, L.lds, V * L.lds, Q, kLdT, V * kLdT, K, kLdT, V * kLdT,
                                V, V, kHeadDim);
      // do_h = dout Wout[hD:(h+1)D, :]^T over the tile's rows
      gemm<false, true>(F, kLdF, gr, C, wout + (size_t)h * kHeadDim * C, C, M, kHeadDim, C,
                        false);
      __syncthreads();
      softmax_rows(S, L.lds, P, L.ldp, M, V, rel + (size_t)h * V * V, rid, nW, tl.w0, mask2);
      for (int e = threadIdx.x; e < M * kHeadDim; e += kThreads) {
        const int r = e / kHeadDim, d = e % kHeadDim;
        DO[r * kLdT + d] = from_f32<T>(F[r * kLdF + d]);
      }
      __syncthreads();
      // o_h = p v; dv = p^T do; dp = do v^T
      gemm_batched<false, false>(nb, G, kLdG, V * kLdG, P, L.ldp, V * L.ldp, Vt, kLdT, V * kLdT,
                                 V, kHeadDim, V);
      gemm_batched<true, false>(nb, F + 2 * kHeadDim, kLdF, V * kLdF, P, L.ldp, V * L.ldp, DO,
                                kLdT, V * kLdT, V, kHeadDim, V);
      gemm_batched<false, true>(nb, DP, L.lds, V * L.lds, DO, kLdT, V * kLdT, Vt, kLdT,
                                V * kLdT, V, V, kHeadDim);
      __syncthreads();
      for (int e = threadIdx.x; e < M * kHeadDim; e += kThreads) {
        const int r = e / kHeadDim, d = e % kHeadDim;
        orow[(size_t)r * C + h * kHeadDim + d] = from_f32<T>(G[r * kLdG + d]);
      }
      // ds = p (dp - rowsum(dp p)), one warp per row
      {
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        for (int r = warp; r < M; r += kWarps) {
          float delta = 0.f;
          for (int j = lane; j < V; j += 32) delta += DP[r * L.lds + j] * S[r * L.lds + j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            delta += __shfl_xor_sync(0xffffffffu, delta, off);
          for (int j = lane; j < V; j += 32) {
            const float ds = S[r * L.lds + j] * (DP[r * L.lds + j] - delta);
            DP[r * L.lds + j] = ds;
            DS[r * L.ldp + j] = from_f32<T>(ds);
          }
        }
      }
      __syncthreads();
      float* drel = slot + 4 * C + (size_t)h * V * V;
      for (int e = threadIdx.x; e < V * V; e += kThreads) {
        const int i = e / V, j = e % V;
        float acc = 0.f;
        for (int w = 0; w < nb; ++w) acc += DP[(w * V + i) * L.lds + j];
        drel[e] += acc;
      }
      // dq = ds k, dk = ds^T q (unscaled q; both times scale below)
      gemm_batched<false, false>(nb, F, kLdF, V * kLdF, DS, L.ldp, V * L.ldp, K, kLdT, V * kLdT,
                                 V, kHeadDim, V);
      gemm_batched<true, false>(nb, F + kHeadDim, kLdF, V * kLdF, DS, L.ldp, V * L.ldp, QU, kLdT,
                                V * kLdT, V, kHeadDim, V);
      __syncthreads();
      for (int j = threadIdx.x; j < 3 * kHeadDim; j += kThreads) {
        const float mul = j < 2 * kHeadDim ? scale : 1.f;
        const int col = (j / kHeadDim) * C + h * kHeadDim + j % kHeadDim;
        float acc = 0.f;
        for (int r = 0; r < M; ++r) {
          const float v = F[r * kLdF + j] * mul;
          acc += v;
          dr[(size_t)r * 3 * C + col] = from_f32<T>(v);
        }
        slot[col] += acc;
      }
      __syncthreads();
    }

    // dx = dqkv Wqkv^T over the tile's rows, in column chunks
    T* dxr = dx + tl.row0 * C;
    for (int n0 = 0; n0 < C; n0 += kOutCols) {
      const int nc = min(kOutCols, C - n0);
      gemm<false, true>(F, kLdO, dr, 3 * C, wqkv + (size_t)n0 * 3 * C, 3 * C, M, nc, 3 * C,
                        false);
      __syncthreads();
      for (int e = threadIdx.x; e < M * nc; e += kThreads) {
        const int r = e / nc, j = e % nc;
        dxr[(size_t)r * C + n0 + j] = from_f32<T>(F[r * kLdO + j]);
      }
      __syncthreads();
    }
  }
}

constexpr int kKeyTile = 32;   // keys of a key-tile block
constexpr int kQRows = 64;     // query rows per step of a key-tile block
constexpr int kLdSt = kQRows + 4;
constexpr int kLdPt = kQRows + 8;
constexpr int kLdDr = kKeyTile + 4;

struct KvLayout {
  size_t off_k, off_v, off_q, off_qu, off_do, off_s, off_dp, off_p, off_ds, off_dk, off_dv, off_st,
      bytes;
};

// drel's columns of the key tile for every query row (V x 32 fp32) first,
// then the k, v tile, the q, unscaled q and do rows of a step, the
// transposed scores and dp (fp32) and p, ds (T) of a step, the fp32 dk, dv
// sums and the step's row statistics.
__host__ __device__ inline KvLayout kv_layout(int V, int elem) {
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

// Block (kt, h, g): keys [kt 32, kt 32 + 32) of head h in the windows [BW g
// / G, BW (g + 1) / G). For each window it walks the query rows in steps of
// kQRows: s^T = k q^T, p^T = exp2(s^T + rel^T log2(e) + mask - max) / sum
// from the row kernel's statistics, dp^T = v do^T, ds^T = p^T (dp^T -
// delta); dv += p^T do, dk += ds^T qu (unscaled q), and drel's tile += ds.
// It writes dk scale and dv in T to dqkv (columns C + h D and 2C + h D), the
// column sums of dk scale and dv over its keys and windows to ksums[g nkt +
// kt] ([dbk | dbv], 2C floats, the head's columns), and the drel tile to
// rows [0, V) and columns of its keys in kslots[g] (H V V floats). qkvu: q
// scale log2(e) | k | v | q per token row (ld 4C); dO: do per head (ld C).
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_keys_kernel(const T* __restrict__ qkvu, const T* __restrict__ dO,
                             const float* __restrict__ rel, const int* __restrict__ rid,
                             const float* __restrict__ stats, T* __restrict__ dqkv,
                             float* __restrict__ kslots, float* __restrict__ ksums, int BW,
                             int V, int C, int H, int nW, float scale, float mask2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const KvLayout L = kv_layout(V, sizeof(T));
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

  const int kt = blockIdx.x, h = blockIdx.y, g = blockIdx.z, G = gridDim.z;
  const int nkt = gridDim.x;
  const int j0 = kt * kKeyTile, keys = min(kKeyTile, V - j0);
  const long long w_begin = (long long)BW * g / G, w_end = (long long)BW * (g + 1) / G;
  const size_t ld = (size_t)4 * C;
  const size_t plane = (size_t)BW * H * V;
  const int nq = (V + kQRows - 1) / kQRows;
  for (int e = threadIdx.x; e < V * kLdDr; e += kThreads) Dr[e] = 0.f;
  float colsum = 0.f;   // thread t < 2D: column t of [dk | dv] over the block's keys

  for (long long w = w_begin; w < w_end; ++w) {
    const size_t row0 = (size_t)w * V;
    const T* base = qkvu + row0 * ld;
    const int* rr = rid == nullptr ? nullptr : rid + (size_t)(w % nW) * V;
    const size_t srow = ((size_t)w * H + h) * V;
    load_head_rows(Kt, base + (size_t)j0 * ld, ld, C + h * kHeadDim, keys, kKeyTile);
    load_head_rows(Vt, base + (size_t)j0 * ld, ld, 2 * C + h * kHeadDim, keys, kKeyTile);
    for (int qs = 0; qs < nq; ++qs) {
      const int i0 = qs * kQRows, rows = min(kQRows, V - i0);
      load_head_rows(Q2, base + (size_t)i0 * ld, ld, h * kHeadDim, rows, kQRows);
      load_head_rows(QU, base + (size_t)i0 * ld, ld, 3 * C + h * kHeadDim, rows, kQRows);
      load_head_rows(DOt, dO + (row0 + i0) * C, C, h * kHeadDim, rows, kQRows);
      for (int r = threadIdx.x; r < kQRows; r += kThreads) {
        Mst[r] = r < rows ? stats[srow + i0 + r] : 0.f;
        Lst[r] = r < rows ? stats[plane + srow + i0 + r] : 1.f;
        Dst[r] = r < rows ? stats[2 * plane + srow + i0 + r] : 0.f;
      }
      __syncthreads();
      gemm<false, true>(St, kLdSt, Kt, kLdT, Q2, kLdT, kKeyTile, kQRows, kHeadDim, false);
      gemm<false, true>(DPt, kLdSt, Vt, kLdT, DOt, kLdT, kKeyTile, kQRows, kHeadDim, false);
      __syncthreads();
      for (int e = threadIdx.x; e < kKeyTile * kQRows; e += kThreads) {
        const int jj = e % kKeyTile, r = e / kKeyTile;
        const int i = i0 + r, j = j0 + jj;
        float p = 0.f, ds = 0.f;
        if (jj < keys && r < rows) {
          float s = St[jj * kLdSt + r] + rel[((size_t)h * V + i) * V + j] * kLog2e;
          if (rr != nullptr) s += rr[i] != rr[j] ? mask2 : 0.f;
          p = exp2f(s - Mst[r]) / Lst[r];
          ds = p * (DPt[jj * kLdSt + r] - Dst[r]);
          Dr[i * kLdDr + jj] += ds;
        }
        Pt[jj * kLdPt + r] = from_f32<T>(p);
        DSt[jj * kLdPt + r] = from_f32<T>(ds);
      }
      __syncthreads();
      gemm<false, false>(DVA, kLdG, Pt, kLdPt, DOt, kLdT, kKeyTile, kHeadDim, kQRows, qs > 0);
      gemm<false, false>(DKA, kLdG, DSt, kLdPt, QU, kLdT, kKeyTile, kHeadDim, kQRows, qs > 0);
      __syncthreads();
    }
    for (int e = threadIdx.x; e < keys * kHeadDim; e += kThreads) {
      const int jj = e / kHeadDim, d = e % kHeadDim;
      T* drow = dqkv + (row0 + j0 + jj) * 3 * C + h * kHeadDim + d;
      drow[C] = from_f32<T>(DKA[jj * kLdG + d] * scale);
      drow[2 * C] = from_f32<T>(DVA[jj * kLdG + d]);
    }
    if (threadIdx.x < 2 * kHeadDim) {
      const int d = threadIdx.x % kHeadDim;
      const float* A = threadIdx.x < kHeadDim ? DKA : DVA;
      const float mul = threadIdx.x < kHeadDim ? scale : 1.f;
      for (int jj = 0; jj < keys; ++jj) colsum += A[jj * kLdG + d] * mul;
    }
    __syncthreads();
  }
  float* drel = kslots + (size_t)g * H * V * V + (size_t)h * V * V;
  for (int e = threadIdx.x; e < V * keys; e += kThreads) {
    const int i = e / keys, jj = e % keys;
    drel[(size_t)i * V + j0 + jj] = Dr[i * kLdDr + jj];
  }
  if (threadIdx.x < 2 * kHeadDim) {
    const int part = threadIdx.x / kHeadDim, d = threadIdx.x % kHeadDim;
    ksums[((size_t)g * nkt + kt) * 2 * C + part * C + h * kHeadDim + d] = colsum;
  }
}

// Window ranges of the key-tile grid: enough that its nkt H blocks per range
// fill the card's resident blocks four times over, at most max_gw and BW.
template <typename T>
int key_ranges(int BW, int V, int H, int max_gw) {
  const size_t bytes = kv_layout(V, sizeof(T)).bytes;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_attention_keys_kernel<T>,
                                                    kThreads, bytes) != cudaSuccess)
    return 0;
  const long long per_range = (long long)((V + kKeyTile - 1) / kKeyTile) * H;
  long long g = (4LL * sms * (per_sm > 0 ? per_sm : 1) + per_range - 1) / per_range;
  if (g < 1) g = 1;
  if (g > BW) g = BW;
  if (g > max_gw) g = max_gw;
  return (int)g;
}

// The general path's backward (see the top of this file). red receives
// [dbqkv (3C) | dbout (C) | drel (H V V)] as the whole-window path's.
template <typename T>
int launch_bwd_general(const void* x, const void* wqkv, const float* bqkv, const void* wout,
                       const float* rel, const int* rid, const void* dout, void* dx, void* dqkv,
                       void* o, float* slots, float* red, void* qkvu, void* dob, float* stats,
                       float* kslots, float* ksums, int BW, int V, int C, int H, int nW,
                       float scale, float scale2, float mask2, int max_slots, int max_gw,
                       cudaStream_t stream) {
  const int N = BW * V;
  int err = launch_proj<T>(x, C, wqkv, 3 * C, false, bqkv, qkvu, 4 * C, N, 3 * C, C, C, scale2,
                           3 * C, stream);
  if (err != 0) return err;
  err = launch_proj<T>(dout, C, wout, C, true, nullptr, dob, C, N, C, C, 0, 1.f, -1, stream);
  if (err != 0) return err;
  int G1 = 0;
  err = launch_rows<T, true>(qkvu, 4 * C, rel, rid, dob, dout, o, dqkv, stats, slots, max_slots,
                             BW, V, C, H, nW, scale, mask2, &G1, stream);
  if (err != 0) return err;
  const size_t bytes = kv_layout(V, sizeof(T)).bytes;
  if (bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  cudaError_t cerr = cudaFuncSetAttribute(window_attention_keys_kernel<T>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (cerr != cudaSuccess) return (int)cerr;
  const int nkt = (V + kKeyTile - 1) / kKeyTile;
  const int Gw = key_ranges<T>(BW, V, H, max_gw);
  if (Gw <= 0) return (int)cudaErrorInvalidValue;
  window_attention_keys_kernel<T><<<dim3((unsigned)nkt, (unsigned)H, (unsigned)Gw), kThreads,
                                    bytes, stream>>>(
      static_cast<const T*>(qkvu), static_cast<const T*>(dob), rel, rid, stats,
      static_cast<T*>(dqkv), kslots, ksums, BW, V, C, H, nW, scale, mask2);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;
  err = launch_proj<T>(dqkv, 3 * C, wqkv, 3 * C, true, nullptr, dx, C, N, C, 3 * C, 0, 1.f, -1,
                       stream);
  if (err != 0) return err;
  // red: dbq from the row slots' [0, C), dbk | dbv from the key sums, dbout
  // from the row slots' [C, 2C), drel from the key slots
  if ((err = launch_reduce(slots, G1, 2 * C, C, red, stream)) != 0) return err;
  if ((err = launch_reduce(ksums, Gw * nkt, 2 * C, 2 * C, red + C, stream)) != 0)
    return err;
  if ((err = launch_reduce(slots + C, G1, 2 * C, C, red + 3 * C, stream)) != 0)
    return err;
  return launch_reduce(kslots, Gw, (size_t)H * V * V, (size_t)H * V * V, red + 4 * C,
                               stream);
}

template <typename T>
int launch_bwd(const void* x, const void* wqkv, const float* bqkv, const void* wout,
               const float* rel, const int* rid, const void* dout, void* dx, void* dqkv, void* o,
               float* slots, float* red, int BW, int V, int C, int H, int nW, float scale,
               float scale2, float mask2, int max_slots, cudaStream_t stream) {
  const size_t bytes = bwd_layout(V, sizeof(T)).bytes;
  if (bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int tw = kTileRows / V;
  const long long tiles = ((long long)BW + tw - 1) / tw;
  const int G = persistent_blocks(window_attention_bwd_kernel<T>, bytes, tiles, max_slots);
  if (G <= 0) return (int)cudaErrorInvalidValue;
  window_attention_bwd_kernel<T><<<G, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), bqkv, static_cast<const T*>(wout),
      rel, rid, static_cast<const T*>(dout), static_cast<T*>(dx), static_cast<T*>(dqkv),
      static_cast<T*>(o), slots, BW, V, C, H, nW, scale, scale2, mask2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(slots, G, (size_t)4 * C + (size_t)H * V * V, red, stream);
}

}  // namespace lcbi

// x, dout, dx: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); dqkv (BW V,
// 3C) and o (BW V, C) in T, written; wqkv (C, 3C), wout (C, C) in T; bqkv (3C,),
// rel (H, V, V) fp32; rid (nW, V) int32 or NULL. red (4C + H V V) fp32
// receives [dbqkv | dbout | drel]. Whole-window path (V = 16, 32, 48, 64):
// slots max_slots x (4C + H V V) fp32 scratch; the general path's scratch
// pointers may be NULL. General path (every other V up to 512): slots
// max_slots x 2C fp32; qkvu (BW V, 4C) and dob (BW V, C) in T; stats 3 BW H V
// fp32; kslots max_gw x H V V and ksums max_gw ceil(V / 32) x 2C fp32.
// Shapes as lcbi_window_attention_fwd. Returns cudaGetLastError() of the
// launches.
extern "C" int lcbi_window_attention_bwd(const void* x, const void* wqkv, const void* bqkv,
                                         const void* wout, const void* rel, const void* rid,
                                         const void* dout, void* dx, void* dqkv, void* o,
                                         void* slots, void* red, void* qkvu, void* dob,
                                         void* stats, void* kslots, void* ksums, int BW, int V,
                                         int C, int H, int nW, float scale, float scale2,
                                         float mask2, int max_slots, int max_gw, int is_bf16,
                                         void* stream) {
  (void)cudaGetLastError();
  const bool whole = lcbi::whole_window_path(V);
  if (!lcbi::attn_shape_ok(BW, V, C, H) || (rid != nullptr && (nW <= 0 || BW % nW != 0)) ||
      (long long)BW * V * (whole ? 3 : 4) * C >= (1LL << 31) || max_slots < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b3 = static_cast<const float*>(bqkv);
  const float* r = static_cast<const float*>(rel);
  const int* ids = static_cast<const int*>(rid);
  float* sl = static_cast<float*>(slots);
  float* rd = static_cast<float*>(red);
  if (!whole) {
    if (qkvu == nullptr || dob == nullptr || stats == nullptr || kslots == nullptr ||
        ksums == nullptr || max_gw < 1)
      return (int)cudaErrorInvalidValue;
    float* st = static_cast<float*>(stats);
    float* ks = static_cast<float*>(kslots);
    float* ku = static_cast<float*>(ksums);
    if (is_bf16)
      return lcbi::launch_bwd_general<__nv_bfloat16>(x, wqkv, b3, wout, r, ids, dout, dx, dqkv, o,
                                                     sl, rd, qkvu, dob, st, ks, ku, BW, V, C, H,
                                                     nW, scale, scale2, mask2, max_slots, max_gw,
                                                     s);
    return lcbi::launch_bwd_general<float>(x, wqkv, b3, wout, r, ids, dout, dx, dqkv, o, sl, rd,
                                           qkvu, dob, st, ks, ku, BW, V, C, H, nW, scale, scale2,
                                           mask2, max_slots, max_gw, s);
  }
  if (is_bf16)
    return lcbi::launch_bwd<__nv_bfloat16>(x, wqkv, b3, wout, r, ids, dout, dx, dqkv, o, sl, rd,
                                           BW, V, C, H, nW, scale, scale2, mask2, max_slots, s);
  return lcbi::launch_bwd<float>(x, wqkv, b3, wout, r, ids, dout, dx, dqkv, o, sl, rd, BW, V, C,
                                 H, nW, scale, scale2, mask2, max_slots, s);
}

// The number of window ranges (rows of kslots) that the general backward's
// key-tile grid runs for these shapes, given at most max_gw, and in
// *key_tiles its key tiles per window (ksums has ranges x key_tiles rows); 0
// on a device query error. Launches nothing.
extern "C" int lcbi_window_attention_key_ranges(int BW, int V, int H, int max_gw, int is_bf16,
                                                int* key_tiles) {
  if (BW < 1 || V < 1 || V > lcbi::kMaxTokens || H < 1 || max_gw < 1) return 0;
  *key_tiles = (V + lcbi::kKeyTile - 1) / lcbi::kKeyTile;
  return is_bf16 ? lcbi::key_ranges<__nv_bfloat16>(BW, V, H, max_gw)
                 : lcbi::key_ranges<float>(BW, V, H, max_gw);
}
