// Chunked Hyena window mixer K3, forward, for windows of 64 < V <= 512 tokens:
//     out = [x +] out_proj(x2 * L(x1 * v)),  [x1 | x2 | v] = shortconv(in_proj([LN](x)))
// with the long conv L as block-Toeplitz products (see hyena_chunked.cuh).
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/hyena_window.py
// _make_fwd_kernel_chunked (launched by _fwd_chunked through
// _mixer_core_chunked[_ln], entry hyena_window_mixer).
//
// What bounds it on the H100: the products. For T tokens, in_proj 6*T*C^2,
// out_proj 2*T*C^2 and the Toeplitz products 2*T*C*chunk*(n+1)/2 operations
// (emb stage 0, T = 2^21, C = 96: 284 GFLOP, 0.29 ms at 989 TFLOP/s) against
// 4*T*C bytes of x in and out (0.8 GB, 0.24 ms at 3.35 TB/s). A 512-token
// window does not fit in a block's shared memory the way the TPU kernel keeps
// one in VMEM, so the chain runs as three launches whose per-channel streams
// cross global memory (g and v2 in T, x2 in fp32; about 4.4 GB a call at emb
// stage 0, largely L2-resident), and each launch keeps its products on
// mma.sync fragments fed from shared memory:
//   1. k3_rows_in: per row tile of 64 tokens of one window plus a back halo
//      of 16 rows (the short conv reaches K - 1 <= 15 tokens back; a
//      fragment's 16 rows is the least halo), a persistent grid walking the
//      tiles: the tile's rows arrive by 16-byte copies issued under the
//      previous tile's last convs and are [LN'd] in place in bf16, then per
//      chunk of 32 channels z = y win[:, x1 | x2 | v of the chunk] (96
//      columns) on fragments over win slices 64 deep, to shared memory in
//      fp32 once; a thread per (channel, 8 tokens) runs the three short convs
//      in registers (at the models' 5 taps; in shared memory at any other
//      count), and g = v x1 (T) and x2 (fp32) go out through shared memory
//      as whole 64-token runs of each channel (stored a lane per channel, 16
//      bytes apart by a stream's plane, they left the launch 1.3x slower).
//   2. k3_toeplitz: per (32 windows, channel), the group's g rows staged in
//      shared memory chunk-major; for each distance d the Toeplitz block
//      M[d][c] comes through the ring in slices of 32 rows, and each slice's
//      B fragments feed every output chunk q >= d, whose sums stay in
//      registers across d (n x 32 rows x chunk columns of fp32: 64 registers
//      a thread), so M[d] is read once a block and 32 windows share it. The
//      epilogue applies the post-gate v2 = vl x2 and writes v2 (T) over g.
//   3. k3_rows_out: per row tile, the tile of v2 staged channel-major as it
//      lies in memory (16-byte copies), its A fragments read transposed by
//      ldmatrix.trans; out_proj's fp32 tile stays in registers over wo slabs
//      32 deep, and the epilogue adds b_out [and x] and rounds once.
// Every weight slice (win, M, wo) comes through a three-slot ring of cp.async
// copies with the tails past the true C zeroed (mlp_common.cuh stage16), two
// stages ahead of the products; one barrier a slice.
//
// fp32 (the tests' path, and emb without AMP): the same three launches with
// the products as FMA loops (common.cuh gemm: full fp32, no TF32) over
// slices of win, M and wo staged in shared memory with the tails masked, the
// sums in shared memory.
//
// Widths: every operand at its true C (no padded copy): the rows of x load
// at the true C (LayerNorm statistics over C), the channel axis runs in
// chunks of 32 whose tails read zero weights, taps and biases, the streams
// hold the true C channels and only columns [0, C) of out are stored.
#include "hyena_chunked.cuh"
#include "mlp_common.cuh"   // stage16, stage_slice16, the mma.sync fragments, cp.async

namespace lcbi {

constexpr int kHalo = 16;             // halo rows of a row tile (>= K - 1, a fragment's rows)
constexpr int kInRows = kHalo + kRowTile;
constexpr int kW3 = 3 * kChunkChannels;   // z columns of a chunk: x1 | x2 | v
constexpr int kLdZ3 = kW3 + 4;        // the fp32 z chunk
constexpr int kTokPer = 8;            // tokens a conv thread writes
constexpr int kFwdRing = 3;           // ring slots: kFwdRing - 1 stages ahead
constexpr int kWinSlice = 64;         // depth of a staged bf16 win slice
constexpr int kLdWin3 = kW3 + 8;
constexpr int kF32Slice = 16;         // depth of a staged fp32 win slice
constexpr int kMSlice = 32;           // rows of a staged Toeplitz or wo slice
constexpr int kToepGroup = 32;        // windows of a bf16 Toeplitz block

static_assert(kChunkChannels * (kRowTile / kTokPer) == kThreads, "a conv thread per 8 tokens");

// Rows of a row tile: local row i holds token t0 - kHalo + i of window w,
// LN'd (or copied) into ys in T, columns [C, cpad) zero (cpad >= C); rows
// whose token lies outside [0, V) are zero.
template <typename T>
__device__ void load_window_rows(const T* __restrict__ x, int w, int t0, int V, int C, int cpad,
                                 const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                                 int has_ln, T* ys, int lds) {
  const int lo = max(0, kHalo - t0);
  const int hi = min(kInRows, kHalo + V - t0);
  const T* src = x + ((size_t)w * V + (t0 - kHalo + lo)) * C;
  layernorm_rows(src, hi - lo, hi - lo, C, ln_g, ln_b, has_ln, ys + (size_t)lo * lds, lds,
                 (float*)nullptr, (float*)nullptr, cpad);
  for (int i = threadIdx.x; i < kInRows * cpad; i += kThreads) {
    const int r = i / cpad;
    if (r < lo || r >= hi) ys[(size_t)r * lds + i % cpad] = from_f32<T>(0.f);
  }
}

// The short convs of one row tile's chunk, from z (fp32, ld kLdZ3; column s
// 32 + j is channel c0 + j of block s of [x1 | x2 | v], the in_proj output
// without its bias): thread (8-token group grp, channel j) computes o[s][t],
// block s's conv at token t0 + 8 grp + t of channel c0 + j (c0 + j < C). Each
// conv output is bs + sum_m (z[t - m] + bin) ws[m] over the taps that stay
// inside the window (token t - m >= 0). KT > 0: K = KT, the taps and a
// sliding window of z in registers; KT = 0: any K, from shared memory.
template <int KT>
__device__ __forceinline__ void short_convs(const float* z, int c0, int C, int K, int t0,
                                            const float* __restrict__ bin,
                                            const float* __restrict__ ws,
                                            const float* __restrict__ bs,
                                            float (&o)[3][kTokPer]) {
  const int j = threadIdx.x % kChunkChannels, grp = threadIdx.x / kChunkChannels;
  const int c = c0 + j;
  const int row0 = kHalo + grp * kTokPer, tg0 = t0 + grp * kTokPer;
  const size_t C3 = (size_t)3 * C;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int col = s * C + c;
    const float bi = bin[col], bsv = bs[col];
    const float* zc = z + s * kChunkChannels + j;
    if constexpr (KT > 0) {
      float w[KT], zw[kTokPer + KT - 1];
#pragma unroll
      for (int m = 0; m < KT; ++m) w[m] = ws[m * C3 + col];
#pragma unroll
      for (int i = 0; i < kTokPer + KT - 1; ++i) zw[i] = zc[(row0 - (KT - 1) + i) * kLdZ3] + bi;
#pragma unroll
      for (int t = 0; t < kTokPer; ++t) {
        float a = bsv;
#pragma unroll
        for (int m = 0; m < KT; ++m)
          if (m <= tg0 + t) a += zw[t + KT - 1 - m] * w[m];
        o[s][t] = a;
      }
    } else {
      for (int t = 0; t < kTokPer; ++t) {
        float a = bsv;
        for (int m = 0; m < K && m <= tg0 + t; ++m)
          a += (zc[(row0 + t - m) * kLdZ3] + bi) * ws[m * C3 + col];
        o[s][t] = a;
      }
    }
  }
}

// The conv tail of one chunk (K = 5, the models' short filter, in
// registers): g = v x1 (T) and x2 (fp32) of the chunk's channels, staged
// channel-major in z's place once every thread has read z, then stored a
// channel's 64 tokens at a time (whole 128- and 256-byte runs of the
// channel-major streams). Every thread of the block takes part (barriers).
template <typename T>
__device__ __forceinline__ void chunk_convs(float* z, int c0, int C, int K, int w, int t0, int V,
                                            size_t plane, const float* __restrict__ bin,
                                            const float* __restrict__ ws,
                                            const float* __restrict__ bs, T* g_out,
                                            float* x2_out) {
  constexpr int kLdG = kRowTile + 16 / (int)sizeof(T), kLdX = kRowTile + 4;
  const int j = threadIdx.x % kChunkChannels, grp = threadIdx.x / kChunkChannels;
  const bool live = c0 + j < C;
  float o[3][kTokPer];
  if (live) {
    if (K == 5) {
      short_convs<5>(z, c0, C, K, t0, bin, ws, bs, o);
    } else {
      short_convs<0>(z, c0, C, K, t0, bin, ws, bs, o);
    }
  }
  __syncthreads();   // every thread has read z
  T* gst = reinterpret_cast<T*>(z);
  float* xst = z + kChunkChannels * kLdG * sizeof(T) / 4;
  if (live) {
    T* gr = gst + j * kLdG + grp * kTokPer;
    float* xr = xst + j * kLdX + grp * kTokPer;
#pragma unroll
    for (int t = 0; t < kTokPer; ++t) {
      gr[t] = from_f32<T>(o[2][t] * o[0][t]);
      xr[t] = o[1][t];
    }
  }
  __syncthreads();
  const size_t base = (size_t)w * V + t0;
  constexpr int kGv = 16 / (int)sizeof(T);   // T values in 16 bytes
  for (int e = threadIdx.x; e < kChunkChannels * kRowTile / kGv; e += kThreads) {
    const int ch = e / (kRowTile / kGv), t = (e % (kRowTile / kGv)) * kGv;
    if (c0 + ch < C)
      *reinterpret_cast<uint4*>(g_out + (size_t)(c0 + ch) * plane + base + t) =
          *reinterpret_cast<const uint4*>(gst + ch * kLdG + t);
  }
  for (int e = threadIdx.x; e < kChunkChannels * kRowTile / 4; e += kThreads) {
    const int ch = e / (kRowTile / 4), t = (e % (kRowTile / 4)) * 4;
    if (c0 + ch < C)
      *reinterpret_cast<float4*>(x2_out + (size_t)(c0 + ch) * plane + base + t) =
          *reinterpret_cast<const float4*>(xst + ch * kLdX + t);
  }
}

// ---------------------------------------------------------------------------
// 1. Row kernel in
// ---------------------------------------------------------------------------

struct RowsInLayout {
  int lds;
  size_t off_z, off_ring, bytes;
};

// ys (kInRows, Cs + 8) in T, z (kInRows, kLdZ3) fp32, then the ring of win
// slices (bf16: 3 x 64 x 104; fp32: one 16 x 100 slice).
__host__ __device__ inline RowsInLayout rows_in_layout(int C, int elem) {
  RowsInLayout L;
  L.lds = round_up16(C) + 8;
  L.off_z = align128((size_t)kInRows * L.lds * elem);
  L.off_ring = L.off_z + align128((size_t)kInRows * kLdZ3 * 4);
  L.bytes = L.off_ring + (elem == 2 ? align128((size_t)kFwdRing * kWinSlice * kLdWin3 * 2)
                                    : align128((size_t)kF32Slice * kLdZ3 * 4));
  return L;
}

// bf16: a persistent grid, each block walking row tiles tile, tile +
// gridDim.x, ...: the tile's rows arrive by 16-byte copies (issued while the
// previous tile's last convs run) and are LN'd in place; z = y win for one
// chunk on fragments, 30 units of 16 x 16 (5 m-tiles x 6 column pairs) over
// the 8 warps, win slices through the ring, whose stages run on across the
// tiles (every tile streams the same slices), so the next tile's first
// slices load during this tile's last convs.
__global__ void __launch_bounds__(kThreads, 2)
k3_rows_in_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_g,
                      const float* __restrict__ ln_b, const bf16* __restrict__ win,
                      const float* __restrict__ bin, const float* __restrict__ ws,
                      const float* __restrict__ bs, bf16* __restrict__ g_out,
                      float* __restrict__ x2_out, int BW, int V, int C, int K, int has_ln) {
  constexpr int kUnits = (kInRows / 16) * (kW3 / 16), kPerWarp = (kUnits + kWarps - 1) / kWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsInLayout L = rows_in_layout(C, 2);
  bf16* ys = reinterpret_cast<bf16*>(smem);
  float* z = reinterpret_cast<float*>(smem + L.off_z);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.off_ring);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int tiles_per_window = V / kRowTile, row_tiles = BW * tiles_per_window;
  const size_t plane = (size_t)BW * V;
  const int Cs = round_up16(C), nks = (C + kWinSlice - 1) / kWinSlice;
  const int nch = (C + kChunkChannels - 1) / kChunkChannels, per_tile = nch * nks;
  const int ntiles = (row_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = ntiles * per_tile;
  const bool vec = C % 8 == 0;   // 16-byte rows and column blocks of win and x

  // stage s: chunk (s % per_tile) / nks, win rows [64 (s % nks), + 64), the
  // chunk's 32 columns of each of x1, x2, v
  auto prefetch = [&](int s) {
    bf16* dst = ring + (s % kFwdRing) * kWinSlice * kLdWin3;
    const int c0 = (s % per_tile / nks) * kChunkChannels, k0 = (s % nks) * kWinSlice;
    for (int e = threadIdx.x; e < kWinSlice * 12; e += kThreads) {
      const int r = e / 12, q = e % 12;
      stage16(dst + r * kLdWin3 + q * 8, win + (q / 4) * C + c0, k0 + r, C, (q % 4) * 8, C - c0,
              3 * C, vec);
    }
  };
  // the rows of a tile: local row r holds token t0 - kHalo + r of its
  // window, rows outside [0, V) zero
  auto stage_rows = [&](int tile) {
    const int w = tile / tiles_per_window, t0 = (tile % tiles_per_window) * kRowTile;
    const int lo = max(0, kHalo - t0), hi = min(kInRows, kHalo + V - t0);
    stage_rows16(ys, L.lds, x + ((size_t)w * V + (t0 - kHalo + lo)) * C, lo, hi, kInRows, C, Cs,
                 vec);
  };
  stage_rows(blockIdx.x);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kFwdRing - 1; ++i) {
    if (i < total) prefetch(i);
    cp_async_commit();
  }

  int s = 0;
  for (int tile = blockIdx.x; tile < row_tiles; tile += gridDim.x) {
    const int w = tile / tiles_per_window, t0 = (tile % tiles_per_window) * kRowTile;
    const int lo = max(0, kHalo - t0), hi = min(kInRows, kHalo + V - t0);
    cp_async_wait<0>();   // the tile's rows (and the ring's heads) are in
    __syncthreads();
    layernorm_rows_inplace(ys + lo * L.lds, L.lds, hi - lo, C, ln_g, ln_b, has_ln);
    for (int ch = 0; ch < nch; ++ch) {
      float za[kPerWarp][2][4] = {};
      for (int sub = 0; sub < nks; ++sub, ++s) {
        cp_async_wait<kFwdRing - 2>();
        __syncthreads();
        if (s + kFwdRing - 1 < total) prefetch(s + kFwdRing - 1);
        cp_async_commit();
        const bf16* sl = ring + (s % kFwdRing) * kWinSlice * kLdWin3;
        const int k0 = sub * kWinSlice, kw = min(kWinSlice, Cs - k0);
#pragma unroll
        for (int i = 0; i < kPerWarp; ++i) {
          const int u = warp + kWarps * i;
          if (u >= kUnits) break;
          const int mt = u / (kW3 / 16), n0 = (u % (kW3 / 16)) * 16;
          for (int kk = 0; kk < kw; kk += 16) {
            uint32_t a[4], b[4];
            frag_a(a, ys, L.lds, mt * 16, k0 + kk, lane);
            frag_b_cols(b, sl, kLdWin3, kk, n0, lane);
            mma_bf16(za[i][0], a, b[0], b[1]);
            mma_bf16(za[i][1], a, b[2], b[3]);
          }
        }
      }
      // z to shared memory in fp32 (the previous chunk's convs have read it:
      // every thread passed this chunk's first barrier since)
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        const int u = warp + kWarps * i;
        if (u >= kUnits) break;
        const int mt = u / (kW3 / 16), n0 = (u % (kW3 / 16)) * 16;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(z + (mt * 16 + g + 8 * hh) * kLdZ3 + n0 + j * 8 + 2 * t4) =
                make_float2(za[i][j][2 * hh], za[i][j][2 * hh + 1]);
      }
      __syncthreads();   // also: every warp's last read of ys is done
      if (ch == nch - 1 && tile + (int)gridDim.x < row_tiles) {
        stage_rows(tile + gridDim.x);   // the next tile's rows, under this chunk's convs
        cp_async_commit();
      }
      chunk_convs<bf16>(z, ch * kChunkChannels, C, K, w, t0, V, plane, bin, ws, bs, g_out,
                        x2_out);
    }
  }
  cp_async_wait<0>();
}

// fp32: the same chain on FMA products in shared memory over 16-deep win
// slices staged with the tails masked. In fp32 the bounds ask for two
// blocks an SM: left free, ptxas spilled the FMA products.
__global__ void __launch_bounds__(kThreads, 2)
k3_rows_in_f32_kernel(const float* __restrict__ x, const float* __restrict__ ln_g,
                      const float* __restrict__ ln_b, const float* __restrict__ win,
                      const float* __restrict__ bin, const float* __restrict__ ws,
                      const float* __restrict__ bs, float* __restrict__ g_out,
                      float* __restrict__ x2_out, int BW, int V, int C, int K, int has_ln) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsInLayout L = rows_in_layout(C, 4);
  float* ys = reinterpret_cast<float*>(smem);
  float* z = reinterpret_cast<float*>(smem + L.off_z);
  float* wsl = reinterpret_cast<float*>(smem + L.off_ring);
  const int tiles_per_window = V / kRowTile;
  const int w = blockIdx.x / tiles_per_window, t0 = (blockIdx.x % tiles_per_window) * kRowTile;
  const size_t plane = (size_t)BW * V, C3 = (size_t)3 * C;
  load_window_rows(x, w, t0, V, C, C, ln_g, ln_b, has_ln, ys, L.lds);
  for (int c0 = 0; c0 < C; c0 += kChunkChannels) {
    for (int k0 = 0; k0 < C; k0 += kF32Slice) {
      const int kw = min(kF32Slice, C - k0);
      __syncthreads();   // the previous slice's product (and chunk's convs) are done
      for (int e = threadIdx.x; e < kF32Slice * kW3; e += kThreads) {
        const int k = e / kW3, j = e % kW3, c = c0 + j % kChunkChannels;
        wsl[k * kLdZ3 + j] =
            k < kw && c < C ? win[(size_t)(k0 + k) * C3 + (j / kChunkChannels) * C + c] : 0.f;
      }
      __syncthreads();
      gemm<false, false>(z, kLdZ3, ys + k0, L.lds, wsl, kLdZ3, kInRows, kW3, kw, k0 > 0);
    }
    __syncthreads();
    chunk_convs<float>(z, c0, C, K, w, t0, V, plane, bin, ws, bs, g_out, x2_out);
  }
}

// ---------------------------------------------------------------------------
// 2. Toeplitz kernel
// ---------------------------------------------------------------------------

// bf16, one block per (32 windows, channel c): gs (n x 32 rows, chunk + 8)
// in T, the group's g rows chunk-major (row q 32 + b: chunk q of window b),
// then the ring of M slices (32 x (chunk + 8)). Warp (mi, nc): windows [16
// mi, + 16), columns [CH/4 nc, + CH/4) of every output chunk.
template <int CH>
__host__ __device__ inline size_t toeplitz_mma_gs_bytes(int n) {
  return align128((size_t)n * kToepGroup * (CH + 8) * 2);
}
template <int CH> __host__ __device__ inline size_t toeplitz_mma_bytes(int n) {
  return toeplitz_mma_gs_bytes<CH>(n) + align128((size_t)kFwdRing * kMSlice * (CH + 8) * 2);
}

template <int CH>
__global__ void __launch_bounds__(kThreads, 2)
k3_toeplitz_mma_kernel(bf16* __restrict__ gv, const float* __restrict__ x2,
                       const bf16* __restrict__ m, int BW, int V, int C) {
  constexpr int NQ = 512 / CH, NT = CH / 32, kLd = CH + 8, kSlot = kMSlice * kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = V / CH;
  bf16* gs = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + toeplitz_mma_gs_bytes<CH>(n));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int mi = warp & 1, ncol = (warp >> 1) * (CH / 4);
  const int c = blockIdx.y, w0 = blockIdx.x * kToepGroup, nw = min(kToepGroup, BW - w0);
  const size_t base = (size_t)c * BW * V + (size_t)w0 * V;
  const bf16* mc = m + (size_t)c * CH * CH;           // M[d][c] at mc + d C CH^2
  const int per = CH / kMSlice, total = n * per;

  auto prefetch = [&](int s) {
    const int d = s / per, k0 = (s % per) * kMSlice;
    stage_slice16<kMSlice, CH>(ring + (s % kFwdRing) * kSlot, kLd, mc + (size_t)d * C * CH * CH,
                               k0, CH, 0, CH, CH, true);
  };
  // the group's g rows (16-byte copies; zeros past BW), then the ring's head
  for (int e = threadIdx.x; e < n * kToepGroup * (CH / 8); e += kThreads) {
    const int row = e / (CH / 8), r = (e % (CH / 8)) * 8;
    const int q = row / kToepGroup, b = row % kToepGroup;
    const bf16* src = gv + base + (size_t)(b < nw ? b : 0) * V + q * CH + r;
    cp_async16(smem_addr(gs + row * kLd + r), src, b < nw ? 16 : 0);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kFwdRing - 1; ++i) {
    if (i < total) prefetch(i);
    cp_async_commit();
  }

  float acc[NQ][NT][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.f;
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kFwdRing - 2>();
    __syncthreads();
    if (s + kFwdRing - 1 < total) prefetch(s + kFwdRing - 1);
    cp_async_commit();
    const bf16* sl = ring + (s % kFwdRing) * kSlot;
    const int d = s / per, k0 = (s % per) * kMSlice;
    // acc[q] += g[q - d][:, k0 + 32) M[d][k0 + 32), for every q >= d
#pragma unroll
    for (int kk = 0; kk < kMSlice; kk += 16) {
      uint32_t b[NT / 2][4];
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) frag_b_cols(b[p], sl, kLd, kk, ncol + 16 * p, lane);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (q < d || q >= n) continue;
        uint32_t a[4];
        frag_a(a, gs, kLd, (q - d) * kToepGroup + mi * 16, k0 + kk, lane);
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          mma_bf16(acc[q][2 * p], a, b[p][0], b[p][1]);
          mma_bf16(acc[q][2 * p + 1], a, b[p][2], b[p][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  // post-gate, v2 = vl x2, written over this block's g rows
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (q >= n) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int b = mi * 16 + g + 8 * hh;
        if (b >= nw) continue;
        const size_t gi = base + (size_t)b * V + q * CH + ncol + j * 8 + 2 * t4;
        const float2 xv = *reinterpret_cast<const float2*>(x2 + gi);
        *reinterpret_cast<uint32_t*>(gv + gi) =
            pack_bf16(acc[q][j][2 * hh] * xv.x, acc[q][j][2 * hh + 1] * xv.y);
      }
  }
}

// fp32, one block per (16 windows, channel): the group's g rows and the fp32
// sums in shared memory (toeplitz_layout), M[d][c] staged 32 rows at a time,
// the products as common.cuh's FMA loops.
__global__ void __launch_bounds__(kThreads)
k3_toeplitz_f32_kernel(float* __restrict__ gv, const float* __restrict__ x2,
                       const float* __restrict__ m, int BW, int V, int C, int chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = V / chunk;
  const ToeplitzLayout L = toeplitz_layout(n, chunk, 4, false);
  float* gs = reinterpret_cast<float*>(smem);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);
  float* ms = reinterpret_cast<float*>(smem + L.off_m);
  const int c = blockIdx.y;
  const int w0 = blockIdx.x * kWindowGroup;
  const int nw = min(kWindowGroup, BW - w0);
  load_group_rows(gv, c, w0, nw, BW, V, n, chunk, gs, L.ldg);
  // acc[q] = sum_{d <= q} gs[q - d] @ M[d][c]
  for (int d = 0; d < n; ++d) {
    const float* md = m + ((size_t)d * C + c) * chunk * chunk;
    for (int k0 = 0; k0 < chunk; k0 += kMSlice) {
      __syncthreads();   // the previous slice's product is done
      for (int i = threadIdx.x; i < kMSlice * chunk; i += kThreads)
        ms[(i / chunk) * L.lda + i % chunk] = md[(size_t)k0 * chunk + i];
      __syncthreads();
      gemm<false, false>(acc + (size_t)d * kWindowGroup * L.lda, L.lda, gs + k0, L.ldg, ms, L.lda,
                         (n - d) * kWindowGroup, chunk, kMSlice, d > 0 || k0 > 0);
    }
  }
  __syncthreads();
  const size_t base = (size_t)c * BW * V + (size_t)w0 * V;
  for (int i = threadIdx.x; i < n * kWindowGroup * chunk; i += kThreads) {
    const int row = i / chunk, r = i % chunk;
    const int q = row / kWindowGroup, b = row % kWindowGroup;
    if (b < nw) {
      const size_t gi = base + (size_t)b * V + q * chunk + r;
      gv[gi] = acc[(size_t)row * L.lda + r] * x2[gi];
    }
  }
}

// ---------------------------------------------------------------------------
// 3. Row kernel out
// ---------------------------------------------------------------------------

constexpr int kLdVt = kRowTile + 8;   // the bf16 v2 tile, channel-major
constexpr int kOutNt = 12;            // 8-column tiles of a warp's half of the output, C <= 192

__host__ __device__ inline size_t rows_out_mma_ring(int C) {
  return align128((size_t)round_up16(C) * kLdVt * 2);
}
__host__ __device__ inline size_t rows_out_mma_res(int C) {
  return rows_out_mma_ring(C) + align128((size_t)kFwdRing * kMSlice * (round_up16(C) + 8) * 2);
}
__host__ __device__ inline size_t rows_out_mma_bytes(int C) {
  return rows_out_mma_res(C) + align128((size_t)kRowTile * (round_up16(C) + 8) * 2);
}

// bf16: the v2 tile (Cs channels x 64 tokens, as it lies in memory), the
// ring of wo slices (32 x (Cs + 8)), the residual's rows (64 x (Cs + 8), read
// with the v2 tile); warp (m-tile mt, half nh): rows [16 mt, + 16), columns
// [nh Cs / 2, + Cs / 2), in registers.
__global__ void __launch_bounds__(kThreads, 2)
k3_rows_out_mma_kernel(const bf16* __restrict__ v2, const bf16* __restrict__ x,
                       const bf16* __restrict__ wo, const float* __restrict__ bo,
                       bf16* __restrict__ out, int BW, int V, int C, int has_ln) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Cs = round_up16(C), ldw = Cs + 8, half = Cs / 2, nt = (half + 7) / 8;
  bf16* vt = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + rows_out_mma_ring(C));
  bf16* xres = reinterpret_cast<bf16*>(smem + rows_out_mma_res(C));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int mt = warp & 3, n0 = (warp >> 2) * half;
  const int tiles_per_window = V / kRowTile;
  const int w = blockIdx.x / tiles_per_window, t0 = (blockIdx.x % tiles_per_window) * kRowTile;
  const size_t plane = (size_t)BW * V;
  const int total = (C + kMSlice - 1) / kMSlice;
  const bool vec = C % 8 == 0;
  auto prefetch = [&](int s) {
    bf16* dst = ring + (s % kFwdRing) * kMSlice * ldw;
    for (int e = threadIdx.x; e < kMSlice * (Cs / 8); e += kThreads) {
      const int r = e / (Cs / 8), cc = (e % (Cs / 8)) * 8;
      stage16(dst + r * ldw + cc, wo, s * kMSlice + r, C, cc, C, C, vec);
    }
  };
  // the v2 tile: channel c's 64 tokens are 128 contiguous bytes
  for (int e = threadIdx.x; e < Cs * (kRowTile / 8); e += kThreads) {
    const int c = e / (kRowTile / 8), t = (e % (kRowTile / 8)) * 8;
    const bf16* src = v2 + (size_t)(c < C ? c : 0) * plane + (size_t)w * V + t0 + t;
    cp_async16(smem_addr(vt + c * kLdVt + t), src, c < C ? 16 : 0);
  }
  if (has_ln)
    stage_rows16(xres, ldw, x + ((size_t)w * V + t0) * C, 0, kRowTile, kRowTile, C, Cs, vec);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kFwdRing - 1; ++i) {
    if (i < total) prefetch(i);
    cp_async_commit();
  }
  float acc[kOutNt][4];
#pragma unroll
  for (int j = 0; j < kOutNt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kFwdRing - 2>();
    __syncthreads();
    if (s + kFwdRing - 1 < total) prefetch(s + kFwdRing - 1);
    cp_async_commit();
    const bf16* sl = ring + (s % kFwdRing) * kMSlice * ldw;
    const int k0 = s * kMSlice, kw = min(kMSlice, Cs - k0);
    for (int kk = 0; kk < kw; kk += 16) {
      uint32_t a[4];
      frag_a_trans(a, vt, kLdVt, k0 + kk, mt * 16, lane);
#pragma unroll
      for (int p = 0; p < kOutNt / 2; ++p) {
        if (2 * p >= nt) break;
        uint32_t b[4];
        frag_b_cols(b, sl, ldw, kk, n0 + 16 * p, lane);
        mma_bf16(acc[2 * p], a, b[0], b[1]);
        mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  const size_t base = ((size_t)w * V + t0) * C;
#pragma unroll
  for (int j = 0; j < kOutNt; ++j) {
    const int col = n0 + j * 8 + 2 * t4;
    if (j >= nt || col >= C) continue;
    const bool two = col + 1 < C;
    const float b0 = bo[col], b1 = two ? bo[col + 1] : 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = mt * 16 + g + 8 * hh;
      const size_t at = base + (size_t)row * C + col;
      float v0 = acc[j][2 * hh] + b0, v1 = acc[j][2 * hh + 1] + b1;
      if (has_ln) {
        v0 += __bfloat162float(xres[row * ldw + col]);
        v1 += __bfloat162float(xres[row * ldw + col + 1]);   // zero past C
      }
      if (two && C % 2 == 0) {   // a 4-byte pair
        *reinterpret_cast<uint32_t*>(out + at) = pack_bf16(v0, v1);
      } else {
        out[at] = __float2bfloat16(v0);
        if (two) out[at + 1] = __float2bfloat16(v1);
      }
    }
  }
}

struct RowsOutF32Layout {
  int ldv, ldacc;
  size_t off_acc, off_w, bytes;
};

// the v2 tile row-major (64, C + 4), the fp32 sums (64, C + 4), a staged wo
// slice (32, C + 4)
__host__ __device__ inline RowsOutF32Layout rows_out_f32_layout(int C) {
  RowsOutF32Layout L;
  L.ldv = C + 4;
  L.ldacc = C + 4;
  L.off_acc = align128((size_t)kRowTile * L.ldv * 4);
  L.off_w = L.off_acc + align128((size_t)kRowTile * L.ldacc * 4);
  L.bytes = L.off_w + align128((size_t)kMSlice * L.ldacc * 4);
  return L;
}

__global__ void __launch_bounds__(kThreads)
k3_rows_out_f32_kernel(const float* __restrict__ v2, const float* __restrict__ x,
                       const float* __restrict__ wo, const float* __restrict__ bo,
                       float* __restrict__ out, int BW, int V, int C, int has_ln) {
  constexpr int R = kRowTile;
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsOutF32Layout L = rows_out_f32_layout(C);
  float* vs = reinterpret_cast<float*>(smem);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);
  float* wsl = reinterpret_cast<float*>(smem + L.off_w);
  const int tiles_per_window = V / R;
  const int w = blockIdx.x / tiles_per_window;
  const int t0 = (blockIdx.x % tiles_per_window) * R;
  const size_t plane = (size_t)BW * V;
  // the tile of v2, channel-major in global memory, row-major here
  for (int i = threadIdx.x; i < R * C; i += kThreads) {
    const int c = i / R, t = i % R;
    vs[(size_t)t * L.ldv + c] = v2[(size_t)c * plane + (size_t)w * V + t0 + t];
  }
  for (int k0 = 0; k0 < C; k0 += kMSlice) {
    const int kw = min(kMSlice, C - k0);
    __syncthreads();   // the tile is in; the previous slice's product is done
    for (int i = threadIdx.x; i < kw * C; i += kThreads)
      wsl[(i / C) * L.ldacc + i % C] = wo[(size_t)k0 * C + i];
    __syncthreads();
    gemm<false, false>(acc, L.ldacc, vs + k0, L.ldv, wsl, L.ldacc, R, C, kw, k0 > 0);
  }
  __syncthreads();
  const size_t base = ((size_t)w * V + t0) * C;
  for (int i = threadIdx.x; i < R * C; i += kThreads) {
    const int t = i / C, c = i % C;
    float v = acc[(size_t)t * L.ldacc + c] + bo[c];
    if (has_ln) v += x[base + i];
    out[base + i] = v;
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int CH>
int launch_toeplitz_mma(bf16* g, const float* x2, const bf16* m, int BW, int V, int C,
                        cudaStream_t stream) {
  const size_t bytes = toeplitz_mma_bytes<CH>(V / CH);
  int err = prepare(k3_toeplitz_mma_kernel<CH>, bytes);
  if (err != 0) return err;
  const dim3 groups((unsigned)((BW + kToepGroup - 1) / kToepGroup), (unsigned)C);
  k3_toeplitz_mma_kernel<CH><<<groups, kThreads, bytes, stream>>>(g, x2, m, BW, V, C);
  return (int)cudaGetLastError();
}

int launch_bf16(const bf16* x, const float* ln_g, const float* ln_b, const bf16* win,
                const float* bin, const float* ws, const float* bs, const bf16* m,
                const bf16* wo, const float* bo, bf16* out, bf16* g, float* x2, int BW, int V,
                int C, int K, int chunk, int has_ln, cudaStream_t stream) {
  const unsigned row_tiles = (unsigned)((size_t)BW * V / kRowTile);
  const size_t in_bytes = rows_in_layout(C, 2).bytes, out_bytes = rows_out_mma_bytes(C);
  int err = prepare(k3_rows_in_mma_kernel, in_bytes);
  if (err == 0) err = prepare(k3_rows_out_mma_kernel, out_bytes);
  if (err != 0) return err;
  const int blocks = persistent_blocks(k3_rows_in_mma_kernel, in_bytes, row_tiles, 1 << 30);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  k3_rows_in_mma_kernel<<<blocks, kThreads, in_bytes, stream>>>(x, ln_g, ln_b, win, bin, ws, bs,
                                                                g, x2, BW, V, C, K, has_ln);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  err = chunk == 128 ? launch_toeplitz_mma<128>(g, x2, m, BW, V, C, stream)
                     : launch_toeplitz_mma<64>(g, x2, m, BW, V, C, stream);
  if (err != 0) return err;
  k3_rows_out_mma_kernel<<<row_tiles, kThreads, out_bytes, stream>>>(g, x, wo, bo, out, BW, V, C,
                                                                     has_ln);
  return (int)cudaGetLastError();
}

int launch_f32(const float* x, const float* ln_g, const float* ln_b, const float* win,
               const float* bin, const float* ws, const float* bs, const float* m,
               const float* wo, const float* bo, float* out, float* g, float* x2, int BW, int V,
               int C, int K, int chunk, int has_ln, cudaStream_t stream) {
  const int n = V / chunk;
  const unsigned row_tiles = (unsigned)((size_t)BW * V / kRowTile);
  const size_t in_bytes = rows_in_layout(C, 4).bytes;
  const size_t tp_bytes = toeplitz_layout(n, chunk, 4, false).off_m +
                          align128((size_t)kMSlice * (chunk + 4) * 4);
  const size_t out_bytes = rows_out_f32_layout(C).bytes;
  int err = prepare(k3_rows_in_f32_kernel, in_bytes);
  if (err == 0) err = prepare(k3_toeplitz_f32_kernel, tp_bytes);
  if (err == 0) err = prepare(k3_rows_out_f32_kernel, out_bytes);
  if (err != 0) return err;
  k3_rows_in_f32_kernel<<<row_tiles, kThreads, in_bytes, stream>>>(x, ln_g, ln_b, win, bin, ws,
                                                                   bs, g, x2, BW, V, C, K, has_ln);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const dim3 groups((unsigned)((BW + kWindowGroup - 1) / kWindowGroup), (unsigned)C);
  k3_toeplitz_f32_kernel<<<groups, kThreads, tp_bytes, stream>>>(g, x2, m, BW, V, C, chunk);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  k3_rows_out_f32_kernel<<<row_tiles, kThreads, out_bytes, stream>>>(g, x, wo, bo, out, BW, V, C,
                                                                     has_ln);
  return (int)cudaGetLastError();
}

}  // namespace lcbi

// x, out: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); win: (C, 3C), wo:
// (C, C) and m: (V / chunk, C, chunk, chunk) in T; bin, bs: (3C,), ws: (K, 3C)
// fp32; bo: (C,) and, if has_ln, ln_g, ln_b: (C,), fp32; every operand at its
// true C. gbuf: C * BW * V of T and x2buf: C * BW * V fp32, scratch. V % 64
// == 0, chunk 64 or 128 dividing V, V / chunk <= 512 / chunk, 0 < C <= 192, 1
// <= K <= 16, all pointers 16-byte aligned. Returns cudaGetLastError() of the
// launches.
extern "C" int lcbi_hyena_chunked_fwd(const void* x, const void* ln_g, const void* ln_b,
                                      const void* win, const void* bin, const void* ws,
                                      const void* bs, const void* m, const void* wo,
                                      const void* bo, void* out, void* gbuf, void* x2buf, int BW,
                                      int V, int C, int K, int chunk, int has_ln, int is_bf16,
                                      void* stream) {
  (void)cudaGetLastError();
  if (BW <= 0 || V <= 0 || V > 512 || V % lcbi::kRowTile != 0 || (chunk != 64 && chunk != 128) ||
      V % chunk != 0 || C <= 0 || C > 192 || K < 1 || K > lcbi::kMaxTaps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using lcbi::bf16;
  if (is_bf16)
    return lcbi::launch_bf16(
        static_cast<const bf16*>(x), static_cast<const float*>(ln_g),
        static_cast<const float*>(ln_b), static_cast<const bf16*>(win),
        static_cast<const float*>(bin), static_cast<const float*>(ws),
        static_cast<const float*>(bs), static_cast<const bf16*>(m), static_cast<const bf16*>(wo),
        static_cast<const float*>(bo), static_cast<bf16*>(out), static_cast<bf16*>(gbuf),
        static_cast<float*>(x2buf), BW, V, C, K, chunk, has_ln, s);
  return lcbi::launch_f32(
      static_cast<const float*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const float*>(win),
      static_cast<const float*>(bin), static_cast<const float*>(ws),
      static_cast<const float*>(bs), static_cast<const float*>(m), static_cast<const float*>(wo),
      static_cast<const float*>(bo), static_cast<float*>(out), static_cast<float*>(gbuf),
      static_cast<float*>(x2buf), BW, V, C, K, chunk, has_ln, s);
}
