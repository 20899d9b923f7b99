// Dense products of the backwards: a row-tiled product into fp32 (K2's and
// K4's, fused_mlp_bwd.cu and mamba_window_bwd.cu) and the split-K weight
// gradients (theirs, and K1's and K8's through wgrad.cuh), both over (rows,
// width) streams in T.
//
//   gemm_rows:  out[m][n] = sum_k A[m][k] B(k, n)          (fp32 out, K the width)
//               A (M, K) row-major; B stored (N, K) ("NT", B^T read: x @ W^T
//               for a W that maps n -> k) or (K, N) ("NN", x @ W).
//   wgrad:      out[m][n] = sum_r A[r][m] B[r][n]           (fp32 partials)
//               over the rows r of one of S splits; A (rows, M), B (rows, N)
//               row-major streams (or A stored (M, rows), a channel-major
//               stream: a_mk); up to kMaxProducts products in one grid;
//               reduce_slots_kernel then sums the S partials in a fixed order.
//
// What bounds them on the H100: the tensor cores. A product of M x N x K moves
// (M K + K N) T in and M N fp32 out, far fewer bytes than its 2 M N K
// operations at the widths of the models (C >= 24, rows >= 16k).
//
// bf16: a block of 8 warps computes a 128 x 128 output tile, each warp 64 x
// 32 of it in registers (16 mma.sync.m16n8k16 fragments of fp32 sums). The
// operands come through a three-stage ring of 32-deep slices in shared
// memory, filled by cp.async 16-byte copies (rows padded by 16 bytes so that
// ldmatrix phases fall in distinct banks); a slice whose 16-byte chunk runs
// past the operand's edge, or an operand whose rows are not 16-byte aligned,
// is copied element by element with zeros past the edge, so any M, N, K and
// any leading dimension work and no operand is ever padded by the caller.
// A transposed operand (the weight gradients' A^T, an NN product's B) reads
// its fragments with ldmatrix.trans.
//
// fp32 (the tests' path): 64 x 64 tiles in shared memory, summed by the FMA
// loops of common.cuh (full fp32, no TF32).
//
// No atomics: every output element is written once per split by one thread,
// and the splits are summed in order, so two launches give the same bits.
#pragma once

#include "flash_attention.cuh"  // mma.sync, ldmatrix, cp.async helpers

namespace lcbi {

constexpr int kMmaTile = 128;   // bf16 output tile (both axes)
constexpr int kMmaDepth = 32;   // depth of a staged slice
constexpr int kMmaStages = 3;
constexpr int kMmaLdK = kMmaDepth + 8;   // (tile, depth) slices: k contiguous
constexpr int kMmaLdT = kMmaTile + 8;    // (depth, tile) slices: m or n contiguous
constexpr int kF32Tile = 64;     // fp32 output tile
constexpr int kF32Depth = 32;
constexpr int kMaxProducts = 4;

__host__ __device__ __forceinline__ int ceil_div(long long a, int b) {
  return (int)((a + b - 1) / b);
}

// One product of a launch: A and B with their leading dimensions (elements),
// the output's M x N, and where its fp32 result starts in each split's block
// of partials (or, for gemm_rows, in out). a_mk (wgrad only): A is stored
// (M, rows) instead of (rows, M).
template <typename T> struct Product {
  const T* A;
  const T* B;
  int lda, ldb, M, N;
  size_t out_off;
  bool a_mk = false;
};

template <typename T> struct Products {
  Product<T> p[kMaxProducts];
  int count;
  int tile_start[kMaxProducts + 1];  // first output tile of each product
};

// 16 bytes of a row-major operand at (row, col) of a (rows, cols) matrix with
// leading dimension ld into shared memory at dst: a cp.async where the whole
// chunk lies inside and vec (ld and the base 16-byte aligned), zeros where it
// lies wholly outside, else element by element (zeros past the edge).
__device__ __forceinline__ void stage16(bf16* dst, const bf16* __restrict__ src, long long row,
                                        long long rows, int col, int cols, int ld, bool vec) {
  if (row >= rows || col >= cols) {
    cp_async16(smem_addr(dst), src, 0);
  } else if (vec && col + 8 <= cols) {
    cp_async16(smem_addr(dst), src + (size_t)row * ld + col, 16);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = col + 2 * i;
      const float lo = c < cols ? __bfloat162float(src[(size_t)row * ld + c]) : 0.f;
      const float hi = c + 1 < cols ? __bfloat162float(src[(size_t)row * ld + c + 1]) : 0.f;
      w[i] = pack_bf16(lo, hi);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A (kMmaDepth x kMmaTile) slice, rows [r0, r0 + kMmaDepth) and columns [c0,
// c0 + kMmaTile), of a row-major (rows, cols) operand, into dst (ld kMmaLdT);
// or, with kDeep, a (kMmaTile x kMmaDepth) slice, rows [r0, r0 + kMmaTile) and
// columns [c0, c0 + kMmaDepth), into dst (ld kMmaLdK). Rows past r_end count
// as outside.
template <bool kDeep>
__device__ __forceinline__ void stage_slice(bf16* dst, const bf16* __restrict__ src, int ld,
                                            long long r0, long long r_end, int c0, int cols,
                                            bool vec) {
  constexpr int kRows = kDeep ? kMmaTile : kMmaDepth, kCols = kDeep ? kMmaDepth : kMmaTile;
  constexpr int kLd = kDeep ? kMmaLdK : kMmaLdT, kPer = kCols / 8;
  for (int e = threadIdx.x; e < kRows * kPer; e += kThreads) {
    const int r = e / kPer, c = (e % kPer) * 8;
    stage16(dst + r * kLd + c, src, r0 + r, r_end, c0 + c, cols, ld, vec);
  }
}

// A fragments (16 x 16) of rows [m0, m0 + 16) and depth [k0, k0 + 16) of an
// operand staged transposed, (depth, m) row-major with leading dimension ld.
__device__ __forceinline__ void frag_a_trans(uint32_t (&a)[4], const bf16* tile, int ld, int k0,
                                             int m0, int lane) {
  ldsm_x4_trans(a, smem_addr(tile + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * ld + m0 +
                             ((lane >> 3) & 1) * 8));
}

// The bf16 block's loop: a 128 x 128 output tile at (m0, n0) from nk slices
// of depth kMmaDepth, which prefetch(i, a, b) stages (cp.async, committed by
// the loop) into the ring's slots a and b; its fp32 sums leave through
// store(row, col, v0, v1), v0 at (row, col) and v1 at (row, col + 1), for
// every row below M and even col below N (col + 1 may be N). A_T: A's slices
// are (depth, M) (the weight gradients' A^T); else (M, depth). B_NK: B's are
// (N, depth); else (depth, N).
template <bool A_T, bool B_NK, class Prefetch, class Store>
__device__ void mma_tile_run(Prefetch prefetch, int nk, int m0, int n0, int M, int N, Store store,
                             unsigned char* smem) {
  constexpr int kAsz = A_T ? kMmaDepth * kMmaLdT : kMmaTile * kMmaLdK;
  constexpr int kBsz = B_NK ? kMmaTile * kMmaLdK : kMmaDepth * kMmaLdT;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kMmaStages * kAsz;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;   // warp tile 64 x 32

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < nk) prefetch(s, As + s * kAsz, Bs + s * kBsz);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    if (i + kMmaStages - 1 < nk) {
      const int slot = (i + kMmaStages - 1) % kMmaStages;
      prefetch(i + kMmaStages - 1, As + slot * kAsz, Bs + slot * kBsz);
    }
    cp_async_commit();
    const bf16* a = As + (i % kMmaStages) * kAsz;
    const bf16* b = Bs + (i % kMmaStages) * kBsz;
#pragma unroll
    for (int kk = 0; kk < kMmaDepth; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (A_T) {
          frag_a_trans(af[mi], a, kMmaLdT, kk, wm * 64 + mi * 16, lane);
        } else {
          frag_a(af[mi], a, kMmaLdK, wm * 64 + mi * 16, kk, lane);
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t bf[4];
        if (B_NK) {
          frag_b_rows(bf, b, kMmaLdK, wn * 32 + p * 16, kk, lane);
        } else {
          frag_b_cols(bf, b, kMmaLdT, kk, wn * 32 + p * 16, lane);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][2 * p], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * p + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free for the block's next tile

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int col = n0 + wn * 32 + nj * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mi * 16 + g + 8 * h;
        if (row < M && col < N) store(row, col, acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      }
    }
  }
}

// The store of a tile into out (fp32, leading dimension ldo, N columns): a
// thread's two neighbouring columns go as one 8-byte store where the rows
// keep 8-byte alignment.
struct F32Store {
  float* out;
  int ldo, N;
  bool pair;
  __device__ F32Store(float* o, int ld, int n)
      : out(o), ldo(ld), N(n), pair(ld % 2 == 0 && reinterpret_cast<size_t>(o) % 8 == 0) {}
  __device__ void operator()(int row, int col, float v0, float v1) const {
    float* o = out + (size_t)row * ldo;
    if (pair && col + 1 < N) {
      *reinterpret_cast<float2*>(o + col) = make_float2(v0, v1);
      return;
    }
    o[col] = v0;
    if (col + 1 < N) o[col + 1] = v1;
  }
};

// The same loop into out (fp32, leading dimension ldo).
template <bool A_T, bool B_NK, class Prefetch>
__device__ void mma_tile_run(Prefetch prefetch, int nk, int m0, int n0, int M, int N,
                             float* __restrict__ out, int ldo, unsigned char* smem) {
  mma_tile_run<A_T, B_NK>(prefetch, nk, m0, n0, M, N, F32Store(out, ldo, N), smem);
}

// The bf16 block of a product: a 128 x 128 output tile at (m0, n0) from depth
// [k_begin, k_end), stored through store (mma_tile_run). A_T: A is stored
// (depth, M) (the weight gradients' A^T); else (M, depth). B_NK: B is stored
// (N, depth); else (depth, N). The depth axis of an operand stored (depth,
// width) is its row axis: for A_T and !B_NK a depth index is a row of the
// stream.
template <bool A_T, bool B_NK, class Store>
__device__ void mma_tile(const Product<bf16>& pr, long long k_begin, long long k_end, int m0,
                         int n0, Store store, unsigned char* smem) {
  const bool avec = pr.lda % 8 == 0 && reinterpret_cast<size_t>(pr.A) % 16 == 0;
  const bool bvec = pr.ldb % 8 == 0 && reinterpret_cast<size_t>(pr.B) % 16 == 0;
  auto prefetch = [&](int i, bf16* a, bf16* b) {
    const long long k0 = k_begin + (long long)i * kMmaDepth;
    if (A_T) {
      stage_slice<false>(a, pr.A, pr.lda, k0, k_end, m0, pr.M, avec);
    } else {
      // rows m of A, depth columns [k0, k0 + 32): the depth is A's column
      // axis, bounded by k_end (gemm_rows runs one split, k_begin = 0)
      stage_slice<true>(a, pr.A, pr.lda, m0, pr.M, (int)k0, (int)k_end, avec);
    }
    if (B_NK) {
      stage_slice<true>(b, pr.B, pr.ldb, n0, pr.N, (int)k0, (int)k_end, bvec);
    } else {
      stage_slice<false>(b, pr.B, pr.ldb, k0, k_end, n0, pr.N, bvec);
    }
  };
  mma_tile_run<A_T, B_NK>(prefetch, ceil_div(k_end - k_begin, kMmaDepth), m0, n0, pr.M, pr.N,
                          store, smem);
}

// The same block into out (fp32, leading dimension ldo).
template <bool A_T, bool B_NK>
__device__ void mma_tile(const Product<bf16>& pr, long long k_begin, long long k_end, int m0,
                         int n0, float* __restrict__ out, int ldo, unsigned char* smem) {
  mma_tile<A_T, B_NK>(pr, k_begin, k_end, m0, n0, F32Store(out, ldo, pr.N), smem);
}

// The fp32 block: a 64 x 64 tile, operands staged whole per 32-deep slice in
// shared memory, summed by common.cuh's FMA gemm into an fp32 tile.
template <bool A_T, bool B_NK>
__device__ void f32_tile(const Product<float>& pr, long long k_begin, long long k_end, int m0,
                         int n0, float* __restrict__ out, int ldo, unsigned char* smem) {
  constexpr int kLdA = A_T ? kF32Tile + 4 : kF32Depth + 4;   // staged as stored
  constexpr int kLdB = B_NK ? kF32Depth + 4 : kF32Tile + 4;
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + (A_T ? kF32Depth : kF32Tile) * kLdA;
  float* acc = Bs + (B_NK ? kF32Tile : kF32Depth) * kLdB;
  constexpr int kLdC = kF32Tile + 4;
  bool started = false;
  for (long long k0 = k_begin; k0 < k_end; k0 += kF32Depth) {
    for (int e = threadIdx.x; e < kF32Tile * kF32Depth; e += kThreads) {
      const int w = e / kF32Depth, d = e % kF32Depth;   // width index, depth index
      const long long k = k0 + d;
      const bool kin = k < k_end;
      // A(m0 + w, k) and B(k, n0 + w)
      float a = 0.f, b = 0.f;
      if (kin && m0 + w < pr.M)
        a = A_T ? pr.A[(size_t)k * pr.lda + m0 + w] : pr.A[(size_t)(m0 + w) * pr.lda + k];
      if (kin && n0 + w < pr.N)
        b = B_NK ? pr.B[(size_t)(n0 + w) * pr.ldb + k] : pr.B[(size_t)k * pr.ldb + n0 + w];
      if (A_T) As[d * kLdA + w] = a; else As[w * kLdA + d] = a;
      if (B_NK) Bs[w * kLdB + d] = b; else Bs[d * kLdB + w] = b;
    }
    __syncthreads();
    gemm<A_T, B_NK>(acc, kLdC, As, kLdA, Bs, kLdB, kF32Tile, kF32Tile, kF32Depth, started);
    __syncthreads();
    started = true;
  }
  for (int e = threadIdx.x; e < kF32Tile * kF32Tile; e += kThreads) {
    const int i = e / kF32Tile, j = e % kF32Tile;
    if (m0 + i < pr.M && n0 + j < pr.N)
      out[(size_t)(m0 + i) * ldo + n0 + j] = started ? acc[i * kLdC + j] : 0.f;
  }
  __syncthreads();
}

template <typename T> struct TileOf { static constexpr int v = kMmaTile; };
template <> struct TileOf<float> { static constexpr int v = kF32Tile; };

template <typename T, bool A_T, bool B_NK>
__device__ __forceinline__ void product_tile(const Product<T>& pr, long long k_begin,
                                             long long k_end, int m0, int n0, float* out, int ldo,
                                             unsigned char* smem) {
  if constexpr (sizeof(T) == 2) {
    mma_tile<A_T, B_NK>(pr, k_begin, k_end, m0, n0, out, ldo, smem);
  } else {
    f32_tile<A_T, B_NK>(pr, k_begin, k_end, m0, n0, out, ldo, smem);
  }
}

// gemm_rows: blockIdx.x walks the output tiles, columns fastest (the tiles of
// one row band read the same rows of A, which meet in L2). out (M, N) fp32,
// leading dimension N; K the depth.
template <typename T, bool B_NK>
__global__ void __launch_bounds__(kThreads)
gemm_rows_kernel(Product<T> pr, int K, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kTile = TileOf<T>::v;
  const int tn = ceil_div(pr.N, kTile);
  const long long tiles = (long long)ceil_div(pr.M, kTile) * tn;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x)
    product_tile<T, false, B_NK>(pr, 0, K, (int)(t / tn) * kTile, (int)(t % tn) * kTile,
                                 out + pr.out_off, pr.N, smem);
}

// wgrad: blockIdx.x is an output tile of one of the products, blockIdx.y the
// split s of the rows; split s writes its partial of every product at
// partials + s * total + out_off.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(Products<T> ps, long long rows, int S, size_t total, float* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kTile = TileOf<T>::v;
  int q = 0;
  while (q + 1 < ps.count && (int)blockIdx.x >= ps.tile_start[q + 1]) ++q;
  const Product<T>& pr = ps.p[q];
  const int t = blockIdx.x - ps.tile_start[q], tn = ceil_div(pr.N, kTile);
  const int s = blockIdx.y;
  long long r_begin = rows * s / S, r_end = rows * (s + 1) / S;
  if (pr.a_mk) {
    // the rows are A's columns: splits start on 16-byte boundaries
    r_begin &= ~7LL;
    if (s + 1 < S) r_end &= ~7LL;
  }
  float* out = partials + (size_t)s * total + pr.out_off;
  if (pr.a_mk) {
    product_tile<T, false, false>(pr, r_begin, r_end, (t / tn) * kTile, (t % tn) * kTile, out,
                                  pr.N, smem);
  } else {
    product_tile<T, true, false>(pr, r_begin, r_end, (t / tn) * kTile, (t % tn) * kTile, out,
                                 pr.N, smem);
  }
}

template <typename T> constexpr size_t product_smem() {
  if constexpr (sizeof(T) == 2) {
    // the larger of the two layouts of each operand's ring
    constexpr size_t a = kMmaTile * kMmaLdK > kMmaDepth * kMmaLdT ? kMmaTile * kMmaLdK
                                                                   : kMmaDepth * kMmaLdT;
    return 2 * kMmaStages * a * sizeof(bf16);
  } else {
    return (size_t)(2 * kF32Tile * (kF32Tile + 4) + kF32Tile * (kF32Tile + 4)) * sizeof(float);
  }
}

inline int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

// out (M, N) fp32 = A (M, K) @ B, B stored (N, K) if B_NK else (K, N).
template <typename T, bool B_NK>
int launch_gemm_rows(const T* A, int lda, const T* B, int ldb, int M, int N, int K, float* out,
                     cudaStream_t stream) {
  constexpr size_t bytes = product_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(gemm_rows_kernel<T, B_NK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int kTile = TileOf<T>::v;
  const long long tiles = (long long)ceil_div(M, kTile) * ceil_div(N, kTile);
  const int sms = device_sms();
  if (sms <= 0) return (int)cudaErrorInvalidValue;
  const long long grid = tiles < 65535LL * 16 ? tiles : 65535LL * 16;
  Product<T> pr{A, B, lda, ldb, M, N, 0};
  gemm_rows_kernel<T, B_NK><<<(unsigned)grid, kThreads, bytes, stream>>>(pr, K, out);
  return (int)cudaGetLastError();
}

// Output tiles of the products (the grid's x extent).
template <typename T> int wgrad_tiles(Products<T>& ps) {
  constexpr int kTile = TileOf<T>::v;
  int at = 0;
  for (int q = 0; q < ps.count; ++q) {
    ps.tile_start[q] = at;
    at += ceil_div(ps.p[q].M, kTile) * ceil_div(ps.p[q].N, kTile);
  }
  ps.tile_start[ps.count] = at;
  return at;
}

// Splits of the row axis for products of these output widths: enough blocks
// for about four per SM, each split at least 256 rows. 0 on a device query
// error.
inline int wgrad_splits_for(long long rows, long long tiles) {
  const int sms = device_sms();
  if (sms <= 0 || tiles <= 0) return 0;
  long long s = (4LL * sms + tiles - 1) / tiles;
  if (s > rows / 256) s = rows / 256;
  if (s > 65535) s = 65535;
  return (int)(s < 1 ? 1 : s);
}

// out[total] = sum over the S splits of the products' partials: each product
// q at out + out_off(q), (M_q, N_q) fp32. partials: S x total fp32 scratch.
template <typename T>
int launch_split_k(Products<T> ps, long long rows, int S, size_t total, float* partials,
                   float* out, cudaStream_t stream) {
  constexpr size_t bytes = product_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(wgrad_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = wgrad_tiles(ps);
  if (S < 1 || S > 65535 || tiles <= 0) return (int)cudaErrorInvalidValue;
  wgrad_kernel<T><<<dim3((unsigned)tiles, (unsigned)S), kThreads, bytes, stream>>>(
      ps, rows, S, total, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partials, S, total, out, stream);
}

}  // namespace lcbi
