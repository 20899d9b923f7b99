// Gradient of the Toeplitz blocks of the chunked Hyena mixer K3:
//     dM[d][c, j, r] = sum over windows w and chunks q >= d of
//                      g[c, w, (q - d) * chunk + j] * dvl[c, w, q * chunk + r]
// from the streams g and dvl (T, channel-major (C, BW, V)) that the K3
// backward writes.
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/hyena_window.py
// _dm_reduce_pallas (called by _bwd_impl_chunked in the default `stream` mode).
//
// What bounds it on the H100: per (d, c) a chunk x chunk product with a deep
// K = BW * (n - d) chunk rows, 2 * C * chunk^2 * BW * n(n+1)/2 FLOPs in all
// (emb stage 0: 129 GFLOP, 0.13 ms at 989 TFLOP/s) against the two streams
// read once (0.8 GB, 0.24 ms at 3.35 TB/s): bytes. The TPU kernel sums over
// its sequential grid into one VMEM block. Here a block per (split s,
// distance d, channel c) walks its share of the windows as one deep-K
// product: row k of its depth axis is chunk q = k % (n - d) of window
// w_begin + k / (n - d), A's row that chunk of g and B's row the chunk of dvl
// d chunks later, both gathered row by row straight from the streams. In
// bf16 the product is mma_gemm.cuh's tile loop (mma.sync fragments fed by a
// cp.async ring; a 128 x 128 tile, chunk x chunk of it stored); in fp32 a
// 64 x 64 tile of 4 x 4 register blocks per thread (FMA, full fp32). Each
// block writes its partial once, and reduce_slots_kernel sums the S partials
// in a fixed order. No atomics, so two launches give the same bits.
#include "mma_gemm.cuh"

namespace lcbi {

constexpr int kDmF32Tile = 64;
constexpr int kDmF32Ld = kDmF32Tile + 4;

// Row k of the block's depth axis: the chunk of (window, chunk index) in
// channel c's stream, as an element offset.
__device__ __forceinline__ size_t dm_row(long long k, int nr, int w_begin, int c, int BW, int V,
                                         int chunk) {
  const long long w = w_begin + k / nr;
  return ((size_t)c * BW + (size_t)w) * V + (size_t)(k % nr) * chunk;
}

// bf16: grid (S, n, C).
__global__ void __launch_bounds__(kThreads)
hyena_dm_mma_kernel(const bf16* __restrict__ g, const bf16* __restrict__ dvl,
                    float* __restrict__ partials, int BW, int V, int C, int chunk, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int s = blockIdx.x, d = blockIdx.y, c = blockIdx.z;
  const int n = V / chunk, nr = n - d;
  const int w_begin = (int)((long long)BW * s / S), w_end = (int)((long long)BW * (s + 1) / S);
  const long long depth = (long long)(w_end - w_begin) * nr;
  const size_t shift = (size_t)d * chunk;
  constexpr int kPer = kMmaTile / 8;   // 16-byte copies of a slice row
  // a slice: rows [k0, k0 + 32) of the depth axis, all chunk columns of A
  // and B (the tile's columns past chunk zero)
  auto prefetch = [&](int i, bf16* a, bf16* b) {
    const long long k0 = (long long)i * kMmaDepth;
    for (int e = threadIdx.x; e < kMmaDepth * kPer; e += kThreads) {
      const int r = e / kPer, col = (e % kPer) * 8;
      const long long k = k0 + r;
      const bool live = k < depth && col < chunk;
      const size_t at = live ? dm_row(k, nr, w_begin, c, BW, V, chunk) + col : 0;
      cp_async16(smem_addr(a + r * kMmaLdT + col), g + at, live ? 16 : 0);
      cp_async16(smem_addr(b + r * kMmaLdT + col), dvl + at + (live ? shift : 0), live ? 16 : 0);
    }
  };
  float* out = partials + (((size_t)s * n + d) * C + c) * chunk * chunk;
  mma_tile_run<true, false>(prefetch, ceil_div(depth, kMmaDepth), 0, 0, chunk, chunk, out, chunk,
                            smem);
}

// fp32: grid (S, n * tiles, C), tiles = (chunk / 64)^2 output tiles of 64 x
// 64; thread (ty, tx) of 16 x 16 owns rows 4 ty .. and columns 4 tx .. of it.
__global__ void __launch_bounds__(kThreads)
hyena_dm_f32_kernel(const float* __restrict__ g, const float* __restrict__ dvl,
                    float* __restrict__ partials, int BW, int V, int C, int chunk, int S) {
  __shared__ __align__(16) float As[kMmaDepth * kDmF32Ld];
  __shared__ __align__(16) float Bs[kMmaDepth * kDmF32Ld];
  const int tpr = chunk / kDmF32Tile, tiles = tpr * tpr;
  const int s = blockIdx.x, d = blockIdx.y / tiles, tile = blockIdx.y % tiles, c = blockIdx.z;
  const int m0 = (tile / tpr) * kDmF32Tile, n0 = (tile % tpr) * kDmF32Tile;
  const int n = V / chunk, nr = n - d;
  const int w_begin = (int)((long long)BW * s / S), w_end = (int)((long long)BW * (s + 1) / S);
  const long long depth = (long long)(w_end - w_begin) * nr;
  const size_t shift = (size_t)d * chunk;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (long long k0 = 0; k0 < depth; k0 += kMmaDepth) {
    for (int e = threadIdx.x; e < kMmaDepth * (kDmF32Tile / 4); e += kThreads) {
      const int r = e / (kDmF32Tile / 4), q = (e % (kDmF32Tile / 4)) * 4;
      const long long k = k0 + r;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (k < depth) {
        const size_t at = dm_row(k, nr, w_begin, c, BW, V, chunk);
        a = *reinterpret_cast<const float4*>(g + at + m0 + q);
        b = *reinterpret_cast<const float4*>(dvl + at + shift + n0 + q);
      }
      *reinterpret_cast<float4*>(As + r * kDmF32Ld + q) = a;
      *reinterpret_cast<float4*>(Bs + r * kDmF32Ld + q) = b;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kMmaDepth; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(As + kk * kDmF32Ld + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(Bs + kk * kDmF32Ld + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = partials + (((size_t)s * n + d) * C + c) * chunk * chunk;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + (size_t)(m0 + 4 * ty + i) * chunk + n0 + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

template <typename T>
int launch_dm(const void* g, const void* dvl, float* partials, float* dm, int BW, int V, int C,
              int chunk, int S, cudaStream_t stream) {
  const int n = V / chunk;
  if constexpr (sizeof(T) == 2) {
    constexpr size_t bytes = product_smem<bf16>();
    cudaError_t err = cudaFuncSetAttribute(hyena_dm_mma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    hyena_dm_mma_kernel<<<dim3((unsigned)S, (unsigned)n, (unsigned)C), kThreads, bytes, stream>>>(
        static_cast<const bf16*>(g), static_cast<const bf16*>(dvl), partials, BW, V, C, chunk, S);
  } else {
    const int tiles = (chunk / kDmF32Tile) * (chunk / kDmF32Tile);
    const dim3 grid((unsigned)S, (unsigned)(n * tiles), (unsigned)C);
    hyena_dm_f32_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(g), static_cast<const float*>(dvl), partials, BW, V, C, chunk, S);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partials, S, (size_t)n * C * chunk * chunk, dm, stream);
}

}  // namespace lcbi

// g, dvl: (C, BW, V) in T (fp32 if is_bf16 == 0, else bf16). partials:
// S x (V / chunk) x C x chunk x chunk fp32 scratch; dm: (V / chunk, C, chunk,
// chunk) fp32. chunk 64 or 128 dividing V, 1 <= S <= BW, all pointers 32-byte
// aligned. Returns cudaGetLastError() of the launches.
extern "C" int lcbi_hyena_dm(const void* g, const void* dvl, void* partials, void* dm, int BW,
                             int V, int C, int chunk, int S, int is_bf16, void* stream) {
  (void)cudaGetLastError();
  if (BW <= 0 || C <= 0 || C > 65535 || (chunk != 64 && chunk != 128) || V <= 0 ||
      V % chunk != 0 || V / chunk > 64 || S < 1 || S > BW || S > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  float* out = static_cast<float*>(dm);
  if (is_bf16)
    return lcbi::launch_dm<__nv_bfloat16>(g, dvl, p, out, BW, V, C, chunk, S, s);
  return lcbi::launch_dm<float>(g, dvl, p, out, BW, V, C, chunk, S, s);
}
