// Shared device code of the chunked Hyena mixer K3 (hyena_chunked.cu,
// hyena_chunked_bwd.cu), for windows of 64 < V <= 512 tokens (V % 64 == 0):
//     out = [x +] out_proj(x2 * L(x1 * v)),  [x1 | x2 | v] = shortconv(in_proj([LN](x)))
// where L is the causal V-tap long conv, run as block-Toeplitz products over
// chunks of `chunk` tokens: vl_chunk[q] = sum_{d <= q} g_chunk[q - d] @ M[d]
// per channel, with M (n, C, chunk, chunk) built by the wrapper.
//
// One 512-token window does not fit in shared memory the way K1's windows do
// (x alone is 196 KB at C = 192 in bf16, the 3C-wide projection 1.2 MB in
// fp32). The work splits where the math allows it: in_proj, the short conv
// and the gates act per token row with a halo of K - 1 rows (row-tile
// kernels, 64 tokens a tile); the long conv acts per channel across a whole
// window (channel kernels, here). Between them the per-channel streams (g,
// x2, v2, dvl, ...) go through global memory in a channel-major layout (C,
// BW, V), in which one channel of one window is V contiguous values: the
// row-tile kernels write and read it in runs of a tile's tokens, the channel
// kernels in whole rows.
#pragma once

#include "common.cuh"

namespace lcbi {

constexpr int kChunkChannels = 32;   // channels per row-tile column chunk
constexpr int kRowTile = 64;         // tokens per row tile (V % 64 == 0)
constexpr int kWindowGroup = 16;     // windows per channel-kernel block (a WMMA edge)
constexpr int kMaxTaps = 16;

// A channel kernel's shared memory: the group's g rows (gs, ld ldg, in T)
// and the fp32 sums (acc, ld lda); the backward's also one Toeplitz block
// M[d][c] (ms, ld chunk + 8, in T) and the dvl rows (dvs, ld ldg, in T).
struct ToeplitzLayout {
  int ldg, lda;
  size_t off_acc, off_m, off_dv, bytes;
};

__host__ __device__ inline ToeplitzLayout toeplitz_layout(int n, int chunk, int elem, bool bwd) {
  ToeplitzLayout L;
  const size_t rows = (size_t)n * kWindowGroup;
  L.ldg = chunk + 8;
  L.lda = chunk + 4;
  L.off_acc = align128(rows * L.ldg * elem);
  L.off_m = L.off_acc + align128(rows * L.lda * 4);
  L.off_dv = L.off_m + align128((size_t)chunk * (chunk + 8) * elem);
  L.bytes = bwd ? L.off_dv + align128(rows * L.ldg * elem) : L.off_m;
  return L;
}

// Channel kernels, one block per (group of 16 windows, channel c): the
// group's g rows in shared memory chunk-major (row q * 16 + b is chunk q of
// window b), so that for chunk distance d the inputs are rows [0, (n-d)16)
// and the outputs rows [d * 16, n * 16): one product each, K = chunk.
template <typename T>
__device__ void load_group_rows(const T* __restrict__ src, int c, int w0, int nw, int BW, int V,
                                int n, int chunk, T* dst, int ld) {
  const size_t base = (size_t)c * BW * V + (size_t)w0 * V;
  for (int i = threadIdx.x; i < n * kWindowGroup * chunk; i += kThreads) {
    const int row = i / chunk, r = i % chunk;
    const int q = row / kWindowGroup, b = row % kWindowGroup;
    dst[(size_t)row * ld + r] = b < nw ? src[base + (size_t)b * V + q * chunk + r] : from_f32<T>(0.f);
  }
}

}  // namespace lcbi
