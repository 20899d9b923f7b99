// The whole-window path's attention core, shared by K8's forward
// (window_attention.cu wattn_whole_fwd_kernel) and backward
// (window_attention_bwd.cu wattn_whole_bwd_kernel): one warp owns one (head,
// window) item of V = 16, 32, 48 or 64 tokens at a head dim D = KD of 16, 32
// or 64 (window_attention.cuh whole_window_path), bf16.
//
//   - Its (V, KD) tiles of the projection streams arrive by cp.async 16-byte
//     copies into the warp's own shared memory (whole_tile_async), the next
//     item's while this one computes where two buffers fit.
//   - Per 16 query rows, s = q k^T on mma.sync.m16n8k16 fragments
//     (whole_scores); the bias rel[h] log2(e) and the region-id mask are
//     added on the fragments and the base-2 softmax runs over the V keys in
//     the warp's registers, each row's max and sum by two shuffles
//     (whole_softmax). The forward and the backward call the same two
//     functions on the same streams, so the backward's p is the forward's.
//   - p (and in the backward ds) is rounded to bf16 once, as A fragments,
//     for products with a (V, KD) tile (whole_rows_times).
// No block barrier: a warp shares nothing with the other warps of its block.
#pragma once

#include <type_traits>

#include "window_attention_mma.cuh"

namespace lcbi {

template <int N> using Ic = std::integral_constant<int, N>;

// f(Ic<NQ>, Ic<KD>) at the whole-window path's V = 16 NQ and D = KD.
template <class F> int whole_dispatch(int V, int D, F&& f) {
  auto by_d = [&](auto nq) {
    switch (D) {
      case 16: return f(nq, Ic<16>{});
      case 32: return f(nq, Ic<32>{});
      default: return f(nq, Ic<64>{});
    }
  };
  switch (V / 16) {
    case 1: return by_d(Ic<1>{});
    case 2: return by_d(Ic<2>{});
    case 3: return by_d(Ic<3>{});
    default: return by_d(Ic<4>{});
  }
}

// The (V, KD) tile of one head of a window from a token-major stream (row r
// at src + r ld) into dst (ld KD + 8), 16 bytes a cp.async copy (C % 16 ==
// 0: every head's row is 16-byte aligned); the warp's lanes share it.
template <int V, int KD>
__device__ __forceinline__ void whole_tile_async(bf16* dst, const bf16* __restrict__ src,
                                                 size_t ld, int lane) {
  constexpr int kCh = KD / 8, kLd = KD + 8;
  for (int e = lane; e < V * kCh; e += 32) {
    const int r = e / kCh, c = (e % kCh) * 8;
    cp_async16(smem_addr(dst + r * kLd + c), src + (size_t)r * ld + c, 16);
  }
}

// s = q k^T for the query rows [16 qt, 16 qt + 16) against the V keys, as
// fp32 accumulator fragments (8 columns each); Q (q scale log2(e)) and K are
// the item's (V, KD) tiles (ld KD + 8).
template <int V, int KD>
__device__ __forceinline__ void whole_scores(float (&sc)[V / 8][4], const bf16* Q, const bf16* K,
                                             int qt, int lane) {
  constexpr int kLd = KD + 8;
#pragma unroll
  for (int nt = 0; nt < V / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    uint32_t qa[4];
    frag_a(qa, Q, kLd, qt * 16, kk * 16, lane);
#pragma unroll
    for (int n2 = 0; n2 < V / 16; ++n2) {
      uint32_t bk[4];
      frag_b_rows(bk, K, kLd, n2 * 16, kk * 16, lane);
      mma_bf16(sc[2 * n2], qa, bk[0], bk[1]);
      mma_bf16(sc[2 * n2 + 1], qa, bk[2], bk[3]);
    }
  }
}

// s += rel[h] log2(e) + (region ids differ ? mask2 : 0), then p = exp2(s -
// max) / sum over the V keys, in place, in base 2 as the TPU kernel: the
// lane's rows are i0 and i0 + 8 (i0 = 16 qt + lane / 4), its columns 8 nt +
// 2 t and + 1 (t = lane % 4). relh: rel[h] (V, V) fp32; rr: the window's
// region ids, or nullptr.
template <int V>
__device__ __forceinline__ void whole_softmax(float (&sc)[V / 8][4], const float* __restrict__ relh,
                                              const int* __restrict__ rr, int i0, int t,
                                              float mask2) {
  int rq[2] = {0, 0};
  if (rr != nullptr) {
    rq[0] = rr[i0];
    rq[1] = rr[i0 + 8];
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < V / 8; ++nt) {
    const int j = nt * 8 + 2 * t;
    int rk[2] = {0, 0};
    if (rr != nullptr) {
      rk[0] = rr[j];
      rk[1] = rr[j + 1];
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float2 bb = *reinterpret_cast<const float2*>(relh + (i0 + 8 * h2) * V + j);
      float v0 = sc[nt][2 * h2] + bb.x * kLog2e, v1 = sc[nt][2 * h2 + 1] + bb.y * kLog2e;
      if (rr != nullptr) {
        v0 += rq[h2] != rk[0] ? mask2 : 0.f;
        v1 += rq[h2] != rk[1] ? mask2 : 0.f;
      }
      sc[nt][2 * h2] = v0;
      sc[nt][2 * h2 + 1] = v1;
      mx[h2] = fmaxf(mx[h2], fmaxf(v0, v1));
    }
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
    mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
    float l = 0.f;
#pragma unroll
    for (int nt = 0; nt < V / 8; ++nt) {
      sc[nt][2 * h2] = fast_exp2(sc[nt][2 * h2] - mx[h2]);
      sc[nt][2 * h2 + 1] = fast_exp2(sc[nt][2 * h2 + 1] - mx[h2]);
      l += sc[nt][2 * h2] + sc[nt][2 * h2 + 1];
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float il = 1.f / l;
#pragma unroll
    for (int nt = 0; nt < V / 8; ++nt) {
      sc[nt][2 * h2] *= il;
      sc[nt][2 * h2 + 1] *= il;
    }
  }
}

// acc = a B for 16 rows: a the (16, V) bf16 A fragments of a row block (p
// or ds, rounded once), B a (V, KD) tile (ld KD + 8) with the keys on its
// rows; acc as fp32 accumulator fragments (8 columns each).
template <int V, int KD>
__device__ __forceinline__ void whole_rows_times(float (&acc)[KD / 8][4],
                                                 const uint32_t (&a)[V / 16][4], const bf16* Bt,
                                                 int lane) {
#pragma unroll
  for (int dt = 0; dt < KD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < V / 16; ++kk)
#pragma unroll
    for (int d2 = 0; d2 < KD / 16; ++d2) {
      uint32_t bf[4];
      frag_b_cols(bf, Bt, KD + 8, kk * 16, d2 * 16, lane);
      mma_bf16(acc[2 * d2], a[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * d2 + 1], a[kk], bf[2], bf[3]);
    }
}

}  // namespace lcbi
