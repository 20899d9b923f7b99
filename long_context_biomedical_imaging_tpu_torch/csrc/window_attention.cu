// Swin window attention K8, forward: per window of V tokens, H heads of D = C / H
// (any D; window_attention.cuh),
//     qkv = x Wqkv + bqkv (fp32 sums);  q | k | v head-major column blocks
//     s_h = (q_h scale) k_h^T + rel[h] + (region ids differ ? mask_value : 0)
//     o_h = softmax(s_h) v_h;  out = sum_h o_h Wout[hD:(h+1)D, :] + bout
// x, out: (BW, V, C) in T; Wqkv (C, 3C), Wout (C, C) in T; the biases and rel
// (H, V, V) fp32; rid (nW, V) int32 region ids, window w reading row w % nW.
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/window_attention.py
// _fwd_kernel (pallas_call in _call_fwd). Rounds where it rounds: q scale
// log2(e), k and v to T after the fp32 bias add, the probabilities to T
// before p v, o_h to T before the out projection; base-2 softmax.
//
// What bounds it on the H100: the projections, 8 T C^2 of the 8 T C^2 + 4 T V
// C operations of T tokens (ptx_attn stage 2: 1.2 MFLOP a token against
// 1.5 KB read and written), so operations. The TPU kernel fuses G windows
// into one block-diagonal sequence padded to 128 lanes; here every path runs
// as passes over streams: the q | k | v projection into device memory in T
// (the bias, and q scale log2(e) rounded once, in its epilogue), the
// attention per (head, window), and the out projection of o. Each pass is
// a kernel of its own shape, and nothing of a window crosses a block.
//
// The whole-window path (bf16; V = 16, 32, 48 or 64 at D = 16, 32 or 64 and
// C % 16 == 0: the ptx_attn windows): the projections are
// window_attention_mma.cuh proj_rows_kernel, the backward's own; the core,
// wattn_whole_fwd_kernel, gives each warp one (head, window) item on the
// code the backward's core shares (window_attention_whole.cuh): its q, k and
// v tiles by cp.async into the warp's shared memory with the next item's
// copies in flight, s = q k^T on mma.sync fragments, the bias and mask on
// the fragments, the base-2 softmax in registers (row max and sum by
// shuffles), p rounded once as the A fragments of o = p v, o_h stored in
// bf16 to the o stream; no block barrier. So the backward recomputes
// exactly this p from the same streams. The streams set its floor: about
// 20 T C bytes (x; qkv written and read; o written and read; out), above
// the operations' time at the ptx_attn widths; fusing the qkv projection
// into the core is later work.
//
// Every other shape, and fp32 everywhere, takes the general path: windows
// of other sizes up to 512 tokens and other head dims. In bf16 up to D = 128
// its attention is the kernels of window_attention_mma.cuh, designed for
// Hopper (a two-pass softmax on register-resident mma.sync fragments, the
// bias slice in shared memory over many windows, k and v through a
// cp.async ring); in fp32, and in bf16 above D = 128, the shared-memory
// kernels of window_attention.cuh (full score rows per query tile, D walked
// in chunks).
#include <algorithm>

#include "window_attention_whole.cuh"

namespace lcbi {

// The forward's core. A warp holds its item's q (scale log2(e)), k and v
// tiles (V x (KD + 8) bf16 each), in two buffers where they fit in 32 KB.
template <int NQ, int KD> struct WholeFwdCfg {
  static constexpr int kV = 16 * NQ;
  static constexpr int kTile = kV * (KD + 8);
  static constexpr int kStage = 3 * kTile;
  static constexpr int kBufs = 2 * kStage * 2 <= 32 * 1024 ? 2 : 1;
  static constexpr size_t kWarpBytes = ((size_t)kBufs * kStage * 2 + 127) / 128 * 128;
  static constexpr int kFit = (int)((200 * 1024) / kWarpBytes);
  static constexpr int kWarps = kFit < 1 ? 1 : kFit > 4 ? 4 : kFit;
  static constexpr int kThreads = 32 * kWarps;
};

// qkv: q scale log2(e) | k | v per token row (ld 3C), in bf16; D = KD, C % 16
// == 0. Warp gw of GW walks items [N gw / GW, N (gw + 1) / GW) of the N = H
// BW items (head h = it / BW, window w = it % BW), as the backward's core,
// and writes o_h at column h D of o (ld C).
template <int NQ, int KD>
__global__ void __launch_bounds__(WholeFwdCfg<NQ, KD>::kThreads)
wattn_whole_fwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ rel,
                       const int* __restrict__ rid, bf16* __restrict__ o, int BW, int C, int H,
                       int nW, int GW, float mask2) {
  using Cf = WholeFwdCfg<NQ, KD>;
  constexpr int V = Cf::kV, kTile = Cf::kTile, kKT = V / 16, kDT = KD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int gw = blockIdx.x * Cf::kWarps + warp;
  if (gw >= GW) return;
  bf16* bufs = reinterpret_cast<bf16*>(smem + (size_t)warp * Cf::kWarpBytes);
  const long long N = (long long)H * BW;
  const int it_begin = (int)(N * gw / GW), it_end = (int)(N * (gw + 1) / GW);
  const size_t ld = (size_t)3 * C;

  // item it's three tiles into buffer b: q scale log2(e), k, v
  auto prefetch = [&](int it, int b) {
    const int h = it / BW, w = it % BW;
    bf16* S = bufs + b * Cf::kStage;
    const bf16* base = qkv + (size_t)w * V * ld + h * KD;
    whole_tile_async<V, KD>(S, base, ld, lane);
    whole_tile_async<V, KD>(S + kTile, base + C, ld, lane);
    whole_tile_async<V, KD>(S + 2 * kTile, base + 2 * C, ld, lane);
  };

  if (Cf::kBufs == 2) {
    prefetch(it_begin, 0);
    cp_async_commit();
  }
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
    const bf16* K = Q + kTile;
    const bf16* Vt = Q + 2 * kTile;
    const int* rr = rid == nullptr ? nullptr : rid + (size_t)(w % nW) * V;
    const float* relh = rel + (size_t)h * V * V;
    const size_t row0 = (size_t)w * V;
#pragma unroll
    for (int qt = 0; qt < NQ; ++qt) {
      const int i0 = qt * 16 + g;   // this lane's rows: i0 and i0 + 8
      float sc[V / 8][4];
      whole_scores<V, KD>(sc, Q, K, qt, lane);
      whole_softmax<V>(sc, relh, rr, i0, t, mask2);
      uint32_t pa[kKT][4];   // p rounded once
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) acc_to_a(pa[kk], sc[2 * kk], sc[2 * kk + 1]);
      float acc[kDT][4];
      whole_rows_times<V, KD>(acc, pa, Vt, lane);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const size_t row = row0 + i0 + 8 * h2;
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt)
          *reinterpret_cast<uint32_t*>(o + row * C + h * KD + dt * 8 + 2 * t) =
              pack_bf16(acc[dt][2 * h2], acc[dt][2 * h2 + 1]);
      }
    }
    __syncwarp();   // the item's buffer is free
  }
  cp_async_wait<0>();
}

template <typename T, int KD>
int launch_fwd_general(const void* x, const void* wqkv, const float* bqkv, const void* wout,
                       const float* bout, const float* rel, const int* rid, void* obuf,
                       void* qkv, void* out, int BW, int V, int C, int H, int nW, float scale2,
                       float mask2, cudaStream_t stream) {
  const int N = BW * V;
  int err = launch_projection<T>(x, C, wqkv, 3 * C, false, bqkv, qkv, 3 * C, N, 3 * C, C, C, scale2,
                           -1, stream);
  if (err != 0) return err;
  int blocks = 0;
  err = launch_rows<T, false, KD>(qkv, 3 * C, rel, rid, nullptr, nullptr, obuf, nullptr, nullptr,
                                  nullptr, 1, BW, V, C, H, nW, 1.f, mask2, &blocks, stream);
  if (err != 0) return err;
  return launch_projection<T>(obuf, C, wout, C, false, bout, out, C, N, C, C, 0, 1.f, -1, stream);
}

// The whole-window path (bf16): the q | k | v projection, the core on as
// many warps as fit on the card at once (at most the items), the out
// projection.
template <int NQ, int KD>
int launch_fwd_whole(const void* x, const void* wqkv, const float* bqkv, const void* wout,
                     const float* bout, const float* rel, const int* rid, void* obuf, void* qkv,
                     void* out, int BW, int C, int H, int nW, float scale2, float mask2,
                     cudaStream_t stream) {
  using Cf = WholeFwdCfg<NQ, KD>;
  const int N = BW * Cf::kV;
  int err = launch_projection<bf16>(x, C, wqkv, 3 * C, false, bqkv, qkv, 3 * C, N, 3 * C, C, C,
                                    scale2, -1, stream);
  if (err != 0) return err;
  const size_t bytes = (size_t)Cf::kWarps * Cf::kWarpBytes;
  auto kernel = wattn_whole_fwd_kernel<NQ, KD>;
  const int blocks = mma_blocks(kernel, Cf::kThreads, bytes, (long long)H * BW);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  const long long GW = std::min((long long)blocks * Cf::kWarps, (long long)H * BW);
  kernel<<<(unsigned)((GW + Cf::kWarps - 1) / Cf::kWarps), Cf::kThreads, bytes, stream>>>(
      static_cast<const bf16*>(qkv), rel, rid, static_cast<bf16*>(obuf), BW, C, H, nW, (int)GW,
      mask2);
  cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;
  return launch_projection<bf16>(obuf, C, wout, C, false, bout, out, C, N, C, C, 0, 1.f, -1,
                                 stream);
}

// The general path in bf16 at D <= 128 (window_attention_mma.cuh): the q | k
// | v projection, the mma row kernel, the out projection.
template <int KD>
int launch_fwd_mma(const void* x, const void* wqkv, const float* bqkv, const void* wout,
                   const float* bout, const float* rel, const int* rid, void* obuf, void* qkv,
                   void* out, int BW, int V, int C, int H, int nW, float scale2, float mask2,
                   cudaStream_t stream) {
  const int N = BW * V;
  int err = launch_projection<bf16>(x, C, wqkv, 3 * C, false, bqkv, qkv, 3 * C, N, 3 * C, C, C,
                                    scale2, -1, stream);
  if (err != 0) return err;
  const int G = mma_row_blocks<false, KD>(BW, V, H);
  err = launch_rows_mma<false, KD>(qkv, 3 * C, rel, rid, nullptr, nullptr, obuf, nullptr, nullptr,
                                   nullptr, G, BW, V, C, H, nW, 1.f, mask2, stream);
  if (err != 0) return err;
  return launch_projection<bf16>(obuf, C, wout, C, false, bout, out, C, N, C, C, 0, 1.f, -1,
                                 stream);
}

template <typename T>
int launch_fwd_d(const void* x, const void* wqkv, const float* bqkv, const void* wout,
                 const float* bout, const float* rel, const int* rid, void* obuf, void* qkv,
                 void* out, int BW, int V, int C, int H, int nW, float scale2, float mask2,
                 cudaStream_t s) {
  const int D = C / H;
  if (std::is_same<T, bf16>::value && whole_window_path(V, C, H))
    return whole_dispatch(V, D, [&](auto nq, auto kd) {
      return launch_fwd_whole<decltype(nq)::value, decltype(kd)::value>(
          x, wqkv, bqkv, wout, bout, rel, rid, obuf, qkv, out, BW, C, H, nW, scale2, mask2, s);
    });
  if (std::is_same<T, bf16>::value && D <= kMmaMaxHeadDim) {
    switch (mma_head_dim(D)) {
      case 16:
        return launch_fwd_mma<16>(x, wqkv, bqkv, wout, bout, rel, rid, obuf, qkv, out, BW, V, C,
                                  H, nW, scale2, mask2, s);
      case 32:
        return launch_fwd_mma<32>(x, wqkv, bqkv, wout, bout, rel, rid, obuf, qkv, out, BW, V, C,
                                  H, nW, scale2, mask2, s);
      case 64:
        return launch_fwd_mma<64>(x, wqkv, bqkv, wout, bout, rel, rid, obuf, qkv, out, BW, V, C,
                                  H, nW, scale2, mask2, s);
      default:
        return launch_fwd_mma<128>(x, wqkv, bqkv, wout, bout, rel, rid, obuf, qkv, out, BW, V, C,
                                   H, nW, scale2, mask2, s);
    }
  }
  switch (padded_head_dim(D, std::is_same<T, float>::value)) {
    case 16:
      return launch_fwd_general<T, 16>(x, wqkv, bqkv, wout, bout, rel, rid, obuf, qkv, out, BW,
                                       V, C, H, nW, scale2, mask2, s);
    case 32:
      return launch_fwd_general<T, 32>(x, wqkv, bqkv, wout, bout, rel, rid, obuf, qkv, out, BW,
                                       V, C, H, nW, scale2, mask2, s);
    default:
      return launch_fwd_general<T, 64>(x, wqkv, bqkv, wout, bout, rel, rid, obuf, qkv, out, BW,
                                       V, C, H, nW, scale2, mask2, s);
  }
}

}  // namespace lcbi

// x, out: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); obuf (BW V, C)
// and qkv (BW V, 3C) in T are the streams o and q | k | v, written. wqkv (C,
// 3C), wout (C, C) in T; bqkv (3C,), bout (C,), rel (H, V, V) fp32; rid (nW,
// V) int32 or NULL (then nW is ignored). C = D H with any D >= 1, 1 <= V <=
// 512, all pointers 32-byte aligned. scale2 = scale log2(e), mask2 =
// mask_value log2(e). Returns cudaGetLastError() of the launches.
extern "C" int lcbi_window_attention_fwd(const void* x, const void* wqkv, const void* bqkv,
                                         const void* wout, const void* bout, const void* rel,
                                         const void* rid, void* obuf, void* qkv, void* out,
                                         int BW, int V, int C, int H, int nW, float scale2,
                                         float mask2, int is_bf16, void* stream) {
  (void)cudaGetLastError();
  if (!lcbi::attn_shape_ok(BW, V, C, H) || (rid != nullptr && (nW <= 0 || BW % nW != 0)) ||
      (long long)BW * V * 3 * C >= (1LL << 31) || obuf == nullptr || qkv == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b3 = static_cast<const float*>(bqkv);
  const float* b1 = static_cast<const float*>(bout);
  const float* r = static_cast<const float*>(rel);
  const int* ids = static_cast<const int*>(rid);
  if (is_bf16)
    return lcbi::launch_fwd_d<__nv_bfloat16>(x, wqkv, b3, wout, b1, r, ids, obuf, qkv, out, BW, V,
                                             C, H, nW, scale2, mask2, s);
  return lcbi::launch_fwd_d<float>(x, wqkv, b3, wout, b1, r, ids, obuf, qkv, out, BW, V, C, H,
                                   nW, scale2, mask2, s);
}
