// Fused pre-LN transformer MLP with residual, backward:
//     out = x + GELU(LN(x) @ w1 + b1) @ w2 + b2
//     -> dx, d ln_g, d ln_b, dw1, db1, dw2, db2 given do = d out
// and, with the template argument LN false, the plain MLP's (K2'):
//     out = GELU(x @ w1 + b1) @ w2 + b2  ->  dx, dw1, db1, dw2, db2
//
// Replaces the TPU kernels long_context_biomedical_imaging_tpu/ops/fused_mlp.py
// _make_ln_bwd_kernel (launched by _ln_bwd_call, the custom VJP of
// fused_ln_mlp_residual) and, as K2', _make_bwd_kernel (launched by _bwd,
// the custom VJP of fused_mlp). Without LN, y is x itself, dx = dy and
// there are no LayerNorm gradients; everything else is the same code.
//
// What bounds it on the H100: five products (u, dh, dw2, dw1, dy), 40*N*C^2
// FLOPs against 6*N*C bytes of x, do in and dx out (bf16), plus the weight
// gradients: 2*C*H fp32 per block of rows that the TPU kernel sums in place
// over its sequential grid. A CUDA grid runs in parallel, so the design
// bounds the partial sums instead of keeping one per row tile (at C = 96 that
// would be 16,384 partials of 0.3 MB): a persistent grid of G blocks (G at
// most the blocks resident at once, and as many as the caller's slots allow)
// walks contiguous ranges of 64-row tiles, each block accumulating into its
// own fp32 slot of every gradient in global memory; reduce_slots_kernel then
// sums the G slots in a fixed order, so the result is deterministic.
//
// Within a tile the forward is recomputed from x, as the TPU kernel does (the
// forward saves only its inputs): the LN'd rows y and the tile of do sit in
// shared memory in the matmul type, and the hidden width runs in chunks of 64
// columns: u = y @ w1[:, chunk] + b1, h = GELU(u), dh = do @ w2[chunk, :]^T,
// du = dh * GELU'(u); then dw2[chunk, :] += h^T do, dw1[:, chunk] += y^T du
// straight into the block's slot, and dy += du @ w1[:, chunk]^T into an fp32
// tile in shared memory. Last the LayerNorm backward per row,
// dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) + do, with
// dxhat = dy * g. Operands of every product are rounded to T where the TPU
// kernel rounds them (y, h, du, do), and every sum is fp32. GELU' is the
// derivative of the tanh form under bf16 and of the exact erf form in fp32.
#include "common.cuh"

namespace lcbi {

constexpr int kBwdChunk = 64;

struct MlpBwdLayout {
  int lds, lddy, ldu, ldh;
  size_t off_dos, off_dy, off_u, off_dh, off_h, off_du, off_stats, bytes;
};

__host__ __device__ inline MlpBwdLayout mlp_bwd_layout(int bm, int C, int elem) {
  MlpBwdLayout L;
  L.lds = C + 8;
  L.lddy = C + 4;
  L.ldu = kBwdChunk + 4;
  L.ldh = kBwdChunk + 8;
  L.off_dos = align128((size_t)bm * L.lds * elem);
  L.off_dy = L.off_dos + align128((size_t)bm * L.lds * elem);
  L.off_u = L.off_dy + align128((size_t)bm * L.lddy * 4);
  L.off_dh = L.off_u + align128((size_t)bm * L.ldu * 4);
  L.off_h = L.off_dh + align128((size_t)bm * L.ldu * 4);
  L.off_du = L.off_h + align128((size_t)bm * L.ldh * elem);
  L.off_stats = L.off_du + align128((size_t)bm * L.ldh * elem);
  L.bytes = L.off_stats + align128((size_t)2 * bm * 4);
  return L;
}

constexpr float kTanhC0 = 0.79788456080286536f;   // sqrt(2 / pi)
constexpr float kTanhC1 = 0.044715f;

template <typename T> __device__ __forceinline__ void gelu_and_grad(float u, float& g, float& dg);
template <> __device__ __forceinline__ void gelu_and_grad<float>(float u, float& g, float& dg) {
  const float cdf = 0.5f * (1.f + erff(u * 0.70710678118654752f));
  g = u * cdf;
  dg = cdf + u * 0.39894228040143268f * expf(-0.5f * u * u);
}
template <> __device__ __forceinline__ void gelu_and_grad<__nv_bfloat16>(float u, float& g,
                                                                          float& dg) {
  const float th = tanhf(kTanhC0 * (u + kTanhC1 * u * u * u));
  g = 0.5f * u * (1.f + th);
  dg = 0.5f * (1.f + th) + 0.5f * u * (1.f - th * th) * kTanhC0 * (1.f + 3.f * kTanhC1 * u * u);
}

// Slot offsets (floats) of each gradient inside one block's slot; dw1 is at 0.
struct MlpSlots {
  int dw2, db1, db2, dg, dbln;
};

template <typename T, bool LN>
__global__ void __launch_bounds__(kThreads)
fused_ln_mlp_bwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                        const float* __restrict__ ln_b, const T* __restrict__ w1,
                        const float* __restrict__ b1, const T* __restrict__ w2,
                        const T* __restrict__ dout, T* __restrict__ dx, float* __restrict__ slots,
                        size_t P, MlpSlots off, int N, int C, int H, int bm, long long tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpBwdLayout L = mlp_bwd_layout(bm, C, sizeof(T));
  T* ys = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + L.off_dos);
  float* dy = reinterpret_cast<float*>(smem + L.off_dy);
  float* u = reinterpret_cast<float*>(smem + L.off_u);
  float* dh = reinterpret_cast<float*>(smem + L.off_dh);
  T* hs = reinterpret_cast<T*>(smem + L.off_h);
  T* dus = reinterpret_cast<T*>(smem + L.off_du);
  float* mus = reinterpret_cast<float*>(smem + L.off_stats);
  float* rstds = mus + bm;

  float* slot = slots + (size_t)blockIdx.x * P;
  float* s_dw1 = slot;
  float* s_dw2 = slot + off.dw2;
  float* s_db1 = slot + off.db1;
  float* s_db2 = slot + off.db2;
  float* s_dg = slot + off.dg;
  float* s_dbln = slot + off.dbln;

  const long long t_begin = tiles * blockIdx.x / gridDim.x;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const bool first = tile == t_begin;
    const size_t r0 = (size_t)tile * bm;
    const int rows = min(bm, N - (int)r0);
    const T* xt = x + r0 * C;
    const T* dot = dout + r0 * C;

    layernorm_rows(xt, rows, bm, C, ln_g, ln_b, LN ? 1 : 0, ys, L.lds, mus, rstds);
    for (int i = threadIdx.x; i < bm * C; i += kThreads) {
      const int r = i / C, c = i % C;
      dos[(size_t)r * L.lds + c] = r < rows ? dot[(size_t)r * C + c] : from_f32<T>(0.f);
    }
    for (int i = threadIdx.x; i < bm * L.lddy; i += kThreads) dy[i] = 0.f;
    __syncthreads();

    for (int h0 = 0; h0 < H; h0 += kBwdChunk) {
      gemm<false, false>(u, L.ldu, ys, L.lds, w1 + h0, H, bm, kBwdChunk, C, false);
      gemm<false, true>(dh, L.ldu, dos, L.lds, w2 + (size_t)h0 * C, C, bm, kBwdChunk, C, false);
      __syncthreads();
      // pad rows: y = 0 gives h = GELU(b1) != 0, but do = 0 there, so dh = du
      // = 0 and neither weight gradient sees them
      for (int i = threadIdx.x; i < bm * kBwdChunk; i += kThreads) {
        const int r = i / kBwdChunk, j = i % kBwdChunk;
        float g, dg;
        gelu_and_grad<T>(u[(size_t)r * L.ldu + j] + b1[h0 + j], g, dg);
        const float du = dh[(size_t)r * L.ldu + j] * dg;
        dh[(size_t)r * L.ldu + j] = du;
        hs[(size_t)r * L.ldh + j] = from_f32<T>(g);
        dus[(size_t)r * L.ldh + j] = from_f32<T>(du);
      }
      __syncthreads();
      for (int j = threadIdx.x; j < kBwdChunk; j += kThreads) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r) s += dh[(size_t)r * L.ldu + j];
        s_db1[h0 + j] = (first ? 0.f : s_db1[h0 + j]) + s;
      }
      // dw2[chunk, :] += h^T do; dw1[:, chunk] += y^T du; dy += du w1[:, chunk]^T
      gemm<true, false>(s_dw2 + (size_t)h0 * C, C, hs, L.ldh, dos, L.lds, kBwdChunk, C, bm, !first);
      gemm<true, false>(s_dw1 + h0, H, ys, L.lds, dus, L.ldh, C, kBwdChunk, bm, !first);
      gemm<false, true>(dy, L.lddy, dus, L.ldh, w1 + h0, H, bm, C, kBwdChunk, true);
      __syncthreads();
    }

    // LayerNorm backward per row (one warp per row), plus the residual;
    // without LN, dx = dy
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const float inv = 1.f / (float)C;
    T* dxt = dx + r0 * C;
    if (!LN) {
      for (int i = threadIdx.x; i < rows * C; i += kThreads)
        dxt[i] = from_f32<T>(dy[(size_t)(i / C) * L.lddy + i % C]);
    }
    for (int r = warp; LN && r < rows; r += kWarps) {
      const float mu = mus[r], rstd = rstds[r];
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float xhat = (to_f32(xt[(size_t)r * C + c]) - mu) * rstd;
        const float dxh = dy[(size_t)r * L.lddy + c] * ln_g[c];
        s1 += dxh;
        s2 += dxh * xhat;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      const float m1 = s1 * inv, m2 = s2 * inv;
      for (int c = lane; c < C; c += 32) {
        const float xhat = (to_f32(xt[(size_t)r * C + c]) - mu) * rstd;
        const float dxh = dy[(size_t)r * L.lddy + c] * ln_g[c];
        const float v = rstd * (dxh - m1 - xhat * m2) + to_f32(dos[(size_t)r * L.lds + c]);
        dxt[(size_t)r * C + c] = from_f32<T>(v);
      }
    }
    // column sums over the tile's rows: d ln_g, d ln_b (with LN), db2
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float sg = 0.f, sb = 0.f, so = 0.f;
      for (int r = 0; r < rows; ++r) {
        if (LN) {
          const float d = dy[(size_t)r * L.lddy + c];
          sg += d * (to_f32(xt[(size_t)r * C + c]) - mus[r]) * rstds[r];
          sb += d;
        }
        so += to_f32(dos[(size_t)r * L.lds + c]);
      }
      if (LN) {
        s_dg[c] = (first ? 0.f : s_dg[c]) + sg;
        s_dbln[c] = (first ? 0.f : s_dbln[c]) + sb;
      }
      s_db2[c] = (first ? 0.f : s_db2[c]) + so;
    }
    __syncthreads();
  }
}

template <typename T, bool LN>
int launch_bwd(const void* x, const void* ln_g, const void* ln_b, const void* w1, const void* b1,
               const void* w2, const void* dout, void* dx, float* slots, float* out, size_t P,
               MlpSlots off, int max_slots, int N, int C, int H, cudaStream_t stream) {
  const int limit = max_dynamic_smem();
  int bm = 64;
  while (bm > 16 && mlp_bwd_layout(bm, C, sizeof(T)).bytes > (size_t)limit) bm /= 2;
  const size_t bytes = mlp_bwd_layout(bm, C, sizeof(T)).bytes;
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_ln_mlp_bwd_kernel<T, LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (N + bm - 1) / bm;
  const int G = persistent_blocks(fused_ln_mlp_bwd_kernel<T, LN>, bytes, tiles, max_slots);
  if (G <= 0) return (int)cudaErrorInvalidValue;
  fused_ln_mlp_bwd_kernel<T, LN><<<G, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<const T*>(w1), static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(dout), static_cast<T*>(dx), slots, P, off, N, C, H, bm, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(slots, G, P, out, stream);
}

}  // namespace lcbi

// x, dout, dx: (N, C) in T (fp32 if is_bf16 == 0, else bf16); w1: (C, H) and
// w2: (H, C) in T; ln_g, ln_b: (C,) and b1: (H,) fp32. slots: max_slots x P
// fp32 scratch (P a multiple of 8, every offset of a block's slot in floats:
// dw1 (C, H) at 0, dw2 (H, C) at off_dw2, then db1 (H), db2, dg, dbln (C)).
// out: (P,) fp32, the slots summed. C % 16 == 0, H % 64 == 0, all pointers
// 32-byte aligned. Returns cudaGetLastError() of the launches.
extern "C" int lcbi_fused_ln_mlp_bwd(const void* x, const void* ln_g, const void* ln_b,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* dout, void* dx, void* slots, void* out, int N,
                                     int C, int H, int is_bf16, int max_slots, long long P,
                                     int off_dw2, int off_db1, int off_db2, int off_dg,
                                     int off_dbln, void* stream) {
  (void)cudaGetLastError();
  if (N <= 0 || C % 16 != 0 || H % lcbi::kBwdChunk != 0 || max_slots < 1 || P % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const lcbi::MlpSlots off{off_dw2, off_db1, off_db2, off_dg, off_dbln};
  float* sl = static_cast<float*>(slots);
  float* o = static_cast<float*>(out);
  if (is_bf16)
    return lcbi::launch_bwd<__nv_bfloat16, true>(x, ln_g, ln_b, w1, b1, w2, dout, dx, sl, o,
                                                 (size_t)P, off, max_slots, N, C, H, s);
  return lcbi::launch_bwd<float, true>(x, ln_g, ln_b, w1, b1, w2, dout, dx, sl, o, (size_t)P,
                                       off, max_slots, N, C, H, s);
}

// K2', the backward of the MLP without LayerNorm or residual: dx, and in
// the slots dw1 (C, H) at 0, dw2 (H, C) at off_dw2, db1 (H) and db2 (C).
// Operands as lcbi_fused_ln_mlp_bwd without ln_g, ln_b and their slots.
extern "C" int lcbi_fused_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* dout, void* dx, void* slots, void* out, int N,
                                  int C, int H, int is_bf16, int max_slots, long long P,
                                  int off_dw2, int off_db1, int off_db2, void* stream) {
  (void)cudaGetLastError();
  if (N <= 0 || C % 16 != 0 || H % lcbi::kBwdChunk != 0 || max_slots < 1 || P % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const lcbi::MlpSlots off{off_dw2, off_db1, off_db2, 0, 0};
  float* sl = static_cast<float*>(slots);
  float* o = static_cast<float*>(out);
  if (is_bf16)
    return lcbi::launch_bwd<__nv_bfloat16, false>(x, nullptr, nullptr, w1, b1, w2, dout, dx, sl,
                                                  o, (size_t)P, off, max_slots, N, C, H, s);
  return lcbi::launch_bwd<float, false>(x, nullptr, nullptr, w1, b1, w2, dout, dx, sl, o,
                                        (size_t)P, off, max_slots, N, C, H, s);
}
