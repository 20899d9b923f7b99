// Fused pre-LN transformer MLP with residual, forward:
//     out = x + GELU(LN(x) @ w1 + b1) @ w2 + b2
// and, with the template argument LN false, the plain MLP (K2'):
//     out = GELU(x @ w1 + b1) @ w2 + b2
//
// Replaces the TPU kernels long_context_biomedical_imaging_tpu/ops/fused_mlp.py
// _make_ln_fwd_kernel (launched by _ln_fwd_call, entry fused_ln_mlp_residual)
// and, as K2', _make_fwd_kernel (launched by _fwd, entry fused_mlp).
//
// What bounds it on the H100: 16*N*C^2 FLOPs against 4*N*C bytes of x in and
// out (bf16), so at C = 96..768 it is compute-bound on the tensor cores once
// the 4C-wide hidden activation stays on chip; the composed chain instead
// writes and re-reads that hidden (4x the stream) through HBM. What the design
// does about it: one block owns a tile of bm rows for the whole chain. The
// LN'd rows sit in shared memory in the matmul type; the hidden runs in
// chunks of 64 columns (u = y @ w1[:, chunk] in fp32, bias + GELU, cast) and
// each chunk is folded at once into the fp32 output tile (acc += h @ w2[chunk]),
// so LN statistics are computed once per row and the hidden never leaves the
// SM. bm is the largest of 64/32/16 rows whose tiles fit in shared memory
// (C = 768 needs bm = 32). GELU is the tanh form under bf16 and the exact erf
// form under fp32, as in the TPU kernel (_gelu). Weights are read from global
// memory by every block; they stay resident in the 50 MB L2.
#include "common.cuh"

namespace lcbi {

constexpr int kHiddenChunk = 64;

struct MlpLayout {
  int lds, ldacc, ldu, ldh;
  size_t off_acc, off_u, off_h, bytes;
};

__host__ __device__ inline MlpLayout mlp_layout(int bm, int C, int elem) {
  MlpLayout L;
  L.lds = C + 8;
  L.ldacc = C + 4;
  L.ldu = kHiddenChunk + 4;
  L.ldh = kHiddenChunk + 8;
  L.off_acc = align128((size_t)bm * L.lds * elem);
  L.off_u = L.off_acc + align128((size_t)bm * L.ldacc * 4);
  L.off_h = L.off_u + align128((size_t)bm * L.ldu * 4);
  L.bytes = L.off_h + align128((size_t)bm * L.ldh * elem);
  return L;
}

template <typename T> __device__ __forceinline__ float gelu(float u);
template <> __device__ __forceinline__ float gelu<float>(float u) {
  return 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
}
template <> __device__ __forceinline__ float gelu<__nv_bfloat16>(float u) {
  const float inner = 0.79788456080286536f * (u + 0.044715f * u * u * u);
  return 0.5f * u * (1.f + tanhf(inner));
}

template <typename T, bool LN>
__global__ void __launch_bounds__(kThreads)
fused_ln_mlp_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                        const float* __restrict__ ln_b, const T* __restrict__ w1,
                        const float* __restrict__ b1, const T* __restrict__ w2,
                        const float* __restrict__ b2, T* __restrict__ out,
                        int N, int C, int H, int bm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpLayout L = mlp_layout(bm, C, sizeof(T));
  T* ys = reinterpret_cast<T*>(smem);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);
  float* u = reinterpret_cast<float*>(smem + L.off_u);
  T* h = reinterpret_cast<T*>(smem + L.off_h);

  const size_t r0 = (size_t)blockIdx.x * bm;
  const int rows = min(bm, N - (int)r0);
  const T* xt = x + r0 * C;

  layernorm_rows(xt, rows, bm, C, ln_g, ln_b, LN ? 1 : 0, ys, L.lds);
  for (int i = threadIdx.x; i < bm * L.ldacc; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  for (int h0 = 0; h0 < H; h0 += kHiddenChunk) {
    gemm_tile(u, L.ldu, ys, L.lds, w1 + h0, H, bm, kHiddenChunk, C, false);
    __syncthreads();
    for (int i = threadIdx.x; i < bm * kHiddenChunk; i += kThreads) {
      const int r = i / kHiddenChunk, j = i % kHiddenChunk;
      h[(size_t)r * L.ldh + j] = from_f32<T>(gelu<T>(u[(size_t)r * L.ldu + j] + b1[h0 + j]));
    }
    __syncthreads();
    // the next chunk's first product writes only u, and its GELU pass (which
    // overwrites h) waits behind the barrier that follows that product
    gemm_tile(acc, L.ldacc, h, L.ldh, w2 + (size_t)h0 * C, C, bm, C, kHiddenChunk, true);
  }
  __syncthreads();

  T* ot = out + r0 * C;
  for (int i = threadIdx.x; i < rows * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const float v = acc[(size_t)r * L.ldacc + c] + b2[c] + (LN ? to_f32(xt[i]) : 0.f);
    ot[i] = from_f32<T>(v);
  }
}

template <typename T, bool LN>
int launch(const void* x, const void* ln_g, const void* ln_b, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int N, int C, int H, cudaStream_t stream) {
  const int limit = max_dynamic_smem();
  int bm = 64;
  while (bm > 16 && mlp_layout(bm, C, sizeof(T)).bytes > (size_t)limit) bm /= 2;
  const size_t bytes = mlp_layout(bm, C, sizeof(T)).bytes;
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_ln_mlp_fwd_kernel<T, LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((N + bm - 1) / bm);
  fused_ln_mlp_fwd_kernel<T, LN><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<const T*>(w1), static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(out), N, C, H, bm);
  return (int)cudaGetLastError();
}

}  // namespace lcbi

// x, out: (N, C) in T (fp32 if is_bf16 == 0, else bf16); w1: (C, H), w2: (H, C)
// in T; ln_g, ln_b, b2: (C,) and b1: (H,) fp32. C % 16 == 0, H % 64 == 0,
// all pointers 32-byte aligned. Returns cudaGetLastError() of the launch.
extern "C" int lcbi_fused_ln_mlp_fwd(const void* x, const void* ln_g, const void* ln_b,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* out, int N, int C, int H,
                                     int is_bf16, void* stream) {
  (void)cudaGetLastError();
  if (N <= 0 || C % 16 != 0 || H % lcbi::kHiddenChunk != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return lcbi::launch<__nv_bfloat16, true>(x, ln_g, ln_b, w1, b1, w2, b2, out, N, C, H, s);
  return lcbi::launch<float, true>(x, ln_g, ln_b, w1, b1, w2, b2, out, N, C, H, s);
}

// K2', the MLP without LayerNorm or residual: out = GELU(x @ w1 + b1) @ w2 +
// b2. Operands as lcbi_fused_ln_mlp_fwd without ln_g and ln_b.
extern "C" int lcbi_fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* out, int N, int C, int H, int is_bf16,
                                  void* stream) {
  (void)cudaGetLastError();
  if (N <= 0 || C % 16 != 0 || H % lcbi::kHiddenChunk != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return lcbi::launch<__nv_bfloat16, false>(x, nullptr, nullptr, w1, b1, w2, b2, out, N, C, H,
                                              s);
  return lcbi::launch<float, false>(x, nullptr, nullptr, w1, b1, w2, b2, out, N, C, H, s);
}
