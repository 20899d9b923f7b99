// Weight gradients of the Swin window attention K8, from the streams that the
// K8 backward (window_attention_bwd.cu) writes:
//     dWqkv = x^T dqkv   (C, 3C),   dWout = o^T dout   (C, C),
// x, o, dout: (N, C) and dqkv: (N, 3C) in T, N = BW V tokens; fp32 results.
//
// Replaces the weight-gradient sums of the TPU kernel
// long_context_biomedical_imaging_tpu/ops/window_attention.py _bwd_kernel
// (dwqkv_ref and dwout_ref, accumulated over its sequential grid in VMEM;
// pallas_call in _call_bwd): products of the same T operands, fp32 sums.
//
// The kernel and its design are in wgrad.cuh and mma_gemm.cuh (K1's, K2's
// and K4's backwards run it too).
#include "wgrad.cuh"

// Row splits of the two products for N rows of C channels: the wrapper
// allocates that many partials of 4 C^2 floats. 0 on a device query error.
extern "C" int lcbi_window_attention_wgrad_splits(long long N, int C) {
  return lcbi::wgrad_splits(N, C);
}

// x, o, dout: (N, C) and dqkv: (N, 3C) in T (fp32 if is_bf16 == 0, else bf16).
// partials: S x 4C^2 fp32 scratch; out: 4C^2 fp32 receives [dWqkv (C, 3C) |
// dWout (C, C)], row-major. Any C > 0 (the staged tiles are zero past C),
// 1 <= S <= N, all pointers 32-byte
// aligned. Returns cudaGetLastError() of the launches.
extern "C" int lcbi_window_attention_wgrad(const void* x, const void* dqkv, const void* o,
                                           const void* dout, void* partials, void* out,
                                           long long N, int C, int S, int is_bf16,
                                           void* stream) {
  (void)cudaGetLastError();
  if (N <= 0 || C <= 0 || S < 1 || S > N || S > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  float* r = static_cast<float*>(out);
  if (is_bf16)
    return lcbi::launch_wgrad<__nv_bfloat16>(x, dqkv, o, dout, p, r, N, C, S, s);
  return lcbi::launch_wgrad<float>(x, dqkv, o, dout, p, r, N, C, S, s);
}
