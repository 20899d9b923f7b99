// Long-sequence selective scan (K7), the stitch between the passes of each
// direction: within each batch row of nseg segment rows, element by element
// over the E = N D floats of a carry, the exclusive affine scan
//     out[s] = X_s,  X_{s+1} = ap[s] X_s + x[s],  X_0 = 0
// along the segments, in walk order: ascending for the forward (x = hl, the
// zero-carry final states: out = hstart, each row's true initial carry),
// descending for the backward (x = dh0, the zero-tail start cotangents: out
// = dh_tail, the true cotangent of each row's final state). x, ap, out are
// (b * nseg, N, D) fp32, element e of segment s of batch row i at (i * nseg +
// s) * E + e.
//
// Replaces no TPU kernel: the JAX package stitches outside Pallas, with
// jax.lax.associative_scan (long_context_biomedical_imaging_tpu/ops/selective_scan_long.py
// _stitch_fwd and _stitch_bwd), and the port did so with a log-depth scan in
// torch ops (about five launches and two full copies of the carries at each
// of its log2(nseg) levels), the largest cost of the K7 path that no kernel
// row measured.
//
// What bounds it on the H100: device memory, x and ap read and out written
// once (12 bytes per element and segment), against 3 fp32 operations each.
// The design: one block per (batch row, 32 elements), a lane per element, so
// each warp's loads are 128 contiguous bytes. The walk order is cut into
// spans of `span` segments (at least 32; at most kStitchSpans spans). Each
// warp composes its spans' affine maps (A, H) from a zero start, the spans'
// aggregates meet in shared memory, warp 0 walks the spans in order for each
// span's start, and each warp walks its spans again from their starts,
// writing out (the second read of x and ap mostly hits L2). The order of
// every operation depends on the shape alone: two launches give the same
// bits. long_scan_stitch_plain (ops/selective_scan_long.py) is this order in
// torch.
#include "selective_scan_long.cuh"

namespace lcbi {

constexpr int kStitchMinSpan = 32;  // segments of a span at least
constexpr int kStitchSpans = 128;   // spans of a batch row at most
constexpr int kStitchWarps = 32;    // warps of a block at most

// Segments of a span for nseg segments (the same in long_scan_stitch_plain).
inline int stitch_span(int nseg) {
  const int span = (nseg + kStitchSpans - 1) / kStitchSpans;
  return span > kStitchMinSpan ? span : kStitchMinSpan;
}

__global__ void __launch_bounds__(kStitchWarps * 32)
long_scan_stitch_kernel(const float* __restrict__ x, const float* __restrict__ ap,
                        float* __restrict__ out, int nseg, int E, int span, int nspan,
                        int reverse) {
  __shared__ float sA[kStitchSpans][32], sH[kStitchSpans][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, W = blockDim.x / 32;
  const int e = blockIdx.x * 32 + lane;
  const bool on = e < E;
  const size_t base = (size_t)blockIdx.y * nseg * E + (on ? e : 0);
  // the segment at walk position k
  auto at_walk = [&](int k) { return base + (size_t)(reverse ? nseg - 1 - k : k) * E; };
  for (int sp = warp; sp < nspan; sp += W) {
    const int k0 = sp * span, k1 = min(nseg, k0 + span);
    float A = 1.f, H = 0.f;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      const size_t o = at_walk(k);
      const float a = ap[o];
      H = fmaf(a, H, x[o]);
      A *= a;
    }
    sA[sp][lane] = A;
    sH[sp][lane] = H;
  }
  __syncthreads();
  if (warp == 0) {  // each span's start, in place of its H
    float X = 0.f;
    for (int sp = 0; sp < nspan; ++sp) {
      const float A = sA[sp][lane], H = sH[sp][lane];
      sH[sp][lane] = X;
      X = fmaf(A, X, H);
    }
  }
  __syncthreads();
  for (int sp = warp; sp < nspan; sp += W) {
    const int k0 = sp * span, k1 = min(nseg, k0 + span);
    float X = sH[sp][lane];
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      const size_t o = at_walk(k);
      const float a = ap[o], v = x[o];
      if (on) out[o] = X;
      X = fmaf(a, X, v);
    }
  }
}

}  // namespace lcbi

// x, ap, out: (b * nseg, N, D) fp32, contiguous, E = N D floats a segment;
// reverse != 0 walks the segments of each batch row from the last. Returns
// cudaGetLastError() of the launch (or cudaErrorInvalidValue for a shape it
// does not take).
extern "C" int lcbi_long_scan_stitch(const void* x, const void* ap, void* out, int b, int nseg,
                                     int E, int reverse, void* stream) {
  (void)cudaGetLastError();
  if (b < 1 || nseg < 1 || E < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  const int span = lcbi::stitch_span(nseg);
  const int nspan = (nseg + span - 1) / span;
  const int warps = nspan < lcbi::kStitchWarps ? nspan : lcbi::kStitchWarps;
  lcbi::long_scan_stitch_kernel<<<dim3((E + 31) / 32, b), warps * 32, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(ap), static_cast<float*>(out),
      nseg, E, span, nspan, reverse);
  return (int)cudaGetLastError();
}
