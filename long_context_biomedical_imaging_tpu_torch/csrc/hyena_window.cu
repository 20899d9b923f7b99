// Fused Hyena window mixer, forward, for windows of V <= 64 tokens:
//     out = [x +] out_proj(x2 * longconv(x1 * v)),  [x1 | x2 | v] = shortconv(in_proj([LN](x)))
//
// Replaces the TPU kernel long_context_biomedical_imaging_tpu/ops/hyena_window.py
// _make_fwd_kernel / _fwd_body (launched by _fwd through _mixer_core_ln and
// _mixer_core, entry hyena_window_mixer).
//
// What bounds it on the H100: the two projections are 8*T*C^2 FLOPs for T
// tokens, against 4*T*C bytes of x in and out (bf16); the composed chain
// streams the 3C-wide projection and its convolved and gated forms through
// HBM about six times. The convolutions and gates act per channel and within
// one window, so nothing crosses windows. What the design does about it: a
// block owns wb whole windows (wb * V rows, padded to a multiple of 16) for
// the whole chain. The (LN'd) rows sit in shared memory in the matmul type.
// The channel axis runs in chunks of 32: for one chunk the block computes the
// x1/x2/v columns of in_proj (3 x 32 fp32 columns), runs the 5-tap causal
// short conv, the pre-gate, the V-tap causal long conv and the post-gate in
// fp32 with one thread per (window, channel), and folds the chunk at once
// into the fp32 output tile (acc += v2[:, chunk] @ w_out[chunk, :]). So the
// 3C-wide intermediates never exist whole: at C = 768 they would take 147 KB
// per window in fp32. wb is 64 / V windows, halved until the tiles fit in
// shared memory (C = 768 at V = 16 runs 2 windows per block).
//
// Taps arrive prepared by the wrapper, as for the TPU kernel: ws (K, 3C) is
// the short filter flipped to causal tap order, kl (V, C) the long filter
// with the skip weight added to tap 0.
//
// Widths: the channel axis runs in chunks of 32 over Cp = C rounded up to 32.
// The rows of x load at the true C (LayerNorm statistics over C, zeros in
// columns [C, Cp)) and only columns [0, C) of the output are stored; the
// weights, taps and biases arrive padded to Cp with zeros (the wrapper pads
// the weights, never the activations), so the padded channels of a chunk's
// tail stay zero through the whole chain.
#include "common.cuh"

namespace lcbi {

constexpr int kChanChunk = 32;
constexpr int kMaxWindow = 64;

struct HyenaLayout {
  int lds, ldacc, ldz, ldv;
  size_t off_acc, off_z, off_v2, off_kl, off_ws, off_bias, bytes;
};

__host__ __device__ inline HyenaLayout hyena_layout(int rows_pad, int V, int C, int K, int elem) {
  HyenaLayout L;
  L.lds = C + 8;
  L.ldacc = C + 4;
  L.ldz = 3 * kChanChunk + 4;
  L.ldv = kChanChunk + 8;
  L.off_acc = align128((size_t)rows_pad * L.lds * elem);
  L.off_z = L.off_acc + align128((size_t)rows_pad * L.ldacc * 4);
  L.off_v2 = L.off_z + align128((size_t)rows_pad * L.ldz * 4);
  L.off_kl = L.off_v2 + align128((size_t)rows_pad * L.ldv * elem);
  L.off_ws = L.off_kl + align128((size_t)V * kChanChunk * 4);
  L.off_bias = L.off_ws + align128((size_t)K * 3 * kChanChunk * 4);
  L.bytes = L.off_bias + align128((size_t)2 * 3 * kChanChunk * 4);
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hyena_window_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                        const float* __restrict__ ln_b, const T* __restrict__ win,
                        const float* __restrict__ bin, const float* __restrict__ ws,
                        const float* __restrict__ bs, const float* __restrict__ kl,
                        const T* __restrict__ wo, const float* __restrict__ bo,
                        T* __restrict__ out, int BW, int V, int C, int K, int wb,
                        int rows_pad, int has_ln) {
  constexpr int CC = kChanChunk, W3 = 3 * kChanChunk;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Cp = chunk_padded_channels(C);
  const HyenaLayout L = hyena_layout(rows_pad, V, Cp, K, sizeof(T));
  T* ys = reinterpret_cast<T*>(smem);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);
  float* z = reinterpret_cast<float*>(smem + L.off_z);
  T* v2 = reinterpret_cast<T*>(smem + L.off_v2);
  float* klc = reinterpret_cast<float*>(smem + L.off_kl);   // (V, CC)
  float* wsc = reinterpret_cast<float*>(smem + L.off_ws);   // (K, 3CC)
  float* binc = reinterpret_cast<float*>(smem + L.off_bias);
  float* bsc = binc + W3;

  const int w0 = blockIdx.x * wb;
  const int nwin = min(wb, BW - w0);
  const int rows = nwin * V;
  const size_t base = (size_t)w0 * V * C;
  const T* xt = x + base;

  layernorm_rows(xt, rows, rows_pad, C, ln_g, ln_b, has_ln, ys, L.lds, nullptr, nullptr, Cp);
  for (int i = threadIdx.x; i < rows_pad * L.ldacc; i += kThreads) acc[i] = 0.f;
  // pad rows of v2 are never written by the gates; keep them finite
  for (int i = threadIdx.x; i < rows_pad * L.ldv; i += kThreads) v2[i] = from_f32<T>(0.f);

  for (int c0 = 0; c0 < Cp; c0 += CC) {
    // this chunk's taps and biases; column j of a 3CC-wide chunk is channel
    // c0 + j % CC of block j / CC of the [x1 | x2 | v] projection
    for (int i = threadIdx.x; i < V * CC; i += kThreads)
      klc[i] = kl[(size_t)(i / CC) * Cp + c0 + i % CC];
    for (int i = threadIdx.x; i < K * W3; i += kThreads) {
      const int m = i / W3, j = i % W3;
      wsc[i] = ws[(size_t)m * 3 * Cp + (j / CC) * Cp + c0 + j % CC];
    }
    for (int j = threadIdx.x; j < W3; j += kThreads) {
      const int col = (j / CC) * Cp + c0 + j % CC;
      binc[j] = bin[col];
      bsc[j] = bs[col];
    }
    __syncthreads();  // also orders the LN prologue before the first product
    for (int s = 0; s < 3; ++s)
      gemm_tile(z + s * CC, L.ldz, ys, L.lds, win + s * Cp + c0, 3 * Cp, rows_pad, CC, Cp, false);
    __syncthreads();

    for (int p = threadIdx.x; p < nwin * CC; p += kThreads) {
      const int w = p / CC, j = p % CC;
      float* zr = z + (size_t)w * V * L.ldz;  // token t of this window: zr[t * ldz]
      // in_proj bias, then the causal short conv (zero history before the
      // window start) and its bias; in place from the last token down, so
      // every read of an earlier token still sees its unconvolved value
      for (int s = 0; s < 3; ++s) {
        const int col = s * CC + j;
        const float bi = binc[col], bsv = bsc[col];
        for (int t = V - 1; t >= 0; --t) {
          float a = (zr[(size_t)t * L.ldz + col] + bi) * wsc[col];
          for (int m = 1; m < K && m <= t; ++m)
            a += (zr[(size_t)(t - m) * L.ldz + col] + bi) * wsc[m * W3 + col];
          zr[(size_t)t * L.ldz + col] = a + bsv;
        }
      }
      // pre-gate g = v * x1, into the v column
      for (int t = 0; t < V; ++t)
        zr[(size_t)t * L.ldz + 2 * CC + j] *= zr[(size_t)t * L.ldz + j];
      // causal long conv over the window, then the post-gate with x2
      for (int t = 0; t < V; ++t) {
        float a = zr[(size_t)t * L.ldz + 2 * CC + j] * klc[j];
        for (int m = 1; m <= t; ++m)
          a += zr[(size_t)(t - m) * L.ldz + 2 * CC + j] * klc[m * CC + j];
        v2[(size_t)(w * V + t) * L.ldv + j] = from_f32<T>(a * zr[(size_t)t * L.ldz + CC + j]);
      }
    }
    __syncthreads();
    // the next chunk's tap loads and first product touch neither v2 nor acc,
    // and its gates (which overwrite v2) wait behind the barrier after them
    gemm_tile(acc, L.ldacc, v2, L.ldv, wo + (size_t)c0 * Cp, Cp, rows_pad, Cp, CC, true);
  }
  __syncthreads();

  T* ot = out + base;
  for (int i = threadIdx.x; i < rows * C; i += kThreads) {
    const int r = i / C, c = i % C;
    float v = acc[(size_t)r * L.ldacc + c] + bo[c];
    if (has_ln) v += to_f32(xt[i]);
    ot[i] = from_f32<T>(v);
  }
}

template <typename T>
int launch(const void* x, const void* ln_g, const void* ln_b, const void* win, const void* bin,
           const void* ws, const void* bs, const void* kl, const void* wo, const void* bo,
           void* out, int BW, int V, int C, int K, int has_ln, cudaStream_t stream) {
  const int limit = max_dynamic_smem();
  int wb = kMaxWindow / V;
  auto bytes_for = [&](int nw) {
    return hyena_layout(round_up16(nw * V), V, chunk_padded_channels(C), K, sizeof(T)).bytes;
  };
  while (wb > 1 && bytes_for(wb) > (size_t)limit) wb /= 2;
  const size_t bytes = bytes_for(wb);
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(hyena_window_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((BW + wb - 1) / wb);
  hyena_window_fwd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      static_cast<const T*>(win), static_cast<const float*>(bin), static_cast<const float*>(ws),
      static_cast<const float*>(bs), static_cast<const float*>(kl), static_cast<const T*>(wo),
      static_cast<const float*>(bo), static_cast<T*>(out), BW, V, C, K, wb,
      round_up16(wb * V), has_ln);
  return (int)cudaGetLastError();
}

}  // namespace lcbi

// The padded width this library's kernels run on (common.cuh): the wrapper
// lays the weights, taps and biases out at it.
extern "C" int lcbi_padded_channels(int C) { return lcbi::chunk_padded_channels(C); }

// x, out: (BW, V, C) in T (fp32 if is_bf16 == 0, else bf16); win: (Cp, 3Cp)
// and wo: (Cp, Cp) in T; bin, bs: (3Cp,), ws: (K, 3Cp), kl: (V, Cp) fp32, all
// padded per [x1 | x2 | v] block with zeros to Cp = C rounded up to 32; bo
// and, if has_ln, ln_g, ln_b: (C,) fp32. 1 <= V <= 64, C > 0, all pointers
// 32-byte aligned. Returns cudaGetLastError() of the launch.
extern "C" int lcbi_hyena_window_fwd(const void* x, const void* ln_g, const void* ln_b,
                                     const void* win, const void* bin, const void* ws,
                                     const void* bs, const void* kl, const void* wo,
                                     const void* bo, void* out, int BW, int V, int C, int K,
                                     int has_ln, int is_bf16, void* stream) {
  (void)cudaGetLastError();
  if (BW <= 0 || V < 1 || V > lcbi::kMaxWindow || C <= 0 || K < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return lcbi::launch<__nv_bfloat16>(x, ln_g, ln_b, win, bin, ws, bs, kl, wo, bo, out, BW, V,
                                       C, K, has_ln, s);
  return lcbi::launch<float>(x, ln_g, ln_b, win, bin, ws, bs, kl, wo, bo, out, BW, V, C, K,
                             has_ln, s);
}
