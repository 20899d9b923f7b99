// Fused pre-LN transformer MLP with residual, backward:
//     out = x + GELU(LN(x) @ w1 + b1) @ w2 + b2
//     -> dx, d ln_g, d ln_b, dw1, db1, dw2, db2 given do = d out
// and, without the LayerNorm and the residual, the plain MLP's (K2'):
//     out = GELU(x @ w1 + b1) @ w2 + b2  ->  dx, dw1, db1, dw2, db2
//
// Replaces the TPU kernels long_context_biomedical_imaging_tpu/ops/fused_mlp.py
// _make_ln_bwd_kernel (launched by _ln_bwd_call, the custom VJP of
// fused_ln_mlp_residual) and, as K2', _make_bwd_kernel (launched by _bwd,
// the custom VJP of fused_mlp). Without LN, y is x itself, dx = dy and
// there are no LayerNorm gradients; everything else is the same code.
//
// What bounds it on the H100: five products (u, dh, dy, dw1, dw2), 10 N C H
// operations on the tensor cores, against 6 N C bytes of x, do in and dx out
// (bf16): 10 H / 6 operations a byte, 640 at H = 384, above the card's ~295,
// so the tensor cores bound it at the models' widths. The TPU kernel sums dw1
// and dw2 in place over its sequential grid; on a parallel grid, summing them
// per row tile in device memory costs 16 C H bytes a tile (about 190 GB per
// ptx train step), which was this kernel's first design and its bottleneck.
//
// The design, for Hopper, in four passes on the stream:
//   1. The row kernel recomputes, per tile of BM rows, the LN'd rows y and
//      takes do into shared memory (bf16 rows padded by 16 bytes), and walks
//      the hidden width in chunks of 64 columns: u = y @ w1[:, chunk] and dh =
//      do @ w2[chunk, :]^T on register-resident mma.sync fragments (one warp
//      per 16 rows x 64 / WC columns), over 64-deep slices of w1 and w2 staged
//      through a three-buffer ring of cp.async copies with the tails past C and
//      H zeroed (the weights pass as they are: no padded copy); then GELU and
//      GELU' on the fragments, du = dh GELU'(u), and the streams h and du (N,
//      H) in T, rounded where the TPU kernel rounds them; db1 sums the fp32
//      du over the tile's rows (warp shuffles, then the warps in order) into
//      the block's slot. With the LN, y goes out as a stream (N, C) too.
//   2. dy = du @ w1^T (N, C) fp32 on the tensor cores (mma_gemm.cuh
//      gemm_rows): the row kernel would have to hold a (BM, C) fp32 tile
//      across all of H (196 KB at C = 768 and 64 rows), so dy leaves it.
//   3. The LayerNorm backward per row with the residual's do (ln_rows.cuh),
//      and the column sums d ln_g, d ln_b, db2 into the block's slot.
//   4. dw1 = y^T du and dw2 = h^T do from the streams, split-K over the rows
//      (mma_gemm.cuh wgrad), the splits summed in a fixed order.
// The small gradients' slots (one per block: db1 from pass 1's persistent
// grid, the rest from pass 3's, which runs on every slot to hide its rows'
// latency) are summed by reduce_slots_kernel in a fixed order. No atomics
// anywhere: two launches give the same bits.
//
// Operands of every product are rounded to T where the TPU kernel rounds
// them (y, h, du, do); every sum is fp32; db1 sums the fp32 du. GELU' is the
// derivative of the tanh form under bf16 and of the exact erf form in fp32.
// fp32 tensors (the tests' path) take the same passes with FMA products in
// shared memory (common.cuh), no TF32. Any C and any H.
#include "ln_rows.cuh"
#include "mlp_common.cuh"

namespace lcbi {

constexpr int kF32SliceK = 32;                // depth of a staged fp32 slice
constexpr int kLdU = kHidChunk + 4;           // fp32 (BM, 64) tiles

// Slot offsets (floats) of each small gradient inside one block's slot; -1
// where the variant has none. db1 comes first, written by the row kernel;
// the LayerNorm pass writes the rest.
struct MlpSlots {
  int db1, db2, dg, dbln;
};

struct MlpRowLayout {
  int lds;
  size_t off_dos, off_w, off_part, bytes;
};

// bf16: ys, dos (bm, Cs + 8), the ring of kRing (w1 slice, w2 slice) stages,
// the warps' db1 partials (bm / 16, 64).
__host__ __device__ inline MlpRowLayout mlp_row_layout_mma(int bm, int C) {
  MlpRowLayout L;
  L.lds = round_up16(C) + 8;
  L.off_dos = align128((size_t)bm * L.lds * 2);
  L.off_w = L.off_dos + align128((size_t)bm * L.lds * 2);
  L.off_part = L.off_w + align128((size_t)kRing * 2 * kSlice * 2);
  L.bytes = L.off_part + align128((size_t)(bm / 16) * kHidChunk * 4);
  return L;
}

// fp32: ys, dos (bm, C + 4), u and dh (bm, 64), a w1 slice (32, 64) and a w2
// slice (64, 32).
__host__ __device__ inline MlpRowLayout mlp_row_layout_f32(int bm, int C) {
  MlpRowLayout L;
  L.lds = C + 4;
  L.off_dos = align128((size_t)bm * L.lds * 4);
  L.off_w = L.off_dos + align128((size_t)bm * L.lds * 4);   // u, dh, then the slices
  L.off_part = 0;
  L.bytes = L.off_w + align128((size_t)2 * bm * kLdU * 4) +
            align128((size_t)kF32SliceK * kLdU * 4) + align128((size_t)kHidChunk * (kF32SliceK + 4) * 4);
  return L;
}

// h (and du) of one row's pair of columns (col, col + 1) to a (N, H) stream.
__device__ __forceinline__ void store_pair(bf16* __restrict__ s, size_t r, int col, int H,
                                           float a, float b) {
  bf16* p = s + r * H + col;
  if (col + 1 < H && H % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    if (col < H) p[0] = __float2bfloat16(a);
    if (col + 1 < H) p[1] = __float2bfloat16(b);
  }
}

// Pass 1 in bf16: BM = 16 WR rows a tile, warps WR x WC over (BM, 64).
template <int WR>
__global__ void __launch_bounds__(kThreads)
mlp_rows_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_g,
                    const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                    const float* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ dout, bf16* __restrict__ y_out,
                    bf16* __restrict__ h_out, bf16* __restrict__ du_out,
                    float* __restrict__ slots, size_t P, int off_db1, int N, int C, int H,
                    int has_ln, long long tiles) {
  constexpr int BM = 16 * WR, WC = 8 / WR, NCOL = kHidChunk / WC, NT = NCOL / 8;
  static_assert(NT % 2 == 0, "warps take pairs of 8-column tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpRowLayout L = mlp_row_layout_mma(BM, C);
  bf16* ys = reinterpret_cast<bf16*>(smem);
  bf16* dos = reinterpret_cast<bf16*>(smem + L.off_dos);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.off_w);
  float* part = reinterpret_cast<float*>(smem + L.off_part);   // (WR, 64)
  const int Cs = round_up16(C);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WC, wn = warp % WC, g = lane / 4, t = lane % 4;
  const bool vec_h = H % 8 == 0, vec_c = C % 8 == 0;
  const int nks = (Cs + kSliceK - 1) / kSliceK, nch = (H + kHidChunk - 1) / kHidChunk;
  const int total = nks * nch;
  float* slot = slots + (size_t)blockIdx.x * P;

  // stage `it` of the tile: chunk it / nks, depth slice it % nks, into buffer it % kRing
  auto prefetch = [&](int it) {
    const int h0 = (it / nks) * kHidChunk, k0 = (it % nks) * kSliceK;
    bf16* w1s = ring + (it % kRing) * 2 * kSlice;
    bf16* w2s = w1s + kSlice;
    stage_slice16<kSliceK, kHidChunk>(w1s, kLdW, w1, k0, C, h0, H, H, vec_h);   // w1[k][h]
    stage_slice16<kHidChunk, kSliceK>(w2s, kLdW, w2, h0, H, k0, C, C, vec_c);   // w2[h][k]
  };

  const long long t_begin = tiles * blockIdx.x / gridDim.x;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const bool first = tile == t_begin;
    const size_t r0 = (size_t)tile * BM;
    const int rows = min(BM, N - (int)r0);
    for (int e = threadIdx.x; e < BM * (Cs / 8); e += kThreads) {
      const int r = e / (Cs / 8), c = (e % (Cs / 8)) * 8;
      stage16(dos + r * L.lds + c, dout, (long long)r0 + r, N, c, C, C, vec_c);
    }
    prefetch(0);
    cp_async_commit();
    if (total > 1) prefetch(1);
    cp_async_commit();
    layernorm_rows(x + r0 * C, rows, BM, C, ln_g, ln_b, has_ln, ys, L.lds, nullptr, nullptr, Cs);

    float au[NT][4], adh[NT][4];
    for (int it = 0; it < total; ++it) {
      // stage it is in; the buffer of stage it + 2 was last read at it - 1
      cp_async_wait<1>();
      __syncthreads();
      if (it + 2 < total) prefetch(it + 2);
      cp_async_commit();
      if (it == 0 && has_ln) {   // the stream y: dw1's left operand
        for (int e = threadIdx.x; e < rows * C; e += kThreads) {
          const int r = e / C, c = e % C;
          y_out[(r0 + r) * C + c] = ys[r * L.lds + c];
        }
      }
      const int ch = it / nks, ks = it % nks, k0 = ks * kSliceK, kw = min(kSliceK, Cs - k0);
      if (ks == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) au[j][e] = adh[j][e] = 0.f;
      }
      const bf16* w1s = ring + (it % kRing) * 2 * kSlice;
      const bf16* w2s = w1s + kSlice;
      // one 16-deep step of both products; a full slice unrolls whole, so that
      // the next step's fragment loads go out ahead of this step's mma
      auto step = [&](int kk) {
        uint32_t ay[4], ad[4];
        frag_a(ay, ys, L.lds, wm * 16, k0 + kk, lane);
        frag_a(ad, dos, L.lds, wm * 16, k0 + kk, lane);
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t b[4];
          frag_b_cols(b, w1s, kLdW, kk, wn * NCOL + 16 * p, lane);
          mma_bf16(au[2 * p], ay, b[0], b[1]);
          mma_bf16(au[2 * p + 1], ay, b[2], b[3]);
          frag_b_rows(b, w2s, kLdW, wn * NCOL + 16 * p, kk, lane);
          mma_bf16(adh[2 * p], ad, b[0], b[1]);
          mma_bf16(adh[2 * p + 1], ad, b[2], b[3]);
        }
      };
      if (kw == kSliceK) {
#pragma unroll
        for (int kk = 0; kk < kSliceK; kk += 16) step(kk);
      } else {
        for (int kk = 0; kk < kw; kk += 16) step(kk);
      }
      if (ks == nks - 1) {
        // GELU, GELU' on the fragments; the streams h, du; db1's partials.
        // Pad rows have do = 0, so dh = du = 0 there; columns past H have
        // zero weights, so dh = du = 0 there too.
        const int h0 = ch * kHidChunk;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int cl = wn * NCOL + j * 8 + 2 * t, col = h0 + cl;
          const float bb0 = col < H ? b1[col] : 0.f, bb1 = col + 1 < H ? b1[col + 1] : 0.f;
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const size_t r = r0 + wm * 16 + g + 8 * hh;
            float ga, da, gb, db;
            gelu_and_grad<bf16>(au[j][2 * hh] + bb0, ga, da);
            gelu_and_grad<bf16>(au[j][2 * hh + 1] + bb1, gb, db);
            const float d0 = adh[j][2 * hh] * da, d1 = adh[j][2 * hh + 1] * db;
            s0 += d0;
            s1 += d1;
            if (r < (size_t)N) {
              store_pair(h_out, r, col, H, ga, gb);
              store_pair(du_out, r, col, H, d0, d1);
            }
          }
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, o);
            s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          }
          if (g == 0) {
            part[wm * kHidChunk + cl] = s0;
            part[wm * kHidChunk + cl + 1] = s1;
          }
        }
        __syncthreads();
        if (threadIdx.x < kHidChunk && h0 + (int)threadIdx.x < H) {
          float s = 0.f;
#pragma unroll
          for (int w = 0; w < WR; ++w) s += part[w * kHidChunk + threadIdx.x];
          float* dst = slot + off_db1 + h0 + threadIdx.x;
          *dst = (first ? 0.f : *dst) + s;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the next tile rewrites ys, dos and the ring
  }
}

// Pass 1 in fp32: the same tile walk on FMA products in shared memory.
__global__ void __launch_bounds__(kThreads)
mlp_rows_f32_kernel(const float* __restrict__ x, const float* __restrict__ ln_g,
                    const float* __restrict__ ln_b, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ dout, float* __restrict__ y_out,
                    float* __restrict__ h_out, float* __restrict__ du_out,
                    float* __restrict__ slots, size_t P, int off_db1, int N, int C, int H,
                    int has_ln, int bm, long long tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpRowLayout L = mlp_row_layout_f32(bm, C);
  constexpr int kLdS2 = kF32SliceK + 4;
  float* ys = reinterpret_cast<float*>(smem);
  float* dos = reinterpret_cast<float*>(smem + L.off_dos);
  float* u = reinterpret_cast<float*>(smem + L.off_w);
  float* dh = u + (size_t)bm * kLdU;
  float* w1s = reinterpret_cast<float*>(smem + L.off_w + align128((size_t)2 * bm * kLdU * 4));
  float* w2s = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(w1s) +
                                        align128((size_t)kF32SliceK * kLdU * 4));
  float* slot = slots + (size_t)blockIdx.x * P;
  const long long t_begin = tiles * blockIdx.x / gridDim.x;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const bool first = tile == t_begin;
    const size_t r0 = (size_t)tile * bm;
    const int rows = min(bm, N - (int)r0);
    layernorm_rows(x + r0 * C, rows, bm, C, ln_g, ln_b, has_ln, ys, L.lds);
    for (int e = threadIdx.x; e < bm * C; e += kThreads) {
      const int r = e / C, c = e % C;
      dos[r * L.lds + c] = r < rows ? dout[(r0 + r) * C + c] : 0.f;
    }
    __syncthreads();
    if (has_ln) {
      for (int e = threadIdx.x; e < rows * C; e += kThreads)
        y_out[r0 * C + e] = ys[(e / C) * L.lds + e % C];
    }
    for (int h0 = 0; h0 < H; h0 += kHidChunk) {
      for (int k0 = 0; k0 < C; k0 += kF32SliceK) {
        const int kw = min(kF32SliceK, C - k0);
        __syncthreads();
        for (int e = threadIdx.x; e < kF32SliceK * kHidChunk; e += kThreads) {
          const int k = e / kHidChunk, j = e % kHidChunk;   // w1[k0 + k][h0 + j]
          w1s[k * kLdU + j] = k < kw && h0 + j < H ? w1[(size_t)(k0 + k) * H + h0 + j] : 0.f;
          const int n = e / kF32SliceK, kk = e % kF32SliceK;  // w2[h0 + n][k0 + kk]
          w2s[n * kLdS2 + kk] = kk < kw && h0 + n < H ? w2[(size_t)(h0 + n) * C + k0 + kk] : 0.f;
        }
        __syncthreads();
        gemm<false, false>(u, kLdU, ys + k0, L.lds, w1s, kLdU, bm, kHidChunk, kw, k0 > 0);
        gemm<false, true>(dh, kLdU, dos + k0, L.lds, w2s, kLdS2, bm, kHidChunk, kw, k0 > 0);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < bm * kHidChunk; e += kThreads) {
        const int r = e / kHidChunk, j = e % kHidChunk, col = h0 + j;
        float gv, dg;
        gelu_and_grad<float>(u[r * kLdU + j] + (col < H ? b1[col] : 0.f), gv, dg);
        const float du = dh[r * kLdU + j] * dg;
        dh[r * kLdU + j] = du;
        if (r < rows && col < H) {
          h_out[(r0 + r) * H + col] = gv;
          du_out[(r0 + r) * H + col] = du;
        }
      }
      __syncthreads();
      if (threadIdx.x < kHidChunk && h0 + (int)threadIdx.x < H) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r) s += dh[r * kLdU + threadIdx.x];
        float* dst = slot + off_db1 + h0 + threadIdx.x;
        *dst = (first ? 0.f : *dst) + s;
      }
    }
    __syncthreads();
  }
}

// Rows a tile of pass 1: the most (of 128, 64, 32 in bf16; 64, 32, 16 in
// fp32) whose layout fits in shared memory; 0 if none does.
template <typename T> int mlp_row_tile(int C, size_t* bytes) {
  const size_t limit = (size_t)max_dynamic_smem();
  for (int bm = sizeof(T) == 2 ? 128 : 64; bm >= (sizeof(T) == 2 ? 32 : 16); bm /= 2) {
    *bytes = sizeof(T) == 2 ? mlp_row_layout_mma(bm, C).bytes : mlp_row_layout_f32(bm, C).bytes;
    if (*bytes <= limit) return bm;
  }
  return 0;
}

template <typename T, typename K>
int launch_rows(K kernel, size_t bytes, long long tiles, int max_slots, int* G) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  *G = persistent_blocks(kernel, bytes, tiles, max_slots);
  return *G > 0 ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_bwd(const void* x, const void* ln_g, const void* ln_b, const void* w1, const void* b1,
               const void* w2, const void* dout, void* dx, void* ys, void* hs, void* dus,
               float* dy, float* partials, int S, float* wgrads, float* slots, float* red, size_t P,
               MlpSlots off, int max_slots, int N, int C, int H, int has_ln,
               cudaStream_t stream) {
  size_t bytes = 0;
  const int bm = mlp_row_tile<T>(C, &bytes);
  if (bm == 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (N + bm - 1) / bm;
  const T* xt = static_cast<const T*>(x);
  const T* dot = static_cast<const T*>(dout);
  int G = 0, e = 0;
  if constexpr (sizeof(T) == 2) {
    auto kernel = bm == 128 ? mlp_rows_mma_kernel<8> : bm == 64 ? mlp_rows_mma_kernel<4>
                                                                : mlp_rows_mma_kernel<2>;
    if ((e = launch_rows<T>(kernel, bytes, tiles, max_slots, &G)) != 0) return e;
    kernel<<<G, kThreads, bytes, stream>>>(
        xt, static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
        static_cast<const T*>(w1), static_cast<const float*>(b1), static_cast<const T*>(w2), dot,
        static_cast<T*>(ys), static_cast<T*>(hs), static_cast<T*>(dus), slots, P, off.db1, N, C, H,
        has_ln, tiles);
  } else {
    if ((e = launch_rows<T>(mlp_rows_f32_kernel, bytes, tiles, max_slots, &G)) != 0) return e;
    mlp_rows_f32_kernel<<<G, kThreads, bytes, stream>>>(
        xt, static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
        static_cast<const T*>(w1), static_cast<const float*>(b1), static_cast<const T*>(w2), dot,
        static_cast<T*>(ys), static_cast<T*>(hs), static_cast<T*>(dus), slots, P, off.db1, N, C, H,
        has_ln, bm, tiles);
  }
  if ((e = (int)cudaGetLastError()) != 0) return e;
  // dy = du @ w1^T (w1 is (C, H): stored (N = C, K = H))
  if ((e = launch_gemm_rows<T, true>(static_cast<const T*>(dus), H, static_cast<const T*>(w1), H,
                                     N, C, H, dy, stream)) != 0)
    return e;
  // the row pass runs on all max_slots blocks (latency-bound rows want many
  // warps): its slot columns (from db2 on) sum over max_slots, db1's over G
  if ((e = launch_ln_bwd<T>(dy, x, dout, ln_g, dx, slots, P, LnSlots{off.dg, off.dbln, off.db2},
                            max_slots, N, C, has_ln, stream)) != 0)
    return e;
  if ((e = launch_reduce(slots, G, P, (size_t)off.db2, red, stream)) != 0) return e;
  if ((e = launch_reduce(slots + off.db2, max_slots, P, P - off.db2, red + off.db2, stream)) != 0)
    return e;
  // dw1 = y^T du (C, H) at 0, dw2 = h^T do (H, C) after it
  Products<T> ps{};
  ps.count = 2;
  ps.p[0] = Product<T>{has_ln ? static_cast<const T*>(ys) : xt, static_cast<const T*>(dus), C, H,
                       C, H, 0};
  ps.p[1] = Product<T>{static_cast<const T*>(hs), dot, H, C, H, C, (size_t)C * H};
  return launch_split_k<T>(ps, N, S, (size_t)2 * C * H, partials, wgrads, stream);
}

}  // namespace lcbi

// Row splits of the weight-gradient products for N rows at C, H: the wrapper
// allocates that many partials of 2 C H floats. 0 on a device query error.
extern "C" int lcbi_fused_mlp_wgrad_splits(long long N, int C, int H, int is_bf16) {
  const int tile = is_bf16 ? lcbi::kMmaTile : lcbi::kF32Tile;
  const long long tiles = 2LL * lcbi::ceil_div(C, tile) * lcbi::ceil_div(H, tile);
  return lcbi::wgrad_splits_for(N, tiles);
}

namespace {

int fused_bwd(const void* x, const void* ln_g, const void* ln_b, const void* w1, const void* b1,
              const void* w2, const void* dout, void* dx, void* ys, void* hs, void* dus, void* dy,
              void* partials, int S, void* wgrads, void* slots, void* out, int N, int C, int H,
              int is_bf16, int max_slots, long long P, lcbi::MlpSlots off, int has_ln,
              void* stream) {
  (void)cudaGetLastError();
  if (N <= 0 || C <= 0 || H <= 0 || max_slots < 1 || P % 8 != 0 || S < 1 || S > N ||
      (has_ln && ys == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f[5] = {static_cast<float*>(dy), static_cast<float*>(partials),
                 static_cast<float*>(wgrads), static_cast<float*>(slots),
                 static_cast<float*>(out)};
  if (is_bf16)
    return lcbi::launch_bwd<__nv_bfloat16>(x, ln_g, ln_b, w1, b1, w2, dout, dx, ys, hs, dus, f[0],
                                           f[1], S, f[2], f[3], f[4], (size_t)P, off, max_slots,
                                           N, C, H, has_ln, s);
  return lcbi::launch_bwd<float>(x, ln_g, ln_b, w1, b1, w2, dout, dx, ys, hs, dus, f[0], f[1], S,
                                 f[2], f[3], f[4], (size_t)P, off, max_slots, N, C, H, has_ln, s);
}

}  // namespace

// x, dout, dx: (N, C) in T (fp32 if is_bf16 == 0, else bf16); w1: (C, H) and
// w2: (H, C) in T at the true widths; ln_g, ln_b: (C,) and b1: (H,) fp32.
// Scratch: ys (N, C), hs and dus (N, H) in T; dy (N, C) fp32; partials S x
// 2CH fp32 (S from lcbi_fused_mlp_wgrad_splits). wgrads: 2CH fp32 receives
// [dw1 (C, H) | dw2 (H, C)]. slots: max_slots x P fp32 scratch (P a multiple
// of 8; offsets in floats inside a block's slot: db1 (H), db2, dg, dbln (C)).
// out: (P,) fp32, the slots summed. All pointers 32-byte aligned. Returns
// cudaGetLastError() of the launches.
extern "C" int lcbi_fused_ln_mlp_bwd(const void* x, const void* ln_g, const void* ln_b,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* dout, void* dx, void* ys, void* hs, void* dus,
                                     void* dy, void* partials, int S, void* wgrads, void* slots,
                                     void* out, int N, int C, int H, int is_bf16, int max_slots,
                                     long long P, int off_db1, int off_db2, int off_dg,
                                     int off_dbln, void* stream) {
  return fused_bwd(x, ln_g, ln_b, w1, b1, w2, dout, dx, ys, hs, dus, dy, partials, S, wgrads,
                   slots, out, N, C, H, is_bf16, max_slots, P,
                   lcbi::MlpSlots{off_db1, off_db2, off_dg, off_dbln}, 1, stream);
}

// K2', the backward of the MLP without LayerNorm or residual: dx, [dw1 | dw2]
// in wgrads, and db1 (H), db2 (C) in the slots. Operands as
// lcbi_fused_ln_mlp_bwd without ln_g, ln_b, ys and their slots.
extern "C" int lcbi_fused_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* dout, void* dx, void* hs, void* dus, void* dy,
                                  void* partials, int S, void* wgrads, void* slots, void* out,
                                  int N, int C, int H, int is_bf16, int max_slots, long long P,
                                  int off_db1, int off_db2, void* stream) {
  return fused_bwd(x, nullptr, nullptr, w1, b1, w2, dout, dx, nullptr, hs, dus, dy, partials, S,
                   wgrads, slots, out, N, C, H, is_bf16, max_slots, P,
                   lcbi::MlpSlots{off_db1, off_db2, -1, -1}, 0, stream);
}
