"""The bf16 forwards of K3 and K4 at their main paths' stage shapes, timed
against variants: ``python -m long_context_biomedical_imaging_tpu_torch.utils.k34_tiles``
on a card (``nvcc`` and a CUDA build of PyTorch).

Each variant is a copy of ``csrc/hyena_chunked.cu`` (K3) or
``csrc/mamba_window.cu`` (K4) with one or more lines replaced (another tile
for a width class, another ring depth, another rule for the blocks an SM),
built with the package's nvcc flags into ``build/k34_tiles/`` (gitignored)
as ``utils/k2_tiles.py`` builds K2's. K3 runs at the emb stages (batch 4:
512-token windows, C = 96 and 192, 5 short taps), K4 at the vessel stages
(batch 4: 64-token windows, C = 96, 192 and 384, d_state 8), both with the
folded LN, through the library's C entry on bf16 operands: its largest
error relative to the plain version, the median time of 7 calls after 2,
and the sum over the stages of the time times the stage's depth (the
forward's share of one emb or vessel train step); a launch the card refuses
reads "refused". The shipped sources come first. One line per variant,
then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor

from .fwd_split import EMB_K3, VESSEL_K4, k3_args, k4_args
from .k2_tiles import build_variant, median_event_ms

K3_SOURCE, K4_SOURCE = "hyena_chunked.cu", "mamba_window.cu"
K3_DEPTHS, K4_DEPTHS = (2, 2), (2, 2, 6)
K4_NARROW = "using K4Narrow = K4Cfg<64, 96, 128, 32, 3>;"
K4_MID = "using K4Mid = K4Cfg<32, 64, 64, 32, 3>;"
K4_WIDE = "using K4Wide = K4Cfg<64, 128, 128, 64, 3>;"
K3_RING = "constexpr int kFwdRing = 3;"
K3_SLICE = "constexpr int kWinSlice = 64;"

# (source, label, [(shipped text, replacement)]): the shipped tiles against
# the alternatives that decided them
VARIANTS = [
    (K3_SOURCE, "shipped", []),
    (K3_SOURCE, "a ring of 4 slots", [(K3_RING, K3_RING.replace("3", "4"))]),
    (K3_SOURCE, "win slices 32 deep", [(K3_SLICE, K3_SLICE.replace("64", "32"))]),
    (K4_SOURCE, "shipped", []),
    (K4_SOURCE, "C <= 192: a ring of 4 slots",
     [(K4_NARROW, K4_NARROW.replace(", 3>", ", 4>")), (K4_MID, K4_MID.replace(", 3>", ", 4>"))]),
    (K4_SOURCE, "C <= 96: chunks of 32, slices 64 deep, passes of 64",
     [(K4_NARROW, "using K4Narrow = K4Cfg<32, 64, 64, 32, 3>;")]),
    (K4_SOURCE, "C <= 96: wout slabs 64 deep", [(K4_NARROW, K4_NARROW.replace("128, 32", "128, 64"))]),
    (K4_SOURCE, "C <= 192: chunks of 64, passes of 128 (one block an SM)",
     [(K4_MID, "using K4Mid = K4Cfg<64, 64, 128, 32, 3>;")]),
    (K4_SOURCE, "C > 192: chunks of 32, passes of 64",
     [(K4_WIDE, "using K4Wide = K4Cfg<32, 64, 64, 32, 3>;")]),
    (K4_SOURCE, "C > 192: win slices 64 deep, wout slabs 32 deep",
     [(K4_WIDE, "using K4Wide = K4Cfg<64, 64, 128, 32, 3>;")]),
    (K4_SOURCE, "C > 192: win slices 64 deep, wout slabs 32 deep, a ring of 6 slots",
     [(K4_WIDE, "using K4Wide = K4Cfg<64, 64, 128, 32, 6>;")]),
    (K4_SOURCE, "the scan's exps by __expf",
     [("        h[s] = expf(dl * A[s]) * h[s]", "        h[s] = __expf(dl * A[s]) * h[s]")]),
    (K4_SOURCE, "SiLU by __expf and __fdividef",
     [("          sv = u * sigmoidf(u);", "          sv = __fdividef(u, 1.f + __expf(-u));")]),
    # ablations (garbage out, timed only): where the row kernels' time goes
    (K3_SOURCE, "without the row kernel's LN",
     [("    layernorm_rows_inplace(ys + lo * L.lds, L.lds, hi - lo, C, ln_g, ln_b, has_ln);", "")]),
    (K3_SOURCE, "without the row kernel's convs",
     [("      chunk_convs<bf16>(z, ch * kChunkChannels, C, K, w, t0, V, plane, bin, ws, bs, g_out,\n"
       "                        x2_out);", "")]),
    (K3_SOURCE, "without the row kernel's products",
     [("            frag_a(a, ys, L.lds, mt * 16, k0 + kk, lane);\n"
       "            frag_b_cols(b, sl, kLdWin3, kk, n0, lane);\n"
       "            mma_bf16(za[i][0], a, b[0], b[1]);\n"
       "            mma_bf16(za[i][1], a, b[2], b[3]);", "")]),
    (K4_SOURCE, "without the scan", [("const int tasks = nwin * Dh * L", "const int tasks = 0")]),
    (K4_SOURCE, "without the LN",
     [("  layernorm_rows_inplace(ys, L.ld, rows, C, ln_g, ln_b, has_ln);", "")]),
    (K4_SOURCE, "without in_proj's products",
     [("          frag_a(a, ys, L.ld, mt * 16, k0 + kk, lane);\n"
       "          frag_b_cols(b, sl, Cf::kLdWin, kk, n0, lane);\n"
       "          mma_bf16(za[i][0], a, b[0], b[1]);\n"
       "          mma_bf16(za[i][1], a, b[2], b[3]);", "")]),
    (K4_SOURCE, "without the conv",
     [("        if (r >= BM) break;", "        if (r >= 0) break;")]),
]


def main():
    import torch

    from ..ops import cuda_build as cb
    from ..ops import hyena_window as hw
    from ..ops import mamba_window as mw

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out_dir = cb.BUILD_DIR.parent / "k34_tiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda iv: build_variant(iv[0], iv[1][2], out_dir, iv[1][0]),
                              enumerate(VARIANTS)))
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(2)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    cases = {K3_SOURCE: [], K4_SOURCE: []}
    with torch.no_grad():
        for (c, bw), depth in zip(EMB_K3, K3_DEPTHS):
            args = k3_args(torch, hw, gen, c, bw, dev)
            ref = hw.hyena_chunked_plain(*args).float()
            g = torch.empty(c, bw, 512, device=dev, dtype=torch.bfloat16)
            x2 = torch.empty(c, bw, 512, device=dev)
            x, w_in, b_in, ws, bs, m, w_out, b_out, lg, lb = args
            ptrs = [x, lg, lb, w_in, b_in, ws, bs, m, w_out, b_out, None, g, x2]
            ints = (bw, 512, c, 5, 128, 1, 1)
            cases[K3_SOURCE].append((c, depth, ptrs, ints, ref))
        for (c, bw), depth in zip(VESSEL_K4, K4_DEPTHS):
            args = k4_args(torch, mw, gen, c, bw, dev)
            ref = mw.mamba_window_plain(*args).float()
            x, w_xz, wconv, w_dbl, w_dt, dtb2, at, dskip, w_out, lg, lb = args
            ptrs = [x, lg, lb, w_xz, wconv, w_dbl, w_dt, dtb2, at, dskip, w_out, None, None]
            ints = (0, bw, 64, c, w_dt.shape[0], 8, 1, 1)
            cases[K4_SOURCE].append((c, depth, ptrs, ints, ref))
    for (source, label, _), (lib, log) in zip(VARIANTS, built):
        if lib is None:
            print(f"{source} {label}: build failed\n{log[-2000:]}", flush=True)
            continue
        k3 = source == K3_SOURCE
        fn = getattr(ctypes.CDLL(str(lib)), "lcbi_hyena_chunked_fwd" if k3 else
                     "lcbi_mamba_window_fwd")
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 if k3 else
                       [ctypes.c_void_p] * 13 + [ctypes.c_longlong] + [ctypes.c_int] * 7) + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        parts, step = [], 0.0
        for c, depth, ptrs, ints, ref in cases[source]:
            out = torch.empty(ref.shape, device=dev, dtype=torch.bfloat16)
            ptrs[10 if k3 else 11] = out
            cargs = [ctypes.c_void_p(None if t is None else t.data_ptr()) for t in ptrs]
            if fn(*cargs, *ints, stream) != 0:
                parts.append(f"C={c} refused")
                step = float("nan")
                continue
            ms = median_event_ms(torch, lambda: fn(*cargs, *ints, stream))
            err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            step += depth * ms
            parts.append(f"C={c} {ms:.3f} ms (rel err {err:.1e})")
        print(f"{'K3' if k3 else 'K4'} {label}: " + ", ".join(parts)
              + f"; per {'emb' if k3 else 'vessel'} step {step:.2f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
