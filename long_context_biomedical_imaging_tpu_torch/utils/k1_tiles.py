"""K1's bf16 forward tiles at the ptx stage shapes, timed against variants:
``python -m long_context_biomedical_imaging_tpu_torch.utils.k1_tiles`` on a
card (``nvcc`` and a CUDA build of PyTorch).

Each variant is a copy of ``csrc/hyena_window.cu`` with one or more lines
replaced (another tile for a width class in ``launch_bf16``, another rule
for the blocks an SM), built with the package's nvcc flags into
``build/k1_tiles/`` (gitignored) as ``utils/k2_tiles.py`` builds K2's. At
each ptx stage (batch 4: 16-token windows, C channels, 5 short taps, the
folded LN) it runs through the library's C entry on bf16 operands: its
largest error relative to the plain version, the median time of 7 calls
after 2, and the sum over the stages of the time times the stage's depth
(the forward's share of one ptx train step); a tile whose shared memory
does not fit reads "refused". The shipped source comes first. One line per
variant, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor

from .k2_tiles import build_variant, median_event_ms

SOURCE = "hyena_window.cu"
C96 = "if (C <= 96) return K1_LAUNCH(4, 3, 1, 96, 32);"
C384 = "if (C <= 384) return K1_LAUNCH(2, 6, 2, 192, 32);"
C768 = "if (k1_fits<1, 6, 2, 256, 16>(C)) return K1_LAUNCH(1, 6, 2, 256, 16);"
RING = "constexpr int kK1Ring = 3;"
MIN_BLOCKS = "static constexpr int kMinBlocks = MR * NO <= 6 ? 2 : 1;"

# (label, [(shipped text, replacement)]): the shipped tiles against the
# alternatives that decided them
VARIANTS = [
    ("shipped", []),
    ("C <= 96: 128 rows, a warp owning its 16 rows' whole width",
     [(C96, C96.replace("4, 3, 1", "8, 6, 1"))]),
    ("C <= 96: win slices 32 deep", [(C96, C96.replace("96, 32", "32, 32"))]),
    ("C <= 384: win slices 64 deep", [(C384, C384.replace("192, 32", "64, 32"))]),
    ("C > 384: win slices 64 deep", [(C768, C768.replace("256, 16", "64, 16"))]),
    ("a ring of 4 slots, 3 stages ahead", [(RING, RING.replace("3", "4"))]),
    ("one block an SM at every width", [(MIN_BLOCKS, "static constexpr int kMinBlocks = 1;")]),
]


def main():
    import torch

    from ..ops import cuda_build as cb
    from ..ops import hyena_window as hw

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    stages = [(96, 512, 2), (192, 256, 2), (384, 128, 6), (768, 64, 2)]   # C, grid, depth
    out_dir = cb.BUILD_DIR.parent / "k1_tiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda iv: build_variant(iv[0], iv[1][1], out_dir, SOURCE),
                              enumerate(VARIANTS)))
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)

    def mk(shape, scale=0.3):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    cases = []
    for c, grid, depth in stages:
        bw, v = 4 * (grid // 4) ** 2, 16
        ws, kl = hw.prepare_taps(mk((3 * c, 5)), mk((c, v)), mk((c,)))
        args = [mk((bw, v, c), 1.0).bfloat16(), mk((c,)) + 1.0, mk((c,)),
                mk((c, 3 * c)).bfloat16(), mk((3 * c,)), ws, mk((3 * c,)), kl,
                mk((c, c)).bfloat16(), mk((c,))]
        x, g, b, w_in, b_in, _, bs, _, w_out, b_out = args
        ref = hw._plain_on_taps(x, w_in, b_in, ws, bs, kl, w_out, b_out, g, b).float()
        cases.append((c, bw, v, depth, args, ref))
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for (label, _), (lib, log) in zip(VARIANTS, built):
        if lib is None:
            print(f"{label}: build failed\n{log[-2000:]}", flush=True)
            continue
        fn = ctypes.CDLL(str(lib)).lcbi_hyena_window_fwd
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        parts, step = [], 0.0
        for c, bw, v, depth, args, ref in cases:
            out = torch.empty_like(args[0])
            ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*args, out)]
            if fn(*ptrs, bw, v, c, 5, 1, 1, stream) != 0:   # a tile that does not fit
                parts.append(f"C={c} refused")
                step = float("nan")
                continue
            ms = median_event_ms(torch, lambda: fn(*ptrs, bw, v, c, 5, 1, 1, stream))
            err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            step += depth * ms
            parts.append(f"C={c} {ms:.3f} ms (rel err {err:.1e})")
        print(f"{label}: " + ", ".join(parts) + f"; per ptx step {step:.2f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
