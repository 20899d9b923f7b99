"""K2's bf16 forward tiles at the ptx stage shapes, timed against variants:
``python -m long_context_biomedical_imaging_tpu_torch.utils.k2_tiles`` on a
card (``nvcc`` and a CUDA build of PyTorch).

Each variant is a copy of ``csrc/fused_mlp.cu`` with one or more lines
replaced (another warp layout for a width class in ``launch_bf16``, or one
block an SM for every class), built with the package's nvcc flags into
``build/k2_tiles/`` (gitignored). At each ptx stage (batch 4: N rows of C
channels, H = 4C) it runs through the library's C entry on bf16 operands:
its largest error relative to the plain version, the median time of 7 calls
after 2, and the sum over the stages of the time times the stage's depth
(the forward's share of one ptx train step). The shipped source comes first.
One line per variant, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor

SOURCE = "fused_mlp.cu"
C192 = "if (C <= 192) return launch_mma<2, 3, 2, LN>"
C384 = "if (C <= 384) return launch_mma<2, 6, 2, LN>"
C768 = "    return launch_mma<1, 6, 2, LN>"
MIN_BLOCKS = "static constexpr int kMinBlocks = MR * NO <= 6 ? 2 : 1;"

# (label, [(shipped text, replacement)])
VARIANTS = [
    ("shipped", []),
    ("C <= 192: a warp owns 16 rows' whole width", [(C192, C192.replace("2, 3, 2", "8, 12, 1"))]),
    ("C <= 192: 16 rows a warp, 2 column groups", [(C192, C192.replace("2, 3, 2", "4, 6, 1"))]),
    ("C <= 384: 16 rows a warp, 2 column groups", [(C384, C384.replace("2, 6, 2", "4, 12, 1"))]),
    ("C <= 384: 32 rows a block, 8 column groups", [(C384, C384.replace("2, 6, 2", "1, 3, 2"))]),
    ("C > 384: 16 rows a warp, 4 column groups", [(C768, C768.replace("1, 6, 2", "2, 12, 1"))]),
    ("one block an SM at every width", [(MIN_BLOCKS, "static constexpr int kMinBlocks = 1;")]),
]


def build_variant(index, replacements, out_dir, source=SOURCE):
    """Build one variant of csrc/<source>; returns (library path or None,
    compiler log)."""
    from ..ops import cuda_build as cb

    text = (cb.CSRC_DIR / source).read_text()
    for old, new in replacements:
        if text.count(old) != 1 or new == old:
            raise RuntimeError(f"{source} no longer holds {old!r} once: update VARIANTS")
        text = text.replace(old, new)
    src = out_dir / f"variant{index}_{source}"
    src.write_text(text)
    lib = out_dir / f"libvariant{index}.so"
    proc = subprocess.run([cb.find_nvcc(), *cb.NVCC_FLAGS, "-I", str(cb.CSRC_DIR), "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    return (lib if proc.returncode == 0 else None), proc.stdout + proc.stderr


def median_event_ms(torch, call, warmup=2, reps=7):
    """The median of reps timed calls (CUDA events, each synchronised) after
    warmup untimed ones."""
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def main():
    import torch

    from ..ops import cuda_build as cb
    from ..ops import fused_mlp as fm

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    stages = [(96, 512, 2), (192, 256, 2), (384, 128, 6), (768, 64, 2)]   # C, grid, depth
    out_dir = cb.BUILD_DIR.parent / "k2_tiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda iv: build_variant(iv[0], iv[1][1], out_dir),
                              enumerate(VARIANTS)))
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(2)

    def mk(shape, scale=0.3):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    cases = []
    for c, grid, depth in stages:
        n, h = 4 * grid * grid, 4 * c
        args = [mk((n, c), 1.0).bfloat16(), mk((c,)) + 1.0, mk((c,)), mk((c, h)).bfloat16(),
                mk((h,)), mk((h, c)).bfloat16(), mk((c,))]
        cases.append((c, n, h, depth, args, fm.fused_ln_mlp_residual_plain(*args).float()))
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for (label, _), (lib, log) in zip(VARIANTS, built):
        if lib is None:
            print(f"{label}: build failed\n{log[-2000:]}", flush=True)
            continue
        fn = ctypes.CDLL(str(lib)).lcbi_fused_ln_mlp_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        parts, step = [], 0.0
        for c, n, h, depth, args, ref in cases:
            out = torch.empty_like(args[0])
            ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*args, out)]

            def call():
                code = fn(*ptrs, n, c, h, 1, stream)
                if code != 0:
                    raise RuntimeError(f"{label} at C={c}: CUDA error {code}")

            ms = median_event_ms(torch, call)
            err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            step += depth * ms
            parts.append(f"C={c} {ms:.3f} ms (rel err {err:.1e})")
        print(f"{label}: " + ", ".join(parts) + f"; per ptx step {step:.2f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
