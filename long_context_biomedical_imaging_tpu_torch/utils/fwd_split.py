"""Where the forwards of K3 and K4 spend their time, on one card:

    python3 -m long_context_biomedical_imaging_tpu_torch.utils.fwd_split [--csrc DIR]

First, for this tree's wrappers, one bf16 call (the folded LN) of K3's
forward at each emb stage shape and of K4's forward at each vessel stage
shape under ``torch.profiler``: the device time of each kernel the call
launches. K3's three launches (row kernel in, Toeplitz kernel, row kernel
out) split there by name.

With ``--csrc DIR``, K4's forward of an older tree (DIR: its ``csrc``; the
single-kernel forward of commit ac8adad, whose chain runs in one launch) is
split by ablation: variants of its ``mamba_window.cu`` with one part of the
chain removed (the scan; x_proj; the in_proj and out_proj products), built
with the package's nvcc flags into ``build/fwd_split/`` (gitignored) and
timed through the library's C entry at the vessel stage shapes beside the
source as it is. A part's share is the shipped time less the variant's. A
variant computes garbage and is timed only; it raises where the source no
longer holds the text it replaces.

Needs one card. Every number it prints is this card's, beside its name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
from pathlib import Path

EMB_K3 = [(96, 4096), (192, 512)]            # C, windows of 512 tokens (batch 4)
VESSEL_K4 = [(96, 16384), (192, 4096), (384, 1024)]   # C, windows of 64 tokens

SCAN = "for (int p = threadIdx.x; p < nwin * Dh; p += kThreads) {"
XPROJ = "x_proj<T>(acc, L.ldacc, wdbl, dbl, L.ldd, rows, Dh, W);"
# the two C x C products, run on no rows
IN_PROJ = "ys, L.lds, wxz, C, rows_pad, C, C, false);"
OUT_PROJ = "ys, L.lds, wout, C, rows_pad, C, C, false);"
ABLATIONS = [
    ("as it is", []),
    ("without the scan", [(SCAN, SCAN.replace("p < nwin * Dh", "p < 0"))]),
    ("without x_proj", [(XPROJ, "")]),
    ("without in_proj and out_proj", [(IN_PROJ, IN_PROJ.replace("rows_pad", "0")),
                                      (OUT_PROJ, OUT_PROJ.replace("rows_pad", "0"))]),
]


def k3_args(torch, hw, gen, c, bw, dev):
    def mk(shape, scale=0.3):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    v = 512
    ws, kl = hw.prepare_taps(mk((3 * c, 5)), mk((c, v), 0.1), mk((c,)))
    m = hw.build_chunk_toeplitz(kl, hw.pick_chunk(v)).bfloat16()
    return [mk((bw, v, c), 1.0).bfloat16(), mk((c, 3 * c)).bfloat16(), mk((3 * c,)), ws,
            mk((3 * c,)), m, mk((c, c)).bfloat16(), mk((c,)), mk((c,), 0.2) + 1.0,
            mk((c,), 0.2)]


def k4_args(torch, mw, gen, c, bw, dev, n=8):
    def mk(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    v, dh, r = 64, c // 2, -(-c // 16)
    dt = torch.exp(torch.rand(dh, generator=gen) * math.log(100.0) + math.log(1e-3))
    wconv, dtb2, at, dskip = mw.prepare_operands(
        mk((dh, 3), 0.5), mk((dh, 3), 0.5), (dt + torch.log(-torch.expm1(-dt))).to(dev),
        -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(dh, n),
        torch.ones(dh, device=dev))
    return [mk((bw, v, c), 1.0).bfloat16(), mk((c, c), c ** -0.5).bfloat16(), wconv,
            mk((dh, r + 2 * n), dh ** -0.5).bfloat16(), mk((r, dh), r ** -0.5).bfloat16(),
            dtb2, at, dskip, mk((c, c), c ** -0.5).bfloat16(), mk((c,), 0.2) + 1.0,
            mk((c,), 0.2)]


def profile_call(torch, fn):
    """{kernel name: device ms} of one call of fn (after one warm-up); where
    the profiler records no device time, {"the call (CUDA events)": its
    median time}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0)
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key.split("(")[0][:48]] = t / 1e3
    if not out:
        from .k2_tiles import median_event_ms

        out["the call (CUDA events)"] = median_event_ms(torch, fn)
    return out


def ablate_k4(torch, mw, csrc: Path, dev):
    from ..ops import cuda_build as cb
    from .k2_tiles import median_event_ms

    out_dir = cb.BUILD_DIR.parent / "fwd_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = []
    for i, (label, reps) in enumerate(ABLATIONS):
        text = (csrc / "mamba_window.cu").read_text()
        for old, new in reps:
            if text.count(old) != 1:
                raise RuntimeError(f"{csrc}/mamba_window.cu no longer holds {old!r} once")
            text = text.replace(old, new)
        src = out_dir / f"ablation{i}_mamba_window.cu"
        src.write_text(text)
        lib = out_dir / f"libablation{i}.so"
        proc = subprocess.run([cb.find_nvcc(), *cb.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{label}: build failed\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        libs.append(lib)
    gen = torch.Generator().manual_seed(4)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    shipped = {}
    for (label, _), lib in zip(ABLATIONS, libs):
        fn = ctypes.CDLL(str(lib)).lcbi_mamba_window_fwd
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        parts = []
        for c, bw in VESSEL_K4:
            x, w_xz, wconv, w_dbl, w_dt, dtb2, at, dskip, w_out, g, b = k4_args(
                torch, mw, gen, c, bw, dev)
            out = torch.empty_like(x)
            ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (x, g, b, w_xz, wconv, w_dbl, w_dt,
                                                            dtb2, at, dskip, w_out, out)]
            r = w_dt.shape[0]

            def call():
                code = fn(*ptrs, None, 0, bw, 64, c, r, 8, 1, 1, stream)
                if code != 0:
                    raise RuntimeError(f"{label}: launch failed ({code})")

            ms = median_event_ms(torch, call)
            shipped.setdefault(c, ms)
            parts.append(f"C={c} {ms:.3f} ms (shipped less this {shipped[c] - ms:.3f})")
        print(f"K4 fwd {label}: " + ", ".join(parts), flush=True)


def main(argv=None):
    import torch

    from ..ops import hyena_window as hw
    from ..ops import mamba_window as mw

    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", type=Path, help="an older tree's csrc, to split its K4 forward")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for c, bw in EMB_K3:
            a = k3_args(torch, hw, gen, c, bw, dev)
            split = profile_call(torch, lambda: hw.hyena_chunked_fwd(*a))
            print(f"K3 fwd BW={bw} V=512 C={c} bf16, device ms by kernel: "
                  + "; ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
            del a
        for c, bw in VESSEL_K4:
            a = k4_args(torch, mw, gen, c, bw, dev)
            split = profile_call(torch, lambda: mw.mamba_window_fwd(*a))
            print(f"K4 fwd BW={bw} V=64 C={c} bf16, device ms by kernel: "
                  + "; ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
            del a
        if args.csrc is not None:
            ablate_k4(torch, mw, args.csrc.resolve(), dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
