"""K7's forward (from zero carries and seeded with y), carry backward and
stitches and K9's forward, this tree against another checkout (its parent,
say), both trees' kernels in one process, in interleaved rounds:

    git archive <parent> | tar -x -C build/parent
    python3 -m long_context_biomedical_imaging_tpu_torch.utils.k79_fwd_ab build/parent

Each tree's ``csrc/selective_scan_long.cu``,
``selective_scan_long_carry_bwd.cu`` and ``selective_scan_window.cu`` are
built with this package's nvcc flags into ``build/k79_fwd_ab/`` (gitignored)
and called through their C entries (a tree whose K7 entries take no
softplus flag, as before d_state 1-16, is called without it) at K7's
vit65k_mamba call ((b, L, D) = (2, 65536, 192)) and K9's calls at micro_w7's
four stages (21,904, 5,476, 1,444 and 400 windows of 49 tokens, d = 48, 96,
192 and 384) and vessel's stage 3 (256 windows of 64 tokens, d = 384),
d_state 8, softplus on, fp32. Twelve rounds, the trees' order alternating; in each, every
kernel's mean time over 20 calls after 3, from CUDA events. Prints each
kernel's median, least and largest round per tree, then the card's name and
power limit. A device-time comparison finer than chip_smoke.py's per-call
medians, which include a launch each. The stitches (forward: hstart from hl
and ap; backward: dh_tail from dh0 and ap, over the 1,024 segments of each
batch row) run through a tree's ``csrc/selective_scan_long_stitch.cu`` where
it has one, else as such a tree ran them: this package's torch stitches
(``_stitch_fwd``, ``_stitch_bwd``: a log-depth ``affine_scan``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

SOURCES = ("selective_scan_long.cu", "selective_scan_long_carry_bwd.cu",
           "selective_scan_window.cu", "selective_scan_long_stitch.cu")
K7_CALL = (2, 65536, 192)
K9_CALLS = ((21904, 49, 48), (5476, 49, 96), (1444, 49, 192), (400, 49, 384),
            (256, 64, 384))
ROUNDS, CALLS = 12, 20


def _build(name, csrc, out):
    """Build one tree's three libraries in parallel: {source: CDLL}."""
    from ..ops import cuda_build as cb

    procs = []
    for src in [s for s in SOURCES if (csrc / s).exists()]:
        lib = out / f"{name}_{src[:-3]}.so"
        procs.append((src, lib, subprocess.Popen(
            [cb.find_nvcc(), *cb.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(csrc / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for src, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed for {src}\n{log[-2000:]}")
        libs[src] = ctypes.CDLL(str(lib))
    return libs


def _code0(fn):
    """fn as a call that returns 0, as a C entry whose launch succeeded."""
    def call():
        fn()
        return 0
    return call


def _calls(libs, softplus_flag, ops):
    """{kernel label: a call} of one tree's libraries on the operands ops."""
    p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    sp = [1] if softplus_flag else []
    fwd = libs[SOURCES[0]].lcbi_long_scan_fwd
    fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * (4 + len(sp)) + [ctypes.c_void_p]
    carry = libs[SOURCES[1]].lcbi_long_scan_carry_bwd
    carry.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (4 + len(sp)) + [ctypes.c_void_p]
    wfwd = libs[SOURCES[2]].lcbi_window_scan_fwd
    wfwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    u, delta, g, at, bm, cm, h0, y, hl, ap, dh0, win, s = ops
    b, length, d = K7_CALL
    nseg = length // 64
    out = {
        "K7 fwd from zero carries": lambda: fwd(p(u), p(delta), p(at), p(bm), p(cm), None, None,
                                                p(hl), p(ap), b, length, d, 8, *sp, s),
        "K7 fwd seeded, y": lambda: fwd(p(u), p(delta), p(at), p(bm), p(cm), p(h0), p(y), None,
                                        None, b, length, d, 8, *sp, s),
        "K7 carry bwd": lambda: carry(p(delta), p(at), p(cm), p(g), p(dh0), b, length, d, 8, *sp,
                                      s),
    }
    if SOURCES[3] in libs:
        stitch = libs[SOURCES[3]].lcbi_long_scan_stitch
        stitch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        for rev, x in ((0, hl), (1, dh0)):
            out[f"K7 stitch {('fwd', 'bwd')[rev]}"] = (
                lambda x=x, rev=rev: stitch(p(x), p(ap), p(h0), b, nseg, 8 * d, rev, s))
    else:
        from ..ops import selective_scan_long as ssl

        out["K7 stitch fwd"] = _code0(lambda: ssl._stitch_fwd(hl, ap, b, nseg))
        out["K7 stitch bwd"] = _code0(lambda: ssl._stitch_bwd(dh0, ap, b, nseg))
    for (bw, wl, wd), tensors in zip(K9_CALLS, win):
        out[f"K9 fwd {bw}x{wl}x{wd}"] = (lambda t=tensors, bw=bw, wl=wl, wd=wd:
                                         wfwd(*[p(x) for x in t], bw, wl, wd, 8, 1, s))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit("usage: k79_fwd_ab <other checkout's repository root>")
    import torch

    from ..ops import cuda_build as cb

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    other = Path(argv[0]).resolve() / "long_context_biomedical_imaging_tpu_torch" / "csrc"
    trees = {"other": other, "this": cb.CSRC_DIR}
    out = cb.BUILD_DIR.parent / "k79_fwd_ab"
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)
    b, length, d = K7_CALL

    def mk(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    rows = b * -(-length // 64)
    at = (-torch.arange(1, 9.0)[:, None] * torch.exp(0.3 * torch.randn(8, d, generator=gen)))
    win = [[mk(bw, wl, wd), mk(bw, wl, wd), (-torch.rand(8, wd, generator=gen) - 0.1).to(dev),
            mk(bw, wl, 8), mk(bw, wl, 8), torch.empty(bw, wl, wd, device=dev)]
           for bw, wl, wd in K9_CALLS]
    # hl, ap and dh0 hold values (ap in (0, 1)) for the stitches
    ops = (mk(b, length, d), mk(b, length, d), mk(b, length, d), at.to(dev).contiguous(),
           mk(b, length, 8), mk(b, length, 8), mk(rows, 8, d),
           torch.empty(b, length, d, device=dev), mk(rows, 8, d),
           torch.rand(rows, 8, d, generator=gen).to(dev), mk(rows, 8, d),
           win, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    fns = {}
    for name, csrc in trees.items():
        flag = "int N, int softplus," in (csrc / SOURCES[0]).read_text()
        fns[name] = _calls(_build(name, csrc, out), flag, ops)
    times = {(n, k): [] for n in fns for k in fns[n]}
    for rnd in range(ROUNDS):
        for name in (list(fns) if rnd % 2 == 0 else list(reversed(list(fns)))):
            for key, fn in fns[name].items():
                for _ in range(3):
                    fn()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(CALLS):
                    if fn() != 0:
                        raise SystemExit(f"{name} {key}: the launch failed")
                end.record()
                torch.cuda.synchronize()
                times[(name, key)].append(start.elapsed_time(end) / CALLS)
    print(f"ms a call, {ROUNDS} rounds of {CALLS} calls; other = {os.path.relpath(argv[0])}",
          flush=True)
    for key in fns["this"]:
        print(f"{key}: " + "; ".join(
            f"{n} median {sorted(times[(n, key)])[ROUNDS // 2]:.4f} (least "
            f"{min(times[(n, key)]):.4f}, largest {max(times[(n, key)]):.4f})" for n in fns),
            flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
