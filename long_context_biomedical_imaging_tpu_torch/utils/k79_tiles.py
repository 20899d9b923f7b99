"""The backwards of K7 and K9 (the lane-group core of
``csrc/selective_scan_bwd.cuh``) at their main paths' shapes, timed against
variants: ``python -m long_context_biomedical_imaging_tpu_torch.utils.k79_tiles``
on a card (``nvcc`` and a CUDA build of PyTorch).

Each variant is a copy of the core's header with one or more lines replaced
(the lane groups at d_state 8; how often the dB | dC partials are flushed;
the threads of a block, which set the channel tiles by width; the register
budget), built with the package's nvcc flags
beside copies of the two entry sources into ``build/k79_tiles/v<i>/``
(gitignored); a variant marked "ablation" leaves a sum out and is timed only.
K7 runs at the vit65k_mamba call ((b, L, D) = (2, 65536, 192), 12 calls a
train step), K9 at micro_w7's stages (21,904 and 5,476 windows of 49 tokens,
d = 48 and 96, two blocks each), both on fp32 operands rounded from bf16 as
the path casts them, d_state 8, softplus on, through the library's C entry:
its largest error relative to the plain pass (K7 ``long_scan_bwd_plain``, K9
``window_scan_bwd_plain``), the median time of 7 calls after 2, and the sum
of the time times the calls a train step makes. The shipped header comes
first. One line per variant, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

from .k2_tiles import median_event_ms

HEADER = "selective_scan_bwd.cuh"
SOURCES = {"k7": "selective_scan_long_bwd.cu", "k9": "selective_scan_window_bwd.cu"}
THREADS = "constexpr int kBwdTileThreads = 256;"
REGS = "(S == 1 ? 64 : 128)"
LANES = ("  g->lg = N <= 1 ? 1 : N <= 2 ? 2 : N <= 8 ? 4 : 8;\n"
         "  g->s = N <= 4 ? 1 : 2;")
CASES = ("    case 4: return s == 1 ? f(BwdCfg<4, 1, SP>{}) : f(BwdCfg<4, 2, SP>{});\n"
         "    default: return f(BwdCfg<8, 2, SP>{});")
FLUSH = "constexpr int kBwdFlush = 2;"
K7_CALL, K7_STEP = (2, 65536, 192), 12
K9_STAGES = [((21904, 49, 48), 2), ((5476, 49, 96), 2)]
LANES81 = [(LANES, "  g->lg = N <= 1 ? 1 : N <= 2 ? 2 : N <= 4 ? 4 : 8;\n"
                   "  g->s = N <= 8 ? 1 : 2;"),
           (CASES, "    case 4: return f(BwdCfg<4, 1, SP>{});\n"
                   "    default: return s == 1 ? f(BwdCfg<8, 1, SP>{}) : f(BwdCfg<8, 2, SP>{});")]

# (label, [(shipped text, replacement)]): the shipped choices (4 lanes of 2
# states at d_state 8, dB | dC partials flushed every 2 stretches, 256 threads
# a block) against the alternatives that decided them
VARIANTS = [
    ("shipped", []),
    ("d_state 8 on 8 lanes of one state", LANES81),
    ("dB | dC partials flushed every 4 stretches", [(FLUSH, FLUSH.replace("2", "4"))]),
    ("8 lanes of one state, flushed every 4 stretches",
     [(FLUSH, FLUSH.replace("2", "4"))] + LANES81),
    ("512 threads a block", [(THREADS, THREADS.replace("256", "512"))]),
    ("128 threads a block", [(THREADS, THREADS.replace("256", "128"))]),
    ("80 registers a thread", [(REGS, REGS.replace("64", "80"))]),
    ("ablation: without the dB | dC sums over the channels",
     [("          tb_sum<V, 16, LG>(v, lane);\n", "")]),
    ("ablation: without the sums over the states",
     [("      tb_sum<2 * kBwdStretch, LG / 2, 1>(pd, lane);\n", "")]),
    ("ablation: without staging u, delta, g",
     [("          scan_cp16(dst + p * kPlane, live ? src + o : src, live);\n", "")]),
]


def build_variant(index, replacements, out_dir):
    """Build the two entry libraries of one variant of the header; returns
    ({"k7" | "k9": library path} or None, compiler log)."""
    from ..ops import cuda_build as cb

    text = (cb.CSRC_DIR / HEADER).read_text()
    for old, new in replacements:
        if text.count(old) != 1 or new == old:
            raise RuntimeError(f"{HEADER} no longer holds {old!r} once: update VARIANTS")
        text = text.replace(old, new)
    vdir = out_dir / f"v{index}"
    vdir.mkdir(parents=True, exist_ok=True)
    (vdir / HEADER).write_text(text)
    libs, log = {}, ""
    for key, source in SOURCES.items():
        shutil.copy(cb.CSRC_DIR / source, vdir / source)
        lib = vdir / f"lib{key}.so"
        proc = subprocess.run([cb.find_nvcc(), *cb.NVCC_FLAGS, "-I", str(vdir), "-I",
                               str(cb.CSRC_DIR), "-o", str(lib), str(vdir / source)],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            return None, log
        libs[key] = lib
    return libs, log


def _inputs(torch, gen, shape, dev, rows=None):
    """u, delta, at, B, C, g (and h0, dht with rows) of one call, fp32 rounded
    from bf16; A = -(1..8) per channel times exp(0.3 N(0, 1))."""
    b, length, d = shape

    def mk(*s):
        return torch.randn(*s, generator=gen).to(dev, torch.bfloat16).float()

    a = -torch.arange(1, 9.0) * torch.exp(0.3 * torch.randn(d, 8, generator=gen))
    out = [mk(b, length, d), mk(b, length, d), a.t().contiguous().to(dev), mk(b, length, 8),
           mk(b, length, 8), mk(b, length, d)]
    if rows is not None:
        out += [torch.randn(rows, 8, d, generator=gen).to(dev) for _ in range(2)]
    return out


def _rel_err(torch, got, ref):
    return max(((x - r).abs().max() / r.abs().max()).item() for x, r in zip(got, ref))


def main():
    import torch

    from ..ops import cuda_build as cb
    from ..ops import selective_scan_long as ssl
    from ..ops import selective_scan_window as ssw

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out_dir = cb.BUILD_DIR.parent / "k79_tiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda iv: build_variant(iv[0], iv[1][1], out_dir),
                              enumerate(VARIANTS)))
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(79)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    b, length, d = K7_CALL
    rows = b * -(-length // ssl.SEG)
    k7 = _inputs(torch, gen, K7_CALL, dev, rows)
    k7_ref = ssl.long_scan_bwd_plain(*k7)
    k9 = [(_inputs(torch, gen, shape, dev), depth) for shape, depth in K9_STAGES]
    k9_ref = [ssw.window_scan_bwd_plain(*args) for args, _ in k9]
    torch.cuda.synchronize()
    for (label, _), (libs, log) in zip(VARIANTS, built):
        if libs is None:
            print(f"{label}: build failed\n{log[-2000:]}", flush=True)
            continue
        parts = []
        lib = ctypes.CDLL(str(libs["k7"]))
        fn, query = lib.lcbi_long_scan_bwd, lib.lcbi_long_scan_bwd_parts
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        query.argtypes, query.restype = [ctypes.c_int] * 4, ctypes.c_longlong
        n_slots = cb.slot_count(8 * d, dev)
        outs = [torch.empty_like(k7[0]), torch.empty_like(k7[0]), torch.empty_like(k7[3]),
                torch.empty_like(k7[4])]
        scratch = [torch.empty(n_slots, 8 * d, device=dev),
                   torch.empty(max(1, query(b, length, d, 8)), device=dev), torch.empty_like(k7[2])]
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in k7 + outs + scratch]
        code = fn(*ptrs, b, length, d, 8, 1, n_slots, stream)
        if code != 0:
            parts.append(f"K7 refused ({code})")
            k7_ms = float("nan")
        else:
            k7_ms = median_event_ms(torch, lambda: fn(*ptrs, b, length, d, 8, 1, n_slots, stream))
            err = _rel_err(torch, [outs[0], outs[1], scratch[2], outs[2], outs[3]], k7_ref)
            parts.append(f"K7 {k7_ms:.3f} ms a call (rel err {err:.1e}), {K7_STEP * k7_ms:.2f} "
                         f"per vit65k_mamba step")
        lib = ctypes.CDLL(str(libs["k9"]))
        fn9 = lib.lcbi_window_scan_bwd
        fn9.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        slots_q, parts_q = lib.lcbi_window_scan_bwd_slots, lib.lcbi_window_scan_bwd_parts
        slots_q.argtypes, slots_q.restype = [ctypes.c_int] * 5, ctypes.c_longlong
        parts_q.argtypes, parts_q.restype = [ctypes.c_int] * 4, ctypes.c_longlong
        step, calls = 0.0, []
        for ((bw, wl, wd), depth), (args, _), ref in zip(K9_STAGES, k9, k9_ref):
            ns = slots_q(bw, wl, wd, 8, 1)
            o9 = [torch.empty_like(args[0]), torch.empty_like(args[0]), torch.empty_like(args[3]),
                  torch.empty_like(args[4])]
            s9 = [torch.empty(max(1, ns), 8 * wd, device=dev),
                  torch.empty(max(1, parts_q(bw, wl, wd, 8)), device=dev),
                  torch.empty_like(args[2])]
            p9 = [ctypes.c_void_p(t.data_ptr()) for t in args + o9 + s9]
            if ns < 1 or fn9(*p9, bw, wl, wd, 8, 1, ns, stream) != 0:
                calls.append(f"d={wd} refused")
                step = float("nan")
                continue
            ms = median_event_ms(torch, lambda: fn9(*p9, bw, wl, wd, 8, 1, ns, stream))
            err = _rel_err(torch, [o9[0], o9[1], s9[2], o9[2], o9[3]], ref)
            step += depth * ms
            calls.append(f"d={wd} {ms:.3f} ms (rel err {err:.1e})")
        parts.append("K9 " + ", ".join(calls) + f", {step:.2f} per micro_w7 step")
        print(f"{label}: " + "; ".join(parts), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
