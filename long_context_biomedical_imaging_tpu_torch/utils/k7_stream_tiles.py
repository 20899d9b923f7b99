"""K7's streamed forward passes and carry backward and K9's forward
(``csrc/selective_scan_long_stream.cuh``) at the vit65k_mamba call and at
micro_w7's K9 calls, timed against variants:
``python -m long_context_biomedical_imaging_tpu_torch.utils.k7_stream_tiles``
on a card (``nvcc`` and a CUDA build of PyTorch).

Each variant is a copy of the header with lines replaced (every occurrence
of each; the exponentials' and softplus's forms, the decay product, the
register budgets and stages of the passes, the tokens of a stage, the
channels of a tile; K9's windows a block, stages, register budget and
chunks a window), built with the package's nvcc flags beside copies of the
three entry sources into ``build/k7_stream_tiles/v<i>/`` (gitignored); a
variant marked "ablation" leaves work out and is timed only. Each runs the
forward from zero carries, the forward seeded with y and the carry backward
at (b, L, D) = (2, 65536, 192), and K9's forward at K9_CALLS (micro_w7's
stages 0, 1 and 3 at batch 4), d_state 8, softplus on, on fp32 operands
rounded from bf16 as the path casts them, through the libraries' C entries:
the largest error of each call's outputs relative to the max of its plain
pass's (``long_scan_fwd_plain``, ``long_scan_carry_bwd_plain``,
``window_scan_fwd_plain``), and the median
over 12 rounds of the mean time of 20 calls (CUDA events) after 3, the
variants taking turns in each round (the order reversed every other
round), so that the card's clocks drift alike over all of them. The shipped
header comes first. One line per variant, then the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

HEADER = "selective_scan_long_stream.cuh"
SOURCES = {"fwd": "selective_scan_long.cu", "carry": "selective_scan_long_carry_bwd.cu",
           "win": "selective_scan_window.cu"}
K7_CALL = (2, 65536, 192)
K9_CALLS = [(21904, 49, 48), (5476, 49, 96), (1444, 49, 192), (400, 49, 384)]
WIN_CONSTANTS = ("kWinStages", "kWinBlocks", "kWinMaxTile")
# K9's (stages, blocks of 256 an SM its registers are budgeted for, channels
# a tile at most, windows a block) beside the shipped ones
WIN_CONFIGS = [(4, 1, 256, "fit"), (3, 3, 128, "fit"), (2, 2, 128, "fit"), (2, 3, 256, "fit"),
               (2, 3, 128, "fewest"), (2, 3, 128, "warps")]
# how many windows' tiles a block takes at d <= kWinMaxTile: as many as fit
# in kStreamMaxTile threads (shipped), the fewest that fill whole warps (32 /
# gcd(d, 32): 96 threads at d = 48), or the most that fill whole warps there
# (192 threads at d = 48)
GROUPS = "      const int groups = kStreamMaxTile / D;"
G0 = ("      int r = D, m = 32;\n"
      "      while (m) {\n        const int t = r % m;\n        r = m;\n        m = t;\n      }\n"
      "      const int g0 = 32 / r;\n")
RULE_LABELS = {"fit": "as many windows a block as fit", "fewest": "the fewest windows that fill "
               "whole warps", "warps": "the most windows that fill whole warps"}
WIN_RULES = {"fit": [],
             "fewest": [(GROUPS, G0 + "      const int groups = g0;")],
             "warps": [(GROUPS, G0 + "      const int groups = g0 * (kStreamMaxTile / (g0 * D) > 0 ? "
                                     "kStreamMaxTile / (g0 * D) : 1);")]}
CHUNK = "constexpr int kStreamChunk = 8; "
STAGES = "constexpr int kStreamStages = 4;"
LEAN_STAGES = "constexpr int kStreamLeanStages = 3;"
LEAN_BLOCKS = "constexpr int kStreamLeanBlocks = 4;"
TILE = "constexpr int kStreamMaxTile = 256; "
EX2 = '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
SOFTPLUS = "  return SOFTPLUS ? stream_softplus(v) : v;"
LIB_EX2 = (EX2, "  y = exp2f(x);")
LIB_SOFTPLUS = (SOFTPLUS, "  return SOFTPLUS ? scan_softplus(v) : v;")
# log(1 + e) by lg2.approx on the special-function unit in place of the
# shipped polynomial e q(e): two special-function instructions a softplus,
# and an absolute, not a relative, error near e = 0
POLY = "  float q = 0.0051261018961668015f;\n"
LG2 = (POLY + "".join(f"  q = fmaf(q, e, {c});\n" for c in (
    "-0.029074065387248993f", "0.0775160863995552f", "-0.13602247834205627f",
    "0.19076880812644958f", "-0.2483539879322052f", "0.3331812024116516f",
    "-0.4999944567680359f", "0.9999999403953552f")) + "  return fmaf(e, q, fmaxf(v, 0.f));",
       '  float r;\n  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));\n'
       '  return fmaf(r, 0.6931471805599453f, fmaxf(v, 0.f));')


def win_config(*values):
    """The replacements that set K9's constants (WIN_CONSTANTS) to values."""
    import re

    from ..ops import cuda_build as cb

    text = (cb.CSRC_DIR / HEADER).read_text()
    out = []
    for name, value in zip(WIN_CONSTANTS, values):
        line = re.search(rf"constexpr int {name} = (\d+);", text)
        if line is None:
            raise RuntimeError(f"{HEADER} no longer holds {name}: update WIN_CONSTANTS")
        if int(line.group(1)) != value:
            out.append((line.group(0), f"constexpr int {name} = {value};"))
    return out


# (label, [(shipped text, replacement)])
VARIANTS = [
    ("shipped", []),
    ("the library's exp2f for every exp2", [LIB_EX2]),
    ("softplus by expf and log1pf (scan_softplus)", [LIB_SOFTPLUS]),
    ("both: the per-thread kernel's arithmetic", [LIB_EX2, LIB_SOFTPLUS]),
    ("softplus's log(1 + e) by lg2.approx", [LG2]),
    ("a branch around each ragged token's softplus",
     [("stream_dt<SP>(sx0[j * tc]) * (j < lim ? 1.f : 0.f)",
       "(j < lim ? stream_dt<SP>(sx0[j * tc]) : 0.f)"),
      ("stream_dt<SP>(sx1[j * tc]) * live", "(live != 0.f ? stream_dt<SP>(sx1[j * tc]) : 0.f)")]),
    # NP exp2s more a row for NP multiplies fewer a token; not shipped, so
    # that each pass keeps exactly NP exp2s a token
    ("decay product as exp2 of the summed d",
     [("  float h[NP], p[NP], hn[NP];", "  float h[NP], p[NP], hn[NP], dsum = 0.f;"),
      ("        p[n] = 1.f;\n      }", "        p[n] = 1.f;\n      }\n      dsum = 0.f;"),
      ("        const float du = dt * sx0[j * tc];",
       "        const float du = dt * sx0[j * tc];\n        dsum += dt;"),
      ("          else\n            p[n] *= an;", ""),
      ("a.ap[o] = p[n];", "a.ap[o] = stream_exp2(a2[n] * dsum);")]),
    ("every pass at its natural registers, four stages",
     [(LEAN_STAGES, LEAN_STAGES.replace("3", "4")), (LEAN_BLOCKS, LEAN_BLOCKS.replace("4", "1"))]),
    ("the seeded pass lean too (64 registers, three stages)",
     [("  return (mode == kFwdZero || mode == kCarryBwd) && np == 8;",
       "  return mode != kWinFwd && np == 8;")]),
    ("16 tokens a stage, 3 stages", [(CHUNK, CHUNK.replace("8", "16")),
                                     (STAGES, STAGES.replace("4", "3"))]),
    ("128 channels a tile", [(TILE, TILE.replace("256", "128"))]),
    *[(f"K9: {stages} stages, registers for {blocks} blocks of 256 an SM, tiles of at most "
       f"{tile} channels, {RULE_LABELS[rule]}", win_config(stages, blocks, tile) + WIN_RULES[rule])
      for stages, blocks, tile, rule in WIN_CONFIGS],

    ("K9: one window a block (K7's tiles)",
     [("if (D <= kWinMaxTile) {", "if (false) {")]),
    ("K9: the ragged last chunk computed in full",
     [("      if (WIN && lim < K) {", "      if (false) {")]),
    ("K9: all 8 chunks a window", [("g->cpr = (L + kStreamChunk - 1) / kStreamChunk;",
                                    "g->cpr = kStreamChunks;")]),
    ("ablation: no state exponentials", [("stream_exp2(dt * a2[n])", "(dt * a2[n])")]),
    ("ablation: no softplus", [(SOFTPLUS, "  return v;")]),
    ("ablation: no staging of the planes",
     [("        scan_cp16(st + so, live ? x0 + o : a.x0, live);\n", ""),
      ("        scan_cp16(st + plane + so, live ? x1 + o : a.x1, live);\n", "")]),
]


def build_variant(index, replacements, out_dir):
    """Build the three entry libraries of one variant of the header; returns
    ({"fwd" | "carry" | "win": library path} or None, compiler log)."""
    from ..ops import cuda_build as cb

    text = (cb.CSRC_DIR / HEADER).read_text()
    for old, new in replacements:
        if old not in text or new == old:
            raise RuntimeError(f"{HEADER} no longer holds {old!r}: update VARIANTS")
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


ROUNDS, CALLS = 12, 20


def mean_event_ms(torch, call, calls=CALLS, warmup=3):
    """The mean time of calls launches (CUDA events) after warmup untimed
    ones."""
    for _ in range(warmup):
        call()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main():
    import torch

    from ..ops import cuda_build as cb
    from ..ops import selective_scan_long as ssl
    from ..ops import selective_scan_window as ssw

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out_dir = cb.BUILD_DIR.parent / "k7_stream_tiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda iv: build_variant(iv[0], iv[1][1], out_dir),
                              enumerate(VARIANTS)))
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(7)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    b, length, d = K7_CALL
    rows = b * -(-length // ssl.SEG)

    def mk(*s):
        return torch.randn(*s, generator=gen).to(dev, torch.bfloat16).float()

    a = -torch.arange(1, 9.0) * torch.exp(0.3 * torch.randn(d, 8, generator=gen))
    u, delta, g = mk(b, length, d), mk(b, length, d), mk(b, length, d)
    at, bm, cm = a.t().contiguous().to(dev), mk(b, length, 8), mk(b, length, 8)
    h0 = torch.randn(rows, 8, d, generator=gen).to(dev)
    _, hl_ref, ap_ref = ssl.long_scan_fwd_plain(u, delta, at, bm, cm, emit_y=False)
    y_ref = ssl.long_scan_fwd_plain(u, delta, at, bm, cm, h0)[0]
    dh0_ref = ssl.long_scan_carry_bwd_plain(delta, at, cm, g)
    y, hl, ap, dh0 = (torch.empty_like(t) for t in (y_ref, hl_ref, ap_ref, dh0_ref))
    win = []
    for bw, wl, wd in K9_CALLS:
        wa = -torch.arange(1, 9.0) * torch.exp(0.3 * torch.randn(wd, 8, generator=gen))
        ops = [mk(bw, wl, wd), mk(bw, wl, wd), wa.t().contiguous().to(dev), mk(bw, wl, 8),
               mk(bw, wl, 8)]
        ref = ssw.window_scan_fwd_plain(*ops)
        win.append((bw, wl, wd, ops, torch.empty_like(ref), ref))
    p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    runs = {}  # label: {call name: (call, [(out, reference)])}
    for (label, _), (libs, log) in zip(VARIANTS, built):
        if libs is None:
            print(f"{label}: build failed\n{log[-2000:]}", flush=True)
            continue
        fwd = ctypes.CDLL(str(libs["fwd"])).lcbi_long_scan_fwd
        fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        carry = ctypes.CDLL(str(libs["carry"])).lcbi_long_scan_carry_bwd
        carry.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        runs[label] = {
            "zero-carry": (lambda fwd=fwd: fwd(p(u), p(delta), p(at), p(bm), p(cm), None, None,
                                               p(hl), p(ap), b, length, d, 8, 1, stream),
                           [(hl, hl_ref), (ap, ap_ref)]),
            "seeded": (lambda fwd=fwd: fwd(p(u), p(delta), p(at), p(bm), p(cm), p(h0), p(y),
                                           None, None, b, length, d, 8, 1, stream),
                       [(y, y_ref)]),
            "carry bwd": (lambda carry=carry: carry(p(delta), p(at), p(cm), p(g), p(dh0), b,
                                                    length, d, 8, 1, stream),
                          [(dh0, dh0_ref)])}
        wfwd = ctypes.CDLL(str(libs["win"])).lcbi_window_scan_fwd
        wfwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        for bw, wl, wd, ops, out, ref in win:
            runs[label][f"K9 {bw}x{wl}x{wd}"] = (
                lambda wfwd=wfwd, ops=ops, out=out, bw=bw, wl=wl, wd=wd:
                wfwd(*[p(t) for t in ops], p(out), bw, wl, wd, 8, 1, stream), [(out, ref)])
    errs, times = {}, {}
    for label, calls in runs.items():
        for name, (call, pairs) in calls.items():
            if call() != 0:
                errs[(label, name)] = None
                continue
            torch.cuda.synchronize()
            errs[(label, name)] = max(((x - r).abs().max() / r.abs().max()).item()
                                      for x, r in pairs)
            times[(label, name)] = []
    order = list(runs)
    for rnd in range(ROUNDS):
        for label in (order if rnd % 2 == 0 else order[::-1]):
            for name, (call, _) in runs[label].items():
                if errs[(label, name)] is not None:
                    times[(label, name)].append(mean_event_ms(torch, call))
    for label, calls in runs.items():
        parts = []
        for name in calls:
            if errs[(label, name)] is None:
                parts.append(f"{name} refused")
                continue
            ms = sorted(times[(label, name)])[ROUNDS // 2]
            parts.append(f"{name} {ms:.4f} ms (rel err {errs[(label, name)]:.1e})")
        print(f"{label}: " + "; ".join(parts), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
