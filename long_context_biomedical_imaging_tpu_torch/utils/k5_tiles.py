"""K5's bf16 tile heights at vit16k's attention shape, timed against
variants: ``python -m long_context_biomedical_imaging_tpu_torch.utils.k5_tiles``
on a card (``nvcc`` and a CUDA build of PyTorch).

Each variant is a copy of one ``csrc/flash_attention*.cu`` source with one
line of its tile configuration (``FwdCfg``, ``DqCfg``, ``DkvCfg``) replaced,
built with the package's nvcc flags into ``build/k5_tiles/`` (gitignored).
At each head dim where a variant differs from the shipped source it runs
through the package's own wrapper (its entry point swapped in) on
(12, 16,385, D) bf16 operands: its largest error relative to the plain
version on two head-batches, and the mean time of 10 calls after 2, beside
the shipped kernel's and ``scaled_dot_product_attention``'s. One line per
(kernel, D, variant), then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor

FWD, DQ, DKV = "flash_attention.cu", "flash_attention_dq.cu", "flash_attention_dkv.cu"
FWD_BN = "static constexpr int kBN = DP <= 64 ? 128 : 32;"
DQ_BN = "static constexpr int kBN = 64;"
DQ_SUB = "static constexpr int kSub = DP <= 64 ? 32 : kBN;"
DKV_BM = "static constexpr int kBM = 64;"
DKV_G = "static constexpr int kG = DP <= 64 ? 1 : DP / 64;"
DKV_WARPS = "static constexpr int kWarps = DP <= 64 ? 4 : 8, kThreads = kWarps * 32;"


def _set(line, value):
    """line (``... = <expr>;``) with its expression replaced by value."""
    return line[:line.index("= ") + 2] + value + ";"


# (label, source, head dims it changes, [(shipped text, replacement)])
VARIANTS = [
    ("fwd keys/tile 64", FWD, (64,), [(FWD_BN, _set(FWD_BN, "DP <= 64 ? 64 : 32"))]),
    ("fwd keys/tile 64", FWD, (128,),
     [(FWD_BN, _set(FWD_BN, "DP <= 64 ? 128 : DP <= 128 ? 64 : 32"))]),
    ("fwd keys/tile 64", FWD, (256,), [(FWD_BN, _set(FWD_BN, "DP <= 64 ? 128 : 64"))]),
    ("dq keys/tile 128", DQ, (64,), [(DQ_BN, _set(DQ_BN, "DP <= 64 ? 128 : 64"))]),
    ("dq keys/step 64", DQ, (64,), [(DQ_SUB, _set(DQ_SUB, "kBN"))]),
    ("dq keys/tile 32", DQ, (128,), [(DQ_BN, _set(DQ_BN, "DP == 128 ? 32 : 64"))]),
    ("dq keys/tile 32", DQ, (256,), [(DQ_BN, _set(DQ_BN, "DP <= 128 ? 64 : 32"))]),
    ("dkv queries/tile 32", DKV, (64,), [(DKV_BM, _set(DKV_BM, "DP <= 64 ? 32 : 64"))]),
    ("dkv queries/tile 128", DKV, (64,), [(DKV_BM, _set(DKV_BM, "DP <= 64 ? 128 : 64"))]),
    ("dkv 2 warps per key tile", DKV, (64,),
     [(DKV_G, _set(DKV_G, "DP <= 64 ? 2 : DP / 64")),
      (DKV_WARPS, "static constexpr int kWarps = 8, kThreads = kWarps * 32;")]),
    ("dkv queries/tile 32", DKV, (128,), [(DKV_BM, _set(DKV_BM, "DP == 128 ? 32 : 64"))]),
    ("dkv queries/tile 32", DKV, (256,), [(DKV_BM, _set(DKV_BM, "DP <= 128 ? 64 : 32"))]),
]
HEAD_DIMS = (64, 128, 256)
BH, L = 12, 16385


def build_variant(index, source, replacements, out_dir):
    """Build one variant; returns (library path or None, compiler log)."""
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


def main():
    import torch
    import torch.nn.functional as F

    from ..ops import cuda_build as cb
    from ..ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    out_dir = cb.BUILD_DIR.parent / "k5_tiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    kernels = {FWD: fa.FLASH_FWD, DQ: fa.FLASH_BWD_DQ, DKV: fa.FLASH_BWD_DKV}
    with ThreadPoolExecutor(len(VARIANTS) + len(kernels)) as pool:
        shipped = [pool.submit(k.load) for k in kernels.values()]
        built = list(pool.map(lambda iv: build_variant(iv[0], iv[1][1], iv[1][3], out_dir),
                              enumerate(VARIANTS)))
        for f in shipped:
            f.result()

    def mean_ms(fn, reps=10):
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def rel_err(got, ref):
        return max(((g[:2].float() - r.float()).abs().max() / r.float().abs().max()).item()
                   for g, r in zip(got, ref))

    for d in HEAD_DIMS:
        gen = torch.Generator().manual_seed(d)
        q, k, v, do = (torch.randn(BH, L, d, generator=gen).to(dev, torch.bfloat16)
                       for _ in range(4))
        scale = d ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        delta = (do.float() * o.float()).sum(-1)
        ref_o = fa.flash_attention_plain(q[:2], k[:2], v[:2], scale)[0]
        ref_dq, ref_dk, ref_dv = fa.flash_attention_bwd_plain(do[:2], q[:2], k[:2], v[:2], scale)
        calls = {FWD: (lambda: fa.flash_attention_fwd(q, k, v, scale)[:1], (ref_o,)),
                 DQ: (lambda: (fa.flash_attention_dq(do, q, k, v, lse, delta, scale),), (ref_dq,)),
                 DKV: (lambda: fa.flash_attention_dkv(do, q, k, v, lse, delta, scale),
                       (ref_dk, ref_dv))}
        for source, kernel in kernels.items():
            call, ref = calls[source]
            rows = [("shipped", kernel._fn, "")] + [
                (label, lib, log) for (label, src, dims, _), (lib, log) in zip(VARIANTS, built)
                if src == source and d in dims]
            for label, lib, log in rows:
                if lib is None:
                    print(f"k5_tiles {source} D={d} {label}: build failed\n{log[-1500:]}",
                          flush=True)
                    continue
                saved = kernel._fn
                if label != "shipped":
                    fn = getattr(ctypes.CDLL(str(lib)), kernel.symbol)
                    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
                    kernel._fn = fn
                try:
                    err = rel_err(call(), ref)
                    ms = mean_ms(call)
                finally:
                    kernel._fn = saved
                print(f"k5_tiles {source} D={d} {label}: {ms:.3f} ms, max err {err:.2e} of max",
                      flush=True)
        q4, k4, v4 = (t[None].requires_grad_() for t in (q, k, v))
        f_ms = mean_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
        out = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        b_ms = mean_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do[None],
                                                   retain_graph=True))
        print(f"k5_tiles SDPA D={d}: fwd {f_ms:.3f} ms, bwd {b_ms:.3f} ms", flush=True)
        del q, k, v, do, o, lse, delta, q4, k4, v4, out
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
