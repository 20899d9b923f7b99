"""Run chip_smoke.py's phase 39 (micro_w7's gradients, card against host)
at other seeds, on one card:

    python3 -m long_context_biomedical_imaging_tpu_torch.utils.micro_w7_seeds \\
        [--tree DIR] [--f64 [--plain]] seed [seed ...]

For each seed, the phase as ``chip_smoke.py`` runs it at its own seed (39):
``phase_vessel_grads`` with ``micro_w7_flags()``, 512x512 images at batch
4, K9 launched where that tree's gate routes it (stage 0 under the JAX
package's 2,048-window floor, every stage under the card's own), from the
``chip_smoke.py`` of DIR (the
repository root this module lies in by default; another checkout, its
parent commit say, takes its own package and its own kernel builds). The
phase's checks are recorded instead of raised, so every seed runs to its
end, and the script prints each seed's verdict and the failed checks.

With ``--f64``, at each seed whose checks failed, the host computes the same
train step's gradients once more in float64 (the model and the images in
float64; the port's own fp32 casts, ``Tensor.float``, kept at float64 while
it runs; buffers that the code allocates as fp32 stay fp32), with this
repository's package, and prints, for the parameter nearest its bf16 limit
and the fp32 check's worst parameter, how far each of the card's and the
host's fp32 and bf16 gradients lies from the float64 one (max|err| /
max|float64 grad|). With ``--plain`` it also runs the card's bf16 step with
K2's kernels, K9's kernels, or both replaced by their plain versions on the
card's tensors (the same function in torch ops, the kernels' rounding
points), so that a kernel and the card's own torch ops can be told apart.
micro_w7's path runs K2 and K9, so these steps are the same code in any
tree whose K2 and K9 did not change.

Needs one card. Every number it prints is this card's, beside its name and
power limit.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys


def _load_tree(root: str):
    """That tree's chip_smoke module, its package first on the path."""
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m == "chip_smoke"
                 or m.startswith("long_context_biomedical_imaging_tpu_torch")]:
        del sys.modules[name]
    return importlib.import_module("chip_smoke")


def run_seed(cs, torch, dev, seed: int):
    """Phase 39 at one seed, its checks recorded: (failed messages, e32,
    card_e, host_e) with the phase's per-parameter errors."""
    failures = []

    def record(cond, msg):
        if not cond:
            failures.append(msg)

    check = cs.check
    cs.check = record
    try:
        grad_k9 = sum(d for *_, d in cs.micro_k9_shapes(cs.MICRO_GRAD_BATCH, height=512))
        e32, card_e, host_e = cs.phase_vessel_grads(
            torch, dev, seed=seed, flags=cs.micro_w7_flags(), channels=1, enhance=True,
            phase=39, name="micro_w7", path_kernels={20: grad_k9, 21: grad_k9})
    finally:
        cs.check = check
    return failures, e32, card_e, host_e


def _plain_on_card(k2: bool, k9: bool):
    """Route K2's and/or K9's autograd Functions to their plain versions on
    CUDA tensors; returns the undo."""
    from long_context_biomedical_imaging_tpu_torch.ops import fused_mlp as fm
    from long_context_biomedical_imaging_tpu_torch.ops import selective_scan_window as sw

    swaps = []
    if k2:
        swaps += [(fm, "_fwd_cuda", fm.fused_ln_mlp_residual_plain),
                  (fm, "fused_ln_mlp_residual_bwd", fm.fused_ln_mlp_residual_bwd_plain)]
    if k9:
        swaps += [(sw, "window_scan_fwd", sw.window_scan_fwd_plain),
                  (sw, "window_scan_bwd", sw.window_scan_bwd_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return undo


def f64_distances(cs, torch, dev, seed: int, names, plain=False):
    """Each gradient of the named parameters (card and host, fp32 and bf16;
    with ``plain`` the card's bf16 also with K2, K9 or both on their plain
    versions) against the host's float64 gradient and against the card's
    fp32 one (the phase's bf16 reference): {name: {run: (max|err| / max|f64|,
    max|err| / max|card fp32|)}}."""
    from torch.func import functional_call

    from long_context_biomedical_imaging_tpu_torch.trainer import amp_params

    x, y, loss_func, model, amp_model = cs.vessel_grad_case(torch, seed, cs.micro_w7_flags(), 1,
                                                            True)

    def grads(m, amp, device, dtype=torch.float32):
        m.to(device=device, dtype=dtype).train().zero_grad(set_to_none=True)
        out = functional_call(m, amp_params(m, amp), (x.to(device, dtype),))
        loss_func(out.to(dtype), y.to(device, dtype)).backward()
        g = {k: p.grad.detach().cpu().double() for k, p in m.named_parameters() if k in names}
        m.to(dtype=torch.float32)
        return g

    runs = {"host fp32": grads(model, False, "cpu"), "host bf16": grads(amp_model, True, "cpu"),
            "card fp32": grads(model, False, dev), "card bf16": grads(amp_model, True, dev)}
    if plain:
        for label, k2, k9 in (("K2 plain", True, False), ("K9 plain", False, True),
                              ("K2 and K9 plain", True, True)):
            undo = _plain_on_card(k2, k9)
            try:
                runs[f"card bf16 {label}"] = grads(amp_model, True, dev)
            finally:
                undo()
    as_float = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else as_float(t, *a, **k)
    try:
        ref = grads(model, False, "cpu", torch.float64)
    finally:
        torch.Tensor.float = as_float
    out = {}
    for name in names:
        scale = max(ref[name].abs().max().item(), 1e-300)
        c32 = runs["card fp32"][name]
        scale32 = max(c32.abs().max().item(), 1e-300)
        out[name] = {run: ((g[name] - ref[name]).abs().max().item() / scale,
                           (g[name] - c32).abs().max().item() / scale32)
                     for run, g in runs.items()}
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("seeds", type=int, nargs="+")
    parser.add_argument("--tree", default=None)
    parser.add_argument("--f64", action="store_true")
    parser.add_argument("--plain", action="store_true")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    info = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {info}", flush=True)
    tree = os.path.abspath(args.tree or here)
    cs = _load_tree(tree)
    cs.phase_device(torch)
    dev = torch.device("cuda", 0)
    failing = []
    for seed in args.seeds:
        failures, e32, card_e, host_e = run_seed(cs, torch, dev, seed)
        limit = {k: cs.BF16_GRAD_RATIO * host_e[k] + cs.VESSEL_BF16_GRAD_FLOOR for k in card_e}
        tight = max(card_e, key=lambda k: card_e[k] / limit[k])
        worst32 = max(e32, key=e32.get)
        print(f"seed {seed} ({os.path.basename(tree)}): {'FAIL' if failures else 'pass'}; "
              f"bf16 nearest its limit {tight}: card {card_e[tight]:.4e}, host "
              f"{host_e[tight]:.4e}, limit {limit[tight]:.4e}; fp32 worst {worst32} "
              f"{e32[worst32]:.4e}", flush=True)
        for msg in failures:
            print(f"seed {seed}: failed check: {msg}", flush=True)
        if failures:
            failing.append((seed, tight, worst32))
        torch.cuda.empty_cache()
    if args.f64 and failing:
        if tree != here:   # the float64 step runs this repository's package
            cs = _load_tree(here)
        for seed, tight, worst32 in failing:
            names = list(dict.fromkeys((tight, worst32)))
            try:
                dists = f64_distances(cs, torch, dev, seed, names, args.plain)
            except (RuntimeError, TypeError, ValueError) as e:
                print(f"seed {seed} float64 reference: failed: {e}", flush=True)
                continue
            for name, dist in dists.items():
                print(f"seed {seed} {name}, max|err| / max|grad| from float64 | from card fp32: "
                      + ", ".join(f"{run} {a:.4e} | {b:.4e}" for run, (a, b) in dist.items()),
                      flush=True)


if __name__ == "__main__":
    main()
