"""Compare this tree with another checkout of the repository (its parent
commit, say) on one card, in turns: parent, this tree, this tree, parent.

    git archive <parent> | tar -x -C build/parent
    python3 -m long_context_biomedical_imaging_tpu_torch.utils.ab_parent build/parent

Each turn is a fresh process started in that tree's root, which imports the
tree's own ``chip_smoke.py`` and runs its train-step phases for ptx (Hyena,
K1 and K2), vessel (Mamba, K4 and K2), ptx_attn (K8's whole-window path) and
emb_attn (K8's general path), then its K2 backward phase (8: each ptx stage
in fp32 and bf16), its K4 phase (17: each vessel stage) and its K2' phase
(46), from which it prints K2's backward per ptx step and K4's per vessel
step (the bf16 times per stage times the stage's depth) and K2''s backward
per call, and last K1's backward per ptx step and K8's weight gradients per
ptx_attn step (the other users of the split-K weight-gradient kernel): the
same functions in both trees, so the turns differ only in the
package they import. Kernels build at their first launch into each tree's
own ``build/kernels/``. Every line a turn prints is echoed with the turn's
label; a summary of the step times, the backward times and the profiled
device time per step of the kernels named in ``KERNELS`` ends the output.
Needs one card.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time

# what a turn runs, in that tree's root; the phases are chip_smoke.py's
TURN = r"""
import sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
dev = torch.device("cuda", 0)
t0 = time.time()
cs.phase_train_throughput(torch, dev)
cs.phase_vessel_throughput(torch, dev)
cs.phase_config_throughput(torch, dev, cs.ptx_attn_flags(), 36, "ptx_attn", batch=cs.BATCH)
cs.phase_config_throughput(torch, dev, cs.emb_attn_flags(), 45, "emb_attn", batch=cs.BATCH,
                           volume=cs.EMB_VOLUME)
from long_context_biomedical_imaging_tpu_torch.ops import fused_mlp, mamba_window
k2 = cs.phase_k2_bwd(torch, fused_mlp, dev)["bfloat16"]
k2_step = sum(depth * ms for (_, ms, _), (_, _, depth) in zip(k2, cs.STAGES))
k4 = cs.phase_k4(torch, mamba_window, dev)["bfloat16"]["bwd"]
k4_step = sum(depth * ms for (_, ms, _), (_, _, depth) in zip(k4, cs.VESSEL_K4_STAGES))
k2p = cs.phase_k2_prime(torch, fused_mlp, dev)[0]["bwd"]
print(f"backward times: K2 bwd {k2_step:.3f} ms per ptx step; K4 bwd {k4_step:.3f} ms per "
      f"vessel step; K2' bwd {k2p[1]:.3f} ms per call (plain VJP {k2p[2]:.3f} ms)", flush=True)
# the other users of the split-K weight gradients, bf16 at the ptx and
# ptx_attn stage shapes: K1's backward with the folded LN, K8's weight gradients
from long_context_biomedical_imaging_tpu_torch.ops import hyena_window, window_attention
gen = torch.Generator().manual_seed(7)
def mk(shape, scale=0.3):
    return (torch.randn(shape, generator=gen) * scale).to(dev)
k1_step = k8w_step = 0.0
for c, grid, depth in cs.STAGES:
    bw, v, bf = cs.BATCH * (grid // 4) ** 2, 16, torch.bfloat16
    ws, kl = hyena_window.prepare_taps(mk((3 * c, 5)), mk((c, v)), mk((c,)))
    a = [mk((bw, v, c), 1.0).to(bf), mk((c, 3 * c)).to(bf), mk((3 * c,)), ws, mk((3 * c,)), kl,
         mk((c, c)).to(bf), mk((c,)), mk((c,)) + 1.0, mk((c,))]
    d = mk((bw, v, c), 1.0).to(bf)
    k1_step += depth * cs.median_ms(torch, lambda: hyena_window.hyena_window_bwd(d, *a),
                                    warmup=1, reps=5)
    s = [mk((bw * v, w), 1.0).to(bf) for w in (c, 3 * c, c, c)]
    k8w_step += depth * cs.median_ms(torch, lambda: window_attention.window_attention_wgrad(*s),
                                     warmup=1, reps=5)
    del a, d, s
print(f"split-K users: K1 bwd {k1_step:.3f} ms per ptx step; K8 weight gradients "
      f"{k8w_step:.3f} ms per ptx_attn step", flush=True)
print(f"turn seconds {time.time() - t0:.1f}", flush=True)
"""

STEP = re.compile(r"phase (12|20|36|45) (?:train throughput: ptx|vessel|ptx_attn|emb_attn) train "
                  r"step .*?: ([0-9.]+) ms/step")
PROFILE = re.compile(r"phase (12|20|36|45) (?:ptx_attn |emb_attn |vessel )?profile: one step, "
                     r"device time ([0-9.]+) ms; top: (.*)")
BACKWARDS = re.compile(r"backward times: K2 bwd ([0-9.]+) ms per ptx step; K4 bwd ([0-9.]+) ms "
                       r"per vessel step; K2' bwd ([0-9.]+) ms per call")
SPLIT_K = re.compile(r"split-K users: K1 bwd ([0-9.]+) ms per ptx step; K8 weight gradients "
                     r"([0-9.]+) ms per ptx_attn step")
# kernel names whose device time per step the summary reports: K1's and K8's
# backward kernels; K2's and K4's (the parent's one kernel each, this tree's
# passes: the row, scan and gate kernels, the shared row-tiled and split-K
# products and row passes)
KERNELS = ("hyena_window_bwd_kernel", "window_attention_wgrad_kernel", "wattn_rows_mma_kernel",
           "wattn_keys_mma_kernel", "window_attention_rows_kernel",
           "window_attention_keys_kernel", "proj_gemm_kernel", "fused_ln_mlp_bwd_kernel",
           "mamba_window_bwd_kernel", "mlp_rows_mma_kernel", "mamba_scan_bwd_kernel",
           "mamba_gate_bwd_kernel", "gemm_rows_kernel", "lcbi::wgrad_kernel", "ln_bwd_kernel",
           "ln_rows_kernel", "reduce_slots_kernel")
NAMES = {"12": "ptx", "20": "vessel", "36": "ptx_attn", "45": "emb_attn"}


def run_turn(label: str, root: str, env: dict) -> dict:
    """One turn: its step times {config: ms} and kernel times {config:
    {kernel: ms}}, after echoing its output."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", TURN], cwd=root, env=env, capture_output=True,
                          text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        print(f"[{label}] {line}", flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"turn {label} failed (exit {proc.returncode})")
    steps, kernels = {}, {}
    for line in proc.stdout.splitlines():
        m = BACKWARDS.search(line)
        if m:
            steps.update({"K2 bwd/ptx step": float(m.group(1)),
                          "K4 bwd/vessel step": float(m.group(2)),
                          "K2' bwd/call": float(m.group(3))})
        m = SPLIT_K.search(line)
        if m:
            steps.update({"K1 bwd/ptx step": float(m.group(1)),
                          "K8 wgrad/ptx_attn step": float(m.group(2))})
        m = STEP.search(line)
        if m:
            steps[NAMES[m.group(1)]] = float(m.group(2))
        m = PROFILE.search(line)
        if m:
            per = kernels.setdefault(NAMES[m.group(1)], {})
            for part in m.group(3).split("; "):
                km = re.match(r"(.*?) ([0-9.]+) ms \(", part)
                if km:
                    for name in KERNELS:
                        if name in km.group(1):
                            per[name] = per.get(name, 0.0) + float(km.group(2))
    print(f"[{label}] turn took {time.time() - t0:.1f} s", flush=True)
    return {"steps": steps, "kernels": kernels}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not os.path.isfile(os.path.join(argv[0], "chip_smoke.py")):
        raise SystemExit("usage: ab_parent <parent checkout holding chip_smoke.py>")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parent = os.path.abspath(argv[0])
    info = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {info}", flush=True)
    env = dict(os.environ)
    results = []
    for label, root in (("parent", parent), ("change", here), ("change", here),
                        ("parent", parent)):
        results.append((label, run_turn(label, root, env)))
    print("summary (ms per train step, bf16, batch 4, and the backwards' ms; kernels: profiled "
          "device ms per step):")
    for label, r in results:
        steps = ", ".join(f"{k} {v:.2f}" for k, v in r["steps"].items())
        kern = "; ".join(f"{cfg}: " + ", ".join(f"{k} {v:.2f}" for k, v in ks.items())
                         for cfg, ks in r["kernels"].items())
        print(f"  {label}: {steps} | {kern}", flush=True)


if __name__ == "__main__":
    main()
