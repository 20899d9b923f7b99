"""Compare this tree with another checkout of the repository (its parent
commit, say) on one card, in turns: parent, this tree, this tree, parent.

    git archive <parent> | tar -x -C build/parent
    python3 -m long_context_biomedical_imaging_tpu_torch.utils.ab_parent build/parent

Each turn is a fresh process started in that tree's root, which imports the
tree's own ``chip_smoke.py`` and runs its train-step phases for ptx (Hyena,
K1 and K2), ptx_attn (K8's whole-window path) and emb_attn (K8's general
path), and its K1 backward and K8 general-path kernel times at the stage
shapes: the same functions in both trees, so the turns differ only in the
package they import. Kernels build at their first launch into each tree's
own ``build/kernels/``. Every line a turn prints is echoed with the turn's
label; a summary of the step times and of the profiled device time per
step of the kernels named in ``KERNELS`` ends the output. Needs one card.
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
cs.phase_config_throughput(torch, dev, cs.ptx_attn_flags(), 36, "ptx_attn", batch=cs.BATCH)
cs.phase_config_throughput(torch, dev, cs.emb_attn_flags(), 45, "emb_attn", batch=cs.BATCH,
                           volume=cs.EMB_VOLUME)
print(f"turn seconds {time.time() - t0:.1f}", flush=True)
"""

STEP = re.compile(r"phase (12|36|45) (?:train throughput: ptx|ptx_attn|emb_attn) train step .*?: "
                  r"([0-9.]+) ms/step")
PROFILE = re.compile(r"phase (12|36|45) (?:ptx_attn |emb_attn )?profile: one step, device time "
                     r"([0-9.]+) ms; top: (.*)")
# kernel name prefixes whose device time per step the summary reports
KERNELS = ("hyena_window_bwd_kernel", "window_attention_wgrad_kernel", "wattn_rows_mma_kernel",
           "wattn_keys_mma_kernel", "window_attention_rows_kernel",
           "window_attention_keys_kernel", "proj_gemm_kernel")
NAMES = {"12": "ptx", "36": "ptx_attn", "45": "emb_attn"}


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
    print("summary (ms per train step, bf16, batch 4; kernels: profiled device ms per step):")
    for label, r in results:
        steps = ", ".join(f"{k} {v:.2f}" for k, v in r["steps"].items())
        kern = "; ".join(f"{cfg}: " + ", ".join(f"{k} {v:.2f}" for k, v in ks.items())
                         for cfg, ks in r["kernels"].items())
        print(f"  {label}: {steps} | {kern}", flush=True)


if __name__ == "__main__":
    main()
