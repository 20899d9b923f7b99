"""Compare this tree with another checkout of the repository (its parent
commit, say) on one card, in turns: parent, this tree, this tree, parent.

    git archive <parent> | tar -x -C build/parent
    python3 -m long_context_biomedical_imaging_tpu_torch.utils.ab_parent build/parent [config ...]

Each turn is a fresh process started in that tree's root, which imports the
tree's own ``chip_smoke.py`` and runs its train-step phases for every
configuration: ptx (12: Hyena, K1 and K2), emb (16: K3), vessel (20: Mamba,
K4), vit16k (24: K5), vit65k_hyena (28: K6), vit65k_mamba (32: K7),
ptx_attn (36: K8's whole-window path), micro_w7 (40: K9) and emb_attn (45:
K8's general path). Then its K3 phase (13) and its K4 phase (17), from which it
prints K3's forward per call at each emb stage shape and K3's forward,
backward and dM per emb step, and K4's forward per call at each vessel
stage shape and K4's forward and backward per vessel step (the phases'
bf16 times with the folded LN, times the stage's depth); then its K1 phase
(3) and its K8 phase (33), from which it prints K1's forward per call at
each ptx stage shape and per ptx step, and K8's whole-window forward and
backward per call at each ptx_attn stage shape and per ptx_attn step
(phase 33's ``fwd`` and ``bwd``: the projection streams, the attention
core and the out projection or dx, without the weight gradients); then its
K7 phase (29) and its K9 phase (37), from which it prints K7's forward
(both calls), carry backward and backward per call at the vit65k_mamba
shape and K9's forward and backward per call at micro_w7's stages (those
its tree's gate routes to K9), and K7's backward per vit65k_mamba step and
K9's backward and forward per micro_w7 step. The summary holds each train
step's peak memory beside its time.
Configurations named after the checkout limit the turns to those
configurations' train steps (to read a step's spread again); the names
``k3``, ``k4``, ``k7`` and ``k9`` run K3's phase 13, K4's phase 17, K7's
phase 29 or K9's phase 37 alone. Kernels build at their first launch into
each tree's own ``build/kernels/``. Every line a turn prints is echoed with
the turn's label; a summary of the step times, the per-step kernel times
and the profiled device time of each step and of the kernels named in
``KERNELS`` ends the output. Needs one card.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time

# what a turn runs, in that tree's root; the phases are chip_smoke.py's:
# the head, one train-step phase per configuration, then the kernel phases
HEAD = r"""
import sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
dev = torch.device("cuda", 0)
t0 = time.time()
"""
STEP_PHASES = {
    "ptx": "cs.phase_train_throughput(torch, dev)",
    "emb": "cs.phase_emb_throughput(torch, dev)",
    "vessel": "cs.phase_vessel_throughput(torch, dev)",
    "vit16k": "cs.phase_vit_throughput(torch, dev)",
    "vit65k_hyena": 'cs.phase_config_throughput(torch, dev, cs.vit65k_hyena_flags(), 28, '
                    '"vit65k_hyena")',
    "vit65k_mamba": 'cs.phase_config_throughput(torch, dev, cs.vit65k_mamba_flags(), 32, '
                    '"vit65k_mamba")',
    "ptx_attn": 'cs.phase_config_throughput(torch, dev, cs.ptx_attn_flags(), 36, "ptx_attn", '
                'batch=cs.BATCH)',
    "micro_w7": 'cs.phase_config_throughput(torch, dev, cs.micro_w7_flags(), 40, "micro_w7", '
                'batch=cs.BATCH)',
    "emb_attn": 'cs.phase_config_throughput(torch, dev, cs.emb_attn_flags(), 45, "emb_attn", '
                'batch=cs.BATCH, volume=cs.EMB_VOLUME)',
    # not train steps: K3's kernel phase alone (forward, backward, dM per
    # call at the emb stage shapes, fp32 and bf16), K4's (forward and
    # backward at the vessel stage shapes, then d_state 16)
    "k3": "from long_context_biomedical_imaging_tpu_torch.ops import hyena_window\n"
          "cs.phase_k3(torch, hyena_window, dev)",
    "k4": "from long_context_biomedical_imaging_tpu_torch.ops import mamba_window\n"
          "cs.phase_k4(torch, mamba_window, dev)",
    # K7's kernel phase alone (the op at three shapes, each kernel against its
    # pass, times at the vit65k_mamba shape), K9's (micro_w7's stages)
    "k7": "from long_context_biomedical_imaging_tpu_torch.ops import selective_scan_long\n"
          "cs.phase_k7(torch, selective_scan_long, dev)",
    "k9": "from long_context_biomedical_imaging_tpu_torch.ops import selective_scan_window\n"
          "cs.phase_k9(torch, selective_scan_window, dev)",
}
KERNEL_PHASES = r"""
from long_context_biomedical_imaging_tpu_torch.ops import hyena_window, mamba_window, window_attention
k3 = cs.phase_k3(torch, hyena_window, dev)["bfloat16"]
k4 = cs.phase_k4(torch, mamba_window, dev)["bfloat16"]
k3_step = {key: sum(depth * r[1] for r, (_, _, depth) in zip(k3[key], cs.EMB_K3_STAGES))
           for key in ("fwd", "bwd", "dm")}
k4_step = {key: sum(depth * r[1] for r, (_, _, depth) in zip(k4[key], cs.VESSEL_K4_STAGES))
           for key in ("fwd", "bwd")}
print("per-call kernels (ms, bf16): K3 fwd (C = 96, 192) "
      + ", ".join(f"{r[1]:.3f}" for r in k3["fwd"]) + "; K4 fwd (C = 96, 192, 384) "
      + ", ".join(f"{r[1]:.3f}" for r in k4["fwd"]), flush=True)
print(f"per-step kernels: K3 fwd {k3_step['fwd']:.3f} ms per emb step; K3 bwd "
      f"{k3_step['bwd']:.3f}; K3 dM {k3_step['dm']:.3f}; K4 fwd {k4_step['fwd']:.3f} ms per "
      f"vessel step; K4 bwd {k4_step['bwd']:.3f}", flush=True)
k1 = cs.phase_k1(torch, hyena_window, dev)[("bfloat16", True)]
k1_step = sum(depth * r[1] for r, (_, _, depth) in zip(k1, cs.STAGES))
k8 = cs.phase_k8(torch, window_attention, dev)
k8_step = sum(depth * r[1] for r, (*_, depth) in zip(k8["fwd"], cs.ATTN_STAGES))
k8b_step = sum(depth * r[1] for r, (*_, depth) in zip(k8["bwd"], cs.ATTN_STAGES))
print("per-call kernels (ms, bf16, C = 96 .. 768): K1 fwd "
      + ", ".join(f"{r[1]:.3f}" for r in k1) + "; K8 whole-window fwd "
      + ", ".join(f"{r[1]:.3f}" for r in k8["fwd"]) + "; K8 whole-window bwd "
      + ", ".join(f"{r[1]:.3f}" for r in k8["bwd"]), flush=True)
print(f"per-step kernels: K1 fwd {k1_step:.3f} ms per ptx step; K8 whole-window fwd "
      f"{k8_step:.3f} ms per ptx_attn step; K8 whole-window bwd {k8b_step:.3f} ms per "
      f"ptx_attn step", flush=True)
from long_context_biomedical_imaging_tpu_torch.ops import selective_scan_long, selective_scan_window
k7 = cs.phase_k7(torch, selective_scan_long, dev)
k9 = cs.phase_k9(torch, selective_scan_window, dev)
k9_depths = [depth for *_, depth in cs.micro_k9_shapes(cs.BATCH)]
print(f"per-call kernels (ms, fp32 operands): K7 fwd (both calls) {k7['fwd'][1]:.4f}, K7 carry "
      f"bwd {k7['carry'][1]:.4f}, K7 bwd {k7['bwd'][1]:.3f}"
      + (f", K7 stitch kernel (both ways) {k7['stitch'][1]:.4f}, torch stitch (both ways) "
         f"{k7['stitch'][2]:.4f}" if "stitch" in k7 else "") + "; K9 fwd (d = "
      + ", ".join(str(s[2]) for s in cs.micro_k9_shapes(cs.BATCH)) + ") "
      + ", ".join(f"{r[1]:.3f}" for r in k9["fwd"]) + "; K9 bwd "
      + ", ".join(f"{r[1]:.3f}" for r in k9["bwd"]), flush=True)
print(f"per-step kernels: K7 bwd {cs.VIT_LAYERS * k7['bwd'][1]:.3f} ms per vit65k_mamba step; "
      f"K9 bwd {sum(d * r[1] for d, r in zip(k9_depths, k9['bwd'])):.3f} ms per micro_w7 step; "
      f"K9 fwd {sum(d * r[1] for d, r in zip(k9_depths, k9['fwd'])):.3f}", flush=True)
"""
TAIL = 'print(f"turn seconds {time.time() - t0:.1f}", flush=True)\n'


# the entries of STEP_PHASES that are kernel phases, not configurations: a
# default turn runs them once, in KERNEL_PHASES
KERNEL_ONLY = ("k3", "k4", "k7", "k9")


def turn_code(configs=None) -> str:
    """A turn's program: every configuration's train step and the kernel
    phases, or (configs given) only those configurations' train steps."""
    names = [n for n in STEP_PHASES if n not in KERNEL_ONLY] if not configs else configs
    return (HEAD + "".join(STEP_PHASES[n] + "\n" for n in names)
            + ("" if configs else KERNEL_PHASES) + TAIL)


STEP = re.compile(r"phase (\d+) (?:train throughput: )?(\S+) train step .*?: ([0-9.]+) ms/step")
PROFILE = re.compile(r"phase (\d+) ((?:\S+ )*?)profile: one step, device time ([0-9.]+) ms; "
                     r"top: (.*)")
PER_STEP = re.compile(r"per-step kernels: K1 fwd ([0-9.]+) ms per ptx step; K8 whole-window fwd "
                      r"([0-9.]+) ms per ptx_attn step; K8 whole-window bwd ([0-9.]+) ms")
PER_STEP_34 = re.compile(r"per-step kernels: K3 fwd ([0-9.]+) ms per emb step; K3 bwd ([0-9.]+); "
                         r"K3 dM ([0-9.]+); K4 fwd ([0-9.]+) ms per vessel step; K4 bwd ([0-9.]+)")
PER_STEP_79 = re.compile(r"per-step kernels: K7 bwd ([0-9.]+) ms per vit65k_mamba step; K9 bwd "
                         r"([0-9.]+) ms per micro_w7 step(?:; K9 fwd ([0-9.]+))?")
PEAK = re.compile(r"phase (\d+) (?:train throughput: )?(\S+) train step .*?peak memory ([0-9.]+) "
                  r"GiB")
# kernel names (substrings) whose device time per step the summary reports:
# K3's forward (its three launches, k3_rows_in, k3_toeplitz and k3_rows_out,
# the older tree's and this tree's by the same names; k3_toeplitz also
# matches the backward's k3_toeplitz_bwd_kernel), K4's forward (the older
# tree's mamba_window_fwd_kernel, this tree's mamba_fwd_mma_kernel; the
# general kernel keeps the older name), K1's forward (hyena_fwd_mma_kernel)
# and backward, K2's forward, K8's whole-window forward
# (wattn_whole_fwd_kernel and the projections' proj_rows_kernel, which the
# backward shares) and backward core, K7's and K9's backwards (the older
# tree's long_scan_bwd_kernel and window_scan_bwd_kernel, this tree's
# scan_bwd_lanes_kernel with its tiles' dB | dC sum scan_bc_tiles_kernel) and
# the other K7 and K9 kernels (K7's forward and carry backward: the older
# tree's long_scan_fwd_kernel and long_scan_carry_bwd_kernel, this tree's
# long_scan_stream_kernel; this tree's stitch, long_scan_stitch_kernel, where
# the older tree ran torch ops)
KERNELS = ("k3_rows_in", "k3_toeplitz_fwd", "k3_toeplitz_mma", "k3_rows_out",
           "mamba_window_fwd_kernel", "mamba_fwd_mma_kernel", "hyena_fwd_mma_kernel",
           "wattn_whole_fwd_kernel", "proj_rows_kernel", "wattn_whole_bwd_kernel",
           "hyena_window_bwd_kernel", "mlp_fwd_mma_kernel", "long_scan_bwd_kernel",
           "window_scan_bwd_kernel", "scan_bwd_lanes_kernel", "scan_bc_tiles_kernel",
           "long_scan_fwd_kernel", "long_scan_carry_bwd_kernel", "long_scan_stream_kernel",
           "long_scan_stitch_kernel", "window_scan_fwd_kernel")
NAMES = {"12": "ptx", "16": "emb", "20": "vessel", "24": "vit16k", "28": "vit65k_hyena",
         "32": "vit65k_mamba", "36": "ptx_attn", "40": "micro_w7", "45": "emb_attn"}


def run_turn(label: str, root: str, env: dict, code: str) -> dict:
    """One turn of the program ``code``: its step times {config: ms} and
    kernel times {config: {kernel: ms}}, after echoing its output."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                          text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        print(f"[{label}] {line}", flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"turn {label} failed (exit {proc.returncode})")
    steps, kernels = {}, {}
    for line in proc.stdout.splitlines():
        m = PER_STEP.search(line)
        if m:
            steps.update({"K1 fwd/ptx step": float(m.group(1)),
                          "K8 whole-window fwd/ptx_attn step": float(m.group(2)),
                          "K8 whole-window bwd/ptx_attn step": float(m.group(3))})
        m = PER_STEP_79.search(line)
        if m:
            steps.update({"K7 bwd/vit65k_mamba step": float(m.group(1)),
                          "K9 bwd/micro_w7 step": float(m.group(2))})
            if m.group(3):
                steps["K9 fwd/micro_w7 step"] = float(m.group(3))
        m = PER_STEP_34.search(line)
        if m:
            steps.update(zip(("K3 fwd/emb step", "K3 bwd/emb step", "K3 dM/emb step",
                              "K4 fwd/vessel step", "K4 bwd/vessel step"),
                             map(float, m.groups())))
        m = STEP.search(line)
        if m:
            steps[m.group(2)] = float(m.group(3))
        m = PEAK.search(line)
        if m:
            steps[f"{m.group(2)} peak GiB"] = float(m.group(3))
        m = PROFILE.search(line)
        if m and "eval" not in m.group(2) and m.group(1) in NAMES:
            steps[f"{NAMES[m.group(1)]} device"] = float(m.group(3))
            per = kernels.setdefault(NAMES[m.group(1)], {})
            for part in m.group(4).split("; "):
                km = re.match(r"(.*?) ([0-9.]+) ms \(", part)
                if km:
                    for name in KERNELS:
                        if name in km.group(1):
                            per[name] = per.get(name, 0.0) + float(km.group(2))
    print(f"[{label}] turn took {time.time() - t0:.1f} s", flush=True)
    return {"steps": steps, "kernels": kernels}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if (not argv or not os.path.isfile(os.path.join(argv[0], "chip_smoke.py"))
            or any(n not in STEP_PHASES for n in argv[1:])):
        raise SystemExit("usage: ab_parent <parent checkout holding chip_smoke.py> [config ...] "
                         f"(configs: {' '.join(STEP_PHASES)}; none: all, and the kernel phases)")
    code = turn_code(argv[1:])
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
        results.append((label, run_turn(label, root, env, code)))
    print("summary (ms per train step, bf16, each configuration at its batch, and the kernels' "
          "ms per step; kernels: profiled device ms per step):")
    for label, r in results:
        steps = ", ".join(f"{k} {v:.2f}" for k, v in r["steps"].items())
        kern = "; ".join(f"{cfg}: " + ", ".join(f"{k} {v:.2f}" for k, v in ks.items())
                         for cfg, ks in r["kernels"].items())
        print(f"  {label}: {steps} | {kern}", flush=True)


if __name__ == "__main__":
    main()
