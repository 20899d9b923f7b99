"""Smoke run of the PyTorch/CUDA port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing one line of numbers (or a few):
  1. device: the card, as nvidia-smi reports its name and power limit;
  2. build: the hand-written kernels from csrc/ with nvcc, in parallel (one
     nvcc per source: twenty-two sources behind twenty-four entry points, K2'
     sharing K2's), with their build seconds and ptxas register/spill lines;
  3. K1, the fused Hyena window mixer, against its plain PyTorch version at
     the four ptx stage shapes (V = 16), fp32 and bf16, with and without the
     folded pre-LN;
  4. K2, the fused LN + MLP + residual, against its plain version at the four
     ptx stage shapes, fp32 and bf16;
  5. slice: run_torch.main evaluates a synthetic ptx dataset (1024x1024
     float32 images) with the ptx flags of projects/run_ptx.sh, on the card,
     eval only; checks the metrics files and that every forward batch went
     through both forward kernels 12 times (the 12 Swin blocks) and no
     backward kernel ran;
  6. model: the full-width ptx model on a 64x64 input, on the card (kernels)
     against the same weights on the host (plain versions), fp32 and bf16;
  7. throughput: the ptx eval forward at batch 4 on 1024x1024, steady state;
  8. K2 backward against the VJP of its plain forward at the four ptx stage
     shapes, fp32 and bf16, every gradient;
  9. K1 backward likewise, with and without the folded LN;
 10. train slice: run_torch.main trains ptx (--debug, 2 epochs) on the card
     with the ptx flags, saves and reloads checkpoints, evaluates; checks the
     metrics, the checkpoints, the step count and that the forward kernels
     ran 12 times per forward batch (train and eval) and the backward
     kernels 12 times per train step; then --inference_only on that run;
 11. model gradients: one train step's gradients of the full-width ptx model
     on a 64x64 input, on the card against the host, fp32 and bf16; every
     parameter's card gradient finite and not all zero;
 12. train throughput: the ptx train step (forward, backward, Adam) at batch
     4 on 1024x1024 in bf16, steady state, with peak memory and the
     profiler's device-time buckets; then 10 steps on one fixed batch must
     lower its loss;
 13. K3, the chunked Hyena mixer of the emb path (512-token windows):
     forward, backward and dM against their plain versions at the two emb
     K3 stage shapes, fp32 and bf16, with the folded pre-LN;
 14. emb train slice: run_torch.main trains emb (--debug, 2 epochs) on a
     synthetic dataset of 256x256x64 volumes with the flags of
     projects/run_emb.sh, saves and reloads checkpoints, evaluates; checks
     that K3 forward ran 4 times per forward batch, K3 backward and dM 4
     times per train step, K2 12 times, K1 never; then --inference_only;
 15. emb model gradients: one train step's gradients of the full-width emb
     model on a 32x128x128 volume (as emb: K3 at C = 96 and 192, the
     composed path at C = 384 and 768), on the card against the host, fp32
     on one seed and bf16 on three; the card's bf16 gradients may stray from
     its fp32 ones at most twice as far as the host's do;
 16. emb throughput: the emb train step and eval forward at batch 4 on
     256x256x64 in bf16, steady state, with peak memory and a one-step
     profile;
 17. K4, the fused Mamba window mixer of the vessel path (64-token
     windows): forward and backward against their plain versions at the
     three vessel K4 stage shapes, fp32 and bf16, with the folded pre-LN;
 18. vessel train slice: run_torch.main trains vessel (--debug, 2 epochs)
     on a synthetic dataset of 1024x1024x3 images with 2-class masks with
     the flags of projects/run_vessel.sh (Swin-tiny + Mamba + UperNet2D),
     saves and reloads checkpoints, evaluates with F1; checks that K4
     forward ran 10 times per forward batch (stages 0-2), K4 backward 10
     times per train step, K2 12 times, K1 and K3 never; then
     --inference_only, which must reproduce the test metrics;
 19. vessel model gradients: one train step's gradients of the full-width
     vessel model on 512x512 images at batch 4 (K4 at stages 0-1, the
     composed scan at stages 2-3), dropout off, on the card against the
     host, fp32 and bf16 on one seed, per parameter; the card's bf16
     gradient of each parameter may stray from its fp32 one at most twice as
     far as the host's, plus a floor;
 20. vessel throughput: the vessel train step and eval forward at batch 4
     on 1024x1024x3 in bf16, steady state, with peak memory and a one-step
     profile;
 21. K5, the flash attention of the vit16k path: forward, dq and dk/dv
     against the plain version and its VJP at ragged lengths (1, 63, 65,
     1025 tokens), at head dims 32 and 128 (1,025 tokens) and at the vit16k
     shape (12 head-batches of 16,385 tokens, D = 64; the plain version on 4
     of them), fp32 and bf16, two launches bitwise equal; then the times of
     the kernels, the plain version and torch's scaled_dot_product_attention
     at vit16k in bf16;
 22. vit16k train slice: run_torch.main trains vit16k (--debug, 2 epochs)
     on synthetic 1024x1024x1 images with the flags of projects/run_ptx.sh
     for the ViT-small encoder (patch 8, attention), ViTLinear and batch 2,
     saves and reloads checkpoints, evaluates; checks that K5 forward and K2
     forward ran 12 times per forward batch, K5 dq, K5 dkv and K2 backward 12
     times per train step, K1, K3 and K4 never; then --inference_only,
     which must reproduce the test metrics;
 23. vit16k model gradients: one train step's gradients of the full-width
     vit16k model on 256x256 images (1,025 tokens, so K5) at batch 2, on the
     card against the host, fp32 and bf16, per parameter;
 24. vit16k throughput: the vit16k train step and eval forward at batch 2
     on 1024x1024 in bf16, steady state, with peak memory and one-step
     profiles;
 25. K6, the spectral long conv of the vit65k_hyena path: the convolution
     (forward, and with the conjugate spectrum the du of its backward), dk
     and dbias against the plain version and its VJP at the vit65k_hyena
     shape (1, 384, 65536), the odd batch at the gate's floor (3, 8, 8192)
     and the gate's ceiling (1, 4, 131072), with and without the skip bias,
     fp32 and bf16, two launches bitwise equal; the refusals; then the times
     of the kernels and the plain version at (1, 384, 65536) in bf16;
 26. vit65k_hyena train slice: run_torch.main trains vit65k_hyena (--debug,
     2 epochs) on synthetic 1024x1024x1 images with the flags of
     projects/run_ptx.sh for the ViT-small encoder (patch 4, Hyena),
     ViTLinear and batch 1, saves and reloads checkpoints, evaluates; checks
     that the K6 conv ran 12 times per forward batch and 12 more per train
     step (du), K6 dk and K2 backward 12 times per train step, K2 forward 12
     times per forward batch, K1, K3, K4 and K5 never; then
     --inference_only, which must reproduce the test metrics;
 27. vit65k_hyena model gradients: one train step's gradients of the
     full-width ViT-small Hyena on 256x512 images (8,192 tokens, K6's lowest
     length) at batch 1, on the card against the host, fp32 and bf16, per
     parameter;
 28. vit65k_hyena throughput: the train step and eval forward at batch 1 on
     1024x1024 in bf16, steady state, with peak memory and one-step
     profiles;
 29. K7, the long-sequence scan of the vit65k_mamba path: selective_scan_long
     (the forward kernel twice, the carry and backward kernels, the
     stitches) against its plain version (the chunked scan) and the
     gradients of all seven inputs at the vit65k_mamba shape (2, 65536, 192),
     a ragged length with an odd batch (3, 2113, 40) and the gate's widest
     channels (1, 4096, 1024), fp32 and bf16, two runs bitwise equal; each
     kernel against its pass's plain version; the refusals; then the times
     of the kernels and the plain version at the vit65k_mamba shape;
 30. vit65k_mamba train slice: run_torch.main trains vit65k_mamba (--debug,
     2 epochs) on synthetic 1024x1024x1 images with the flags of
     projects/run_ptx.sh for the ViT-small encoder (patch 4, Mamba),
     ViTLinear and batch 1, saves and reloads checkpoints, evaluates; checks
     that the K7 forward ran 24 times per forward batch (twice per block),
     K7 carry backward, K7 backward and K2 backward 12 times per train step,
     K2 forward 12 times per forward batch, K1 and K3-K6 never; then
     --inference_only, which must reproduce the test metrics;
 31. vit65k_mamba model gradients: one train step's gradients of the
     full-width ViT-small Mamba on 128x256 images (2,048 tokens, K7's
     floor) at batch 1, on the card against the host, fp32 and bf16, per
     parameter;
 32. vit65k_mamba throughput: the train step and eval forward at batch 1 on
     1024x1024 in bf16, steady state, with peak memory and one-step
     profiles;
 33. K8, the Swin window attention of the ptx_attn path: the forward, the
     backward and the weight-gradient kernels against the plain version and
     its VJP at the four ptx_attn stage shapes (batch 4: 65,536 .. 1,024
     windows of 16 tokens, C = 96 .. 768), at 64-token windows and at a
     window count no tile divides, with and without the shifted windows'
     region ids, fp32 and bf16; two launches bitwise equal; the
     relative-position table's gradient through the gather; the refusals
     (a CPU tensor, a head dim of 16); then the times of the kernels and the
     plain version at the stage shapes in bf16;
 34. ptx_attn train slice: run_torch.main trains ptx_attn (--debug, 2
     epochs) on synthetic 1024x1024x1 images with the flags of
     projects/run_ptx.sh and the CLI's default mixer, window attention
     (--Swin.use_hyena False --Swin.use_mamba False), saves and reloads
     checkpoints, evaluates; checks that K8 forward and K2 forward ran 12
     times per forward batch, K8 backward, K8 weight gradients and K2
     backward 12 times per train step, K1 and K3-K7 never; then
     --inference_only, which must reproduce the test metrics;
 35. ptx_attn model gradients: one train step's gradients of the full-width
     model on 256x256 images at batch 2 (every stage's odd blocks shift), on
     the card against the host, fp32 and bf16, per parameter;
 36. ptx_attn throughput: the train step and eval forward at batch 4 on
     1024x1024 in bf16, steady state, with peak memory and one-step
     profiles;
 37. K9, the windowed selective scan of the micro_w7 path: the forward and
     backward kernels through selective_scan_window (y and the gradients of
     all seven inputs) against its plain version (selective_scan_cm) and its
     VJP at micro_w7's two K9 stage shapes (batch 4: 21,904 and 5,476 7x7
     windows, d 48 and 96), at 3x3 windows (L = 9) at a window count no tile
     divides, at L = 64 with d = 130 and d = 1024 (N d = 8192), fp32 and
     bf16; two launches bitwise equal; each kernel against its plain pass;
     the refusals (a CPU tensor, L > 64, N d > 8192); then the times of the
     kernels and the plain version at the two stage shapes;
 38. micro_w7 train slice: run_torch.main trains micro_w7 (--debug, 2
     epochs) on synthetic 1024x1024x1 enhancement pairs with the flags of
     projects/run_micro.sh and --Swin.window_size 7 (Swin-tiny + Mamba +
     UperNet2D, CombinationEnhance), saves and reloads checkpoints,
     evaluates loss, SSIM and PSNR; checks that K9 forward ran as the gate
     routes each forward batch (stages 0-1 at batch 4: 4 blocks) and K9
     backward as it routes each train step, K2 12 times per forward batch
     and per train step, K1 and K3-K8 never; then --inference_only, which
     must reproduce the test metrics;
 39. micro_w7 model gradients: one train step's gradients of the
     full-width micro_w7 model under CombinationEnhance on 512x512 images at
     batch 4 (stage 0 reaches K9 by the gate itself: 5,476 windows), dropout
     off, on the card against the host, fp32 and bf16, per parameter, as
     phase 19 holds vessel;
 40. micro_w7 throughput: the train step and eval forward at batch 4 on
     1024x1024 in bf16, steady state, with peak memory and one-step
     profiles;
 41. micro as shipped: run_torch.main with projects/run_micro.sh's own flags
     (window 4) trains one step and evaluates at 1024x1024; checks that K4
     ran in all 12 blocks (16-token windows) and K9 never, and prints its
     step and eval times;
 42. K8 at every window class: the forward, backward and weight-gradient
     kernels against the plain version and its VJP at V = 16 and 64 (the
     whole-window path) and 49, 256, 343 and 512 (the general path), with
     and without region ids, and at emb_attn's four stage shapes (batch 4:
     4,096 / 512 / 64 windows of 8x8x8 and 16 of 4x8x8, C = 96 .. 768) with
     their region ids, the plain version on at most 1,024 windows at a time,
     fp32 and bf16; two launches bitwise equal; V = 513 takes the plain
     version with no K8 launch; a CPU tensor, V = 0 and a head dim of 48
     refused; then the times of the kernels on each whole stage shape and of
     the plain version over the same windows in slices;
 43. emb_attn train slice: run_torch.main trains emb_attn (--debug, 2
     epochs) on synthetic 256x256x64 volumes with the flags of
     projects/run_emb.sh and the CLI's default mixer, window attention
     (--Swin.use_hyena False --Swin.use_mamba False), saves and reloads
     checkpoints, evaluates; checks that K8 forward and K2 forward ran 12
     times per forward batch, K8 backward, K8 weight gradients and K2
     backward 12 times per train step, K1, K3-K7, K9 and K2' never; then
     --inference_only, which must reproduce the test metrics;
 44. emb_attn model gradients: one train step's gradients of the
     full-width model on 64x64x32 volumes at batch 2 (stages 0-1 in shifted
     8x8x8 windows, stages 2-3 in windows shrunk to the grid), on the card
     against the host, fp32 and bf16, per parameter, as phase 35;
 45. emb_attn throughput: the train step and eval forward at batch 4 on
     256x256x64 in bf16, steady state, with peak memory and one-step
     profiles;
 46. K2', the MLP without LN or residual, behind MLPBlock (eval, its kernel
     path) at ViT-small widths on 32,770 rows (vit16k's tokens at batch 2):
     forward and every gradient against fused_mlp_plain and its VJP, fp32
     and bf16, one launch of each K2' kernel per pass and none of K2's, two
     launches bitwise equal, and the times of the kernels and the plain
     version.
Then one JSON line with the kernels' numbers, and last the result line.
Every time is on this card, with its name and power limit printed in phase 1.
It imports neither JAX nor the JAX package, and fails (exit code != 0, no
result line) without a CUDA card or without the port beside it.
"""

from __future__ import annotations

import json
import math
import os
import re
import shlex
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "long_context_biomedical_imaging_tpu_torch"


def project_flags(script_name: str) -> list[str]:
    """The flags projects/<script_name> passes to the entry point."""
    with open(os.path.join(REPO, "projects", script_name)) as f:
        script = f.read().replace("\\\n", " ")
    line = next(ln for ln in script.splitlines() if ln.strip().startswith("$RUN"))
    return [t for t in shlex.split(line)[1:] if t != "$@"]


def ptx_flags() -> list[str]:
    return project_flags("run_ptx.sh")


def emb_flags() -> list[str]:
    return project_flags("run_emb.sh")


def vessel_flags() -> list[str]:
    return project_flags("run_vessel.sh")


def micro_flags() -> list[str]:
    return project_flags("run_micro.sh")


def micro_w7_flags() -> list[str]:
    """micro_w7: the flags of projects/run_micro.sh with 7x7 windows (the
    Swin Transformer's published window; 49 tokens, K9's route)."""
    return micro_flags() + ["--Swin.window_size", "7"]


def ptx_attn_flags() -> list[str]:
    """ptx_attn: the flags of projects/run_ptx.sh with the CLI's default
    mixer, window attention (--Swin.use_hyena False --Swin.use_mamba False,
    which override the script's own mixer flags)."""
    return ptx_flags() + ["--Swin.use_hyena", "False", "--Swin.use_mamba", "False"]


def emb_attn_flags() -> list[str]:
    """emb_attn: the flags of projects/run_emb.sh with the CLI's default
    mixer, window attention (3D Swin-tiny, 8x8x8 windows)."""
    return emb_flags() + ["--Swin.use_hyena", "False", "--Swin.use_mamba", "False"]


def _vit_flags(patch: int, batch: int, mixer: str) -> list[str]:
    """The flags of projects/run_ptx.sh with the ViT-small encoder for Swin,
    ViTLinear for SwinLinear and the given patch, batch size and mixer
    ("attention", "hyena" or "mamba")."""
    flags, out, i = ptx_flags(), [], 0
    while i < len(flags):
        flag, values = flags[i], []
        i += 1
        while i < len(flags) and not flags[i].startswith("--"):
            values.append(flags[i])
            i += 1
        name = flag.split("=")[0]
        if name.startswith("--Swin.") or name in ("--encoder_name", "--decoder_name"):
            continue
        if name == "--batch_size":
            flag, values = f"--batch_size={batch}", []
        out += [flag] + values
    return out + ["--encoder_name=ViT", "--ViT.size=small", "--ViT.patch_size", str(patch),
                  "--ViT.use_hyena", str(mixer == "hyena"), "--ViT.use_mamba",
                  str(mixer == "mamba"), "--decoder_name=ViTLinear"]


def vit16k_flags() -> list[str]:
    """vit16k (scripts/overfit_one_batch.py): ViT-small, patch 8, softmax
    attention, batch 2."""
    return _vit_flags(8, VIT_BATCH, "attention")


def vit65k_hyena_flags() -> list[str]:
    """vit65k_hyena (scripts/overfit_one_batch.py): ViT-small, patch 4, the
    Hyena mixer over all 65,536 tokens, batch 1."""
    return _vit_flags(4, H65_BATCH, "hyena")


def vit65k_mamba_flags() -> list[str]:
    """vit65k_mamba (scripts/overfit_one_batch.py): ViT-small, patch 4, the
    Mamba mixer (d_state 8) over all 65,536 tokens, batch 1."""
    return _vit_flags(4, H65_BATCH, "mamba")


# ptx at batch 4: Swin-tiny stages on 512^2 .. 64^2 token grids, windows of 16
STAGES = [(96, 512, 2), (192, 256, 2), (384, 128, 6), (768, 64, 2)]  # C, grid, depth
BATCH = 4
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # of max|plain out|: sum order; a bf16 ulp
# backward, of each gradient's max|plain|: fp32 sum order (rows within a
# block, then blocks); bf16: the kernels round their products' operands where
# the TPU kernels do, the plain VJP elsewhere
GRAD_TOL = {"float32": 1e-3, "bfloat16": 3e-2}
# whole-model gradients, card (kernels) against host (plain versions), of each
# parameter's max|host grad|: fp32 sum order; bf16 as above compounded over
# 12 blocks, largest in bias gradients that sum a bf16 cotangent over every
# token with cancellation (tests/test_torch_train.py measures the same effect
# against the JAX package)
MODEL_GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
# phase 15: against the card's fp32 gradients, the card's bf16 ones may
# stray at most this many times as far as the host's (the plain versions')
BF16_GRAD_RATIO = 2.0
# phase 19, the vessel model's fp32 gradients, card against host: rounding
# moves them far more than emb's (see phase_vessel_grads); an H100 read 2.1e-3
# over the whole model and 1.0e-3 in the encoder; the encoder holds every K4
# parameter, so a K4 weight gradient off by more than 3e-3 of its max fails
VESSEL_GRAD_TOL = 1e-2
VESSEL_ENCODER_GRAD_TOL = 3e-3
# phase 19, bf16: each parameter's card error may exceed BF16_GRAD_RATIO x the
# host's by this much of its max (an H100 came nearest at a stage-1 A_log:
# 0.118 against the host's 0.046)
VESSEL_BF16_GRAD_FLOOR = 5e-2
EMB_GRAD_SEEDS = (10, 11, 12)
# emb at batch 4, the K3 stages: C, windows of 512 tokens, depth
EMB_K3_STAGES = [(96, 4096, 2), (192, 512, 2)]
# vessel at batch 4 on 1024x1024, the K4 stages: C, windows of 64 tokens,
# depth (stage 3, 256 windows, runs the composed scan)
VESSEL_K4_STAGES = [(96, 16384, 2), (192, 4096, 2), (384, 1024, 6)]
VESSEL_K4_BLOCKS = sum(d for _, _, d in VESSEL_K4_STAGES)
# vit16k at batch 2: 1024x1024 in 8x8 patches and the cls token; ViT-small's 6
# heads of 64 in each of 12 layers
VIT_BATCH, VIT_L, VIT_LAYERS = 2, 16385, 12
VIT_BH = VIT_BATCH * 6
# K5's ragged shapes (BH, L): a lone token, a short tile, a tile and a row,
# 16 tiles and a row
K5_RAGGED = [(3, 1), (3, 63), (2, 65), (2, 1025)]
# phase 21's planted-key inputs at vit16k: queries lean on a unit direction u
# by K5_LEAN, key L - 1 is K5_PLANT * u; its score is then scale * K5_PLANT *
# (K5_LEAN + N(0, 1)), against the 16,384 iid keys' log-sum-exp of about 10
K5_LEAN, K5_PLANT = 2.0, 32.0
# at vit16k the plain version takes this many head-batches at a time: it holds
# (L, L) fp32 scores per head-batch, several of them in its VJP
K5_PLAIN_SLICE = 2
# phase 23, bf16: each parameter's card error may exceed BF16_GRAD_RATIO x the
# host's by this much of its max
VIT_BF16_GRAD_FLOOR = 2e-2
# phase 21, K5 at the other head dims (BH, L, D): 1,025 tokens, ragged at
# either tile edge (64 rows at D = 32, 32 at D = 128)
K5_HEAD_DIMS = [(2, 1025, 32), (2, 1025, 128)]
# vit65k_hyena at batch 1: 1024x1024 in 4x4 patches, no cls token; the Hyena
# long conv of each of ViT-small's 12 layers on (1, 384, 65536)
H65_BATCH, H65_L, H65_D = 1, 65536, 384
# phase 25, K6's shapes (B, D, L): the vit65k_hyena call, the odd batch at the
# gate's floor, the gate's ceiling
K6_SHAPES = [(H65_BATCH, H65_D, H65_L), (3, 8, 8192), (1, 4, 131072)]
# of each output's max|plain|: fp32, the four-step FFT against cuFFT, fp32
# round-off of a length-2L transform; bf16, both sum in fp32 and round once
K6_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# phase 27, bf16: each parameter's card error may exceed BF16_GRAD_RATIO x the
# host's by this much of its max
H65_BF16_GRAD_FLOOR = 2e-2
# vit65k_mamba's scan in each of ViT-small's 12 layers: u, delta (b, L, D) and
# B, C (b, L, 8), b = 2 (run_torch.main duplicates a batch of one image), D the
# mixer's d_half
M65_D, K7_N = 192, 8
# phase 29, K7's shapes (b, L, D): the vit65k_mamba call, a ragged length with
# an odd batch (the carries stay within their batch row), the gate's widest
# channels (N D = 8192)
K7_SHAPES = [(2, H65_L, M65_D), (3, 2113, 40), (1, 4096, 1024)]
# of each output's max|plain|: fp32, the kernels' exp2 and softplus forms and
# the chunked scan's log-depth association (y), the sums of dA, dD and the
# bias gradient over up to 131,072 tokens in another order (gradients); bf16,
# the output and the inputs' gradients are rounded once to bf16 on both sides
K7_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 3e-2)}
# each kernel against its pass's plain version on the same fp32 inputs: the
# exp2 and softplus forms, dA's sum order
K7_PASS_TOL = 1e-4
# phase 31, bf16: each parameter's card error may exceed BF16_GRAD_RATIO x the
# host's by this much of its max
M65_BF16_GRAD_FLOOR = 2e-2
# ptx_attn at batch 4: each stage's K8 call, (BW windows of 16 tokens, C, token
# grid, depth); the odd blocks carry the stage's (nW, 16) region ids
ATTN_STAGES = [(BATCH * (grid // 4) ** 2, c, grid, depth) for c, grid, depth in STAGES]
ATTN_BLOCKS = sum(d for _, _, _, d in ATTN_STAGES)
# phase 33, K8's other shapes (BW, V, C, token grid or None): 64-token windows
# (the 2D window 8 of vessel and cmr) with their region ids, and a window
# count that no 64-row tile divides (random region ids, 7 rows)
K8_EXTRA = [(4 * 144, 64, 96, 96), (1001, 16, 192, None)]
# phase 35, bf16: each parameter's card error may exceed BF16_GRAD_RATIO x the
# host's by this much of its max
ATTN_BF16_GRAD_FLOOR = 2e-2
# phase 35 holds the gradients at this batch of 256x256 images: token grids
# 128 .. 16, so every stage's odd blocks shift
ATTN_GRAD_BATCH = 2
# micro_w7 at batch 4: each stage's Swin grid padded to a multiple of 7, (C,
# padded token grid, depth); the Mamba mixer's d_half is C / 2
MICRO_STAGES = [(c, -(-grid // 7) * 7, depth) for c, grid, depth in STAGES]
# phase 37, K9's shapes (BW, L, d) beyond the two stage shapes: 3x3 windows at
# a window count no tile divides, the longest window at an odd width, the
# gate's widest channels (N d = 8192)
K9_EXTRA = [(3001, 9, 40), (2049, 64, 130), (257, 64, 1024)]
K9_N = 8
# phase 39 holds the micro_w7 gradients at this batch of 512x512 images
MICRO_GRAD_BATCH = 4
# emb_attn's (T, H, W) volume
EMB_VOLUME = (64, 256, 256)
# phase 42, K8's window classes beyond emb_attn's stages (BW, V, C, region ids):
# the whole-window path's 16 and 64 tokens, a 7x7 window, 7x7x7, 4x8x8 and
# 8x8x8 windows at the stage widths, random region ids in 4 rows
K8_CLASSES = [(256, 16, 96, True), (64, 64, 192, True), (300, 49, 96, True),
              (24, 343, 192, True), (32, 256, 768, True), (16, 512, 384, True)]
# phase 42 holds the plain version at emb_attn's stages on at most this many
# windows at a time: its fp32 scores and their VJP at stage 0 (4,096 windows
# of 512 tokens, 3 heads) would take 12.9 GB each
K8_PLAIN_WINDOWS = 1024
# phase 44 holds the emb_attn gradients at this (T, H, W): token grids
# 16x32x32 .. 2x4x4, so stages 0-1 run 512-token windows (shifted) and
# stages 2-3 windows shrunk to the grid (256 and 32 tokens)
EMB_ATTN_GRAD_VOLUME = (32, 64, 64)
# phase 46, K2' at ViT-small widths on vit16k's tokens at batch 2 (N, C, H)
K2P_SHAPE = (VIT_BATCH * VIT_L, 384, 1536)
# the card's peaks for the bounds (H100 SXM data sheet, dense): bf16 tensor
# cores, fp32 outside them, device memory
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def median_ms(torch, fn, warmup=2, reps=7):
    """Median over reps of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def compare(torch, out, ref, dtype_name, min_scale=0.0):
    """(max abs err, max|ref|, ok) of an output against its reference: ok when
    finite and err <= TOL * max(max|ref|, min_scale)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    ok = (bool(torch.isfinite(out).all().item())
          and err <= TOL[dtype_name] * max(scale, min_scale))
    return err, scale, ok


def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = shutil.which("nvidia-smi")
    check(smi is not None, "nvidia-smi not found")
    out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {out.stdout.strip()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {torch.cuda.device_count()} card(s)", flush=True)
    print(out.stdout.strip(), flush=True)
    return name


def all_kernels():
    """K1 fwd, K2 fwd, K1 bwd, K2 bwd, K3 fwd, K3 bwd, K3 dM, K4 fwd, K4 bwd,
    K5 fwd, K5 dq, K5 dkv, K6 conv, K6 dk, K7 fwd, K7 carry bwd, K7 bwd, K8
    fwd, K8 bwd, K8 weight gradients, K9 fwd, K9 bwd, K2' fwd, K2' bwd (K2'
    shares K2's sources, behind its own entry points: runs key launches by
    the entry point's symbol)."""
    from long_context_biomedical_imaging_tpu_torch.ops import (flash_attention, fused_mlp,
                                                               hyena_window, mamba_window,
                                                               selective_scan_long,
                                                               selective_scan_window,
                                                               spectral_conv, window_attention)

    return (hyena_window.HYENA_WINDOW_FWD, fused_mlp.FUSED_LN_MLP_FWD,
            hyena_window.HYENA_WINDOW_BWD, fused_mlp.FUSED_LN_MLP_BWD,
            hyena_window.HYENA_CHUNKED_FWD, hyena_window.HYENA_CHUNKED_BWD,
            hyena_window.HYENA_DM, mamba_window.MAMBA_WINDOW_FWD, mamba_window.MAMBA_WINDOW_BWD,
            flash_attention.FLASH_FWD, flash_attention.FLASH_BWD_DQ,
            flash_attention.FLASH_BWD_DKV, spectral_conv.SPECTRAL_CONV,
            spectral_conv.SPECTRAL_CONV_DK, selective_scan_long.LONG_SCAN_FWD,
            selective_scan_long.LONG_SCAN_CARRY_BWD, selective_scan_long.LONG_SCAN_BWD,
            window_attention.WINDOW_ATTENTION_FWD, window_attention.WINDOW_ATTENTION_BWD,
            window_attention.WINDOW_ATTENTION_WGRAD, selective_scan_window.WINDOW_SCAN_FWD,
            selective_scan_window.WINDOW_SCAN_BWD, fused_mlp.FUSED_MLP_FWD,
            fused_mlp.FUSED_MLP_BWD)


def check_launches(kernels, launches, expected, where):
    """Each kernel's launch count in a run against the expected count (0
    where the run's path does not reach it)."""
    for i, kernel in enumerate(kernels):
        want = expected.get(i, 0)
        check(launches[kernel.symbol] == want,
              f"{kernel.symbol} launched {launches[kernel.symbol]} times in {where}, "
              f"expected {want}")


def phase_build():
    """Build every kernel library at once: one nvcc process per source (an
    entry point whose source another kernel builds loads that library)."""
    from concurrent.futures import ThreadPoolExecutor

    kernels = list({k.source: k for k in reversed(all_kernels())}.values())[::-1]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        seconds = list(pool.map(lambda k: k.load(), kernels))
    for kernel in all_kernels():
        kernel.load()
    for kernel, sec in zip(kernels, seconds):
        usage = [line.strip() for line in kernel.build_log.splitlines()
                 if "registers" in line or "spill" in line]
        print(f"phase 2 build: {kernel.source} {sec:.1f} s; " + " | ".join(usage), flush=True)
    print(f"phase 2 build: all {len(kernels)} in {time.perf_counter() - t0:.1f} s wall",
          flush=True)


def phase_k1(torch, hyena_window, dev):
    """Returns {(dtype, ln): [(err, kernel_ms, plain_ms) per stage]}."""
    gen = torch.Generator().manual_seed(1)

    def mk(shape, scale=0.3):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    results = {}
    for c, grid, _ in STAGES:
        bw, v = BATCH * (grid // 4) ** 2, 16
        x = mk((bw, v, c), 1.0)
        w = [mk((c, 3 * c)), mk((3 * c,)), mk((3 * c, 5)), mk((3 * c,)),
             mk((c, v)), mk((c,)), mk((c, c)), mk((c,))]
        ln = dict(ln_scale=mk((c,), 0.2) + 1.0, ln_bias=mk((c,), 0.2))
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            args = [x.to(dtype), w[0].to(dtype), *w[1:6], w[6].to(dtype), w[7]]
            for with_ln in (False, True):
                kw = ln if with_ln else {}
                out = hyena_window.hyena_window_mixer(*args, **kw)
                torch.cuda.synchronize()
                ref = hyena_window.hyena_window_plain(*args, **kw)
                err, scale, ok = compare(torch, out, ref, dname)
                del out, ref
                k_ms = median_ms(torch, lambda: hyena_window.hyena_window_mixer(*args, **kw))
                p_ms = median_ms(torch, lambda: hyena_window.hyena_window_plain(*args, **kw))
                print(f"phase 3 K1 BW={bw} V={v} C={c} {dname} ln={with_ln}: "
                      f"max_abs_err={err:.3e} max|out|={scale:.3e} "
                      f"kernel_ms={k_ms:.3f} plain_ms={p_ms:.3f} {'ok' if ok else 'MISMATCH'}",
                      flush=True)
                check(ok, f"K1 disagrees with its plain version at BW={bw} C={c} "
                          f"{dname} ln={with_ln}: {err} > {TOL[dname]} * {scale}")
                results.setdefault((dname, with_ln), []).append((err, k_ms, p_ms))
        del x, w, args
        torch.cuda.empty_cache()
    return results


def phase_k2(torch, fused_mlp, dev):
    """Returns {dtype: [(err, kernel_ms, plain_ms) per stage]}."""
    gen = torch.Generator().manual_seed(2)

    def mk(shape, scale=0.3):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    results = {}
    for c, grid, _ in STAGES:
        n, h = BATCH * grid * grid, 4 * c
        p = [mk((n, c), 1.0), mk((c,), 0.2) + 1.0, mk((c,), 0.2), mk((c, h)),
             mk((h,)), mk((h, c)), mk((c,))]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            args = [p[0].to(dtype), p[1], p[2], p[3].to(dtype), p[4], p[5].to(dtype), p[6]]
            out = fused_mlp.fused_ln_mlp_residual(*args)
            torch.cuda.synchronize()
            ref = fused_mlp.fused_ln_mlp_residual_plain(*args)
            err, scale, ok = compare(torch, out, ref, dname)
            del out, ref
            k_ms = median_ms(torch, lambda: fused_mlp.fused_ln_mlp_residual(*args))
            p_ms = median_ms(torch, lambda: fused_mlp.fused_ln_mlp_residual_plain(*args))
            print(f"phase 4 K2 N={n} C={c} H={h} {dname}: max_abs_err={err:.3e} "
                  f"max|out|={scale:.3e} kernel_ms={k_ms:.3f} plain_ms={p_ms:.3f} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            check(ok, f"K2 disagrees with its plain version at N={n} C={c} {dname}: "
                      f"{err} > {TOL[dname]} * {scale}")
            results.setdefault(dname, []).append((err, k_ms, p_ms))
        del p, args
        torch.cuda.empty_cache()
    return results


def write_dataset(root, shape, n_train=4, n_val=6, n_test=6, seed=0, masks=False,
                  targets=False):
    """Synthetic data laid out as tests/test_e2e.py makes it, plus a split
    CSV: per-subject <id>/<id>_input.npy float32 images (H x W [x C]) or
    volumes (H x W x D) of ``shape`` and x_metadata.csv with alternating
    labels of the 2 classes; with ``masks``, also <id>/<id>_output.npy, an
    H x W mask of the 2 classes (class 1 where the first channel exceeds
    0.5, so that a model can learn it); with ``targets``, an enhancement
    target <id>/<id>_output.npy of ``shape``, the input less some noise."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(seed)
    splits = ["train"] * n_train + ["val"] * n_val + ["test"] * n_test
    ids = [f"subj{i:03d}" for i in range(len(splits))]
    for sid in ids:
        os.makedirs(os.path.join(root, "data", sid))
        image = rng.standard_normal(shape, dtype=np.float32)
        np.save(os.path.join(root, "data", sid, f"{sid}_input.npy"), image)
        if masks:
            np.save(os.path.join(root, "data", sid, f"{sid}_output.npy"),
                    (image.reshape(shape[0], shape[1], -1)[..., 0] > 0.5).astype(np.float32))
        if targets:
            noise = rng.standard_normal(shape, dtype=np.float32)
            np.save(os.path.join(root, "data", sid, f"{sid}_output.npy"), image - 0.3 * noise)
    pd.DataFrame({"SubjectID": ids, "Label": [i % 2 for i in range(len(ids))]}).to_csv(
        os.path.join(root, "data", "x_metadata.csv"), index=False)
    pd.DataFrame({"SubjectID": ids, "Split": splits}).to_csv(
        os.path.join(root, "split.csv"), index=False)
    return {"val": n_val, "test": n_test}


def phase_slice(torch, fused_mlp, hyena_window, tmp):
    import numpy as np

    import run_torch

    sizes = write_dataset(tmp, (1024, 1024))
    expected_batches = sum(min(3, math.ceil(n / BATCH)) for n in sizes.values())
    argv = ptx_flags() + [f"--data_dir={tmp}/data", f"--split_csv_path={tmp}/split.csv",
                        "--device=cuda", "--train_model=False", "--debug",
                        f"--log_dir={tmp}/logs", "--run_name=chip_smoke"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = all_kernels()
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    rc = run_torch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kernel.symbol: kernel.launches for kernel in kernels}
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"run_torch.main returned {rc}")

    run_dir = os.path.join(tmp, "logs", "chip_smoke")
    log = open(os.path.join(run_dir, "run.log")).read()
    timed = re.findall(r"(\w+) forward: (\d+) batches of (\d+) in ([\d.]+) s", log)
    check(len(timed) == 2, f"expected val and test forward lines in run.log, got {timed}")
    batches = sum(int(b) for _, b, _, _ in timed)
    images = sum(int(b) * int(n) for _, b, n, _ in timed)
    seconds = sum(float(s) for _, _, _, s in timed)
    check(batches == expected_batches, f"{batches} forward batches, expected {expected_batches}")
    check_launches(kernels, launches, {0: 12 * batches, 1: 12 * batches},
                   "the eval-only ptx slice")
    metrics = {}
    for split in ("val", "test"):
        path = os.path.join(run_dir, f"{split}_metrics.txt")
        check(os.path.exists(path), f"{path} missing")
        m = dict(line.split(": ") for line in open(path).read().strip().splitlines())
        check(set(m) == {"loss", "acc_1", "auroc", "f1"}, f"{split} metrics {sorted(m)}")
        check(np.isfinite(float(m["loss"])), f"{split} loss {m['loss']} not finite")
        metrics[split] = {k: float(v) for k, v in m.items()}
    print(f"phase 5 slice: run_torch.main eval-only ptx on the card in {wall:.1f} s; "
          f"{batches} forward batches of {BATCH} ({images} images incl. padding) in "
          f"{seconds:.3f} s = {images / seconds:.2f} images/s (first batch included); "
          f"peak memory {peak / 2**30:.2f} GiB; launches {launches}; "
          f"val {metrics['val']}; test {metrics['test']}", flush=True)
    return launches


def phase_model(torch, dev):
    """The full-width ptx model on a 64x64 input: on the card through the
    kernels against the same weights on the host through the plain versions."""
    from torch.func import functional_call

    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import amp_params

    x = torch.randn(2, 1, 64, 64, 1, generator=torch.Generator().manual_seed(3))
    for amp in (False, True):
        argv = ([a for a in ptx_flags() if a != "--use_amp"] + ["--height=64", "--width=64"]
                + (["--use_amp"] if amp else []))
        model = build_model(check_args(parse_config(argv))).eval()
        with torch.no_grad():
            host = functional_call(model.encoder, _enc(amp_params(model, amp)), (x,))
            host_logits = functional_call(model, amp_params(model, amp), (x,))
            model = model.to(dev)
            card = functional_call(model.encoder, _enc(amp_params(model, amp)), (x.to(dev),))
            card_logits = functional_call(model, amp_params(model, amp), (x.to(dev),))
        dname = "bfloat16" if amp else "float32"
        worst = 0.0
        for i, (a, b) in enumerate(zip(card, host)):
            check(a.shape == b.shape, f"hidden state {i}: {a.shape} vs {b.shape}")
            err, scale, ok = compare(torch, a.cpu(), b, dname)
            check(ok, f"model {dname} hidden state {i}: {err} > {TOL[dname]} * {scale}")
            worst = max(worst, err / max(scale, 1e-30))
        # the logits are tanh outputs: held on the scale of their range, 1
        err, scale, ok = compare(torch, card_logits.cpu(), host_logits, dname, min_scale=1.0)
        check(ok and card_logits.shape == (2, 2), f"model {dname} logits: {err} vs {scale}")
        print(f"phase 6 model: full-width ptx Swin-tiny, 64x64 input, {dname}: card vs host "
              f"hidden states max rel err {worst:.3e}, logits max abs err {err:.3e}",
              flush=True)


def _enc(params):
    return {k[len("encoder."):]: v for k, v in params.items() if k.startswith("encoder.")}


def phase_throughput(torch, dev):
    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import amp_params, make_eval_step

    model = build_model(check_args(parse_config(ptx_flags()))).to(dev).eval()
    step = make_eval_step(model, cross_entropy_loss)
    params = amp_params(model, True)
    x = torch.randn(BATCH, 1, 1024, 1024, 1, device=dev)
    y = torch.arange(BATCH, device=dev) % 2
    ms = median_ms(torch, lambda: step(params, x, y, BATCH), warmup=2, reps=5)
    print(f"phase 7 throughput: ptx eval forward, batch {BATCH} of 1024x1024, bf16: "
          f"{ms:.2f} ms/batch = {BATCH * 1000 / ms:.2f} images/s (median of 5)", flush=True)


def compare_grads(torch, grads, refs, dtype_name):
    """(worst abs err, worst err / max|ref|, ok) over a tuple of gradients
    against their references: ok when every gradient is finite, of its
    reference's dtype and shape, and within GRAD_TOL of its max|ref|."""
    worst_abs, worst_rel, ok = 0.0, 0.0, True
    for g, r in zip(grads, refs):
        ok = ok and g.dtype == r.dtype and g.shape == r.shape
        g, r = g.float(), r.float()
        err = (g - r).abs().max().item()
        scale = max(r.abs().max().item(), 1e-30)
        ok = ok and bool(torch.isfinite(g).all().item()) and err <= GRAD_TOL[dtype_name] * scale
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / scale)
    return worst_abs, worst_rel, ok


def phase_k2_bwd(torch, fused_mlp, dev):
    """Returns {dtype: [(err, kernel_ms, plain_ms) per stage]}."""
    gen = torch.Generator().manual_seed(4)

    def mk(shape, scale=0.3):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    results = {}
    for c, grid, _ in STAGES:
        n, h = BATCH * grid * grid, 4 * c
        p = [mk((n, c), 1.0), mk((c,), 0.2) + 1.0, mk((c,), 0.2), mk((c, h)),
             mk((h,)), mk((h, c)), mk((c,))]
        do = mk((n, c), 1.0)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            args = [p[0].to(dtype), p[1], p[2], p[3].to(dtype), p[4], p[5].to(dtype), p[6]]
            d = do.to(dtype)
            got = fused_mlp.fused_ln_mlp_residual_bwd(d, *args)
            torch.cuda.synchronize()
            ref = fused_mlp.fused_ln_mlp_residual_bwd_plain(d, *args)
            err, rel, ok = compare_grads(torch, got, ref, dname)
            del got, ref
            k_ms = median_ms(torch, lambda: fused_mlp.fused_ln_mlp_residual_bwd(d, *args),
                             warmup=1, reps=5)
            p_ms = median_ms(torch, lambda: fused_mlp.fused_ln_mlp_residual_bwd_plain(d, *args),
                             warmup=1, reps=3)
            print(f"phase 8 K2 bwd N={n} C={c} H={h} {dname}: max_abs_err={err:.3e} "
                  f"max_rel_err={rel:.3e} kernel_ms={k_ms:.3f} plain_ms={p_ms:.3f} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            check(ok, f"K2 bwd disagrees with its plain VJP at N={n} C={c} {dname}: "
                      f"{rel} > {GRAD_TOL[dname]}")
            results.setdefault(dname, []).append((err, k_ms, p_ms))
        del p, args, do, d
        torch.cuda.empty_cache()
    return results


def phase_k1_bwd(torch, hyena_window, dev):
    """Returns {(dtype, ln): [(err, kernel_ms, plain_ms) per stage]}."""
    gen = torch.Generator().manual_seed(5)

    def mk(shape, scale=0.3):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    results = {}
    for c, grid, _ in STAGES:
        bw, v = BATCH * (grid // 4) ** 2, 16
        x, do = mk((bw, v, c), 1.0), mk((bw, v, c), 1.0)
        ws, kl = hyena_window.prepare_taps(mk((3 * c, 5)), mk((c, v)), mk((c,)))
        w = [mk((c, 3 * c)), mk((3 * c,)), ws, mk((3 * c,)), kl, mk((c, c)), mk((c,))]
        ln = [mk((c,), 0.2) + 1.0, mk((c,), 0.2)]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            args = [x.to(dtype), w[0].to(dtype), *w[1:5], w[5].to(dtype), w[6]]
            d = do.to(dtype)
            for with_ln in (False, True):
                a = args + (ln if with_ln else [])
                got = hyena_window.hyena_window_bwd(d, *a)
                torch.cuda.synchronize()
                ref = hyena_window.hyena_window_bwd_plain(d, *a)
                err, rel, ok = compare_grads(torch, got, ref, dname)
                del got, ref
                k_ms = median_ms(torch, lambda: hyena_window.hyena_window_bwd(d, *a),
                                 warmup=1, reps=5)
                p_ms = median_ms(torch, lambda: hyena_window.hyena_window_bwd_plain(d, *a),
                                 warmup=1, reps=3)
                print(f"phase 9 K1 bwd BW={bw} V={v} C={c} {dname} ln={with_ln}: "
                      f"max_abs_err={err:.3e} max_rel_err={rel:.3e} kernel_ms={k_ms:.3f} "
                      f"plain_ms={p_ms:.3f} {'ok' if ok else 'MISMATCH'}", flush=True)
                check(ok, f"K1 bwd disagrees with its plain VJP at BW={bw} C={c} {dname} "
                          f"ln={with_ln}: {rel} > {GRAD_TOL[dname]}")
                results.setdefault((dname, with_ln), []).append((err, k_ms, p_ms))
        del x, do, w, args, d
        torch.cuda.empty_cache()
    return results


def phase_train_slice(torch, fused_mlp, hyena_window, tmp):
    """run_torch.main trains ptx on the card (the slice's main path), then an
    inference-only run reloads its best checkpoint."""
    import math

    import numpy as np
    import yaml

    import run_torch

    n_train, epochs = 12, 2
    sizes = write_dataset(tmp, (1024, 1024), n_train=n_train)
    steps = epochs * min(3, math.ceil(n_train / BATCH))          # --debug: 3 per epoch
    val_batches = min(3, math.ceil(sizes["val"] / BATCH))
    eval_batches = epochs * val_batches + val_batches + min(3, math.ceil(sizes["test"] / BATCH))
    run_dir = os.path.join(tmp, "logs", "chip_smoke_train")
    argv = ptx_flags() + [f"--data_dir={tmp}/data", f"--split_csv_path={tmp}/split.csv",
                        "--device=cuda", "--debug", f"--num_epochs={epochs}",
                        f"--log_dir={tmp}/logs", "--run_name=chip_smoke_train"]
    check("--train_model=True" in argv, "the ptx flags no longer train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = all_kernels()
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    rc = run_torch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kernel.symbol: kernel.launches for kernel in kernels}
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"run_torch.main returned {rc}")

    forward = 12 * (steps + eval_batches)
    check_launches(kernels, launches, {0: forward, 1: forward, 2: 12 * steps, 3: 12 * steps},
                   f"the ptx train slice ({steps} train steps, {eval_batches} eval batches)")
    for name in ("model_last_epoch", "model_epoch_0", "model_best_checkpoint"):
        path = os.path.join(run_dir, "models", name)
        check(os.path.exists(os.path.join(path, "state.pt")), f"{path} missing")
    meta = yaml.safe_load(open(os.path.join(run_dir, "models", "model_last_epoch", "meta.yaml")))
    check(meta["step"] == steps and meta["epoch"] == epochs - 1,
          f"model_last_epoch meta: step {meta['step']} epoch {meta['epoch']}, "
          f"expected {steps}, {epochs - 1}")
    log = open(os.path.join(run_dir, "run.log")).read()
    trained = re.findall(r"epoch (\d+) train: (\d+) steps, (\d+) samples in ([\d.]+) s", log)
    check(len(trained) == epochs, f"expected {epochs} train epoch lines, got {trained}")
    losses = [float(v) for v in re.findall(r"train: \{'loss': ([-\d.e+naninf]+)", log)]
    check(len(losses) == epochs and all(np.isfinite(losses)), f"train losses {losses}")
    metrics = {}
    for split in ("val", "test"):
        path = os.path.join(run_dir, f"{split}_metrics.txt")
        check(os.path.exists(path), f"{path} missing")
        m = dict(line.split(": ") for line in open(path).read().strip().splitlines())
        check(np.isfinite(float(m["loss"])), f"{split} loss {m['loss']} not finite")
        metrics[split] = {k: float(v) for k, v in m.items()}
    train_images = sum(int(n) for _, _, n, _ in trained)
    train_seconds = sum(float(sec) for _, _, _, sec in trained)
    print(f"phase 10 train slice: run_torch.main ptx training on the card in {wall:.1f} s; "
          f"{steps} train steps over {epochs} epochs, {train_images} images in "
          f"{train_seconds:.3f} s = {train_images / train_seconds:.2f} images/s (first steps "
          f"and loading included); train losses {losses}; peak memory {peak / 2**30:.2f} GiB; "
          f"launches {launches}; val {metrics['val']}; test {metrics['test']}", flush=True)

    rc = run_torch.main(["--inference_only=True", f"--inference_dir={run_dir}",
                         f"--inference_log_dir={tmp}/logs",
                         "--inference_run_name=chip_smoke_inference"])
    check(rc == 0, f"inference-only run returned {rc}")
    path = os.path.join(tmp, "logs", "chip_smoke_inference", "test_metrics.txt")
    check(os.path.exists(path), f"{path} missing")
    print(f"phase 10 inference-only: reloaded {run_dir}/models/model_best_checkpoint; "
          f"test {open(path).read().strip().splitlines()}", flush=True)
    return launches


def phase_model_grads(torch, dev):
    """One train step's gradients of the full-width ptx model on a 64x64
    input: on the card (kernels) against the same weights on the host (plain
    versions)."""
    from torch.func import functional_call

    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import amp_params

    x = torch.randn(2, 1, 64, 64, 1, generator=torch.Generator().manual_seed(6))
    y = torch.tensor([0, 1])

    def grads(model, device):
        model.zero_grad(set_to_none=True)
        out = functional_call(model, amp_params(model, amp), (x.to(device),)).float()
        cross_entropy_loss(out, y.to(device)).backward()
        return {k: p.grad.detach().cpu() for k, p in model.named_parameters()}

    for amp in (False, True):
        argv = ([a for a in ptx_flags() if a != "--use_amp"] + ["--height=64", "--width=64"]
                + (["--use_amp"] if amp else []))
        model = build_model(check_args(parse_config(argv)))
        host = grads(model, "cpu")
        card = grads(model.to(dev), dev)
        dname = "bfloat16" if amp else "float32"
        worst, worst_name = 0.0, ""
        for name, g in card.items():
            check(bool(torch.isfinite(g).all()), f"{dname}: gradient of {name} not finite")
            check(g.abs().max().item() > 0, f"{dname}: gradient of {name} is all zero")
            rel = (g - host[name]).abs().max().item() / max(host[name].abs().max().item(), 1e-30)
            if rel > worst:
                worst, worst_name = rel, name
        print(f"phase 11 model gradients: full-width ptx Swin-tiny, 64x64 input, {dname}: "
              f"{len(card)} parameters, every card gradient finite and non-zero; card vs host "
              f"worst max|err| / max|host grad| {worst:.3e} ({worst_name})", flush=True)
        check(worst <= MODEL_GRAD_TOL[dname],
              f"{dname} model gradients: {worst_name} off by {worst} of its max")


def phase_train_throughput(torch, dev):
    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.metrics.device import make_train_metric_fn
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.optim import OptimManager
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import make_train_step

    cfg = check_args(parse_config(ptx_flags()))
    model = build_model(cfg).to(dev)
    optim = OptimManager(cfg, num_train_samples=1000)
    optim.build(model.parameters())
    _, metrics_fn = make_train_metric_fn(cfg)
    step = make_train_step(model, cross_entropy_loss, optim, use_amp=True, metrics_fn=metrics_fn)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(BATCH, 1, 1024, 1024, 1, generator=gen).to(dev)
    y = (torch.arange(BATCH) % 2).to(dev)
    lr = cfg.optim.lr
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(torch, lambda: step([(x, y)], lr, BATCH), warmup=2, reps=5)
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 12 train throughput: ptx train step (forward, backward, Adam), batch {BATCH} "
          f"of 1024x1024, bf16: {ms:.2f} ms/step = {BATCH * 1000 / ms:.2f} images/s (median of "
          f"5 after 2 warm-ups); peak memory {peak / 2**30:.2f} GiB", flush=True)

    profile_step(torch, lambda: step([(x, y)], lr, BATCH), "phase 12 profile")

    stats = [step([(x, y)], 10 * lr, BATCH) for _ in range(10)]
    losses = [float(s[0]) for s in stats]
    print(f"phase 12 fixed batch: 10 Adam steps at lr {10 * lr:g}: loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}", flush=True)
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"10 steps on one batch did not lower the loss: {losses}")
    return ms


def phase_k3(torch, hyena_window, dev):
    """K3 forward, backward (without dM) and dM against their plain versions
    at the emb K3 stage shapes, fp32 and bf16, with the folded LN. Returns
    {dtype: {"fwd" | "bwd" | "dm": [(err, kernel_ms, plain_ms) per stage]}};
    the backward's error covers every gradient, dM included."""
    hw = hyena_window
    gen = torch.Generator().manual_seed(8)

    def mk(shape, scale=0.3):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    results = {}
    for c, bw, _ in EMB_K3_STAGES:
        v = 512
        chunk = hw.pick_chunk(v)
        x, do = mk((bw, v, c), 1.0), mk((bw, v, c), 1.0)
        ws, kl = hw.prepare_taps(mk((3 * c, 5)), mk((c, v), 0.1), mk((c,)))
        m32 = hw.build_chunk_toeplitz(kl, chunk)
        w = [mk((c, 3 * c)), mk((3 * c,)), ws, mk((3 * c,)), None, mk((c, c)), mk((c,)),
             mk((c,), 0.2) + 1.0, mk((c,), 0.2)]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            args = [x.to(dtype), w[0].to(dtype), w[1], w[2], w[3], m32.to(dtype),
                    w[5].to(dtype), w[6], w[7], w[8]]
            d = do.to(dtype)
            res = results.setdefault(dname, {"fwd": [], "bwd": [], "dm": []})
            with torch.no_grad():
                out = hw.hyena_chunked_fwd(*args)
                torch.cuda.synchronize()
                ref = hw.hyena_chunked_plain(*args)
                err, scale, ok = compare(torch, out, ref, dname)
                del out, ref
                check(ok, f"K3 fwd disagrees with its plain version at BW={bw} C={c} {dname}: "
                          f"{err} > {TOL[dname]} * {scale}")
                k_ms = median_ms(torch, lambda: hw.hyena_chunked_fwd(*args), warmup=1, reps=5)
                p_ms = median_ms(torch, lambda: hw.hyena_chunked_plain(*args), warmup=1, reps=3)
            res["fwd"].append((err, k_ms, p_ms))
            print(f"phase 13 K3 fwd BW={bw} V={v} C={c} {dname}: max_abs_err={err:.3e} "
                  f"max|out|={scale:.3e} kernel_ms={k_ms:.3f} plain_ms={p_ms:.3f} ok", flush=True)

            got = hw.hyena_chunked_bwd(d, *args)
            torch.cuda.synchronize()
            ref = hw.hyena_chunked_bwd_plain(d, *args)
            err, rel, ok = compare_grads(torch, got, ref, dname)
            del got, ref
            check(ok, f"K3 bwd disagrees with its plain VJP at BW={bw} C={c} {dname}: "
                      f"{rel} > {GRAD_TOL[dname]}")
            k_ms = median_ms(torch, lambda: hw.hyena_chunked_bwd_streams(d, *args), warmup=1,
                             reps=5)
            p_ms = median_ms(torch, lambda: hw.hyena_chunked_bwd_plain(d, *args), warmup=1,
                             reps=3)
            res["bwd"].append((err, k_ms, p_ms))
            print(f"phase 13 K3 bwd BW={bw} V={v} C={c} {dname}: max_abs_err={err:.3e} "
                  f"max_rel_err={rel:.3e} kernel_ms={k_ms:.3f} (without dM) plain_ms={p_ms:.3f} "
                  f"(the whole VJP) ok", flush=True)

            _, (gs, dvl) = hw.hyena_chunked_bwd_streams(d, *args)
            with torch.no_grad():
                got = hw.hyena_dm(gs, dvl, chunk)
                torch.cuda.synchronize()
                ref = hw.hyena_dm_plain(gs, dvl, chunk)
                err, scale, ok = compare(torch, got, ref, dname)
                check(ok, f"K3 dM disagrees with its plain version at BW={bw} C={c} {dname}: "
                          f"{err} > {TOL[dname]} * {scale}")
                k_ms = median_ms(torch, lambda: hw.hyena_dm(gs, dvl, chunk), warmup=1, reps=5)
                p_ms = median_ms(torch, lambda: hw.hyena_dm_plain(gs, dvl, chunk), warmup=1,
                                 reps=3)
            res["dm"].append((err, k_ms, p_ms))
            print(f"phase 13 K3 dM BW={bw} V={v} C={c} {dname}: max_abs_err={err:.3e} "
                  f"max|dM|={scale:.3e} kernel_ms={k_ms:.3f} plain_ms={p_ms:.3f} ok", flush=True)
            del got, ref, gs, dvl, args, d
            torch.cuda.empty_cache()
        del x, do, w, m32
        torch.cuda.empty_cache()
    return results


def phase_emb_slice(torch, fused_mlp, hyena_window, tmp):
    """run_torch.main trains emb on the card (this slice's main path), then an
    inference-only run reloads its best checkpoint."""
    import numpy as np
    import yaml

    import run_torch

    n_train, n_val, n_test, epochs = 8, 4, 4, 2
    write_dataset(tmp, (256, 256, 64), n_train, n_val, n_test)
    steps = epochs * min(3, math.ceil(n_train / BATCH))          # --debug: 3 per epoch
    val_batches = min(3, math.ceil(n_val / BATCH))
    test_batches = min(3, math.ceil(n_test / BATCH))
    eval_batches = epochs * val_batches + val_batches + test_batches
    run_dir = os.path.join(tmp, "logs", "chip_smoke_emb")
    argv = emb_flags() + [f"--data_dir={tmp}/data", f"--split_csv_path={tmp}/split.csv",
                          "--device=cuda", "--debug", f"--num_epochs={epochs}",
                          f"--log_dir={tmp}/logs", "--run_name=chip_smoke_emb"]
    check("--train_model=True" in argv and "--time=64" in argv, "the emb flags changed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = all_kernels()
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    rc = run_torch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kernel.symbol: kernel.launches for kernel in kernels}
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"run_torch.main returned {rc}")
    forward = steps + eval_batches
    check_launches(kernels, launches, {1: 12 * forward, 3: 12 * steps, 4: 4 * forward,
                                       5: 4 * steps, 6: 4 * steps},
                   f"the emb train slice ({steps} train steps, {eval_batches} eval batches)")
    for name in ("model_last_epoch", "model_epoch_0", "model_best_checkpoint"):
        path = os.path.join(run_dir, "models", name)
        check(os.path.exists(os.path.join(path, "state.pt")), f"{path} missing")
    meta = yaml.safe_load(open(os.path.join(run_dir, "models", "model_last_epoch", "meta.yaml")))
    check(meta["step"] == steps and meta["epoch"] == epochs - 1,
          f"model_last_epoch meta: step {meta['step']} epoch {meta['epoch']}")
    log = open(os.path.join(run_dir, "run.log")).read()
    trained = re.findall(r"epoch (\d+) train: (\d+) steps, (\d+) samples in ([\d.]+) s", log)
    check(len(trained) == epochs, f"expected {epochs} train epoch lines, got {trained}")
    losses = [float(v) for v in re.findall(r"train: \{'loss': ([-\d.e+naninf]+)", log)]
    check(len(losses) == epochs and all(np.isfinite(losses)), f"train losses {losses}")
    metrics = {}
    for split in ("val", "test"):
        path = os.path.join(run_dir, f"{split}_metrics.txt")
        check(os.path.exists(path), f"{path} missing")
        m = dict(line.split(": ") for line in open(path).read().strip().splitlines())
        check(set(m) == {"loss", "acc_1", "auroc", "f1"} and np.isfinite(float(m["loss"])),
              f"{split} metrics {m}")
        metrics[split] = {k: float(v) for k, v in m.items()}
    train_images = sum(int(n) for _, _, n, _ in trained)
    train_seconds = sum(float(sec) for _, _, _, sec in trained)
    print(f"phase 14 emb train slice: run_torch.main emb training on the card in {wall:.1f} s; "
          f"{steps} train steps over {epochs} epochs, {train_images} volumes in "
          f"{train_seconds:.3f} s = {train_images / train_seconds:.3f} volumes/s (first steps "
          f"and loading included); train losses {losses}; peak memory {peak / 2**30:.2f} GiB; "
          f"launches {launches}; val {metrics['val']}; test {metrics['test']}", flush=True)

    for kernel in kernels:
        kernel.launches = 0
    rc = run_torch.main(["--inference_only=True", f"--inference_dir={run_dir}",
                         f"--inference_log_dir={tmp}/logs",
                         "--inference_run_name=chip_smoke_emb_inference"])
    check(rc == 0, f"inference-only run returned {rc}")
    inference = {kernel.symbol: kernel.launches for kernel in kernels}
    batches = val_batches + test_batches
    check_launches(kernels, inference, {1: 12 * batches, 4: 4 * batches},
                   "the emb inference-only run")
    path = os.path.join(tmp, "logs", "chip_smoke_emb_inference", "test_metrics.txt")
    check(os.path.exists(path), f"{path} missing")
    test = {k: float(v) for k, v in (ln.split(": ") for ln in open(path).read().split("\n") if ln)}
    check(test == metrics["test"], f"inference-only test metrics {test} != {metrics['test']}")
    print(f"phase 14 inference-only: reloaded {run_dir}/models/model_best_checkpoint; "
          f"test {test} (the training run's own); launches {inference}", flush=True)
    return launches


def phase_emb_grads(torch, dev, seeds=EMB_GRAD_SEEDS):
    """One train step's gradients of the full-width emb model on a
    32x128x128 volume (windows of 512 / 512 / 256 / 128 tokens: K3 at C = 96
    and 192, the composed path at C = 384 and 768, as emb routes them), with
    weights and volume from each seed: on the card (kernels) against the host
    (plain versions), fp32 on the first seed and bf16 on every seed. The card's
    fp32 gradients are the reference of each seed's bf16 ones: the card's bf16
    gradients may stray from them at most BF16_GRAD_RATIO times as far as the
    host's. Errors are per parameter, max|err| / max|reference|, worst over
    the parameters. Returns {seed: (card vs host, card vs fp32, host vs
    fp32)} of the bf16 runs."""
    from torch.func import functional_call

    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import amp_params

    y = torch.tensor([0, 1])
    argv = ([a for a in emb_flags() if a != "--use_amp"]
            + ["--height=128", "--width=128", "--time=32"])

    def grads(model, x, amp, device):
        model.to(device).zero_grad(set_to_none=True)
        out = functional_call(model, amp_params(model, amp), (x.to(device),)).float()
        cross_entropy_loss(out, y.to(device)).backward()
        return {k: p.grad.detach().cpu() for k, p in model.named_parameters()}

    def worst(got, ref, dname):
        err, at = 0.0, ""
        for name, g in got.items():
            check(bool(torch.isfinite(g).all()), f"{dname}: gradient of {name} not finite")
            check(g.abs().max().item() > 0, f"{dname}: gradient of {name} is all zero")
            rel = (g - ref[name]).abs().max().item() / max(ref[name].abs().max().item(), 1e-30)
            if rel > err:
                err, at = rel, name
        return err, at

    readings = {}
    for seed in seeds:
        model = build_model(check_args(parse_config(argv + [f"--seed={seed}"])))
        amp_model = build_model(check_args(parse_config(argv + [f"--seed={seed}", "--use_amp"])))
        amp_model.load_state_dict(model.state_dict())
        x = torch.randn(2, 32, 128, 128, 1, generator=torch.Generator().manual_seed(seed))
        host32 = grads(model, x, False, "cpu") if seed == seeds[0] else None
        host16 = grads(amp_model, x, True, "cpu")
        card32 = grads(model, x, False, dev)
        card16 = grads(amp_model, x, True, dev)
        if host32 is not None:
            err, at = worst(card32, host32, "float32")
            print(f"phase 15 emb model gradients: full-width emb Swin-tiny, 32x128x128 volume, "
                  f"float32, seed {seed}: {len(card32)} parameters, every card gradient finite "
                  f"and non-zero; card vs host worst max|err| / max|host grad| {err:.3e} ({at})",
                  flush=True)
            check(err <= MODEL_GRAD_TOL["float32"],
                  f"float32 emb model gradients, seed {seed}: {at} off by {err} of its max")
        vs_host, at = worst(card16, host16, "bfloat16")
        card_err, card_at = worst(card16, card32, "bfloat16")
        host_err, host_at = worst(host16, card32, "bfloat16")
        print(f"phase 15 emb model gradients: full-width emb Swin-tiny, 32x128x128 volume, "
              f"bfloat16, seed {seed}: {len(card16)} parameters, every card gradient finite and "
              f"non-zero; worst max|err| / max|reference grad|: card vs host {vs_host:.3e} ({at}); "
              f"against the fp32 gradients, card {card_err:.3e} ({card_at}), host {host_err:.3e} "
              f"({host_at})", flush=True)
        check(vs_host <= MODEL_GRAD_TOL["bfloat16"],
              f"bfloat16 emb model gradients, seed {seed}: {at} off by {vs_host} of its max")
        check(card_err <= BF16_GRAD_RATIO * host_err,
              f"bfloat16 emb model gradients, seed {seed}: the card strays {card_err} from fp32 "
              f"({card_at}), more than {BF16_GRAD_RATIO} x the host's {host_err}")
        readings[seed] = (vs_host, card_err, host_err)
        del model, amp_model, host16, card16, card32
    spread = {label: (min(r[i] for r in readings.values()), max(r[i] for r in readings.values()))
              for i, label in enumerate(("card vs host", "card vs fp32", "host vs fp32"))}
    print(f"phase 15 emb model gradients, bf16 over seeds {list(readings)}: worst max|err| / "
          f"max|reference grad| " + "; ".join(f"{k} {lo:.3e} to {hi:.3e}"
                                                for k, (lo, hi) in spread.items()), flush=True)
    return readings


def phase_emb_throughput(torch, dev):
    """The emb train step and eval forward at batch 4 on 256x256x64, bf16."""
    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.metrics.device import make_train_metric_fn
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.optim import OptimManager
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import (amp_params, make_eval_step,
                                                                   make_train_step)

    cfg = check_args(parse_config(emb_flags()))
    model = build_model(cfg).to(dev)
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(BATCH, 64, 256, 256, 1, generator=gen).to(dev)
    y = (torch.arange(BATCH) % 2).to(dev)
    step = make_eval_step(model.eval(), cross_entropy_loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eval_ms = median_ms(torch, lambda: step(amp_params(model, True), x, y, BATCH), warmup=2,
                        reps=5)
    eval_peak = torch.cuda.max_memory_allocated()
    print(f"phase 16 emb eval forward, batch {BATCH} of 256x256x64, bf16: {eval_ms:.2f} ms/batch "
          f"= {BATCH * 1000 / eval_ms:.3f} volumes/s (median of 5); peak memory "
          f"{eval_peak / 2**30:.2f} GiB", flush=True)

    model.train()
    optim = OptimManager(cfg, num_train_samples=1000)
    optim.build(model.parameters())
    _, metrics_fn = make_train_metric_fn(cfg)
    train = make_train_step(model, cross_entropy_loss, optim, use_amp=True, metrics_fn=metrics_fn)
    lr = cfg.optim.lr
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(torch, lambda: train([(x, y)], lr, BATCH), warmup=2, reps=5)
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 16 emb train step (forward, backward, Adam), batch {BATCH} of 256x256x64, bf16: "
          f"{ms:.2f} ms/step = {BATCH * 1000 / ms:.3f} volumes/s (median of 5 after 2 warm-ups); "
          f"peak memory {peak / 2**30:.2f} GiB", flush=True)
    profile_step(torch, lambda: train([(x, y)], lr, BATCH), "phase 16 emb profile")
    return ms, eval_ms


def phase_k4(torch, mamba_window, dev):
    """K4 forward and backward against their plain versions at the vessel K4
    stage shapes, fp32 and bf16, with the folded LN, on operands drawn as the
    model initialises them. Returns {dtype: {"fwd" | "bwd": [(err,
    kernel_ms, plain_ms) per stage]}}; the backward's error covers every
    gradient."""
    mw = mamba_window
    gen = torch.Generator().manual_seed(13)
    n = mw.MAMBA_KERNEL_STATE

    def mk(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    results = {}
    for c, bw, _ in VESSEL_K4_STAGES:
        v, dh, r = 64, c // 2, -(-c // 16)
        x, do = mk((bw, v, c), 1.0), mk((bw, v, c), 1.0)
        # dt_bias: the inverse softplus of a log-uniform dt in [1e-3, 0.1];
        # A = -(1..N) per channel; D = 1 (models/mamba.py init_params)
        dt = torch.exp(torch.rand(dh, generator=gen) * math.log(100.0) + math.log(1e-3))
        raw = (mk((dh, 3), 0.5), mk((dh, 3), 0.5), (dt + torch.log(-torch.expm1(-dt))).to(dev),
               -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(dh, n),
               torch.ones(dh, device=dev))
        wconv, dtb2, at, dskip = mw.prepare_operands(*raw)
        w = [mk((c, c), c ** -0.5), mk((dh, r + 2 * n), dh ** -0.5), mk((r, dh), r ** -0.5),
             mk((c, c), c ** -0.5)]
        ln = [mk((c,), 0.2) + 1.0, mk((c,), 0.2)]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            args = [x.to(dtype), w[0].to(dtype), wconv, w[1].to(dtype), w[2].to(dtype), dtb2, at,
                    dskip, w[3].to(dtype)] + ln
            d = do.to(dtype)
            res = results.setdefault(dname, {"fwd": [], "bwd": []})
            with torch.no_grad():
                out = mw.mamba_window_fwd(*args)
                torch.cuda.synchronize()
                ref = mw.mamba_window_plain(*args)
                err, scale, ok = compare(torch, out, ref, dname)
                del out, ref
                check(ok, f"K4 fwd disagrees with its plain version at BW={bw} C={c} {dname}: "
                          f"{err} > {TOL[dname]} * {scale}")
                k_ms = median_ms(torch, lambda: mw.mamba_window_fwd(*args), warmup=1, reps=5)
                p_ms = median_ms(torch, lambda: mw.mamba_window_plain(*args), warmup=1, reps=3)
            res["fwd"].append((err, k_ms, p_ms))
            print(f"phase 17 K4 fwd BW={bw} V={v} C={c} {dname}: max_abs_err={err:.3e} "
                  f"max|out|={scale:.3e} kernel_ms={k_ms:.3f} plain_ms={p_ms:.3f} ok", flush=True)

            got = mw.mamba_window_bwd(d, *args)
            torch.cuda.synchronize()
            ref = mw.mamba_window_bwd_plain(d, *args)
            err, rel, ok = compare_grads(torch, got, ref, dname)
            del got, ref
            check(ok, f"K4 bwd disagrees with its plain VJP at BW={bw} C={c} {dname}: "
                      f"{rel} > {GRAD_TOL[dname]}")
            k_ms = median_ms(torch, lambda: mw.mamba_window_bwd(d, *args), warmup=1, reps=5)
            p_ms = median_ms(torch, lambda: mw.mamba_window_bwd_plain(d, *args), warmup=1, reps=3)
            res["bwd"].append((err, k_ms, p_ms))
            print(f"phase 17 K4 bwd BW={bw} V={v} C={c} {dname}: max_abs_err={err:.3e} "
                  f"max_rel_err={rel:.3e} kernel_ms={k_ms:.3f} plain_ms={p_ms:.3f} ok", flush=True)
            del args, d
            torch.cuda.empty_cache()
        del x, do, w, ln
        torch.cuda.empty_cache()
    return results


def phase_vessel_slice(torch, tmp):
    """run_torch.main trains vessel on the card (this slice's main path),
    then an inference-only run reloads its best checkpoint."""
    import numpy as np
    import yaml

    import run_torch

    n_train, n_val, n_test, epochs = 8, 4, 4, 2
    write_dataset(tmp, (1024, 1024, 3), n_train, n_val, n_test, masks=True)
    steps = epochs * min(3, math.ceil(n_train / BATCH))          # --debug: 3 per epoch
    val_batches = min(3, math.ceil(n_val / BATCH))
    test_batches = min(3, math.ceil(n_test / BATCH))
    eval_batches = epochs * val_batches + val_batches + test_batches
    run_dir = os.path.join(tmp, "logs", "chip_smoke_vessel")
    argv = vessel_flags() + [f"--data_dir={tmp}/data", f"--split_csv_path={tmp}/split.csv",
                             "--device=cuda", "--debug", f"--num_epochs={epochs}",
                             f"--log_dir={tmp}/logs", "--run_name=chip_smoke_vessel"]
    check("--train_model=True" in argv and "--decoder_name=UperNet2D" in argv,
          "the vessel flags changed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = all_kernels()
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    rc = run_torch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kernel.symbol: kernel.launches for kernel in kernels}
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"run_torch.main returned {rc}")
    forward = steps + eval_batches
    k4 = VESSEL_K4_BLOCKS
    check_launches(kernels, launches, {1: 12 * forward, 3: 12 * steps, 7: k4 * forward,
                                       8: k4 * steps},
                   f"the vessel train slice ({steps} train steps, {eval_batches} eval batches)")
    for name in ("model_last_epoch", "model_epoch_0", "model_best_checkpoint"):
        path = os.path.join(run_dir, "models", name)
        check(os.path.exists(os.path.join(path, "state.pt")), f"{path} missing")
    meta = yaml.safe_load(open(os.path.join(run_dir, "models", "model_last_epoch", "meta.yaml")))
    check(meta["step"] == steps and meta["epoch"] == epochs - 1,
          f"model_last_epoch meta: step {meta['step']} epoch {meta['epoch']}")
    log = open(os.path.join(run_dir, "run.log")).read()
    trained = re.findall(r"epoch (\d+) train: (\d+) steps, (\d+) samples in ([\d.]+) s", log)
    check(len(trained) == epochs, f"expected {epochs} train epoch lines, got {trained}")
    losses = [float(v) for v in re.findall(r"train: \{'loss': ([-\d.e+naninf]+)", log)]
    check(len(losses) == epochs and all(np.isfinite(losses)), f"train losses {losses}")
    metrics = {}
    for split in ("val", "test"):
        path = os.path.join(run_dir, f"{split}_metrics.txt")
        check(os.path.exists(path), f"{path} missing")
        m = {k: float(v) for k, v in (ln.split(": ") for ln in open(path).read().split("\n") if ln)}
        check(set(m) == {"loss", "f1"} and np.isfinite(m["loss"]) and 0.0 <= m["f1"] <= 1.0,
              f"{split} metrics {m}")
        metrics[split] = m
    train_images = sum(int(n) for _, _, n, _ in trained)
    train_seconds = sum(float(sec) for _, _, _, sec in trained)
    print(f"phase 18 vessel train slice: run_torch.main vessel training on the card in "
          f"{wall:.1f} s; {steps} train steps over {epochs} epochs, {train_images} images in "
          f"{train_seconds:.3f} s = {train_images / train_seconds:.3f} images/s (first steps "
          f"and loading included); train losses {losses}; peak memory {peak / 2**30:.2f} GiB; "
          f"launches {launches}; val {metrics['val']}; test {metrics['test']}", flush=True)

    for kernel in kernels:
        kernel.launches = 0
    rc = run_torch.main(["--inference_only=True", f"--inference_dir={run_dir}",
                         f"--inference_log_dir={tmp}/logs",
                         "--inference_run_name=chip_smoke_vessel_inference"])
    check(rc == 0, f"inference-only run returned {rc}")
    inference = {kernel.symbol: kernel.launches for kernel in kernels}
    batches = val_batches + test_batches
    check_launches(kernels, inference, {1: 12 * batches, 7: k4 * batches},
                   "the vessel inference-only run")
    inf_dir = os.path.join(tmp, "logs", "chip_smoke_vessel_inference")
    path = os.path.join(inf_dir, "test_metrics.txt")
    check(os.path.exists(path), f"{path} missing")
    test = {k: float(v) for k, v in (ln.split(": ") for ln in open(path).read().split("\n") if ln)}
    check(test == metrics["test"], f"inference-only test metrics {test} != {metrics['test']}")
    saved = sorted(os.listdir(os.path.join(inf_dir, "saved_samples", "test")))
    check(len(saved) == n_test and all(f.endswith("_output.npy") for f in saved),
          f"saved test predictions {saved}")
    pred = np.load(os.path.join(inf_dir, "saved_samples", "test", saved[0]))
    check(pred.shape == (1, 1024, 1024) and set(np.unique(pred)) <= {0.0, 1.0},
          f"a saved prediction has shape {pred.shape} and values {np.unique(pred)[:5]}")
    print(f"phase 18 inference-only: reloaded {run_dir}/models/model_best_checkpoint; "
          f"test {test} (the training run's own); {len(saved)} masks of {pred.shape} saved; "
          f"launches {inference}", flush=True)
    return launches


def _no_dropout(model):
    """Dropout off (UperNet's PSP dropout): the card and the host draw
    different masks."""
    from torch import nn

    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    return model


def phase_vessel_grads(torch, dev, seed=20, flags=None, channels=3, enhance=False, phase=19,
                       name="vessel", path_kernels=None):
    """One train step's gradients of the full-width vessel model on 512x512x3
    images at batch 4 (windows of 64 tokens: K4 at stages 0-1, 4096 and 1024
    windows; the composed scan at stages 2-3, 256 and 64 windows), BatchNorm
    on batch statistics and dropout off, weights and images from one seed: on
    the card (kernels) against the host (plain versions), fp32 and bf16.
    Errors are per parameter, max|err| / max|reference|. Another UperNet2D
    configuration runs the same check with its ``flags``, its images'
    ``channels`` and, with ``enhance``, enhancement targets and
    CombinationEnhance (micro_w7, phase 39); path_kernels: {index in
    all_kernels(): launches per gradient on the card}.

    fp32: every parameter within VESSEL_GRAD_TOL, and every encoder
    parameter (where K4 runs) within VESSEL_ENCODER_GRAD_TOL. This model's
    gradients are sensitive to rounding: on the host, fp32 moves them by up
    to 1.5e-2 of max from a float64 run, most in PSP's convolutions and
    BatchNorm biases (PERF.md); a train-mode BatchNorm also removes each
    channel's mean from the gradient it passes back, so what feeds it a
    per-channel constant gets small sums of large terms. The encoder reads
    far less, so it gets a limit of its own that a wrong K4 gradient exceeds.
    bf16 (AMP): the card's fp32 gradients are the reference; each
    parameter's bf16 gradient on the card may stray from it at most
    BF16_GRAD_RATIO times as far as the host's bf16 gradient of that
    parameter, plus VESSEL_BF16_GRAD_FLOOR of its max (bf16 moves this
    model's gradients by up to 0.35 of max on either side, so a card-host
    limit on bf16 would measure rounding).

    The images differ in scale and offset: PSP's bin-1 BatchNorm normalises
    4 pooled values per channel with the fast variance E[x^2] - E[x]^2, and
    on iid images those nearly agree (E[x^2] / var 1.2e5 at this seed), so
    fp32 rounding of the variance alone moves gradients by 1e-2 of max;
    spread images keep the ratio near 100.

    Returns the per-parameter errors: fp32 card vs host, and bf16 card and
    host against the card's fp32."""
    from torch.func import functional_call

    from long_context_biomedical_imaging_tpu_torch.losses import get_loss_func
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import amp_params

    argv = ([a for a in (flags or vessel_flags()) if a != "--use_amp"]
            + ["--height=512", "--width=512", f"--seed={seed}"])
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(BATCH, 1, 512, 512, channels, generator=gen)
    x = (x * torch.tensor([0.5, 1.0, 1.5, 2.0]).view(BATCH, 1, 1, 1, 1)
         + torch.tensor([-1.0, -0.3, 0.3, 1.0]).view(BATCH, 1, 1, 1, 1))
    if enhance:
        y = x - 0.3 * torch.randn(x.shape, generator=gen)
    else:
        y = (x[..., 0] > 0.5).long()
    loss_func = get_loss_func(check_args(parse_config(argv)).loss_func)
    kernels = [all_kernels()[i] for i in (path_kernels or {})]

    def grads(model, amp, device):
        model.to(device).train().zero_grad(set_to_none=True)
        before = [k.launches for k in kernels]
        out = functional_call(model, amp_params(model, amp), (x.to(device),)).float()
        loss_func(out, y.to(device)).backward()
        ran = [k.launches - b for k, b in zip(kernels, before)]
        want = list(path_kernels.values()) if path_kernels and device != "cpu" else [0] * len(
            kernels)
        check(ran == want, f"{name} kernel launches {ran} on {device}, expected {want}")
        return {k: p.grad.detach().cpu() for k, p in model.named_parameters()}

    def errors(got, ref, dname):
        errs = {}
        for pname, g in got.items():
            check(bool(torch.isfinite(g).all()), f"{dname}: gradient of {pname} not finite")
            check(g.abs().max().item() > 0, f"{dname}: gradient of {pname} is all zero")
            errs[pname] = ((g - ref[pname]).abs().max().item()
                           / max(ref[pname].abs().max().item(), 1e-30))
        return errs

    def worst(errs, prefix=""):
        at = max((k for k in errs if k.startswith(prefix)), key=errs.get)
        return errs[at], at

    model = _no_dropout(build_model(check_args(parse_config(argv))))
    amp_model = _no_dropout(build_model(check_args(parse_config(argv + ["--use_amp"]))))
    amp_model.load_state_dict(model.state_dict())
    host32 = grads(model, False, "cpu")
    host16 = grads(amp_model, True, "cpu")
    card32 = grads(model, False, dev)
    card16 = grads(amp_model, True, dev)
    e32 = errors(card32, host32, "float32")
    err, at = worst(e32)
    enc, enc_at = worst(e32, "encoder.")
    print(f"phase {phase} {name} model gradients: full-width {name} Swin-tiny + Mamba + "
          f"UperNet2D, batch {BATCH} of 512x512x{channels}, float32, seed {seed}: {len(card32)} "
          f"parameters, every card gradient finite and non-zero; card vs host worst max|err| / "
          f"max|host grad| {err:.3e} ({at}), encoder {enc:.3e} ({enc_at})", flush=True)
    check(err <= VESSEL_GRAD_TOL, f"float32 {name} model gradients: {at} off by {err} of its max")
    check(enc <= VESSEL_ENCODER_GRAD_TOL,
          f"float32 {name} encoder gradients: {enc_at} off by {enc} of its max")
    card_e = errors(card16, card32, "bfloat16")
    host_e = errors(host16, card32, "bfloat16 host")
    limit = {k: BF16_GRAD_RATIO * host_e[k] + VESSEL_BF16_GRAD_FLOOR for k in card_e}
    tight = max(card_e, key=lambda k: card_e[k] / limit[k])
    ratio = max(card_e, key=lambda k: card_e[k] / max(host_e[k], 1e-30))
    print(f"phase {phase} {name} model gradients, bfloat16: every card gradient finite and "
          f"non-zero; "
          f"max|err| / max|fp32 card grad|, worst: card {worst(card_e)[0]:.3e} "
          f"({worst(card_e)[1]}), host {worst(host_e)[0]:.3e} ({worst(host_e)[1]}); per "
          f"parameter, nearest its limit {tight}: card {card_e[tight]:.3e}, host "
          f"{host_e[tight]:.3e}, limit {limit[tight]:.3e}; largest card/host ratio {ratio}: "
          f"{card_e[ratio]:.3e} / {host_e[ratio]:.3e}", flush=True)
    check(card_e[tight] <= limit[tight],
          f"bfloat16 {name} model gradients: the card strays {card_e[tight]} from fp32 at "
          f"{tight}, more than {BF16_GRAD_RATIO} x the host's {host_e[tight]} + "
          f"{VESSEL_BF16_GRAD_FLOOR}")
    return e32, card_e, host_e


def phase_vessel_throughput(torch, dev):
    """The vessel train step and eval forward at batch 4 on 1024x1024x3, bf16."""
    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.metrics.device import make_train_metric_fn
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.optim import OptimManager
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import (amp_params, make_eval_step,
                                                                   make_train_step)

    cfg = check_args(parse_config(vessel_flags()))
    model = build_model(cfg).to(dev)
    gen = torch.Generator().manual_seed(21)
    x = torch.randn(BATCH, 1, 1024, 1024, 3, generator=gen).to(dev)
    y = (x[..., 0] > 0.5).long()
    step = make_eval_step(model.eval(), cross_entropy_loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eval_ms = median_ms(torch, lambda: step(amp_params(model, True), x, y, BATCH), warmup=2,
                        reps=5)
    eval_peak = torch.cuda.max_memory_allocated()
    print(f"phase 20 vessel eval forward, batch {BATCH} of 1024x1024x3, bf16: {eval_ms:.2f} "
          f"ms/batch = {BATCH * 1000 / eval_ms:.3f} images/s (median of 5); peak memory "
          f"{eval_peak / 2**30:.2f} GiB", flush=True)

    model.train()
    optim = OptimManager(cfg, num_train_samples=1000)
    optim.build(model.parameters())
    _, metrics_fn = make_train_metric_fn(cfg)
    train = make_train_step(model, cross_entropy_loss, optim, use_amp=True, metrics_fn=metrics_fn)
    lr = cfg.optim.lr
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(torch, lambda: train([(x, y)], lr, BATCH), warmup=2, reps=5)
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 20 vessel train step (forward, backward, Adam), batch {BATCH} of 1024x1024x3, "
          f"bf16: {ms:.2f} ms/step = {BATCH * 1000 / ms:.3f} images/s (median of 5 after 2 "
          f"warm-ups); peak memory {peak / 2**30:.2f} GiB", flush=True)
    profile_step(torch, lambda: train([(x, y)], lr, BATCH), "phase 20 vessel profile")
    return ms, eval_ms


def _k5_errors(torch, got, ref, dname, names, floor=0.0):
    """{name: max abs err} of K5 outputs against their plain references, and
    whether each is finite, of its reference's dtype and shape and within
    TOL (o, lse) or GRAD_TOL (gradients) of max(max|ref|, floor)."""
    errs, ok = {}, True
    for name, g, r in zip(names, got, ref):
        ok = ok and g.dtype == r.dtype and g.shape == r.shape
        g, r = g.float(), r.float()
        errs[name] = (g - r).abs().max().item()
        tol = (TOL if name in ("o", "lse") else GRAD_TOL)[dname]
        ok = (ok and bool(torch.isfinite(g).all().item())
              and errs[name] <= tol * max(r.abs().max().item(), floor))
    return errs, ok


def phase_k5(torch, fa, dev):
    """K5 forward, dq and dk/dv against the plain version and its VJP, fp32
    and bf16: at ragged lengths (K5_RAGGED) and head dims 32 and 128
    (K5_HEAD_DIMS), and at the vit16k shape (12,
    16385, 64) on every head-batch, for iid inputs and for inputs whose lone
    last key takes most queries' weight, with the plain version on
    head-batches 0-1 and 10-11; there two launches of each kernel must give
    the same bits. Then the times at vit16k in bf16 (``_k5_times``). Returns
    {"fwd" | "dq" | "dkv": (max abs err at vit16k in bf16 over both input
    sets, kernel ms, plain ms, SDPA ms)} per call; the plain and SDPA backward
    times are of the whole VJP (dq, dk and dv)."""
    gen = torch.Generator().manual_seed(22)
    scale = 64 ** -0.5

    def mk(shape):
        return torch.randn(shape, generator=gen).to(dev)

    def run_both(args, d):
        o, lse = fa.flash_attention_fwd(*args, scale)
        return (o, lse), fa.flash_attention_bwd(d, *args, o, lse, scale)

    for bh, l, hd in [(bh, l, 64) for bh, l in K5_RAGGED] + K5_HEAD_DIMS:
        raw = [mk((bh, l, hd)) for _ in range(4)]
        sc = hd ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            *args, d = (t.to(dtype) for t in raw)
            o, lse = fa.flash_attention_fwd(*args, sc)
            fwd, grads = (o, lse), fa.flash_attention_bwd(d, *args, o, lse, sc)
            torch.cuda.synchronize()
            # at L = 1, dq and dk vanish exactly (one key): the kernels leave
            # fp32 round-off of dp - delta, held on the inputs' scale, 1
            floor = 1.0 if l == 1 else 0.0
            e_fwd, ok_fwd = _k5_errors(torch, fwd, fa.flash_attention_plain(*args, sc), dname,
                                       ("o", "lse"), floor)
            e_bwd, ok_bwd = _k5_errors(torch, grads, fa.flash_attention_bwd_plain(d, *args, sc),
                                       dname, ("dq", "dk", "dv"), floor)
            print(f"phase 21 K5 BH={bh} L={l} D={hd} {dname}: max_abs_err "
                  + " ".join(f"{k}={v:.3e}" for k, v in {**e_fwd, **e_bwd}.items())
                  + (" ok" if ok_fwd and ok_bwd else " MISMATCH"), flush=True)
            check(ok_fwd and ok_bwd, f"K5 disagrees with its plain version at BH={bh} L={l} "
                                     f"D={hd} {dname}: {e_fwd} {e_bwd}")

    raw = [mk((VIT_BH, VIT_L, 64)) for _ in range(4)]
    # iid inputs spread every query's softmax over all 16,385 keys (max|o| is
    # small and one key moves o little), so a second set plants the ragged
    # tile's lone key: every query leans on a direction u by K5_LEAN, and key
    # L - 1 is K5_PLANT * u, which takes most of the weight for many queries
    u = torch.nn.functional.normalize(torch.randn((VIT_BH, 1, 64), generator=gen), dim=-1)
    u = u.to(dev)
    planted = [raw[0] + K5_LEAN * u, raw[1].clone(), raw[2], raw[3]]
    planted[1][:, -1:] = K5_PLANT * u
    worst, times = {}, None
    for inputs, label in ((raw, "iid"), (planted, "planted key")):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            *args, d = (t.to(dtype) for t in inputs)
            fwd, grads = run_both(args, d)
            fwd2, grads2 = run_both(args, d)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(t).all()) for t in (*fwd, *grads)),
                  f"K5 {dname} at vit16k, {label}: an output is not finite")
            same = all(torch.equal(a, b) for a, b in zip((*fwd, *grads), (*fwd2, *grads2)))
            check(same, f"K5 {dname} at vit16k, {label}: two launches gave different bits")
            del fwd2, grads2
            errs = {}
            for i in (0, VIT_BH - K5_PLAIN_SLICE):
                sl = [t[i:i + K5_PLAIN_SLICE] for t in (*args, d)]
                e_fwd, ok_fwd = _k5_errors(torch, [t[i:i + K5_PLAIN_SLICE] for t in fwd],
                                           fa.flash_attention_plain(*sl[:3], scale), dname,
                                           ("o", "lse"))
                e_bwd, ok_bwd = _k5_errors(torch, [t[i:i + K5_PLAIN_SLICE] for t in grads],
                                           fa.flash_attention_bwd_plain(sl[3], *sl[:3], scale),
                                           dname, ("dq", "dk", "dv"))
                check(ok_fwd and ok_bwd, f"K5 disagrees with its plain version at vit16k, "
                                         f"{label}, head-batches {i}-{i + K5_PLAIN_SLICE - 1}, "
                                         f"{dname}: {e_fwd} {e_bwd}")
                for k, v in {**e_fwd, **e_bwd}.items():
                    errs[k] = max(errs.get(k, 0.0), v)
                torch.cuda.empty_cache()
            # each query's weight on the last key, from the kernel's base-2 lse
            s_last = torch.einsum("bld,bd->bl", args[0].float(), args[1][:, -1].float())
            p_last = torch.exp2(s_last * (scale * math.log2(math.e)) - fwd[1].float())
            print(f"phase 21 K5 BH={VIT_BH} L={VIT_L} D=64 {dname}, {label}: max|o| "
                  f"{fwd[0].abs().max().item():.3e}; weight on key L-1: mean "
                  f"{p_last.mean().item():.3e}, over 0.5 for {(p_last > 0.5).sum().item()} of "
                  f"{p_last.numel()} queries; every output finite, two launches bitwise equal; "
                  f"head-batches 0-1 and {VIT_BH - 2}-{VIT_BH - 1} against the plain version, "
                  f"max_abs_err " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()) + " ok",
                  flush=True)
            if dtype == torch.bfloat16:
                for k, v in errs.items():
                    worst[k] = max(worst.get(k, 0.0), v)
                if label == "iid":
                    times = _k5_times(torch, fa, args, d, fwd[0], fwd[1], scale)
            del args, d, fwd, grads, s_last, p_last
            torch.cuda.empty_cache()
    k_fwd, k_dq, k_dkv, p_fwd, p_bwd, s_fwd, s_bwd = times
    return {"fwd": (worst["o"], k_fwd, p_fwd, s_fwd),
            "dq": (worst["dq"], k_dq, p_bwd, s_bwd),
            "dkv": (max(worst["dk"], worst["dv"]), k_dkv, p_bwd, s_bwd)}


def _k5_times(torch, fa, args, d, o, lse, scale):
    """ms per call at vit16k in bf16: K5 fwd, dq and dkv; the plain version
    over all 12 head-batches (K5_PLAIN_SLICE at a time), forward and VJP;
    SDPA forward and backward (and, printed only, both in one)."""
    import torch.nn.functional as F

    delta = (d.float() * o.float()).sum(dim=-1)
    k_fwd = median_ms(torch, lambda: fa.flash_attention_fwd(*args, scale), warmup=1, reps=5)
    k_dq = median_ms(torch, lambda: fa.flash_attention_dq(d, *args, lse, delta, scale),
                     warmup=1, reps=5)
    k_dkv = median_ms(torch, lambda: fa.flash_attention_dkv(d, *args, lse, delta, scale),
                      warmup=1, reps=5)
    slices = [[t[i:i + K5_PLAIN_SLICE] for t in (*args, d)]
              for i in range(0, VIT_BH, K5_PLAIN_SLICE)]
    p_fwd = median_ms(torch, lambda: [fa.flash_attention_plain(*sl[:3], scale)
                                      for sl in slices], warmup=1, reps=3)
    p_bwd = median_ms(torch, lambda: [fa.flash_attention_bwd_plain(sl[3], *sl[:3], scale)
                                      for sl in slices], warmup=1, reps=3)
    torch.cuda.empty_cache()
    # SDPA on (B, H, L, D), the layout the model's attention has
    qb, kb, vb, db = (t.view(VIT_BATCH, VIT_BH // VIT_BATCH, VIT_L, 64) for t in (*args, d))
    s_fwd = median_ms(torch, lambda: F.scaled_dot_product_attention(qb, kb, vb),
                      warmup=1, reps=5)
    leaves = [t.detach().requires_grad_(True) for t in (qb, kb, vb)]
    out = F.scaled_dot_product_attention(*leaves)
    s_bwd = median_ms(torch, lambda: torch.autograd.grad(out, leaves, db, retain_graph=True),
                      warmup=1, reps=5)
    s_both = median_ms(torch, lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves), leaves, db), warmup=1, reps=5)
    del out, leaves
    torch.cuda.empty_cache()
    print(f"phase 21 K5 times at BH={VIT_BH} L={VIT_L} D=64 bf16, ms per call: kernel "
          f"fwd {k_fwd:.3f}, dq {k_dq:.3f}, dkv {k_dkv:.3f}; plain fwd {p_fwd:.3f}, plain "
          f"VJP {p_bwd:.3f}; SDPA fwd {s_fwd:.3f}, bwd {s_bwd:.3f}, fwd+bwd "
          f"{s_both:.3f}", flush=True)
    return k_fwd, k_dq, k_dkv, p_fwd, p_bwd, s_fwd, s_bwd


def phase_vit_slice(torch, tmp):
    """run_torch.main trains vit16k on the card (this slice's main path),
    then an inference-only run reloads its best checkpoint."""
    import numpy as np
    import yaml

    import run_torch

    n_train, n_val, n_test, epochs = 4, 4, 4, 2
    write_dataset(tmp, (1024, 1024), n_train, n_val, n_test)
    steps = epochs * min(3, math.ceil(n_train / VIT_BATCH))      # --debug: 3 per epoch
    val_batches = min(3, math.ceil(n_val / VIT_BATCH))
    test_batches = min(3, math.ceil(n_test / VIT_BATCH))
    eval_batches = epochs * val_batches + val_batches + test_batches
    run_dir = os.path.join(tmp, "logs", "chip_smoke_vit")
    argv = vit16k_flags() + [f"--data_dir={tmp}/data", f"--split_csv_path={tmp}/split.csv",
                             "--device=cuda", "--debug", f"--num_epochs={epochs}",
                             f"--log_dir={tmp}/logs", "--run_name=chip_smoke_vit"]
    check("--train_model=True" in argv and not any(a.startswith("--Swin.") for a in argv),
          "the vit16k flags changed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = all_kernels()
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    rc = run_torch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kernel.symbol: kernel.launches for kernel in kernels}
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"run_torch.main returned {rc}")
    forward = steps + eval_batches
    check_launches(kernels, launches, {1: VIT_LAYERS * forward, 3: VIT_LAYERS * steps,
                                       9: VIT_LAYERS * forward, 10: VIT_LAYERS * steps,
                                       11: VIT_LAYERS * steps},
                   f"the vit16k train slice ({steps} train steps, {eval_batches} eval batches)")
    for name in ("model_last_epoch", "model_epoch_0", "model_best_checkpoint"):
        path = os.path.join(run_dir, "models", name)
        check(os.path.exists(os.path.join(path, "state.pt")), f"{path} missing")
    meta = yaml.safe_load(open(os.path.join(run_dir, "models", "model_last_epoch", "meta.yaml")))
    check(meta["step"] == steps and meta["epoch"] == epochs - 1,
          f"model_last_epoch meta: step {meta['step']} epoch {meta['epoch']}")
    log = open(os.path.join(run_dir, "run.log")).read()
    trained = re.findall(r"epoch (\d+) train: (\d+) steps, (\d+) samples in ([\d.]+) s", log)
    check(len(trained) == epochs, f"expected {epochs} train epoch lines, got {trained}")
    losses = [float(v) for v in re.findall(r"train: \{'loss': ([-\d.e+naninf]+)", log)]
    check(len(losses) == epochs and all(np.isfinite(losses)), f"train losses {losses}")
    metrics = {}
    for split in ("val", "test"):
        path = os.path.join(run_dir, f"{split}_metrics.txt")
        check(os.path.exists(path), f"{path} missing")
        m = {k: float(v) for k, v in (ln.split(": ") for ln in open(path).read().split("\n") if ln)}
        check(set(m) == {"loss", "acc_1", "auroc", "f1"} and np.isfinite(m["loss"]),
              f"{split} metrics {m}")
        metrics[split] = m
    train_images = sum(int(n) for _, _, n, _ in trained)
    train_seconds = sum(float(sec) for _, _, _, sec in trained)
    print(f"phase 22 vit16k train slice: run_torch.main vit16k training on the card in "
          f"{wall:.1f} s; {steps} train steps over {epochs} epochs, {train_images} images in "
          f"{train_seconds:.3f} s = {train_images / train_seconds:.3f} images/s (first steps "
          f"and loading included); train losses {losses}; peak memory {peak / 2**30:.2f} GiB; "
          f"launches {launches}; val {metrics['val']}; test {metrics['test']}", flush=True)

    for kernel in kernels:
        kernel.launches = 0
    rc = run_torch.main(["--inference_only=True", f"--inference_dir={run_dir}",
                         f"--inference_log_dir={tmp}/logs",
                         "--inference_run_name=chip_smoke_vit_inference"])
    check(rc == 0, f"inference-only run returned {rc}")
    inference = {kernel.symbol: kernel.launches for kernel in kernels}
    batches = val_batches + test_batches
    check_launches(kernels, inference, {1: VIT_LAYERS * batches, 9: VIT_LAYERS * batches},
                   "the vit16k inference-only run")
    path = os.path.join(tmp, "logs", "chip_smoke_vit_inference", "test_metrics.txt")
    check(os.path.exists(path), f"{path} missing")
    test = {k: float(v) for k, v in (ln.split(": ") for ln in open(path).read().split("\n") if ln)}
    check(test == metrics["test"], f"inference-only test metrics {test} != {metrics['test']}")
    print(f"phase 22 inference-only: reloaded {run_dir}/models/model_best_checkpoint; test "
          f"{test} (the training run's own); launches {inference}", flush=True)
    return launches


def phase_vit_grads(torch, dev, seed=23):
    """One train step's gradients of the full-width vit16k model (ViT-small,
    patch 8, ViTLinear) on 256x256 images at batch 2: 1,024 patch tokens and
    the cls token, so every block's attention takes the flash route (K5 on
    the card, its plain version on the host). Weights and images from one
    seed, on the card against the host, fp32 and bf16, per parameter
    (max|err| / max|reference|). fp32: every parameter within
    MODEL_GRAD_TOL. bf16 (AMP): the card's fp32 gradients are the reference;
    each parameter's bf16 gradient on the card may stray from it at most
    BF16_GRAD_RATIO times as far as the host's bf16 gradient, plus
    VIT_BF16_GRAD_FLOOR of its max. On the card K5 runs 12 times forward and
    its two backward kernels 12 times each, per gradient."""
    from torch.func import functional_call

    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import amp_params

    argv = ([a for a in vit16k_flags() if a != "--use_amp"]
            + ["--height=256", "--width=256", f"--seed={seed}"])
    x = torch.randn(VIT_BATCH, 1, 256, 256, 1, generator=torch.Generator().manual_seed(seed))
    y = torch.arange(VIT_BATCH) % 2
    k5 = all_kernels()[9:12]

    def grads(model, amp, device):
        model.to(device).zero_grad(set_to_none=True)
        before = [k.launches for k in k5]
        out = functional_call(model, amp_params(model, amp), (x.to(device),)).float()
        cross_entropy_loss(out, y.to(device)).backward()
        ran = [k.launches - b for k, b in zip(k5, before)]
        check(ran == ([VIT_LAYERS] * 3 if device != "cpu" else [0] * 3),
              f"K5 launches {ran} on {device}")
        return {k: p.grad.detach().cpu() for k, p in model.named_parameters()}

    def errors(got, ref, dname):
        errs = {}
        for name, g in got.items():
            check(bool(torch.isfinite(g).all()), f"{dname}: gradient of {name} not finite")
            check(g.abs().max().item() > 0, f"{dname}: gradient of {name} is all zero")
            errs[name] = ((g - ref[name]).abs().max().item()
                          / max(ref[name].abs().max().item(), 1e-30))
        return errs

    model = build_model(check_args(parse_config(argv)))
    amp_model = build_model(check_args(parse_config(argv + ["--use_amp"])))
    amp_model.load_state_dict(model.state_dict())
    host32 = grads(model, False, "cpu")
    host16 = grads(amp_model, True, "cpu")
    card32 = grads(model, False, dev)
    card16 = grads(amp_model, True, dev)
    e32 = errors(card32, host32, "float32")
    at = max(e32, key=e32.get)
    print(f"phase 23 vit16k model gradients: full-width ViT-small + ViTLinear, batch "
          f"{VIT_BATCH} of 256x256 (1,025 tokens), float32, seed {seed}: {len(card32)} "
          f"parameters, every card gradient finite and non-zero; card vs host worst max|err| / "
          f"max|host grad| {e32[at]:.3e} ({at})", flush=True)
    check(e32[at] <= MODEL_GRAD_TOL["float32"],
          f"float32 vit16k model gradients: {at} off by {e32[at]} of its max")
    card_e = errors(card16, card32, "bfloat16")
    host_e = errors(host16, card32, "bfloat16 host")
    limit = {k: BF16_GRAD_RATIO * host_e[k] + VIT_BF16_GRAD_FLOOR for k in card_e}
    tight = max(card_e, key=lambda k: card_e[k] / limit[k])
    ratio = max(card_e, key=lambda k: card_e[k] / max(host_e[k], 1e-30))
    worst_card, worst_host = max(card_e, key=card_e.get), max(host_e, key=host_e.get)
    print(f"phase 23 vit16k model gradients, bfloat16: every card gradient finite and non-zero; "
          f"max|err| / max|fp32 card grad|, worst: card {card_e[worst_card]:.3e} ({worst_card}), "
          f"host {host_e[worst_host]:.3e} ({worst_host}); per parameter, nearest its limit "
          f"{tight}: card {card_e[tight]:.3e}, host {host_e[tight]:.3e}, limit "
          f"{limit[tight]:.3e}; largest card/host ratio {ratio}: {card_e[ratio]:.3e} / "
          f"{host_e[ratio]:.3e}", flush=True)
    check(card_e[tight] <= limit[tight],
          f"bfloat16 vit16k model gradients: the card strays {card_e[tight]} from fp32 at "
          f"{tight}, more than {BF16_GRAD_RATIO} x the host's {host_e[tight]} + "
          f"{VIT_BF16_GRAD_FLOOR}")
    return e32, card_e, host_e


def phase_vit_throughput(torch, dev):
    """The vit16k train step and eval forward at batch 2 on 1024x1024x1, bf16."""
    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.metrics.device import make_train_metric_fn
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.optim import OptimManager
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import (amp_params, make_eval_step,
                                                                   make_train_step)

    cfg = check_args(parse_config(vit16k_flags()))
    model = build_model(cfg).to(dev)
    gen = torch.Generator().manual_seed(24)
    x = torch.randn(VIT_BATCH, 1, 1024, 1024, 1, generator=gen).to(dev)
    y = (torch.arange(VIT_BATCH) % 2).to(dev)
    step = make_eval_step(model.eval(), cross_entropy_loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eval_ms = median_ms(torch, lambda: step(amp_params(model, True), x, y, VIT_BATCH), warmup=2,
                        reps=5)
    eval_peak = torch.cuda.max_memory_allocated()
    print(f"phase 24 vit16k eval forward, batch {VIT_BATCH} of 1024x1024, bf16: {eval_ms:.2f} "
          f"ms/batch = {VIT_BATCH * 1000 / eval_ms:.3f} images/s (median of 5); peak memory "
          f"{eval_peak / 2**30:.2f} GiB", flush=True)
    profile_step(torch, lambda: step(amp_params(model, True), x, y, VIT_BATCH),
                 "phase 24 vit16k eval profile")

    model.train()
    optim = OptimManager(cfg, num_train_samples=1000)
    optim.build(model.parameters())
    _, metrics_fn = make_train_metric_fn(cfg)
    train = make_train_step(model, cross_entropy_loss, optim, use_amp=True, metrics_fn=metrics_fn)
    lr = cfg.optim.lr
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(torch, lambda: train([(x, y)], lr, VIT_BATCH), warmup=2, reps=5)
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 24 vit16k train step (forward, backward, Adam), batch {VIT_BATCH} of "
          f"1024x1024, bf16: {ms:.2f} ms/step = {VIT_BATCH * 1000 / ms:.3f} images/s (median of "
          f"5 after 2 warm-ups); peak memory {peak / 2**30:.2f} GiB", flush=True)
    profile_step(torch, lambda: train([(x, y)], lr, VIT_BATCH), "phase 24 vit16k profile")
    return ms, eval_ms


def _k6_inputs(torch, gen, shape, dtype, dev, with_bias):
    """u, k, bias, g of one K6 case: u and the cotangent g iid, k an iid
    filter decaying along the sequence as the Hyena filter does."""
    b, d, length = shape
    u = torch.randn(shape, generator=gen).to(dev, dtype)
    k = (torch.randn((d, length), generator=gen) * torch.exp(-torch.arange(length) / 4000.0))
    bias = torch.randn((d,), generator=gen).to(dev) if with_bias else None
    g = torch.randn(shape, generator=gen).to(dev, dtype)
    return u, k.to(dev), bias, g


def phase_k6(torch, sc, dev):
    """K6's convolution (y, and du from the conjugate spectrum plus bias g),
    dk and dbias = dk[:, 0] against the plain version and its VJP at
    K6_SHAPES, with and without the bias, fp32 and bf16; two launches of each
    must give the same bits. Then the refusals, and the times at the
    vit65k_hyena shape in bf16. Returns {"conv" | "dk": (max abs err at
    (1, 384, 65536) in bf16, kernel ms, plain ms)} per call: the conv row's
    kernel time is the forward and the du call, its plain time the plain
    forward and du's share of the plain VJP; the dk row's the dk call and
    dk's share (the VJP computes du, dk and dbias in one call: it is split as
    the two rows' bounds split the backward's work)."""
    gen = torch.Generator().manual_seed(25)
    worst = {"conv": 0.0, "dk": 0.0}
    for shape in K6_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            for with_bias in (False, True):
                u, k, bias, g = _k6_inputs(torch, gen, shape, dtype, dev, with_bias)
                got = [sc.spectral_conv_fwd(u, k, bias), sc.spectral_conv_fwd(g, k, bias, True),
                       sc.spectral_conv_dk(g, u)]
                again = [sc.spectral_conv_fwd(u, k, bias), sc.spectral_conv_fwd(g, k, bias, True),
                         sc.spectral_conv_dk(g, u)]
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"K6 {shape} {dname} bias={with_bias}: two launches gave different bits")
                got.append(got[2][:, 0] if with_bias else None)
                ref = [sc.spectral_causal_conv_plain(u, k, bias),
                       *sc.spectral_causal_conv_bwd_plain(g, u, k, bias)]
                errs, ok = {}, True
                for name, a, r in zip(("y", "du", "dk", "dbias"), got, ref):
                    if r is None:
                        continue
                    ok = ok and a.dtype == r.dtype and a.shape == r.shape
                    a, r = a.float(), r.float()
                    errs[name] = (a - r).abs().max().item()
                    ok = (ok and bool(torch.isfinite(a).all().item())
                          and errs[name] <= K6_TOL[dname] * r.abs().max().item())
                print(f"phase 25 K6 B,D,L={shape} {dname} bias={with_bias}: max_abs_err "
                      + " ".join(f"{k_}={v:.3e}" for k_, v in errs.items())
                      + " (max|y| {:.3e}, max|dk| {:.3e}); two launches bitwise equal".format(
                          ref[0].float().abs().max().item(), ref[2].abs().max().item())
                      + (" ok" if ok else " MISMATCH"), flush=True)
                check(ok, f"K6 disagrees with its plain version at {shape} {dname} "
                          f"bias={with_bias}: {errs}")
                if shape == K6_SHAPES[0] and dtype == torch.bfloat16:
                    worst["conv"] = max(worst["conv"], errs["y"], errs["du"])
                    worst["dk"] = max(worst["dk"], errs["dk"], errs.get("dbias", 0.0))
                del u, k, bias, g, got, again, ref
                torch.cuda.empty_cache()
    for args, exc in (((torch.zeros(1, 2, 4096, device=dev), torch.zeros(2, 4096, device=dev)),
                       ValueError),
                      ((torch.zeros(1, 2, 8192), torch.zeros(2, 8192)), ValueError),
                      ((torch.zeros(1, 2, 8192, device=dev, dtype=torch.float16),
                        torch.zeros(2, 8192, device=dev)), TypeError)):
        try:
            sc.spectral_conv_fwd(*args)
        except exc:
            continue
        raise SmokeFailure(f"K6 took {tuple(args[0].shape)} {args[0].dtype} on "
                           f"{args[0].device}")
    print("phase 25 K6 refusals: L = 4096, a CPU tensor, fp16: refused", flush=True)

    u, k, bias, g = _k6_inputs(torch, gen, K6_SHAPES[0], torch.bfloat16, dev, True)
    k_fwd = median_ms(torch, lambda: sc.spectral_conv_fwd(u, k, bias), warmup=1, reps=5)
    k_du = median_ms(torch, lambda: sc.spectral_conv_fwd(g, k, bias, True), warmup=1, reps=5)
    k_dk = median_ms(torch, lambda: sc.spectral_conv_dk(g, u), warmup=1, reps=5)
    p_fwd = median_ms(torch, lambda: sc.spectral_causal_conv_plain(u, k, bias), warmup=1, reps=5)
    p_vjp = median_ms(torch, lambda: sc.spectral_causal_conv_bwd_plain(g, u, k, bias), warmup=1,
                      reps=5)
    del u, k, bias, g
    torch.cuda.empty_cache()
    bounds = k6_bounds()
    share = bounds["conv"][0] / (bounds["conv"][0] + bounds["dk"][0])
    print(f"phase 25 K6 times at B,D,L={K6_SHAPES[0]} bf16 with the bias, ms per call: kernel "
          f"conv {k_fwd:.3f}, conv du {k_du:.3f}, dk {k_dk:.3f}; plain fwd {p_fwd:.3f}, plain VJP "
          f"{p_vjp:.3f}; bounds conv {bounds['conv'][0]:.4f} ({bounds['conv'][1]}), dk "
          f"{bounds['dk'][0]:.4f} ({bounds['dk'][1]})", flush=True)
    return {"conv": (worst["conv"], k_fwd + k_du, p_fwd + share * p_vjp),
            "dk": (worst["dk"], k_dk, (1 - share) * p_vjp)}


def _k7_inputs(torch, gen, shape, dtype, dev):
    """u, delta, A, B, C, D, delta_bias and a cotangent g of one K7 case:
    A = -(1..8) per channel times exp(0.3 N(0, 1)), as A_log's init plus
    noise; u, delta, B, C and g in dtype, the rest fp32."""
    b, length, d = shape
    a = -torch.arange(1, K7_N + 1.0) * torch.exp(0.3 * torch.randn(d, K7_N, generator=gen))
    args = [torch.randn(shape, generator=gen), torch.randn(shape, generator=gen), a,
            torch.randn(b, length, K7_N, generator=gen),
            torch.randn(b, length, K7_N, generator=gen), torch.randn(d, generator=gen),
            torch.randn(d, generator=gen), torch.randn(shape, generator=gen)]
    return [t.to(dev, dtype if i in (0, 1, 3, 4, 7) else torch.float32)
            for i, t in enumerate(args)]


def _k7_vjp(torch, fn, args):
    """fn(*args[:7]) and its gradients for the cotangent args[7]."""
    leaves = [t.detach().requires_grad_(True) for t in args[:7]]
    y = fn(*leaves)
    return [y.detach()] + list(torch.autograd.grad(y, leaves, args[7]))


def phase_k7(torch, ssl, dev):
    """K7, the long-sequence scan of the vit65k_mamba path. selective_scan_long
    on the card (the forward kernel twice, the carry and backward kernels,
    the stitches) against its plain version (the chunked scan) at K7_SHAPES,
    fp32 and bf16: y and the gradients of u, delta, A, B, C, D and
    delta_bias, two runs bitwise equal. Then each kernel against its pass's
    plain version on the same fp32 inputs at K7_SHAPES, the refusals, and
    the times at the vit65k_mamba shape (fp32 operands, as the path casts its
    bf16 ones). Returns {"fwd" | "carry" | "bwd": (max abs err against the
    pass's plain version at that shape, kernel ms, plain ms)} per layer: the
    fwd row's kernel time is both forward calls, its plain time the plain
    forward; the plain backward (the VJP less the forward) is split between
    the carry and bwd rows as their bounds split the backward's work."""
    gen = torch.Generator().manual_seed(29)
    kernels = (ssl.LONG_SCAN_FWD, ssl.LONG_SCAN_CARRY_BWD, ssl.LONG_SCAN_BWD)
    names = ("y", "du", "ddelta", "dA", "dB", "dC", "dD", "ddelta_bias")
    for shape in K7_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            args = _k7_inputs(torch, gen, shape, dtype, dev)
            before = [k.launches for k in kernels]
            got = _k7_vjp(torch, ssl.selective_scan_long, args)
            again = _k7_vjp(torch, ssl.selective_scan_long, args)
            torch.cuda.synchronize()
            ran = [k.launches - b for k, b in zip(kernels, before)]
            check(ran == [4, 2, 2], f"K7 {shape} {dname}: launches {ran}, expected [4, 2, 2]")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K7 {shape} {dname}: two runs gave different bits")
            ref = _k7_vjp(torch, ssl.selective_scan_long_plain, args)
            errs, ok = {}, True
            for i, (name, a, r) in enumerate(zip(names, got, ref)):
                ok = ok and a.dtype == r.dtype and a.shape == r.shape
                a, r = a.float(), r.float()
                errs[name] = (a - r).abs().max().item()
                ok = (ok and bool(torch.isfinite(a).all().item())
                      and errs[name] <= K7_TOL[dname][i > 0] * r.abs().max().item())
            print(f"phase 29 K7 b,L,D={shape} {dname}: max_abs_err "
                  + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
                  + " (max|y| {:.3e}, max|dA| {:.3e}); two runs bitwise equal".format(
                      ref[0].float().abs().max().item(), ref[3].abs().max().item())
                  + (" ok" if ok else " MISMATCH"), flush=True)
            check(ok, f"K7 disagrees with its plain version at {shape} {dname}: {errs}")
            del args, got, again, ref
            torch.cuda.empty_cache()

    worst = {}
    for shape in K7_SHAPES:
        b, length, _ = shape
        nseg = -(-length // ssl.SEG)
        u, delta, a, bm, cm, _, _, g = _k7_inputs(torch, gen, shape, torch.float32, dev)
        at = a.t().contiguous()
        _, hl, ap = ssl.long_scan_fwd_plain(u, delta, at, bm, cm, emit_y=False)
        hstart = ssl._stitch_fwd(hl, ap, b, nseg)
        dht = ssl._stitch_bwd(ssl.long_scan_carry_bwd_plain(delta, at, cm, g), ap, b, nseg)
        pairs = {
            "fwd": ([*ssl.long_scan_fwd(u, delta, at, bm, cm, emit_y=False)[1:],
                     ssl.long_scan_fwd(u, delta, at, bm, cm, hstart)[0]],
                    [hl, ap, ssl.long_scan_fwd_plain(u, delta, at, bm, cm, hstart)[0]]),
            "carry": ([ssl.long_scan_carry_bwd(delta, at, cm, g)],
                      [ssl.long_scan_carry_bwd_plain(delta, at, cm, g)]),
            "bwd": (ssl.long_scan_bwd(u, delta, at, bm, cm, g, hstart, dht),
                    ssl.long_scan_bwd_plain(u, delta, at, bm, cm, g, hstart, dht))}
        torch.cuda.synchronize()
        errs, ok = {}, True
        for key, (got, ref) in pairs.items():
            e = [(x - r).abs().max().item() for x, r in zip(got, ref)]
            ok = ok and all(bool(torch.isfinite(x).all().item())
                            and v <= K7_PASS_TOL * r.abs().max().item()
                            for x, r, v in zip(got, ref, e))
            errs[key] = max(e)
        print(f"phase 29 K7 kernels against their passes' plain versions, b,L,D={shape} "
              f"float32: max_abs_err fwd (hl, ap, y) {errs['fwd']:.3e}, carry bwd (dh0) "
              f"{errs['carry']:.3e}, bwd (du, ddelta, dat, dB, dC) {errs['bwd']:.3e}"
              + (" ok" if ok else " MISMATCH"), flush=True)
        check(ok, f"a K7 kernel disagrees with its pass's plain version at {shape}: {errs}")
        if shape == K7_SHAPES[0]:
            worst = errs
        del u, delta, a, bm, cm, g, at, hl, ap, hstart, dht, pairs
        torch.cuda.empty_cache()

    u, delta, a, bm, cm, _, _, g = _k7_inputs(torch, gen, K7_SHAPES[2], torch.float32, dev)
    for args, what in (((u.cpu(), delta.cpu(), a.t().contiguous().cpu(), bm.cpu(), cm.cpu()),
                        "a CPU tensor"),
                       ((u, delta, a.t()[:4].contiguous(), bm[..., :4].contiguous(),
                         cm[..., :4].contiguous()), "d_state 4")):
        try:
            ssl.long_scan_fwd(*args)
        except ValueError:
            continue
        raise SmokeFailure(f"K7 took {what}")
    print("phase 29 K7 refusals: a CPU tensor, d_state 4: refused", flush=True)

    b, length, _ = K7_SHAPES[0]
    nseg = -(-length // ssl.SEG)
    args = _k7_inputs(torch, gen, K7_SHAPES[0], torch.bfloat16, dev)
    u, delta, a, bm, cm, dskip, dbias, g = args
    u32, d32, at = u.float(), (delta.float() + dbias).contiguous(), a.t().contiguous()
    b32, c32, g32 = bm.float(), cm.float(), g.float()
    _, hl, ap = ssl.long_scan_fwd(u32, d32, at, b32, c32, emit_y=False)
    hstart = ssl._stitch_fwd(hl, ap, b, nseg)
    dht = ssl._stitch_bwd(ssl.long_scan_carry_bwd(d32, at, c32, g32), ap, b, nseg)
    k_zero = median_ms(torch, lambda: ssl.long_scan_fwd(u32, d32, at, b32, c32, emit_y=False))
    k_y = median_ms(torch, lambda: ssl.long_scan_fwd(u32, d32, at, b32, c32, hstart))
    k_carry = median_ms(torch, lambda: ssl.long_scan_carry_bwd(d32, at, c32, g32))
    k_bwd = median_ms(torch, lambda: ssl.long_scan_bwd(u32, d32, at, b32, c32, g32, hstart, dht))
    with torch.no_grad():
        p_fwd = median_ms(torch, lambda: ssl.selective_scan_long_plain(*args[:7]), warmup=1,
                          reps=5)
    p_vjp = median_ms(torch, lambda: _k7_vjp(torch, ssl.selective_scan_long_plain, args),
                      warmup=1, reps=5)
    peaks = {}
    for label, fn in (("K7", ssl.selective_scan_long), ("plain", ssl.selective_scan_long_plain)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _k7_vjp(torch, fn, args)
        torch.cuda.synchronize()
        peaks[label] = (torch.cuda.max_memory_allocated() - base) / 2**30
    del args, u, delta, a, bm, cm, dskip, dbias, g, u32, d32, at, b32, c32, g32, hl, ap
    del hstart, dht
    torch.cuda.empty_cache()
    bounds = k7_bounds()
    share = bounds["carry_bwd"][0] / (bounds["carry_bwd"][0] + bounds["bwd"][0])
    p_bwd = max(p_vjp - p_fwd, 0.0)
    print(f"phase 29 K7 times at b,L,D={K7_SHAPES[0]}, N={K7_N}, fp32 operands, ms per call: "
          f"kernel fwd zero-carry {k_zero:.3f}, fwd seeded with y {k_y:.3f}, carry bwd "
          f"{k_carry:.3f}, bwd {k_bwd:.3f}; plain (chunked scan, bf16 inputs) fwd {p_fwd:.3f}, "
          f"VJP {p_vjp:.3f}; peak memory of the forward and VJP above their inputs: K7 "
          f"{peaks['K7']:.3f} GiB, plain {peaks['plain']:.3f} GiB; bounds fwd "
          f"{bounds['fwd_zero'][0]:.4f} + {bounds['fwd_y'][0]:.4f} ({bounds['fwd_y'][1]}), "
          f"carry bwd {bounds['carry_bwd'][0]:.4f} ({bounds['carry_bwd'][1]}), "
          f"bwd {bounds['bwd'][0]:.4f} ({bounds['bwd'][1]})",
          flush=True)
    return {"fwd": (worst["fwd"], k_zero + k_y, p_fwd),
            "carry": (worst["carry"], k_carry, share * p_bwd),
            "bwd": (worst["bwd"], k_bwd, (1 - share) * p_bwd)}


def _k8_case(torch, gen, bw, v, c, grid, dev, rid_rows=7):
    """Operands of one K8 case, drawn as the model initialises them (the
    weights U(+-1/sqrt(C)), the biases small, the table trunc_normal(0.02)
    gathered, here iid at 0.5 to make the bias matter), x and the cotangent
    iid; region ids of the shifted windows of a grid x grid token grid, or
    random ids in rid_rows rows when grid is None."""
    from long_context_biomedical_imaging_tpu_torch.ops.window import compute_shift_regions

    heads = c // 32

    def mk(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    args = [mk((bw, v, c), 1.0), mk((c, 3 * c), c ** -0.5), mk((3 * c,), 0.1),
            mk((c, c), c ** -0.5), mk((c,), 0.1), mk((heads, v, v), 0.5)]
    if grid is None:
        rid = torch.randint(0, 4, (rid_rows, v), generator=gen, dtype=torch.int32).to(dev)
    else:
        w = int(round(v ** 0.5))
        rid = compute_shift_regions((1, grid, grid), (1, w, w), (0, w // 2, w // 2)).to(dev)
    check(bw % rid.shape[0] == 0, f"{bw} windows, {rid.shape[0]} region rows")
    return args, rid, mk((bw, v, c), 1.0), heads


def phase_k8(torch, wa, dev):
    """K8 forward, backward and weight-gradient kernels against the plain
    version and its VJP at the four ptx_attn stage shapes (batch 4, 16-token
    windows, C = 96 .. 768), at 64-token windows and at a window count no
    tile divides, each with and without region ids, fp32 and bf16; two
    launches bitwise equal; the relative-position table's gradient through
    the gather; the refusals; then the times of the kernels and the plain
    version at the stage shapes in bf16 with region ids (the odd blocks'
    call). Returns {"fwd" | "bwd" | "wgrad": [(worst bf16 abs err over the
    cases, kernel_ms, plain_ms) per stage]}; the plain VJP's time is split
    between bwd and wgrad as their bounds split the backward's work."""
    from long_context_biomedical_imaging_tpu_torch.models.swin import WindowAttention

    gen = torch.Generator().manual_seed(33)
    scale = 32 ** -0.5
    worst = {"fwd": 0.0, "bwd": 0.0, "wgrad": 0.0}
    cases = [(bw, 16, c, grid) for bw, c, grid, _ in ATTN_STAGES] + K8_EXTRA
    for bw, v, c, grid in cases:
        base, rid_c, do_c, heads = _k8_case(torch, gen, bw, v, c, grid, dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x, wq, bq, wo, bo, rel = ([base[0].to(dtype), base[1].to(dtype), base[2],
                                       base[3].to(dtype)] + base[4:])
            do = do_c.to(dtype)
            for rid in (rid_c, None):
                args = (x, wq, bq, wo, bo, rel, heads, rid, -100.0, scale)
                err, berr, werr = _k8_hold(torch, wa, args, do, bw, dname,
                                           f"BW={bw} V={v} C={c} {dname} rid={rid is not None}",
                                           33)
                if dtype == torch.bfloat16:
                    worst["fwd"] = max(worst["fwd"], err)
                    worst["bwd"] = max(worst["bwd"], berr)
                    worst["wgrad"] = max(worst["wgrad"], werr)
        del base, do_c, x, wq, bq, wo, bo, rel, do
        torch.cuda.empty_cache()

    # bitwise repeatability, the table's gradient through the gather, refusals
    bw1, c1, grid1, _ = ATTN_STAGES[1]
    base, rid, do, heads = _k8_case(torch, gen, bw1, 16, c1, grid1, dev)
    args = (base[0].bfloat16(), base[1].bfloat16(), base[2], base[3].bfloat16(), base[4],
            base[5], heads, rid, -100.0, scale)
    runs = [(wa.window_attention_fwd(*args), *wa.window_attention_bwd(do.bfloat16(), *args))
            for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)), "K8 launches are not bitwise repeatable")
    del runs
    module = WindowAttention(384, 12, window_size=(1, 4, 4))
    module.init_params(gen)
    module.to(dev)
    x = torch.randn(ATTN_STAGES[2][0], 16, 384, generator=gen).to(dev)
    rid = _k8_case(torch, gen, ATTN_STAGES[2][0], 16, 384, ATTN_STAGES[2][2], dev)[1]
    g = torch.randn(x.shape, generator=gen).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        table = module.relative_position_bias_table
        table.grad = None
        params = {k: p.to(dtype) for k, p in module.named_parameters()}
        out = torch.func.functional_call(module, params, (x.to(dtype), rid))
        out.backward(g.to(dtype))
        card = table.grad.clone()
        table.grad = None
        params = {k: p.to(dtype) for k, p in module.named_parameters()}
        rel = params["relative_position_bias_table"][module._index.to(dev)]
        rel = rel.reshape(16, 16, 12).permute(2, 0, 1)
        ref = wa.window_attention_plain(x.to(dtype), params["qkv_kernel"], params["qkv_bias_p"],
                                        params["proj_kernel"], params["proj_bias"], rel, 12, rid)
        ref.backward(g.to(dtype))
        terr, trel, tok = compare_grads(torch, (card,), (table.grad,), dname)
        check(tok, f"K8 table gradient through the gather, {dname}: {trel} > {GRAD_TOL[dname]}")
        print(f"phase 33 K8 table gradient through the gather, BW={x.shape[0]} C=384 {dname}: "
              f"max_abs_err={terr:.3e} max_rel_err={trel:.3e} ok", flush=True)
    refusals = 0
    for bad in (lambda: wa.window_attention_fwd(*[a.cpu() if torch.is_tensor(a) else a
                                                  for a in args]),
                lambda: wa.window_attention_fwd(*args[:6], 12, *args[7:])):
        try:
            bad()
        except ValueError:
            refusals += 1
    check(refusals == 2, "K8 took a CPU tensor or a head dim other than 32")
    print("phase 33 K8: two launches bitwise equal; a CPU tensor and D = 16 refused", flush=True)
    del base, args, module, x, g
    torch.cuda.empty_cache()

    bounds = k8_bounds()
    results = {"fwd": [], "bwd": [], "wgrad": []}
    for (bw, c, grid, _), b in zip(ATTN_STAGES, bounds):
        base, rid, do, heads = _k8_case(torch, gen, bw, 16, c, grid, dev)
        args = (base[0].bfloat16(), base[1].bfloat16(), base[2], base[3].bfloat16(), base[4],
                base[5], heads, rid, -100.0, scale)
        do = do.bfloat16()
        with torch.no_grad():
            f_ms = median_ms(torch, lambda: wa.window_attention_fwd(*args), warmup=1, reps=5)
            pf_ms = median_ms(torch, lambda: wa.window_attention_plain(*args), warmup=1, reps=3)
        streams = wa.window_attention_bwd_streams(do, *args)
        b_ms = median_ms(torch, lambda: wa.window_attention_bwd_streams(do, *args), warmup=1,
                         reps=5)
        w_ms = median_ms(torch, lambda: wa.window_attention_wgrad(args[0], streams[1],
                                                                 streams[2], do),
                         warmup=1, reps=5)
        pb_ms = median_ms(torch, lambda: wa.window_attention_bwd_plain(do, *args), warmup=1,
                          reps=3)
        share = b["bwd"][0] / (b["bwd"][0] + b["wgrad"][0])
        results["fwd"].append((worst["fwd"], f_ms, pf_ms))
        results["bwd"].append((worst["bwd"], b_ms, share * pb_ms))
        results["wgrad"].append((worst["wgrad"], w_ms, (1 - share) * pb_ms))
        print(f"phase 33 K8 times BW={bw} V=16 C={c} bf16 rid: fwd {f_ms:.3f} ms (bound "
              f"{b['fwd'][0]:.3f}, plain {pf_ms:.3f}); bwd {b_ms:.3f} ms (bound "
              f"{b['bwd'][0]:.3f}); wgrad {w_ms:.3f} ms (bound {b['wgrad'][0]:.3f}); plain VJP "
              f"{pb_ms:.3f} ms", flush=True)
        del base, args, do, streams
        torch.cuda.empty_cache()
    return results


def _k8_hold(torch, wa, args_full, do_full, n_plain, dname, label, phase):
    """One K8 case, kernels against the plain version and its VJP on the
    first n_plain windows of the operands: (fwd abs err, bwd abs err over
    dx and the bias and table gradients, wgrad abs err over dWqkv and dWout),
    after the checks."""
    x, *rest = args_full
    args = (x[:n_plain], *rest)
    do = do_full[:n_plain]
    with torch.no_grad():
        out = wa.window_attention_fwd(*args)
        torch.cuda.synchronize()
        ref = wa.window_attention_plain(*args)
        err, mag, ok = compare(torch, out, ref, dname)
    del out, ref
    check(ok, f"K8 fwd disagrees with its plain version at {label}: {err} > {TOL[dname]} * {mag}")
    got = wa.window_attention_bwd(do, *args)
    torch.cuda.synchronize()
    refs = wa.window_attention_bwd_plain(do, *args)
    gerr, grel, gok = compare_grads(torch, got, refs, dname)
    werr = compare_grads(torch, (got[1], got[3]), (refs[1], refs[3]), dname)[0]
    berr = compare_grads(torch, got[:1] + got[2:3] + got[4:], refs[:1] + refs[2:3] + refs[4:],
                         dname)[0]
    del got, refs
    torch.cuda.empty_cache()
    check(gok, f"K8 bwd disagrees with its plain VJP at {label}: {grel} > {GRAD_TOL[dname]}")
    print(f"phase {phase} K8 {label}: fwd max_abs_err={err:.3e} max|out|={mag:.3e}; every "
          f"gradient max_abs_err={gerr:.3e} max_rel_err={grel:.3e} ok", flush=True)
    return err, berr, werr


def phase_k8_general(torch, wa, dev):
    """K8 at every window class: the forward, backward and weight-gradient
    kernels against the plain version and its VJP at V = 16 and 64 (the
    whole-window path) and 49, 256, 343 and 512 (the general path), with and
    without region ids, and at emb_attn's four stage shapes (batch 4) with
    their region ids, the plain version on at most K8_PLAIN_WINDOWS windows
    (stage 0: one volume's 1,024 of its 4,096); fp32 and bf16. Two launches
    bitwise equal; V = 513 takes the plain version with no K8 launch; a CPU
    tensor, V = 0 and a head dim of 48 are refused. Then the times of the
    kernels on each whole stage shape and of the plain version over the
    same windows in slices, bf16 with region ids (the odd blocks' call).
    Returns {"fwd" | "bwd" | "wgrad": [(worst bf16 abs err over the stage
    cases, kernel_ms, plain_ms) per stage]}; the plain VJP's time is split
    between bwd and wgrad as their bounds split the backward's work."""
    gen = torch.Generator().manual_seed(42)
    scale = 32 ** -0.5

    def operands(bw, v, c, rid_rows=1):
        base, rid, do, heads = _k8_case(torch, gen, bw, v, c, None, dev, rid_rows)
        return base, do, heads, rid

    def typed(base, heads, rid, dtype):
        x, wq, bq, wo, bo, rel = base
        return (x.to(dtype), wq.to(dtype), bq, wo.to(dtype), bo, rel, heads, rid, -100.0, scale)

    for bw, v, c, with_rid in K8_CLASSES:
        base, do, heads, rid_c = operands(bw, v, c, 4)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            for rid in ((rid_c, None) if with_rid else (None,)):
                _k8_hold(torch, wa, typed(base, heads, rid, dtype), do.to(dtype), bw, dname,
                         f"BW={bw} V={v} C={c} {dname} rid={rid is not None}", 42)
        del base, do

    stages = emb_attn_stages()
    worst = [{"fwd": 0.0, "bwd": 0.0, "wgrad": 0.0} for _ in stages]
    for i, (bw, v, c, rid, *_) in enumerate(stages):
        base, do, heads, _ = operands(bw, v, c)
        rid = None if rid is None else rid.to(dev)
        n_plain = min(bw, K8_PLAIN_WINDOWS)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            errs = _k8_hold(torch, wa, typed(base, heads, rid, dtype), do.to(dtype), n_plain,
                            dname, f"emb_attn stage {i} BW={bw} (plain on {n_plain}) V={v} "
                                   f"C={c} {dname} rid={rid is not None}", 42)
            if dtype == torch.bfloat16:
                worst[i] = dict(zip(("fwd", "bwd", "wgrad"), errs))
        del base, do
        torch.cuda.empty_cache()

    # bitwise repeatability, the V > 512 route, refusals
    bw, v, c, rid, *_ = stages[1]
    base, do, heads, _ = operands(bw, v, c)
    args = typed(base, heads, rid.to(dev), torch.bfloat16)
    runs = [(wa.window_attention_fwd(*args), *wa.window_attention_bwd(do.bfloat16(), *args))
            for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "K8's general path is not bitwise repeatable")
    del runs, base, do, args
    kernels = (wa.WINDOW_ATTENTION_FWD, wa.WINDOW_ATTENTION_BWD, wa.WINDOW_ATTENTION_WGRAD)
    base, do, heads, _ = operands(2, wa.MAX_TOKENS + 1, 64)
    leaf = base[0].clone().requires_grad_()
    before = [k.launches for k in kernels]
    out = wa.windowed_attention_proj(leaf, *base[1:], heads)
    out.backward(do)
    torch.cuda.synchronize()
    check([k.launches for k in kernels] == before, "V = 513 launched a K8 kernel")
    with torch.no_grad():
        ref = wa.window_attention_plain(base[0], *base[1:], heads, None, -100.0, scale)
    check(torch.equal(out.detach(), ref), "V = 513 did not take the plain version")
    refusals = 0
    small, _, _, _ = operands(4, 16, 96)
    for bad in (lambda: wa.window_attention_fwd(*[t.cpu() for t in small], 3),
                lambda: wa.window_attention_fwd(small[0][:, :0].contiguous(), *small[1:5],
                                                small[5][:, :0, :0].contiguous(), 3),
                lambda: wa.window_attention_fwd(*small, 2)):
        try:
            bad()
        except ValueError:
            refusals += 1
    check(refusals == 3, "K8 took a CPU tensor, V = 0 or a head dim of 48")
    print("phase 42 K8: two launches of the general path bitwise equal; V = 513 took the plain "
          "version with no K8 launch; a CPU tensor, V = 0 and D = 48 refused", flush=True)
    del base, do, leaf, out, ref
    torch.cuda.empty_cache()

    bounds = emb_attn_k8_bounds()
    results = {"fwd": [], "bwd": [], "wgrad": []}
    for i, ((bw, v, c, rid, *_), b) in enumerate(zip(stages, bounds)):
        base, do, heads, _ = operands(bw, v, c)
        args = typed(base, heads, None if rid is None else rid.to(dev), torch.bfloat16)
        do = do.bfloat16()
        n_plain = min(bw, K8_PLAIN_WINDOWS)
        parts = [(args[0][j:j + n_plain], *args[1:]) for j in range(0, bw, n_plain)]
        dparts = [do[j:j + n_plain] for j in range(0, bw, n_plain)]
        with torch.no_grad():
            f_ms = median_ms(torch, lambda: wa.window_attention_fwd(*args), warmup=1, reps=3)
            pf_ms = median_ms(torch, lambda: [wa.window_attention_plain(*a) for a in parts],
                              warmup=1, reps=3)
        streams = wa.window_attention_bwd_streams(do, *args)
        b_ms = median_ms(torch, lambda: wa.window_attention_bwd_streams(do, *args), warmup=1,
                         reps=3)
        w_ms = median_ms(torch, lambda: wa.window_attention_wgrad(args[0], streams[1],
                                                                 streams[2], do),
                         warmup=1, reps=3)
        del streams
        pb_ms = median_ms(torch, lambda: [wa.window_attention_bwd_plain(g, *a)
                                          for g, a in zip(dparts, parts)], warmup=1, reps=3)
        share = b["bwd"][0] / (b["bwd"][0] + b["wgrad"][0])
        results["fwd"].append((worst[i]["fwd"], f_ms, pf_ms))
        results["bwd"].append((worst[i]["bwd"], b_ms, share * pb_ms))
        results["wgrad"].append((worst[i]["wgrad"], w_ms, (1 - share) * pb_ms))
        print(f"phase 42 K8 times emb_attn stage {i} BW={bw} V={v} C={c} bf16 rid="
              f"{rid is not None}: fwd {f_ms:.3f} ms (bound {b['fwd'][0]:.3f}, plain "
              f"{pf_ms:.3f} in {len(parts)} slice(s)); bwd {b_ms:.3f} ms (bound "
              f"{b['bwd'][0]:.3f}); wgrad {w_ms:.3f} ms (bound {b['wgrad'][0]:.3f}); plain VJP "
              f"{pb_ms:.3f} ms in {len(parts)} slice(s)", flush=True)
        del base, args, do, parts, dparts
        torch.cuda.empty_cache()
    return results


def phase_k2_prime(torch, fm, dev):
    """K2', the MLP without LN or residual, behind MLPBlock (eval, so its
    kernel path) at ViT-small widths on vit16k's tokens at batch 2
    (K2P_SHAPE): the forward and the gradients of x and the four parameters
    on the card against fused_mlp_plain and its VJP, fp32 and bf16; each K2'
    kernel launched once per pass and no K2 kernel; two launches bitwise
    equal; then the times of the kernels and the plain version in bf16.
    Returns ({"fwd" | "bwd": (worst bf16 abs err, ms, plain ms) per call},
    the phase's launches by symbol)."""
    from long_context_biomedical_imaging_tpu_torch.models import MLPBlock, init_weights

    n, c, h = K2P_SHAPE
    gen = torch.Generator().manual_seed(46)
    block = init_weights(MLPBlock(c, h), gen).to(dev).eval()
    params = [block.fc1_kernel, block.fc1_bias, block.fc2_kernel, block.fc2_bias]
    x32 = torch.randn(n, c, generator=gen).to(dev)
    do32 = torch.randn(n, c, generator=gen).to(dev)
    kernels = all_kernels()
    for kernel in kernels:
        kernel.launches = 0
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        block.zero_grad(set_to_none=True)
        x = x32.to(dtype, copy=True).requires_grad_()
        out = block(x)
        out.backward(do32.to(dtype))
        torch.cuda.synchronize()
        plain = [p.detach() for p in params]
        with torch.no_grad():
            ref = fm.fused_mlp_plain(x.detach(), *plain)
        err, mag, ok = compare(torch, out.detach(), ref, dname)
        check(ok, f"K2' fwd disagrees with its plain version, {dname}: {err} > {TOL[dname]} * "
                  f"{mag}")
        refs = fm.fused_mlp_bwd_plain(do32.to(dtype), x.detach(), *plain)
        gerr, grel, gok = compare_grads(torch, [x.grad] + [p.grad for p in params], refs, dname)
        check(gok, f"K2' bwd disagrees with its plain VJP, {dname}: {grel} > {GRAD_TOL[dname]}")
        worst[dname] = (err, gerr)
        print(f"phase 46 K2' MLPBlock N={n} C={c} H={h} {dname}: fwd max_abs_err={err:.3e} "
              f"max|out|={mag:.3e}; every gradient max_abs_err={gerr:.3e} max_rel_err="
              f"{grel:.3e} ok", flush=True)
        del x, out, ref, refs
    launches = {kernel.symbol: kernel.launches for kernel in kernels}
    check_launches(kernels, launches, {22: 2, 23: 2}, "the K2' phase (MLPBlock, fp32 and bf16)")
    x, do = x32.bfloat16(), do32.bfloat16()
    w = [params[0].detach().bfloat16(), params[1].detach(), params[2].detach().bfloat16(),
         params[3].detach()]
    runs = [(fm.fused_mlp_fwd(x, *w), *fm.fused_mlp_bwd(do, x, *w)) for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)), "K2' launches are not bitwise repeatable")
    del runs
    with torch.no_grad():
        f_ms = median_ms(torch, lambda: fm.fused_mlp_fwd(x, *w), warmup=2, reps=7)
        pf_ms = median_ms(torch, lambda: fm.fused_mlp_plain(x, *w), warmup=1, reps=5)
    b_ms = median_ms(torch, lambda: fm.fused_mlp_bwd(do, x, *w), warmup=2, reps=7)
    pb_ms = median_ms(torch, lambda: fm.fused_mlp_bwd_plain(do, x, *w), warmup=1, reps=5)
    b = k2p_bounds()
    print(f"phase 46 K2' times N={n} C={c} H={h} bf16: fwd {f_ms:.3f} ms (bound "
          f"{b['fwd'][0]:.3f}, plain {pf_ms:.3f}); bwd {b_ms:.3f} ms (bound {b['bwd'][0]:.3f}, "
          f"plain VJP {pb_ms:.3f}); two launches bitwise equal", flush=True)
    return ({"fwd": (worst["bfloat16"][0], f_ms, pf_ms),
             "bwd": (worst["bfloat16"][1], b_ms, pb_ms)}, launches)


def micro_k9_shapes(batch, height=1024):
    """(BW, L, d, depth) of each micro_w7 stage whose Mamba call the gate
    routes to K9, for a batch of images of height x height: the gate of the
    port's models/mamba.py, the JAX package's."""
    from long_context_biomedical_imaging_tpu_torch.models.mamba import _window_scan_supported

    out = []
    for c, grid, depth in STAGES:
        g = -(-(grid * height // 1024) // 7) * 7
        bw = batch * (g // 7) ** 2
        if _window_scan_supported(49, K9_N, c // 2, batch=bw):
            out.append((bw, 49, c // 2, depth))
    return out


def emb_attn_stages(batch=BATCH, volume=EMB_VOLUME):
    """Each emb_attn stage's K8 call at the given batch and (T, H, W) volume,
    from the port's own stage grids (models/swin.py stage_grids) and window
    shrink (ops/window.py get_window_size): [(BW windows, V tokens, C, the
    odd blocks' (nW, V) region ids or None, depth, token grid, window)]."""
    from long_context_biomedical_imaging_tpu_torch.models.swin import stage_grids
    from long_context_biomedical_imaging_tpu_torch.ops.window import (compute_shift_regions,
                                                                      get_window_size)

    window = (8, 8, 8)
    grids = stage_grids(tuple(n // 2 for n in volume), len(STAGES), 3)
    out = []
    for grid, (c, _, depth) in zip(grids, STAGES):
        win, shift = get_window_size(grid, window, tuple(w // 2 for w in window))
        dims = tuple(-(-n // w) * w for n, w in zip(grid, win))
        n_win = math.prod(d // w for d, w in zip(dims, win))
        rid = compute_shift_regions(dims, win, shift) if any(shift) else None
        out.append((batch * n_win, math.prod(win), c, rid, depth, grid, win))
    return out


def phase_k9(torch, ssw, dev):
    """K9, the windowed scan of the micro_w7 path. selective_scan_window on
    the card (one forward and one backward launch) against its plain version
    (selective_scan_cm) and its VJP at micro_w7's K9 stage shapes and
    K9_EXTRA, fp32 and bf16: y and the gradients of u, delta, A, B, C, D and
    delta_bias at K7_TOL (dA, dD and ddelta_bias sum over up to a million
    tokens), two runs bitwise equal. Then each kernel against its plain
    pass on the same fp32 operands, the refusals, and the times at the stage
    shapes with bf16 inputs (the kernels on the fp32 operands the path casts
    them to). Returns {"fwd" | "bwd": [(max abs err of the kernel against
    its plain pass, fp32, kernel ms, plain ms) per stage]}: the plain fwd is
    the plain version's forward, the plain bwd its VJP less its forward."""
    gen = torch.Generator().manual_seed(37)
    kernels = (ssw.WINDOW_SCAN_FWD, ssw.WINDOW_SCAN_BWD)
    names = ("y", "du", "ddelta", "dA", "dB", "dC", "dD", "ddelta_bias")
    stages = [(bw, length, d) for bw, length, d, _ in micro_k9_shapes(BATCH)]
    check(stages == [(21904, 49, 48), (5476, 49, 96)], f"micro_w7's K9 stages {stages}")
    for shape in stages + K9_EXTRA:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            args = _k7_inputs(torch, gen, shape, dtype, dev)
            before = [k.launches for k in kernels]
            got = _k7_vjp(torch, ssw.selective_scan_window, args)
            again = _k7_vjp(torch, ssw.selective_scan_window, args)
            torch.cuda.synchronize()
            ran = [k.launches - b for k, b in zip(kernels, before)]
            check(ran == [2, 2], f"K9 {shape} {dname}: launches {ran}, expected [2, 2]")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K9 {shape} {dname}: two runs gave different bits")
            ref = _k7_vjp(torch, ssw.selective_scan_window_plain, args)
            errs, ok = {}, True
            for i, (name, a, r) in enumerate(zip(names, got, ref)):
                ok = ok and a.dtype == r.dtype and a.shape == r.shape
                a, r = a.float(), r.float()
                errs[name] = (a - r).abs().max().item()
                ok = (ok and bool(torch.isfinite(a).all().item())
                      and errs[name] <= K7_TOL[dname][i > 0] * r.abs().max().item())
            print(f"phase 37 K9 BW,L,d={shape} {dname}: max_abs_err "
                  + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
                  + " (max|y| {:.3e}, max|dA| {:.3e}); two runs bitwise equal".format(
                      ref[0].float().abs().max().item(), ref[3].abs().max().item())
                  + (" ok" if ok else " MISMATCH"), flush=True)
            check(ok, f"K9 disagrees with its plain version at {shape} {dname}: {errs}")
            del args, got, again, ref
            torch.cuda.empty_cache()

    worst = []
    for shape in stages + K9_EXTRA:
        u, delta, a, bm, cm, _, _, g = _k7_inputs(torch, gen, shape, torch.float32, dev)
        at = a.t().contiguous()
        pairs = {"fwd": ([ssw.window_scan_fwd(u, delta, at, bm, cm)],
                         [ssw.window_scan_fwd_plain(u, delta, at, bm, cm)]),
                 "bwd": (ssw.window_scan_bwd(u, delta, at, bm, cm, g),
                         ssw.window_scan_bwd_plain(u, delta, at, bm, cm, g))}
        torch.cuda.synchronize()
        errs, ok = {}, True
        for key, (got, ref) in pairs.items():
            e = [(x - r).abs().max().item() for x, r in zip(got, ref)]
            ok = ok and all(bool(torch.isfinite(x).all().item())
                            and v <= K7_PASS_TOL * r.abs().max().item()
                            for x, r, v in zip(got, ref, e))
            errs[key] = max(e)
        print(f"phase 37 K9 kernels against their plain passes, BW,L,d={shape} float32: "
              f"max_abs_err fwd (y) {errs['fwd']:.3e}, bwd (du, ddelta, dat, dB, dC) "
              f"{errs['bwd']:.3e}" + (" ok" if ok else " MISMATCH"), flush=True)
        check(ok, f"a K9 kernel disagrees with its plain pass at {shape}: {errs}")
        if shape in stages:
            worst.append(errs)
        del u, delta, a, bm, cm, g, at, pairs
        torch.cuda.empty_cache()

    u, delta, a, bm, cm, _, _, g = _k7_inputs(torch, gen, (3001, 49, 96), torch.float32, dev)
    wide = torch.zeros(4, 49, 1040, device=dev)
    long_seq, long_bc = torch.zeros(4, 65, 96, device=dev), torch.zeros(4, 65, K9_N, device=dev)
    for fn, what in ((lambda: ssw.window_scan_fwd(u.cpu(), delta.cpu(), a.t().contiguous().cpu(),
                                                  bm.cpu(), cm.cpu()), "a CPU tensor"),
                     (lambda: ssw.selective_scan_window(long_seq, long_seq, a, long_bc, long_bc),
                      "L = 65"),
                     (lambda: ssw.window_scan_fwd(wide, wide, torch.zeros(K9_N, 1040, device=dev),
                                                  bm[:4], cm[:4]), "N d = 8320")):
        try:
            fn()
        except ValueError:
            continue
        raise SmokeFailure(f"K9 took {what}")
    print("phase 37 K9 refusals: a CPU tensor, L = 65, N d = 8320: refused", flush=True)
    del u, delta, a, bm, cm, g, wide, long_seq, long_bc

    out = {"fwd": [], "bwd": []}
    for (bw, length, d), errs in zip(stages, worst):
        args = _k7_inputs(torch, gen, (bw, length, d), torch.bfloat16, dev)
        u, delta, a, bm, cm, dskip, dbias, g = args
        u32, d32, at = u.float(), (delta.float() + dbias).contiguous(), a.t().contiguous()
        b32, c32, g32 = bm.float(), cm.float(), g.float()
        k_fwd = median_ms(torch, lambda: ssw.window_scan_fwd(u32, d32, at, b32, c32))
        k_bwd = median_ms(torch, lambda: ssw.window_scan_bwd(u32, d32, at, b32, c32, g32))
        with torch.no_grad():
            p_fwd = median_ms(torch, lambda: ssw.selective_scan_window_plain(*args[:7]),
                              warmup=1, reps=5)
        p_vjp = median_ms(torch, lambda: _k7_vjp(torch, ssw.selective_scan_window_plain, args),
                          warmup=1, reps=5)
        op_ms = median_ms(torch, lambda: _k7_vjp(torch, ssw.selective_scan_window, args))
        bounds = k9_bounds()[stages.index((bw, length, d))]
        print(f"phase 37 K9 times at BW,L,d={(bw, length, d)}, N={K9_N}, bf16 inputs, fp32 "
              f"operands, ms per call: kernel fwd {k_fwd:.3f}, bwd {k_bwd:.3f}; the whole op "
              f"(casts, kernels, D skip) forward and backward {op_ms:.3f}; plain "
              f"(selective_scan_cm) fwd {p_fwd:.3f}, VJP {p_vjp:.3f}; bounds fwd "
              f"{bounds['fwd'][0]:.4f} ({bounds['fwd'][1]}), bwd {bounds['bwd'][0]:.4f} "
              f"({bounds['bwd'][1]})", flush=True)
        out["fwd"].append((errs["fwd"], k_fwd, p_fwd))
        out["bwd"].append((errs["bwd"], k_bwd, max(p_vjp - p_fwd, 0.0)))
        del args, u, delta, a, bm, cm, dskip, dbias, g, u32, d32, at, b32, c32, g32
        torch.cuda.empty_cache()
    return out


def phase_config_slice(torch, tmp, flags, name, phase, expected, batch=H65_BATCH,
                       subjects=(3, 2, 2), enhance=False, shape=(1024, 1024)):
    """run_torch.main trains a configuration at the given batch size on
    synthetic images (or volumes) of the stored ``shape`` on the card (the
    vit65k_hyena, vit65k_mamba, ptx_attn, micro_w7 or emb_attn path;
    subjects: train, val and test images;
    ``enhance``: enhancement pairs and loss, SSIM and PSNR, else labels and
    the classification metrics), then an inference-only run reloads its best
    checkpoint. expected(forward batches, train steps) gives each kernel's
    launch count by its index in all_kernels()."""
    import numpy as np
    import yaml

    import run_torch

    (n_train, n_val, n_test), epochs = subjects, 2
    write_dataset(tmp, shape, n_train, n_val, n_test, targets=enhance)
    metric_names = {"loss", "ssim", "psnr"} if enhance else {"loss", "acc_1", "auroc", "f1"}
    steps = epochs * min(3, math.ceil(n_train / batch))      # --debug: 3 per epoch
    val_batches = min(3, math.ceil(n_val / batch))
    test_batches = min(3, math.ceil(n_test / batch))
    eval_batches = epochs * val_batches + val_batches + test_batches
    run = f"chip_smoke_{name}"
    run_dir = os.path.join(tmp, "logs", run)
    argv = flags + [f"--data_dir={tmp}/data", f"--split_csv_path={tmp}/split.csv",
                    "--device=cuda", "--debug", f"--num_epochs={epochs}", f"--log_dir={tmp}/logs",
                    f"--run_name={run}"]
    check("--train_model=True" in argv, f"the {name} flags no longer train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = all_kernels()
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    rc = run_torch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kernel.symbol: kernel.launches for kernel in kernels}
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"run_torch.main returned {rc}")
    check_launches(kernels, launches, expected(steps + eval_batches, steps),
                   f"the {name} train slice ({steps} train steps, {eval_batches} eval batches)")
    for ckpt in ("model_last_epoch", "model_epoch_0", "model_best_checkpoint"):
        path = os.path.join(run_dir, "models", ckpt)
        check(os.path.exists(os.path.join(path, "state.pt")), f"{path} missing")
    meta = yaml.safe_load(open(os.path.join(run_dir, "models", "model_last_epoch", "meta.yaml")))
    check(meta["step"] == steps and meta["epoch"] == epochs - 1,
          f"model_last_epoch meta: step {meta['step']} epoch {meta['epoch']}")
    log = open(os.path.join(run_dir, "run.log")).read()
    trained = re.findall(r"epoch (\d+) train: (\d+) steps, (\d+) samples in ([\d.]+) s", log)
    check(len(trained) == epochs, f"expected {epochs} train epoch lines, got {trained}")
    losses = [float(v) for v in re.findall(r"train: \{'loss': ([-\d.e+naninf]+)", log)]
    check(len(losses) == epochs and all(np.isfinite(losses)), f"train losses {losses}")
    metrics = {}
    for split in ("val", "test"):
        path = os.path.join(run_dir, f"{split}_metrics.txt")
        check(os.path.exists(path), f"{path} missing")
        m = {k: float(v) for k, v in (ln.split(": ") for ln in open(path).read().split("\n") if ln)}
        check(set(m) == metric_names and all(np.isfinite(list(m.values()))),
              f"{split} metrics {m}")
        metrics[split] = m
    train_images = sum(int(n) for _, _, n, _ in trained)
    train_seconds = sum(float(sec) for _, _, _, sec in trained)
    print(f"phase {phase} {name} train slice: run_torch.main {name} training on the card "
          f"in {wall:.1f} s; {steps} train steps over {epochs} epochs, {train_images} images in "
          f"{train_seconds:.3f} s = {train_images / train_seconds:.3f} images/s (first steps "
          f"and loading included); train losses {losses}; peak memory {peak / 2**30:.2f} GiB; "
          f"launches {launches}; val {metrics['val']}; test {metrics['test']}", flush=True)

    for kernel in kernels:
        kernel.launches = 0
    rc = run_torch.main(["--inference_only=True", f"--inference_dir={run_dir}",
                         f"--inference_log_dir={tmp}/logs",
                         f"--inference_run_name={run}_inference"])
    check(rc == 0, f"inference-only run returned {rc}")
    inference = {kernel.symbol: kernel.launches for kernel in kernels}
    check_launches(kernels, inference, expected(val_batches + test_batches, 0),
                   f"the {name} inference-only run")
    path = os.path.join(tmp, "logs", f"{run}_inference", "test_metrics.txt")
    check(os.path.exists(path), f"{path} missing")
    test = {k: float(v) for k, v in (ln.split(": ") for ln in open(path).read().split("\n") if ln)}
    check(test == metrics["test"], f"inference-only test metrics {test} != {metrics['test']}")
    print(f"phase {phase} inference-only: reloaded {run_dir}/models/model_best_checkpoint; test "
          f"{test} (the training run's own); launches {inference}", flush=True)
    return launches


def phase_micro_shipped(torch, tmp):
    """micro as projects/run_micro.sh ships it (window 4: 16-token windows):
    run_torch.main trains one step at batch 4 on synthetic 1024x1024x1
    enhancement pairs and evaluates; K4 in all 12 blocks of every forward
    batch and train step, K9 never. Returns (train seconds of the step, eval
    ms per batch), from run.log (the first step and batch, so with their
    one-time costs)."""
    import numpy as np

    import run_torch

    write_dataset(tmp, (1024, 1024), BATCH, BATCH, BATCH, targets=True)
    run_dir = os.path.join(tmp, "logs", "chip_smoke_micro")
    argv = micro_flags() + [f"--data_dir={tmp}/data", f"--split_csv_path={tmp}/split.csv",
                            "--device=cuda", "--num_epochs=1", f"--log_dir={tmp}/logs",
                            "--run_name=chip_smoke_micro"]
    check("--Swin.window_size" in argv and argv[argv.index("--Swin.window_size") + 1] == "4",
          "projects/run_micro.sh no longer ships window 4")
    kernels = all_kernels()
    for kernel in kernels:
        kernel.launches = 0
    rc = run_torch.main(argv)
    torch.cuda.synchronize()
    check(rc == 0, f"run_torch.main returned {rc}")
    launches = {kernel.symbol: kernel.launches for kernel in kernels}
    log = open(os.path.join(run_dir, "run.log")).read()
    trained = re.findall(r"epoch 0 train: (\d+) steps, (\d+) samples in ([\d.]+) s", log)
    timed = re.findall(r"(\w+) forward: (\d+) batches of (\d+) in ([\d.]+) s", log)
    check(len(trained) == 1 and trained[0][0] == "1", f"train lines {trained}")
    batches = sum(int(b) for _, b, _, _ in timed)
    check_launches(kernels, launches, {1: 12 * (1 + batches), 3: 12, 7: 12 * (1 + batches),
                                       8: 12}, "the shipped micro run")
    m = {k: float(v) for k, v in (ln.split(": ") for ln in
                                  open(os.path.join(run_dir, "test_metrics.txt")).read()
                                  .split("\n") if ln)}
    check(set(m) == {"loss", "ssim", "psnr"} and all(np.isfinite(list(m.values()))),
          f"test metrics {m}")
    step_s = float(trained[0][2])
    eval_ms = 1e3 * sum(float(sec) for *_, sec in timed) / batches
    print(f"phase 41 micro as shipped (window 4): run_torch.main trained 1 step of batch "
          f"{BATCH} in {step_s:.3f} s and evaluated {batches} batches at {eval_ms:.2f} ms each "
          f"(first step and batches, from run.log); K4 fwd in 12 blocks of each of "
          f"{1 + batches} forward batches, K4 bwd in 12, K9 never; test {m}; launches "
          f"{launches}", flush=True)
    return step_s, eval_ms


def long_vit_label(height, width):
    """phase_config_grads' label for the 65,536-token ViT configurations."""
    return (f"full-width ViT-small + ViTLinear, batch {H65_BATCH} of {height}x{width} "
            f"({height * width // 16:,} tokens)")


def phase_config_grads(torch, dev, flags, size, phase, name, path_kernels, floor, label,
                       batch=H65_BATCH, time_=1):
    """One train step's gradients of a full-width configuration at the given
    batch size on images cut to size (H, W) (volumes of time_ slices in
    3D), so that its kernels still run
    (label describes the model and its input). Weights and images from the
    seed ``phase``, on the card
    against the host, fp32 and bf16, per parameter (max|err| /
    max|reference|), as phase 23 holds vit16k: fp32 within MODEL_GRAD_TOL;
    bf16 (AMP) against the card's fp32 gradients, at most BF16_GRAD_RATIO
    times the host's distance plus floor. path_kernels: {index in
    all_kernels(): launches per gradient on the card}."""
    from torch.func import functional_call

    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import amp_params

    height, width = size
    argv = ([a for a in flags if a != "--use_amp"]
            + [f"--height={height}", f"--width={width}", f"--time={time_}", f"--seed={phase}"])
    x = torch.randn(batch, time_, height, width, 1,
                    generator=torch.Generator().manual_seed(phase))
    y = torch.arange(batch) % 2
    kernels = [all_kernels()[i] for i in path_kernels]

    def grads(model, amp, device):
        model.to(device).zero_grad(set_to_none=True)
        before = [k.launches for k in kernels]
        out = functional_call(model, amp_params(model, amp), (x.to(device),)).float()
        cross_entropy_loss(out, y.to(device)).backward()
        ran = [k.launches - b for k, b in zip(kernels, before)]
        want = list(path_kernels.values()) if device != "cpu" else [0] * len(kernels)
        check(ran == want, f"{name} kernel launches {ran} on {device}, expected {want}")
        return {k: p.grad.detach().cpu() for k, p in model.named_parameters()}

    def errors(got, ref, dname):
        errs = {}
        for pname, g in got.items():
            check(bool(torch.isfinite(g).all()), f"{dname}: gradient of {pname} not finite")
            check(g.abs().max().item() > 0, f"{dname}: gradient of {pname} is all zero")
            errs[pname] = ((g - ref[pname]).abs().max().item()
                           / max(ref[pname].abs().max().item(), 1e-30))
        return errs

    model = build_model(check_args(parse_config(argv)))
    amp_model = build_model(check_args(parse_config(argv + ["--use_amp"])))
    amp_model.load_state_dict(model.state_dict())
    host32 = grads(model, False, "cpu")
    host16 = grads(amp_model, True, "cpu")
    card32 = grads(model, False, dev)
    card16 = grads(amp_model, True, dev)
    e32 = errors(card32, host32, "float32")
    at = max(e32, key=e32.get)
    print(f"phase {phase} {name} model gradients: {label}, float32, seed {phase}: "
          f"{len(card32)} parameters, every card gradient finite and non-zero; card vs host "
          f"worst max|err| / max|host grad| {e32[at]:.3e} ({at})", flush=True)
    check(e32[at] <= MODEL_GRAD_TOL["float32"],
          f"float32 {name} model gradients: {at} off by {e32[at]} of its max")
    card_e = errors(card16, card32, "bfloat16")
    host_e = errors(host16, card32, "bfloat16 host")
    limit = {k: BF16_GRAD_RATIO * host_e[k] + floor for k in card_e}
    tight = max(card_e, key=lambda k: card_e[k] / limit[k])
    ratio = max(card_e, key=lambda k: card_e[k] / max(host_e[k], 1e-30))
    worst_card, worst_host = max(card_e, key=card_e.get), max(host_e, key=host_e.get)
    print(f"phase {phase} {name} model gradients, bfloat16: every card gradient finite and "
          f"non-zero; max|err| / max|fp32 card grad|, worst: card {card_e[worst_card]:.3e} "
          f"({worst_card}), host {host_e[worst_host]:.3e} ({worst_host}); per parameter, nearest "
          f"its limit {tight}: card {card_e[tight]:.3e}, host {host_e[tight]:.3e}, limit "
          f"{limit[tight]:.3e}; largest card/host ratio {ratio}: {card_e[ratio]:.3e} / "
          f"{host_e[ratio]:.3e}", flush=True)
    check(card_e[tight] <= limit[tight],
          f"bfloat16 {name} model gradients: the card strays {card_e[tight]} from fp32 at "
          f"{tight}, more than {BF16_GRAD_RATIO} x the host's {host_e[tight]} + {floor}")
    return e32, card_e, host_e


def phase_config_throughput(torch, dev, flags, phase, name, batch=H65_BATCH,
                            volume=(1, 1024, 1024)):
    """The train step and eval forward of a configuration at the given batch
    size on (T, H, W) ``volume`` inputs of one channel, bf16, weights and data
    from the seed ``phase``; the configuration's own loss on labels of 2
    classes, or on enhancement targets for an enhance task."""
    from long_context_biomedical_imaging_tpu_torch.losses import get_loss_func
    from long_context_biomedical_imaging_tpu_torch.metrics.device import make_train_metric_fn
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.optim import OptimManager
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import (amp_params, make_eval_step,
                                                                   make_train_step)

    cfg = check_args(parse_config(flags))
    model = build_model(cfg).to(dev)
    loss_func = get_loss_func(cfg.loss_func)
    gen = torch.Generator().manual_seed(phase)
    x = torch.randn(batch, *volume, 1, generator=gen)
    size = "x".join(str(n) for n in volume[1:] + volume[:1] if n > 1)
    if cfg.task_type == "enhance":
        y = (x - 0.3 * torch.randn(x.shape, generator=gen)).to(dev)
    else:
        y = (torch.arange(batch) % 2).to(dev)
    x = x.to(dev)
    step = make_eval_step(model.eval(), loss_func)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eval_ms = median_ms(torch, lambda: step(amp_params(model, True), x, y, batch), warmup=2,
                        reps=5)
    eval_peak = torch.cuda.max_memory_allocated()
    print(f"phase {phase} {name} eval forward, batch {batch} of {size}, bf16: "
          f"{eval_ms:.2f} ms/batch = {batch * 1000 / eval_ms:.3f} images/s (median of 5); "
          f"peak memory {eval_peak / 2**30:.2f} GiB", flush=True)
    profile_step(torch, lambda: step(amp_params(model, True), x, y, batch),
                 f"phase {phase} {name} eval profile")

    model.train()
    optim = OptimManager(cfg, num_train_samples=1000)
    optim.build(model.parameters())
    _, metrics_fn = make_train_metric_fn(cfg)
    train = make_train_step(model, loss_func, optim, use_amp=True, metrics_fn=metrics_fn)
    lr = cfg.optim.lr
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(torch, lambda: train([(x, y)], lr, batch), warmup=2, reps=5)
    peak = torch.cuda.max_memory_allocated()
    print(f"phase {phase} {name} train step (forward, backward, Adam), batch {batch} of "
          f"{size}, bf16: {ms:.2f} ms/step = {batch * 1000 / ms:.3f} images/s (median of "
          f"5 after 2 warm-ups); peak memory {peak / 2**30:.2f} GiB", flush=True)
    profile_step(torch, lambda: train([(x, y)], lr, batch), f"phase {phase} {name} profile")
    return ms, eval_ms


def profile_step(torch, fn, label):
    """Device time of one call by kernel, from torch.profiler: the CUDA
    kernel events alone. A CPU event (an aten op, an autograd Function's
    range) carries the device time of the kernels it launched as well, so
    counting it too would count those kernels twice."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    attr = "self_device_time_total"
    events = [e for e in prof.key_averages() if getattr(e, attr, 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(getattr(e, attr) for e in events)
    if total:
        top = sorted(events, key=lambda e: -getattr(e, attr))[:20]
        print(f"{label}: one step, device time {total / 1e3:.2f} ms; top: "
              + "; ".join(f"{e.key[:60]} {getattr(e, attr) / 1e3:.2f} ms "
                          f"({100 * getattr(e, attr) / total:.1f}%)" for e in top), flush=True)
    else:
        print(f"{label}: the profiler recorded no device time", flush=True)


def bound(ops_bf16, ops_fp32, nbytes):
    """(ms, 'operations' | 'bytes'): the least time of one call, the larger of
    its operations over the peaks of their types and its bytes over the
    memory rate."""
    t_ops = ops_bf16 / PEAK_BF16 + ops_fp32 / PEAK_FP32
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def k6_bounds():
    """K6 per call at the vit65k_hyena shape in bf16, {"conv" | "dk": (ms,
    bound_by)}. The yardstick of a transform is 2.5 n log2 n fp32 operations
    per real FFT of n points (n = 2L, the zero-padded length), over the fp32
    peak; the bytes are the inputs read once and the outputs written once.
    The convolution (and its du call) transforms the filter (D transforms)
    and the input (B D) and inverts (B D): u or g and y in bf16, k and bias
    in fp32. dk transforms g and u (2 B D) and inverts once per channel (D):
    g and u in bf16, dk in fp32."""
    b, d, length = K6_SHAPES[0]
    n = 2 * length
    fft = 2.5 * n * math.log2(n)
    return {"conv": bound(0, (d + 2 * b * d) * fft, 2 * 2 * b * d * length + 4 * d * (length + 1)),
            "dk": bound(0, (2 * b * d + d) * fft, 2 * 2 * b * d * length + 4 * d * length)}


def k7_bounds():
    """K7 per call at the vit65k_mamba shape, {"fwd_zero" | "fwd_y" |
    "carry_bwd" | "bwd": (ms, bound_by)}. Yardstick: the scan's fp32
    operations over 67 TFLOP/s, counted per (token, channel, state), an exp
    as one: the forward from zero carries 6 (exp, d A, a h + b, the d u B
    product, the decay product), seeded with y 7 (a h + b, C . h instead of
    the product); the carry backward 5 (exp, d A, dh + C g, a dh); the
    backward's function 20 (the h recompute 5; dh, its products with h_prev,
    B, d u and A, dA, dC, a dh 15); plus softplus (4) per (token, channel),
    and the backward's sigmoid and du, ddelta (6). Bytes: the fp32 inputs
    read once and outputs written once: the forward from zero carries u,
    delta, B and the carries out, seeded u, delta, B, C, the carries in and
    y (the seeded pass writes no carries: nothing reads them); the carry
    backward delta, g, C, dh0;
    the backward u, delta, g, B, C, h0, dht, du, ddelta, dB, dC, dA."""
    from long_context_biomedical_imaging_tpu_torch.ops.selective_scan_long import SEG

    b, length, d = K7_SHAPES[0]
    n = K7_N
    tokens, cells = b * length, b * length * d * n
    rows = b * -(-length // SEG)
    seq, state, carry = 4 * tokens * d, 4 * tokens * n, 4 * rows * n * d
    return {"fwd_zero": bound(0, 6 * cells + 4 * tokens * d, 2 * seq + state + 2 * carry),
            "fwd_y": bound(0, 7 * cells + 4 * tokens * d, 3 * seq + 2 * state + carry),
            "carry_bwd": bound(0, 5 * cells + 4 * tokens * d, 2 * seq + state + carry),
            "bwd": bound(0, 20 * cells + 10 * tokens * d,
                         5 * seq + 4 * state + 2 * carry + 4 * n * d)}


def k8_bounds(cases=None):
    """K8 per call at each stage in bf16, [{"fwd" | "bwd" | "wgrad": (ms,
    bound_by)} per case]; cases (BW windows, V tokens, C, rows of region
    ids), ptx_attn's stages when None (T = BW * V tokens, H = C / 32 heads).
    Products on the tensor cores: the forward's qkv
    and out projections 8TC^2 and its scores and p v 4TVC; the backward's
    qkv recompute 6TC^2, do 2TC^2, dx 6TC^2 and its six window products
    12TVC; the weight gradients x^T dqkv and o^T dout 8TC^2. fp32: about 6
    operations per score (bias, mask, max, exp2, sum, divide) forward, 12
    backward (recompute, delta, ds, the bias sums). Bytes, each read or
    written once: the forward x, out (bf16) and the weights; the backward x,
    dout, dx, dqkv, o (bf16), the weights and the fp32 bias, rel and region
    id gradients and inputs; the weight gradients x, dqkv, o, dout (bf16) and
    dWqkv, dWout in fp32."""
    if cases is None:
        cases = [(bw, 16, c, (grid // 4) ** 2) for bw, c, grid, _ in ATTN_STAGES]
    out = []
    for bw, v, c, rid_rows in cases:
        t, heads = bw * v, c // 32
        scores, small = t * v * heads, 4 * (4 * c + 2 * heads * v * v) + 4 * rid_rows * v
        w = 2 * 4 * c * c
        out.append({"fwd": bound(8 * t * c * c + 4 * t * v * c, 6 * scores, 4 * t * c + w + small),
                    "bwd": bound(14 * t * c * c + 12 * t * v * c, 12 * scores,
                                 14 * t * c + w + 2 * small),
                    "wgrad": bound(8 * t * c * c, 0, 12 * t * c + 4 * 4 * c * c)})
    return out


def emb_attn_k8_bounds():
    """K8 per call at each emb_attn stage (batch 4), as k8_bounds; the odd
    blocks' region ids counted."""
    return k8_bounds([(bw, v, c, 0 if rid is None else rid.shape[0])
                      for bw, v, c, rid, *_ in emb_attn_stages()])


def k2p_bounds():
    """K2' per call at K2P_SHAPE in bf16, {"fwd" | "bwd": (ms, bound_by)}:
    the forward's two products 4NCH, the backward's five (the hidden
    recomputed, dh, dW2, dW1, dx) 10NCH on the tensor cores; bytes x and the
    output (bf16) and the weights, the backward's x, dout, dx (bf16), the
    weights and their fp32 gradients."""
    n, c, h = K2P_SHAPE
    w = 2 * 2 * c * h
    return {"fwd": bound(4 * n * c * h, 0, 4 * n * c + w + 4 * (c + h)),
            "bwd": bound(10 * n * c * h, 0, 6 * n * c + w + 4 * (2 * c * h + c + h))}


def k9_bounds():
    """K9 per call at micro_w7's K9 stages (batch 4, 49-token windows),
    [{"fwd" | "bwd": (ms, bound_by)} per stage]. Yardstick: the scan's fp32
    operations over 67 TFLOP/s, counted per (token, channel, state), an exp
    as one: the forward 7 (exp, d A, a h + b with the d u B product, C . h),
    the backward's function 20 (the h recompute 5; dh, its products with
    h_prev, B, d u and A, dA, dC, a dh 15); plus softplus (4) per (token,
    channel) forward, and softplus, sigmoid, du and ddelta (10) backward.
    Bytes: the fp32 operands read once and outputs written once: the
    forward u, delta, y and B, C; the backward u, delta, g, du, ddelta and B,
    C, dB, dC; A^T (and dA)."""
    out = []
    for bw, length, d, _ in micro_k9_shapes(BATCH):
        tokens = bw * length
        cells = tokens * d * K9_N
        seq, state, at = 4 * tokens * d, 4 * tokens * K9_N, 4 * K9_N * d
        out.append({"fwd": bound(0, 7 * cells + 4 * tokens * d, 3 * seq + 2 * state + at),
                    "bwd": bound(0, 20 * cells + 10 * tokens * d, 5 * seq + 4 * state + 2 * at)})
    return out


def kernel_bounds():
    """Per kernel: (bound ms of one train step of its main path, bound_by),
    from the main path's bf16 shapes: ptx for K1 and K2 (T tokens, C
    channels per stage; K1 fwd 8TC^2 of products plus its fp32 convolutions,
    K1 bwd 22TC^2 plus three times those; K2 fwd 16NC^2, bwd 40NC^2), emb
    for K3 (the Toeplitz products 2 * BW * C * chunk^2 * n(n+1)/2), vessel
    for K4 (its stages 0-2), vit16k for K5 (12 layers), vit65k_hyena for K6
    (12 layers, the conv twice in each, forward and du; ``k6_bounds``),
    vit65k_mamba for K7 (12 layers, the forward twice in each; ``k7_bounds``),
    ptx_attn for K8 (its four stages; ``k8_bounds``) and emb_attn for K8's
    rows at its stages (``emb_attn_k8_bounds``), micro_w7 for K9 (its stages
    0-1; ``k9_bounds``); K2' per call at K2P_SHAPE (``k2p_bounds``), which no
    train path runs."""
    out = {}

    def add(name, depth, b):
        ms, by = b
        tot, votes = out.get(name, (0.0, {}))
        votes[by] = votes.get(by, 0.0) + depth * ms
        out[name] = (tot + depth * ms, votes)

    for c, grid, depth in STAGES:
        t = BATCH * grid * grid
        v, k = 16, 5
        conv = 2 * k * 3 * c * t + t * c * (v + 1) + 3 * t * c
        w = 2 * (4 * c * c)
        add("hyena_window_fwd", depth, bound(8 * t * c * c, conv, 4 * t * c + w))
        add("hyena_window_bwd", depth, bound(22 * t * c * c, 3 * conv, 6 * t * c + w + 16 * c * c))
        w2 = 2 * (8 * c * c)
        add("fused_ln_mlp_fwd", depth, bound(16 * t * c * c, 0, 4 * t * c + w2))
        add("fused_ln_mlp_bwd", depth, bound(40 * t * c * c, 0, 6 * t * c + w2 + 32 * c * c))
    for c, bw, depth in EMB_K3_STAGES:
        v, chunk = 512, 128
        n = v // chunk
        t = bw * v
        toeplitz = 2 * bw * c * chunk * chunk * n * (n + 1) // 2
        w = 2 * (4 * c * c + n * c * chunk * chunk)
        add("hyena_chunked_fwd", depth, bound(8 * t * c * c + toeplitz, 0, 4 * t * c + w))
        add("hyena_chunked_bwd", depth,
            bound(22 * t * c * c + 2 * toeplitz, 0, 10 * t * c + w + 16 * c * c))
        add("hyena_dm", depth, bound(toeplitz, 0, 4 * t * c + 4 * n * c * chunk * chunk))
    for c, bw, depth in VESSEL_K4_STAGES:
        # vessel K4 (T = BW * 64 tokens, Dh = C/2, R = ceil(C/16), N = 8):
        # products in_proj and out_proj 4TC^2, x_proj 2T Dh (R + 2N), dt_proj
        # 2T R Dh; fp32 LN, conv, SiLU and gates about 20TC, the scan and
        # softplus about (7N + 8) T Dh; the backward recomputes the forward
        # and does twice its products more (10TC^2 in all) and about twice its
        # fp32 work, and writes fp32 weight gradients
        t, dh, r, n = bw * 64, c // 2, -(-c // 16), 8
        prod = 4 * t * c * c + 2 * t * dh * (r + 2 * n) + 2 * t * r * dh
        f32 = 20 * t * c + (7 * n + 8) * t * dh
        w = 2 * (2 * c * c + dh * (r + 2 * n) + r * dh)
        add("mamba_window_fwd", depth, bound(prod, f32, 4 * t * c + w))
        add("mamba_window_bwd", depth, bound(prod + 6 * t * c * c + 4 * t * dh * (r + 2 * n)
                                             + 4 * t * r * dh, 3 * f32, 6 * t * c + 3 * w))
    # vit16k K5, per layer: BH head-batches of L tokens at D = 64; each product
    # 2 BH L^2 D, each pass of exp2 BH L^2 in fp32. The forward is 2 products
    # (q k^T, p v) and one exp2 pass. The backward's function is 5 products
    # (q k^T recomputed, do v^T, p^T do, ds^T q, ds k) and one exp2 pass,
    # split between its two kernels so that their bounds add up to it: dq
    # takes ds k, half of the shared q k^T and do v^T and half the exp2; dkv
    # the rest. Bytes: the bf16 (BH, L, D) tensors read and written once (the
    # forward q, k, v, o; the backward q, o, do, dq for dq and k, v, dk, dv for
    # dkv) and the fp32 (BH, L) lse
    bh, l = VIT_BH, VIT_L
    prod, ex, tile, lse = 2 * bh * l * l * 64, bh * l * l, 2 * bh * l * 64, 4 * bh * l
    add("flash_attention_fwd", VIT_LAYERS, bound(2 * prod, ex, 4 * tile + lse))
    add("flash_attention_dq", VIT_LAYERS, bound(2 * prod, ex / 2, 4 * tile + lse))
    add("flash_attention_dkv", VIT_LAYERS, bound(3 * prod, ex / 2, 4 * tile))
    k6 = k6_bounds()
    add("spectral_conv", 2 * VIT_LAYERS, k6["conv"])
    add("spectral_conv_dk", VIT_LAYERS, k6["dk"])
    for b, (_, _, _, depth) in zip(k8_bounds(), ATTN_STAGES):
        for key in ("fwd", "bwd", "wgrad"):
            add(f"window_attention_{key}", depth, b[key])
    k7 = k7_bounds()
    add("long_scan_fwd", VIT_LAYERS, k7["fwd_zero"])
    add("long_scan_fwd", VIT_LAYERS, k7["fwd_y"])
    add("long_scan_carry_bwd", VIT_LAYERS, k7["carry_bwd"])
    add("long_scan_bwd", VIT_LAYERS, k7["bwd"])
    for b, (*_, depth) in zip(k9_bounds(), micro_k9_shapes(BATCH)):
        add("window_scan_fwd", depth, b["fwd"])
        add("window_scan_bwd", depth, b["bwd"])
    for b, (*_, depth, _, _) in zip(emb_attn_k8_bounds(), emb_attn_stages()):
        for key in ("fwd", "bwd", "wgrad"):
            add(f"window_attention_{key}_emb_attn", depth, b[key])
    k2p = k2p_bounds()
    add("fused_mlp_fwd", 1, k2p["fwd"])
    add("fused_mlp_bwd", 1, k2p["bwd"])
    return {name: (ms, max(votes, key=votes.get)) for name, (ms, votes) in out.items()}


def run():
    if not os.path.isdir(os.path.join(REPO, PACKAGE)):
        raise SmokeFailure(f"{PACKAGE}/ is not beside {os.path.basename(__file__)}")
    sys.path.insert(0, REPO)
    import torch

    name = phase_device(torch)
    dev = torch.device("cuda", 0)
    from long_context_biomedical_imaging_tpu_torch.ops import fused_mlp, hyena_window

    phase_build()
    k1 = phase_k1(torch, hyena_window, dev)
    k2 = phase_k2(torch, fused_mlp, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_slice(torch, fused_mlp, hyena_window, os.path.join(tmp, "eval"))
        phase_model(torch, dev)
        phase_throughput(torch, dev)
        k2b = phase_k2_bwd(torch, fused_mlp, dev)
        k1b = phase_k1_bwd(torch, hyena_window, dev)
        launches = phase_train_slice(torch, fused_mlp, hyena_window, os.path.join(tmp, "train"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_model_grads(torch, dev)
    phase_train_throughput(torch, dev)
    k3 = phase_k3(torch, hyena_window, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_emb_")
    try:
        emb_launches = phase_emb_slice(torch, fused_mlp, hyena_window, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_emb_grads(torch, dev)
    phase_emb_throughput(torch, dev)
    from long_context_biomedical_imaging_tpu_torch.ops import mamba_window

    k4 = phase_k4(torch, mamba_window, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vessel_")
    try:
        vessel_launches = phase_vessel_slice(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_vessel_grads(torch, dev)
    phase_vessel_throughput(torch, dev)
    from long_context_biomedical_imaging_tpu_torch.ops import flash_attention

    k5 = phase_k5(torch, flash_attention, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vit_")
    try:
        vit_launches = phase_vit_slice(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_vit_grads(torch, dev)
    phase_vit_throughput(torch, dev)
    from long_context_biomedical_imaging_tpu_torch.ops import selective_scan_long, spectral_conv

    k6 = phase_k6(torch, spectral_conv, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_h65_")
    try:
        h65_launches = phase_config_slice(
            torch, tmp, vit65k_hyena_flags(), "vit65k_hyena", 26,
            lambda forward, steps: {1: VIT_LAYERS * forward, 3: VIT_LAYERS * steps,
                                    12: VIT_LAYERS * (forward + steps), 13: VIT_LAYERS * steps})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_config_grads(torch, dev, vit65k_hyena_flags(), (256, 512), 27, "vit65k_hyena",
                       {12: 2 * VIT_LAYERS, 13: VIT_LAYERS}, H65_BF16_GRAD_FLOOR,
                       long_vit_label(256, 512))
    phase_config_throughput(torch, dev, vit65k_hyena_flags(), 28, "vit65k_hyena")
    k7 = phase_k7(torch, selective_scan_long, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_m65_")
    try:
        m65_launches = phase_config_slice(
            torch, tmp, vit65k_mamba_flags(), "vit65k_mamba", 30,
            lambda forward, steps: {1: VIT_LAYERS * forward, 3: VIT_LAYERS * steps,
                                    14: 2 * VIT_LAYERS * forward, 15: VIT_LAYERS * steps,
                                    16: VIT_LAYERS * steps})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_config_grads(torch, dev, vit65k_mamba_flags(), (128, 256), 31, "vit65k_mamba",
                       {14: 2 * VIT_LAYERS, 15: VIT_LAYERS, 16: VIT_LAYERS},
                       M65_BF16_GRAD_FLOOR, long_vit_label(128, 256))
    phase_config_throughput(torch, dev, vit65k_mamba_flags(), 32, "vit65k_mamba")
    from long_context_biomedical_imaging_tpu_torch.ops import window_attention

    k8 = phase_k8(torch, window_attention, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_attn_")
    try:
        attn_launches = phase_config_slice(
            torch, tmp, ptx_attn_flags(), "ptx_attn", 34,
            lambda forward, steps: {1: ATTN_BLOCKS * forward, 3: ATTN_BLOCKS * steps,
                                    17: ATTN_BLOCKS * forward, 18: ATTN_BLOCKS * steps,
                                    19: ATTN_BLOCKS * steps},
            batch=BATCH, subjects=(12, 6, 6))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_config_grads(torch, dev, ptx_attn_flags(), (256, 256), 35, "ptx_attn",
                       {17: ATTN_BLOCKS, 18: ATTN_BLOCKS, 19: ATTN_BLOCKS}, ATTN_BF16_GRAD_FLOOR,
                       f"full-width Swin-tiny + SwinLinear (window attention), batch "
                       f"{ATTN_GRAD_BATCH} of 256x256", batch=ATTN_GRAD_BATCH)
    phase_config_throughput(torch, dev, ptx_attn_flags(), 36, "ptx_attn", batch=BATCH)
    from long_context_biomedical_imaging_tpu_torch.ops import selective_scan_window

    k9 = phase_k9(torch, selective_scan_window, dev)
    # every loader batch is padded to BATCH, so each forward batch runs K9 in
    # the blocks whose call the gate gives it at that batch (stages 0-1)
    k9_blocks = sum(depth for *_, depth in micro_k9_shapes(BATCH))
    check(k9_blocks == 4, f"micro_w7 routes {k9_blocks} blocks to K9 at batch {BATCH}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_micro_w7_")
    try:
        micro_launches = phase_config_slice(
            torch, tmp, micro_w7_flags(), "micro_w7", 38,
            lambda forward, steps: {1: 12 * forward, 3: 12 * steps, 20: k9_blocks * forward,
                                    21: k9_blocks * steps},
            batch=BATCH, subjects=(8, 4, 4), enhance=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    grad_k9 = sum(depth for *_, depth in micro_k9_shapes(MICRO_GRAD_BATCH, height=512))
    phase_vessel_grads(torch, dev, seed=39, flags=micro_w7_flags(), channels=1, enhance=True,
                       phase=39, name="micro_w7", path_kernels={20: grad_k9, 21: grad_k9})
    phase_config_throughput(torch, dev, micro_w7_flags(), 40, "micro_w7", batch=BATCH)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_micro_")
    try:
        phase_micro_shipped(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    k8g = phase_k8_general(torch, window_attention, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_emb_attn_")
    try:
        emb_attn_launches = phase_config_slice(
            torch, tmp, emb_attn_flags(), "emb_attn", 43,
            lambda forward, steps: {1: ATTN_BLOCKS * forward, 3: ATTN_BLOCKS * steps,
                                    17: ATTN_BLOCKS * forward, 18: ATTN_BLOCKS * steps,
                                    19: ATTN_BLOCKS * steps},
            batch=BATCH, subjects=(8, 4, 4), shape=EMB_VOLUME[1:] + EMB_VOLUME[:1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gt, gh, gw = EMB_ATTN_GRAD_VOLUME
    phase_config_grads(torch, dev, emb_attn_flags(), (gh, gw), 44, "emb_attn",
                       {17: ATTN_BLOCKS, 18: ATTN_BLOCKS, 19: ATTN_BLOCKS}, ATTN_BF16_GRAD_FLOOR,
                       f"full-width 3D Swin-tiny + SwinLinear (window attention), batch "
                       f"{ATTN_GRAD_BATCH} of {gh}x{gw}x{gt}", batch=ATTN_GRAD_BATCH, time_=gt)
    phase_config_throughput(torch, dev, emb_attn_flags(), 45, "emb_attn", batch=BATCH,
                            volume=EMB_VOLUME)
    k2p, k2p_launches = phase_k2_prime(torch, fused_mlp, dev)
    check(not any(m.split(".")[0] in ("jax", "jaxlib", "flax", "long_context_biomedical_imaging_tpu")
                  for m in sys.modules), "JAX was imported")

    # per kernel, in its main path's configuration (bf16 under AMP, the
    # folded LN): launches in that path's train slice (ptx for K1 and K2, emb
    # for K3, vessel for K4, vit16k for K5, vit65k_hyena for K6, vit65k_mamba
    # for K7, ptx_attn for K8 and emb_attn for K8's _emb_attn rows, micro_w7
    # for K9), worst error over the stage shapes (the backward: over every
    # gradient; K7 and K9: against their passes' plain versions, fp32 as on
    # the path), and the time of one train step (each stage's time x its
    # depth), with its bound; K2', which no path runs, per call with phase
    # 46's launches; library_ms is the time of torch's
    # scaled_dot_product_attention for K5 (forward; its backward shared
    # between dq and dkv) and null for K1-K4, K2' and K6-K9, which no single
    # PyTorch call computes
    bounds = kernel_bounds()
    depths = [d for _, _, d in STAGES]
    emb_depths = [d for _, _, d in EMB_K3_STAGES]
    vessel_depths = [d for _, _, d in VESSEL_K4_STAGES]
    tpu = "long_context_biomedical_imaging_tpu/ops/"
    rows = [("hyena_window_fwd", hyena_window.HYENA_WINDOW_FWD, k1[("bfloat16", True)], depths,
             launches, tpu + "hyena_window.py:328", None),
            ("fused_ln_mlp_fwd", fused_mlp.FUSED_LN_MLP_FWD, k2["bfloat16"], depths, launches,
             tpu + "fused_mlp.py:197", None),
            ("hyena_window_bwd", hyena_window.HYENA_WINDOW_BWD, k1b[("bfloat16", True)], depths,
             launches, tpu + "hyena_window.py:410", None),
            ("fused_ln_mlp_bwd", fused_mlp.FUSED_LN_MLP_BWD, k2b["bfloat16"], depths, launches,
             tpu + "fused_mlp.py:210", None),
            ("hyena_chunked_fwd", hyena_window.HYENA_CHUNKED_FWD, k3["bfloat16"]["fwd"],
             emb_depths, emb_launches, tpu + "hyena_window.py:592", None),
            ("hyena_chunked_bwd", hyena_window.HYENA_CHUNKED_BWD, k3["bfloat16"]["bwd"],
             emb_depths, emb_launches, tpu + "hyena_window.py:680", None),
            ("hyena_dm", hyena_window.HYENA_DM, k3["bfloat16"]["dm"], emb_depths, emb_launches,
             tpu + "hyena_window.py:854", None),
            ("mamba_window_fwd", mamba_window.MAMBA_WINDOW_FWD, k4["bfloat16"]["fwd"],
             vessel_depths, vessel_launches, tpu + "mamba_window.py:201", None),
            ("mamba_window_bwd", mamba_window.MAMBA_WINDOW_BWD, k4["bfloat16"]["bwd"],
             vessel_depths, vessel_launches, tpu + "mamba_window.py:270", None)]
    # the plain VJP and SDPA's backward each compute dq, dk and dv in one
    # call: their times are split between the dq and dkv rows as the rows'
    # bounds split the backward's work, so that the two rows add up to them
    bwd_bound = bounds["flash_attention_dq"][0] + bounds["flash_attention_dkv"][0]
    for label, kernel, key, replaces in (
            ("flash_attention_fwd", flash_attention.FLASH_FWD, "fwd", "flash_attention.py:65"),
            ("flash_attention_dq", flash_attention.FLASH_BWD_DQ, "dq", "flash_attention.py:159"),
            ("flash_attention_dkv", flash_attention.FLASH_BWD_DKV, "dkv",
             "flash_attention.py:189")):
        err, k_ms, p_ms, s_ms = k5[key]
        share = 1.0 if key == "fwd" else bounds[label][0] / bwd_bound
        rows.append((label, kernel, [(err, k_ms, share * p_ms)], [VIT_LAYERS], vit_launches,
                     tpu + replaces, VIT_LAYERS * share * s_ms))
    # K6: the conv row's ms is the forward and the du call of each layer
    for label, kernel, key, replaces in (
            ("spectral_conv", spectral_conv.SPECTRAL_CONV, "conv", "spectral_conv.py:158"),
            ("spectral_conv_dk", spectral_conv.SPECTRAL_CONV_DK, "dk", "spectral_conv.py:183")):
        rows.append((label, kernel, [k6[key]], [VIT_LAYERS], h65_launches, tpu + replaces, None))
    # K7: the fwd row's ms is both forward calls of each layer
    for label, kernel, key, line in (
            ("long_scan_fwd", selective_scan_long.LONG_SCAN_FWD, "fwd", 253),
            ("long_scan_carry_bwd", selective_scan_long.LONG_SCAN_CARRY_BWD, "carry", 289),
            ("long_scan_bwd", selective_scan_long.LONG_SCAN_BWD, "bwd", 320)):
        rows.append((label, kernel, [k7[key]], [VIT_LAYERS], m65_launches,
                     f"{tpu}selective_scan_long.py:{line}", None))
    # K8: the weight-gradient kernel computes the part of the TPU backward
    # kernel's work that sums dWqkv and dWout
    attn_depths = [d for _, _, _, d in ATTN_STAGES]
    for label, kernel, key, line in (
            ("window_attention_fwd", window_attention.WINDOW_ATTENTION_FWD, "fwd", 259),
            ("window_attention_bwd", window_attention.WINDOW_ATTENTION_BWD, "bwd", 277),
            ("window_attention_wgrad", window_attention.WINDOW_ATTENTION_WGRAD, "wgrad", 277)):
        rows.append((label, kernel, k8[key], attn_depths, attn_launches,
                     f"{tpu}window_attention.py:{line}", None))
    # K9: micro_w7's stages 0-1
    micro_depths = [depth for *_, depth in micro_k9_shapes(BATCH)]
    for label, kernel, key, line in (
            ("window_scan_fwd", selective_scan_window.WINDOW_SCAN_FWD, "fwd", 188),
            ("window_scan_bwd", selective_scan_window.WINDOW_SCAN_BWD, "bwd", 323)):
        rows.append((label, kernel, k9[key], micro_depths, micro_launches,
                     f"{tpu}selective_scan_pallas.py:{line}", None))
    # K8 again at emb_attn's stages (512- and 256-token windows, the general
    # path), with emb_attn's launches
    emb_attn_depths = [depth for *_, depth, _, _ in emb_attn_stages()]
    for label, kernel, key, line in (
            ("window_attention_fwd", window_attention.WINDOW_ATTENTION_FWD, "fwd", 259),
            ("window_attention_bwd", window_attention.WINDOW_ATTENTION_BWD, "bwd", 277),
            ("window_attention_wgrad", window_attention.WINDOW_ATTENTION_WGRAD, "wgrad", 277)):
        rows.append((f"{label}_emb_attn", kernel, k8g[key], emb_attn_depths, emb_attn_launches,
                     f"{tpu}window_attention.py:{line}", None))
    # K2': no train path runs it; its launches are phase 46's, its times per
    # call at K2P_SHAPE
    for label, kernel, key, line in (("fused_mlp_fwd", fused_mlp.FUSED_MLP_FWD, "fwd", 280),
                                     ("fused_mlp_bwd", fused_mlp.FUSED_MLP_BWD, "bwd", 308)):
        rows.append((label, kernel, [k2p[key]], [1], k2p_launches, f"{tpu}fused_mlp.py:{line}",
                     None))
    kernels = [{
        "name": label, "route": "cuda", "source": f"{PACKAGE}/csrc/{kernel.source}",
        "replaces": replaces, "launches": path_launches[kernel.symbol],
        "max_abs_err": max(r[0] for r in res),
        "ms": sum(d * r[1] for d, r in zip(dep, res)),
        "plain_ms": sum(d * r[2] for d, r in zip(dep, res)),
        "bound_ms": bounds[label][0], "bound_by": bounds[label][1], "library_ms": library,
    } for label, kernel, res, dep, path_launches, replaces, library in rows]
    for row in kernels:
        check(row["launches"] > 0, f"{row['name']} never ran on its main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


def main():
    try:
        run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
