"""PyTorch port, on a CUDA card: each hand-written kernel (forward and
backward) against its plain PyTorch version, at small odd shapes the ptx
path does not reach (ragged row tiles, V = 1/24/64, C = 16/768; for K3
ragged window groups and chunks of 64), K3 also at the emb stage shapes, K5
(flash attention) at ragged sequence lengths, head dims 32, 64 and 128 and at
the vit16k shape, K6 (the spectral long conv) at the vit65k_hyena shape, the
odd batch at its floor and its ceiling, K7 (the long-sequence scan) at the
vit65k_mamba shape, a ragged length and the gate's widest channels, K8
(Swin window attention) at the ptx_attn stage shapes, V = 64 and a ragged
tile and, on its general path, at V = 49, 256, 343 and 512 (emb_attn's
stage shapes at batch 1 among them), K2' (the MLP without LN or residual,
behind MLPBlock) at ViT-small widths, K9 (the windowed scan) at the
micro_w7 stage shapes and odd windows, and whole models whose every
parameter gets a gradient on the card (a ViT-hyena and a ViT-mamba also
against the host), and the Swin checkpointing's memory. Marked ``cuda``;
without a card every test skips. This file imports neither JAX nor flax,
so that it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q

chip_smoke.py makes the same comparison at the ptx and emb shapes.
"""

import pytest
import torch

from long_context_biomedical_imaging_tpu_torch.ops import flash_attention as tfa
from long_context_biomedical_imaging_tpu_torch.ops import fused_mlp as tmlp
from long_context_biomedical_imaging_tpu_torch.ops import hyena_window as thw
from long_context_biomedical_imaging_tpu_torch.ops import mamba_window as tmw
from long_context_biomedical_imaging_tpu_torch.ops import selective_scan_long as tsl
from long_context_biomedical_imaging_tpu_torch.ops import selective_scan_window as tsw
from long_context_biomedical_imaging_tpu_torch.ops import spectral_conv as tsc
from long_context_biomedical_imaging_tpu_torch.ops import window_attention as twa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels in csrc/ run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    # of max|plain out|. fp32: summation order only; bf16: a bf16 ulp of the
    # output where the fp32 sums straddle a rounding boundary
    return 1e-4 if dtype == torch.float32 else 2e-2


def _randn(gen, shape, scale=0.3):
    return torch.randn(shape, generator=gen) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("with_ln", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw,v,c", [(5, 24, 64), (3, 64, 128), (9, 1, 32), (300, 16, 96)])
def test_hyena_window_kernel_matches_plain(cuda_device, dtype, bw, v, c, with_ln):
    gen = torch.Generator().manual_seed(bw * 1000 + v)
    w = [_randn(gen, s) for s in ((c, 3 * c), (3 * c,), (3 * c, 5), (3 * c,),
                                  (c, v), (c,), (c, c), (c,))]
    args = [_randn(gen, (bw, v, c), 1.0).to(cuda_device, dtype)] + [
        a.to(cuda_device, dtype if i in (0, 6) else torch.float32) for i, a in enumerate(w)]
    kw = {}
    if with_ln:
        kw = dict(ln_scale=(_randn(gen, (c,)) + 1).to(cuda_device),
                  ln_bias=_randn(gen, (c,)).to(cuda_device))
    k_long = args[5].clone()
    before = thw.HYENA_WINDOW_FWD.launches
    out = thw.hyena_window_mixer(*args, **kw)
    torch.cuda.synchronize()
    assert thw.HYENA_WINDOW_FWD.launches == before + 1
    assert torch.equal(args[5], k_long), "the wrapper must not modify its inputs"
    assert out.dtype == dtype and out.shape == (bw, v, c)
    ref = thw.hyena_window_plain(*args, **kw).float()
    err = (out.float() - ref).abs().max().item()
    assert err <= _tol(dtype) * ref.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c", [(37, 16), (300, 96), (70, 768)])
def test_fused_ln_mlp_kernel_matches_plain(cuda_device, dtype, n, c):
    gen = torch.Generator().manual_seed(n * 1000 + c)
    h = 4 * c
    shapes = ((n, c), (c,), (c,), (c, h), (h,), (h, c), (c,))
    args = [(_randn(gen, s, 1.0 if i == 0 else 0.3) + (1.0 if i == 1 else 0.0)).to(
        cuda_device, dtype if i in (0, 3, 5) else torch.float32) for i, s in enumerate(shapes)]
    before = tmlp.FUSED_LN_MLP_FWD.launches
    out = tmlp.fused_ln_mlp_residual(*args)
    torch.cuda.synchronize()
    assert tmlp.FUSED_LN_MLP_FWD.launches == before + 1
    assert out.dtype == dtype and out.shape == (n, c)
    ref = tmlp.fused_ln_mlp_residual_plain(*args).float()
    err = (out.float() - ref).abs().max().item()
    assert err <= _tol(dtype) * ref.abs().max().item(), err


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda_device):
    """Unsupported shapes, dtypes or layouts raise before any launch."""
    x = torch.zeros(2, 16, 48, device=cuda_device)          # C % 32 != 0
    w = [torch.zeros(s, device=cuda_device) for s in
         ((48, 144), (144,), (144, 5), (144,), (48, 16), (48,), (48, 48), (48,))]
    before = thw.HYENA_WINDOW_FWD.launches
    with pytest.raises(ValueError):
        thw.hyena_window_mixer(x, *w)
    long = torch.zeros(1, 96, 32, device=cuda_device)        # 64 < V, V % 64 != 0: no kernel
    w = [torch.zeros(s, device=cuda_device) for s in
         ((32, 96), (96,), (96, 5), (96,), (32, 96), (32,), (32, 32), (32,))]
    with pytest.raises(ValueError):
        thw.hyena_window_mixer(long, *w)
    assert thw.HYENA_WINDOW_FWD.launches == before
    x = torch.zeros(8, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        tmlp.fused_ln_mlp_residual(x, *[torch.zeros(s, device=cuda_device) for s in
                                        ((32,), (32,), (32, 128), (128,), (128, 32), (32,))])


def _grad_tol(dtype):
    # of each gradient's max|plain|. fp32: summation order (the kernels sum
    # over rows per block, then over blocks); bf16: the kernel rounds its
    # products' operands where the TPU kernel does, the plain VJP elsewhere
    return 1e-3 if dtype == torch.float32 else 3e-2


def _check_grads(kernel_grads, plain_grads, dtype, names):
    for name, g, r in zip(names, kernel_grads, plain_grads):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert torch.isfinite(g).all(), name
        err = (g.float() - r.float()).abs().max().item()
        assert err <= _grad_tol(dtype) * max(r.float().abs().max().item(), 1e-6), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c", [(37, 16), (300, 96), (70, 768)])
def test_fused_ln_mlp_backward_kernel_matches_plain(cuda_device, dtype, n, c):
    """K2 backward through the autograd Function against the VJP of the plain
    forward, for x and all six parameters; one launch; inputs unchanged."""
    gen = torch.Generator().manual_seed(n * 1000 + c + 7)
    h = 4 * c
    shapes = ((n, c), (c,), (c,), (c, h), (h,), (h, c), (c,))
    args = [(_randn(gen, s, 1.0 if i == 0 else 0.3) + (1.0 if i == 1 else 0.0)).to(
        cuda_device, dtype if i in (0, 3, 5) else torch.float32) for i, s in enumerate(shapes)]
    do = _randn(gen, (n, c), 1.0).to(cuda_device, dtype)
    kept = [a.clone() for a in args]
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = tmlp.FUSED_LN_MLP_BWD.launches
    tmlp.fused_ln_mlp_residual(*leaves).backward(do)
    torch.cuda.synchronize()
    assert tmlp.FUSED_LN_MLP_BWD.launches == before + 1
    assert all(torch.equal(a, k) for a, k in zip(args, kept)), "inputs changed"
    plain = tmlp.fused_ln_mlp_residual_bwd_plain(do, *args)
    _check_grads([t.grad for t in leaves], plain, dtype,
                 ("x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c", [(37, 16), (32770, 384)])
def test_fused_mlp_kernels_match_plain(cuda_device, dtype, n, c):
    """K2' (the MLP without LN or residual) through MLPBlock in eval mode:
    the forward and the gradients of x and the four fp32 parameters against
    fused_mlp_plain and its VJP (32,770 rows at C = 384, H = 1536: vit16k's
    tokens at batch 2, ViT-small's widths); one launch of each K2' kernel and
    none of K2's; two launches bitwise equal."""
    from long_context_biomedical_imaging_tpu_torch.models import MLPBlock

    gen = torch.Generator().manual_seed(n + c)
    block = MLPBlock(c, 4 * c).eval()
    for p in block.parameters():
        p.data = _randn(gen, p.shape, c ** -0.5)
    block.to(cuda_device)
    x = _randn(gen, (n, c), 1.0).to(cuda_device, dtype)
    do = _randn(gen, (n, c), 1.0).to(cuda_device, dtype)
    counts = (tmlp.FUSED_MLP_FWD, tmlp.FUSED_MLP_BWD, tmlp.FUSED_LN_MLP_FWD,
              tmlp.FUSED_LN_MLP_BWD)
    before = [k.launches for k in counts]
    leaf = x.clone().requires_grad_(True)
    out = block(leaf)
    out.backward(do)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counts, before)] == [1, 1, 0, 0]
    params = [block.fc1_kernel, block.fc1_bias, block.fc2_kernel, block.fc2_bias]
    ref = tmlp.fused_mlp_plain(x, *[p.detach() for p in params])
    err = (out.float() - ref.float()).abs().max().item()
    assert out.dtype == dtype and err <= _tol(dtype) * ref.float().abs().max().item()
    plain = tmlp.fused_mlp_bwd_plain(do, x, *[p.detach() for p in params])
    _check_grads([leaf.grad] + [p.grad for p in params], plain, dtype,
                 ("x", "w1", "b1", "w2", "b2"))
    w = [p.detach().to(dtype) if p.dim() == 2 else p.detach() for p in params]
    runs = [(tmlp.fused_mlp_fwd(x, *w), *tmlp.fused_mlp_bwd(do, x, *w)) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("with_ln", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw,v,c", [(5, 24, 64), (3, 64, 128), (9, 1, 32), (300, 16, 96)])
def test_hyena_window_backward_kernel_matches_plain(cuda_device, dtype, bw, v, c, with_ln):
    """K1 backward through the wrapper (tap flip and skip fold outside the
    kernel) against the VJP of the plain forward in the raw weights; one
    launch; inputs unchanged."""
    gen = torch.Generator().manual_seed(bw * 1000 + v + 11)
    w = [_randn(gen, s) for s in ((c, 3 * c), (3 * c,), (3 * c, 5), (3 * c,),
                                  (c, v), (c,), (c, c), (c,))]
    args = [_randn(gen, (bw, v, c), 1.0).to(cuda_device, dtype)] + [
        a.to(cuda_device, dtype if i in (0, 6) else torch.float32) for i, a in enumerate(w)]
    if with_ln:
        args += [(_randn(gen, (c,)) + 1).to(cuda_device), _randn(gen, (c,)).to(cuda_device)]
    do = _randn(gen, (bw, v, c), 1.0).to(cuda_device, dtype)
    kept = [a.clone() for a in args]
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = thw.HYENA_WINDOW_BWD.launches
    thw.hyena_window_mixer(*leaves).backward(do)
    torch.cuda.synchronize()
    assert thw.HYENA_WINDOW_BWD.launches == before + 1
    assert all(torch.equal(a, k) for a, k in zip(args, kept)), "inputs changed"
    _, vjp = torch.func.vjp(thw.hyena_window_plain, *args)
    _check_grads([t.grad for t in leaves], vjp(do), dtype,
                 ("x", "w_in", "b_in", "w_short", "b_short", "k_long", "b_long", "w_out",
                  "b_out", "ln_scale", "ln_bias"))


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
def test_every_parameter_gets_a_gradient_on_the_card(cuda_device, amp):
    """A tiny Swin + Hyena model trains one step on the card: the loss
    backward reaches every parameter, through the bf16 AMP cast too, with
    finite, non-zero gradients, and both backward kernels launch once per
    block."""
    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import amp_params

    argv = ["--task_type=class", "--encoder_name=Swin", "--decoder_name=SwinLinear",
            "--height=64", "--width=64", "--no_out_channel=2", "--seed=3",
            "--Swin.size=custom", "--Swin.embed_dim=32", "--Swin.depths", "1", "1", "1", "1",
            "--Swin.num_heads", "2", "2", "2", "2", "--Swin.patch_size", "2",
            "--Swin.window_size", "4", "--Swin.use_hyena", "True"] + (["--use_amp"] if amp else [])
    model = build_model(check_args(parse_config(argv))).to(cuda_device)
    x = torch.randn(2, 1, 64, 64, 1, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    y = torch.tensor([0, 1], device=cuda_device)
    counts = (thw.HYENA_WINDOW_BWD.launches, tmlp.FUSED_LN_MLP_BWD.launches)
    params = amp_params(model, amp)
    out = torch.func.functional_call(model, params, (x,))
    cross_entropy_loss(out.float(), y).backward()
    torch.cuda.synchronize()
    assert (thw.HYENA_WINDOW_BWD.launches - counts[0],
            tmlp.FUSED_LN_MLP_BWD.launches - counts[1]) == (4, 4)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name


@pytest.mark.cuda
def test_backward_kernels_are_deterministic(cuda_device):
    """The per-block gradient slots are summed in a fixed order, without
    atomics: two backward launches on the same inputs give bitwise-equal
    gradients, for both kernels, with more row tiles than blocks."""
    gen = torch.Generator().manual_seed(5)
    c, h, bf = 96, 384, torch.bfloat16
    x = _randn(gen, (40000, c), 1.0).to(cuda_device, bf)
    p = [(_randn(gen, (c,)) + 1).to(cuda_device), _randn(gen, (c,)).to(cuda_device),
         _randn(gen, (c, h)).to(cuda_device, bf), _randn(gen, (h,)).to(cuda_device),
         _randn(gen, (h, c)).to(cuda_device, bf), _randn(gen, (c,)).to(cuda_device)]
    do = _randn(gen, (40000, c), 1.0).to(cuda_device, bf)
    first = tmlp.fused_ln_mlp_residual_bwd(do, x, *p)
    again = tmlp.fused_ln_mlp_residual_bwd(do, x, *p)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    xw, dow = x.reshape(2500, 16, c), do.reshape(2500, 16, c)
    ws, kl = thw.prepare_taps(_randn(gen, (3 * c, 5)).to(cuda_device),
                              _randn(gen, (c, 16)).to(cuda_device), _randn(gen, (c,)).to(cuda_device))
    w = [_randn(gen, (c, 3 * c)).to(cuda_device, bf), _randn(gen, (3 * c,)).to(cuda_device), ws,
         _randn(gen, (3 * c,)).to(cuda_device), kl, _randn(gen, (c, c)).to(cuda_device, bf),
         _randn(gen, (c,)).to(cuda_device), p[0], p[1]]
    first = thw.hyena_window_bwd(dow, xw, *w)
    again = thw.hyena_window_bwd(dow, xw, *w)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def _chunked_args(gen, bw, v, c, dtype, device, with_ln):
    """K3 operands on prepared taps: x, w_in, b_in, ws, bs, m (Toeplitz
    blocks in x.dtype), w_out, b_out [, ln_scale, ln_bias]."""
    ws, kl = thw.prepare_taps(_randn(gen, (3 * c, 5)), _randn(gen, (c, v), 0.1),
                              _randn(gen, (c,)))
    m = thw.build_chunk_toeplitz(kl, thw.pick_chunk(v))
    args = [_randn(gen, (bw, v, c), 1.0).to(device, dtype), _randn(gen, (c, 3 * c)).to(device, dtype),
            _randn(gen, (3 * c,)).to(device), ws.to(device), _randn(gen, (3 * c,)).to(device),
            m.to(device, dtype), _randn(gen, (c, c)).to(device, dtype), _randn(gen, (c,)).to(device)]
    if with_ln:
        args += [(_randn(gen, (c,)) + 1).to(device), _randn(gen, (c,)).to(device)]
    return args


_K3_SHAPES = [(5, 192, 32), (17, 128, 64), (3, 512, 96), (4096, 512, 96), (512, 512, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_ln", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw,v,c", _K3_SHAPES)
def test_hyena_chunked_kernel_matches_plain(cuda_device, dtype, bw, v, c, with_ln):
    """K3 forward through the wrapper against its plain version: small odd
    shapes (chunk 64 at V = 192, a ragged group of 17 windows) and the two
    emb stage shapes. One launch; inputs unchanged."""
    gen = torch.Generator().manual_seed(bw + v + c)
    w = [_randn(gen, s) for s in ((c, 3 * c), (3 * c,), (3 * c, 5), (3 * c,), (c, v), (c,),
                                  (c, c), (c,))]
    w[4] = w[4] / 3      # a 0.1 filter over up to 512 taps
    raw = [_randn(gen, (bw, v, c), 1.0).to(cuda_device, dtype)] + [
        a.to(cuda_device, dtype if i in (0, 6) else torch.float32) for i, a in enumerate(w)]
    kw = {}
    if with_ln:
        kw = dict(ln_scale=(_randn(gen, (c,)) + 1).to(cuda_device),
                  ln_bias=_randn(gen, (c,)).to(cuda_device))
    kept = [a.clone() for a in raw]
    before = thw.HYENA_CHUNKED_FWD.launches
    out = thw.hyena_window_mixer(*raw, **kw)
    torch.cuda.synchronize()
    assert thw.HYENA_CHUNKED_FWD.launches == before + 1
    assert all(torch.equal(a, k) for a, k in zip(raw, kept)), "inputs changed"
    assert out.dtype == dtype and out.shape == (bw, v, c)
    ws, kl = thw.prepare_taps(raw[3], raw[5], raw[6])
    m = thw.build_chunk_toeplitz(kl, thw.pick_chunk(v)).to(dtype)
    ref = thw.hyena_chunked_plain(raw[0], raw[1], raw[2].float(), ws, raw[4].float(), m, raw[7],
                                  raw[8].float(), *kw.values()).float()
    err = (out.float() - ref).abs().max().item()
    assert err <= _tol(dtype) * ref.abs().max().item(), err


_K3_NAMES = ("x", "w_in", "b_in", "ws", "bs", "m", "w_out", "b_out", "ln_scale", "ln_bias")


@pytest.mark.cuda
@pytest.mark.parametrize("with_ln", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw,v,c", _K3_SHAPES)
def test_hyena_chunked_backward_kernels_match_plain(cuda_device, dtype, bw, v, c, with_ln):
    """K3 backward and dM (hyena_chunked_bwd: one launch of each) against the
    VJP of the plain forward, every gradient including dM."""
    gen = torch.Generator().manual_seed(bw + v + c + 3)
    args = _chunked_args(gen, bw, v, c, dtype, cuda_device, with_ln)
    do = _randn(gen, (bw, v, c), 1.0).to(cuda_device, dtype)
    before = (thw.HYENA_CHUNKED_BWD.launches, thw.HYENA_DM.launches)
    got = thw.hyena_chunked_bwd(do, *args)
    torch.cuda.synchronize()
    assert (thw.HYENA_CHUNKED_BWD.launches, thw.HYENA_DM.launches) == (before[0] + 1,
                                                                       before[1] + 1)
    _check_grads(got, thw.hyena_chunked_bwd_plain(do, *args), dtype, _K3_NAMES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw,v,c,chunk", [(7, 192, 8, 64), (4096, 512, 96, 128),
                                          (512, 512, 192, 128)])
def test_hyena_dm_kernel_matches_plain(cuda_device, dtype, bw, v, c, chunk):
    """The dM kernel alone on random streams against its plain version:
    fp32 sums over up to 16384 chunk rows, 1e-4 of max in fp32 and 2e-3 in
    bf16 (exact bf16 products, fp32 sums in another order)."""
    gen = torch.Generator().manual_seed(bw + c)
    gs = _randn(gen, (c, bw, v), 1.0).to(cuda_device, dtype)
    dvl = _randn(gen, (c, bw, v), 1.0).to(cuda_device, dtype)
    got = thw.hyena_dm(gs, dvl, chunk)
    ref = thw.hyena_dm_plain(gs, dvl, chunk)
    err = (got - ref).abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 2e-3) * ref.abs().max().item(), err


@pytest.mark.cuda
def test_chunked_kernels_are_deterministic(cuda_device):
    """K3 backward and dM: two launches on the same inputs at the emb stage-0
    shape give bitwise-equal gradients (ordered slot and partial sums)."""
    gen = torch.Generator().manual_seed(9)
    args = _chunked_args(gen, 4096, 512, 96, torch.bfloat16, cuda_device, True)
    do = _randn(gen, (4096, 512, 96), 1.0).to(cuda_device, torch.bfloat16)
    first = thw.hyena_chunked_bwd(do, *args)
    again = thw.hyena_chunked_bwd(do, *args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


# ---------------------------------------------------------------------------
# K4, the fused Mamba window mixer (vessel)
# ---------------------------------------------------------------------------

def _mamba_args(gen, bw, v, c, dtype, device, with_ln, r=None):
    """K4 operands on prepared operands: x, w_xz, wconv, w_dbl, w_dt, dtb2,
    at, dskip, w_out [, ln_scale, ln_bias]; projection weights in dtype."""
    dh, n = c // 2, tmw.MAMBA_KERNEL_STATE
    r = r or -(-c // 16)
    wconv, dtb2, at, dskip = tmw.prepare_operands(
        _randn(gen, (dh, 3)), _randn(gen, (dh, 3)), _randn(gen, (dh,), 0.5),
        -torch.exp(_randn(gen, (dh, n))), _randn(gen, (dh,), 1.0))
    args = [_randn(gen, (bw, v, c), 1.0).to(device, dtype),
            _randn(gen, (c, c), c ** -0.5).to(device, dtype), wconv.to(device),
            _randn(gen, (dh, r + 2 * n), dh ** -0.5).to(device, dtype),
            _randn(gen, (r, dh), r ** -0.5).to(device, dtype), dtb2.to(device), at.to(device),
            dskip.to(device), _randn(gen, (c, c), c ** -0.5).to(device, dtype)]
    if with_ln:
        args += [(_randn(gen, (c,)) + 1).to(device), _randn(gen, (c,)).to(device)]
    return args


# a ragged tile (5 windows of 16 at C = 32), V = 24 and 40 (tiles padded to 16
# rows), the three vessel K4 stage shapes at batch 4, micro's stage 3 (1024 windows of
# 16 at C = 768) and vessel's stage 3 at batch 16 (1024 windows of 64 at C = 768: the
# forward's fp32 accumulator no longer fits in shared memory and moves to global scratch)
_K4_SHAPES = [(5, 16, 32), (3, 24, 64), (7, 40, 128), (16384, 64, 96), (4096, 64, 192),
              (1024, 64, 384), (1024, 16, 768), (1024, 64, 768)]
_K4_NAMES = ("x", "w_xz", "wconv", "w_dbl", "w_dt", "dtb2", "at", "dskip", "w_out",
             "ln_scale", "ln_bias")


@pytest.mark.cuda
@pytest.mark.parametrize("with_ln", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw,v,c", _K4_SHAPES)
def test_mamba_window_kernel_matches_plain(cuda_device, dtype, bw, v, c, with_ln):
    """K4 forward against its plain version; one launch; inputs unchanged."""
    gen = torch.Generator().manual_seed(bw + v + c)
    args = _mamba_args(gen, bw, v, c, dtype, cuda_device, with_ln)
    kept = [a.clone() for a in args]
    before = tmw.MAMBA_WINDOW_FWD.launches
    out = tmw.mamba_window_fwd(*args)
    torch.cuda.synchronize()
    assert tmw.MAMBA_WINDOW_FWD.launches == before + 1
    assert all(torch.equal(a, k) for a, k in zip(args, kept)), "inputs changed"
    assert out.dtype == dtype and out.shape == (bw, v, c)
    ref = tmw.mamba_window_plain(*args).float()
    err = (out.float() - ref).abs().max().item()
    assert err <= _tol(dtype) * ref.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("with_ln", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw,v,c", _K4_SHAPES)
def test_mamba_window_backward_kernel_matches_plain(cuda_device, dtype, bw, v, c, with_ln):
    """K4 backward against the VJP of the plain forward, every gradient; one
    launch."""
    gen = torch.Generator().manual_seed(bw + v + c + 5)
    args = _mamba_args(gen, bw, v, c, dtype, cuda_device, with_ln)
    do = _randn(gen, (bw, v, c), 1.0).to(cuda_device, dtype)
    before = tmw.MAMBA_WINDOW_BWD.launches
    got = tmw.mamba_window_bwd(do, *args)
    torch.cuda.synchronize()
    assert tmw.MAMBA_WINDOW_BWD.launches == before + 1
    _check_grads(got, tmw.mamba_window_bwd_plain(do, *args), dtype, _K4_NAMES)


@pytest.mark.cuda
@pytest.mark.parametrize("with_ln", [False, True])
def test_mamba_window_kernels_take_fp32_swin_base_windows(cuda_device, with_ln):
    """Swin-base (C = 1024) without AMP: fp32 windows of 64 tokens, whose rows
    outgrow a block's shared memory, so the forward keeps its rows and its
    accumulator in global scratch. Forward and backward against the plain
    versions."""
    gen = torch.Generator().manual_seed(1024 + with_ln)
    args = _mamba_args(gen, 1024, 64, 1024, torch.float32, cuda_device, with_ln)
    out = tmw.mamba_window_fwd(*args)
    torch.cuda.synchronize()
    ref = tmw.mamba_window_plain(*args)
    err = (out - ref).abs().max().item()
    assert err <= _tol(torch.float32) * ref.abs().max().item(), err
    del out, ref
    do = _randn(gen, (1024, 64, 1024), 1.0).to(cuda_device)
    got = tmw.mamba_window_bwd(do, *args)
    torch.cuda.synchronize()
    _check_grads(got, tmw.mamba_window_bwd_plain(do, *args), torch.float32, _K4_NAMES)


@pytest.mark.cuda
def test_mamba_window_mixer_goes_through_both_kernels(cuda_device):
    """mamba_window_mixer on CUDA tensors launches K4 forward and backward,
    never the plain version, and its gradients reach the raw parameters
    (conv branches, dt_bias through the factor 2, A through A^T)."""
    gen = torch.Generator().manual_seed(3)
    bw, v, c, dh, n = 64, 16, 64, 32, 8
    raw = [_randn(gen, (bw, v, c), 1.0), _randn(gen, (c, c), 0.1), _randn(gen, (dh, 3)),
           _randn(gen, (dh, 3)), _randn(gen, (dh, 4 + 2 * n), 0.2), _randn(gen, (4, dh), 0.5),
           _randn(gen, (dh,)), -torch.exp(_randn(gen, (dh, n))), _randn(gen, (dh,)),
           _randn(gen, (c, c), 0.1)]
    leaves = [a.to(cuda_device).requires_grad_(True) for a in raw]
    host = [a.clone().requires_grad_(True) for a in raw]
    counts = (tmw.MAMBA_WINDOW_FWD.launches, tmw.MAMBA_WINDOW_BWD.launches)
    out = tmw.mamba_window_mixer(*leaves, d_state=n)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (tmw.MAMBA_WINDOW_FWD.launches - counts[0],
            tmw.MAMBA_WINDOW_BWD.launches - counts[1]) == (1, 1)
    tmw.mamba_window_mixer(*host, d_state=n).square().sum().backward()
    for t, h in zip(leaves, host):
        err = (t.grad.cpu() - h.grad).abs().max().item()
        assert err <= 1e-3 * h.grad.abs().max().item(), err


@pytest.mark.cuda
def test_mamba_window_kernels_are_deterministic_and_refuse(cuda_device):
    """Two K4 backward launches on the same inputs at the vessel stage-1
    shape give bitwise-equal gradients (ordered slot and warp sums); a
    launch the kernel refuses (V = 72) raises and the wrapper refuses what
    it cannot take (d_state 4). fp32 windows of 64 tokens at C = 864, whose
    rows alone outgrow a block's shared memory, run with the rows in global
    scratch and match the plain version."""
    gen = torch.Generator().manual_seed(11)
    args = _mamba_args(gen, 4096, 64, 192, torch.bfloat16, cuda_device, True)
    do = _randn(gen, (4096, 64, 192), 1.0).to(cuda_device, torch.bfloat16)
    first = tmw.mamba_window_bwd(do, *args)
    again = tmw.mamba_window_bwd(do, *args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    from long_context_biomedical_imaging_tpu_torch.ops.cuda_build import ptr, stream_handle

    x, out = args[0][:1], torch.empty_like(args[0][:1])
    with pytest.raises(RuntimeError, match="lcbi_mamba_window_fwd"):
        tmw.MAMBA_WINDOW_FWD(*(ptr(a) for a in [x, None, None] + args[1:9] + [out, None]),
                             0, 1, 72, 192, 12, 0, 1, stream_handle(cuda_device))
    edge = _mamba_args(gen, 2, 64, 832, torch.float32, cuda_device, False)
    assert tmw.mamba_window_fwd(*edge).shape == (2, 64, 832)
    wide = _mamba_args(gen, 2, 64, 864, torch.float32, cuda_device, False)
    got = tmw.mamba_window_fwd(*wide)
    ref = tmw.mamba_window_plain(*wide)
    assert (got - ref).abs().max().item() <= _tol(torch.float32) * ref.abs().max().item()
    small = _mamba_args(gen, 2, 16, 64, torch.float32, cuda_device, False)
    small[6] = small[6][:4].contiguous()
    with pytest.raises(ValueError):
        tmw.mamba_window_fwd(*small)


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
def test_every_vessel_parameter_gets_a_gradient_on_the_card(cuda_device, amp):
    """A tiny Swin + Mamba + UperNet2D model (128x128x3 at batch 4: stage 0
    has 1024 windows of 16 tokens and takes K4) trains one step on the card:
    K4 forward and backward launch once (stage 0), and the loss backward
    reaches every parameter, through the bf16 AMP cast too, with finite,
    non-zero gradients."""
    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import amp_params

    argv = ["--task_type=seg", "--encoder_name=Swin", "--decoder_name=UperNet2D",
            "--height=128", "--width=128", "--no_in_channel=3", "--no_out_channel=2",
            "--seed=3", "--Swin.size=custom", "--Swin.embed_dim=32",
            "--Swin.depths", "1", "1", "1", "1", "--Swin.num_heads", "2", "2", "2", "2",
            "--Swin.patch_size", "2", "--Swin.window_size", "4", "--Swin.use_hyena", "False",
            "--Swin.use_mamba", "True"] + (["--use_amp"] if amp else [])
    model = build_model(check_args(parse_config(argv))).to(cuda_device).train()
    x = torch.randn(4, 1, 128, 128, 3, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    y = (x[..., 0] > 0.5).long()
    counts = (tmw.MAMBA_WINDOW_FWD.launches, tmw.MAMBA_WINDOW_BWD.launches)
    out = torch.func.functional_call(model, amp_params(model, amp), (x,))
    assert out.shape == (4, 1, 128, 128, 2)
    cross_entropy_loss(out.float(), y).backward()
    torch.cuda.synchronize()
    assert (tmw.MAMBA_WINDOW_FWD.launches - counts[0],
            tmw.MAMBA_WINDOW_BWD.launches - counts[1]) == (1, 1)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name


# ---------------------------------------------------------------------------
# K5, flash attention (vit16k)
# ---------------------------------------------------------------------------

def _flash_args(gen, bh, l, dtype, device, d=64):
    return [_randn(gen, (bh, l, d), 1.0).to(device, dtype) for _ in range(4)]


def _check_flash(got, ref, dtype, names, floor):
    """Each output against its plain reference within the forward's (_tol)
    or the gradients' (_grad_tol) share of max(max|ref|, floor)."""
    for name, g, r in zip(names, got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert torch.isfinite(g).all(), name
        tol = _tol(dtype) if name in ("o", "lse") else _grad_tol(dtype)
        err = (g.float() - r.float()).abs().max().item()
        assert err <= tol * max(r.float().abs().max().item(), floor), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,l", [(3, 1), (3, 63), (2, 65), (2, 1025)])
def test_flash_attention_kernels_match_plain(cuda_device, dtype, bh, l):
    """K5 forward (o, lse), dq and dk/dv against the plain version and its
    VJP at ragged lengths: a lone key and query (L = 1), one short tile, a
    tile and one row, 16 tiles and one row (the vit16k tail at 1,025 tokens).
    One launch each. At L = 1 dq and dk vanish exactly (a softmax over one
    key) and the kernels leave fp32 round-off of dp - delta, so their floor
    is the inputs' scale, 1."""
    gen = torch.Generator().manual_seed(bh * 10000 + l)
    q, k, v, do = _flash_args(gen, bh, l, dtype, cuda_device)
    scale = 64 ** -0.5
    counts = (tfa.FLASH_FWD.launches, tfa.FLASH_BWD_DQ.launches, tfa.FLASH_BWD_DKV.launches)
    o, lse = tfa.flash_attention_fwd(q, k, v, scale)
    grads = tfa.flash_attention_bwd(do, q, k, v, o, lse, scale)
    torch.cuda.synchronize()
    assert (tfa.FLASH_FWD.launches - counts[0], tfa.FLASH_BWD_DQ.launches - counts[1],
            tfa.FLASH_BWD_DKV.launches - counts[2]) == (1, 1, 1)
    floor = 1.0 if l == 1 else 1e-6
    _check_flash((o, lse), tfa.flash_attention_plain(q, k, v, scale), dtype, ("o", "lse"), floor)
    _check_flash(grads, tfa.flash_attention_bwd_plain(do, q, k, v, scale), dtype,
                 ("dq", "dk", "dv"), floor)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_match_plain_at_vit16k(cuda_device, dtype):
    """K5 at the vit16k shape, (12, 16385, 64): the kernels run on all 12
    head-batches, every output is finite, and head-batches 0 and 11 (the
    plain version holds (L, L) fp32 scores per head-batch, several of them in
    its VJP) match the plain version and its VJP."""
    gen = torch.Generator().manual_seed(16385)
    q, k, v, do = _flash_args(gen, 12, 16385, dtype, cuda_device)
    scale = 64 ** -0.5
    o, lse = tfa.flash_attention_fwd(q, k, v, scale)
    grads = tfa.flash_attention_bwd(do, q, k, v, o, lse, scale)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in (o, lse, *grads))
    for i in (0, 11):
        sl = [t[i:i + 1] for t in (q, k, v, do)]
        _check_flash((o[i:i + 1], lse[i:i + 1]), tfa.flash_attention_plain(*sl[:3], scale),
                     dtype, ("o", "lse"), 1e-6)
        _check_flash([g[i:i + 1] for g in grads],
                     tfa.flash_attention_bwd_plain(sl[3], *sl[:3], scale), dtype,
                     ("dq", "dk", "dv"), 1e-6)
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("bh,l", [(3, 63), (2, 1025)])
def test_flash_attention_kernels_match_plain_at_head_dims(cuda_device, dtype, d, bh, l):
    """K5 at head dims 32 (64-row tiles) and 128 (32-row tiles): forward (o,
    lse), dq and dk/dv against the plain version and its VJP at a short tile
    and at 16 tiles and one row (ragged at either tile edge)."""
    gen = torch.Generator().manual_seed(d * 100000 + bh * 10000 + l)
    q, k, v, do = _flash_args(gen, bh, l, dtype, cuda_device, d)
    scale = d ** -0.5
    o, lse = tfa.flash_attention_fwd(q, k, v, scale)
    grads = tfa.flash_attention_bwd(do, q, k, v, o, lse, scale)
    torch.cuda.synchronize()
    _check_flash((o, lse), tfa.flash_attention_plain(q, k, v, scale), dtype, ("o", "lse"), 1e-6)
    _check_flash(grads, tfa.flash_attention_bwd_plain(do, q, k, v, scale), dtype,
                 ("dq", "dk", "dv"), 1e-6)


@pytest.mark.cuda
def test_flash_attention_kernels_are_deterministic_and_refuse(cuda_device):
    """Two launches of each K5 kernel on the same inputs give the same bits
    (no atomics); D = 32 and 128 sliced from the same inputs match the plain
    version and its VJP, fp32 and bf16, and repeat bitwise; the wrappers
    refuse a head dim no instance takes (48), fp16, a non-contiguous tensor,
    operands on two devices or of two dtypes."""
    gen = torch.Generator().manual_seed(5)
    q, k, v, do = _flash_args(gen, 4, 777, torch.bfloat16, cuda_device)
    first = tfa.flash_attention_fwd(q, k, v, 0.125)
    again = tfa.flash_attention_fwd(q, k, v, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    g1 = tfa.flash_attention_bwd(do, q, k, v, *first, 0.125)
    g2 = tfa.flash_attention_bwd(do, q, k, v, *first, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    wide = [_randn(gen, (4, 777, 128), 1.0).to(cuda_device) for _ in range(4)]
    for dtype in (torch.float32, torch.bfloat16):
        for sliced in ([t[..., :32].contiguous() for t in (q, k, v, do)],
                       [t.to(dtype) for t in wide]):
            sl = [t.to(dtype) for t in sliced]
            scale = sl[0].shape[-1] ** -0.5
            fwd = tfa.flash_attention_fwd(*sl[:3], scale)
            grads = tfa.flash_attention_bwd(sl[3], *sl[:3], *fwd, scale)
            assert all(torch.equal(a, b) for a, b in zip(
                (*fwd, *grads),
                (*tfa.flash_attention_fwd(*sl[:3], scale),
                 *tfa.flash_attention_bwd(sl[3], *sl[:3], *fwd, scale))))
            _check_flash(fwd, tfa.flash_attention_plain(*sl[:3], scale), dtype, ("o", "lse"),
                         1e-6)
            _check_flash(grads, tfa.flash_attention_bwd_plain(sl[3], *sl[:3], scale), dtype,
                         ("dq", "dk", "dv"), 1e-6)
    odd = [t[..., :48].contiguous() for t in (q, k, v)]
    with pytest.raises(ValueError, match="D in"):
        tfa.flash_attention_fwd(*odd, 0.125)
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(*(t.half() for t in (q, k, v)), 0.125)
    strided = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(strided, k, v, 0.125)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, k.cpu(), v, 0.125)
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(q, k.float(), v, 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
def test_every_vit_parameter_gets_a_gradient_on_the_card(cuda_device, amp):
    """A ViT (hidden 128, 2 heads of 64, 2 layers) on 128x128 images with
    patch 4 (1,024 tokens and the cls token, so K5) trains one step on the
    card: K5 forward launches twice (one per block) and dq and dkv twice in
    the backward, and the loss backward reaches every parameter, through the
    bf16 AMP cast too, with finite, non-zero gradients."""
    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import amp_params

    argv = ["--task_type=class", "--encoder_name=ViT", "--decoder_name=ViTLinear",
            "--height=128", "--width=128", "--no_in_channel=1", "--no_out_channel=2",
            "--seed=3", "--ViT.size=custom", "--ViT.hidden_size=128", "--ViT.mlp_dim=256",
            "--ViT.num_layers=2", "--ViT.num_heads=2", "--ViT.patch_size", "4"] + (
                ["--use_amp"] if amp else [])
    model = build_model(check_args(parse_config(argv))).to(cuda_device)
    x = torch.randn(2, 1, 128, 128, 1, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    y = torch.tensor([0, 1], device=cuda_device)
    counts = (tfa.FLASH_FWD.launches, tfa.FLASH_BWD_DQ.launches, tfa.FLASH_BWD_DKV.launches)
    out = torch.func.functional_call(model, amp_params(model, amp), (x,))
    assert out.shape == (2, 2)
    cross_entropy_loss(out.float(), y).backward()
    torch.cuda.synchronize()
    assert (tfa.FLASH_FWD.launches - counts[0], tfa.FLASH_BWD_DQ.launches - counts[1],
            tfa.FLASH_BWD_DKV.launches - counts[2]) == (2, 2, 2)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name


# ---------------------------------------------------------------------------
# K6, the spectral long conv (vit65k_hyena)
# ---------------------------------------------------------------------------

def _spec_tol(dtype):
    # of max|plain|. fp32: the four-step FFT and cuFFT agree to fp32
    # round-off of a length-2L transform; bf16: both compute in fp32 and round
    # the result once, so they differ by at most a bf16 ulp
    return 1e-5 if dtype == torch.float32 else 1e-2


def _spec_args(gen, shape, dtype, device, with_bias):
    b, d, length = shape
    u = _randn(gen, shape, 1.0).to(device, dtype)
    k = (_randn(gen, (d, length), 1.0) * torch.exp(-torch.arange(length) / 2000.0)).to(device)
    bias = _randn(gen, (d,), 1.0).to(device) if with_bias else None
    g = _randn(gen, shape, 1.0).to(device, dtype)
    return u, k, bias, g


def _check_spec(got, ref, dtype, names):
    for name, a, r in zip(names, got, ref):
        if r is None:
            assert a is None, name
            continue
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert torch.isfinite(a).all(), name
        err = (a.float() - r.float()).abs().max().item()
        assert err <= _spec_tol(dtype) * r.float().abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 8, 8192), (1, 4, 131072), (1, 384, 65536)])
def test_spectral_conv_kernels_match_plain(cuda_device, dtype, shape, with_bias):
    """K6 through its autograd Function: the forward (one conv launch) and
    du, dk, dbias (one conv launch with the conjugate spectrum, one dk
    launch) against the plain version and its VJP, at the vit65k_hyena shape,
    the odd batch at the gate's floor and one channel block at its ceiling."""
    gen = torch.Generator().manual_seed(sum(shape) + with_bias)
    u, k, bias, g = _spec_args(gen, shape, dtype, cuda_device, with_bias)
    leaves = [t.clone().requires_grad_(True) if t is not None else None for t in (u, k, bias)]
    before = (tsc.SPECTRAL_CONV.launches, tsc.SPECTRAL_CONV_DK.launches)
    y = tsc.spectral_causal_conv(*leaves)
    assert tsc.SPECTRAL_CONV.launches == before[0] + 1
    y.backward(g)
    torch.cuda.synchronize()
    assert (tsc.SPECTRAL_CONV.launches, tsc.SPECTRAL_CONV_DK.launches) == (
        before[0] + 2, before[1] + 1)
    _check_spec([y], [tsc.spectral_causal_conv_plain(u, k, bias)], dtype, ["y"])
    _check_spec([t.grad if t is not None else None for t in leaves],
                tsc.spectral_causal_conv_bwd_plain(g, u, k, bias), dtype,
                ("du", "dk", "dbias"))


@pytest.mark.cuda
def test_spectral_conv_kernels_are_deterministic_and_refuse(cuda_device):
    """Two launches of each K6 kernel give the same bits (the dk kernel sums
    the batch in a fixed order); the wrappers refuse a length outside the gate
    (4096, 262144) or not a power of two (12288), a CPU tensor, fp16, a filter
    that is not fp32, a non-contiguous tensor."""
    gen = torch.Generator().manual_seed(6)
    u, k, bias, g = _spec_args(gen, (3, 8, 8192), torch.bfloat16, cuda_device, True)
    for conj in (False, True):
        assert torch.equal(tsc.spectral_conv_fwd(u, k, bias, conj),
                           tsc.spectral_conv_fwd(u, k, bias, conj))
    assert torch.equal(tsc.spectral_conv_dk(g, u), tsc.spectral_conv_dk(g, u))
    for length in (4096, 12288, 262144):
        with pytest.raises(ValueError, match="8192"):
            tsc.spectral_conv_fwd(torch.zeros(1, 2, length, device=cuda_device),
                                  torch.zeros(2, length, device=cuda_device))
    with pytest.raises(ValueError, match="CUDA"):
        tsc.spectral_conv_fwd(u.cpu(), k.cpu(), bias.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        tsc.spectral_conv_dk(g.cpu(), u.cpu())
    with pytest.raises(TypeError):
        tsc.spectral_conv_fwd(u.half(), k, bias)
    with pytest.raises(TypeError):
        tsc.spectral_conv_fwd(u, k.bfloat16(), bias)
    with pytest.raises(ValueError, match="contiguous"):
        tsc.spectral_conv_fwd(u.transpose(0, 1).contiguous().transpose(0, 1), k, bias)


@pytest.mark.cuda
def test_long_conv_routes_on_the_card(cuda_device):
    """causal_long_conv_cm on a CUDA tensor past the Toeplitz budget: a
    spectral length (8192) launches K6 (the conv forward; conv and dk in the
    backward) and matches the host's route (K6's plain version); 4096 takes
    the fp32 FFT and 512 the direct convolution, with no K6 launch, each
    matching the host."""
    from long_context_biomedical_imaging_tpu_torch.ops import fftconv as tfft

    for length, launches in ((8192, (2, 1)), (4096, (0, 0)), (512, (0, 0))):
        gen = torch.Generator().manual_seed(length)
        c = 1024 if length == 512 else 16
        u = _randn(gen, (1, length, c), 1.0)
        k = _randn(gen, (c, length), 0.2)
        bias = _randn(gen, (c,), 0.5)
        g = _randn(gen, (1, length, c), 1.0)
        outs = []
        for dev in (cuda_device, torch.device("cpu")):
            leaves = [t.to(dev).requires_grad_(True) for t in (u, k, bias)]
            before = (tsc.SPECTRAL_CONV.launches, tsc.SPECTRAL_CONV_DK.launches)
            y = tfft.causal_long_conv_cm(*leaves)
            y.backward(g.to(dev))
            ran = (tsc.SPECTRAL_CONV.launches - before[0], tsc.SPECTRAL_CONV_DK.launches - before[1])
            assert ran == (launches if dev.type == "cuda" else (0, 0)), (length, dev, ran)
            outs.append([y.detach().cpu()] + [t.grad.cpu() for t in leaves])
        for name, a, r in zip(("y", "du", "dk", "dbias"), *outs):
            err = (a - r).abs().max().item()
            assert err <= 1e-5 * r.abs().max().item(), (length, name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
def test_vit_hyena_gradients_on_the_card_match_the_host(cuda_device, amp):
    """A ViT-hyena (hidden 32, 2 heads, 2 layers, MLP 64) on 256x512 images
    with patch 4: 8,192 tokens, K6's lowest length. One train step on the card
    launches the K6 conv twice forward and twice in the backward, dk twice;
    every parameter's gradient is finite and non-zero and, in fp32, within
    1e-4 of its max of the host's (K6's plain version), in bf16 within 1e-1
    (bf16 roundings compounded over the blocks)."""
    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import amp_params

    argv = ["--task_type=class", "--encoder_name=ViT", "--decoder_name=ViTLinear",
            "--height=256", "--width=512", "--no_in_channel=1", "--no_out_channel=2",
            "--seed=3", "--ViT.size=custom", "--ViT.hidden_size=32", "--ViT.mlp_dim=64",
            "--ViT.num_layers=2", "--ViT.num_heads=2", "--ViT.patch_size", "4",
            "--ViT.use_hyena=True"] + (["--use_amp"] if amp else [])
    model = build_model(check_args(parse_config(argv)))
    x = torch.randn(1, 1, 256, 512, 1, generator=torch.Generator().manual_seed(0))
    y = torch.tensor([1])
    grads = {}
    for dev in (torch.device("cpu"), cuda_device):
        model.to(dev).zero_grad(set_to_none=True)
        before = (tsc.SPECTRAL_CONV.launches, tsc.SPECTRAL_CONV_DK.launches)
        out = torch.func.functional_call(model, amp_params(model, amp), (x.to(dev),))
        cross_entropy_loss(out.float(), y.to(dev)).backward()
        torch.cuda.synchronize()
        ran = (tsc.SPECTRAL_CONV.launches - before[0], tsc.SPECTRAL_CONV_DK.launches - before[1])
        assert ran == ((4, 2) if dev.type == "cuda" else (0, 0)), (dev, ran)
        grads[dev.type] = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    tol = 1e-1 if amp else 1e-4
    for name, g in grads["cuda"].items():
        ref = grads["cpu"][name]
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
        assert (g - ref).abs().max().item() <= tol * ref.abs().max().item(), name


@pytest.mark.cuda
def test_swin_checkpointing_lowers_peak_memory(cuda_device):
    """--Swin.use_checkpoint=True on the ptx model (Swin-tiny + Hyena, patch
    2, window 4) at batch 2 of 256x256, bf16 AMP: one forward and backward
    keeps only the block boundaries, so its peak memory is lower than
    without the flag, and the gradients are the same to 1e-6 of each max (the
    recompute runs the same kernels on the same inputs)."""
    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import amp_params

    base = ["--task_type=class", "--encoder_name=Swin", "--decoder_name=SwinLinear",
            "--height=256", "--width=256", "--no_out_channel=2", "--seed=3", "--use_amp",
            "--Swin.size=tiny", "--Swin.patch_size", "2", "--Swin.window_size", "4",
            "--Swin.use_hyena", "True"]
    x = torch.randn(2, 1, 256, 256, 1, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    y = torch.tensor([0, 1], device=cuda_device)
    peaks, grads = [], []
    model = build_model(check_args(parse_config(base))).to(cuda_device)
    for flag in ("False", "True"):
        remat = build_model(check_args(parse_config(base + [f"--Swin.use_checkpoint={flag}"])))
        remat.load_state_dict(model.state_dict())
        remat.to(cuda_device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        out = torch.func.functional_call(remat, amp_params(remat, True), (x,))
        cross_entropy_loss(out.float(), y).backward()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - start)
        grads.append({k: p.grad.detach() for k, p in remat.named_parameters()})
        del remat, out
    assert peaks[1] < peaks[0], peaks
    for name, g in grads[0].items():
        err = (g - grads[1][name]).abs().max().item()
        assert err <= 1e-6 * g.abs().max().item(), (name, err)


# K7's shapes (b, L, D), N = 8: the vit65k_mamba call (batch 1 duplicated), a
# ragged length with an odd batch (the carries stay within their batch row),
# the gate's widest channels (N * D = 8192)
K7_SHAPES = [(2, 65536, 192), (3, 2113, 40), (1, 4096, 1024)]
K7_NAMES = ("y", "du", "ddelta", "dA", "dB", "dC", "dD", "ddelta_bias")


def _k7_args(gen, shape, dtype, device):
    """u, delta, A, B, C, D, delta_bias and a cotangent g of one K7 case:
    A = -(1..8) per channel times exp(0.3 N(0, 1)), as A_log's init plus
    noise; u, delta and g in dtype, the rest fp32."""
    b, length, d = shape
    a = -torch.arange(1, 9.0) * torch.exp(0.3 * torch.randn(d, 8, generator=gen))
    args = [torch.randn(shape, generator=gen), torch.randn(shape, generator=gen), a,
            torch.randn(b, length, 8, generator=gen), torch.randn(b, length, 8, generator=gen),
            torch.randn(d, generator=gen), torch.randn(d, generator=gen),
            torch.randn(shape, generator=gen)]
    return [t.to(device, dtype if i in (0, 1, 3, 4, 7) else torch.float32)
            for i, t in enumerate(args)]


def _k7_vjp(fn, args):
    """fn(*args[:7]) and its gradients for the cotangent args[7]."""
    leaves = [t.detach().requires_grad_(True) for t in args[:7]]
    y = fn(*leaves)
    return [y.detach()] + list(torch.autograd.grad(y, leaves, args[7]))


def _check_k7(got, ref, dtype):
    # of each output's max|plain|. fp32: the kernels' exp2 and softplus forms
    # and the chunked scan's log-depth association, the sums over 131,072
    # tokens of dA, dD and ddelta_bias in another order; bf16: the output and
    # the inputs' gradients are rounded once to bf16 on both sides
    tol = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 3e-2)}[dtype]
    for i, (name, a, r) in enumerate(zip(K7_NAMES, got, ref)):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        a, r = a.float(), r.float()
        err = (a - r).abs().max().item()
        assert torch.isfinite(a).all() and err <= tol[i > 0] * r.abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K7_SHAPES)
def test_long_scan_kernels_match_plain(cuda_device, dtype, shape):
    """selective_scan_long on the card (K7: the forward kernel twice, the
    carry kernel and the backward kernel, with the stitches) against its
    plain version (the chunked scan) on the same inputs: y and the gradients
    of u, delta, A, B, C, D and delta_bias."""
    args = _k7_args(torch.Generator().manual_seed(shape[1]), shape, dtype, cuda_device)
    kernels = (tsl.LONG_SCAN_FWD, tsl.LONG_SCAN_CARRY_BWD, tsl.LONG_SCAN_BWD)
    before = [k.launches for k in kernels]
    got = _k7_vjp(tsl.selective_scan_long, args)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 1, 1]
    _check_k7(got, _k7_vjp(tsl.selective_scan_long_plain, args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K7_SHAPES)
def test_long_scan_passes_match_plain(cuda_device, shape):
    """Each K7 kernel against its pass's plain version on the same fp32
    inputs: the forward pass from zero carries (hl, ap) and seeded (y), the
    carry backward (dh0), the backward (du, ddelta, dat, dB, dC), within
    1e-4 of each output's max (exp2 and softplus forms, dat's sum order)."""
    u, delta, a, bm, cm, _, _, g = _k7_args(torch.Generator().manual_seed(7), shape,
                                            torch.float32, cuda_device)
    at = a.t().contiguous()
    rows = shape[0] * -(-shape[1] // tsl.SEG)
    h0 = torch.randn(rows, 8, shape[2], device=cuda_device)
    dht = torch.randn(rows, 8, shape[2], device=cuda_device)
    pairs = [(tsl.long_scan_fwd(u, delta, at, bm, cm, emit_y=False)[1:],
              tsl.long_scan_fwd_plain(u, delta, at, bm, cm, emit_y=False)[1:]),
             (tsl.long_scan_fwd(u, delta, at, bm, cm, h0)[:1],
              tsl.long_scan_fwd_plain(u, delta, at, bm, cm, h0)[:1]),
             ((tsl.long_scan_carry_bwd(delta, at, cm, g),),
              (tsl.long_scan_carry_bwd_plain(delta, at, cm, g),)),
             (tsl.long_scan_bwd(u, delta, at, bm, cm, g, h0, dht),
              tsl.long_scan_bwd_plain(u, delta, at, bm, cm, g, h0, dht))]
    torch.cuda.synchronize()
    for i, (got, ref) in enumerate(pairs):
        for j, (x, r) in enumerate(zip(got, ref)):
            err = (x - r).abs().max().item()
            assert torch.isfinite(x).all() and err <= 1e-4 * r.abs().max().item(), (i, j, err)


@pytest.mark.cuda
def test_long_scan_kernels_are_deterministic_and_refuse(cuda_device):
    """Two launches of each K7 kernel give the same bits (the backward sums
    dB, dC over the channels and dA over the rows in a fixed order); the
    wrappers refuse a CPU tensor, d_state 4, fp16 and a non-contiguous
    tensor."""
    u, delta, a, bm, cm, _, _, g = _k7_args(torch.Generator().manual_seed(8), (3, 2113, 40),
                                            torch.float32, cuda_device)
    at = a.t().contiguous()
    _, hl, ap = tsl.long_scan_fwd(u, delta, at, bm, cm, emit_y=False)
    runs = [[tsl.long_scan_fwd(u, delta, at, bm, cm, hl)[0],
             tsl.long_scan_carry_bwd(delta, at, cm, g),
             *tsl.long_scan_bwd(u, delta, at, bm, cm, g, hl, ap)] for _ in range(2)]
    torch.cuda.synchronize()
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="CUDA"):
        tsl.long_scan_fwd(u.cpu(), delta.cpu(), at.cpu(), bm.cpu(), cm.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        tsl.long_scan_bwd(u.cpu(), delta.cpu(), at.cpu(), bm.cpu(), cm.cpu(), g.cpu(), hl.cpu(),
                          ap.cpu())
    with pytest.raises(ValueError, match="d_state 8"):
        tsl.long_scan_fwd(u, delta, at[:4].contiguous(), bm[..., :4].contiguous(),
                          cm[..., :4].contiguous())
    with pytest.raises(ValueError, match="d_state 8"):
        tsl.selective_scan_long(u, delta, a[:, :4], bm[..., :4], cm[..., :4])
    with pytest.raises(TypeError):
        tsl.long_scan_carry_bwd(delta.half(), at, cm, g)
    with pytest.raises(ValueError, match="contiguous"):
        tsl.long_scan_fwd(u.transpose(0, 1).contiguous().transpose(0, 1), delta, at, bm, cm)


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
def test_vit_mamba_gradients_on_the_card_match_the_host(cuda_device, amp):
    """A ViT-mamba (hidden 32, 2 heads, 2 layers, MLP 64) on 128x256 images
    with patch 4: 2,048 tokens, K7's floor. One train step on the card
    launches the K7 forward twice per block, the carry and backward kernels
    once; every parameter's gradient is finite and non-zero and, in fp32,
    within 1e-4 of its max of the host's (K7's plain passes), in bf16 within
    1e-1 (bf16 roundings compounded over the blocks)."""
    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import amp_params

    argv = ["--task_type=class", "--encoder_name=ViT", "--decoder_name=ViTLinear",
            "--height=128", "--width=256", "--no_in_channel=1", "--no_out_channel=2",
            "--seed=3", "--ViT.size=custom", "--ViT.hidden_size=32", "--ViT.mlp_dim=64",
            "--ViT.num_layers=2", "--ViT.num_heads=2", "--ViT.patch_size", "4",
            "--ViT.use_mamba=True"] + (["--use_amp"] if amp else [])
    model = build_model(check_args(parse_config(argv)))
    x = torch.randn(1, 1, 128, 256, 1, generator=torch.Generator().manual_seed(0))
    y = torch.tensor([1])
    kernels = (tsl.LONG_SCAN_FWD, tsl.LONG_SCAN_CARRY_BWD, tsl.LONG_SCAN_BWD)
    grads = {}
    for dev in (torch.device("cpu"), cuda_device):
        model.to(dev).zero_grad(set_to_none=True)
        before = [k.launches for k in kernels]
        out = torch.func.functional_call(model, amp_params(model, amp), (x.to(dev),))
        cross_entropy_loss(out.float(), y.to(dev)).backward()
        torch.cuda.synchronize()
        ran = [k.launches - b for k, b in zip(kernels, before)]
        assert ran == ([4, 2, 2] if dev.type == "cuda" else [0, 0, 0]), (dev, ran)
        grads[dev.type] = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    tol = 1e-1 if amp else 1e-4
    for name, g in grads["cuda"].items():
        ref = grads["cpu"][name]
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
        assert (g - ref).abs().max().item() <= tol * ref.abs().max().item(), name


# ---------------------------------------------------------------------------
# K8: Swin window attention
# ---------------------------------------------------------------------------

def _k8_args(gen, bw, v, c, dtype, dev, nw=None):
    """x, wqkv, bqkv, wout, bout, rel, rid, do of one K8 case (heads of 32):
    rid with a few regions per window, as the shifted windows have."""
    heads = c // 32
    t = [_randn(gen, (bw, v, c), 1.0), _randn(gen, (c, 3 * c), c ** -0.5),
         _randn(gen, (3 * c,), 0.1), _randn(gen, (c, c), c ** -0.5), _randn(gen, (c,), 0.1),
         _randn(gen, (heads, v, v), 0.5), _randn(gen, (bw, v, c), 1.0)]
    x, wq, bq, wo, bo, rel, do = (a.to(dev) for a in t)
    rid = None
    if nw is not None:
        rid = torch.randint(0, 4, (nw, v), generator=gen, dtype=torch.int32).to(dev)
    return x.to(dtype), wq.to(dtype), bq, wo.to(dtype), bo, rel, rid, do.to(dtype), heads


# (BW, V, C, nW): the four ptx_attn stages at batch 1 (C = 96 .. 768, 16-token
# windows of shifted blocks), 64-token windows, a window count no tile divides;
# the general path: 7x7 windows, emb_attn's stage 3 (4x8x8 = 256 tokens, C =
# 768) and stage 2 (8x8x8 = 512, C = 384) at batch 1, 7x7x7 windows, 512
# tokens at C = 96 with region ids
K8_CASES = [(16384, 16, 96, 16384), (4096, 16, 192, 4096), (1024, 16, 384, 256),
            (256, 16, 768, 64), (300, 64, 96, 100), (37, 16, 64, None), (5, 64, 128, None),
            (48, 49, 96, 12), (4, 256, 768, 4), (16, 512, 384, 16), (5, 343, 64, None),
            (8, 512, 96, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw,v,c,nw", K8_CASES)
def test_window_attention_kernels_match_plain(cuda_device, dtype, bw, v, c, nw):
    """K8 forward and all six gradients (backward and weight-gradient
    kernels) against the plain version and its VJP on the same inputs: the
    output within _tol of max|out|, each gradient within 1e-3 (fp32: sums
    over up to 2^18 tokens in another order) or 3e-2 (bf16: the kernels
    round the products' operands where the TPU kernel does, the plain VJP
    where autograd does) of its max."""
    x, wq, bq, wo, bo, rel, rid, do, heads = _k8_args(torch.Generator().manual_seed(bw + v),
                                                      bw, v, c, dtype, cuda_device, nw)
    scale = 32 ** -0.5
    out = twa.window_attention_fwd(x, wq, bq, wo, bo, rel, heads, rid, -100.0, scale)
    grads = twa.window_attention_bwd(do, x, wq, bq, wo, bo, rel, heads, rid, -100.0, scale)
    torch.cuda.synchronize()
    ref = twa.window_attention_plain(x, wq, bq, wo, bo, rel, heads, rid, -100.0, scale)
    refs = twa.window_attention_bwd_plain(do, x, wq, bq, wo, bo, rel, heads, rid, -100.0, scale)
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out).all() and err <= _tol(dtype) * ref.float().abs().max().item()
    gtol = 1e-3 if dtype == torch.float32 else 3e-2
    for name, g, r in zip(("dx", "dwqkv", "dbqkv", "dwout", "dbout", "drel"), grads, refs):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        err = (g.float() - r.float()).abs().max().item()
        assert torch.isfinite(g).all() and err <= gtol * r.float().abs().max().item(), (name, err)


@pytest.mark.cuda
def test_window_attention_kernels_are_deterministic_and_refuse(cuda_device):
    """Two launches of each K8 kernel give the same bits (the bias and rel
    gradients sum in per-block slots, the weight gradients in split-K
    partials, both reduced in a fixed order); the Function launches the
    forward once per call and the backward and weight-gradient kernels once
    per gradient, on both paths (V = 16 and 343); the wrappers refuse a CPU
    tensor, a head dim other than 32, windows of 0 or 513 tokens (a larger
    window takes the plain version before the kernels), fp16 and a
    non-contiguous tensor, and take windows of 8 and 128 tokens."""
    kernels = (twa.WINDOW_ATTENTION_FWD, twa.WINDOW_ATTENTION_BWD, twa.WINDOW_ATTENTION_WGRAD)
    for bw, v, nw in ((30, 343, 10), (1000, 16, 250)):
        x, wq, bq, wo, bo, rel, rid, do, heads = _k8_args(
            torch.Generator().manual_seed(9), bw, v, 192, torch.bfloat16, cuda_device, nw)
        args = (x, wq, bq, wo, bo, rel, heads, rid, -100.0, 32 ** -0.5)
        runs = [(twa.window_attention_fwd(*args), *twa.window_attention_bwd(do, *args))
                for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b), v
        before = [k.launches for k in kernels]
        leaf = x.detach().requires_grad_()
        twa.windowed_attention_proj(leaf, wq, bq, wo, bo, rel, heads, rid).backward(do)
        assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1]
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        twa.window_attention_fwd(*cpu)
    with pytest.raises(ValueError, match="CUDA"):
        twa.window_attention_bwd(do.cpu(), *cpu)
    with pytest.raises(ValueError, match="head dim of 32"):
        twa.window_attention_fwd(x, wq, bq, wo, bo, rel[:3].repeat(2, 1, 1)[:12], 12, rid)
    for v in (0, 8, 128, twa.MAX_TOKENS + 1):
        xv = torch.zeros(8, v, 64, device=cuda_device, dtype=torch.bfloat16)
        call = lambda: twa.window_attention_fwd(  # noqa: E731
            xv, wq[:64, :192].contiguous(), bq[:192], wo[:64, :64].contiguous(), bo[:64],
            torch.zeros(2, v, v, device=cuda_device), 2)
        if v in (0, twa.MAX_TOKENS + 1):
            with pytest.raises(ValueError, match="windows of 1 to 512"):
                call()
        else:
            assert torch.isfinite(call()).all()
    with pytest.raises(TypeError):
        twa.window_attention_fwd(x.half(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        twa.window_attention_fwd(x.transpose(0, 1).contiguous().transpose(0, 1), *args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
def test_swin_attention_gradients_on_the_card_match_the_host(cuda_device, amp):
    """A Swin-attention model (embed 32, heads 1/2, depths 2/2, window 4,
    64x64 images at batch 2, both stages shifted): one train step on the
    card launches K8 forward, backward and weight-gradient 4 times each;
    every parameter's gradient is finite and non-zero and, in fp32, within
    1e-4 of its max of the host's (K8's plain version), in bf16 within 1e-1
    (bf16 roundings compounded over the blocks)."""
    from long_context_biomedical_imaging_tpu_torch.losses import cross_entropy_loss
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.setup import check_args, parse_config
    from long_context_biomedical_imaging_tpu_torch.trainer import amp_params

    argv = ["--task_type=class", "--encoder_name=Swin", "--decoder_name=SwinLinear",
            "--height=64", "--width=64", "--no_out_channel=2", "--seed=3",
            "--Swin.size=custom", "--Swin.embed_dim=32", "--Swin.depths", "2", "2",
            "--Swin.num_heads", "1", "2", "--Swin.patch_size", "2", "--Swin.window_size", "4",
            "--Swin.use_hyena", "False"] + (["--use_amp"] if amp else [])
    model = build_model(check_args(parse_config(argv)))
    x = torch.randn(2, 1, 64, 64, 1, generator=torch.Generator().manual_seed(0))
    y = torch.tensor([0, 1])
    kernels = (twa.WINDOW_ATTENTION_FWD, twa.WINDOW_ATTENTION_BWD, twa.WINDOW_ATTENTION_WGRAD)
    grads = {}
    for dev in (torch.device("cpu"), cuda_device):
        model.to(dev).zero_grad(set_to_none=True)
        before = [k.launches for k in kernels]
        out = torch.func.functional_call(model, amp_params(model, amp), (x.to(dev),))
        cross_entropy_loss(out.float(), y.to(dev)).backward()
        torch.cuda.synchronize()
        ran = [k.launches - b for k, b in zip(kernels, before)]
        assert ran == ([4, 4, 4] if dev.type == "cuda" else [0, 0, 0]), (dev, ran)
        grads[dev.type] = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    tol = 1e-1 if amp else 1e-4
    for name, g in grads["cuda"].items():
        ref = grads["cpu"][name]
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
        assert (g - ref).abs().max().item() <= tol * ref.abs().max().item(), name


# K9 (BW, L, d): micro_w7's two stage shapes at batch 4 (7x7 windows of 49
# tokens, d_half 48 and 96), 3x3 windows at a count no tile divides, the
# gate's longest and widest window (N d = 8192)
K9_SHAPES = [(21904, 49, 48), (5476, 49, 96), (3001, 9, 40), (257, 64, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K9_SHAPES)
def test_window_scan_kernels_match_plain(cuda_device, dtype, shape):
    """selective_scan_window on the card (K9: one forward and one backward
    launch) against its plain version (selective_scan_cm) on the same
    inputs: y and the gradients of u, delta, A, B, C, D and delta_bias, at
    K7's tolerances (dA, dD and ddelta_bias sum over up to a million
    tokens)."""
    args = _k7_args(torch.Generator().manual_seed(shape[1]), shape, dtype, cuda_device)
    kernels = (tsw.WINDOW_SCAN_FWD, tsw.WINDOW_SCAN_BWD)
    before = [k.launches for k in kernels]
    got = _k7_vjp(tsw.selective_scan_window, args)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1]
    _check_k7(got, _k7_vjp(tsw.selective_scan_window_plain, args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("softplus", [True, False])
@pytest.mark.parametrize("shape", K9_SHAPES[1:3])
def test_window_scan_passes_match_plain(cuda_device, shape, softplus):
    """Each K9 kernel against its plain pass on the same fp32 inputs, with
    and without softplus: the forward (y) and the backward (du, ddelta, dat,
    dB, dC), within 1e-4 of each output's max (exp2 and softplus forms,
    dat's sum order)."""
    u, delta, a, bm, cm, _, _, g = _k7_args(torch.Generator().manual_seed(9), shape,
                                            torch.float32, cuda_device)
    at = a.t().contiguous()
    if not softplus:
        delta = torch.nn.functional.softplus(delta)
    pairs = [((tsw.window_scan_fwd(u, delta, at, bm, cm, softplus),),
              (tsw.window_scan_fwd_plain(u, delta, at, bm, cm, softplus),)),
             (tsw.window_scan_bwd(u, delta, at, bm, cm, g, softplus),
              tsw.window_scan_bwd_plain(u, delta, at, bm, cm, g, softplus))]
    torch.cuda.synchronize()
    for i, (got, ref) in enumerate(pairs):
        for j, (x, r) in enumerate(zip(got, ref)):
            err = (x - r).abs().max().item()
            assert torch.isfinite(x).all() and err <= 1e-4 * r.abs().max().item(), (i, j, err)


@pytest.mark.cuda
def test_window_scan_kernels_are_deterministic_and_refuse(cuda_device):
    """Two launches of each K9 kernel give the same bits (the backward sums
    dB, dC over the channels and dA over the windows in a fixed order); the
    wrappers refuse a CPU tensor, L > 64, N d > 8192 and d_state 4, each
    with a ValueError naming the limit."""
    u, delta, a, bm, cm, _, _, g = _k7_args(torch.Generator().manual_seed(10), (3001, 49, 96),
                                            torch.float32, cuda_device)
    at = a.t().contiguous()
    runs = [[tsw.window_scan_fwd(u, delta, at, bm, cm),
             *tsw.window_scan_bwd(u, delta, at, bm, cm, g)] for _ in range(2)]
    torch.cuda.synchronize()
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="CUDA"):
        tsw.window_scan_fwd(u.cpu(), delta.cpu(), at.cpu(), bm.cpu(), cm.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        tsw.window_scan_bwd(u.cpu(), delta.cpu(), at.cpu(), bm.cpu(), cm.cpu(), g.cpu())
    long_seq = torch.zeros(4, 65, 96, device=cuda_device)
    long_bc = torch.zeros(4, 65, 8, device=cuda_device)
    with pytest.raises(ValueError, match="L <= 64"):
        tsw.window_scan_fwd(long_seq, long_seq, at, long_bc, long_bc)
    with pytest.raises(ValueError, match="L <= 64"):
        tsw.selective_scan_window(long_seq, long_seq, a, long_bc, long_bc)
    wide = torch.zeros(4, 49, 1040, device=cuda_device)
    with pytest.raises(ValueError, match="8192"):
        tsw.window_scan_fwd(wide, wide, torch.zeros(8, 1040, device=cuda_device), bm[:4],
                            cm[:4])
    with pytest.raises(ValueError, match="d_state 8"):
        tsw.window_scan_fwd(u, delta, at[:4].contiguous(), bm[..., :4].contiguous(),
                            cm[..., :4].contiguous())


@pytest.mark.cuda
def test_mamba_mixer_takes_k9_on_the_card(cuda_device):
    """The Mamba mixer on 2048 windows of 49 tokens (JAX's K9 route) launches
    K9's forward and backward on the card and never the sequential scan;
    its output matches the host's (plain versions) within 1e-4 of max and
    every parameter's gradient within 1e-3 (sums over 100,352 tokens in
    another order)."""
    from long_context_biomedical_imaging_tpu_torch.models import mamba as tmamba

    mixer = tmamba.MambaVisionMixer(96, d_state=8, d_conv=3, expand=1)
    mixer.init_params(torch.Generator().manual_seed(0))
    x = torch.randn(2048, 49, 96, generator=torch.Generator().manual_seed(1))
    results = {}
    for dev in (torch.device("cpu"), cuda_device):
        mixer.to(dev).zero_grad(set_to_none=True)
        before = (tsw.WINDOW_SCAN_FWD.launches, tsw.WINDOW_SCAN_BWD.launches)
        real, used = tmamba.selective_scan_cm, []
        tmamba.selective_scan_cm = lambda *a, **k: used.append(1) or real(*a, **k)
        try:
            out = mixer(x.to(dev))
            out.square().mean().backward()
        finally:
            tmamba.selective_scan_cm = real
        torch.cuda.synchronize()
        ran = (tsw.WINDOW_SCAN_FWD.launches - before[0], tsw.WINDOW_SCAN_BWD.launches - before[1])
        assert not used and ran == ((1, 1) if dev.type == "cuda" else (0, 0)), (dev, ran)
        results[dev.type] = [out.detach().cpu()] + [p.grad.detach().cpu()
                                                    for p in mixer.parameters()]
    for i, (got, ref) in enumerate(zip(results["cuda"], results["cpu"])):
        assert torch.isfinite(got).all() and got.abs().max() > 0, i
        tol = 1e-4 if i == 0 else 1e-3
        assert (got - ref).abs().max().item() <= tol * ref.abs().max().item(), i
