"""PyTorch port, setup and data: the same argv gives the same Config, the
same dataset gives identical items, the loader pads and uploads as
specified, and unported surfaces raise instead of being substituted."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from chip_smoke import ptx_flags
from long_context_biomedical_imaging_tpu.data.dataset import NumpyDataset as JaxNumpyDataset
from long_context_biomedical_imaging_tpu.data.native_io import load_npy_batch as jax_load_npy
from long_context_biomedical_imaging_tpu.setup import check_args as jax_check_args
from long_context_biomedical_imaging_tpu.setup import parse_config as jax_parse_config
from long_context_biomedical_imaging_tpu_torch.data import BatchLoader, NumpyDataset
from long_context_biomedical_imaging_tpu_torch.data.native_io import load_npy_batch
from long_context_biomedical_imaging_tpu_torch.setup import (
    check_args, config_to_yaml, parse_config, parse_config_and_setup_run, resolve_device,
    yaml_to_config)

PTX_ARGV = ptx_flags()  # the flags of projects/run_ptx.sh


@pytest.mark.parametrize("argv", [
    [],
    PTX_ARGV,
    PTX_ARGV + ["--device=cuda", "--train_model=False", "--debug"],
    ["--encoder_name=ViT", "--ViT.patch_size", "16", "--optim_type=lbfgs",
     "--scheduler_type=StepLR", "--task_type=seg", "--decoder_name=UperNet2D"],
], ids=["defaults", "ptx", "ptx_eval_cuda", "vit_seg"])
def test_same_argv_same_config(argv):
    """parse_config and check_args: the same argv gives the same Config in
    both packages (the run names, whose defaults carry the clock, are fixed),
    with one intended difference: without --device the port runs on the
    card (cuda) where the JAX package runs on the TPU."""
    argv = argv + ["--run_name=r", "--inference_run_name=i"]
    ours, ref = parse_config(argv), jax_parse_config(argv)
    given = any(a.startswith("--device") for a in argv)
    for a, b in ((ours.to_dict(), ref.to_dict()),
                 (check_args(ours).to_dict(), jax_check_args(ref).to_dict())):
        if not given:
            assert (a.pop("device"), b.pop("device")) == ("cuda", "tpu")
        assert a == b


def test_ptx_flags_come_from_the_project_script():
    assert PTX_ARGV[0] == "--run_name=ptx_classification"
    assert PTX_ARGV[-1] == "--override" and "$@" not in PTX_ARGV
    cfg = check_args(parse_config(PTX_ARGV))
    assert (cfg.Swin.size, cfg.Swin.use_hyena, cfg.batch_size, cfg.use_amp) == ("tiny", True, 4, True)
    assert cfg.height == cfg.width == 1024 and cfg.Swin.window_size == [4, 4, 4]


def test_unknown_flag_and_yaml_roundtrip(tmp_path):
    with pytest.raises(NameError):
        parse_config(["--not_a_real_flag=3"])
    cfg = parse_config(PTX_ARGV)
    path = os.path.join(tmp_path, "config.yaml")
    config_to_yaml(cfg, path)
    assert yaml_to_config(path).to_dict() == cfg.to_dict()


def _make_dataset(root, n=6, h=20, w=24, rng=None):
    rng = rng or np.random.default_rng(0)
    rows = []
    for i in range(n):
        sid = f"subj{i:03d}"
        os.makedirs(os.path.join(root, sid), exist_ok=True)
        np.save(os.path.join(root, sid, f"{sid}_input.npy"),
                rng.normal(size=(h, w)).astype(np.float32))
        rows.append((sid, int(rng.integers(0, 2))))
    pd.DataFrame({"SubjectID": [r[0] for r in rows],
                  "Label": [r[1] for r in rows]}).to_csv(
        os.path.join(root, "x_metadata.csv"), index=False)
    return root


@pytest.mark.parametrize("split", ["train", "val"])
def test_numpy_dataset_items_identical(tmp_path, split):
    """NumpyDataset: identical subject lists and items (resize, augmentations
    with the per-item seeded draws, labels) in both packages: exact."""
    _make_dataset(str(tmp_path))
    argv = [f"--data_dir={tmp_path}", "--height=16", "--width=16", "--seed=5",
            "--affine_aug=True", "--brightness_aug=True", "--gaussian_blur_aug=True",
            "--run_name=r"]
    ours = NumpyDataset(check_args(parse_config(argv)), split)
    ref = JaxNumpyDataset(jax_check_args(jax_parse_config(argv)), split)
    assert ours.subject_ids == ref.subject_ids and len(ours) > 0
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        np.testing.assert_array_equal(a[0], b[0])
        assert a[0].shape == (1, 16, 16, 1) and a[0].dtype == np.float32
        assert int(a[1]) == int(b[1]) and a[2] == b[2]


def test_native_io_matches_jax(tmp_path):
    """The copied native reader returns the same arrays (exact)."""
    _make_dataset(str(tmp_path), n=3)
    paths = sorted(str(p) for p in tmp_path.glob("*/*_input.npy"))
    for a, b in zip(load_npy_batch(paths), jax_load_npy(paths)):
        np.testing.assert_array_equal(a, b)


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((1, 2, 2, 1), i, np.float32), np.int32(i % 2), f"s{i}"


@pytest.mark.parametrize("n,expect", [(5, [(4, 4), (4, 2)]), (8, [(4, 4), (4, 4)]),
                                      (6, [(4, 4), (4, 2)])])
def test_loader_pads_last_batch(n, expect):
    """Ragged last batch: padded with its first row to the batch size; n_valid
    counts the real rows (a singleton is duplicated first). Labels int64,
    images float32, on the requested device, in dataset order."""
    loader = BatchLoader(_Items(n), 4, torch.device("cpu"), num_workers=2,
                         prefetch_batches=2)
    got = list(loader)
    assert [(im.shape[0], nv) for im, _, _, nv in got] == expect
    for images, labels, ids, n_valid in got:
        assert images.dtype == torch.float32 and labels.dtype == torch.int64
        assert images.device.type == "cpu"
    first = got[0][0][:, 0, 0, 0, 0].tolist()
    assert first == [0.0, 1.0, 2.0, 3.0]
    tail_images, _, _, tail_valid = got[-1]
    if tail_valid < 4:
        assert tail_images[-1, 0, 0, 0, 0] == tail_images[0, 0, 0, 0, 0]


def test_loader_surfaces_item_errors():
    class Bad(_Items):
        def __getitem__(self, i):
            raise OSError("unreadable")

    with pytest.raises(OSError):
        list(BatchLoader(Bad(3), 2, torch.device("cpu")))


def test_device_cuda_raises_without_gpu(monkeypatch):
    """--device=cuda with no card raises: no fallback to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(parse_config(["--device=cuda"]))
    assert resolve_device(parse_config(["--device=cpu"])) == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device(parse_config(["--device=tpu"]))


_EVAL = ["--train_model=False", "--device=cpu", "--task_type=class",
         "--encoder_name=Swin", "--decoder_name=SwinLinear"]


@pytest.mark.parametrize("extra", [
    ["--train_model=True", "--with_timer"],
    ["--train_model=True", "--optim_type=nadam"],
    ["--train_model=True", "--optim_type=lbfgs"],
    ["--model_parallel=2"],
    ["--encoder_name=ViT", "--decoder_name=UperNet2D", "--task_type=seg"],
    ["--Swin.use_hyena=False"],
    ["--task_type=seg", "--decoder_name=UperNet3D", "--time=16"],
    ["--task_type=enhance", "--decoder_name=SwinUNETR", "--loss_func=MSE"],
    ["--ddp"],
], ids=["train_timer", "train_nadam", "train_lbfgs", "model_parallel", "vit", "attention",
        "seg_head", "enhance_head", "ddp"])
def test_unported_surfaces_raise(tmp_path, extra):
    """Each surface the port does not run yet raises NotImplementedError
    before the run directory is made."""
    with pytest.raises(NotImplementedError):
        parse_config_and_setup_run(_EVAL + extra + [f"--log_dir={tmp_path}", "--run_name=r"])
    assert not os.path.exists(os.path.join(tmp_path, "r"))


def test_world_size_above_one_raises(tmp_path, monkeypatch):
    """Under a launcher that sets WORLD_SIZE > 1 (torchrun), setup raises
    NotImplementedError naming the data-parallel slice before the run
    directory is made, instead of training alone on all the data in every
    process; WORLD_SIZE=1 sets up."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="data-parallel"):
        parse_config_and_setup_run(_EVAL + [f"--log_dir={tmp_path}", "--run_name=r"])
    assert not os.path.exists(os.path.join(tmp_path, "r"))
    monkeypatch.setenv("WORLD_SIZE", "1")
    cfg = parse_config_and_setup_run(_EVAL + ["--Swin.use_hyena=True", f"--log_dir={tmp_path}",
                                              "--run_name=r"])
    assert os.path.isdir(cfg.log_dir_run)


@pytest.mark.parametrize("train", [False, True])
def test_vit_hyena_sets_up(tmp_path, train):
    """The ViT-hyena slice's surface (ViT with the Hyena mixer and ViTLinear)
    sets up a run, evaluation and training; the model holds the Hyena
    operator in each block, no position embedding and no cls token, and its
    head mean-pools."""
    from long_context_biomedical_imaging_tpu_torch.models import build_model

    extra = ["--encoder_name=ViT", "--decoder_name=ViTLinear", "--ViT.use_hyena=True",
             "--ViT.size=custom", "--ViT.hidden_size=32", "--ViT.mlp_dim=64",
             "--ViT.num_layers=1", "--ViT.num_heads=2", "--height=32", "--width=32"]
    cfg = parse_config_and_setup_run(_EVAL + extra + [f"--train_model={train}",
                                                      f"--log_dir={tmp_path}", "--run_name=r"])
    assert os.path.isdir(os.path.join(cfg.log_dir_run, "models"))
    model = build_model(cfg)
    assert model.encoder.block_0.attn.hyena is not None
    assert model.encoder.cls_token is None
    assert model.encoder.patch_embedding.position_embeddings is None
    assert not model.decoder.use_cls_token


@pytest.mark.parametrize("train", [False, True])
def test_vit_mamba_sets_up(tmp_path, train):
    """The ViT-mamba surface (--encoder_name=ViT --decoder_name=ViTLinear
    --ViT.use_mamba=True), refused until the ViT-mamba slice, sets up a run,
    evaluation and training; the model holds the Mamba mixer (d_state 8,
    3-tap conv, expand 1) in each block, no position embedding and no cls
    token, and its head mean-pools a forward's tokens."""
    from long_context_biomedical_imaging_tpu_torch.models import build_model
    from long_context_biomedical_imaging_tpu_torch.models.mamba import MambaVisionMixer

    extra = ["--encoder_name=ViT", "--decoder_name=ViTLinear", "--ViT.use_mamba=True",
             "--ViT.size=custom", "--ViT.hidden_size=32", "--ViT.mlp_dim=64",
             "--ViT.num_layers=1", "--ViT.num_heads=2", "--height=32", "--width=32"]
    cfg = parse_config_and_setup_run(_EVAL + extra + [f"--train_model={train}",
                                                      f"--log_dir={tmp_path}", "--run_name=r"])
    assert os.path.isdir(os.path.join(cfg.log_dir_run, "models"))
    model = build_model(cfg)
    mixer = model.encoder.block_0.attn.mamba
    assert isinstance(mixer, MambaVisionMixer) and model.encoder.block_0.attn.hyena is None
    assert (mixer.d_state, mixer.d_conv, mixer.expand) == (8, 3, 1)
    assert model.encoder.cls_token is None
    assert model.encoder.patch_embedding.position_embeddings is None
    assert not model.decoder.use_cls_token
    assert model(torch.zeros(1, 1, 32, 32, 1)).shape == (1, 2)


@pytest.mark.parametrize("extra", [
    ["--Swin.use_hyena=False", "--Swin.use_mamba=True"],
    ["--task_type=seg", "--decoder_name=UperNet2D", "--Swin.use_hyena=False",
     "--Swin.use_mamba=True"],
    ["--train_model=True", "--task_type=seg", "--decoder_name=UperNet2D",
     "--Swin.use_hyena=True"],
], ids=["mamba", "vessel_eval", "hyena_seg_train"])
def test_vessel_surfaces_set_up(tmp_path, extra):
    """The vessel slice's surfaces (the Mamba Swin mixer, segmentation with
    UperNet2D) set up a run, and the Swin block holds the mixer its flags
    name (setup refuses both flags at once)."""
    from long_context_biomedical_imaging_tpu_torch.models.swin import WindowAttention

    cfg = parse_config_and_setup_run(_EVAL + extra + [f"--log_dir={tmp_path}", "--run_name=r"])
    assert os.path.isdir(os.path.join(cfg.log_dir_run, "models"))
    attn = WindowAttention(32, 2, bool(cfg.Swin.use_hyena), bool(cfg.Swin.use_mamba))
    assert attn.mixer_name == ("hyena" if cfg.Swin.use_hyena else "mamba")
    assert not hasattr(attn, "mamba" if cfg.Swin.use_hyena else "hyena")


@pytest.mark.parametrize("extra", [["--with_timer"], ["--optim_type=nadam"],
                                   ["--optim_type=lbfgs"]])
def test_eval_only_ignores_training_surfaces(tmp_path, extra):
    """An evaluation-only run sets up whatever --with_timer or optimizer it
    is given (they only matter to training) and makes the run's models/
    directory."""
    cfg = parse_config_and_setup_run(_EVAL + extra + ["--Swin.use_hyena=True",
                                                      f"--log_dir={tmp_path}", "--run_name=r"])
    assert os.path.isdir(os.path.join(cfg.log_dir_run, "models"))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_loader_shuffle_is_seeded_per_epoch(seed):
    """Shuffled order: the JAX BatchLoader's, np.random.default_rng(seed *
    100003 + epoch), for every epoch, so one --seed trains on the same
    batches in both packages; another epoch reorders."""
    from long_context_biomedical_imaging_tpu.data.loader import BatchLoader as JaxBatchLoader

    def order(loader_cls, epoch, **kw):
        loader = loader_cls(_Items(11), 4, shuffle=True, seed=seed, num_workers=2, **kw)
        loader.set_epoch(epoch)
        return [int(v) for batch in loader for v in np.asarray(batch[0])[:batch[3], 0, 0, 0, 0]]

    orders = []
    for epoch in range(3):
        ours = order(BatchLoader, epoch, device=torch.device("cpu"))
        assert ours == order(JaxBatchLoader, epoch), epoch
        assert sorted(ours) == list(range(11))
        orders.append(ours)
    assert orders[0] != orders[1]


def test_yaml_load_path_reproduces_a_run_config(tmp_path):
    """--yaml_load_path reloads a saved run config under a new run name."""
    first = parse_config_and_setup_run(_EVAL + ["--Swin.use_hyena=True", "--seed=9",
                                                f"--log_dir={tmp_path}", "--run_name=a"])
    saved = os.path.join(first.log_dir_run, "config.yaml")
    again = parse_config_and_setup_run([f"--yaml_load_path={saved}", f"--log_dir={tmp_path}",
                                        "--run_name=b"])
    assert again.log_dir_run == os.path.join(str(tmp_path), "b") and again.seed == 9
    assert yaml_to_config(os.path.join(again.log_dir_run, "config.yaml")).Swin.use_hyena
