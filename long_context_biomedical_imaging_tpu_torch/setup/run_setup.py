"""Run setup: logging, seeding, directories and the device.

Counterpart of the JAX package's ``setup/run_setup.py``. A run is one process
on one device: ``--device=cuda`` is the first CUDA card and must exist,
``--device=cpu`` the host. There is no distributed initialisation: ``--ddp``
and a ``WORLD_SIZE`` above 1 raise until the data-parallel slice.

Surfaces that are not ported yet raise ``NotImplementedError`` naming the
ROADMAP.md slice that ports them, before any directory is made; nothing is
silently substituted.
"""

from __future__ import annotations

import logging
import os
import random
import sys
from datetime import datetime

import numpy as np
import torch

from ..losses import get_loss_func
from ..models.model_base import check_ported
from ..optim.optim_base import reject_unported_optim
from .config import Config, check_args, config_to_yaml, yaml_to_config
from .parsers import parse_config

_LATER = "ROADMAP.md queue 1"


def set_seed(seed: int | None) -> None:
    """Seed the host-side RNGs. Model init and shuffling take their own
    ``torch.Generator`` seeded from the same value."""
    if seed is None:
        return
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def setup_logger(config: Config) -> logging.Logger:
    """File + stream logging per run dir (ref: setup/setup_utils.py:41-62)."""
    os.makedirs(config.log_dir_run, exist_ok=True)
    log_path = os.path.join(config.log_dir_run, "run.log")

    logger = logging.getLogger("lcbi")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s")
    fh = logging.FileHandler(log_path)
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)

    file_only = logging.getLogger("lcbi.file_only")
    file_only.setLevel(logging.INFO)
    file_only.handlers.clear()
    file_only.addHandler(fh)
    file_only.propagate = False
    return logger


def resolve_device(config: Config) -> torch.device:
    """The run's torch.device from ``--device``. ``cuda`` without a card
    raises; there is no fallback to the host."""
    name = config.get("device")
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device=cuda but torch.cuda.is_available() is "
                               "False: no CUDA card is visible")
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"--device={name} is not a device of the PyTorch port; "
                     "use cuda or cpu")


def reject_unported(config: Config) -> None:
    """Raise NotImplementedError for every surface the port does not run yet."""
    if config.get("train_model"):
        if config.get("with_timer"):
            raise NotImplementedError(
                f"--with_timer: the step timer and profiler trace are ported with "
                f"utils/status.py ({_LATER})")
        reject_unported_optim(config)
    if config.get("ddp") or int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        raise NotImplementedError(
            f"--ddp or WORLD_SIZE > 1: data-parallel training comes with the "
            f"data-parallel slice ({_LATER})")
    if int(config.get("model_parallel", 1) or 1) > 1:
        raise NotImplementedError(
            f"--model_parallel > 1: sequence parallelism is the last slice "
            f"({_LATER})")
    check_ported(config)
    get_loss_func(config.loss_func)


def rewire_inference_only(config: Config) -> Config:
    """--inference_only: load ``config.yaml`` of ``--inference_dir``, force an
    evaluation-only run of its best checkpoint on val and test, saving the
    test predictions, under --inference_log_dir / --inference_run_name
    (ref: setup/setup_base.py:59-102)."""
    assert config.inference_dir not in (None, "None", "none"), \
        "If inference_only is True, inference_dir must be specified"
    assert os.path.exists(config.inference_dir), \
        f"inference_dir {config.inference_dir} does not exist"
    inference_dir = config.inference_dir
    new_log_dir = config.inference_log_dir
    new_run_name = config.inference_run_name
    config = yaml_to_config(os.path.join(inference_dir, "config.yaml"))
    config.log_dir = new_log_dir
    config.run_name = new_run_name
    config.inference_dir = inference_dir
    config.inference_only = True
    config.train_model = False
    config.model_load_path = os.path.join(inference_dir, "models", "model_best_checkpoint")
    config.eval_train_set = False
    config.eval_val_set = True
    config.eval_test_set = True
    config.save_train_samples = False
    config.save_val_samples = False
    config.save_test_samples = True
    config.override = True
    return config


def setup_run(config: Config) -> Config:
    """Date, dirs, seed and logging (ref: setup/setup_utils.py:88-129)."""
    config.date = datetime.now().strftime("%Y-%m-%d")
    config.log_dir_run = os.path.join(config.log_dir, config.run_name)
    if os.path.exists(os.path.join(config.log_dir_run, "config.yaml")) and not config.get(
            "override", False) and config.get("train_model", True):
        raise FileExistsError(
            f"{config.log_dir_run} already contains a run; pass --override to overwrite")
    os.makedirs(config.log_dir_run, exist_ok=True)
    os.makedirs(os.path.join(config.log_dir_run, "models"), exist_ok=True)
    setup_logger(config)
    set_seed(config.get("seed"))
    config.world_size = 1
    config.global_rank = 0
    config.local_device_count = 1
    return config


def parse_config_and_setup_run(argv=None, custom_parser=None) -> Config:
    """Parse flags -> Config, apply the yaml and inference-only rewiring,
    validate, reject what is not ported, set up. Returns the Config;
    :func:`resolve_device` gives its device."""
    config = parse_config(argv=argv, custom_parser=custom_parser)

    if config.yaml_load_path is not None:
        loaded = yaml_to_config(config.yaml_load_path)
        loaded.log_dir = config.log_dir
        loaded.run_name = config.run_name
        config = loaded

    if config.inference_only:
        config = rewire_inference_only(config)

    reject_unported(config)
    check_args(config)
    resolve_device(config)
    setup_run(config)
    config_to_yaml(config, os.path.join(config.log_dir_run, "config.yaml"))
    return config
