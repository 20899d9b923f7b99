"""Metric manager (ref: metrics/metrics_base.py:23-438).

Counterpart of the JAX package's ``metrics/manager.py`` for
classification, segmentation and enhancement: AverageMeter batch averaging
of the device-side train stats, exact eval metrics, prediction ``.npy``
dumps, optional wandb logging, and the checkpoint policy: the last and
periodic checkpoints at each train epoch's end and the best-on-val-loss
checkpoint after each val eval. One process, so no cross-process reduction.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.checkpoint import save_checkpoint
from ..utils.wandb_utils import init_wandb
from . import functional as F


class AverageMeter:
    """Batch-weighted running average (ref: metrics_utils.py:32-57)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / self.count if self.count else 0.0


# (train metric names, eval metric names) per task (ref: metrics_base.py:59-115)
TASK_METRICS = {
    "class": (("loss", "auroc"), ("loss", "acc_1", "auroc", "f1")),
    "seg": (("loss", "f1"), ("loss", "f1")),
    "enhance": (("loss", "ssim", "psnr"), ("loss", "ssim", "psnr")),
}


class MetricManager:
    def __init__(self, config):
        self.config = config
        self.wandb_run = None

    def init_wandb(self):
        self.wandb_run = init_wandb(self.config)

    def setup_metrics(self):
        task = self.config.task_type
        train_names, eval_names = TASK_METRICS[task]
        self.train_metrics = {n: AverageMeter() for n in train_names}
        self.eval_metrics = {n: AverageMeter() for n in eval_names}
        self.binary = self.config.no_out_channel in (1, 2)  # ref: :69-72
        self.samplewise = task == "seg"                      # ref: :88-91
        self.best_val_loss = np.inf
        if self.wandb_run is not None:
            self.wandb_run.define_metric("epoch")
            for n in train_names:
                self.wandb_run.define_metric(f"train/{n}", step_metric="epoch")
            for n in eval_names:
                for split in ("val", "test", "train"):
                    self.wandb_run.define_metric(f"{split}/{n}", step_metric="epoch")

    def _postprocess(self, output: np.ndarray, labels: np.ndarray):
        """Class logits -> (positive-class probability or softmax, labels);
        segmentation logits (B, T, H, W, C) -> (argmax over the classes,
        labels), each flattened per sample; enhancement images (B, T, H, W,
        C) -> (B, C, [T,] H, W), time squeezed in 2D (ref:
        metrics_base.py:156-170)."""
        task = self.config.task_type
        if task == "seg":
            hard = output.argmax(axis=-1)
            return hard.reshape(hard.shape[0], -1), labels.reshape(labels.shape[0], -1)
        if task == "enhance":
            out, lab = np.moveaxis(output, -1, 1), np.moveaxis(labels, -1, 1)
            if lab.shape[2] == 1:
                out, lab = out[:, :, 0], lab[:, :, 0]
            return out, lab
        e = np.exp(output - output.max(axis=1, keepdims=True))
        probs = e / e.sum(axis=1, keepdims=True)
        return (probs[:, -1] if self.binary else probs), labels

    def _compute(self, name: str, preds: np.ndarray, labels: np.ndarray) -> float:
        if name == "acc_1":
            return F.accuracy_top1(preds, labels, self.binary)
        if name == "auroc":
            return F.auroc(preds, labels, self.binary)
        if name == "f1":
            return F.f1_score(preds, labels, self.binary, self.config.no_out_channel,
                              samplewise=self.samplewise)
        if name == "psnr":
            return F.psnr(preds, labels)
        if name == "ssim":
            return F.ssim(preds, labels)
        raise NotImplementedError(name)

    # -- train hooks -----------------------------------------------------------

    def on_train_epoch_start(self):
        for m in self.train_metrics.values():
            m.reset()
        self._grad_norm_meter = AverageMeter()

    def on_train_step_end_device(self, stats, names, n, curr_lr=None):
        """Update the meters from one step's device-side stats vector
        [loss, *names, grad_norm], fetched to the host."""
        stats = np.asarray(stats, dtype=np.float64)
        self.train_metrics["loss"].update(float(stats[0]), n=n)
        for name, val in zip(names, stats[1:]):
            if name in self.train_metrics:
                self.train_metrics[name].update(float(val), n=n)
        self._grad_norm_meter.update(float(stats[-1]), n=1)
        if self.wandb_run is not None:
            log = {"grad_norm": float(stats[-1])}
            if curr_lr is not None:
                log["lr"] = float(curr_lr)
            self.wandb_run.log(log)

    def on_train_epoch_end(self, train_state: dict, epoch: int) -> dict:
        """Average the epoch's train meters and save model_last_epoch, and
        model_epoch_{epoch} every --checkpoint_frequency epochs
        (ref: metrics_base.py:212-234)."""
        average = {name: m.avg for name, m in self.train_metrics.items()}
        if self.wandb_run is not None:
            for name, val in average.items():
                self.wandb_run.log({"epoch": epoch, f"train/{name}": val}, commit=False)
            if self._grad_norm_meter.count:
                from ..optim.optim_base import global_norm
                param_norm = float(global_norm(list(train_state["params"].values())))
                self.wandb_run.log({"epoch": epoch, "train/grad_norm": self._grad_norm_meter.avg,
                                    "train/param_norm": param_norm}, commit=False)
        save_checkpoint(self.config, "model_last_epoch", dict(train_state, epoch=epoch))
        if epoch % self.config.checkpoint_frequency == 0:
            save_checkpoint(self.config, f"model_epoch_{epoch}", dict(train_state, epoch=epoch))
        self.average_train_metrics = average
        return average

    # -- eval hooks ------------------------------------------------------------

    def on_eval_epoch_start(self):
        self.all_preds = []
        self.all_labels = []
        for m in self.eval_metrics.values():
            m.reset()

    def on_eval_step_end(self, loss, output, labels, ids, save_samples=False,
                         split="val"):
        """output: (n_valid, classes) or (n_valid, T, H, W, classes) fp32
        logits, or (n_valid, T, H, W, C) images; labels: (n_valid,), (n_valid,
        T, H, W) or (n_valid, T, H, W, C)."""
        output = np.asarray(output)
        labels = np.asarray(labels)
        preds, labels_m = self._postprocess(output, labels)
        n = output.shape[0]
        if self.config.exact_metrics:
            self.all_preds.append(preds)
            self.all_labels.append(labels_m)
        for name, meter in self.eval_metrics.items():
            if name == "loss":
                meter.update(float(loss), n=n)
            elif not self.config.exact_metrics:
                meter.update(self._compute(name, preds, labels_m), n=n)
        if save_samples:
            save_path = os.path.join(self.config.log_dir_run, "saved_samples", split)
            os.makedirs(save_path, exist_ok=True)
            for b_pred, b_out, b_id in zip(preds, output, ids):
                if self.config.task_type == "seg":
                    b_pred = b_pred.reshape(b_out.shape[:-1])   # (T, H, W) class ids
                # enhance: b_pred is the (C, [T,] H, W) image
                np.save(os.path.join(save_path, f"{b_id}_output.npy"),
                        np.asarray(b_pred, dtype=np.float32))

    def on_eval_epoch_end(self, train_state, epoch: int, split: str,
                          final_eval: bool = True) -> dict:
        """Average the eval meters (or compute the exact metrics). After a
        val eval during training (final_eval False) a lower loss than any
        before saves model_best_checkpoint (ref: metrics_base.py:300-305)."""
        if self.config.exact_metrics:
            tail = () if self.binary else (self.config.no_out_channel,)
            preds = (np.concatenate(self.all_preds) if self.all_preds
                     else np.zeros((0,) + tail, np.float32))
            labels = (np.concatenate(self.all_labels) if self.all_labels
                      else np.zeros((0,), np.int64))
            average = {"loss": self.eval_metrics["loss"].avg}
            for name in self.eval_metrics:
                if name != "loss":
                    average[name] = self._compute(name, preds, labels)
        else:
            average = {name: m.avg for name, m in self.eval_metrics.items()}
        if not final_eval and average["loss"] < self.best_val_loss:
            self.best_val_loss = average["loss"]
            save_checkpoint(self.config, "model_best_checkpoint", dict(train_state, epoch=epoch))
        if self.wandb_run is not None:
            if not final_eval:
                self.wandb_run.log({"epoch": epoch, "best_loss": self.best_val_loss},
                                   commit=False)
            for name, val in average.items():
                self.wandb_run.log({"epoch": epoch, f"{split}/{name}": val}, commit=False)
        self.average_eval_metrics = average
        return average

    def on_training_end(self, ran_training: bool = True):
        if self.wandb_run is not None:
            if ran_training:
                self.wandb_run.summary["best_val_loss"] = self.best_val_loss
            self.wandb_run.finish()
