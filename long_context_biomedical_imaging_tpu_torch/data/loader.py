"""Host-side streaming batch loader with device upload.

Counterpart of the JAX package's ``data/loader.py``: a thread pool reads and
augments items, a producer thread collates them into batches and keeps up to
``prefetch_batches`` of them queued. For a CUDA device the producer also
copies each batch into pinned host memory, and the consumer uploads it with
``non_blocking=True``, so the copy overlaps the previous batch's compute.

A ragged last batch is padded with repeats of its first row up to the batch
size (one shape for every step); ``n_valid`` says how many rows are real.
Batch-size-1 batches are duplicated as in the reference (BatchNorm heads need
two rows). Images stay float32; integer labels (class ids, masks) become
int64 and float targets (enhancement images) pass through as float32, never
cast to an integer type. Shuffling draws the JAX package's order:
``np.random.default_rng(seed * 100003 + epoch)``.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


class BatchLoader:
    """Yields (images, labels, ids, n_valid): images (B, T, H, W, C) float32
    and labels (int64 ids or float32 images) on ``device``, ids a list,
    n_valid an int."""

    def __init__(self, dataset, batch_size: int, device: torch.device,
                 shuffle: bool = False, seed: int = 0, num_workers: int = 4,
                 prefetch_batches: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = device
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            # the JAX package's draw, so one --seed trains on the same batches
            np.random.default_rng(self.seed * 100_003 + self.epoch).shuffle(idx)
        return idx

    def _collate(self, pool, batch_idx):
        items = list(pool.map(self.dataset.__getitem__, batch_idx))
        images = np.stack([it[0] for it in items])
        labels = np.stack([it[1] for it in items])
        ids = [it[2] for it in items]
        n_valid = images.shape[0]
        if n_valid == 1:
            images = np.concatenate([images, images])
            labels = np.concatenate([labels, labels])
            ids = ids + ids
            n_valid = 2
        if images.shape[0] < self.batch_size:
            reps = self.batch_size - images.shape[0]
            images = np.concatenate([images, images[:1].repeat(reps, axis=0)])
            labels = np.concatenate([labels, labels[:1].repeat(reps, axis=0)])
        images = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
        labels = np.ascontiguousarray(labels)
        labels = torch.from_numpy(labels.astype(np.float32 if labels.dtype.kind == "f"
                                                else np.int64))
        if self.device.type == "cuda":
            images, labels = images.pin_memory(), labels.pin_memory()
        return images, labels, ids, n_valid

    def __iter__(self):
        idx = self._indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        error: list = []

        def put_or_stop(item) -> bool:
            # never block forever: an early-exiting consumer (e.g. --debug)
            # sets `stop` and must be able to unblock a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        pool = ThreadPoolExecutor(max_workers=self.num_workers)

        def producer():
            try:
                for b in batches:
                    if stop.is_set() or not put_or_stop(self._collate(pool, b)):
                        return
            except BaseException as e:  # handed to the consumer below
                error.append(e)
            finally:
                put_or_stop(None)   # the end-of-epoch sentinel is never dropped

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                try:
                    item = q.get(timeout=5.0)
                except queue.Empty:
                    if not thread.is_alive():
                        break  # producer died without a sentinel
                    continue
                if item is None:
                    break
                images, labels, ids, n_valid = item
                yield (images.to(self.device, non_blocking=True),
                       labels.to(self.device, non_blocking=True), ids, n_valid)
            if error:
                raise error[0]
        finally:
            stop.set()
            # drain so a producer blocked on a full queue can observe `stop`
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=5.0)
            pool.shutdown(wait=False)
