"""Batching data loader and dataset factory (`pcfa_tpu/data/loader.py`).

Numpy batches on the host, decoded one batch ahead by a background
thread while the card attacks the current one. Batches and their order
(with `shuffle`) are those of the JAX package's loader for the same
seed.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator

import numpy as np

from pcfa_tpu_torch import config
from pcfa_tpu_torch.data.datasets import KITTI, MpiSintel
from pcfa_tpu_torch.data.synthetic import SyntheticDataset
from pcfa_tpu_torch.parallel import multihost

_DONE = object()


class _Failed:
    """A worker's exception, handed to the consumer to raise."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class DataLoader:
    """Minimal batched loader: stacks samples along axis 0.

    Yields (img1, img2, flow, valid) float32 numpy batches. `shuffle` draws
    a fresh permutation per epoch from a generator seeded with 0 (the JAX
    loader's default)."""

    def __init__(self, dataset, batch_size=1, shuffle=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(0)

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def _make_batch(self, idx_chunk) -> tuple:
        samples = [self.dataset[int(i)] for i in idx_chunk]
        return tuple(np.stack([s[k] for s in samples]) for k in range(4))

    def __iter__(self) -> Iterator[tuple]:
        idx = self._indices()
        chunks = [idx[i:i + self.batch_size]
                  for i in range(0, len(idx), self.batch_size)]
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def worker():
            try:
                for c in chunks:
                    if stop.is_set():
                        break
                    q.put(self._make_batch(c))
                q.put(_DONE)
            except Exception as e:  # noqa: BLE001 — re-raised by the consumer
                q.put(_Failed(e))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    break
                if isinstance(item, _Failed):
                    raise item.exc
                yield item
        finally:
            # an abandoned or failed iteration: let the worker see `stop`
            # (it may be blocked on a full queue) and end
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()


def prepare_dataloader(
    mode: str = "training",
    dataset: str = "Sintel",
    shuffle: bool = False,
    batch_size: int = 1,
    small_run: bool = False,
    dstype: str = "clean",
):
    """Dataset factory: `dataset` ∈ {Sintel, Kitti15, Synthetic}; returns
    (loader, has_gt). `small_run` truncates to the first 32 samples. Each
    process keeps its contiguous slice of the dataset when
    `torch.distributed` runs more than one process. Synthetic data takes its count and size from
    PCFA_SYNTHETIC_COUNT (32) and PCFA_SYNTHETIC_SIZE=HxW (128x256)."""
    if dataset == "Sintel":
        if mode == "training":
            ds = MpiSintel(split=config.splits("sintel_train"),
                           root=config.paths("sintel_mpi"), dstype=dstype,
                           has_gt=True)
        elif mode == "evaluation":
            ds = MpiSintel(split=config.splits("sintel_eval"),
                           root=config.paths("sintel_mpi"), dstype=dstype,
                           has_gt=False)
        else:
            raise ValueError(f"The specified mode: {mode} is unknown.")
    elif dataset == "Kitti15":
        if mode == "training":
            ds = KITTI(split=config.splits("kitti_train"),
                       root=config.paths("kitti15"), has_gt=True)
        elif mode == "evaluation":
            ds = KITTI(split=config.splits("kitti_eval"),
                       root=config.paths("kitti15"), has_gt=False)
        else:
            raise ValueError(f"The specified mode: {mode} is unknown.")
    elif dataset == "Synthetic":
        count = int(os.environ.get("PCFA_SYNTHETIC_COUNT", 32))
        size_s = os.environ.get("PCFA_SYNTHETIC_SIZE", "128x256")
        h, w = (int(v) for v in size_s.split("x"))
        ds = SyntheticDataset(num_samples=count, size=(h, w),
                              has_gt=(mode == "training"))
    else:
        raise ValueError(
            f"Unknown dataset {dataset}, use 'Sintel', 'Kitti15' or "
            "'Synthetic'.")

    has_gt = ds.has_groundtruth()

    if small_run:
        ds = _Subset(ds, list(range(min(32, len(ds)))))

    if multihost.process_index_and_count()[1] > 1:
        ds = _Subset(ds, multihost.process_shard(len(ds)))

    return DataLoader(ds, batch_size=batch_size, shuffle=shuffle), has_gt


class _Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = indices

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    def has_groundtruth(self):
        return self.dataset.has_groundtruth()
