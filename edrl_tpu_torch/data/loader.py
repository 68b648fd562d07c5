"""Batching, splitting and background prefetch (``edrl_tpu/data/loader.py``, copied).

``BatchLoader`` replaces the reference's ``DataLoader(batch_size, drop_last,
num_workers=8)`` (``fusion_train.py:583-594``): a thread pool builds
fixed-shape numpy batches behind a bounded prefetch queue, with epoch-indexed
shuffles and uint8 transport of clean batches.  The threads touch numpy
only; the trainer copies each batch to the card (pinned, ``non_blocking``).

``kfold_split`` reproduces the reference's 5-fold file split,
``KFold(n_splits=5, shuffle=True, random_state=10)`` (``fusion_train.py:564``),
with sklearn's shuffling.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


def kfold_split(
    items: Sequence, n_splits: int = 5, seed: int = 10
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """sklearn-compatible shuffled KFold: permute indices with the seeded RNG,
    then cut into ``n_splits`` contiguous test folds of balanced sizes."""
    n = len(items)
    idx = np.arange(n)
    np.random.RandomState(seed).shuffle(idx)
    sizes = np.full(n_splits, n // n_splits, dtype=np.int64)
    sizes[: n % n_splits] += 1
    out = []
    start = 0
    arr = np.asarray(items)
    for size in sizes:
        test = idx[start : start + size]
        train = np.concatenate([idx[:start], idx[start + size :]])
        out.append((arr[train], arr[test]))
        start += size
    return out


def _stack_batch(
    samples: List[Dict[str, np.ndarray]], uint8_transport: bool = False
) -> Dict[str, np.ndarray]:
    batch = {}
    for key in samples[0]:
        batch[key] = np.stack([s[key] for s in samples])
    # Model-facing layout: fundus NHWC, OCT NDHWC (add channel dim).
    for key in ("oct_low", "oct_high", "oct"):
        if key in batch and batch[key].ndim == 4:
            batch[key] = batch[key][..., None]
    if uint8_transport:
        # Clean single-view batches quantize losslessly (8-bit sources);
        # the device side divides by 255 (see trainer steps).
        for key in ("fundus", "oct"):
            if key in batch and batch[key].dtype == np.float32:
                batch[key] = np.clip(
                    np.rint(batch[key] * 255.0), 0, 255
                ).astype(np.uint8)
    return batch


class BatchLoader:
    """Iterate fixed-shape batches with shuffling, drop_last, and prefetch."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 2,
        uint8_transport: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.uint8_transport = uint8_transport

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])
            ).shuffle(order)
        num_batches = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for b in range(num_batches):
                        if stop.is_set():
                            return
                        idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
                        samples = list(
                            pool.map(lambda i: self.dataset.get(int(i), epoch), idxs)
                        )
                        q.put(_stack_batch(samples, self.uint8_transport))
                q.put(None)
            except BaseException as exc:  # forward to the consumer
                q.put(exc)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            # Drain so a blocked producer can observe `stop` and exit.
            while not q.empty():
                q.get_nowait()
