"""Host -> device input pipeline (mirrors aladin_tpu/data/pipeline.py).

A thread pool tensorizes numpy batches ahead of the device; each batch is
copied to the entry point's device from pinned memory with
``non_blocking=True``, so the copy overlaps the previous batch's compute.
The native reader and tokenizer (``io/native.py``) run without the GIL, so
the pool's threads decode in parallel; each thread has its own decode
buffer, and every row handed out is a copy of it.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

from aladin_torch.models.aladin import Batch


def batch_from_numpy(d: Dict[str, np.ndarray], device: torch.device) -> Batch:
    """A collated numpy batch as a Batch of tensors on ``device``."""
    device = torch.device(device)

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return Batch(**{f: put(d[f]) for f in Batch.__dataclass_fields__})


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def trim_batch(d: Dict[str, np.ndarray], multiple: int) -> Dict[str, np.ndarray]:
    """Trim a collated numpy batch to its longest real text and region
    lengths, rounded up to ``multiple`` (length bucketing for encode; pair
    with ``sort_by_length``). Every kept position computes what the
    full-width batch would."""
    l_t = d["txt_ids"].shape[1]
    r = d["img_feats"].shape[1]
    lab_len = d["img_mask"][:, :l_t].sum(axis=1)
    m_t = min(l_t, _round_up(max(d["cap_len"].max(), lab_len.max()), multiple))
    m_r = min(r, _round_up(d["img_len"].max(), multiple))
    if m_t == l_t and m_r == r:
        return d
    return {
        "txt_ids": d["txt_ids"][:, :m_t],
        "txt_mask": d["txt_mask"][:, :m_t],
        "txt_type": d["txt_type"][:, :m_t],
        "cap_len": d["cap_len"],
        "img_ids": d["img_ids"][:, :m_t],
        "img_mask": np.concatenate(
            [d["img_mask"][:, :m_t], d["img_mask"][:, l_t:l_t + m_r]], axis=1),
        "img_type": d["img_type"][:, :m_t],
        "img_feats": d["img_feats"][:, :m_r],
        "img_len": d["img_len"],
    }


class BatchLoader:
    """Iterates fixed-size batches with shuffle and background prefetch.

    ``shard(rank, ranks)`` makes it a data-parallel rank's loader: every
    rank visits the same global batches in the same shuffled order, and
    this one collates and copies only its rows ``[rank * B / ranks,
    (rank + 1) * B / ranks)`` of each."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, prefetch: int = 2, device="cpu", num_threads: int = 4,
                 sort_by_length: bool = False, trim_multiple: int = 0):
        if sort_by_length and shuffle:
            raise ValueError("sort_by_length and shuffle are mutually exclusive: length "
                             "sorting fixes the visit order (it exists for eval encoding)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.device = torch.device(device)
        self.num_threads = num_threads
        self.sort_by_length = sort_by_length
        self.trim_multiple = trim_multiple
        self.rank, self.ranks = 0, 1

    def shard(self, rank: int, ranks: int) -> None:
        """Yield rank ``rank``'s rows of each global batch from now on."""
        if self.batch_size % ranks:
            raise ValueError(f"batch size {self.batch_size} must be divisible by dp={ranks}")
        self.rank, self.ranks = rank, ranks

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def row_order(self, epoch: int = 0) -> np.ndarray:
        """The dataset-row order this epoch visits."""
        n = len(self.dataset)
        if self.sort_by_length and hasattr(self.dataset, "length_hint"):
            hints = np.asarray([self.dataset.length_hint(i) for i in range(n)])
            return np.argsort(hints, kind="stable")
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        return order

    def _index_batches(self, epoch: int):
        n = len(self.dataset)
        order = self.row_order(epoch)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for s in range(0, stop, self.batch_size):
            idx = order[s:s + self.batch_size]
            if len(idx) < self.batch_size:  # pad the final partial batch by wrapping
                idx = np.concatenate([idx, order[:self.batch_size - len(idx)]])
            rows = self.batch_size // self.ranks  # this rank's rows of the global batch
            yield idx[self.rank * rows:(self.rank + 1) * rows]

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        """Batches of one epoch, in order; at most ``num_threads + prefetch``
        collated batches are in flight."""

        def to_batch(d):
            if self.trim_multiple > 0:
                d = trim_batch(d, self.trim_multiple)
            return batch_from_numpy(d, self.device)

        idx_iter = self._index_batches(epoch)
        if self.num_threads <= 1:
            for idx in idx_iter:
                yield to_batch(self.dataset.collate(idx))
            return
        with ThreadPoolExecutor(self.num_threads) as pool:
            inflight: deque = deque()
            for idx in idx_iter:
                inflight.append(pool.submit(self.dataset.collate, idx))
                if len(inflight) >= self.num_threads + self.prefetch:
                    yield to_batch(inflight.popleft().result())
            while inflight:
                yield to_batch(inflight.popleft().result())
