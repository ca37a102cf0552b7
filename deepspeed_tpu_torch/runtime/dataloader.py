"""Data loading (counterpart of ``deepspeed_tpu/runtime/dataloader.py``:
``DeepSpeedDataLoader``, ``RepeatingLoader``, ``default_collate``).

Wraps any indexable dataset (numpy arrays, lists of dicts, a torch
``Dataset``) into batched host trees, numpy arrays or, for samples that
are torch tensors, torch tensors; the engine moves them to its device.
With ``shuffle`` the order of an epoch is numpy's
``default_rng(seed + epoch).permutation``, the JAX package's, so both
packages read the same samples for a seed.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np
import torch


class RepeatingLoader:
    """Wraps an iterable to restart it on StopIteration (JAX :17)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.loader)

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


def default_collate(samples: Sequence[Any]):
    """Stack a list of samples (dicts, tuples or lists, arrays) into one
    batched tree: torch tensors with ``torch.stack``, anything else with
    ``np.stack``."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples])
                           for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(list(samples))
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:
    """Batched loader (JAX ``DeepSpeedDataLoader``, dataloader.py:41).
    Each ``iter()`` starts an epoch: the order from ``data_sampler``, a
    seeded permutation with ``shuffle``, else the dataset's order, in
    batches of ``batch_size`` (the last, short one dropped with
    ``drop_last``)."""

    def __init__(self,
                 dataset,
                 batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 shuffle: bool = False,
                 seed: int = 0,
                 drop_last: bool = True,
                 data_sampler: Optional[Any] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.data_sampler = data_sampler
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Any]:
        n = len(self.dataset)
        if self.data_sampler is not None:
            order = list(self.data_sampler)
        elif self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            order = rng.permutation(n).tolist()
        else:
            order = list(range(n))
        self._epoch += 1
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            yield self.collate_fn([self.dataset[j] for j in idx])
