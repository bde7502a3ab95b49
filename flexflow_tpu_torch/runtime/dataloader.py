"""Host-to-device data loading — the port of ``SingleDataLoader`` in
flexflow_tpu/runtime/dataloader.py, for one device.

Full numpy arrays stay on the host; each batch is a row gather copied
to the model's device.  The shuffle draws from
``np.random.default_rng(seed)`` exactly as the reference's does, so the
two packages see the same batches in the same order.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class SingleDataLoader:
    """Iterates (inputs, labels) batches, placed on ``compiled.device``."""

    def __init__(self, compiled, xs: Sequence[np.ndarray], y: np.ndarray,
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True):
        self.device = compiled.device
        self.xs = [np.ascontiguousarray(a) for a in xs]
        self.y = np.ascontiguousarray(y)
        n = self.xs[0].shape[0]
        if any(a.shape[0] != n for a in self.xs) or self.y.shape[0] != n:
            raise ValueError("all inputs and the labels must share the "
                             "sample dim")
        self.num_samples = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_remainder = drop_remainder

    @property
    def num_batches(self) -> int:
        if self.drop_remainder:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def _place(self, array: np.ndarray, idx: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array[idx]).to(self.device)

    def __iter__(self):
        order = np.arange(self.num_samples)
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        for b in range(self.num_batches):
            idx = order[b * bs:(b + 1) * bs]
            yield ([self._place(a, idx) for a in self.xs],
                   self._place(self.y, idx))
