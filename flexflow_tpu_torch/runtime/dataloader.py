"""Host-to-device data loading — the port of ``SingleDataLoader`` in
flexflow_tpu/runtime/dataloader.py.

Full numpy arrays stay on the host; each batch is a row gather copied
to the model's device.  The shuffle draws from
``np.random.default_rng(seed)`` exactly as the reference's does, so the
two packages see the same batches in the same order, and so does every
rank of a job.  Under a strategy each rank is handed its block of each
input, as the input's annotation splits it (``CompiledModel
.input_slices``), and of the labels, as the sink's batch and sequence
split them (``label_slices``): the other dims are cut once here, the
batch dim from each batch's rows.  ``iter_traced(n)`` yields
the same batches in the same order, n at a time stacked on a leading
step axis for ``CompiledModel.train_steps``.

Rows are gathered through the native threaded gather
(``native.gather_rows``, native/src/dataloader.cpp) from 1 MiB of
gathered rows up, as the reference does (dataloader.py:57-71), and
through numpy below that or with ``FLEXFLOW_TPU_NO_NATIVE=1``.  The
reference's multi-host placement (each process gathers only its slice
of a batch's rows and the global array is assembled from them) is what
the per-rank blocks above already do: every rank draws the same
order and gathers only its own rows and dims of each batch.
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
        n = xs[0].shape[0]
        if any(a.shape[0] != n for a in xs) or y.shape[0] != n:
            raise ValueError("all inputs and the labels must share the "
                             "sample dim")
        # each array's block: the rows of a batch (a slice of it), the
        # rest of its dims cut here
        shapes = [(batch_size,) + a.shape[1:] for a in xs]
        blocks = [compiled.input_slices(i, s) for i, s in enumerate(shapes)]
        blocks.append(compiled.label_slices((batch_size,) + y.shape[1:]))
        self._rows = [b[0] for b in blocks]
        self.xs = [np.ascontiguousarray(a[(slice(None),) + b[1:]])
                   for a, b in zip(xs, blocks)]
        self.y = np.ascontiguousarray(y[(slice(None),) + blocks[-1][1:]])
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

    @staticmethod
    def _gather(a: np.ndarray, idx: np.ndarray) -> np.ndarray:
        """``a[idx]``: the threaded native gather from 1 MiB of rows up
        (threads pay off there), numpy below or without the library."""
        row_bytes = a.dtype.itemsize * int(np.prod(a.shape[1:],
                                                   dtype=np.int64))
        if row_bytes * len(idx) >= 1 << 20:
            from flexflow_tpu_torch import native

            out = native.gather_rows(a, idx)
            if out is not None:
                return out
        return a[idx]

    def _place(self, array: np.ndarray, idx: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(self._gather(array, idx)).to(self.device)

    def _batch(self, idx: np.ndarray):
        """(inputs, labels) of the batch of global rows ``idx``: this
        rank's rows of each."""
        return ([self._place(a, idx[r]) for a, r in zip(self.xs, self._rows)],
                self._place(self.y, idx[self._rows[-1]]))

    def _order(self) -> np.ndarray:
        order = np.arange(self.num_samples)
        if self.shuffle:
            self.rng.shuffle(order)
        return order

    def skip_epochs(self, n: int) -> None:
        """Draw and drop ``n`` epochs' orders: the next epoch sees the
        order epoch ``n`` would have (a resumed ``fit``)."""
        for _ in range(n):
            self._order()

    def __iter__(self):
        order = self._order()
        bs = self.batch_size
        for b in range(self.num_batches):
            yield self._batch(order[b * bs:(b + 1) * bs])

    def iter_traced(self, n: int):
        """Yield ``('stack', inputs, labels)`` with a leading [n] step
        axis for ``CompiledModel.train_steps``, then the batches that do
        not fill a stack as ``('single', inputs, labels)``: the
        reference's ``iter_traced`` (dataloader.py:107-140).  Stacks take
        full batches only, and one process (``fit`` uses them only
        there)."""
        order = self._order()
        bs = self.batch_size
        stacks = (self.num_samples // bs) // n
        for s in range(stacks):
            idx = order[s * n * bs:(s + 1) * n * bs]
            yield ("stack",
                   [self._place(a, idx).reshape((n, bs) + a.shape[1:])
                    for a in self.xs],
                   self._place(self.y, idx).reshape(
                       (n, bs) + self.y.shape[1:]))
        for b in range(stacks * n, self.num_batches):
            yield ("single", *self._batch(order[b * bs:(b + 1) * bs]))
