"""Compiled steps — the port's counterpart of ``jax.jit`` over a step
(reference compiler/lowering.py:694-731, the train step and its
``lax.scan`` over N steps; runtime/decode.py:1047 and :1078, the decode
frame and the chunk pass).

A ``StepGraph`` runs a step function ``fn(*arrays)`` over STATIC input
buffers.  ``fn`` reaches everything else it uses (weights, optimizer
state, KV pools) by closure, updates that in place, and returns fresh
tensors (a tuple, list or dict of them).  Each call copies the caller's
arrays into buffers that keep their addresses: a tensor with
``copy_``, a host numpy array through a pinned host buffer, without
blocking.  It returns STATIC output buffers, which the next call with
the same input shapes overwrites: a caller that keeps a result copies
it.

On the card, the first call for an input-shape key runs ``fn`` eagerly
on the graph's side stream.  That is the call's real execution, and it
launches every kernel instance the graph will hold, so one-time set-up
happens outside the capture: the flash kernels' ``cudaFuncSetAttribute``
statics, the runtime that each ``nvcc``-built library carries, lazy
module loading, cuBLAS workspaces, and the decode kernels' arrival
counters (keyed by stream, allocated at first use).  Then ``fn`` is
captured on the same stream into a ``torch.cuda.CUDAGraph`` (the
eager results are copied into its outputs).  Every later call with
that key replays the graph.  The key also holds the addresses of the
``bound`` tensors, those that ``fn`` reads or updates in place: a
caller that swaps a weight for a new tensor gets a new capture.  A
capture that fails raises; nothing falls back to eager dispatch.

On the CPU, and on the card inside ``eager()`` (the counterpart of
``jax.disable_jit()``), ``fn`` runs eagerly through the same static
buffers, so outputs alias the same way everywhere.

Launch counts.  A kernel wrapper counts a launch when its Python code
runs.  During a capture that code records a kernel without running it,
and a replay runs kernels without any Python.  So a capture's ticks are
taken back and kept per key (``captured_launches``), and each replay
adds them: every ``.launches`` stays the number of kernels that ran,
captured launches x replays on a replayed path.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from flexflow_tpu_torch.kernels import flash_attention as _fa
from flexflow_tpu_torch.kernels import ragged_paged_attention as _rpa

# every kernel wrapper with a ``.launches`` count
COUNTED = (_fa.flash_forward, _fa.flash_backward_dq, _fa.flash_backward_dkv,
           _fa.flash_forward_partial, _rpa.ragged_paged_attention,
           _rpa.ragged_paged_attention_quant)

_EAGER = 0


@contextlib.contextmanager
def eager():
    """Run every ``StepGraph`` eagerly (through its static buffers)
    while inside: no capture, no replay."""
    global _EAGER
    _EAGER += 1
    try:
        yield
    finally:
        _EAGER -= 1


class _Entry:
    """One input-shape key: its static buffers and, once captured, its
    graph."""

    def __init__(self, arrays, device):
        self.inputs = [torch.empty(a.shape, dtype=a.dtype, device=device)
                       for a in arrays]
        self.staging = [None] * len(arrays)  # pinned host buffers
        self.copied = None  # event after the last copy out of staging
        self.outputs = None
        self.spec = None
        self.graph = None
        self.bound = None
        self.launches: Dict[object, int] = {}
        self.replays = 0


_SIDE_STREAMS: Dict[torch.device, object] = {}


def _side_stream(device: torch.device):
    """The one stream every capture on ``device`` runs on: cuBLAS keeps
    a workspace for each stream it has run on, so a stream per program
    (a new one at each ``FFModel.swap_strategy``) would grow the card's
    memory by a workspace at each."""
    stream = _SIDE_STREAMS.get(device)
    if stream is None:
        stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


class StepGraph:
    """A step function's static buffers and captured graphs, one per
    input-shape key, on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._entries: Dict[tuple, _Entry] = {}

    def __call__(self, fn, arrays: Sequence, bound: Sequence = ()):
        """``fn(*static inputs)`` for ``arrays`` (tensors or numpy
        arrays); returns ``fn``'s result as static output buffers.
        ``bound``: the tensors ``fn`` reaches by closure."""
        arrays = [torch.from_numpy(np.ascontiguousarray(a))
                  if isinstance(a, np.ndarray) else a for a in arrays]
        key = tuple((tuple(a.shape), a.dtype) for a in arrays)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _Entry(arrays, self.device)
        self._copy_in(entry, arrays)
        if self.device.type != "cuda" or _EAGER:
            return self._run_eager(entry, fn)
        ptrs = tuple(map(torch.Tensor.data_ptr, bound))
        if entry.graph is None or entry.bound != ptrs:
            return self._capture(entry, fn, ptrs)
        entry.graph.replay()
        for wrapper, n in entry.launches.items():
            wrapper.launches += n
        entry.replays += 1
        return pytree.tree_unflatten(entry.outputs, entry.spec)

    def release(self) -> None:
        """Drop every captured graph and static buffer (a swapped-out
        program's, ``FFModel.swap_strategy``), so the next program's
        captures do not stack on them."""
        self._entries.clear()

    def report(self):
        """Per captured key: input shapes, launches per replay by
        wrapper, replays so far."""
        return [{"shapes": [list(s) for s, _ in key],
                 "captured_launches": {w.__name__: n
                                       for w, n in e.launches.items()},
                 "replays": e.replays}
                for key, e in self._entries.items() if e.graph is not None]

    def _copy_in(self, entry, arrays):
        host = [i for i, (dst, src) in enumerate(zip(entry.inputs, arrays))
                if dst.device.type == "cuda" and src.device.type == "cpu"]
        if host and entry.copied is not None:
            entry.copied.synchronize()  # the last copy out of staging
        for i, (dst, src) in enumerate(zip(entry.inputs, arrays)):
            if i in host:
                if entry.staging[i] is None:
                    entry.staging[i] = torch.empty(
                        dst.shape, dtype=dst.dtype, pin_memory=True)
                entry.staging[i].copy_(src)
                src = entry.staging[i]
            dst.copy_(src, non_blocking=True)
        if host:
            entry.copied = torch.cuda.Event()
            entry.copied.record()

    def _run_eager(self, entry, fn):
        leaves, spec = pytree.tree_flatten(fn(*entry.inputs))
        if entry.outputs is None:
            entry.outputs = [t.detach().clone() for t in leaves]
            entry.spec = spec
        else:
            for dst, src in zip(entry.outputs, leaves):
                dst.copy_(src)
        return pytree.tree_unflatten(entry.outputs, entry.spec)

    def _capture(self, entry, fn, ptrs):
        side = _side_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            # the call's own execution, eager, on the capture's stream
            ran = pytree.tree_leaves(fn(*entry.inputs))
            before = [w.launches for w in COUNTED]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                leaves, spec = pytree.tree_flatten(fn(*entry.inputs))
            entry.launches = {w: w.launches - b
                              for w, b in zip(COUNTED, before)
                              if w.launches != b}
            for w, b in zip(COUNTED, before):
                w.launches = b  # the capture ran nothing
            for dst, src in zip(leaves, ran):
                dst.copy_(src)
        torch.cuda.current_stream(self.device).wait_stream(side)
        entry.graph, entry.bound = graph, ptrs
        entry.outputs, entry.spec = leaves, spec
        return pytree.tree_unflatten(entry.outputs, entry.spec)
