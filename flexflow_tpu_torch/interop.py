"""Carry parameters and state between the JAX package and the port.

``params_from_numpy`` and ``state_from_numpy`` take the reference's
``params[op][weight]`` and ``state["<op>/<var>"]`` dicts as numpy
arrays (``np.asarray`` of each JAX array) and return the port's tensors
on a chosen device; ``params_to_numpy`` is the way back (host numpy
arrays, e.g. to compare gradients and updated weights).  Given the
``CompiledModel`` of a strategy over several ranks, ``params_from_numpy``
keeps this rank's block of each whole weight and ``params_to_numpy``
gathers the blocks into whole weights (a collective: every rank calls
it), so tests compare whole weights whatever the strategy; the pipelined,
placed and staged models' ranks hold only their stage's or segment's
ops, and their ``gather_weights`` brings every weight to every rank.
``stacked_to_blocks`` and ``blocks_to_stacked`` carry weights between
the JAX package's pipelined layout (each block weight stacked over the
blocks under block 0's op name) and the port's (each block's own op
names).  bfloat16 is
carried bit for bit both ways (numpy's ml_dtypes extension type, loaded
only when a bfloat16 tensor goes back).  This is how a test makes both
packages compute the same function.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    a = np.array(a)  # a writable copy the tensor may own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@torch.no_grad()
def params_to_numpy(params, compiled=None
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """Host copies of ``params``; given a compiled model of several
    ranks, the whole weights of every op in ``params`` (gathered: every
    rank calls it with the same op names), or of every op of the model
    when ``params`` is all this rank holds (a pipelined, placed or
    staged model's ranks hold different ops)."""
    if compiled is not None:
        names = [(op, w) for op, ws in params.items() for w in ws]
        if set(names) == {(op, w) for op, w in compiled.weight_names()
                          if compiled.holds(op)}:
            names = None  # all this rank holds: every weight of the job
        params = compiled.gather_weights(params, names)
    return {op: {w: tensor_to_numpy(v) for w, v in ws.items()}
            for op, ws in params.items()}


def params_from_numpy(params, device="cpu", compiled=None
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's tensors of whole numpy weights; given a compiled
    model, this rank's blocks of the ops it holds."""
    if compiled is not None:
        return compiled.local_weights(
            {op: {w: np.asarray(v) for w, v in ws.items()}
             for op, ws in params.items()}, device)
    return {op: {w: tensor_from_numpy(v, device) for w, v in ws.items()}
            for op, ws in params.items()}


def _block_names(graph, block_of=None):
    from flexflow_tpu_torch.compiler.pipeline_lowering import detect_blocks

    blocks, _, _ = detect_blocks(graph, block_of)
    return [[n.op.name for n in blk] for blk in blocks]


def stacked_to_blocks(params, graph, block_of=None
                      ) -> Dict[str, Dict[str, np.ndarray]]:
    """The JAX package's pipelined layout -> whole weights by op name.
    The reference's ``PipelinedCompiledModel`` keeps each block weight
    as ``params[<block-0 op>][w]`` with a leading [L] axis (block b's
    slice initialised from ``fold_in(k, b)``); the port keeps block b's
    weights under block b's own op names.  ``graph`` (and ``block_of``)
    give the blocks, as ``compile(pipeline=...)`` finds them."""
    names = _block_names(graph, block_of)
    tmpl = names[0]
    out = {}
    for op, ws in params.items():
        if op in tmpl:
            i = tmpl.index(op)
            for b, blk in enumerate(names):
                out[blk[i]] = {w: np.asarray(v)[b] for w, v in ws.items()}
        else:
            out[op] = {w: np.asarray(v) for w, v in ws.items()}
    return out


def blocks_to_stacked(whole, graph, block_of=None
                      ) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of ``stacked_to_blocks``: whole weights by op name ->
    the JAX package's pipelined layout."""
    names = _block_names(graph, block_of)
    in_block = {op for blk in names for op in blk}
    out = {op: dict(ws) for op, ws in whole.items() if op not in in_block}
    for i, op0 in enumerate(names[0]):
        if op0 in whole:
            out[op0] = {w: np.stack([np.asarray(whole[blk[i]][w])
                                     for blk in names])
                        for w in whole[op0]}
    return out


def state_from_numpy(state, device="cpu") -> Dict[str, torch.Tensor]:
    return {k: tensor_from_numpy(v, device) for k, v in state.items()}
