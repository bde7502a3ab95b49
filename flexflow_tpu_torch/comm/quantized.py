"""EQuARX-style quantized allreduce (arXiv:2506.17615) — the port of
flexflow_tpu/comm/quantized.py in torch ops over the ranks' process
groups.

Shape of the collective (both compressed precisions), as the
reference's:

    quantize(local) -> all_to_all of the COMPRESSED payload
    -> dequantize + fp32 sum of the owned shard -> requantize
    -> all_gather of the COMPRESSED reduced shards -> dequantize

The int8 codes of a shard and their per-chunk fp32 scales cross in one
byte message (comm/compat.py), so each phase moves about
``1 + 4 / chunk`` bytes per element (bf16: 2) where the fp32 sum moves
4.  The owner adds the n dequantized shards in rank order.  fp32 is the
plain ``parallel.mesh.all_reduce_sum``.

Where the port departs from the reference: the reference's gradients
arrive already summed by GSPMD's backward psum, so its
``quantized_grad_sync`` routes the SUMMED gradient through the round
trip with ``mean=True`` (its module docstring's honesty note).  The
port's ranks hold their own shares of the gradient, so the compressed
collective IS the gradient sum here (``mean=False``): it replaces the
fp32 all-reduce instead of following it, and the error feedback of
``quantized_allreduce_ef`` carries each rank's own entry error.  The
collective itself, on the same per-rank inputs, computes what the
reference's does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.comm import compat
from flexflow_tpu_torch.parallel.mesh import all_reduce_sum

SYNC_PRECISIONS = ("fp32", "bf16", "int8")

# elements per int8 scale block: the scales cost 4/256 = 1.6% of the
# payload and an outlier spoils only its own chunk (EQuARX block scaling)
DEFAULT_CHUNK = 256

# weight groups below this many elements never compress (their sync is
# latency-bound and bias/scale vectors are exactly these): the floor
# the search's safety heuristic, the cost model and the execution share
MIN_COMPRESS_ELEMS = 1 << 16


def quantize_chunked(x: torch.Tensor, chunk: int = DEFAULT_CHUNK):
    """Flatten ``x`` and quantize per chunk to symmetric int8: returns
    ``(q [nchunks, chunk] int8, scale [nchunks, 1] fp32)``.  The tail is
    zero-padded to a whole chunk; an all-zero chunk gets scale 1, so it
    round-trips exactly; |q| <= 127."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % chunk
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, chunk)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(blocks / scale).to(torch.int8)
    return q, scale


def dequantize_chunked(q: torch.Tensor, scale: torch.Tensor, size: int,
                       shape) -> torch.Tensor:
    """Inverse of ``quantize_chunked``: drop the padding, restore
    ``shape`` (``size`` real elements)."""
    blocks = q.to(torch.float32) * scale
    return blocks.reshape(-1)[:size].reshape(shape)


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def quantized_allreduce(x: torch.Tensor, axes, mesh,
                        precision: str = "fp32",
                        chunk: int = DEFAULT_CHUNK,
                        mean: bool = False) -> torch.Tensor:
    """The sum (or, with ``mean``, the mean) of ``x`` over this rank's
    slice along ``axes``; bf16 and int8 compress both phases (module
    docstring) and hold ``allreduce_error_bound``.  Every rank of the
    slice returns the same tensor."""
    if precision not in SYNC_PRECISIONS:
        raise ValueError(
            f"precision must be one of {SYNC_PRECISIONS}, got {precision!r}")
    axes = _axes(axes)
    n = mesh.size(axes)
    if precision == "fp32":
        y = all_reduce_sum(x, axes, mesh)
        return y / n if mean else y
    shape, size, dtype = x.shape, x.numel(), x.dtype
    flat = x.reshape(-1).to(torch.float32)
    # every rank's owned share is a whole number of chunks
    pad = (-flat.numel()) % (n * chunk)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    if precision == "int8":
        q, s = quantize_chunked(flat, chunk)            # [C, chunk], [C, 1]
        qr, sr = compat.all_to_all_bytes(
            [q.reshape(n, -1, chunk), s.reshape(n, -1, 1)], axes, mesh)
        part = qr[0].to(torch.float32) * sr[0]
        for j in range(1, n):
            part = part + qr[j].to(torch.float32) * sr[j]
        q2, s2 = quantize_chunked(part, chunk)
        full_q, full_s = compat.all_gather_bytes([q2, s2], axes, mesh)
        full = (full_q.to(torch.float32) * full_s).reshape(-1)
    else:
        (br,) = compat.all_to_all_bytes(
            [flat.to(torch.bfloat16).reshape(n, -1)], axes, mesh)
        part = br[0].to(torch.float32)
        for j in range(1, n):
            part = part + br[j].to(torch.float32)
        (full,) = compat.all_gather_bytes([part.to(torch.bfloat16)], axes,
                                          mesh)
        full = full.to(torch.float32)
    out = full[:size].reshape(shape)
    if mean:
        out = out / n
    return out.to(dtype)


def quantized_allreduce_ef(x: torch.Tensor, residual: torch.Tensor, axes,
                           mesh, precision: str = "int8",
                           chunk: int = DEFAULT_CHUNK, mean: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback variant (EF-SGD): each rank sends
    ``quantize(x + residual)`` and keeps the entry error ``(x +
    residual) - dequantize(quantize(x + residual))`` as its next
    residual.  Returns ``(reduced, new_residual)``; fp32 is the exact
    sum with a zero residual."""
    if precision not in SYNC_PRECISIONS:
        raise ValueError(
            f"precision must be one of {SYNC_PRECISIONS}, got {precision!r}")
    if precision == "fp32":
        return (quantized_allreduce(x, axes, mesh, "fp32", chunk, mean),
                torch.zeros_like(x, dtype=torch.float32))
    carry = x.to(torch.float32) + residual.to(torch.float32)
    if precision == "int8":
        q, s = quantize_chunked(carry, chunk)
        approx = dequantize_chunked(q, s, carry.numel(), carry.shape)
    else:
        approx = carry.to(torch.bfloat16).to(torch.float32)
    new_residual = carry - approx
    out = quantized_allreduce(carry, axes, mesh, precision, chunk,
                              mean).to(x.dtype)
    return out, new_residual


def allreduce_error_bound(per_device_inputs, precision: str,
                          chunk: int = DEFAULT_CHUNK) -> float:
    """Max-abs error bound of ``quantized_allreduce`` against the exact
    fp32 sum of ``per_device_inputs`` (the n addends), as the
    reference's: two rounding stages, each at most the summed amax over
    254 (int8) or times 2^-8 (bf16), with 5% headroom for the fp32
    accumulation."""
    if precision not in SYNC_PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "fp32":
        return 0.0
    total = float(sum(np.max(np.abs(np.asarray(x)))
                      for x in per_device_inputs))
    per_stage = total / 254.0 if precision == "int8" else total * 2.0 ** -8
    return 1.05 * 2.0 * per_stage + 1e-12


def replication_axes(placement, mesh) -> Tuple[Tuple[str, ...], int]:
    """The mesh axes (of size > 1, ``pp`` aside) a weight's placement
    does not split, and their extent: the reference's rule over a
    ``parallel.mesh.Placement``."""
    used = set(placement.split_axes())
    rep = tuple(a for a, s in mesh.axes
                if a not in used and s > 1 and a != "pp")
    return rep, mesh.size(rep)


def quantized_grad_sync(grads: Dict[str, Dict[str, torch.Tensor]], mesh,
                        grad_axes: Dict[str, Dict[str, Tuple[str, ...]]],
                        precision_map: Dict[str, str],
                        chunk: int = DEFAULT_CHUNK,
                        residuals: Optional[Dict[str, Dict[str, torch.Tensor]]]
                        = None):
    """Sum the weight groups ``precision_map`` names (op name ->
    bf16/int8/int8_ef) through the compressed collective over each
    weight's ``grad_axes``, one collective per weight.  fp32 groups,
    weights summed over no axis and weights below
    ``MIN_COMPRESS_ELEMS`` are left to the caller's fp32 sum.  An
    ``int8_ef`` weight with a residual in ``residuals`` takes
    ``quantized_allreduce_ef``; without one, the plain int8 wire.

    Returns ``(merged, new_residuals, synced)``: the gradients with the
    compressed ones summed, the new residuals by op and weight, and the
    (op, weight) pairs this call summed."""
    merged = {op: dict(ws) for op, ws in grads.items()}
    new_res: Dict[str, Dict[str, torch.Tensor]] = {}
    synced = set()
    for op, prec in precision_map.items():
        if prec == "fp32":
            continue
        for w, g in grads.get(op, {}).items():
            axes = grad_axes.get(op, {}).get(w, ())
            if not axes or g.numel() < MIN_COMPRESS_ELEMS:
                continue
            r = (residuals or {}).get(op, {}).get(w)
            if prec == "int8_ef" and r is not None:
                y, nr = quantized_allreduce_ef(g, r, axes, mesh, "int8",
                                               chunk)
                new_res.setdefault(op, {})[w] = nr
            else:
                y = quantized_allreduce(
                    g, axes, mesh, "int8" if prec == "int8_ef" else prec,
                    chunk)
            merged[op][w] = y
            synced.add((op, w))
    return merged, new_res, synced

