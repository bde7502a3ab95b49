"""Ulysses all-to-all sequence parallelism — the port of
flexflow_tpu/parallel/ulysses.py (ulysses.py:56-111).

The second sequence-parallel scheme beside the ring
(``parallel/ring_attention.py``).  q/k/v arrive split on the sequence
over a set of mesh axes; one all-to-all over that set's process group
gives every rank the whole sequence for ``H / n`` of its heads,
attention runs there on the full sequence (the flash kernels on the
card, their plain versions for CPU tensors: ``flash_attention`` picks
by device), and the inverse all-to-all restores the sequence split on
the output.  Both exchanges are one autograd Function each, whose
backward is the other exchange.  The reference's fallback from its
flash kernel to the XLA path on an error (``_full_attention``,
ulysses.py:50-54) is not copied: the route is the op's, decided from
its global shapes (``flash`` below), and a failure raises.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from flexflow_tpu_torch.kernels.flash_attention import (
    attn_core,
    flash_attention,
)
from flexflow_tpu_torch.parallel.mesh import Mesh, all_to_all


def _seq_to_head(x, axes, mesh):
    """[B, S/n, H, D] -> [B, S, H/n, D]: send head group j to rank j,
    stack the sequence blocks received in rank order."""
    n = mesh.size(axes)
    b, s, h, d = x.shape
    blocks = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
    got = all_to_all(blocks, axes, mesh)  # [n, B, S/n, H/n, D]
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _head_to_seq(x, axes, mesh):
    """[B, S, H/n, D] -> [B, S/n, H, D]: the inverse exchange."""
    n = mesh.size(axes)
    b, s, h, d = x.shape
    blocks = x.reshape(b, n, s // n, h, d).permute(1, 0, 2, 3, 4)
    got = all_to_all(blocks, axes, mesh)  # [n, B, S/n, H/n, D]
    return got.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h, d)


class _SeqToHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return _seq_to_head(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return _head_to_seq(g, ctx.axes, ctx.mesh), None, None


class _HeadToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return _head_to_seq(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_head(g, ctx.axes, ctx.mesh), None, None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      seq_axes: Sequence[str], mesh: Mesh,
                      causal: bool = False, scale: Optional[float] = None,
                      flash: bool = True) -> torch.Tensor:
    """Self-attention over a sequence split in equal contiguous blocks
    over ``seq_axes`` of ``mesh`` (rank i of the axes' group holding
    block i): q, k, v are this rank's [B, S/n, H, D], H divisible by n;
    returns its [B, S/n, H, D] of the output.  ``flash`` takes the flash
    kernels for the full-sequence attention, else ``attn_core``.
    Differentiable in q, k and v; every rank of the group calls it with
    the same shapes."""
    axes = tuple(seq_axes)
    n = mesh.size(axes)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"ulysses attention needs Sk == Sq, got "
                         f"{q.shape[1]} and {k.shape[1]}")
    if q.shape[2] % n:
        raise ValueError(f"ulysses head exchange needs the {q.shape[2]} "
                         f"local heads divisible by the seq degree {n}")
    attend = flash_attention if flash else attn_core
    qh, kh, vh = (_SeqToHead.apply(t.contiguous(), axes, mesh)
                  for t in (q, k, v))
    out = attend(qh, kh, vh, causal, scale)
    return _HeadToSeq.apply(out.contiguous(), axes, mesh)
