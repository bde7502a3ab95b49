"""Ring attention — the port of flexflow_tpu/parallel/ring_attention.py.

Sequence parallelism for MHA: each rank holds a shard of the sequence;
its queries stay put while K/V shards rotate around the ring of ranks
(``ppermute``), and the online-softmax partials of every step merge in
fp32, so attention memory per rank stays O(S/n).  The reference runs
this inside ``shard_map`` on its global view; the port runs it on the
rank's local shards, one process per rank, with the same schedules:

* contiguous: rank i holds chunk i of n; under a causal mask a block
  from a later rank is skipped, one from an earlier rank is full and
  the resident block is the diagonal;
* zigzag (the reference's default for causal rings): the sequence is
  viewed as 2n chunks and rank i attends with chunks i and 2n-1-i, so
  every rank computes two half-chunk blocks per ring step.  The
  exchange to that layout and back is two half-chunk ``ppermute``s
  each way (the reference's ``_zigzag_ring``, :203-232 and :291-297);
  the rotation sits outside the per-rank choice of blocks, as there.

Each block step is ``_block_attn``: the partial-output flash kernel
(``flash_attention_partial``) when ``_pick_block`` tiles both lengths at
the reference's blocks and the head dim is one the kernel takes, else
the plain partial (the reference's XLA fallback).  Blocks are merged
with ``_merge``, differentiated through (m included); the l floor of
1e-30 is applied once, at the end.

The ring is a process group whose rank order is the shards' order.
Under a view that splits the batch as well as the sequence (dp_s x sp)
it is the group of the sequence's mesh axes through this rank
(``parallel.mesh.Mesh.group``), whose ranks are sorted, so that a
member's group rank is its coordinate index along those axes: at sp 4
on 8 ranks the product ring of two size-2 axes
(__graft_entry__.py:152-155).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from flexflow_tpu_torch.kernels.flash_attention import (
    HEAD_DIMS,
    _pick_block,
    attention_partial_at,
    flash_attention,
    flash_attention_partial,
)
from flexflow_tpu_torch.parallel.mesh import ppermute, tie

# the reference's partial-forward blocks (flash_attention_partial's
# defaults), which decide the shape rule
BLOCK_Q = 512
BLOCK_K = 1024


def _block_attn(q, k, v, scale, causal):
    """One block step: (acc [B, H, Sq, D], m, l [B, H, Sq, 1]) fp32."""
    if (_pick_block(q.shape[1], BLOCK_Q) is not None
            and _pick_block(k.shape[1], BLOCK_K) is not None
            and q.shape[-1] in HEAD_DIMS):
        return flash_attention_partial(q, k, v, causal, scale)
    return attention_partial_at(q, k, v, causal, scale, 0, q.shape[1])


def _merge(p1, p2):
    """Numerically stable combine of two online-softmax partials."""
    acc1, m1, l1 = p1
    acc2, m2, l2 = p2
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return acc1 * a1 + acc2 * a2, m, l1 * a1 + l2 * a2


def _finish(part, dtype):
    """acc / max(l, 1e-30) as [B, S, H, D] in ``dtype``."""
    acc, _, l = part
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(dtype)


def ring_attention(q_l: torch.Tensor, k_l: torch.Tensor, v_l: torch.Tensor,
                   group=None, causal: bool = False,
                   scale: Optional[float] = None,
                   schedule: str = "auto") -> torch.Tensor:
    """Self-attention over a sequence split in equal contiguous shards,
    group rank i holding shard i: q_l, k_l, v_l are this rank's
    [B, S/n, H, D]; returns its [B, S/n, H, D] of the output, in q's
    dtype.  Differentiable in q_l, k_l and v_l; every rank of the group
    must call it with the same shapes and arguments.

    ``schedule``: "contiguous" | "zigzag" | "auto" (zigzag for a causal
    ring of more than one rank when the length splits into 2n chunks).
    """
    group = group or dist.group.WORLD
    n = dist.get_world_size(group)
    if scale is None:
        scale = 1.0 / math.sqrt(q_l.shape[-1])
    if q_l.shape != k_l.shape or k_l.shape != v_l.shape:
        raise ValueError(f"ring attention is self-attention: q, k, v "
                         f"shards must match, got {tuple(q_l.shape)}, "
                         f"{tuple(k_l.shape)}, {tuple(v_l.shape)}")
    if n == 1:
        return flash_attention(q_l, k_l, v_l, causal=causal, scale=scale)
    q_l, k_l, v_l = (t.contiguous() for t in (q_l, k_l, v_l))
    if schedule not in ("auto", "contiguous", "zigzag"):
        raise ValueError(f"schedule must be auto, contiguous or zigzag, "
                         f"got {schedule!r}")
    if schedule == "auto":
        schedule = ("zigzag" if causal and q_l.shape[1] % 2 == 0
                    else "contiguous")
    if schedule == "zigzag":
        if not causal:
            raise ValueError("zigzag scheduling only applies to causal "
                             "attention")
        if q_l.shape[1] % 2:
            raise ValueError(f"zigzag needs an even shard, got "
                             f"{q_l.shape[1]}")
        return _zigzag_ring(q_l, k_l, v_l, group, n, scale)
    return _contiguous_ring(q_l, k_l, v_l, group, n, causal, scale)


def _contiguous_ring(q_l, k_l, v_l, group, n, causal, scale):
    idx = dist.get_rank(group)
    perm = [(i, (i + 1) % n) for i in range(n)]
    # step 0 on the resident block (the diagonal under a causal mask),
    # then n-1 rotate-and-compute steps
    acc = _block_attn(q_l, k_l, v_l, scale, causal)
    kv, order = (k_l, v_l), None
    for step in range(1, n):
        kv, order = ppermute(kv, perm, group, order)
        src = (idx - step) % n  # whose block this rank holds now
        if not causal or src < idx:
            acc = _merge(acc, _block_attn(q_l, *kv, scale, False))
        # causal and src > idx: the block lies above the diagonal
    return tie(_finish(acc, q_l.dtype), order)


def _zigzag_ring(q_l, k_l, v_l, group, n, scale):
    idx = dist.get_rank(group)
    s2 = q_l.shape[1] // 2

    def fwd_owner(c):  # zigzag owner rank of global chunk c
        return c if c < n else 2 * n - 1 - c

    # exchange A carries each rank's early contiguous half (chunk 2i), B
    # the late half (chunk 2i+1); both maps are bijections
    perm_a = [(i, fwd_owner(2 * i)) for i in range(n)]
    perm_b = [(i, fwd_owner(2 * i + 1)) for i in range(n)]
    # True where A delivers this rank's early zigzag chunk (global id
    # idx); else A carried the late one
    a_is_early = 2 * [s for s, d in perm_a if d == idx][0] == idx

    halves = [t[:, :s2] for t in (q_l, k_l, v_l)]
    ra, order = ppermute(halves, perm_a, group)
    halves = [t[:, s2:] for t in (q_l, k_l, v_l)]
    rb, order = ppermute(halves, perm_b, group, order)
    early, late = (ra, rb) if a_is_early else (rb, ra)
    q0, k0, v0 = early  # global chunk idx
    q1, k1, v1 = late   # global chunk 2n-1-idx

    # resident step: the early half attends its diagonal; the late half
    # attends the early chunk fully plus its own diagonal
    acc0 = _block_attn(q0, k0, v0, scale, True)
    acc1 = _merge(_block_attn(q1, k0, v0, scale, False),
                  _block_attn(q1, k1, v1, scale, True))
    perm = [(i, (i + 1) % n) for i in range(n)]
    kv = (k0, k1, v0, v1)
    for step in range(1, n):
        kv, order = ppermute(kv, perm, group, order)
        src = (idx - step) % n  # rank whose chunks this rank holds now
        k0s, k1s, v0s, v1s = kv
        if src < idx:
            # both q halves attend src's early chunk (below the diagonal)
            acc0 = _merge(acc0, _block_attn(q0, k0s, v0s, scale, False))
            acc1 = _merge(acc1, _block_attn(q1, k0s, v0s, scale, False))
        else:
            # the early half sees nothing of src; the late half (chunk
            # 2n-1-idx) attends both of src's chunks
            acc1 = _merge(acc1, _merge(_block_attn(q1, k0s, v0s, scale, False),
                                       _block_attn(q1, k1s, v1s, scale, False)))

    out0, out1 = _finish(acc0, q_l.dtype), _finish(acc1, q_l.dtype)
    # inverse exchange: each zigzag half goes back along the route it
    # came by; the receivers get their contiguous (early, late) halves
    oa, ob = (out0, out1) if a_is_early else (out1, out0)
    (e,), order = ppermute([oa], [(d, s) for s, d in perm_a], group, order)
    (lt,), order = ppermute([ob], [(d, s) for s, d in perm_b], group, order)
    return tie(torch.cat([e, lt], dim=1), order)
