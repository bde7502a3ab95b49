"""The ranks' collectives — the port's counterpart of
flexflow_tpu/parallel/mesh.py.

The reference builds one ``jax.sharding.Mesh`` whose axes are the prime
factors of the device count, and its collectives (``lax.ppermute``,
``psum``) run inside ``shard_map`` over named axes.  The port's mesh is
one process group over the ranks (``torch.distributed``'s default group,
joined by ``runtime.distributed.initialize``), and its collectives are:

* ``ppermute(xs, perm)`` — each rank sends its tensors to the rank the
  permutation maps it to and receives from the rank mapped to it, as
  ``lax.ppermute`` does.  It is differentiable: the backward sends the
  cotangents along the inverse permutation (the transpose JAX takes of
  ``lax.ppermute``).  A pair (r, r) is a local copy: torch.distributed
  has no send to oneself.  Every exchange of one call threads an order
  token through the next (``order``), and ``tie`` joins the last token
  to the call's result, so autograd runs the backward exchanges on
  every rank in the reverse of the forward order, whatever each rank
  computed in between (a rank that skips a block of the causal ring
  builds a different graph from its neighbour's), and runs all of them
  on every rank (an exchange whose results one rank never reads is
  still reached through the tokens).  The tensors of one exchange are
  posted in order with fixed tags.
* ``all_reduce_mean_(tensors)`` — the mean over the ranks, in place,
  through one flat buffer: for the gradients (each rank's are those of
  its shard's mean loss) and the loss and metrics.

Transport (``initialize`` chose it): NCCL or gloo on the tensors'
device, except for CUDA tensors on gloo (ranks sharing a card), which
copy each block to the host and back.  Those copies are counted in
``ppermute.host_hops`` / ``all_reduce_mean_.host_hops`` (tensors) and
``.host_bytes`` (bytes each way).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _host_hop(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _peers(perm: Sequence[Tuple[int, int]], me: int, n: int):
    """(destination, source) of rank ``me`` under a bijection ``perm``
    of the group's ranks."""
    dst = dict(perm)
    src = {d: s for s, d in perm}
    if sorted(dst) != list(range(n)) or sorted(src) != list(range(n)):
        raise ValueError(f"perm {list(perm)} is not a bijection of "
                         f"{n} ranks")
    return dst[me], src[me]


def _exchange(xs: Sequence[torch.Tensor], perm, group) -> List[torch.Tensor]:
    me, n = dist.get_rank(group), dist.get_world_size(group)
    dst, src = _peers(perm, me, n)
    if dst == me:  # then src == me too: a local copy
        return [x.clone(memory_format=torch.contiguous_format) for x in xs]
    hop = _host_hop(xs[0], group)
    send = [x.contiguous() for x in xs]
    if hop:
        send = [x.cpu() for x in send]
        ppermute.host_hops += len(send)
        ppermute.host_bytes += sum(x.numel() * x.element_size()
                                   for x in send)
    recv = [torch.empty_like(x) for x in send]
    g_dst = dist.get_global_rank(group, dst)
    g_src = dist.get_global_rank(group, src)
    ops = ([dist.P2POp(dist.isend, x, g_dst, group, tag)
            for tag, x in enumerate(send)]
           + [dist.P2POp(dist.irecv, x, g_src, group, tag)
              for tag, x in enumerate(recv)])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if hop:
        recv = [x.to(xs[0].device) for x in recv]
    return recv


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, perm, group, order, *xs):
        ctx.perm, ctx.group = perm, group
        return (order.clone(), *_exchange(xs, perm, group))

    @staticmethod
    def backward(ctx, g_order, *gys):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return (None, None, g_order, *_exchange(gys, inverse, ctx.group))


def ppermute(xs: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]],
             group=None, order: Optional[torch.Tensor] = None):
    """Send ``xs`` from every rank s to rank d for each (s, d) in
    ``perm`` (a bijection of the group's ranks); returns (the tensors
    received, the order token).  Pass the token to the next exchange of
    the same call as ``order``, and the last one to ``tie``."""
    group = group or dist.group.WORLD
    if order is None:
        order = torch.zeros((), device=xs[0].device,
                            requires_grad=torch.is_grad_enabled())
    out = _PPermute.apply(tuple(perm), group, order, *xs)
    return list(out[1:]), out[0]


ppermute.host_hops = 0
ppermute.host_bytes = 0


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, order):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros((), dtype=torch.float32, device=g.device)


def tie(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``x`` itself, with the exchanges that made ``order`` behind it in
    the autograd graph."""
    return _Tie.apply(x, order)


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the group's ranks, through
    one flat buffer per dtype (the sum, then a division by the group's
    size)."""
    group = group or dist.group.WORLD
    n = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        hop = _host_hop(flat, group)
        if hop:
            flat = flat.cpu()
            all_reduce_mean_.host_hops += 1
            all_reduce_mean_.host_bytes += flat.numel() * flat.element_size()
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat.div_(n).to(ts[0].device)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


all_reduce_mean_.host_hops = 0
all_reduce_mean_.host_bytes = 0
