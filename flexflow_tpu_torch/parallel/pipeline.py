"""Pipeline parallelism over a ``pp`` axis of ranks — the port of
flexflow_tpu/parallel/pipeline.py (``PipelineConfig``,
``split_microbatches``, ``merge_microbatches``, and the schedule).

The schedule's form.  The reference runs a collective pipeline: one
``lax.scan`` of ``M + S - 1`` ticks in which every pp rank runs its
stage at every tick (``jnp.where`` masks the fill bubble) and hands
the activation to its neighbour by ``lax.ppermute``; the last stage's
outputs are then streamed down the chain to every stage, and
``jax.grad`` of the scan is the backward.  The port runs GPipe with
point-to-point sends instead (``pipeline_gpipe``): stage s computes
only its own M microbatches, receiving each from stage s - 1 and
sending it on to stage s + 1, and the backward runs the microbatches
in reverse, receiving each cotangent from s + 1 and sending the input's
cotangent to s - 1.  It computes the same function (the tests hold
the forward and the gradients to ``pipeline_spmd``'s) without the
masked bubble work: a rank launches its stage's kernels M times per
step, not M + S - 1.  One process per rank cannot run a masked tick
for free, which is why the port does not copy the scan.

Both directions are one ``torch.autograd.Function``, so the order of
every rank's sends and receives is fixed by the code, not by
autograd's scheduling: forward, for m = 0..M-1 receive, compute, send;
backward, for m = M-1..0 receive, differentiate, send.  Sends are
posted without waiting (``parallel.mesh.Sends``), receives block, and
data only ever flows one way along the chain in each direction, so no
rank can wait on a rank that waits on it.  Each microbatch's autograd
graph is kept from the forward to the backward (GPipe's stored
activations; the reference's scan saves the same residuals).

The output is the last stage's, broadcast over the pp group, as the
reference's chain broadcast leaves it on every stage.  Every pp rank
must then use it the same way (the lowering runs the epilogue and the
loss on every pp rank alike): the backward takes the cotangent from
the last stage and ignores the others', and it returns stage 0's input
cotangent on every pp rank (broadcast), so a prologue that every pp
rank ran gets the same gradient everywhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch

from flexflow_tpu_torch.parallel.mesh import Sends, broadcast, recv


@dataclass(frozen=True)
class PipelineConfig:
    """User-facing pipeline request (``FFModel.compile(pipeline=...)``).

    ``num_stages`` ranks along the ``pp`` axis each own
    ``layers / num_stages`` of the repeated block stack;
    ``num_microbatches`` should be >= num_stages to keep the bubble
    small (bubble fraction = (S-1)/(M+S-1))."""

    num_stages: int
    num_microbatches: int
    axis_name: str = "pp"


def split_microbatches(x: torch.Tensor, num_microbatches: int
                       ) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...] (batch must divide evenly)."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by {num_microbatches} "
                         f"microbatches")
    return x.reshape((num_microbatches, b // num_microbatches)
                     + tuple(x.shape[1:]))


def merge_microbatches(y: torch.Tensor) -> torch.Tensor:
    """[M, B/M, ...] -> [B, ...]."""
    return y.reshape((y.shape[0] * y.shape[1],) + tuple(y.shape[2:]))


class _Schedule:
    """What one call of ``pipeline_gpipe`` needs besides its tensors."""

    def __init__(self, stage_fn, mesh, axis_name):
        self.stage_fn = stage_fn
        self.mesh = mesh
        self.axis = axis_name
        self.s = mesh.coord(axis_name)
        self.S = mesh.shape[axis_name]
        # global ranks of this rank's pp column, by stage
        self.ranks = (mesh.members((axis_name,)) if self.S > 1
                      else [mesh.rank])
        self.group = mesh.group((axis_name,)) if self.S > 1 else None

    def run_stage(self, leaves, x, m):
        y = self.stage_fn(leaves, x, m)
        if y.shape != x.shape or y.dtype != x.dtype:
            raise ValueError(
                f"a pipeline stage must keep its input's shape and dtype "
                f"(homogeneous stages): {tuple(x.shape)} {x.dtype} -> "
                f"{tuple(y.shape)} {y.dtype}")
        return y

    def forward(self, xm, leaves, train):
        """Stage s's forward over the M microbatches: (each
        microbatch's (input, output), the outputs on every pp rank)."""
        s, S, M = self.s, self.S, xm.shape[0]
        sends = Sends()
        records, outs = [], []
        for m in range(M):
            x = xm[m] if s == 0 else recv(xm[m], self.ranks[s - 1], m)
            x = x.detach().requires_grad_(train and (s > 0
                                                     or xm.requires_grad))
            with torch.set_grad_enabled(train):
                y = self.run_stage(leaves, x, m)
            if s < S - 1:
                sends.send(y, self.ranks[s + 1], m)
            else:
                outs.append(y.detach())
            records.append((x, y))
        sends.wait()
        out = torch.stack(outs) if s == S - 1 else torch.empty_like(xm)
        if S > 1:
            out = broadcast(out, self.ranks[S - 1], self.group)
        return records, out


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, xm, *params):
        leaves = [p.detach().requires_grad_(p.requires_grad)
                  for p in params]
        records, out = sched.forward(xm, leaves, train=True)
        ctx.sched, ctx.records, ctx.leaves = sched, records, leaves
        ctx.x_like = torch.empty_like(xm)
        return out

    @staticmethod
    def backward(ctx, g_out):
        sched, records, leaves = ctx.sched, ctx.records, ctx.leaves
        s, S = sched.s, sched.S
        M = len(records)
        want = [p for p in leaves if p.requires_grad]
        g_params: List[Optional[torch.Tensor]] = [None] * len(want)
        g_x = torch.zeros_like(ctx.x_like)
        sends = Sends()
        for m in reversed(range(M)):
            x, y = records[m]
            gy = (g_out[m] if s == S - 1
                  else recv(y, sched.ranks[s + 1], m))
            inputs = ([x] if x.requires_grad else []) + want
            got = torch.autograd.grad(y, inputs, gy, allow_unused=True)
            if x.requires_grad:
                gx, got = got[0], got[1:]
                if gx is None:
                    gx = torch.zeros_like(x)
                if s > 0:
                    sends.send(gx, sched.ranks[s - 1], m)
                else:
                    g_x[m] = gx
            for i, g in enumerate(got):
                if g is not None:
                    g_params[i] = g if g_params[i] is None else g_params[i] + g
            records[m] = None  # free the microbatch's graph
        sends.wait()
        if S > 1:
            g_x = broadcast(g_x, sched.ranks[0], sched.group)
        it = iter(g_params)
        out = [next(it) if p.requires_grad else None for p in leaves]
        out = [torch.zeros_like(p) if (p.requires_grad and g is None) else g
               for p, g in zip(leaves, out)]
        return (None, g_x, *out)


def pipeline_gpipe(stage_fn: Callable, stage_params: Sequence[torch.Tensor],
                   x_microbatches: torch.Tensor, mesh,
                   axis_name: str = "pp") -> torch.Tensor:
    """Run ``stage_fn`` as an S-stage GPipe pipeline over the ``axis_name``
    axis of ``mesh`` (module docstring).

    ``stage_fn(params, x, mb_index) -> y``: this rank's stage on one
    microbatch, ``params`` the tensors of ``stage_params`` (this stage's
    weights, e.g. its L/S blocks), ``y`` of ``x``'s shape and dtype.
    ``x_microbatches`` [M, ...]: the input, the same on every pp rank
    (read on stage 0).  Returns the [M, ...] outputs on every pp rank.
    Differentiable in ``x_microbatches`` and ``stage_params`` when
    autograd is on; with it off (evaluation) it runs the forward
    alone."""
    sched = _Schedule(stage_fn, mesh, axis_name)
    params = list(stage_params)
    if torch.is_grad_enabled() and (
            x_microbatches.requires_grad
            or any(p.requires_grad for p in params)):
        return _GPipe.apply(sched, x_microbatches, *params)
    with torch.no_grad():
        return sched.forward(x_microbatches, params, train=False)[1]
