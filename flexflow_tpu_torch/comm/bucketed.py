"""Bucketed, issue-ordered gradient sync — the execution half of the
sync SCHEDULE (search/sync_schedule.py); the port of
flexflow_tpu/comm/bucketed.py.

* **Fused payloads.**  A bucket's member gradients flatten into one
  buffer per set of summed axes and cross in one collective: a
  compressed bucket in one ``quantized_allreduce`` (int8 codes and
  scales, or bf16; ``quantized_allreduce_ef`` where the members carry
  error-feedback residuals, flattened into the same buffer), an fp32
  bucket in one all-reduce, a bucket with a reduction plan in one
  ``staged_allreduce`` (comm/hierarchical.py) on a machine with link
  levels.  Members below ``MIN_COMPRESS_ELEMS`` sum in fp32 even
  inside a compressed bucket, as the cost model prices them.
* **Issue order.**  The reference chains its buckets through
  ``optimization_barrier`` so XLA issues them in the schedule's order.
  Here ``BucketedSync`` is fed each weight's gradient as the backward
  produces it (the lowering's hook on each weight leaf,
  compiler/lowering.py ``loss_and_grads``) and issues bucket k + 1 only
  once bucket k has been issued and all of k + 1's members have
  arrived.  Every rank therefore issues the same collectives in the
  same order, whatever order its gradients become ready in; ranks that
  issued in readiness order could pair one rank's bucket with
  another's and hang.  fp32 buckets go out as asynchronous all-reduces
  (``parallel.mesh.all_reduce_sum_async``) that run under the rest of
  the backward; compressed and staged buckets run their phases when
  issued.  ``finish`` feeds what never arrived (weights the loss does
  not reach, or every gradient when no hook ran, as with gradient
  accumulation), issues the rest in order and waits for every bucket
  before the optimizer update.
* Synced weights no bucket names take the monolithic fp32 sum after
  the buckets, as the simulator prices an uncovered group.
* **Lane stamps** (``lane_stamps``, set by the lowering when
  ``FFConfig.device_trace_dir`` is): each bucket with members is
  stamped ``issue`` when it is issued and ``done`` once its sum is on
  this rank's device — at the end of ``_issue`` for a bucket whose
  phases ran there, after its wait in ``finish`` for an asynchronous
  one — under its stable lane id ``bucket:<name>:sync`` (the
  simulator's lane name), so a live ``device_trace`` capture records
  when each lane ran (obs/annotate.py ``lane_stamp``; matched to the
  predicted lanes by obs/trace_ingest.py).  Off, nothing is stamped.

Where the port departs from the reference: the reference's fp32
buckets carry GSPMD-reduced gradients and only anchor the order; the
port's carry the ranks' shares and sum them.  At a world of 2 the sum
of two addends does not depend on their order, so an fp32 schedule is
bit-equal to the monolithic sum; at 4 the transport's summation order
may depend on where an element sits in the payload (the tests say
what they found).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from flexflow_tpu_torch.comm.hierarchical import (
    plan_axis_groups,
    plan_cross_precision,
    staged_allreduce,
)
from flexflow_tpu_torch.comm.quantized import (
    DEFAULT_CHUNK,
    MIN_COMPRESS_ELEMS,
    quantized_allreduce,
    quantized_allreduce_ef,
)
from flexflow_tpu_torch.parallel.mesh import (
    Pending,
    all_reduce_sum,
    all_reduce_sum_async,
)

_WIRES = ("bf16", "int8", "int8_ef")


def _cat(ts: List[torch.Tensor]) -> torch.Tensor:
    if len(ts) == 1:
        return ts[0].reshape(-1).to(torch.float32)
    return torch.cat([t.reshape(-1).to(torch.float32) for t in ts])


class BucketedSync:
    """One optimizer step's execution of ``schedule`` over gradients
    summed along ``grad_axes`` (op -> weight -> axes; weights with no
    axes need no sum).  ``machine`` (a MachineSpec) arms the staged
    plans; ``residuals`` (op -> weight -> tensor) the error feedback of
    ``int8_ef`` buckets; ``lane_stamps`` the lanes' issue and done
    stamps (module docstring)."""

    def __init__(self, schedule, grad_axes, mesh, machine=None,
                 residuals=None, chunk: int = DEFAULT_CHUNK,
                 lane_stamps: bool = False):
        self.mesh, self.machine, self.chunk = mesh, machine, chunk
        self.lane_stamps = lane_stamps
        self.residuals = residuals or {}
        self.buckets = list(getattr(schedule, "buckets", schedule))
        self._axes = grad_axes
        self._bucket_of: Dict[Tuple[str, str], int] = {}
        self._members: List[List[Tuple[str, str]]] = []
        for k, b in enumerate(self.buckets):
            ms = [(op, w) for op in b.ops
                  for w, axes in grad_axes.get(op, {}).items()
                  if axes and (op, w) not in self._bucket_of]
            self._members.append(ms)
            for m in ms:
                self._bucket_of[m] = k
        self._waiting = [set(ms) for ms in self._members]
        self._got: Dict[Tuple[str, str], torch.Tensor] = {}
        self._next = 0
        # (bucket, members, sum or Pending) per fused group, in issue
        # order
        self._out: List[Tuple[int, List[Tuple[str, str]], object]] = []
        self.new_residuals: Dict[str, Dict[str, torch.Tensor]] = {}

    def members(self) -> List[Tuple[str, str]]:
        """The (op, weight) pairs some bucket sums."""
        return list(self._bucket_of)

    def arrive(self, op: str, w: str, g: torch.Tensor) -> None:
        """Weight (op, w)'s whole gradient on this rank exists: issue
        every bucket that is complete and next in order."""
        k = self._bucket_of.get((op, w))
        if k is None or (op, w) in self._got:
            return
        self._got[(op, w)] = g
        self._waiting[k].discard((op, w))
        while self._next < len(self.buckets) and not self._waiting[self._next]:
            self._issue(self._next)
            self._next += 1

    def _stamp(self, k: int, marker: str) -> None:
        if self.lane_stamps and self._members[k]:
            from flexflow_tpu_torch.obs.annotate import lane_stamp

            lane_stamp(f"bucket:{self.buckets[k].name}:sync", marker,
                       self._got[self._members[k][0]].device)

    def _issue(self, k: int) -> None:
        self._stamp(k, "issue")
        b = self.buckets[k]
        prec = getattr(b, "precision", "fp32")
        plan = getattr(b, "plan", None)
        cross = plan_cross_precision(plan)
        wire = prec in _WIRES and (plan is None or cross is not None)
        groups: Dict[tuple, List[Tuple[str, str]]] = {}
        for op, w in self._members[k]:
            g = self._got[(op, w)]
            axes = self._axes[op][w]
            if wire and g.numel() >= MIN_COMPRESS_ELEMS:
                ef = (prec == "int8_ef"
                      and self.residuals.get(op, {}).get(w) is not None)
                groups.setdefault((axes, "wire", ef), []).append((op, w))
            else:
                groups.setdefault((axes, "fp32", False), []).append((op, w))
        start = len(self._out)
        for (axes, kind, ef), ms in groups.items():
            staged = None
            if plan is not None and self.machine is not None:
                st_axes, st_sizes = plan_axis_groups(
                    axes, self.mesh, self.machine, plan.cross_level)
                if st_axes[-1]:
                    staged = (st_axes, st_sizes)
            flat = _cat([self._got[m] for m in ms])
            if staged is not None:
                # the plan stages this group (EF off: the cross stage
                # carries summed shards the residual never saw, as the
                # cost model prices it)
                p = cross if kind == "wire" else "fp32"
                red = staged_allreduce(flat, staged[0], staged[1], p,
                                       self.mesh, self.chunk)
            elif kind == "fp32":
                red = all_reduce_sum_async(flat, axes, self.mesh)
            elif ef:
                rs = _cat([self.residuals[op][w] for op, w in ms])
                red, nr = quantized_allreduce_ef(flat, rs, axes, self.mesh,
                                                 "int8", self.chunk)
                self._split_into(self.new_residuals, ms, nr)
            else:
                red = quantized_allreduce(
                    flat, axes, self.mesh,
                    "int8" if prec == "int8_ef" else prec, self.chunk)
            self._out.append((k, ms, red))
        if not any(isinstance(red, Pending)
                   for _, _, red in self._out[start:]):
            self._stamp(k, "done")

    def _split_into(self, tree, ms, flat) -> None:
        off = 0
        for op, w in ms:
            like = self._got[(op, w)]
            n = like.numel()
            tree.setdefault(op, {})[w] = flat[off:off + n].view(
                like.shape).to(like.dtype)
            off += n

    def finish(self, grads) -> Dict[str, Dict[str, torch.Tensor]]:
        """Issue what is left in order, sum the synced weights no bucket
        names (one fp32 all-reduce per set of axes), wait for every
        bucket, and return the summed gradients (a new tree; ``grads``
        is left as it was)."""
        for (op, w) in list(self._bucket_of):
            if (op, w) not in self._got:
                self.arrive(op, w, grads[op][w])
        merged = {op: dict(ws) for op, ws in grads.items()}
        waited = False
        for i, (k, ms, red) in enumerate(self._out):
            if isinstance(red, Pending):
                red, waited = red.wait(), True
            self._split_into(merged, ms, red)
            if waited and (i + 1 == len(self._out)
                           or self._out[i + 1][0] != k):
                self._stamp(k, "done")  # the bucket's last wait is over
                waited = False
        rest: Dict[Tuple[str, ...], List[Tuple[str, str]]] = {}
        for op, ws in self._axes.items():
            for w, axes in ws.items():
                if axes and (op, w) not in self._bucket_of and op in grads:
                    rest.setdefault(axes, []).append((op, w))
        for axes, ms in rest.items():
            for m in ms:
                self._got[m] = grads[m[0]][m[1]]
            self._split_into(merged, ms, all_reduce_sum(
                _cat([self._got[m] for m in ms]), axes, self.mesh))
        return merged


def bucketed_grad_sync(grads, mesh, grad_axes, schedule,
                       chunk: int = DEFAULT_CHUNK, machine=None,
                       residuals=None):
    """Run ``schedule``'s buckets in issue order over ``grads`` (every
    gradient already computed) and return ``(summed gradients, new
    error-feedback residuals)`` — ``BucketedSync`` without the
    backward's hooks."""
    sync = BucketedSync(schedule, grad_axes, mesh, machine, residuals,
                        chunk)
    return sync.finish(grads), sync.new_residuals
