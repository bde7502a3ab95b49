"""Staged hierarchical gradient collectives — the execution half of the
reduction PLAN (search/reduction_plan.py); the port of
flexflow_tpu/comm/hierarchical.py.

The staged shape: reduce-scatter within each host (or slice), a small
cross-level all-reduce of the surviving 1/f shard at the plan's wire
precision, all-gather within each host.  Only the shard crosses the
slow links.

* The within-level stages are exact fp32 reduce-scatters and
  all-gathers through the transport seam (comm/compat.py), so
  quantization touches a value only at the cross stage.
* The cross stage is ``quantized_allreduce`` at the plan's precision
  (the fp32 sum for an all-fp32 plan).
* ``plan_axis_groups`` groups a weight's summed axes by link level with
  the aligned-span rule of ``MachineSpec.topology_levels()`` and the
  cost model's ``_axis_level`` (an axis of stride s and size f lives in
  aligned blocks of span s * f), so the executed nesting is the priced
  one.

Where the port departs from the reference: its all-fp32 plans are
value-identity anchors (GSPMD's own backward psum reduced the
gradient), while the port's ranks hold gradient shares, so every plan
runs its stages for real; an all-fp32 plan sums in the staged order.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from flexflow_tpu_torch.comm import compat
from flexflow_tpu_torch.comm.quantized import DEFAULT_CHUNK, quantized_allreduce
from flexflow_tpu_torch.parallel.mesh import all_gather


def mesh_axis_spans(mesh) -> dict:
    """Aligned span (stride * size) of every mesh axis: axis i's stride
    is the product of the later axes' sizes (rank r sits at the
    row-major coordinates of r, ``parallel.mesh.Mesh``)."""
    spans = {}
    stride = 1
    for name, size in reversed(list(mesh.axes)):
        spans[name] = stride * size
        stride *= size
    return spans


def plan_axis_groups(rep_axes: Tuple[str, ...], mesh, machine,
                     cross_level: int
                     ) -> Tuple[List[Tuple[str, ...]], List[int]]:
    """Group a weight's summed axes by link level, finest first:
    ``axes[i]`` for i < cross_level are the level-i reduce-scatter /
    all-gather axes, ``axes[-1]`` the cross all-reduce's (every axis at
    or beyond the plan's cross level); ``sizes[i]`` each group's extent
    (1 for an empty level)."""
    levels = machine.topology_levels()
    spans = mesh_axis_spans(mesh)

    def axis_level(span: int) -> int:
        for i, lvl in enumerate(levels):
            if span <= lvl.span and lvl.span % span == 0:
                return i
        return len(levels) - 1

    groups: List[List[str]] = [[] for _ in range(cross_level + 1)]
    for a in rep_axes:
        groups[min(axis_level(spans[a]), cross_level)].append(a)
    sizes = [mesh.size(g) for g in groups]
    return [tuple(g) for g in groups], sizes


def staged_allreduce(x: torch.Tensor, stage_axes: List[Tuple[str, ...]],
                     stage_sizes: List[int], cross_precision: str, mesh,
                     chunk: int = DEFAULT_CHUNK,
                     mean: bool = False) -> torch.Tensor:
    """Hierarchical sum of ``x`` over every axis of ``stage_axes``
    (``plan_axis_groups``): exact fp32 reduce-scatters peel the
    within-level axes finest first, ``quantized_allreduce`` at
    ``cross_precision`` sums the surviving shard across the top level,
    and the mirrored all-gathers rebuild it.  The sum over all the axes
    up to the cross stage's quantization (exact for fp32)."""
    shape, size, dtype = x.shape, x.numel(), x.dtype
    flat = x.reshape(-1).to(torch.float32)
    inner = 1
    for n in stage_sizes[:-1]:
        inner *= n
    pad = (-flat.numel()) % max(1, inner)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = flat
    applied: List[Tuple[str, ...]] = []
    for axes in stage_axes[:-1]:
        if not axes:
            continue
        shard = compat.reduce_scatter(shard, axes, mesh)
        applied.append(axes)
    cross = stage_axes[-1]
    if cross:
        shard = quantized_allreduce(shard, cross, mesh,
                                    precision=cross_precision, chunk=chunk)
    for axes in reversed(applied):
        shard = all_gather(shard, 0, axes, mesh)
    out = shard[:size].reshape(shape)
    if mean:
        total = 1
        for n in stage_sizes:
            total *= n
        out = out / total
    return out.to(dtype)


def plan_cross_precision(plan) -> Optional[str]:
    """The compressed wire precision of a plan's cross-level all-reduce,
    or None when every stage is fp32 (the reference's rule; the port
    still runs such a plan's stages, in fp32)."""
    if plan is None:
        return None
    for s in plan.stages:
        if s.kind == "allreduce" and s.precision != "fp32":
            return s.precision
    return None
