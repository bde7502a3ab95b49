"""Candidate MachineView enumeration per operator — a copy of
flexflow_tpu/search/views.py.

Role of register_all_machine_views + get_valid_machine_views
(reference: src/runtime/graph.cc:1778-1810, :493-578): the reference
registers 1-D strided views for every divisor of the GPU count and asks
each op which are valid.  Here a view is a degree vector over the op's
output dims (+ a contraction/replica degree), and validity =
divisibility of the dim + membership in the op's splittable set; the
total parts must divide the mesh size so the degrees factor onto axes.
"""

from __future__ import annotations

from typing import List

from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.ops.base import Operator


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def boundary_views(
    op: Operator, num_devices: int, max_views: int = 4
) -> List[MachineView]:
    """Small, *diverse* view set for split-boundary enumeration.

    Sequence splits multiply DP states by the boundary node's view
    count, so boundary enumeration must stay near the reference's
    handful of 1-D divisor views (reference: graph.cc:1778-1810
    register_all_machine_views) while covering the strategy families
    that matter: pure batch (DP), the biggest non-batch 1-D split (TP),
    a balanced batch x non-batch hybrid, a contraction split, and the
    trivial view.  Interior nodes still brute-force the rich
    ``candidate_views`` set at DP leaves."""
    fixed = op.fixed_machine_view()
    if fixed is not None:
        return [fixed]
    out_shape = op.output_shapes[0]
    nd = out_shape.ndim
    if nd == 0:
        return [MachineView.trivial(0)]
    splittable = set(op.splittable_output_dims())
    divisors = _divisors(num_devices)
    max_r = op.max_replica_degree()
    picks: List[MachineView] = []
    seen = set()

    def add(degs, r=1):
        mv = MachineView(dim_degrees=tuple(degs), replica_degree=r)
        if (
            mv.num_parts <= num_devices
            and num_devices % mv.num_parts == 0
            and mv not in seen
        ):
            seen.add(mv)
            picks.append(mv)

    # max batch split (pure DP)
    if 0 in splittable:
        for d in reversed(divisors):
            if d > 1 and out_shape.sizes[0] % d == 0:
                degs = [1] * nd
                degs[0] = d
                add(degs)
                break
    # max non-batch 1-D split (pure TP): the dim admitting the LARGEST
    # split wins (first such dim on ties)
    best_dim, best_d = None, 1
    for dim in sorted(splittable - {0}):
        for d in reversed(divisors):
            if d > best_d and out_shape.sizes[dim] % d == 0:
                best_dim, best_d = dim, d
                break
    if best_dim is not None:
        degs = [1] * nd
        degs[best_dim] = best_d
        add(degs)
    # balanced hybrid: batch x (non-batch | contraction)
    if 0 in splittable and num_devices >= 4:
        b = 1
        for d in divisors:
            if 1 < d * d <= num_devices and out_shape.sizes[0] % d == 0:
                b = d
        other = num_devices // b if b > 1 else 0
        if b > 1 and other > 1:
            done = False
            for dim in sorted(splittable - {0}):
                if out_shape.sizes[dim] % other == 0:
                    degs = [1] * nd
                    degs[0] = b
                    degs[dim] = other
                    add(degs)
                    done = True
                    break
            if not done and other <= max_r and max_r % other == 0:
                degs = [1] * nd
                degs[0] = b
                add(degs, other)
    # max contraction split
    for r in reversed(divisors):
        if 1 < r <= max_r and max_r % r == 0:
            add([1] * nd, r)
            break
    add([1] * nd)  # trivial
    return picks[:max_views]


def candidate_views(
    op: Operator,
    num_devices: int,
    max_views: int = 48,
    allow_partial: bool = True,
) -> List[MachineView]:
    fixed = op.fixed_machine_view()
    if fixed is not None:
        return [fixed]
    out_shape = op.output_shapes[0]
    nd = out_shape.ndim
    if nd == 0:
        return [MachineView.trivial(0)]
    splittable = set(op.splittable_output_dims())
    divisors = _divisors(num_devices)
    max_r = op.max_replica_degree() if allow_partial else 1

    views = [MachineView.trivial(nd)]
    seen = {views[0]}

    def add(degs, r):
        mv = MachineView(dim_degrees=tuple(degs), replica_degree=r)
        if mv.num_parts <= num_devices and num_devices % mv.num_parts == 0:
            if mv not in seen:
                seen.add(mv)
                views.append(mv)

    # 1-D views: one split dim (like the reference's 1-D boxes)
    for dim in sorted(splittable):
        for d in divisors[1:]:
            if out_shape.sizes[dim] % d == 0:
                degs = [1] * nd
                degs[dim] = d
                add(degs, 1)
    # pure contraction splits
    for r in divisors[1:]:
        if r <= max_r and max_r % r == 0:
            add([1] * nd, r)
    # 2-D combos: batch (dim 0) x one other split or contraction
    if 0 in splittable:
        for b in divisors[1:]:
            if out_shape.sizes[0] % b != 0:
                continue
            for dim in sorted(splittable - {0}):
                for d in divisors[1:]:
                    if b * d <= num_devices and out_shape.sizes[dim] % d == 0:
                        degs = [1] * nd
                        degs[0] = b
                        degs[dim] = d
                        add(degs, 1)
            for r in divisors[1:]:
                if b * r <= num_devices and r <= max_r and max_r % r == 0:
                    degs = [1] * nd
                    degs[0] = b
                    add(degs, r)
    return views[:max_views]
