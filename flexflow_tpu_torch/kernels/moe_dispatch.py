"""Sort-based MoE token dispatch — the port of
flexflow_tpu/kernels/moe_dispatch.py, which is ``jnp`` (no Pallas), so
it ports as torch ops, on the card and on the CPU alike:

1. a stable sort of the token -> expert assignments
   (``torch.argsort(stable=True)``),
2. each token's rank within its expert (its capacity slot): its place in
   the sorted order less its expert's first place
   (``torch.searchsorted``, left, as ``jnp.searchsorted``),
3. a narrow int32 scatter of the token ids into the ``[E * cap + 1]``
   slot table, the trash slot last,
4. one wide row gather of the [T, D] rows through the slot table.

Positions are arrival order (the i-th token routed to expert e gets slot
i) and a token with an expert id outside [0, E) is dropped, as in the
reference (moe_dispatch.py:40-55).  The gradient of the gather is
autograd's scatter-add (atomics on the card): each slot takes one token
and every empty slot reads the zero row past the tokens, whose gradient
is dropped, so every token row's gradient is one addend and exact.
"""

from __future__ import annotations

from typing import Tuple

import torch


def dispatch_indices(flat_e: torch.Tensor, n_experts: int, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-token capacity positions, validity and the slot -> token
    table.

    flat_e: [T] int32 expert ids in token order.
    Returns (pos [T] int32, valid [T] bool, token_for_slot [E * cap]
    int32, where T marks an empty slot)."""
    t = flat_e.shape[0]
    dev = flat_e.device
    flat_e = flat_e.to(torch.int32)
    in_range = (flat_e >= 0) & (flat_e < n_experts)
    order = torch.argsort(flat_e, stable=True)  # token ids grouped by expert
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(n_experts, dtype=torch.int32, device=dev))
    safe_e = sorted_e.clamp(0, n_experts - 1).long()
    ranks = (torch.arange(t, dtype=torch.int32, device=dev)
             - starts[safe_e].to(torch.int32))
    pos = torch.empty(t, dtype=torch.int32, device=dev)
    pos[order] = ranks  # narrow scatter (order is a permutation)
    valid = (pos < capacity) & (pos >= 0) & in_range
    slot = (flat_e.clamp(0, n_experts - 1) * capacity
            + pos.clamp(0, capacity - 1))
    # invalid tokens write to a trash slot past the table
    slot = torch.where(valid, slot, n_experts * capacity)
    token_for_slot = torch.full((n_experts * capacity + 1,), t,
                                dtype=torch.int32, device=dev)
    token_for_slot[slot.long()] = torch.arange(t, dtype=torch.int32,
                                               device=dev)
    return pos, valid, token_for_slot[: n_experts * capacity]


def moe_dispatch(src: torch.Tensor, flat_e: torch.Tensor, n_experts: int,
                 capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(src [T, D], expert ids [T]) -> (grouped [E, cap, D], pos [T],
    valid [T]).  Empty slots are zero rows; differentiable."""
    t, d = src.shape
    pos, valid, token_for_slot = dispatch_indices(flat_e, n_experts,
                                                  capacity)
    padded = torch.cat([src, src.new_zeros((1, d))], dim=0)
    grouped = padded[token_for_slot.long()].reshape(n_experts, capacity, d)
    return grouped, pos, valid
