"""The port's one transport seam — the counterpart of
flexflow_tpu/comm/compat.py.

The reference's file absorbs JAX's ``shard_map`` API drift.  This one
absorbs what the ``torch.distributed`` backends lack or do differently,
so the compressed and staged collectives (comm/quantized.py,
comm/hierarchical.py) read the same on NCCL and on gloo:

* ``reduce_scatter`` — NCCL's own reduce-scatter
  (``parallel.mesh.reduce_scatter_sum``); on gloo an ``all_to_all`` of
  the blocks followed by a local fp32 sum in rank order, as the
  quantized collective's reduce phase does.  The emulation moves the
  same (n - 1) / n of the payload a reduce-scatter does, and its sum is
  the same on every backend.
* ``all_to_all_bytes`` / ``all_gather_bytes`` — compressed payloads
  (int8 codes with their fp32 scales, bf16) cross as raw bytes
  (``.view(torch.uint8)``), so what a backend supports for int8 and
  bf16 does not matter, and a block of codes and its scales travel in
  one message.

Every call goes through ``parallel/mesh.py``, so ``comm_counts()`` and
its host-hop accounting see it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from flexflow_tpu_torch.parallel import mesh as _mesh


def to_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a flat uint8 view of its storage (contiguous first)."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def from_bytes(b: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """The inverse of ``to_bytes``: ``b`` read as ``dtype`` of
    ``shape``."""
    return b.contiguous().view(dtype).reshape(shape)


def reduce_scatter(x: torch.Tensor, axes: Sequence[str], mesh
                   ) -> torch.Tensor:
    """Sum of the flat ``x`` over this rank's slice along ``axes``, of
    which this rank keeps its block (``x.numel()`` must divide by the
    slice's size): fp32 in, fp32 out."""
    n = mesh.size(axes)
    flat = x.reshape(-1)
    if flat.numel() % n:
        raise ValueError(f"{flat.numel()} elements do not split {n} ways")
    if n == 1:
        return flat.clone()
    if dist.get_backend(mesh.group(axes)) == "nccl":
        return _mesh.reduce_scatter_sum(flat, axes, mesh)
    recv = _mesh.all_to_all(flat.reshape(n, -1), axes, mesh)
    out = recv[0].clone()
    for j in range(1, n):
        out.add_(recv[j])
    return out


def all_to_all_bytes(blocks: Sequence[torch.Tensor], axes: Sequence[str],
                     mesh) -> List[List[torch.Tensor]]:
    """Send ``blocks[k]`` ([n, ...] each, any dtype) so that row j of
    every block goes to the slice's rank j, all of them in one byte
    message per destination; returns, per block, the n rows received
    (row j from rank j), each shaped and typed as the block's rows."""
    n = mesh.size(axes)
    rows = [b.reshape(n, -1) for b in blocks]
    raw = [to_bytes(r).reshape(n, -1) for r in rows]
    widths = [r.shape[1] for r in raw]
    recv = _mesh.all_to_all(torch.cat(raw, dim=1), axes, mesh)
    out, off = [], 0
    for b, w in zip(blocks, widths):
        part = recv[:, off:off + w]
        out.append([from_bytes(part[j], b.dtype, b.shape[1:])
                    for j in range(n)])
        off += w
    return out


def all_gather_bytes(parts: Sequence[torch.Tensor], axes: Sequence[str],
                     mesh) -> List[torch.Tensor]:
    """Gather each of ``parts`` (any dtype) over the slice in one byte
    message; returns, per part, the slice's blocks concatenated along
    dim 0 in rank order."""
    n = mesh.size(axes)
    raw = [to_bytes(p) for p in parts]
    widths = [r.numel() for r in raw]
    got = _mesh.all_gather(torch.cat(raw), 0, axes, mesh).reshape(n, -1)
    out, off = [], 0
    for p, w in zip(parts, widths):
        blocks = [from_bytes(got[j, off:off + w], p.dtype, p.shape)
                  for j in range(n)]
        out.append(torch.cat(blocks, dim=0))
        off += w
    return out
