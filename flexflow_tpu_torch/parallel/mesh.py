"""The mesh of ranks, layouts, resharding and the ranks' collectives —
the port's counterpart of flexflow_tpu/parallel/mesh.py.

Axes.  The reference builds one ``jax.sharding.Mesh`` whose axes are
the prime factors of the device count and maps every op's view onto
axis names with one deterministic rule.  ``prime_factors``,
``mesh_axis_sizes``, ``assign_slot_axes`` and ``view_slot_axes`` are
copied from it verbatim, so the same strategy lands on the same axes
in both packages.  ``Mesh`` is the torch side: rank r sits at the
row-major coordinates of r over the axes (``np.array(devices)
.reshape(shape)``'s order), and every non-empty set of axes of size > 1
has one process group per slice of the ranks along it (the whole set:
the default group), created on every rank in one deterministic order
when the job starts (``runtime.distributed.initialize``).  A group's
ranks are sorted, so a member's group rank is its coordinate index
along the set's axes, outermost first.

Layouts.  ``placement(annot, slot_axes)`` is ``annot_partition_spec``'s
counterpart: a ``Placement`` names the mesh axes each tensor dim is
split over and the axes over which the tensor is a partial sum.  A rank
holds the block of the global tensor its coordinates select, or, where
the tensor is partial, an addend of it.

Resharding.  ``reshard(x, src, dst, mesh)`` is the port's stand-in for
what GSPMD inserts where the reference's lowering constrains an edge
(``_constrain``, compiler/lowering.py:163-168): a sum over the axes
where ``src`` is partial and ``dst`` is not, then an all-gather along
each dim whose axes ``dst`` drops, then a local slice along each dim
whose axes ``dst`` adds.  Each step is an autograd Function whose
backward is its transpose on gradients that are themselves laid out as
the value is (the sum's backward is the identity, the gather's a
slice, the slice's a gather).  ``grad_all_reduce`` is the identity
whose backward sums over axes (Megatron's f operator): the lowering
puts it on an input that is replicated over axes along which the op's
work differs, whose gradient is then a partial sum.

Collectives.  ``all_reduce_sum`` (or ``all_reduce_sum_async``, which
returns a ``Pending``), ``all_gather``, ``all_to_all`` and
``reduce_scatter_sum`` (over a set of axes; the last through the
transport's own, NCCL's: comm/compat.py emulates it on gloo),
``ppermute`` (a permutation of a group's ranks,
the ring's) and ``all_reduce_mean_`` (in place, through one flat
buffer).  ``ppermute`` is differentiable: the backward sends the
cotangents along the inverse permutation.  A pair (r, r) is a local
copy: torch.distributed has no send to oneself.  Every exchange of one
call threads an order token through the next (``order``), and ``tie``
joins the last token to the call's result, so autograd runs the
backward exchanges on every rank in the reverse of the forward order,
whatever each rank computed in between, and runs all of them on every
rank.  The tensors of one exchange are posted in order with fixed tags.

The halo exchange (a conv's or pool's split H or W, ops/conv.py):
``halo_exchange(x, dim, axes, mesh, windows)`` hands each rank the
window of rows its output block reads, each row from the rank that
owns it, all of one exchange's sends and receives posted together;
its backward returns the rows' gradients to their owners.

Point to point (the pipelined, placed and staged lowerings):
``Sends`` posts sends without waiting and waits for them together,
``recv`` receives one tensor by tag, and ``broadcast`` hands one rank's
tensor to a group.  Sub-meshes: a ``Mesh`` may cover a block of the
job's ranks ``[start, start + width)`` and take other axes (the
pipelined lowering's leading ``pp``); every rank builds every mesh of
the job, member or not, so that each ``dist.new_group`` is called by
every rank in one order (``runtime.distributed.mesh_over``).

Transport (``initialize`` chose it): NCCL or gloo on the tensors'
device, except for CUDA tensors on gloo (ranks sharing a card), which
copy each block to the host and back.  Every collective counts its
``calls`` and the ``bytes`` it hands the transport; the host copies
are counted in ``host_hops`` (tensors) and ``host_bytes`` (bytes each
way).  ``comm_counts`` reads them all, ``reset_comm_counts`` zeroes
them.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.ops.base import REPLICA_SLOT, ShardAnnot


# ---- the reference's axis rule (parallel/mesh.py:27-131), verbatim -------
def prime_factors(n: int) -> List[int]:
    out: List[int] = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def mesh_axis_sizes(num_devices: int) -> List[Tuple[str, int]]:
    factors = prime_factors(num_devices) or [1]
    return [(f"x{i}", f) for i, f in enumerate(factors)]


def assign_slot_axes(
    slot_degrees: Sequence[int], pool_sizes: Sequence[int]
) -> List[Tuple[int, ...]]:
    """THE canonical slot→axis assignment rule: slots are visited in
    order; each slot of degree d consumes, for every prime factor of d,
    the first unused pool axis of that size.  Returns per-slot tuples of
    pool-axis INDICES; raises ValueError if a degree does not factor
    into the remaining pool."""
    used = [False] * len(pool_sizes)
    out: List[Tuple[int, ...]] = []
    for d in slot_degrees:
        taken: List[int] = []
        for p in prime_factors(d):
            for i, size in enumerate(pool_sizes):
                if not used[i] and size == p:
                    used[i] = True
                    taken.append(i)
                    break
            else:
                raise ValueError(
                    f"degree {d} does not factor into mesh axes {list(pool_sizes)}"
                )
        out.append(tuple(taken))
    return out


def place_zero_factors(
    extents: Sequence[int], factor_sizes: Sequence[int]
) -> List[Tuple[int, int]]:
    """THE greedy placement rule for ZeRO-1 optimizer-state sharding,
    which the search's memory model (search/machine_model.py
    op_memory) prices: weight dims are visited largest-remaining-extent
    first, replication factors in pool order, and a factor lands on the
    first visited dim it divides evenly.  Returns (dim, factor_index)
    placements; factors that fit nowhere are not placed."""
    remaining = list(range(len(factor_sizes)))
    ext = list(extents)
    out: List[Tuple[int, int]] = []
    for d in sorted(range(len(ext)), key=lambda i: -ext[i]):
        for fi in list(remaining):
            if ext[d] > 1 and ext[d] % factor_sizes[fi] == 0:
                out.append((d, fi))
                ext[d] //= factor_sizes[fi]
                remaining.remove(fi)
    return out


def view_slot_axes(
    mv: MachineView, axis_pool: Sequence[Tuple[str, int]]
) -> Dict[int, Tuple[str, ...]]:
    """Assign mesh axes to the view's slots (output dims + replica slot).

    Deterministic (assign_slot_axes): slots are visited in order
    (0..ndim-1 then REPLICA_SLOT).  Raises if the view does not factor
    into the pool.
    """
    degrees = list(mv.dim_degrees) + [mv.replica_degree]
    idx = assign_slot_axes(degrees, [s for _, s in axis_pool])
    slots: Dict[int, Tuple[str, ...]] = {
        i: tuple(axis_pool[j][0] for j in idx[i])
        for i in range(len(mv.dim_degrees))
    }
    slots[REPLICA_SLOT] = tuple(axis_pool[j][0] for j in idx[-1])
    return slots


# ---- layouts -------------------------------------------------------------
@dataclass(frozen=True)
class Placement:
    """How a tensor lies over the mesh: ``dims[i]`` the axes dim i is
    split over (outermost first), ``partial`` the axes over which the
    ranks hold addends of it.  Every other axis replicates it."""

    dims: Tuple[Tuple[str, ...], ...]
    partial: Tuple[str, ...] = ()

    @staticmethod
    def replicated(ndim: int) -> "Placement":
        return Placement(((),) * ndim)

    def without_partial(self) -> "Placement":
        return replace(self, partial=())

    def split_axes(self) -> Tuple[str, ...]:
        return tuple(a for axes in self.dims for a in axes)

    def local_sizes(self, sizes: Sequence[int], mesh: "Mesh"
                    ) -> Tuple[int, ...]:
        return tuple(s // mesh.size(axes) for s, axes in zip(sizes, self.dims))

    def local_slices(self, sizes: Sequence[int], mesh: "Mesh",
                     at: Optional[int] = None) -> Tuple[slice, ...]:
        """This rank's block of a tensor of global ``sizes`` (or the
        block of the mesh's rank ``at``, counted from its start)."""
        out = []
        for s, axes in zip(sizes, self.dims):
            n = mesh.size(axes)
            if s % n:
                raise ValueError(f"dim of {s} does not split {n} ways over "
                                 f"{axes}")
            i, per = mesh.index(axes, at), s // n
            out.append(slice(i * per, (i + 1) * per))
        return tuple(out)


def placement(annot: ShardAnnot, slot_axes: Dict[int, Tuple[str, ...]]
              ) -> Placement:
    """``annot`` under the view slots' axes (the reference's
    ``annot_partition_spec``, plus the partial-sum axes: the replica
    slot's, where the annotation is partial)."""
    dims = []
    for deg, slot in zip(annot.degrees, annot.parallel_idx()):
        dims.append(() if deg <= 1 or slot == -1
                    else tuple(slot_axes.get(slot, ())))
    partial = tuple(slot_axes.get(REPLICA_SLOT, ())) if annot.partial else ()
    return Placement(tuple(dims), partial)


def build_mesh(devices=None) -> "Mesh":
    """The job's mesh over ``devices`` (reference parallel/mesh.py:45-57,
    which builds a ``jax.sharding.Mesh``): None for every rank of the
    job, else a count or a sequence of consecutive global ranks, whose
    block gets its own prime-factor axes.  Outside a job, a one-rank
    mesh.  Every rank of the job calls it alike: a new block creates
    process groups on every rank (``runtime.distributed.mesh_over``)."""
    from flexflow_tpu_torch.runtime import distributed

    if devices is None:
        return distributed.mesh_over()
    ranks = (list(range(devices)) if isinstance(devices, int)
             else [int(r) for r in devices])
    if not ranks or ranks != list(range(ranks[0], ranks[0] + len(ranks))):
        raise ValueError(f"devices {devices!r} are not a block of "
                         f"consecutive ranks")
    return distributed.mesh_over(start=ranks[0], width=len(ranks))


class Mesh:
    """The ranks ``[start, start + width)`` of a job of ``world`` ranks
    over named axes: by default the prime-factor axes of ``width``
    (``mesh_axis_sizes``), else ``axes`` (the pipelined lowering's
    leading ``pp`` axis).  Every rank of the job builds every mesh its
    job uses, member or not, because ``dist.new_group`` must be called
    by every rank in one order; a rank outside the block keeps no
    group and has coordinates 0."""

    def __init__(self, world: int, rank: int, make_groups: bool = True,
                 axes: Optional[Sequence[Tuple[str, int]]] = None,
                 start: int = 0, width: Optional[int] = None):
        width = world if width is None else width
        if start < 0 or start + width > world:
            raise ValueError(f"ranks [{start}, {start + width}) are not "
                             f"in a job of {world}")
        self.axes = ([(n, s) for n, s in axes] if axes is not None
                     else mesh_axis_sizes(width))
        if math.prod(s for _, s in self.axes) != width:
            raise ValueError(f"axes {self.axes} do not cover {width} ranks")
        self.shape = dict(self.axes)
        self.names = tuple(n for n, _ in self.axes)
        self.world, self.rank = width, rank
        self.job_world, self.start = world, start
        dims = tuple(s for _, s in self.axes)
        here = rank - start if start <= rank < start + width else 0
        self._coords = dict(zip(self.names, np.unravel_index(here, dims)))
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._members: Dict[Tuple[str, ...], List[int]] = {}
        real = [n for n in self.names if self.shape[n] > 1]
        # every rank visits the same sets in the same order and creates
        # every group of each set, its own or not
        for k in range(1, len(real) + 1):
            for axes_ in itertools.combinations(real, k):
                self._make_groups(axes_, make_groups)

    def _make_groups(self, axes, make_groups):
        others = [n for n in self.names if n not in axes]
        ranks = self.start + np.arange(self.world).reshape(
            tuple(self.shape[n] for n in self.names))
        # move the set's axes last: each row is one group, in coordinate
        # order along the set's axes
        order = [self.names.index(n) for n in others + list(axes)]
        rows = ranks.transpose(order).reshape(-1, self.size(axes))
        for row in rows:
            members = [int(r) for r in row]
            if members != sorted(members):
                raise AssertionError(f"group {members} is not in rank order")
            if self.rank in members:
                self._members[axes] = members
            if not make_groups:
                continue
            if len(members) == self.job_world:
                group = dist.group.WORLD
            else:
                group = dist.new_group(ranks=members)
            if self.rank in members:
                self._groups[axes] = group

    def coord(self, axis: str) -> int:
        return int(self._coords[axis])

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes: Sequence[str], at: Optional[int] = None) -> int:
        """This rank's (or the mesh's rank ``at``'s) row-major coordinate
        index along ``axes``."""
        coords = self._coords if at is None else dict(zip(
            self.names, np.unravel_index(at, tuple(self.shape[n]
                                                   for n in self.names))))
        i = 0
        for a in axes:
            i = i * self.shape[a] + int(coords[a])
        return i

    def _key(self, axes: Sequence[str]) -> Tuple[str, ...]:
        return tuple(n for n in self.names if n in axes
                     and self.shape[n] > 1)

    def group(self, axes: Sequence[str]):
        """The process group of this rank's slice along ``axes``."""
        return self._groups[self._key(axes)]

    def members(self, axes: Sequence[str]) -> List[int]:
        """The global ranks of this rank's slice along ``axes``, in
        coordinate order."""
        return list(self._members[self._key(axes)])

    def __repr__(self) -> str:
        return f"Mesh({self.axes}, rank {self.rank} at {self._coords})"


# ---- collectives over a set of axes --------------------------------------
def _host_hop(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _count(fn, *tensors: torch.Tensor, hop: bool) -> None:
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    fn.calls += 1
    fn.bytes += nbytes
    if hop:
        fn.host_hops += len(tensors)
        fn.host_bytes += nbytes


def all_reduce_sum(x: torch.Tensor, axes: Sequence[str], mesh: Mesh
                   ) -> torch.Tensor:
    """The sum of ``x`` over this rank's slice along ``axes`` (a new
    tensor; ``x`` is left as it was)."""
    group = mesh.group(axes)
    hop = _host_hop(x, group)
    buf = x.detach().cpu() if hop else x.detach().clone(
        memory_format=torch.contiguous_format)
    _count(all_reduce_sum, buf, hop=hop)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.device) if hop else buf


def all_gather(x: torch.Tensor, dim: int, axes: Sequence[str], mesh: Mesh
               ) -> torch.Tensor:
    """The blocks of this rank's slice along ``axes`` concatenated along
    ``dim`` in coordinate order (the group's rank order)."""
    group = mesh.group(axes)
    hop = _host_hop(x, group)
    send = x.detach().contiguous()
    if hop:
        send = send.cpu()
    _count(all_gather, send, hop=hop)
    parts = [torch.empty_like(send) for _ in range(mesh.size(axes))]
    dist.all_gather(parts, send, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if hop else out


def all_to_all(x: torch.Tensor, axes: Sequence[str], mesh: Mesh
               ) -> torch.Tensor:
    """``x`` [n, ...]: block j goes to the slice's rank j, and block j of
    the result came from rank j (``all_to_all_single``)."""
    group = mesh.group(axes)
    hop = _host_hop(x, group)
    send = x.detach().contiguous()
    if hop:
        send = send.cpu()
    _count(all_to_all, send, hop=hop)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.to(x.device) if hop else recv


def reduce_scatter_sum(x: torch.Tensor, axes: Sequence[str], mesh: Mesh
                       ) -> torch.Tensor:
    """``x`` [n * k, ...] summed over this rank's slice along ``axes``,
    of which this rank keeps block j (its coordinate index), through the
    transport's own reduce-scatter.  Gloo's is not used:
    ``comm.compat.reduce_scatter`` emulates it there."""
    group = mesh.group(axes)
    n = mesh.size(axes)
    send = x.detach().contiguous()
    _count(reduce_scatter_sum, send, hop=False)
    out = torch.empty((send.shape[0] // n,) + tuple(send.shape[1:]),
                      dtype=send.dtype, device=send.device)
    dist.reduce_scatter_tensor(out, send, op=dist.ReduceOp.SUM, group=group)
    return out


class Pending:
    """An all-reduce in flight (``all_reduce_sum_async``): ``wait()``
    returns the sum on the tensor's device."""

    def __init__(self, work, buf: torch.Tensor, device: torch.device):
        self._work, self._buf, self._device = work, buf, device

    def wait(self) -> torch.Tensor:
        self._work.wait()
        return self._buf.to(self._device)


def all_reduce_sum_async(x: torch.Tensor, axes: Sequence[str], mesh: Mesh
                         ) -> Pending:
    """``all_reduce_sum`` issued without waiting (``async_op``): the
    transport runs it while the caller goes on (the backward of the
    bucketed gradient sync, comm/bucketed.py)."""
    group = mesh.group(axes)
    hop = _host_hop(x, group)
    buf = x.detach().cpu() if hop else x.detach().clone(
        memory_format=torch.contiguous_format)
    _count(all_reduce_sum, buf, hop=hop)
    work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group,
                           async_op=True)
    return Pending(work, buf, x.device)


for _fn in (all_reduce_sum, all_gather, all_to_all, reduce_scatter_sum):
    _fn.calls = _fn.bytes = _fn.host_hops = _fn.host_bytes = 0


class _AllReduce(torch.autograd.Function):
    """Sum of partial addends; the backward hands the (replicated)
    gradient to every addend."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        return all_reduce_sum(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    """Gather along ``dim``; the backward keeps this rank's block of the
    (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, dim, axes, mesh):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        return all_gather(x, dim, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.axes, ctx.mesh), None, None, None


class _AllGatherSummed(torch.autograd.Function):
    """Gather along ``dim`` for a computation each rank does on part of
    the whole (its query rows over gathered K/V); the backward sums the
    ranks' partial gradients of the whole and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, dim, axes, mesh):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        return all_gather(x, dim, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum(g.contiguous(), ctx.axes, ctx.mesh)
        return _block(g, ctx.dim, ctx.axes, ctx.mesh), None, None, None


def all_gather_summed(x: torch.Tensor, dim: int, axes: Sequence[str],
                      mesh: Mesh) -> torch.Tensor:
    """``all_gather`` whose gradient is the sum over ``axes`` of the
    whole's gradients, cut to this rank's block (the K/V that a split
    sequence's attention gathers, reference ops/attention.py:205-228)."""
    return _AllGatherSummed.apply(x, dim, tuple(axes), mesh)


class _Slice(torch.autograd.Function):
    """This rank's block along ``dim``; the backward gathers the blocks'
    gradients into the (replicated) gradient of the whole."""

    @staticmethod
    def forward(ctx, x, dim, axes, mesh):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        return _block(x, dim, axes, mesh).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.axes, ctx.mesh), None, None, None


class _GradAllReduce(torch.autograd.Function):
    """The identity; the backward sums the gradient over ``axes``."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.axes, ctx.mesh), None, None


def _block(x, dim, axes, mesh):
    n = mesh.size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} "
                         f"ways over {tuple(axes)}")
    per = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axes) * per, per)


def reshard(x: torch.Tensor, src: Placement, dst: Placement, mesh: Mesh
            ) -> torch.Tensor:
    """``x``, laid out as ``src``, laid out as ``dst`` (module
    docstring): sums, then gathers, then slices."""
    if src == dst:
        return x
    if set(dst.partial) - set(src.partial):
        raise ValueError(f"cannot reshard {src} to the partial {dst}")
    summed = tuple(a for a in src.partial if a not in dst.partial)
    if summed:
        x = _AllReduce.apply(x, summed, mesh)
    for d, (s, t) in enumerate(zip(src.dims, dst.dims)):
        if s != t and s and t[:len(s)] != s:
            x = _AllGather.apply(x, d, s, mesh)
    for d, (s, t) in enumerate(zip(src.dims, dst.dims)):
        if s == t:
            continue
        extra = t[len(s):] if t[:len(s)] == s else t
        if extra:
            x = _Slice.apply(x, d, extra, mesh)
    return x


def grad_all_reduce(x: torch.Tensor, axes: Sequence[str], mesh: Mesh
                    ) -> torch.Tensor:
    """``x``, whose gradient is summed over ``axes`` in the backward."""
    return _GradAllReduce.apply(x, tuple(axes), mesh) if axes else x


# ---- the ring's exchange -------------------------------------------------
def _peers(perm: Sequence[Tuple[int, int]], me: int, n: int):
    """(destination, source) of rank ``me`` under a bijection ``perm``
    of the group's ranks."""
    dst = dict(perm)
    src = {d: s for s, d in perm}
    if sorted(dst) != list(range(n)) or sorted(src) != list(range(n)):
        raise ValueError(f"perm {list(perm)} is not a bijection of "
                         f"{n} ranks")
    return dst[me], src[me]


def _post(fn, sends, recvs, like: torch.Tensor, group) -> List[torch.Tensor]:
    """Post every send and receive of one exchange at once and wait for
    them all, so no order of posts across ranks can deadlock: ``sends``
    is [(global rank, tag, tensor)], ``recvs`` [(global rank, tag,
    shape, dtype)].  Counted as ``fn``'s; returns the received tensors
    on ``like``'s device (through host memory where the group is gloo
    and ``like`` is on the card)."""
    hop = _host_hop(like, group)
    bufs = [x.contiguous() for *_, x in sends]
    if hop:
        bufs = [b.cpu() for b in bufs]
    out = [torch.empty(shape, dtype=dtype,
                       device="cpu" if hop else like.device)
           for *_, shape, dtype in recvs]
    ops = ([dist.P2POp(dist.isend, b, peer, group, tag)
            for (peer, tag, _), b in zip(sends, bufs)]
           + [dist.P2POp(dist.irecv, b, peer, group, tag)
              for (peer, tag, *_), b in zip(recvs, out)])
    if ops:
        _count(fn, *bufs, hop=hop)
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(like.device) for b in out] if hop else out


def _exchange(xs: Sequence[torch.Tensor], perm, group) -> List[torch.Tensor]:
    me, n = dist.get_rank(group), dist.get_world_size(group)
    dst, src = _peers(perm, me, n)
    if dst == me:  # then src == me too: a local copy
        return [x.clone(memory_format=torch.contiguous_format) for x in xs]
    g_dst = dist.get_global_rank(group, dst)
    g_src = dist.get_global_rank(group, src)
    return _post(ppermute, [(g_dst, tag, x) for tag, x in enumerate(xs)],
                 [(g_src, tag, x.shape, x.dtype) for tag, x in enumerate(xs)],
                 xs[0], group)


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
        _count(all_reduce_mean_, flat, hop=hop)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat.div_(n).to(ts[0].device)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def _transport_of(x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend() == "gloo"


class Sends:
    """Point-to-point sends between ranks (the pipelined, placed and
    staged lowerings' activation and cotangent hops), posted without
    waiting and waited for together: a rank never blocks on a send, so
    no order of sends and receives between stages can deadlock.  Each
    message is a tensor with an integer tag, which the receiver names
    in ``recv``."""

    def __init__(self):
        self._pending: List[Tuple[object, torch.Tensor]] = []

    def send(self, x: torch.Tensor, dst: int, tag: int) -> None:
        """Post ``x`` to global rank ``dst``."""
        hop = _transport_of(x)
        buf = x.detach().contiguous()
        if hop:
            buf = buf.cpu()
        _count(send_recv, buf, hop=hop)
        self._pending.append((dist.isend(buf, dst, tag=tag), buf))

    def wait(self) -> None:
        for work, _ in self._pending:
            work.wait()
        self._pending.clear()


def recv(like: torch.Tensor, src: int, tag: int) -> torch.Tensor:
    """The tensor global rank ``src`` sent with ``tag``, shaped and
    typed as ``like``, on ``like``'s device."""
    hop = _transport_of(like)
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if hop else like.device)
    dist.recv(buf, src, tag=tag)
    return buf.to(like.device) if hop else buf


def send_recv():
    """Not called: it carries ``Sends.send``'s counters, as each
    collective function carries its own (``comm_counts()
    ["send_recv"]``)."""


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of ``group`` (default:
    the job); ``x`` gives the shape and dtype elsewhere (a new
    tensor)."""
    group = group or dist.group.WORLD
    hop = _host_hop(x, group)
    buf = x.detach().cpu() if hop else x.detach().clone(
        memory_format=torch.contiguous_format)
    _count(broadcast, buf, hop=hop)
    dist.broadcast(buf, src, group=group)
    return buf.to(x.device) if hop else buf


# ---- the halo exchange (attribute parallelism) ---------------------------
def _halo_spans(windows: Sequence[Tuple[int, int]], block: int, me: int):
    """For each rank j of the slice: the rows of this rank's block that
    j's window takes, as [a0, a1) in this block, and the rows of j's
    block that this rank's window takes, as [w0, w1) in this window
    (empty spans have a1 <= a0 or w1 <= w0)."""
    lo, hi = windows[me]
    spans = []
    for j, (jlo, jhi) in enumerate(windows):
        a0, a1 = max(jlo, me * block), min(jhi, (me + 1) * block)
        r0, r1 = max(lo, j * block), min(hi, (j + 1) * block)
        spans.append((a0 - me * block, a1 - me * block, r0 - lo, r1 - lo))
    return spans


def _sized(x: torch.Tensor, dim: int, n: int) -> Tuple[int, ...]:
    shape = list(x.shape)
    shape[dim] = n
    return tuple(shape)


class _HaloWindow(torch.autograd.Function):
    """Rows ``windows[me]`` of a tensor split in blocks along ``dim``,
    received from their owners; the backward sends each received row's
    gradient back to its owner, which adds it to its block's."""

    @staticmethod
    def forward(ctx, x, dim, axes, mesh, windows):
        me, block = mesh.index(axes), x.shape[dim]
        members, group = mesh.members(axes), mesh.group(axes)
        spans = _halo_spans(windows, block, me)
        ctx.dim, ctx.block, ctx.spans = dim, block, spans
        ctx.members, ctx.group, ctx.me = members, group, me
        sends, wanted = [], []  # one message each way per peer: tag 0
        for j, (a0, a1, w0, w1) in enumerate(spans):
            if j == me:
                continue
            if a1 > a0:
                sends.append((members[j], 0, x.narrow(dim, a0, a1 - a0)))
            if w1 > w0:
                wanted.append((members[j], 0, _sized(x, dim, w1 - w0),
                               x.dtype))
        got = iter(_post(halo_exchange, sends, wanted, x, group))
        pieces = []
        for j, (a0, a1, w0, w1) in enumerate(spans):
            if w1 <= w0:
                continue
            pieces.append(x.narrow(dim, a0, a1 - a0) if j == me
                          else next(got))
        if not pieces:
            return x.narrow(dim, 0, 0).clone()
        return torch.cat(pieces, dim=dim)

    @staticmethod
    def backward(ctx, g):
        dim, spans, me = ctx.dim, ctx.spans, ctx.me
        grad = torch.zeros(_sized(g, dim, ctx.block), dtype=g.dtype,
                           device=g.device)
        sends, wanted, into = [], [], []
        for j, (a0, a1, w0, w1) in enumerate(spans):
            if j == me:
                if a1 > a0:
                    grad.narrow(dim, a0, a1 - a0).add_(
                        g.narrow(dim, w0, w1 - w0))
                continue
            if w1 > w0:
                sends.append((ctx.members[j], 0, g.narrow(dim, w0, w1 - w0)))
            if a1 > a0:
                wanted.append((ctx.members[j], 0, _sized(g, dim, a1 - a0),
                               g.dtype))
                into.append(a0)
        for a0, part in zip(into, _post(halo_exchange, sends, wanted, g,
                                         ctx.group)):
            grad.narrow(dim, a0, part.shape[dim]).add_(part)
        return grad, None, None, None, None


def halo_exchange(x: torch.Tensor, dim: int, axes: Sequence[str],
                  mesh: Mesh, windows: Sequence[Tuple[int, int]]
                  ) -> torch.Tensor:
    """``x``, this rank's block of a tensor split evenly along ``dim``
    over ``axes``, replaced by the rows ``windows[me]`` = [lo, hi) of
    the whole (``me``: this rank's coordinate index along ``axes``;
    ``windows`` holds every rank's, clipped to the tensor): the rows it
    holds are kept, the others are received from the ranks that own
    them, however many blocks away, and rows it holds outside its
    window are dropped.  Each rank sends each peer only the rows of
    its block in the peer's window, in one message, all messages of the
    exchange posted together.  Differentiable: the backward sends each
    window row's gradient to its owner, which sums it into its block's
    gradient.  Counted as ``comm_counts()["halo_exchange"]`` (bytes
    sent, forward and backward)."""
    return _HaloWindow.apply(x, dim, tuple(axes), mesh,
                             tuple((int(a), int(b)) for a, b in windows))


for _fn in (ppermute, all_reduce_mean_, send_recv, broadcast,
            halo_exchange):
    _fn.calls = _fn.bytes = _fn.host_hops = _fn.host_bytes = 0

COLLECTIVES = (all_reduce_sum, all_gather, all_to_all, reduce_scatter_sum,
               ppermute, all_reduce_mean_, send_recv, broadcast,
               halo_exchange)


def comm_counts() -> Dict[str, Dict[str, int]]:
    """Every collective's counters: calls, bytes, host hops (tensors)
    and host bytes."""
    return {fn.__name__: {"calls": fn.calls, "bytes": fn.bytes,
                          "host_hops": fn.host_hops,
                          "host_bytes": fn.host_bytes}
            for fn in COLLECTIVES}


def reset_comm_counts() -> None:
    for fn in COLLECTIVES:
        fn.calls = fn.bytes = fn.host_hops = fn.host_bytes = 0
