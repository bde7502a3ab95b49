"""Operator base machinery — the port of flexflow_tpu/ops/base.py.

An ``Operator`` is an immutable descriptor: op type + attributes +
logical input/output shapes + weight specs.  ``infer`` runs at graph
build time; ``forward(ctx, inputs, weights)`` computes the op on
PyTorch tensors: the whole tensors on one process, this rank's shards
under a strategy (the lowering reshards every edge to the annotation
the op's ``propagate`` asks for first).  ``propagate(mv)`` is the
reference's degree propagation, copied: given the op's ``MachineView``
it derives a ``ShardAnnot`` for each input, weight and output.
``forward_sharded`` is the hook for an op whose shards need more than
its ``forward`` on them (the vocab-split embedding, a spatially split
conv or pool, the MoE dispatch under an expert split).  The cost hooks are
the reference's: ``flops`` (the forward-FLOP estimate; the training
path's MFU counts 3x its sum), ``bytes_accessed`` (the roofline's HBM
bytes), ``fixed_machine_view``/``splittable_output_dims``/
``max_replica_degree`` (the search's view space) and
``calibration_signature`` (the identity a measured record is keyed by,
``signature`` less the ``_CALIBRATION_INERT_ATTRS``).

The op RNG (``LoweringContext.op_rng``, ``dropout_mask``): a dropout
mask is a counter-based hash of three things, computed in torch int64
ops on the model's device: the step's seed (a 0-d int64 tensor the
training step takes, so a captured step draws new masks at every
replay), ``zlib.crc32`` of the op's name, and each element's index in
the WHOLE tensor of the step (the global batch, every head).  So a rank
under a batch or head split draws exactly its block of the one-process
mask, a gradient-accumulation microbatch its rows of it, remat's
recompute the mask of the first pass, and the CPU the card's mask.
The reference keys ops by Python's salted ``hash(op_name)``
(ops/base.py:145-148), which changes from one interpreter to the next;
the port does not copy that (ROADMAP, reference-side oddities).
Values stay below 2**32 in int64, so no product overflows and ``>>``
never meets a sign bit.
"""

from __future__ import annotations

from dataclasses import dataclass
import zlib
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
    Type,
    TYPE_CHECKING,
)

import torch

from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import DataType, ParallelTensorShape
from flexflow_tpu_torch.initializers import Initializer

if TYPE_CHECKING:
    from flexflow_tpu_torch.parallel.mesh import Mesh, Placement


@dataclass(frozen=True)
class WeightSpec:
    """A named weight owned by an op."""

    name: str
    shape: Tuple[int, ...]
    dtype: DataType
    initializer: Initializer


REPLICA_SLOT = -2  # parallel_idx value meaning "the view's replica slot"


@dataclass(frozen=True)
class ShardAnnot:
    """Sharding annotation of one tensor under an op's MachineView.

    ``degrees[i]`` — partition degree of tensor dim i.
    ``idx[i]``     — which view slot dim i derives from: an output-dim
                     index, ``REPLICA_SLOT`` for the view's replica slot,
                     or -1 when unsharded (identity by position when
                     empty).  It puts, e.g., a Linear weight's out dim
                     on the same mesh axes as the activation's out dim.
    ``replica``    — replication count of the tensor over the rest of
                     the view.
    ``partial``    — partial-sum state: the value still needs a sum over
                     the view's replica-slot axes."""

    degrees: Tuple[int, ...]
    replica: int = 1
    partial: bool = False
    idx: Tuple[int, ...] = ()

    def __hash__(self):
        # cached: the cost model's memo dicts hash annotations millions
        # of times per search (reference ops/base.py:80-87)
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.degrees, self.replica, self.partial, self.idx))
            object.__setattr__(self, "_hash", h)
        return h

    def parallel_idx(self) -> Tuple[int, ...]:
        if self.idx:
            return self.idx
        return tuple(i if d > 1 else -1 for i, d in enumerate(self.degrees))

    @property
    def num_parts(self) -> int:
        p = self.replica
        for d in self.degrees:
            p *= d
        return p

    @staticmethod
    def trivial(ndim: int) -> "ShardAnnot":
        return ShardAnnot((1,) * ndim)


@dataclass(frozen=True)
class OpSharding:
    """Degree propagation of one op under one MachineView.  An
    ``inputs`` entry of None is unconstrained: the producer's layout
    governs (the parallel ops, whose data movement is the change of
    layout at their own output)."""

    inputs: Tuple[Optional[ShardAnnot], ...]
    weights: Tuple[ShardAnnot, ...]
    outputs: Tuple[ShardAnnot, ...]


_M32 = 0xFFFFFFFF
_MIX = 0x45D9F3B  # < 2**27: a product with a 32-bit value fits int64


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash of int64 values in [0, 2**32),
    elementwise; returns a new tensor."""
    x = (x >> 16).bitwise_xor_(x).mul_(_MIX).bitwise_and_(_M32)
    x = (x >> 16).bitwise_xor_(x).mul_(_MIX).bitwise_and_(_M32)
    return (x >> 16).bitwise_xor_(x)


def op_key(op_name: str) -> int:
    """An op's stream key: crc32 of its name, the same in every
    process (the reference's ``hash(op_name)`` is salted per process)."""
    return zlib.crc32(op_name.encode())


def stream_key(seed: torch.Tensor, op_name: str) -> torch.Tensor:
    """The 0-d int64 key of ``op_name``'s draws at step ``seed``."""
    seed = seed.to(torch.int64)
    k = _mix32((seed & _M32) ^ _mix32(torch.full_like(seed, op_key(op_name))))
    return _mix32(k ^ ((seed >> 32) & _M32))


def draw_keep_mask(key: torch.Tensor, keep: float,
                   global_shape: Sequence[int], starts: Sequence[int],
                   local_shape: Sequence[int]) -> torch.Tensor:
    """bool [local_shape]: True where an element is kept, for the block
    of a tensor of ``global_shape`` that starts at ``starts``.  Element
    i of the whole tensor (row-major) is kept iff the hash of
    (i, ``key``) is below ``keep * 2**32``."""
    dev = key.device
    idx = torch.zeros((1,) * len(local_shape), dtype=torch.int64,
                      device=dev)
    for d, (g, s, n) in enumerate(zip(global_shape, starts, local_shape)):
        view = [1] * len(local_shape)
        view[d] = n
        ar = torch.arange(s, s + n, dtype=torch.int64,
                          device=dev).view(view)
        idx = idx * g + ar  # the last dim's add makes the full tensor
    numel = 1
    for g in global_shape:
        numel *= g
    if numel <= (1 << 32):  # every index fits 32 bits
        h = _mix32(idx.bitwise_xor_(key))
    else:
        h = _mix32(_mix32((idx & _M32) ^ key).bitwise_xor_(idx >> 32))
    return h < int(round(keep * (1 << 32)))


class LoweringContext:
    """Carried through one forward pass of the whole graph.  ``train``
    says whether the pass is a training step's; ``device`` is where the
    model's tensors live (constants are placed there).  Ops that own
    state (the decode op's KV pools) read it from ``state_in`` and
    publish what they wrote under the same keys in ``state_out``.

    In the lowering ``mesh`` is the job's mesh (``parallel.mesh.Mesh``,
    one rank for one process; None in passes outside it, such as the
    prefill lane's), and while a node runs ``slot_axes`` maps
    its view's slots to mesh axes and ``in_placements``/
    ``out_placements`` are the layouts of its local inputs and
    outputs.  An op that sums its partial output itself
    (``reduce_partial``) records that in ``out_placements``.

    ``seed`` is the training step's 0-d int64 seed tensor (zero when the
    pass has none, as the reference's ``op_rng`` falls back to key 0)
    and ``row_base`` the offset of this pass's rows within this rank's
    block of the batch: a gradient-accumulation or pipeline microbatch
    sets it, so its masks are its rows of the whole batch's.
    ``mask_source``, None outside tests, replaces the drawn masks:
    ``mask_source(ctx, op_name, local_shape, keep)`` returns the bool
    keep mask (the parity tests hand in the reference's masks).
    ``seq_length`` is ``FFConfig.iteration.seq_length`` (the reference's
    LoweringContext, ops/base.py:132): when positive, ``batch_matmul``
    masks its sequence tail."""

    mask_source: Optional[Callable] = None

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16,
                 train: bool = False,
                 state_in: Optional[Dict[str, torch.Tensor]] = None,
                 device: torch.device | str = "cpu",
                 mesh: "Optional[Mesh]" = None,
                 seed: Optional[torch.Tensor] = None, row_base: int = 0,
                 seq_length: int = -1):
        self.compute_dtype = compute_dtype
        self.seq_length = seq_length
        self.train = train
        self.state_in = state_in or {}
        self.state_out: Dict[str, torch.Tensor] = {}
        self.device = torch.device(device)
        self.mesh = mesh
        self.seed = seed
        self.row_base = row_base
        self.slot_axes: Optional[Dict[int, Tuple[str, ...]]] = None
        self.in_placements: List["Placement"] = []
        self.out_placements: List["Placement"] = []

    def op_rng(self, op_name: str) -> torch.Tensor:
        """The 0-d int64 key of ``op_name``'s draws in this pass (the
        reference's ``fold_in(rng, hash(op_name))``)."""
        seed = self.seed
        if seed is None:
            seed = torch.zeros((), dtype=torch.int64, device=self.device)
        return stream_key(seed, op_name)

    def dropout_mask(self, op_name: str, keep: float,
                     global_shape: Sequence[int], starts: Sequence[int],
                     local_shape: Sequence[int]) -> torch.Tensor:
        """The keep mask of this rank's block (``local_shape``, starting
        at ``starts`` in a tensor of ``global_shape``; dim 0 is the
        batch, offset further by ``row_base``)."""
        if LoweringContext.mask_source is not None:
            return LoweringContext.mask_source(self, op_name,
                                               tuple(local_shape), keep)
        starts = (starts[0] + self.row_base,) + tuple(starts[1:])
        return draw_keep_mask(self.op_rng(op_name), keep, global_shape,
                              starts, local_shape)

    def block_starts(self, global_shape: Sequence[int],
                     placement: "Optional[Placement]") -> Tuple[int, ...]:
        """Where this rank's block of a tensor of ``global_shape`` laid
        out as ``placement`` starts (zeros on one rank)."""
        if self.mesh is None or placement is None:
            return (0,) * len(global_shape)
        return tuple(s.start for s in placement.local_slices(global_shape,
                                                              self.mesh))

    def axes(self, slot: int) -> Tuple[str, ...]:
        """The mesh axes of the current view's ``slot`` (() on one
        device)."""
        return (self.slot_axes or {}).get(slot, ())

    def partial_leader(self, out: int = 0) -> bool:
        """True on the ranks at coordinate 0 of output ``out``'s partial
        axes (every rank when it is not partial): where a term that the
        partial sum must count once, such as a bias, is added."""
        if self.mesh is None or not self.out_placements:
            return True
        return all(self.mesh.coord(a) == 0
                   for a in self.out_placements[out].partial)

    def reduce_partial(self, y: torch.Tensor, out: int = 0) -> torch.Tensor:
        """Sum output ``out``'s partial addends over their axes here,
        inside the op, and record the result as no longer partial."""
        if self.mesh is None or not self.out_placements[out].partial:
            return y
        from flexflow_tpu_torch.parallel.mesh import reshard

        src = self.out_placements[out]
        dst = src.without_partial()
        self.out_placements[out] = dst
        return reshard(y, src, dst, self.mesh)

    def local_sizes(self, sizes: Sequence[int], out: int = 0
                    ) -> Tuple[int, ...]:
        """This rank's shard sizes of output ``out``'s global ``sizes``."""
        if self.mesh is None or not self.out_placements:
            return tuple(sizes)
        return self.out_placements[out].local_sizes(sizes, self.mesh)


class Operator:
    """Immutable operator descriptor (graph node payload)."""

    op_type: OperatorType = OperatorType.NOOP
    # True for graph sources (inputs/constants), whose outputs carry no
    # gradient in training
    is_gradient_free: bool = False

    def __init__(self, name: str,
                 input_shapes: Sequence[ParallelTensorShape], **attrs):
        self.name = name
        self.input_shapes: Tuple[ParallelTensorShape, ...] = tuple(
            s.drop_parallelism() for s in input_shapes)
        self.attrs: Dict[str, Any] = dict(attrs)
        self.output_shapes: Tuple[ParallelTensorShape, ...] = tuple(
            self.infer())
        self._weight_specs: Tuple[WeightSpec, ...] = tuple(
            self.weight_specs())

    def infer(self) -> Sequence[ParallelTensorShape]:
        raise NotImplementedError(type(self).__name__)

    def weight_specs(self) -> Sequence[WeightSpec]:
        return ()

    def forward(self, ctx: LoweringContext, inputs: List[torch.Tensor],
                weights: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError(type(self).__name__)

    def forward_sharded(self, ctx: LoweringContext,
                        inputs: List[torch.Tensor],
                        weights: Dict[str, torch.Tensor],
                        osh: OpSharding) -> Optional[List[torch.Tensor]]:
        """Outputs computed with the op's own collectives when its
        ``forward`` on the local shards would be wrong for this
        sharding, or None to use ``forward``.  Called only on a mesh of
        more than one rank."""
        return None

    def propagate(self, mv: MachineView) -> OpSharding:
        """Default rule: elementwise-style — every input shares the
        output's annotation (valid only when input rank == output
        rank); weights replicated over all parts."""
        out = ShardAnnot(mv.dim_degrees, mv.replica_degree)
        ins = tuple(ShardAnnot(mv.dim_degrees, mv.replica_degree)
                    for _ in self.input_shapes)
        w = tuple(ShardAnnot((1,) * len(ws.shape), mv.num_parts)
                  for ws in self._weight_specs)
        return OpSharding(inputs=ins, weights=w, outputs=(out,))

    def flops(self) -> float:
        """Forward FLOPs estimate (reference ops/base.py:220-223)."""
        return float(sum(s.num_elements for s in self.output_shapes))

    def bytes_accessed(self) -> float:
        """HBM bytes of one forward: every input and output once, every
        weight once (reference ops/base.py:225-233)."""
        b = sum(s.num_bytes for s in self.input_shapes)
        b += sum(s.num_bytes for s in self.output_shapes)
        for w in self._weight_specs:
            n = 1
            for d in w.shape:
                n *= d
            b += n * w.dtype.itemsize
        return float(b)

    def fixed_machine_view(self) -> Optional[MachineView]:
        """Non-None when the op's attributes pin its view (the parallel
        ops)."""
        return None

    def draws_dropout(self) -> bool:
        """Whether a training pass of the op draws dropout masks."""
        return False

    def splittable_output_dims(self) -> Tuple[int, ...]:
        """Output dims a strategy may partition. Default: dim 0."""
        return (0,) if self.output_shapes[0].ndim else ()

    def max_replica_degree(self) -> int:
        """>1 if the op supports partial-sum (row-parallel) execution."""
        return 1

    # attrs that never change the lone-op kernel a one-card probe
    # measures (they select a multi-device scheme): left out of
    # calibration_signature, so one record serves every mode
    _CALIBRATION_INERT_ATTRS: frozenset = frozenset()

    def signature(self) -> Tuple:
        """Structural identity: two ops with equal signatures have equal
        shapes and propagation (reference ops/base.py:243-258)."""
        sig = getattr(self, "_sig_cache", None)
        if sig is None:
            sig = (self.op_type.value,
                   tuple(s.sizes for s in self.input_shapes),
                   tuple(s.dtype.value for s in self.input_shapes),
                   tuple(sorted((k, _sig_value(v))
                                for k, v in self.attrs.items())))
            self._sig_cache = sig
        return sig

    def calibration_signature(self) -> Tuple:
        """The identity of a measured record: ``signature()`` less the
        ``_CALIBRATION_INERT_ATTRS`` (reference ops/base.py:260-277)."""
        if not self._CALIBRATION_INERT_ATTRS:
            return self.signature()
        sig = self.signature()
        attrs = tuple((k, v) for k, v in sig[3]
                      if k not in self._CALIBRATION_INERT_ATTRS)
        return sig[:3] + (attrs,) + sig[4:]

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name})"


def _sig_value(v):
    if isinstance(v, (list, tuple)):
        return tuple(_sig_value(x) for x in v)
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    if isinstance(v, DataType):
        return v.value
    return repr(v)


OP_REGISTRY: Dict[OperatorType, Type[Operator]] = {}


def register_op(cls: Type[Operator]) -> Type[Operator]:
    OP_REGISTRY[cls.op_type] = cls
    return cls
