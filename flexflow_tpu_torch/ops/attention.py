"""MultiHeadAttention on one device — the port of ``MultiHeadAttentionOp``
in flexflow_tpu/ops/attention.py.

query [B, Sq, E], key [B, Sk, E], value [B, Sk, E] -> [B, Sq, E] with
the reference's weight layouts (wq/wk/wv [E, H, dk], wo [H, dk, E],
optional biases) and dtype flow: inputs and weights cast to the compute
dtype, q/k/v projected there, attention, the output projection with an
fp32 result (``matmul_acc32``, as the reference's
``preferred_element_type=float32``), an fp32 bias, the result cast back
to the query's dtype.

Which attention runs is ``flash_route``, a function of shapes: the
flash kernels (``kernels/flash_attention.py``) when ``use_flash`` is set,
the reference's shape threshold holds (ops/attention.py:248-255, tuned
on a TPU v5e and kept so both packages take the same path; not yet
measured on the card), ``_pick_block`` finds the reference's blocks, and
the head dim is one the CUDA kernels take; otherwise the reference's
XLA path, ``attn_core``.  The reference's try/except around the flash
call is not copied: a CUDA tensor that takes the flash route launches
the kernels or raises.

On a rank's shards (``propagate``, reference ops/attention.py:272-299):
under a replica (head) split the rank holds its heads' blocks of wq,
wk, wv and wo, so it attends over its local heads and its output is a
partial sum over the head axes; ``bo``, replicated there, is added on
one rank of them only (``LoweringContext.partial_leader``).  Under a
batch split it attends over its rows.  When the view splits the
sequence (slot 1 has mesh axes), self-attention without dropout runs
over the process group of those axes, as the reference's
``_attention`` does (ops/attention.py:196-247): the all-to-all of
``parallel/ulysses.py`` where ``_use_ulysses`` picks it (the
reference's rule), else the zigzag or contiguous ring of
``parallel/ring_attention.py``.  ``uses_flash`` decides the route from
the op's global shapes, so a strategy never changes it.  Cross-attention
or attention dropout under a split sequence takes the reference's
all-gather path (ops/attention.py:205-228), with its ``RuntimeWarning``:
each rank holds a contiguous block of the query rows (the zigzag order
lives inside the ring only), self-attention's K/V blocks are gathered
over the sequence axes in coordinate order, which is the natural order
(``all_gather_summed``: the backward sums the ranks' K/V gradients),
cross-attention's K/V are whole already (its view keeps them so), and
the rank attends its rows with their global causal offsets
(``attn_core``/``attn_core_dropout`` with ``q0``); the dropout mask is
this rank's rows of the whole mask, drawn at each element's global
index, so it is the unsplit run's.

Attention dropout in training takes the reference's route
(ops/attention.py:200-270): never the flash kernels, always
``attn_core_dropout`` with the mask ``LoweringContext.dropout_mask``
draws for [B, H, Sq, Sk] (this rank's batch rows and heads of the whole
mask under a batch or head split).  Outside training the op takes its
usual route.

``BatchMatmulOp`` is the reference's (ops/attention.py:312-382):
[..., M, K] x [..., K, N] in the compute dtype with an fp32 product,
cast back to the first input's dtype.  With ``ctx.seq_length`` > 0
(``FFConfig.iteration.seq_length``, set by the flat, pipelined and
placed lowerings as the reference's are) the inputs are zeroed past it
along ``a_seq_length_dim`` and ``b_seq_length_dim`` before the product
(reference :338-355), by the global index of each row: a rank whose
block of that dim starts at row s masks its rows at s and on.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import DataType, ParallelTensorShape
from flexflow_tpu_torch.initializers import DEFAULT_WEIGHT_INIT, Initializer
from flexflow_tpu_torch.kernels.flash_attention import (
    HEAD_DIMS,
    _pick_block,
    attn_core,
    attn_core_dropout,
    flash_attention,
)
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.ops.base import (
    REPLICA_SLOT,
    Operator,
    OpSharding,
    ShardAnnot,
    WeightSpec,
    register_op,
)
from flexflow_tpu_torch.ops.linear import _MatmulAcc32, matmul_acc32

# the reference's flash defaults and threshold (flash_attention.py:666-669,
# ops/attention.py:255)
FLASH_BLOCK_Q = 512
FLASH_BLOCK_K = 1024
FLASH_MIN_SK = 512
FLASH_MIN_QK = 512 * 2048


def flash_route(sq: int, sk: int, head_dim: int, use_flash: bool) -> bool:
    """True when attention over these shapes takes the flash kernels."""
    profitable = sk >= FLASH_MIN_SK or sq * sk >= FLASH_MIN_QK
    return (use_flash and profitable
            and _pick_block(sq, FLASH_BLOCK_Q) is not None
            and _pick_block(sk, FLASH_BLOCK_K) is not None
            and head_dim in HEAD_DIMS)


def _project(x, w):
    """[B, S, E] x [E, H, dk] -> [B, S, H, dk] (one matmul)."""
    e, h, dk = w.shape
    return torch.matmul(x, w.reshape(e, h * dk)).view(*x.shape[:-1], h, dk)


@register_op
class MultiHeadAttentionOp(Operator):
    """attrs: embed_dim, num_heads, kdim, vdim, dropout, use_bias,
    causal, use_flash (take the flash kernels where ``flash_route``
    allows), sp_mode (the reference's sequence-parallel scheme, read
    when the sequence is split across ranks)."""

    op_type = OperatorType.MULTIHEAD_ATTENTION
    # sp_mode picks the multi-rank scheme; a one-card probe never runs
    # the collective, so records are shared across modes
    _CALIBRATION_INERT_ATTRS = frozenset({"sp_mode"})

    def __init__(self, name, input_shapes, embed_dim: int, num_heads: int,
                 kdim: int = 0, vdim: int = 0, dropout: float = 0.0,
                 use_bias: bool = False, causal: bool = False,
                 use_flash: bool = True, sp_mode: str = "ring",
                 kernel_initializer: Initializer | None = None):
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} does not divide into "
                             f"{num_heads} heads")
        if sp_mode not in ("ring", "ulysses", "auto"):
            raise ValueError(f"sp_mode must be ring, ulysses or auto, got "
                             f"{sp_mode!r}")
        self._kernel_init = kernel_initializer or DEFAULT_WEIGHT_INIT
        super().__init__(name, input_shapes, embed_dim=embed_dim,
                         num_heads=num_heads, kdim=kdim or embed_dim,
                         vdim=vdim or embed_dim, dropout=dropout,
                         use_bias=use_bias, causal=causal,
                         use_flash=use_flash, sp_mode=sp_mode)

    def _use_ulysses(self, n: int) -> bool:
        """Whether a seq degree of ``n`` is served by the all-to-all
        exchange instead of the ring (reference ops/attention.py:94-110:
        the ring when the head count does not divide; ``auto`` picks
        Ulysses only for non-causal attention at n >= 3, where it moves
        fewer bytes than the ring)."""
        a = self.attrs
        mode = a.get("sp_mode", "ring")
        if n <= 1 or a["num_heads"] % n != 0:
            return False
        if mode == "ulysses":
            return True
        return mode == "auto" and not a["causal"] and n >= 3

    def ring_comm_bytes(self, mv) -> Tuple[float, int, int]:
        """(forward wire bytes per device, seq degree, view slot the
        collective rides) when the view splits the SEQUENCE dim —
        execution then runs the sequence-parallel scheme ``sp_mode``
        selects: the ring rotates the K and V shards n-1 ppermute hops
        each (parallel/ring_attention.py), the Ulysses exchange moves
        (n-1)/n of each of q/k/v/out through one all-to-all pair
        (parallel/ulysses.py).  The backward re-runs the collective;
        the cost model doubles it.  Charged so sequence parallelism is
        not ranked as free compute-splitting (the compute roofline
        alone would say it is).

        Zero for cross-attention (Sk != Sq — propagate keeps K/V whole
        and execution takes the non-ring path) and the bytes shrink by
        the head-parallel replica degree (each device moves only its
        own heads' columns)."""
        q, k = self.input_shapes[0], self.input_shapes[1]
        n = mv.dim_degrees[1] if len(mv.dim_degrees) > 1 else 1
        if n <= 1 or k.sizes[1] != q.sizes[1]:
            return 0.0, 1, 1
        b_loc = q.sizes[0] / max(mv.dim_degrees[0], 1)
        e = self.attrs["embed_dim"] / max(mv.replica_degree, 1)
        shard = b_loc * (q.sizes[1] / n) * e * q.dtype.itemsize
        if self._use_ulysses(n):
            # q/k/v/out each move (n-1)/n of one local shard, once
            return 4.0 * (n - 1) / n * shard, n, 1
        return 2.0 * (n - 1) * shard, n, 1  # K and V, n-1 hops each

    def infer(self) -> Sequence[ParallelTensorShape]:
        q = self.input_shapes[0]
        return (ParallelTensorShape.make(
            (q.sizes[0], q.sizes[1], self.attrs["embed_dim"]), q.dtype),)

    @property
    def head_dim(self) -> int:
        return self.attrs["embed_dim"] // self.attrs["num_heads"]

    def weight_specs(self):
        a = self.attrs
        e, h, dk = a["embed_dim"], a["num_heads"], self.head_dim
        qe, ke, ve = (s.sizes[-1] for s in self.input_shapes[:3])
        specs = [
            WeightSpec("wq", (qe, h, dk), DataType.FLOAT32, self._kernel_init),
            WeightSpec("wk", (ke, h, dk), DataType.FLOAT32, self._kernel_init),
            WeightSpec("wv", (ve, h, dk), DataType.FLOAT32, self._kernel_init),
            WeightSpec("wo", (h, dk, e), DataType.FLOAT32, self._kernel_init),
        ]
        if a["use_bias"]:
            specs += [
                WeightSpec("bq", (h, dk), DataType.FLOAT32,
                           DEFAULT_WEIGHT_INIT),
                WeightSpec("bk", (h, dk), DataType.FLOAT32,
                           DEFAULT_WEIGHT_INIT),
                WeightSpec("bv", (h, dk), DataType.FLOAT32,
                           DEFAULT_WEIGHT_INIT),
                WeightSpec("bo", (e,), DataType.FLOAT32, DEFAULT_WEIGHT_INIT),
            ]
        return specs

    def draws_dropout(self) -> bool:
        return self.attrs["dropout"] > 0.0

    def uses_flash(self) -> bool:
        q, k = self.input_shapes[0], self.input_shapes[1]
        return flash_route(q.sizes[1], k.sizes[1], self.head_dim,
                           self.attrs["use_flash"])

    def forward(self, ctx, inputs, weights):
        a = self.attrs
        cd = ctx.compute_dtype
        # self-attention feeds one tensor three times: cast it once
        q = inputs[0].to(cd)
        k = q if inputs[1] is inputs[0] else inputs[1].to(cd)
        v = k if inputs[2] is inputs[1] else inputs[2].to(cd)
        # [B, S, H', dk]: H' the heads of this rank's wq/wk/wv blocks
        qh, kh, vh = (_project(x, weights[n].to(cd))
                      for x, n in ((q, "wq"), (k, "wk"), (v, "wv")))
        if a["use_bias"]:
            qh = qh + weights["bq"].to(cd)
            kh = kh + weights["bk"].to(cd)
            vh = vh + weights["bv"].to(cd)
        scale = 1.0 / math.sqrt(self.head_dim)
        seq_axes = ctx.axes(1)
        dropout_active = a["dropout"] > 0.0 and ctx.train
        self_attn = (self.input_shapes[0].sizes[1]
                     == self.input_shapes[1].sizes[1])
        if ctx.mesh is not None and seq_axes and (dropout_active
                                                  or not self_attn):
            out = self._gathered(ctx, seq_axes, qh, kh, vh, scale,
                                 dropout_active, self_attn)
        elif ctx.mesh is not None and seq_axes:
            out = self._sequence_parallel(ctx, seq_axes, qh, kh, vh, scale)
        elif dropout_active:
            keep = 1.0 - a["dropout"]
            mask = ctx.dropout_mask(self.name, keep,
                                    self.mask_shape(),
                                    self._mask_starts(ctx, qh.shape[2]),
                                    (qh.shape[0], qh.shape[2], qh.shape[1],
                                     kh.shape[1]))
            out = attn_core_dropout(qh, kh, vh, mask, a["causal"], scale,
                                    keep)
        else:
            attend = flash_attention if self.uses_flash() else attn_core
            out = attend(qh, kh, vh, a["causal"], scale)  # [B, Sq, H', dk]
        wo = weights["wo"].to(cd)
        y = matmul_acc32(out.reshape(*out.shape[:2], -1),
                         wo.reshape(-1, wo.shape[-1]))
        if a["use_bias"] and ctx.partial_leader():
            y = y + weights["bo"].float()
        return [y.to(inputs[0].dtype)]

    def mask_shape(self) -> Tuple[int, int, int, int]:
        """The whole attention-dropout mask's shape, [B, H, Sq, Sk]."""
        q, k = self.input_shapes[0], self.input_shapes[1]
        return (q.sizes[0], self.attrs["num_heads"], q.sizes[1], k.sizes[1])

    def _mask_starts(self, ctx, local_heads: int) -> Tuple[int, ...]:
        """Where this rank's [b, h', Sq', Sk] block of the mask starts:
        its batch and query rows (the query's layout) and its heads (the
        replica slot's axes, as wq's head dim)."""
        b0, q0 = ctx.block_starts(self.input_shapes[0].sizes,
                                  ctx.in_placements[0] if ctx.in_placements
                                  else None)[:2]
        h0 = 0
        if ctx.mesh is not None:
            h0 = ctx.mesh.index(ctx.axes(REPLICA_SLOT)) * local_heads
        return (b0, h0, q0, 0)

    def _gathered(self, ctx, seq_axes, qh, kh, vh, scale, dropout_active,
                  self_attn):
        """The reference's all-gather path under a split sequence (module
        docstring): this rank's query rows over the whole K/V."""
        import warnings

        from flexflow_tpu_torch.parallel.mesh import all_gather_summed

        reason = ("cross-attention (Sk != Sq)" if not self_attn
                  else "attention dropout active")
        warnings.warn(
            f"{self.name}: sequence-parallel strategy degrades to the "
            f"all-gather attention path ({reason}); K/V will be "
            f"gathered across the seq axis", RuntimeWarning, stacklevel=3)
        a = self.attrs
        sq_total = self.input_shapes[0].sizes[1]
        q0 = ctx.mesh.index(seq_axes) * qh.shape[1]
        if self_attn:
            kh = all_gather_summed(kh, 1, seq_axes, ctx.mesh)
            vh = all_gather_summed(vh, 1, seq_axes, ctx.mesh)
        if not dropout_active:
            return attn_core(qh, kh, vh, a["causal"], scale, q0, sq_total)
        keep = 1.0 - a["dropout"]
        starts = self._mask_starts(ctx, qh.shape[2])
        mask = ctx.dropout_mask(self.name, keep, self.mask_shape(), starts,
                                (qh.shape[0], qh.shape[2], qh.shape[1],
                                 kh.shape[1]))
        return attn_core_dropout(qh, kh, vh, mask, a["causal"], scale,
                                 keep, q0, sq_total)

    def _sequence_parallel(self, ctx, seq_axes, qh, kh, vh, scale):
        """Self-attention over the sequence split across ``seq_axes``."""
        n = ctx.mesh.size(seq_axes)
        group = ctx.mesh.group(seq_axes)
        if self._use_ulysses(n):
            from flexflow_tpu_torch.parallel.ulysses import ulysses_attention

            return ulysses_attention(qh, kh, vh, seq_axes, ctx.mesh,
                                     causal=self.attrs["causal"],
                                     scale=scale, flash=self.uses_flash())
        from flexflow_tpu_torch.parallel.ring_attention import ring_attention

        return ring_attention(qh, kh, vh, group,
                              causal=self.attrs["causal"], scale=scale)

    def propagate(self, mv: MachineView) -> OpSharding:
        b, sq, e_deg = mv.dim_degrees
        assert e_deg == 1, "embed dim of attention output stays whole"
        r = mv.replica_degree  # head split -> partial sums over wo
        q_annot = ShardAnnot((b, sq, 1), replica=r)
        # self-attention: K/V stay seq-sharded too (ring attention rotates
        # them); cross-attention with a different kv length keeps K/V whole
        kv_seq = sq if self.input_shapes[1].sizes[1] == self.input_shapes[0].sizes[1] else 1
        kv_annot = ShardAnnot((b, kv_seq, 1), replica=r)
        out = ShardAnnot(mv.dim_degrees, replica=r, partial=r > 1)
        R = REPLICA_SLOT
        head_w = ShardAnnot((1, r, 1), replica=b, idx=(-1, R, -1))
        ws = [
            head_w,  # wq [E,H,dk] split over heads
            head_w,
            head_w,
            ShardAnnot((r, 1, 1), replica=b, idx=(R, -1, -1)),  # wo [H,dk,E]
        ]
        if self.attrs["use_bias"]:
            hb = ShardAnnot((r, 1), replica=b, idx=(R, -1))
            ws += [hb, hb, hb, ShardAnnot((1,), replica=b * r)]
        return OpSharding(inputs=(q_annot, kv_annot, kv_annot), weights=tuple(ws), outputs=(out,))

    def splittable_output_dims(self):
        return (0, 1)  # batch and sequence

    def max_replica_degree(self) -> int:
        return self.attrs["num_heads"]

    def flops(self) -> float:
        """The reference's estimate (ops/attention.py:301-308): the four
        projections plus the full [Sq, Sk] score and value products."""
        a = self.attrs
        bsz, sq, e = self.output_shapes[0].sizes
        sk = self.input_shapes[1].sizes[1]
        h, dk = a["num_heads"], self.head_dim
        proj = 2.0 * bsz * (sq * e * h * dk * 2 + sk * e * h * dk * 2)
        attn = 2.0 * bsz * h * sq * sk * dk * 2
        return proj + attn


@register_op
class BatchMatmulOp(Operator):
    """[B, M, K] x [B, K, N] -> [B, M, N]; the seq-length masking dims
    are the reference's attrs (model.h:451-455)."""

    op_type = OperatorType.BATCH_MATMUL

    def __init__(self, name, input_shapes, a_seq_length_dim: int = -1,
                 b_seq_length_dim: int = -1):
        super().__init__(name, input_shapes,
                         a_seq_length_dim=a_seq_length_dim,
                         b_seq_length_dim=b_seq_length_dim)

    def infer(self) -> Sequence[ParallelTensorShape]:
        a, b = self.input_shapes
        if a.sizes[-1] != b.sizes[-2] or a.sizes[:-2] != b.sizes[:-2]:
            raise ValueError(f"batch_matmul of {a.sizes} and {b.sizes}")
        return (ParallelTensorShape.make(a.sizes[:-1] + (b.sizes[-1],),
                                         a.dtype),)

    def _seq_mask(self, ctx, t, i, dim):
        """``t`` (input ``i``) zeroed at global indices >= seq_length
        along ``dim`` (attr < 0: unmasked)."""
        if dim < 0:
            return t
        d = dim % t.ndim
        start = 0
        if ctx.mesh is not None and len(ctx.in_placements) > i:
            axes = ctx.in_placements[i].dims[d]
            if axes:
                start = ctx.mesh.index(axes) * t.shape[d]
        idx = torch.arange(start, start + t.shape[d], device=t.device)
        keep = (idx < ctx.seq_length).reshape(
            [t.shape[d] if j == d else 1 for j in range(t.ndim)])
        return torch.where(keep, t, torch.zeros((), dtype=t.dtype,
                                                device=t.device))

    def forward(self, ctx, inputs, weights):
        x, y = inputs
        cd = ctx.compute_dtype
        xs, ys = x.shape, y.shape
        xc, yc = x.to(cd), y.to(cd)
        if ctx.seq_length > 0:
            xc = self._seq_mask(ctx, xc, 0, self.attrs["a_seq_length_dim"])
            yc = self._seq_mask(ctx, yc, 1, self.attrs["b_seq_length_dim"])
        z = _MatmulAcc32.apply(xc.reshape(-1, *xs[-2:]),
                               yc.reshape(-1, *ys[-2:]))
        return [z.view(*xs[:-1], ys[-1]).to(x.dtype)]

    def propagate(self, mv: MachineView) -> OpSharding:
        degs = mv.dim_degrees  # [..., M, N]
        r = mv.replica_degree  # K split
        m, n = degs[-2], degs[-1]
        batch = degs[:-2]
        nd = len(degs)
        bidx = tuple(range(nd - 2))
        a_annot = ShardAnnot(batch + (m, r), replica=n,
                             idx=bidx + (nd - 2, REPLICA_SLOT))
        b_annot = ShardAnnot(batch + (r, n), replica=m,
                             idx=bidx + (REPLICA_SLOT, nd - 1))
        out = ShardAnnot(degs, replica=r, partial=r > 1)
        return OpSharding(inputs=(a_annot, b_annot), weights=(),
                          outputs=(out,))

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return tuple(range(self.output_shapes[0].ndim))

    def max_replica_degree(self) -> int:
        return self.input_shapes[0].sizes[-1]

    def flops(self) -> float:
        out = self.output_shapes[0]
        return 2.0 * out.num_elements * self.input_shapes[0].sizes[-1]
