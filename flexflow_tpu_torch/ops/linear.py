"""Linear (dense) operator — the port of ``LinearOp`` in
flexflow_tpu/ops/linear.py (linear.py:106-113): the input and kernel
cast to the compute dtype, the product accumulated AND returned in
float32 (the reference's ``preferred_element_type=jnp.float32``), a
float32 bias, then the activation.  ``matmul_acc32`` is that product;
the MHA and decode-attention output projections use it too.
Gradients flow through it by autograd; ``flops`` is the reference's
(linear.py:142-144) and so is ``propagate`` (linear.py:116-140).

On a rank's shards (``propagate``'s layouts): the input holds the
rank's rows and, under a replica (contraction) split, its block of the
in dim; the kernel its [in / r, out / t] block.  The product is then a
partial sum over the replica axes, and the bias, replicated there, is
added on one rank of them only (``LoweringContext.partial_leader``), so
the sum counts it once, and so does its gradient, which the weight
sync sums over those axes.  An activation cannot act on addends: with
one, the op sums its output itself (``reduce_partial``) after the bias
and before the activation.  A softmax under an out-dim split takes its
row whole (``_row_softmax``), as the reference's GSPMD does."""

from __future__ import annotations

from dataclasses import replace
from typing import Sequence

import torch

from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import DataType, ParallelTensorShape
from flexflow_tpu_torch.initializers import (
    DEFAULT_BIAS_INIT,
    DEFAULT_WEIGHT_INIT,
    Initializer,
)
from flexflow_tpu_torch.kernels.flash_attention import _bmm32
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.ops.base import (
    REPLICA_SLOT,
    Operator,
    OpSharding,
    ShardAnnot,
    WeightSpec,
    register_op,
)


class _MatmulAcc32(torch.autograd.Function):
    """fp32 product of compute-dtype operands a [M, K] and b [K, N], or
    a batch of them, a [N, M, K] and b [N, K, P].  The backward forms dA
    and dB the same way from the cotangent cast to the compute dtype
    (the reference's transpose contracts the fp32 cotangent; rounding it
    once keeps both backward products on the card's bf16 tensor cores)
    and casts them to the operands' dtypes.  On the card it also gives
    ``torch.bmm``'s ``out_dtype`` form, which has none, a derivative."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mm32(g, b.transpose(-2, -1)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _mm32(a.transpose(-2, -1), g).to(b.dtype)
        return da, db


def _mm32(a, b):
    if a.dim() == 3:
        return _bmm32(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    # products of bf16 values are exact in fp32: the reference's
    # function up to summation order
    return torch.mm(a.float(), b.float())


def matmul_acc32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, N] -> float32 [..., N], both operands already
    in the compute dtype: the reference's ``jnp.dot(...,
    preferred_element_type=jnp.float32)``.  float32 operands give
    exactly ``torch.matmul``; lower-precision operands accumulate in
    float32 and the result stays float32 (``torch.mm`` with
    ``out_dtype`` on the card), instead of being rounded to the compute
    dtype first."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    y = _MatmulAcc32.apply(a.reshape(-1, a.shape[-1]), b)
    return y.view(*a.shape[:-1], b.shape[-1])


_ACTIVATIONS = {  # the reference's table (linear.py:40-47), on fp32
    None: lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def _row_softmax(ctx, y):
    """The softmax of rows whose out dim is split over ranks: the row
    gathered whole, its softmax, this rank's block of it (the
    gradients: the blocks' gathered whole, the whole row's cut back to
    this rank's block), so every rank computes one process's bits."""
    from flexflow_tpu_torch.parallel.mesh import reshard

    split = ctx.out_placements[0]
    whole = replace(split, dims=split.dims[:-1] + ((),))
    row = reshard(y, split, whole, ctx.mesh)
    return reshard(torch.softmax(row, dim=-1), whole, split, ctx.mesh)


@register_op
class LinearOp(Operator):
    op_type = OperatorType.LINEAR

    def __init__(self, name, input_shapes, out_dim: int,
                 activation: str | None = None, use_bias: bool = True,
                 kernel_initializer: Initializer | None = None,
                 bias_initializer: Initializer | None = None,
                 param_dtype: str = "float32"):
        if activation not in _ACTIVATIONS:
            raise NotImplementedError(
                f"LinearOp activation {activation!r} not supported; one of "
                f"{sorted(k for k in _ACTIVATIONS if k)}")
        self._kernel_init = kernel_initializer or DEFAULT_WEIGHT_INIT
        self._bias_init = bias_initializer or DEFAULT_BIAS_INIT
        super().__init__(name, input_shapes, out_dim=out_dim,
                         activation=activation, use_bias=use_bias,
                         param_dtype=param_dtype)

    def infer(self) -> Sequence[ParallelTensorShape]:
        x = self.input_shapes[0]
        return (ParallelTensorShape.make(
            x.sizes[:-1] + (self.attrs["out_dim"],), x.dtype),)

    @property
    def in_dim(self) -> int:
        return self.input_shapes[0].sizes[-1]

    def weight_specs(self):
        pd = DataType.from_any(self.attrs["param_dtype"])
        specs = [WeightSpec("kernel", (self.in_dim, self.attrs["out_dim"]),
                            pd, self._kernel_init)]
        if self.attrs["use_bias"]:
            specs.append(WeightSpec("bias", (self.attrs["out_dim"],),
                                    pd, self._bias_init))
        return specs

    def forward(self, ctx, inputs, weights):
        cd = ctx.compute_dtype
        y = matmul_acc32(inputs[0].to(cd), weights["kernel"].to(cd))
        if self.attrs["use_bias"] and ctx.partial_leader():
            y = y + weights["bias"].float()
        if self.attrs["activation"] is not None:
            y = ctx.reduce_partial(y)
        if (self.attrs["activation"] == "softmax" and ctx.out_placements
                and ctx.out_placements[0].dims[-1]):
            y = _row_softmax(ctx, y)
        else:
            y = _ACTIVATIONS[self.attrs["activation"]](y)
        return [y.to(inputs[0].dtype)]

    def propagate(self, mv: MachineView) -> OpSharding:
        degs = mv.dim_degrees
        r = mv.replica_degree  # contraction split
        t = degs[-1]  # out-dim split
        batch_parts = 1
        for d in degs[:-1]:
            batch_parts *= d
        nd = len(degs)
        x_annot = ShardAnnot(
            degs[:-1] + (r,),
            replica=t,
            idx=tuple(range(nd - 1)) + (REPLICA_SLOT,),
        )
        out = ShardAnnot(degs, replica=r, partial=r > 1)
        w = [ShardAnnot((r, t), replica=batch_parts,
                        idx=(REPLICA_SLOT, nd - 1))]
        if self.attrs["use_bias"]:
            w.append(ShardAnnot((t,), replica=batch_parts * r, idx=(nd - 1,)))
        return OpSharding(inputs=(x_annot,), weights=tuple(w), outputs=(out,))

    def splittable_output_dims(self):
        # any batch dim + the out-channel dim
        return tuple(range(self.output_shapes[0].ndim))

    def max_replica_degree(self) -> int:
        return self.in_dim

    def flops(self) -> float:
        return 2.0 * self.output_shapes[0].num_elements * self.in_dim
