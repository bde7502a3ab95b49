"""MultiHeadAttention on one device — the port of ``MultiHeadAttentionOp``
in flexflow_tpu/ops/attention.py.

query [B, Sq, E], key [B, Sk, E], value [B, Sk, E] -> [B, Sq, E] with
the reference's weight layouts (wq/wk/wv [E, H, dk], wo [H, dk, E],
optional biases) and dtype flow: inputs and weights cast to the compute
dtype, q/k/v projected there, attention, the output projection, an fp32
bias, the result cast back to the query's dtype.  As in the port's
``LinearOp``, a bfloat16 output projection is rounded to bfloat16 before
the bias add, where XLA keeps it in float32.

Which attention runs is ``flash_route``, a function of shapes: the
flash kernels (``kernels/flash_attention.py``) when ``use_flash`` is set,
the reference's shape threshold holds (ops/attention.py:248-255, tuned
on a TPU v5e and kept so both packages take the same path; not yet
measured on the card), ``_pick_block`` finds the reference's blocks, and
the head dim is one the CUDA kernels take; otherwise the reference's
XLA path, ``attn_core``.  The reference's try/except around the flash
call is not copied: a CUDA tensor that takes the flash route launches
the kernels or raises.

Not ported here: attention dropout in training (raises; a later slice),
and the ring and Ulysses sequence-parallel branches (multi-device).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import DataType, ParallelTensorShape
from flexflow_tpu_torch.initializers import DEFAULT_WEIGHT_INIT, Initializer
from flexflow_tpu_torch.kernels.flash_attention import (
    HEAD_DIMS,
    _pick_block,
    attn_core,
    flash_attention,
)
from flexflow_tpu_torch.ops.base import Operator, WeightSpec, register_op

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
    allows), sp_mode (the reference's sequence-parallel scheme; inert
    on one device)."""

    op_type = OperatorType.MULTIHEAD_ATTENTION

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

    def uses_flash(self) -> bool:
        q, k = self.input_shapes[0], self.input_shapes[1]
        return flash_route(q.sizes[1], k.sizes[1], self.head_dim,
                           self.attrs["use_flash"])

    def forward(self, ctx, inputs, weights):
        a = self.attrs
        if a["dropout"] > 0.0 and ctx.train:
            raise NotImplementedError(
                f"{self.name}: attention dropout in training comes with a "
                f"later slice of the port; build with dropout=0")
        cd = ctx.compute_dtype
        # self-attention feeds one tensor three times: cast it once
        q = inputs[0].to(cd)
        k = q if inputs[1] is inputs[0] else inputs[1].to(cd)
        v = k if inputs[2] is inputs[1] else inputs[2].to(cd)
        qh, kh, vh = (_project(x, weights[n].to(cd))
                      for x, n in ((q, "wq"), (k, "wk"), (v, "wv")))
        if a["use_bias"]:
            qh = qh + weights["bq"].to(cd)
            kh = kh + weights["bk"].to(cd)
            vh = vh + weights["bv"].to(cd)
        scale = 1.0 / math.sqrt(self.head_dim)
        attend = flash_attention if self.uses_flash() else attn_core
        out = attend(qh, kh, vh, a["causal"], scale)  # [B, Sq, H, dk]
        wo = weights["wo"].to(cd)
        y = torch.matmul(out.reshape(*out.shape[:2], -1),
                         wo.reshape(-1, wo.shape[-1])).float()
        if a["use_bias"]:
            y = y + weights["bo"].float()
        return [y.to(inputs[0].dtype)]

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
