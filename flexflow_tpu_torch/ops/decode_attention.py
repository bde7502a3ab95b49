"""DecodeAttentionOp — the port of flexflow_tpu/ops/decode_attention.py
(``forward``, fp32 and bf16 pools).

One decode step projects the fresh token's q/k/v, scatters the new k/v
into this layer's page-pool cache (model STATE, threaded through
``ctx.state_in``/``state_out``) and attends the query against the
sequence's ragged cache through ``kernels/ragged_paged_attention``.
Inputs:

* hidden     [B, 1, E]            — the decode frame's token embeddings
* page_table [B, pages_per_seq]   — int32 page ids into the pool
* seq_lens   [B]                  — int32 tokens ALREADY cached per
                                    sequence (the fresh token lands at
                                    position seq_lens[b]; attention runs
                                    over seq_lens[b] + 1 tokens)

Same dtype discipline as the reference: projections in the compute
dtype, the cache and the softmax in fp32 (a bf16 pool stores the cast).

Where the port departs from JAX: the KV pool is updated IN PLACE
(``index_put_``) instead of by the functional ``.at[].set`` — the pool
is the largest tensor of the model, and a copy per layer per frame
would double the step's memory traffic.  ``state_out`` still publishes
the (same) pool tensors under their keys.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import DataType, ParallelTensorShape
from flexflow_tpu_torch.initializers import DEFAULT_WEIGHT_INIT, Initializer
from flexflow_tpu_torch.kernels.ragged_paged_attention import (
    ragged_paged_attention,
    ragged_paged_attention_reference,
)
from flexflow_tpu_torch.ops.base import (
    LoweringContext,
    Operator,
    WeightSpec,
    register_op,
)

_POOL_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@register_op
class DecodeAttentionOp(Operator):
    """hidden [B, 1, E], page_table [B, pages_per_seq] i32,
    seq_lens [B] i32 -> [B, 1, E].

    attrs: embed_dim, num_heads, page_size, pages_per_seq, num_pages
    (pool size; default max_seqs * pages_per_seq), use_kernel (the CUDA
    kernel when True, its plain version when False — on CPU tensors the
    two are the same), kv_dtype (pool dtype, present only when not
    "fp32", as in the reference)."""

    op_type = OperatorType.DECODE_ATTENTION

    def __init__(self, name, input_shapes, embed_dim: int, num_heads: int,
                 page_size: int = 16, pages_per_seq: int = 8,
                 num_pages: int = 0, use_kernel: bool = True,
                 kv_dtype: str = "fp32",
                 kernel_initializer: Initializer | None = None):
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} does not divide into "
                             f"{num_heads} heads")
        if page_size < 1 or pages_per_seq < 1:
            raise ValueError("page_size and pages_per_seq must be >= 1")
        if kv_dtype not in _POOL_DTYPES:
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r}: the int8 pool comes with a later "
                f"serving slice")
        b = input_shapes[0].sizes[0]
        num_pages = num_pages or b * pages_per_seq
        if num_pages < b:
            raise ValueError(f"page pool ({num_pages}) smaller than the "
                             f"decode frame's sequence slots ({b})")
        self._kernel_init = kernel_initializer or DEFAULT_WEIGHT_INIT
        extra = {} if kv_dtype == "fp32" else {"kv_dtype": kv_dtype}
        super().__init__(name, input_shapes, embed_dim=embed_dim,
                         num_heads=num_heads, page_size=page_size,
                         pages_per_seq=pages_per_seq, num_pages=num_pages,
                         use_kernel=use_kernel, **extra)

    def infer(self) -> Sequence[ParallelTensorShape]:
        h, pt, sl = self.input_shapes
        if h.ndim != 3 or h.sizes[1] != 1:
            raise ValueError(f"decode attention wants [B, 1, E] hidden, "
                             f"got {h.sizes}")
        if pt.sizes != (h.sizes[0], self.attrs["pages_per_seq"]):
            raise ValueError(f"page_table shape {pt.sizes}")
        if sl.sizes != (h.sizes[0],):
            raise ValueError(f"seq_lens shape {sl.sizes}")
        return (ParallelTensorShape.make(
            (h.sizes[0], 1, self.attrs["embed_dim"]), h.dtype),)

    @property
    def head_dim(self) -> int:
        return self.attrs["embed_dim"] // self.attrs["num_heads"]

    @property
    def kv_dtype(self) -> str:
        return self.attrs.get("kv_dtype", "fp32")

    def weight_specs(self):
        a = self.attrs
        e, h, dk = a["embed_dim"], a["num_heads"], self.head_dim
        qe = self.input_shapes[0].sizes[-1]
        return [
            WeightSpec("wq", (qe, h, dk), DataType.FLOAT32, self._kernel_init),
            WeightSpec("wk", (qe, h, dk), DataType.FLOAT32, self._kernel_init),
            WeightSpec("wv", (qe, h, dk), DataType.FLOAT32, self._kernel_init),
            WeightSpec("wo", (h, dk, e), DataType.FLOAT32, self._kernel_init),
        ]

    def state_specs(self):
        """The layer's page-pool cache: (name, shape, torch dtype, fill)."""
        a = self.attrs
        shape = (a["num_pages"], a["page_size"], a["num_heads"],
                 self.head_dim)
        dt = _POOL_DTYPES[self.kv_dtype]
        return [("k_cache", shape, dt, 0.0), ("v_cache", shape, dt, 0.0)]

    def forward(self, ctx: LoweringContext, inputs, weights):
        a = self.attrs
        hidden, page_table, seq_lens = inputs
        page_table = page_table.to(torch.int32)
        seq_lens = seq_lens.to(torch.int32)
        cd = ctx.compute_dtype
        x = hidden[:, 0, :].to(cd)  # [B, E]
        wq, wk, wv, wo = (weights[n].to(cd) for n in ("wq", "wk", "wv", "wo"))
        q = torch.einsum("be,ehd->bhd", x, wq)
        k_new = torch.einsum("be,ehd->bhd", x, wk).float()
        v_new = torch.einsum("be,ehd->bhd", x, wv).float()

        ps = a["page_size"]
        k_cache = ctx.state_in[f"{self.name}/k_cache"]
        v_cache = ctx.state_in[f"{self.name}/v_cache"]
        # scatter the fresh token at position seq_lens[b]: pool page
        # page_table[b, seq_lens[b] // ps], slot seq_lens[b] % ps.  Every
        # frame row scatters; the executor points a row it wants ignored
        # at a page no live sequence owns.
        slot = (seq_lens % ps).long()
        # a full sequence must be evicted before it is stepped again; the
        # clamp keeps the gather in bounds, as the reference's does
        page_idx = torch.clamp(seq_lens // ps, max=a["pages_per_seq"] - 1)
        page = torch.gather(page_table, 1,
                            page_idx[:, None].long())[:, 0].long()
        k_cache.index_put_((page, slot), k_new.to(k_cache.dtype))
        v_cache.index_put_((page, slot), v_new.to(v_cache.dtype))
        ctx.state_out[f"{self.name}/k_cache"] = k_cache
        ctx.state_out[f"{self.name}/v_cache"] = v_cache

        scale = 1.0 / math.sqrt(self.head_dim)
        lens = seq_lens + 1  # the fresh token attends to itself too
        attend = (ragged_paged_attention if a["use_kernel"]
                  else ragged_paged_attention_reference)
        out = attend(q.float().contiguous(), k_cache, v_cache, page_table,
                     lens, scale)
        y = torch.einsum("bhd,hde->be", out.to(cd), wo).float()
        return [y[:, None, :].to(hidden.dtype)]
