"""DecodeAttentionOp — the port of flexflow_tpu/ops/decode_attention.py
(``forward`` and ``forward_chunk``, fp32, bf16 and int8 pools).

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
dtype, the cache and the softmax in fp32 (a bf16 pool stores the cast;
an int8 pool stores each fresh token quantized, ``_quantize_kv``, with
one fp32 scale per (page, slot) for k and for v), the output projection
accumulated and kept in fp32 (``matmul_acc32``).

``forward_chunk`` is the chunked-prefill twin (runtime/prefill.py): C
prompt tokens per sequence in one pass, scattered into the pool, each
attending to the cached prefix plus the chunk's causal triangle over
the gathered dense K/V (plain torch ops, as the reference leaves that
attention to XLA).

Where the port departs from JAX: the KV pool (and an int8 pool's
scales) is updated IN PLACE (``index_put_``) instead of by the
functional ``.at[].set`` — the pool is the largest tensor of the model,
and a copy per layer per frame would double the step's memory traffic.
``state_out`` still publishes the (same) tensors under their keys.

``propagate``, ``state_shardings`` and the cost hooks are the
reference's (decode_attention.py:200-216, 395-527).  On a rank's shards
(``forward_sharded``; the chunk pass's ``forward_chunk`` reads the same
axes):

* **Head split** (the view's replica slot, decode TP): the rank holds
  its heads' blocks of wq/wk/wv/wo and of both pools ([P, page_size,
  H/r, D]) and runs the decode kernel on [B, H/r]; its output
  projection is a partial sum over the head axes, which the lowering
  sums in fp32 where a consumer needs it whole (the MHA's rule).  An
  int8 pool's per-token scale is the amax over ALL heads, as the
  reference's (one scale row, replicated over the head split): each
  rank all-gathers its heads' amax over the head axes and takes the
  max before it quantizes, so every rank writes the reference's scale
  and payload.
* **Batch split** (slot 0, sequence slots): the rank holds its slots'
  rows.  When the pool's pages follow the slots (``num_pages ==
  max_seqs * pages_per_seq``: the executor's slot-aligned allotment
  gives slot i pages [i*pps, (i+1)*pps)), the rank holds the
  contiguous page range [j*P/b, (j+1)*P/b) of its batch coordinate j,
  1/b of the pool, and translates the page table's global ids into it;
  every page its rows read or write lies there.  A free-list allotment
  (prefix sharing, or a pool of another size: decode.py's
  ``slot_aligned`` is false) can give a sequence pages of another
  rank's range, so there the pool is WHOLE on every rank of the batch
  group (a pool of another size from the start; a split one gathered
  once, by ``CompiledModel.whole_page_pools``, when
  ``compiled_decode_step(slot_aligned=False)`` builds the step): each
  rank all-gathers the frame's fresh K/V rows (and their page and
  slot) over the batch axes and writes every row, so every copy of the
  pool holds the same bytes, and its rows attend with global page ids.
  The memory cost is b times the sharded pool per rank (and, for a
  gathered pool, the model's split one beside it), plus one all-gather
  of [B, H/r, D] fp32 K and V per layer per frame.
* The chunk pass (runtime/prefill.py) runs its one sequence's rows on
  every rank of the batch group.  On a sharded pool only the rank
  that holds the sequence's pages writes them (the others write the
  pool's own values back) and computes its attention; the others'
  rows are zeroed and one all-reduce over the batch axes hands every
  rank the holder's output.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import DataType, ParallelTensorShape
from flexflow_tpu_torch.initializers import DEFAULT_WEIGHT_INIT, Initializer
from flexflow_tpu_torch.kernels.ragged_paged_attention import (
    NEG_INF,
    gather_kv_pages,
    gather_kv_pages_quant,
    ragged_paged_attention,
    ragged_paged_attention_quant,
    ragged_paged_attention_quant_reference,
    ragged_paged_attention_reference,
)
from flexflow_tpu_torch.ops.base import (
    REPLICA_SLOT,
    LoweringContext,
    Operator,
    OpSharding,
    ShardAnnot,
    WeightSpec,
    register_op,
)
from flexflow_tpu_torch.ops.linear import matmul_acc32
from flexflow_tpu_torch.parallel.mesh import all_gather, all_reduce_sum

_POOL_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
                "int8": torch.int8}


def _quantize_kv(x, amax=None):
    """Per-token symmetric int8 quantization of fresh K or V rows:
    x [..., H, D] fp32 -> (int8 payload, fp32 scale over the trailing
    (H, D) axes): amax / 127 with a 1e-30 floor, ``torch.round``
    (half to even, as ``jnp.round``), clipped to +-127.  ``amax``
    overrides the rows' own (the max over every head under a head
    split)."""
    if amax is None:
        amax = x.abs().amax(dim=(-2, -1))
    s = amax.clamp_min(1e-30) / 127.0
    q = torch.clamp(torch.round(x / s[..., None, None]), -127, 127)
    return q.to(torch.int8), s.float()


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
    # use_kernel selects the execution path, not the math: one probe
    # record serves both
    _CALIBRATION_INERT_ATTRS = frozenset({"use_kernel"})

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
            raise ValueError(f"kv_dtype must be one of "
                             f"{sorted(_POOL_DTYPES)}, got {kv_dtype!r}")
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

    @property
    def max_seqs(self) -> int:
        return self.input_shapes[0].sizes[0]

    @property
    def max_seq_len(self) -> int:
        return self.attrs["page_size"] * self.attrs["pages_per_seq"]

    def state_shardings(self, mv: MachineView):
        """ShardAnnot per state var under ``mv`` (reference
        decode_attention.py:200-216): the page dim over the batch axes,
        the head dim over the replica axes; an int8 pool's scales split
        with the page dim and replicate over the head split."""
        b = max(mv.dim_degrees[0], 1) if mv.dim_degrees else 1
        r = max(mv.replica_degree, 1)
        annot = ShardAnnot((b, 1, r, 1), idx=(0, -1, REPLICA_SLOT, -1))
        out = {"k_cache": annot, "v_cache": annot}
        if self.kv_dtype == "int8":
            s_annot = ShardAnnot((b, 1), replica=r, idx=(0, -1))
            out["k_scale"] = s_annot
            out["v_scale"] = s_annot
        return out

    def pages_follow_slots(self) -> bool:
        """Whether the executor's slot-aligned allotment can serve this
        pool (slot i owns pages [i*pps, (i+1)*pps)), so that a batch
        split's ranks each hold their slots' page range."""
        return (self.attrs["num_pages"]
                == self.max_seqs * self.attrs["pages_per_seq"])

    def propagate(self, mv: MachineView) -> OpSharding:
        b, s, e_deg = mv.dim_degrees
        assert s == 1, "decode token dim is length 1 — unsplittable"
        assert e_deg == 1, "embed dim of attention output stays whole"
        assert self.max_seqs % max(b, 1) == 0, (
            "sequence slots must divide evenly over the batch degree")
        r = mv.replica_degree  # head split -> partial sums over wo
        h_annot = ShardAnnot((b, 1, 1), replica=r)
        pt_annot = ShardAnnot((b, 1), replica=r)
        sl_annot = ShardAnnot((b,), replica=r)
        out = ShardAnnot(mv.dim_degrees, replica=r, partial=r > 1)
        R = REPLICA_SLOT
        head_w = ShardAnnot((1, r, 1), replica=b, idx=(-1, R, -1))
        ws = (
            head_w, head_w, head_w,
            ShardAnnot((r, 1, 1), replica=b, idx=(R, -1, -1)),  # wo
        )
        return OpSharding(inputs=(h_annot, pt_annot, sl_annot),
                          weights=ws, outputs=(out,))

    def splittable_output_dims(self):
        return (0,)  # sequence slots; the token dim is length 1

    def max_replica_degree(self) -> int:
        return self.attrs["num_heads"]

    # ---- cost hooks (reference ops/decode_attention.py:420-527) -------
    def flops(self) -> float:
        a = self.attrs
        bsz = self.max_seqs
        e, h, dk = a["embed_dim"], a["num_heads"], self.head_dim
        proj = 2.0 * bsz * e * h * dk * 4  # q, k, v, o projections
        attn = 2.0 * bsz * h * self.max_seq_len * dk * 2
        return proj + attn

    # KV quantize-overhead pricing (the EQuARX discipline the cost
    # model's wire-precision terms follow, machine_model.QUANT_PASSES):
    # writing a quantized token costs streaming passes over the
    # per-step fp32 token buffer (read the projections, round, write
    # payload + scales).  The READ side's dequant runs in-register on
    # bytes already streamed — its price IS the smaller stream, so no
    # extra read pass is charged.
    KV_QUANT_PASSES = 3.0

    def _kv_payload_bytes_per_token(self) -> float:
        """K + V PAYLOAD bytes per cached token in the pool dtype
        (scales excluded — they shard differently)."""
        itemsize = {"fp32": 4.0, "bf16": 2.0, "int8": 1.0}[self.kv_dtype]
        return 2.0 * self.attrs["num_heads"] * self.head_dim * itemsize

    def _kv_scale_bytes_per_token(self) -> float:
        """The int8 pool's per-(page, slot) fp32 k/v scales: 8 bytes
        per cached token, replicated over a head split."""
        return 8.0 if self.kv_dtype == "int8" else 0.0

    def kv_bytes_per_token(self) -> float:
        """K + V bytes one cached token occupies across all heads, in
        the POOL dtype (int8 includes its two fp32 scales)."""
        return (self._kv_payload_bytes_per_token()
                + self._kv_scale_bytes_per_token())

    def kv_cache_bytes(self, mv: MachineView, serving=None) -> float:
        """Per-device resident bytes of this layer's page pool under
        ``mv`` — the KV-residency term of the simulator's HBM check.
        Batch degree shards sequences (each device holds its sequences'
        pages — realized by the executor's slot-aligned allocation),
        the replica degree shards heads; both divide the payload, while
        an int8 pool's scales divide only by batch (each replica needs
        every token's scale).  When the serving arrival model declares
        an expected shared prefix (``ServingSpec.shared_prefix_pages``
        — realized by the executor's radix prefix sharing), residency
        is the SHARED total: the common-prefix pages exist once, not
        once per sequence."""
        tokens = self.attrs["num_pages"] * self.attrs["page_size"]
        b = max(mv.dim_degrees[0], 1) if mv.dim_degrees else 1
        r = max(mv.replica_degree, 1)
        per_dev = (tokens * self._kv_payload_bytes_per_token() / (b * r)
                   + tokens * self._kv_scale_bytes_per_token() / b)
        if serving is not None:
            factor = getattr(serving, "shared_residency_factor", None)
            if factor is not None:
                per_dev *= factor()
        return per_dev

    def bytes_accessed(self) -> float:
        # activations + weights + the full-occupancy cache read (the
        # decode-dominant term: attention streams every live KV byte)
        base = super().bytes_accessed()
        return base + (self.max_seqs * self.max_seq_len
                       * self.kv_bytes_per_token())

    def sharded_bytes_accessed(self, mv: MachineView,
                               serving=None) -> float:
        """Per-shard bytes under ``mv`` — the decode op's replacement
        for the cost model's uniform ``bytes_accessed() / parts`` rule:
        a head split divides the KV stream like a batch split does (each
        device reads only its own heads' columns), and under a serving
        arrival model the cache read scales with the RAGGED p99 shard
        load instead of full occupancy (search/serving.py
        ``load_factor`` — the currency the serve objective ranks in)."""
        b = max(mv.dim_degrees[0], 1) if mv.dim_degrees else 1
        r = max(mv.replica_degree, 1)
        # activations shard with the sequence slots; the projection
        # weights shard with the HEADS (a batch split replicates them —
        # every device streams the full wq..wo, the head split's real
        # second win beside the balanced cache read)
        act = sum(s.num_bytes for s in self.input_shapes)
        act += sum(s.num_bytes for s in self.output_shapes)
        wbytes = 0.0
        for ws in self._weight_specs:
            n = 1
            for d in ws.shape:
                n *= d
            wbytes += n * ws.dtype.itemsize
        live = self.max_seqs * self.max_seq_len
        # attention streams each sequence's OWN pages (a prefix shared
        # in residency is still read once per attending sequence), so
        # the stream term never takes the shared-residency discount —
        # the pool DTYPE is what shrinks it
        kv = live * self._kv_payload_bytes_per_token() / (b * r)
        # each replica streams every one of its sequences' scales
        kv += live * self._kv_scale_bytes_per_token() / b
        if serving is not None:
            kv *= serving.load_factor(b)
        quant = 0.0
        if self.kv_dtype != "fp32":
            # quantize overhead on the write path (KV_QUANT_PASSES,
            # class comment): per step each slot collapses one fp32
            # K + V token to the pool dtype
            tok_fp32 = (self.max_seqs * 2.0 * self.attrs["num_heads"]
                        * self.head_dim * 4.0)
            quant = self.KV_QUANT_PASSES * tok_fp32 / (b * r)
        return act / b + wbytes / r + kv + quant

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
        """The layer's page-pool cache: (name, shape, torch dtype, fill);
        an int8 pool adds per-(page, slot) fp32 k/v scales."""
        a = self.attrs
        shape = (a["num_pages"], a["page_size"], a["num_heads"],
                 self.head_dim)
        dt = _POOL_DTYPES[self.kv_dtype]
        specs = [("k_cache", shape, dt, 0), ("v_cache", shape, dt, 0)]
        if self.kv_dtype == "int8":
            sshape = (a["num_pages"], a["page_size"])
            specs += [("k_scale", sshape, torch.float32, 0.0),
                      ("v_scale", sshape, torch.float32, 0.0)]
        return specs

    def _pools(self, ctx):
        """This rank's state tensors of the layer, by name."""
        return {n: ctx.state_in[f"{self.name}/{n}"]
                for n, *_ in self.state_specs()}

    def _page_base(self, ctx, pools, bax):
        """The first global page id of this rank's pool block, or None
        when the rank holds the whole page dim."""
        held = pools["k_cache"].shape[0]
        if not bax or held == self.attrs["num_pages"]:
            return None
        return ctx.mesh.index(bax) * held

    def _scatter(self, ctx, pools, page, slot, k_new, v_new, hax=(),
                 keep=None):
        """Write fresh fp32 k/v rows [B, ..., H, D] at pool (page, slot)
        in place (quantized under an int8 pool, with the amax over the
        head axes ``hax``) and publish the state.  Rows where the bool
        [B] ``keep`` is False write the pool's own values back."""
        idx = (page.long(), slot.long())

        def put(pool, val):
            if keep is not None:
                k = keep.reshape((-1,) + (1,) * (val.dim() - 1))
                val = torch.where(k, val, pool[idx])
            pool.index_put_(idx, val)

        if self.kv_dtype == "int8":
            # k's and v's amax in one gather over the head axes
            amax = torch.stack([k_new.abs().amax(dim=(-2, -1)),
                                v_new.abs().amax(dim=(-2, -1))])
            if hax:
                amax = all_gather(amax[None], 0, hax, ctx.mesh).amax(0)
        for i, (kind, new) in enumerate((("k", k_new), ("v", v_new))):
            if self.kv_dtype == "int8":
                payload, s = _quantize_kv(new, amax[i])
                put(pools[f"{kind}_cache"], payload)
                put(pools[f"{kind}_scale"], s)
            else:
                cache = pools[f"{kind}_cache"]
                put(cache, new.to(cache.dtype))
        for n, t in pools.items():
            ctx.state_out[f"{self.name}/{n}"] = t

    def _project_kv(self, x, weights, cd):
        """q in the compute dtype, fresh k/v in fp32: x [..., E]."""
        wq, wk, wv = (weights[n].to(cd) for n in ("wq", "wk", "wv"))
        q = torch.einsum("...e,ehd->...hd", x, wq)
        k_new = torch.einsum("...e,ehd->...hd", x, wk).float()
        v_new = torch.einsum("...e,ehd->...hd", x, wv).float()
        return q, k_new, v_new

    def _out_proj(self, out, weights, cd):
        """[..., H, D] -> fp32 [..., E] through wo, accumulated and kept
        in fp32 (the reference's preferred_element_type=float32)."""
        wo = weights["wo"].to(cd)
        return matmul_acc32(out.to(cd).flatten(-2),
                            wo.reshape(-1, wo.shape[-1]))

    def forward(self, ctx: LoweringContext, inputs, weights):
        return self._frame(ctx, inputs, weights, (), ())

    def forward_sharded(self, ctx: LoweringContext, inputs, weights, osh):
        """The frame on this rank's rows and heads (module docstring)."""
        return self._frame(ctx, inputs, weights, ctx.axes(0),
                           ctx.axes(REPLICA_SLOT))

    def _frame(self, ctx, inputs, weights, bax, hax):
        """One decode frame over the batch axes ``bax`` and the head
        axes ``hax`` (both empty on one device)."""
        a = self.attrs
        hidden, page_table, seq_lens = inputs
        page_table = page_table.to(torch.int32)
        seq_lens = seq_lens.to(torch.int32)
        cd = ctx.compute_dtype
        q, k_new, v_new = self._project_kv(hidden[:, 0, :].to(cd), weights,
                                           cd)
        ps = a["page_size"]
        # scatter the fresh token at position seq_lens[b]: pool page
        # page_table[b, seq_lens[b] // ps], slot seq_lens[b] % ps.  Every
        # frame row scatters; the executor points a row it wants ignored
        # at a page no live sequence owns.
        slot = seq_lens % ps
        # a full sequence must be evicted before it is stepped again; the
        # clamp keeps the gather in bounds, as the reference's does
        page_idx = torch.clamp(seq_lens // ps, max=a["pages_per_seq"] - 1)
        page = torch.gather(page_table, 1, page_idx[:, None].long())[:, 0]
        pools = self._pools(ctx)
        base = self._page_base(ctx, pools, bax)
        if base is not None:
            # this rank's slots own its page range (slot-aligned)
            page_table = page_table - base
            self._scatter(ctx, pools, page - base, slot, k_new, v_new, hax)
        elif bax:
            # a whole pool under a batch split: every row on every rank
            rows = [all_gather(t, 0, bax, ctx.mesh)
                    for t in (page, slot, k_new, v_new)]
            self._scatter(ctx, pools, *rows, hax)
        else:
            self._scatter(ctx, pools, page, slot, k_new, v_new, hax)

        scale = 1.0 / math.sqrt(self.head_dim)
        lens = seq_lens + 1  # the fresh token attends to itself too
        qf = q.float().contiguous()
        kv = (pools["k_cache"], pools["v_cache"])
        if self.kv_dtype == "int8":
            attend = (ragged_paged_attention_quant if a["use_kernel"]
                      else ragged_paged_attention_quant_reference)
            kv += (pools["k_scale"], pools["v_scale"])
        else:
            attend = (ragged_paged_attention if a["use_kernel"]
                      else ragged_paged_attention_reference)
        out = attend(qf, *kv, page_table.contiguous(), lens, scale)
        y = self._out_proj(out, weights, cd)
        return [y[:, None, :].to(hidden.dtype)]

    def forward_chunk(self, ctx: LoweringContext, inputs, weights):
        """The chunked-prefill twin of ``forward``: hidden [B, C, E],
        page_table [B, pages_per_seq], positions [B, C] int32 (each
        token's absolute cache position; the caller clamps pad positions
        into the sequence's own allotment, where the decode loop
        rewrites them before any frame reads them).  Scatters all C
        tokens' K/V into the pool in place and attends each query to
        every cached position <= its own -> [B, C, E].  Under a
        strategy the rows are whole on every rank and the heads are the
        rank's (module docstring)."""
        a = self.attrs
        hidden, page_table, positions = inputs
        page_table = page_table.to(torch.int32)
        positions = positions.to(torch.int32)
        cd = ctx.compute_dtype
        bax, hax = ctx.axes(0), ctx.axes(REPLICA_SLOT)
        q, k_new, v_new = self._project_kv(hidden.to(cd), weights, cd)
        ps = a["page_size"]
        slot = positions % ps  # [B, C]
        page_idx = torch.clamp(positions // ps, max=a["pages_per_seq"] - 1)
        page = torch.gather(page_table, 1, page_idx.long())  # [B, C]
        pools = self._pools(ctx)
        base = self._page_base(ctx, pools, bax)
        held = None
        if base is not None:
            # only the rank holding the sequence's pages writes them
            n = pools["k_cache"].shape[0]
            first = page_table[:, 0] - base
            held = (first >= 0) & (first < n)
            page = (page - base).clamp(0, n - 1)
            page_table = (page_table - base).clamp(0, n - 1)
        self._scatter(ctx, pools, page, slot, k_new, v_new, hax, keep=held)

        if self.kv_dtype == "int8":
            k_dense = gather_kv_pages_quant(pools["k_cache"],
                                            pools["k_scale"], page_table)
            v_dense = gather_kv_pages_quant(pools["v_cache"],
                                            pools["v_scale"], page_table)
        else:
            k_dense = gather_kv_pages(pools["k_cache"], page_table).float()
            v_dense = gather_kv_pages(pools["v_cache"], page_table).float()
        scale = 1.0 / math.sqrt(self.head_dim)
        s = torch.einsum("bchd,bshd->bchs", q.float(), k_dense) * scale
        pos_k = torch.arange(k_dense.shape[1], device=s.device)
        mask = pos_k[None, None, :] <= positions[:, :, None]  # [B, C, S]
        s = torch.where(mask[:, :, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bchs,bshd->bchd", p, v_dense)
        if held is not None:
            # the holder's rows, exactly, on every rank of the group
            out = all_reduce_sum(
                torch.where(held[:, None, None, None], out,
                            torch.zeros_like(out)), bax, ctx.mesh)
        return [self._out_proj(out, weights, cd).to(hidden.dtype)]
