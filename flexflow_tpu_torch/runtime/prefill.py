"""Chunked prefill — the port of flexflow_tpu/runtime/prefill.py.

The prompt path off the decode loop: the prompt's causal forward runs
once per C-token CHUNK and scatters the chunk's K/V straight into the
sequence's page-pool pages, after which the sequence joins the decode
loop at its LAST prompt token — the first generated token still comes
out of the decode graph, so the chunked lane is token-identical to
prefill through decode frames (test-enforced across ragged prompt
lengths).

The chunk pass is derived from the decode graph itself: embeddings,
dense, LayerNorm and add are position-wise, and
``DecodeAttentionOp.forward_chunk`` is the prefix + causal-chunk
attention with the batched scatter, so prefill and decode share the
decode model's parameters and KV state.  PyTorch runs eagerly, with no
jit to prune dead code, so ``build_chunk_forward`` runs only the nodes
upstream of the last decode-attention op (no final LayerNorm, no
lm_head): prefill produces state, not logits.

``prefill_weight_bridge`` proves that a separately built prefill graph
(models/decode.py ``build_gpt_prefill``) corresponds weight for weight
to the decode graph.

Positions past the prompt (the fixed-shape chunk's pad tail) are
clamped into the sequence's own allotment: a pad write lands at a
FUTURE position that the decode loop rewrites in the frame that first
reads it, so pad garbage is dead by construction.

Over ranks (``build_chunk_forward(..., compiled=)`` with a compiled
model on a mesh of several ranks) the chunk pass runs each node on this
rank's shards as the frame's lowering lays them out, except that the
chunk's rows are whole on every rank: every layout drops the axes of
its dim 0 (the decode graph's batch dim), the edges reshard between
those layouts, and each decode op writes and attends with its own
heads and its block of the pool (ops/decode_attention.py
``forward_chunk``: on a pool split over the batch axes only the rank
holding the sequence's pages writes them).  The pass runs eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.ops.base import LoweringContext
from flexflow_tpu_torch.ops.inout import InputOp
from flexflow_tpu_torch.parallel.mesh import Placement, reshard


def run_chunked_prefill(prefill_fn: Callable, tokens: Sequence[int],
                        pages: Sequence[int], *, chunk: int, cap: int,
                        start: int = 0,
                        trace_id: Optional[str] = None) -> int:
    """Drive the chunk writer over a prompt: write ``tokens[start:-1]``
    into the sequence's pages in ``ceil((len-1-start)/chunk)``
    fixed-shape passes (the decode loop then starts at the LAST token).
    Returns the number of chunk passes.

    ``start`` is the prefix-sharing skip-ahead: the first ``start``
    tokens already live in pages the admission claimed (or copied on
    divergence), so the writer begins at the first divergent token.
    Pad positions past the prompt clamp into the allotment
    (``cap - 1``).  When ``trace_id`` names a live request trace, each
    pass closes as one ``prefill.chunk`` child span under the open
    ``prefill`` span."""
    n_pre = len(tokens) - 1
    if n_pre - start <= 0:
        return 0
    tracer = None
    if trace_id is not None:
        from flexflow_tpu_torch.obs.tracing import TRACER as tracer
    table = np.asarray(pages, np.int32)[None, :]  # [1, P]
    chunks = 0
    for c0 in range(start, n_pre, chunk):
        if tracer is not None:
            tracer.begin(trace_id, "prefill.chunk", parent="prefill",
                         c0=c0)
        ids = np.zeros((1, chunk), np.int32)
        valid = min(chunk, n_pre - c0)
        ids[0, :valid] = tokens[c0:c0 + valid]
        pos = np.minimum(c0 + np.arange(chunk), cap - 1)
        prefill_fn(ids, pos[None, :].astype(np.int32), table)
        if tracer is not None:
            tracer.end(trace_id, "prefill.chunk", tokens=valid)
        chunks += 1
    return chunks


def _decode_guids(graph) -> List[int]:
    return [n.guid for n in graph.topo_order()
            if n.op.op_type == OperatorType.DECODE_ATTENTION]


def prefill_io_nodes(graph) -> Tuple[int, int, int]:
    """(token_ids, page_table, seq_lens) InputOp guids of a
    decode-family graph, found from the first decode op's own bindings
    (input 1 = page_table, input 2 = seq_lens), never by name."""
    dec = _decode_guids(graph)
    if not dec:
        raise ValueError("graph has no DecodeAttentionOp — not a "
                         "decode-family graph")
    by_idx = {e.dst_idx: e.src for e in graph.in_edges[dec[0]]}
    pt_guid, sl_guid = by_idx[1], by_idx[2]
    inputs = [n.guid for n in graph.topo_order()
              if isinstance(n.op, InputOp)]
    tok = [g for g in inputs if g not in (pt_guid, sl_guid)]
    if len(tok) != 1:
        raise ValueError(
            f"decode-family graph must have exactly 3 inputs "
            f"(token_ids, page_table, seq_lens); found {len(inputs)}")
    return tok[0], pt_guid, sl_guid


def _rowless(pl: Optional[Placement]) -> Optional[Placement]:
    """``pl`` with its dim 0 whole (the chunk pass's rows)."""
    if pl is None or not pl.dims:
        return pl
    return Placement(((),) + tuple(pl.dims[1:]), pl.partial)


def build_chunk_forward(graph, compute_dtype, device="cpu",
                        compiled=None) -> Callable:
    """A function ``(params, state, ids [B, C], positions [B, C],
    page_table [B, P]) -> new_state`` running the decode graph for a
    C-token chunk: position-wise ops run their ordinary ``forward``,
    the seq_lens -> pos_ids reshape becomes identity (positions arrive
    [B, C]), decode attention takes ``forward_chunk``.  Only the last
    decode op and the nodes upstream of it run; the pools are updated
    in place.  ``compiled``, a lowering of ``graph`` over several ranks,
    runs the pass on this rank's shards (module docstring); the arrays
    are then whole on every rank."""
    tok_guid, pt_guid, sl_guid = prefill_io_nodes(graph)
    dec_guids = _decode_guids(graph)
    needed = set()
    stack = [dec_guids[-1]]
    while stack:
        g = stack.pop()
        if g not in needed:
            needed.add(g)
            stack.extend(e.src for e in graph.in_edges[g])
    topo = [n for n in graph.topo_order() if n.guid in needed]
    for node in topo:  # fail when built, not mid-prefill
        if node.op.op_type == OperatorType.RESHAPE:
            srcs = {e.src for e in graph.in_edges[node.guid]}
            if srcs != {sl_guid}:
                raise NotImplementedError(
                    f"chunked prefill only supports the seq_lens "
                    f"pos_ids reshape; {node.op.name!r} reshapes "
                    f"something else")
    dec_set = set(dec_guids)
    mesh = (compiled.mesh if compiled is not None
            and compiled.mesh.world > 1 else None)

    @torch.no_grad()
    def fwd(params, state, ids, positions, page_table):
        ctx = LoweringContext(compute_dtype=compute_dtype, train=False,
                              state_in=state, device=device, mesh=mesh)
        bound = {tok_guid: ids, pt_guid: page_table, sl_guid: positions}
        values: Dict[Tuple[int, int], torch.Tensor] = {}
        places: Dict[Tuple[int, int], Placement] = {}
        for node in topo:
            op = node.op
            if isinstance(op, InputOp):
                x = bound[node.guid]
                if mesh is not None:
                    pl = _rowless(compiled._out_pl[node.guid][0])
                    places[(node.guid, 0)] = pl
                    x = x[pl.local_slices(x.shape, mesh)]
                values[(node.guid, 0)] = x
                continue
            edges = sorted(graph.in_edges[node.guid],
                           key=lambda e: e.dst_idx)
            ins = [values[(e.src, e.src_idx)] for e in edges]
            weights = params.get(op.name, {})
            if mesh is not None:
                ins = _on_shards(ctx, compiled, node, edges, ins, places)
            if node.guid in dec_set:
                outs = op.forward_chunk(ctx, ins, weights)
            elif op.op_type == OperatorType.RESHAPE:
                outs = [ins[0]]  # positions already [B, C]
            else:
                outs = None
                if mesh is not None:
                    outs = op.forward_sharded(
                        ctx, ins, weights, compiled._shardings[node.guid])
                if outs is None:
                    outs = op.forward(ctx, ins, weights)
            for i, y in enumerate(outs):
                values[(node.guid, i)] = y
                if mesh is not None:
                    places[(node.guid, i)] = ctx.out_placements[i]
        new_state = dict(state)
        new_state.update(ctx.state_out)
        return new_state

    return fwd


def _on_shards(ctx, compiled, node, edges, ins, places):
    """``node``'s inputs resharded to its rowless input layouts, and
    ``ctx`` set up for the node as the lowering's ``_run_node`` sets it
    (its slot axes, rowless input and output layouts)."""
    out, in_pls = [], []
    for e, x in zip(edges, ins):
        want = _rowless(compiled._in_pl[node.guid][e.dst_idx])
        src = places[(e.src, e.src_idx)]
        if want is None:
            want = src
        out.append(reshard(x, src, want, compiled.mesh))
        in_pls.append(want)
    ctx.slot_axes = compiled._slot_axes[node.guid]
    ctx.in_placements = in_pls
    ctx.out_placements = [_rowless(p) for p in compiled._out_pl[node.guid]]
    return out


def prefill_weight_bridge(prefill_graph, decode_graph) -> Dict[str, str]:
    """Prove the separately built prefill graph and the decode graph
    share ONE parameter set, weight for weight: returns
    ``{"prefill_op/w": "decode_op/w"}`` for every prefill weight, or
    raises ``ValueError`` naming the first break.  The rule is name
    correspondence under shape agreement, with one exception: the
    positional table, whose prefill rows (``seq_len``) may be a prefix
    of the decode graph's ``max_seq_len`` rows."""
    dec_ops = {n.op.name: n.op for n in decode_graph.topo_order()
               if n.op._weight_specs}
    pos_rows = {decode_graph.nodes[g].op.attrs["page_size"]
                * decode_graph.nodes[g].op.attrs["pages_per_seq"]
                for g in _decode_guids(decode_graph)}
    bridge: Dict[str, str] = {}
    for node in prefill_graph.topo_order():
        op = node.op
        if not op._weight_specs:
            continue
        twin = dec_ops.get(op.name)
        if twin is None:
            raise ValueError(
                f"prefill op {op.name!r} has no same-named decode twin "
                f"— the graphs cannot share a parameter set")
        dec_ws = {w.name: w for w in twin._weight_specs}
        for ws in op._weight_specs:
            tw = dec_ws.get(ws.name)
            if tw is None:
                raise ValueError(
                    f"prefill weight {op.name}/{ws.name} missing on the "
                    f"decode twin")
            ok = tuple(ws.shape) == tuple(tw.shape)
            if not ok and len(ws.shape) == len(tw.shape) == 2 \
                    and ws.shape[1] == tw.shape[1] \
                    and ws.shape[0] <= tw.shape[0] \
                    and tw.shape[0] in pos_rows:
                # the positional-table prefix rule: only a decode table
                # with exactly max_seq_len rows qualifies, so a vocab
                # mismatch stays an error
                ok = True
            if not ok:
                raise ValueError(
                    f"weight {op.name}/{ws.name} shape mismatch: "
                    f"prefill {tuple(ws.shape)} vs decode "
                    f"{tuple(tw.shape)}")
            bridge[f"{op.name}/{ws.name}"] = f"{twin.name}/{ws.name}"
    return bridge
