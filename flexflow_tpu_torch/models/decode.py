"""The GPT decode-frame graph — the port of ``build_gpt_decode`` in
flexflow_tpu/models/decode.py.

One decode step: token ids [B, 1] -> next-token logits [B, 1, vocab],
where B = config.batch_size is the frame's sequence-slot count.  Each
layer is paged-cache attention, residual add, LayerNorm, dense+relu,
dense, residual add, LayerNorm (post-LN, the decode twin of the
reference's ``encoder_layer``); a final LayerNorm and an untied
``lm_head`` close the stack.  Op names equal the reference's, so a
``params[op][weight]`` dict carries across the two packages.

``build_gpt_prefill`` is the prompt-phase graph (the causal GPT
forward at prompt length) and ``derive_prefill_model`` reads its
widths off an existing decode graph; ``prefill_weight_bridge``
(runtime/prefill.py) proves the two share one parameter set.  Cache
population runs through the chunked prefill lane over the decode graph
itself.
"""

from __future__ import annotations

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.model import FFModel

# the reference's canonical small decode config
GPT_DECODE_KW = dict(vocab=2048, num_layers=2, hidden=256, num_heads=8,
                     ff_dim=512, page_size=16, pages_per_seq=16)

# the reference's serving-regime decode config (long caches at modest
# width)
GPT_DECODE_SERVE_KW = dict(vocab=4096, num_layers=2, hidden=512,
                           num_heads=8, ff_dim=1024, page_size=32,
                           pages_per_seq=128)
SERVE_FRAME_SLOTS = 32  # config.batch_size the reference's serve sweep uses


def decode_layer(model, t, page_table, seq_lens, hidden, num_heads,
                 ff_dim, name, page_size, pages_per_seq, num_pages=0):
    """One decode-step transformer layer: paged-cache attention +
    residual + LN + FFN + residual + LN."""
    a = model.decode_attention(
        t, page_table, seq_lens, embed_dim=hidden, num_heads=num_heads,
        page_size=page_size, pages_per_seq=pages_per_seq,
        num_pages=num_pages, name=f"{name}_mha")
    t = model.add(a, t, name=f"{name}_res1")
    t = model.layer_norm(t, name=f"{name}_ln1")
    f = model.dense(t, ff_dim, activation="relu", name=f"{name}_ff1")
    f = model.dense(f, hidden, name=f"{name}_ff2")
    t = model.add(f, t, name=f"{name}_res2")
    return model.layer_norm(t, name=f"{name}_ln2")


def build_gpt_decode(config: FFConfig, vocab: int = 2048,
                     num_layers: int = 2, hidden: int = 256,
                     num_heads: int = 8, ff_dim: int = 512,
                     page_size: int = 16, pages_per_seq: int = 16,
                     num_pages: int = 0) -> FFModel:
    """The single-token decode-step graph.  Inputs, in binding order:
    ``token_ids`` [B, 1] i32, ``page_table`` [B, pages_per_seq] i32,
    ``seq_lens`` [B] i32.  Every layer's attention reads and writes its
    own page-pool KV cache (model state); all layers share one page-table
    geometry, so one allocator serves the whole stack."""
    model = FFModel(config)
    b = config.batch_size
    ids = model.create_tensor([b, 1], dtype="int32", name="token_ids")
    page_table = model.create_tensor([b, pages_per_seq], dtype="int32",
                                     name="page_table")
    seq_lens = model.create_tensor([b], dtype="int32", name="seq_lens")
    t = model.embedding(ids, vocab, hidden, aggr="none", name="tok_embed")
    # learned positional embedding indexed by the token's position
    # (= seq_lens)
    pos = model.reshape(seq_lens, [b, 1], name="pos_ids")
    p = model.embedding(pos, page_size * pages_per_seq, hidden,
                        aggr="none", name="pos_embed")
    t = model.add(t, p, name="embed_sum")
    for i in range(num_layers):
        t = decode_layer(model, t, page_table, seq_lens, hidden, num_heads,
                         ff_dim, f"layer{i}", page_size=page_size,
                         pages_per_seq=pages_per_seq, num_pages=num_pages)
    t = model.layer_norm(t, name="final_ln")
    model.dense(t, vocab, use_bias=False, name="lm_head")
    return model


def build_gpt_prefill(config: FFConfig, vocab: int = 2048,
                      num_layers: int = 2, hidden: int = 256,
                      num_heads: int = 8, ff_dim: int = 512,
                      seq_len: int = 256) -> FFModel:
    """The prompt-phase graph: ``build_gpt`` at prompt length."""
    from flexflow_tpu_torch.models.transformer import build_gpt

    return build_gpt(config, vocab=vocab, num_layers=num_layers,
                     hidden=hidden, num_heads=num_heads, ff_dim=ff_dim,
                     seq_len=seq_len)


def derive_prefill_model(decode_graph, config: FFConfig, seq_len: int):
    """Build the prefill twin of an existing DECODE graph by reading the
    widths off the graph (vocab/hidden from the token embedding, heads
    from the decode ops, ff width from the dense that feeds another
    dense).  Returns ``(model, prefill_config)``: the config at batch 1
    (one prompt at a time), everything else inherited."""
    import dataclasses

    from flexflow_tpu_torch.core.optype import OperatorType
    from flexflow_tpu_torch.runtime.prefill import prefill_io_nodes

    tok_guid, _, _ = prefill_io_nodes(decode_graph)
    topo = decode_graph.topo_order()
    dec_ops = [n.op for n in topo
               if n.op.op_type == OperatorType.DECODE_ATTENTION]
    tok_embed = next(
        n.op for n in topo
        if n.op.op_type == OperatorType.EMBEDDING
        and any(e.src == tok_guid for e in decode_graph.in_edges[n.guid]))
    hidden = tok_embed.attrs["out_dim"]
    # ff1 is the dense that feeds another dense directly (ff1 -> ff2);
    # ff_dim may equal vocab or hidden, so out_dim alone cannot tell
    ff_dim = hidden
    for n in topo:
        if n.op.op_type == OperatorType.LINEAR and any(
                decode_graph.nodes[e.dst].op.op_type == OperatorType.LINEAR
                for e in decode_graph.out_edges[n.guid]):
            ff_dim = n.op.attrs["out_dim"]
            break
    cfg = dataclasses.replace(config, batch_size=1)
    model = build_gpt_prefill(
        cfg, vocab=tok_embed.attrs["num_entries"], num_layers=len(dec_ops),
        hidden=hidden, num_heads=dec_ops[0].attrs["num_heads"],
        ff_dim=ff_dim, seq_len=seq_len)
    return model, cfg
