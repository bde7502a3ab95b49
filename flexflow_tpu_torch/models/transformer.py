"""Transformer encoder, BERT and GPT — the port of ``encoder_layer``,
``build_transformer``, ``build_bert``, ``build_gpt`` and
``build_gpt_xl`` in flexflow_tpu/models/transformer.py.  Op names equal the reference's, so
a ``params[op][weight]`` dict carries across the two packages.
``build_bert`` at its defaults is the OSDI'22 BERT benchmark model
(BERT-base widths: vocab 30522, 12 layers, hidden 768, 12 heads, ff
3072, seq 512, attention dropout 0.1; batch 8 in that benchmark)."""

from __future__ import annotations

import numpy as np

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.model import FFModel


def encoder_layer(model, t, hidden, num_heads, ff_dim, name, dropout=0.1,
                  layer_norm=True, causal=False, sp_mode="ring"):
    """Multi-head attention + residual (+ LN) + ReLU FFN + residual
    (+ LN): post-LN, as the reference's."""
    a = model.multihead_attention(
        t, t, t, embed_dim=hidden, num_heads=num_heads, dropout=dropout,
        causal=causal, sp_mode=sp_mode, name=f"{name}_mha")
    t = model.add(a, t, name=f"{name}_res1")
    if layer_norm:
        t = model.layer_norm(t, name=f"{name}_ln1")
    f = model.dense(t, ff_dim, activation="relu", name=f"{name}_ff1")
    f = model.dense(f, hidden, name=f"{name}_ff2")
    t = model.add(f, t, name=f"{name}_res2")
    if layer_norm:
        t = model.layer_norm(t, name=f"{name}_ln2")
    return t


def build_transformer(config: FFConfig, num_layers: int = 12,
                      hidden: int = 512, num_heads: int = 8,
                      ff_dim: int = 2048, seq_len: int = 512,
                      dropout: float = 0.0, layer_norm: bool = False,
                      causal: bool = False, dtype: str = "float32",
                      sp_mode: str = "ring") -> FFModel:
    """The reference Transformer example: raw float inputs [B, S, H]
    through the encoder stack and a per-position dense head back to
    hidden.  ``dtype`` sets the activation stream's dtype."""
    model = FFModel(config)
    b = config.batch_size
    t = model.create_tensor([b, seq_len, hidden], dtype=dtype, name="tokens")
    for i in range(num_layers):
        t = encoder_layer(model, t, hidden, num_heads, ff_dim, f"layer{i}",
                          dropout=dropout, layer_norm=layer_norm,
                          causal=causal, sp_mode=sp_mode)
    model.dense(t, hidden, name="head")
    return model


def build_bert(config: FFConfig, vocab: int = 30522, num_layers: int = 12,
               hidden: int = 768, num_heads: int = 12, ff_dim: int = 3072,
               seq_len: int = 512, num_classes: int = 2,
               dropout: float = 0.1) -> FFModel:
    """BERT-base-style classifier: token embedding + LN, the encoder
    stack with attention dropout, a mean-pool over the sequence, a tanh
    pooler and the classification head.  Input: ``input_ids`` [B,
    seq_len] int32; labels [B] class ids."""
    model = FFModel(config)
    b = config.batch_size
    ids = model.create_tensor([b, seq_len], dtype="int32", name="input_ids")
    t = model.embedding(ids, vocab, hidden, aggr="none", name="tok_embed")
    t = model.layer_norm(t, name="embed_ln")
    for i in range(num_layers):
        t = encoder_layer(model, t, hidden, num_heads, ff_dim, f"layer{i}",
                          dropout=dropout, layer_norm=True)
    t = model.mean(t, dims=[1], name="pool")
    t = model.dense(t, hidden, activation="tanh", name="pooler")
    model.dense(t, num_classes, name="classifier")
    return model


def build_gpt(config: FFConfig, vocab: int = 32000, num_layers: int = 12,
              hidden: int = 768, num_heads: int = 12, ff_dim: int = 3072,
              seq_len: int = 1024, dropout: float = 0.0) -> FFModel:
    """GPT-style causal language model: token + learned positional
    embeddings, post-LN causal encoder stack, untied vocab head; trains
    with per-token sparse CCE on shifted targets.  Input: ``input_ids``
    [B, seq_len] int32."""
    model = FFModel(config)
    b = config.batch_size
    ids = model.create_tensor([b, seq_len], dtype="int32", name="input_ids")
    t = model.embedding(ids, vocab, hidden, aggr="none", name="tok_embed")
    pos = model.create_constant(
        np.arange(seq_len, dtype=np.int32)[None, :].repeat(b, axis=0),
        name="positions")
    p = model.embedding(pos, seq_len, hidden, aggr="none", name="pos_embed")
    t = model.add(t, p, name="embed_sum")
    for i in range(num_layers):
        t = encoder_layer(model, t, hidden, num_heads, ff_dim, f"layer{i}",
                          dropout=dropout, layer_norm=True, causal=True)
    t = model.layer_norm(t, name="final_ln")
    model.dense(t, vocab, use_bias=False, name="lm_head")
    return model


# the production-scale config (about 1015 graph nodes at 144 layers x
# about 7 nodes per layer), reference transformer.py:111-124: the
# thousand-node stacked LLM graph the segment-reuse search solves
GPT_XL_KW = dict(vocab=32000, num_layers=144, hidden=512, num_heads=8,
                 ff_dim=2048, seq_len=256)


def build_gpt_xl(config: FFConfig, **overrides):
    """``build_gpt`` at production depth (``GPT_XL_KW``, >= 1000
    nodes), one canonical xl config for the scale search."""
    kw = dict(GPT_XL_KW)
    kw.update(overrides)
    return build_gpt(config, **kw)
