"""The port of flexflow_tpu/models/dlrm.py, op names equal to the
reference's (a params dict carries across). DLRM (reference:
examples/cpp/DLRM/dlrm.cc:27-736): sparse embedding tables +
bottom/top MLPs + pairwise feature interaction. The embedding tables
are the parameter-parallel workhorse — the search shards them over
vocab (partial-sum gather) or channel (reference:
embedding.cc:123-190)."""

from __future__ import annotations

from typing import List, Sequence

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.model import FFModel


def build_dlrm(
    config: FFConfig,
    embedding_sizes: Sequence[int] = (1000000,) * 8,
    embedding_dim: int = 64,
    indices_per_table: int = 1,
    dense_dim: int = 13,
    bot_mlp: Sequence[int] = (512, 256, 64),
    top_mlp: Sequence[int] = (512, 256, 1),
):
    """reference: dlrm.cc:27-44 (default sparse-feature config)."""
    model = FFModel(config)
    b = config.batch_size

    dense_in = model.create_tensor([b, dense_dim], name="dense_features")
    t = dense_in
    for i, h in enumerate(bot_mlp):
        t = model.dense(t, h, activation="relu", name=f"bot_mlp_{i}")
    bottom = t  # [B, embedding_dim]

    sparse_outs: List = []
    for i, vocab in enumerate(embedding_sizes):
        ids = model.create_tensor([b, indices_per_table], dtype="int32",
                                  name=f"sparse_{i}")
        e = model.embedding(ids, vocab, embedding_dim, aggr="sum",
                            name=f"embed_{i}")
        sparse_outs.append(e)

    # feature interaction: concat (reference dlrm.cc interact_features
    # "cat" mode)
    t = model.concat([bottom] + sparse_outs, axis=1, name="interact")
    for i, h in enumerate(top_mlp[:-1]):
        t = model.dense(t, h, activation="relu", name=f"top_mlp_{i}")
    t = model.dense(t, top_mlp[-1], activation="sigmoid", name="top_out")
    return model
