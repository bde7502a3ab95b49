"""The port of flexflow_tpu/models/xdl.py, op names equal to the
reference's (a params dict carries across). XDL ads-ranking model
(reference: examples/cpp/XDL/xdl.cc:1-438): many small embedding
tables + deep MLP over concatenated features."""

from __future__ import annotations

from typing import Sequence

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.model import FFModel


def build_xdl(
    config: FFConfig,
    num_tables: int = 16,
    vocab: int = 100000,
    embedding_dim: int = 16,
    mlp: Sequence[int] = (256, 128, 1),
):
    model = FFModel(config)
    b = config.batch_size
    embeds = []
    for i in range(num_tables):
        ids = model.create_tensor([b, 1], dtype="int32", name=f"sparse_{i}")
        embeds.append(
            model.embedding(ids, vocab, embedding_dim, aggr="sum", name=f"embed_{i}")
        )
    t = model.concat(embeds, axis=1, name="concat")
    for i, h in enumerate(mlp[:-1]):
        t = model.dense(t, h, activation="relu", name=f"mlp_{i}")
    t = model.dense(t, mlp[-1], activation="sigmoid", name="out")
    return model
