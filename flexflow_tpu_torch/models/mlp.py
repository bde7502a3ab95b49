"""The port of flexflow_tpu/models/mlp.py, op names equal to the
reference's (a params dict carries across). MLP_Unify (reference:
examples/cpp/MLP_Unify/mlp.cc:1-93): the minimal two-tower MLP used by
the Unity artifact's mlp.sh benchmark."""

from __future__ import annotations

from typing import Sequence

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.model import FFModel


def build_mlp_unify(
    config: FFConfig,
    in_dim: int = 8192,
    hidden: Sequence[int] = (8192, 8192, 8192),
    num_classes: int = 10,
):
    model = FFModel(config)
    b = config.batch_size
    x = model.create_tensor([b, in_dim], name="features")
    t = x
    for i, h in enumerate(hidden):
        t = model.dense(t, h, activation="relu", name=f"fc{i}")
    t = model.dense(t, num_classes, name="head")
    return model
