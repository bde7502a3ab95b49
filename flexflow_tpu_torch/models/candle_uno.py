"""The port of flexflow_tpu/models/candle_uno.py, op names equal to the
reference's (a params dict carries across). CANDLE-Uno drug-response
model (reference: examples/cpp/candle_uno/candle_uno.cc:1-453):
several input feature towers, each its own MLP, concatenated into a
deep head — the OSDI'22 hybrid-parallel showcase (independent towers
place on disjoint devices)."""

from __future__ import annotations

from typing import Dict, Sequence

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.model import FFModel


def build_candle_uno(
    config: FFConfig,
    feature_shapes: Dict[str, int] = None,
    input_features: Sequence[str] = None,
    dense_layers: Sequence[int] = (1000,) * 3,
    dense_feature_layers: Sequence[int] = (1000,) * 3,
):
    """reference: candle_uno.cc:27-60 default config — towers for
    dose/cell/drug features feeding a 3x1000 head."""
    feature_shapes = feature_shapes or {
        "dose": 1, "cell.rnaseq": 942, "drug.descriptors": 5270,
        "drug.fingerprints": 2048,
    }
    input_features = input_features or [
        "dose1", "dose2", "cell.rnaseq", "drug1.descriptors",
        "drug1.fingerprints", "drug2.descriptors", "drug2.fingerprints",
    ]
    model = FFModel(config)
    b = config.batch_size
    towers = []
    for feat in input_features:
        # map e.g. "drug1.descriptors" -> "drug.descriptors", "dose1" ->
        # "dose" (reference: candle_uno.cc:38-39 feature-name mapping)
        if "." in feat:
            base = feat.split(".")[-1]
            key = next((k for k in feature_shapes if k.endswith(base)), None)
        else:
            stripped = feat.rstrip("0123456789")
            key = stripped if stripped in feature_shapes else None
        assert key is not None, f"no feature shape for input {feat!r}"
        dim = feature_shapes[key]
        x = model.create_tensor([b, dim], name=f"in_{feat.replace('.', '_')}")
        t = x
        if dim > 1:  # feature towers get their own MLP (candle_uno.cc build_feature_model)
            for i, h in enumerate(dense_feature_layers):
                t = model.dense(t, h, activation="relu",
                                name=f"tower_{feat.replace('.', '_')}_{i}")
        towers.append(t)
    t = model.concat(towers, axis=1, name="concat")
    for i, h in enumerate(dense_layers):
        t = model.dense(t, h, activation="relu", name=f"head_{i}")
    t = model.dense(t, 1, name="out")
    return model
