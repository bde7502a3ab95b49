"""Training metrics — the port of flexflow_tpu/metrics.py.

``compute_metrics`` returns per-batch sums as 0-dim tensors on the
model's device (no host sync); ``PerfMetrics`` folds them on the host.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from flexflow_tpu_torch.losses import LossType, sparse_targets


class MetricsType(enum.Enum):
    ACCURACY = "accuracy"
    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
    MEAN_SQUARED_ERROR = "mean_squared_error"
    ROOT_MEAN_SQUARED_ERROR = "root_mean_squared_error"
    MEAN_ABSOLUTE_ERROR = "mean_absolute_error"

    @staticmethod
    def from_any(x) -> "MetricsType":
        return x if isinstance(x, MetricsType) else MetricsType(x)


@torch.no_grad()
def compute_metrics(metric_types: List[MetricsType], loss_type,
                    logits: torch.Tensor,
                    labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-batch metric sums; keys mirror ``PerfMetrics`` fields."""
    loss_type = LossType.from_any(loss_type)
    out: Dict[str, torch.Tensor] = {}
    n = logits.shape[0]
    out["train_all"] = torch.tensor(float(n), device=logits.device)
    logits32 = logits.float()
    labels32 = labels.float()
    for m in metric_types:
        m = MetricsType.from_any(m)
        if m is MetricsType.ACCURACY:
            pred = logits32.argmax(dim=-1)
            if loss_type is LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
                tgt, per_pos = sparse_targets(labels, logits)
                correct = (pred == tgt).float()
                if per_pos:
                    # each sample credited its fraction of correct tokens
                    out["train_correct"] = correct.reshape(n, -1).mean(
                        dim=-1).sum()
                else:
                    out["train_correct"] = correct.sum()
            else:
                tgt = labels32.argmax(dim=-1)
                out["train_correct"] = (pred == tgt).float().sum()
        elif m is MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY:
            tgt, per_pos = sparse_targets(labels, logits)
            logp = torch.log_softmax(logits32, dim=-1)
            nll = -torch.gather(logp, -1, tgt[..., None])
            if per_pos:
                out["sparse_cce_loss"] = nll.reshape(n, -1).mean(
                    dim=-1).sum()
            else:
                out["sparse_cce_loss"] = nll.sum()
        elif m is MetricsType.CATEGORICAL_CROSSENTROPY:
            logp = torch.log_softmax(logits32, dim=-1)
            out["cce_loss"] = -(labels32 * logp).sum()
        elif m is MetricsType.MEAN_SQUARED_ERROR:
            d = logits32 - labels32.reshape(logits32.shape)
            out["mse_loss"] = (d * d).sum() / max(1, labels32.numel() // n)
        elif m is MetricsType.ROOT_MEAN_SQUARED_ERROR:
            d = logits32 - labels32.reshape(logits32.shape)
            out["rmse_loss"] = torch.sqrt(
                (d * d).mean(dim=tuple(range(1, d.dim())))).sum()
        elif m is MetricsType.MEAN_ABSOLUTE_ERROR:
            d = (logits32 - labels32.reshape(logits32.shape)).abs()
            out["mae_loss"] = d.mean(dim=tuple(range(1, d.dim()))).sum()
    return out


@dataclass
class PerfMetrics:
    """Host-side accumulator across iterations."""

    sums: Dict[str, float] = field(default_factory=dict)

    def update(self, batch_metrics: Dict[str, torch.Tensor]) -> None:
        for k, v in batch_metrics.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v)

    def reset(self) -> None:
        self.sums.clear()

    def report(self) -> Dict[str, float]:
        n = max(self.sums.get("train_all", 0.0), 1.0)
        rep = {}
        if "train_correct" in self.sums:
            rep["accuracy"] = self.sums["train_correct"] / n
        for key, name in [
            ("sparse_cce_loss", "sparse_categorical_crossentropy"),
            ("cce_loss", "categorical_crossentropy"),
            ("mse_loss", "mean_squared_error"),
            ("rmse_loss", "root_mean_squared_error"),
            ("mae_loss", "mean_absolute_error"),
        ]:
            if key in self.sums:
                rep[name] = self.sums[key] / n
        rep["samples"] = n
        return rep

    def __str__(self) -> str:
        rep = self.report()
        parts = [f"{k}: {v:.4f}" for k, v in rep.items() if k != "samples"]
        return f"[samples={int(rep.get('samples', 0))}] " + " ".join(parts)
