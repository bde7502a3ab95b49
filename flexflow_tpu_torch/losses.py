"""Loss functions — the port of flexflow_tpu/losses.py.

Scalar, differentiable losses on the final op's output; the gradients
come from autograd of the mean-reduced loss, as the reference's come
from ``jax.grad``.
"""

from __future__ import annotations

import enum

import torch


class LossType(enum.Enum):
    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
    MEAN_SQUARED_ERROR = "mean_squared_error"
    MEAN_SQUARED_ERROR_AVG_REDUCE = "mean_squared_error_avg_reduce"
    MEAN_SQUARED_ERROR_SUM_REDUCE = "mean_squared_error_sum_reduce"
    IDENTITY = "identity"

    @staticmethod
    def from_any(x) -> "LossType":
        if isinstance(x, LossType):
            return x
        aliases = {
            "categorical_crossentropy": LossType.CATEGORICAL_CROSSENTROPY,
            "sparse_categorical_crossentropy":
                LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
            "mean_squared_error": LossType.MEAN_SQUARED_ERROR,
            "mse": LossType.MEAN_SQUARED_ERROR,
        }
        # (the reference's aliases.get(x, LossType(x)) evaluates the
        # default first and so refuses its own "mse" alias)
        return aliases[x] if x in aliases else LossType(x)


def _match_shape(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Labels reshaped to the logits' shape for regression losses, as
    float32 — guards against [B, 1] vs [B] broadcasting to [B, B]."""
    if labels.shape != logits.shape:
        if labels.numel() != logits.numel():
            raise ValueError(f"label shape {tuple(labels.shape)} "
                             f"incompatible with output "
                             f"{tuple(logits.shape)}")
        labels = labels.reshape(logits.shape)
    return labels.float()


def sparse_targets(labels: torch.Tensor, logits: torch.Tensor):
    """(int64 targets, per_position) for the sparse-CCE family — the one
    shape rule, shared with ``metrics.compute_metrics``.  Per-position
    when the labels match all leading dims of 3D+ logits (causal LM:
    logits [B, S, V], labels [B, S] or [B, S, 1]); the first label per
    sample otherwise."""
    lab = labels.long()
    if lab.dim() == logits.dim() and lab.shape[-1] == 1:
        lab = lab.reshape(lab.shape[:-1])
    if logits.dim() > 2:
        if lab.shape == logits.shape[:-1]:
            return lab, True
        raise ValueError(
            f"sparse labels {tuple(labels.shape)} incompatible with logits "
            f"{tuple(logits.shape)}: per-position labels must match "
            f"{tuple(logits.shape[:-1])} (optionally with a trailing "
            f"singleton)")
    return lab.reshape(lab.shape[0], -1)[:, 0], False


def compute_loss(loss_type, logits: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Scalar fp32 loss (pre-softmax logits for the CCE losses)."""
    loss_type = LossType.from_any(loss_type)
    if loss_type is LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
        lab, _ = sparse_targets(labels, logits)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, lab[..., None])
        return nll.mean()
    if loss_type is LossType.CATEGORICAL_CROSSENTROPY:
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -(labels.float() * logp).sum(dim=-1).mean()
    if loss_type is LossType.MEAN_SQUARED_ERROR:
        # Keras semantics: the mean over all elements
        d = logits.float() - _match_shape(labels, logits)
        return (d * d).mean()
    if loss_type is LossType.MEAN_SQUARED_ERROR_AVG_REDUCE:
        d = logits.float() - _match_shape(labels, logits)
        return (d * d).sum(dim=tuple(range(1, d.dim()))).mean()
    if loss_type is LossType.MEAN_SQUARED_ERROR_SUM_REDUCE:
        d = logits.float() - _match_shape(labels, logits)
        return (d * d).sum()
    if loss_type is LossType.IDENTITY:
        return logits.float().mean()
    raise ValueError(f"unknown loss {loss_type}")
