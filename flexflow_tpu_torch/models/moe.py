"""The port of flexflow_tpu/models/moe.py, op names equal to the
reference's (a params dict carries across). Mixture-of-Experts
classifier (reference: examples/cpp/mixture_of_experts/moe.cc:1-501):
top-k gating -> group_by dispatch -> per-expert MLPs -> weighted
aggregate, with assignment caching feeding dynamic recompilation
(moe.cc:46-92).

Experts are a batched [E, cap, D] computation (one Linear
over the expert dim is expert-parallel when dim 0 is sharded)."""

from __future__ import annotations

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.model import FFModel


def build_moe(
    config: FFConfig,
    in_dim: int = 784,
    num_classes: int = 10,
    num_exp: int = 4,
    num_select: int = 2,
    hidden: int = 64,
    alpha: float = 2.0,
    lambda_bal: float = 0.04,
    use_cache: bool = False,
):
    """reference: moe.cc:94-148 (num_exp=4 k=2 alpha=2 on MNIST-784)."""
    model = FFModel(config)
    b = config.batch_size
    x = model.create_tensor([b, in_dim], name="features")
    # gating network (moe.cc: dense -> softmax -> topk)
    gate = model.dense(x, num_exp, name="gate_dense")
    gate = model.softmax(gate, name="gate_softmax")
    if use_cache:
        gate = model.cache(gate, name="gate_cache")
    topk_vals, topk_idx = model.top_k(gate, k=num_select, name="gate_topk")
    grouped, eidx, pos, valid = model.group_by(x, topk_idx, n_experts=num_exp,
                                               alpha=alpha, name="dispatch")
    # experts: batched MLP over [E, cap, D] — dim 0 sharding = EP
    h = model.dense(grouped, hidden, activation="relu", name="expert_fc1")
    h = model.dense(h, num_classes, name="expert_fc2")
    out = model.aggregate(topk_vals, eidx, pos, valid, h,
                          lambda_bal=lambda_bal, name="combine")
    return model
