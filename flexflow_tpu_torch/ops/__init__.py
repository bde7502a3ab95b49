"""The port's operators (each module names its reference in
flexflow_tpu/ops/)."""

from flexflow_tpu_torch.ops.base import (
    OP_REGISTRY,
    LoweringContext,
    Operator,
    WeightSpec,
    register_op,
)
from flexflow_tpu_torch.ops.attention import MultiHeadAttentionOp
from flexflow_tpu_torch.ops.decode_attention import DecodeAttentionOp
from flexflow_tpu_torch.ops.elementwise import ElementBinaryOp
from flexflow_tpu_torch.ops.embedding import EmbeddingOp
from flexflow_tpu_torch.ops.inout import ConstantOp, InputOp
from flexflow_tpu_torch.ops.linear import LinearOp
from flexflow_tpu_torch.ops.norm import LayerNormOp
from flexflow_tpu_torch.ops.shape_ops import ReshapeOp

__all__ = [
    "OP_REGISTRY",
    "ConstantOp",
    "DecodeAttentionOp",
    "ElementBinaryOp",
    "EmbeddingOp",
    "InputOp",
    "LayerNormOp",
    "LinearOp",
    "LoweringContext",
    "MultiHeadAttentionOp",
    "Operator",
    "ReshapeOp",
    "WeightSpec",
    "register_op",
]
