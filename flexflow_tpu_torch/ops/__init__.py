"""The port's operators (each module names its reference in
flexflow_tpu/ops/)."""

from flexflow_tpu_torch.ops.base import (
    OP_REGISTRY,
    LoweringContext,
    Operator,
    OpSharding,
    ShardAnnot,
    WeightSpec,
    register_op,
)
from flexflow_tpu_torch.ops.conv import Conv2DOp, Pool2DOp
from flexflow_tpu_torch.ops.attention import (
    BatchMatmulOp,
    MultiHeadAttentionOp,
)
from flexflow_tpu_torch.ops.decode_attention import DecodeAttentionOp
from flexflow_tpu_torch.ops.elementwise import (
    ElementBinaryOp,
    ElementUnaryOp,
)
from flexflow_tpu_torch.ops.embedding import BatchedEmbeddingOp, EmbeddingOp
from flexflow_tpu_torch.ops.inout import ConstantOp, InputOp, NoOp
from flexflow_tpu_torch.ops.linear import LinearOp
from flexflow_tpu_torch.ops.moe import (
    AggregateOp,
    AggregateSpecOp,
    CacheOp,
    GroupByOp,
)
from flexflow_tpu_torch.ops.norm import (
    BatchNormOp,
    DropoutOp,
    LayerNormOp,
    SoftmaxOp,
)
from flexflow_tpu_torch.ops.reductions import GatherOp, MeanOp, TopKOp
from flexflow_tpu_torch.ops.shape_ops import (
    CastOp,
    ConcatOp,
    FlatOp,
    ReshapeOp,
    ReverseOp,
    SplitOp,
    StackOp,
    TransposeOp,
    UnstackOp,
)

__all__ = [
    "OP_REGISTRY",
    "BatchMatmulOp",
    "DropoutOp",
    "ElementUnaryOp",
    "GatherOp",
    "MeanOp",
    "SoftmaxOp",
    "TopKOp",
    "BatchedEmbeddingOp",
    "ConstantOp",
    "DecodeAttentionOp",
    "ElementBinaryOp",
    "EmbeddingOp",
    "InputOp",
    "NoOp",
    "OpSharding",
    "ShardAnnot",
    "LayerNormOp",
    "LinearOp",
    "LoweringContext",
    "MultiHeadAttentionOp",
    "Operator",
    "ReshapeOp",
    "FlatOp",
    "ConcatOp",
    "BatchNormOp",
    "StackOp",
    "UnstackOp",
    "CastOp",
    "ReverseOp",
    "SplitOp",
    "TransposeOp",
    "Conv2DOp",
    "Pool2DOp",
    "AggregateOp",
    "AggregateSpecOp",
    "CacheOp",
    "GroupByOp",
    "WeightSpec",
    "register_op",
]
