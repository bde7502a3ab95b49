"""Model zoo of the port (flexflow_tpu/models/): every family the
reference ships, each builder a copy of its reference file."""

from flexflow_tpu_torch.models.alexnet import (
    build_alexnet,
    build_alexnet_cifar10,
)
from flexflow_tpu_torch.models.resnet import build_resnet, build_resnext50
from flexflow_tpu_torch.models.inception import build_inception_v3
from flexflow_tpu_torch.models.transformer import (
    build_bert,
    build_gpt,
    build_gpt_xl,
    build_transformer,
    encoder_layer,
)
from flexflow_tpu_torch.models.decode import (
    GPT_DECODE_KW,
    GPT_DECODE_SERVE_KW,
    SERVE_FRAME_SLOTS,
    build_gpt_decode,
    build_gpt_prefill,
    derive_prefill_model,
)
from flexflow_tpu_torch.models.dlrm import build_dlrm
from flexflow_tpu_torch.models.xdl import build_xdl
from flexflow_tpu_torch.models.candle_uno import build_candle_uno
from flexflow_tpu_torch.models.moe import build_moe
from flexflow_tpu_torch.models.mlp import build_mlp_unify
from flexflow_tpu_torch.models.synthetic import (
    build_moe_trunk,
    build_multibranch,
)

__all__ = [
    "build_alexnet",
    "build_alexnet_cifar10",
    "build_resnet",
    "build_resnext50",
    "build_inception_v3",
    "build_transformer",
    "build_bert",
    "build_gpt",
    "build_gpt_decode",
    "build_gpt_prefill",
    "derive_prefill_model",
    "build_gpt_xl",
    "encoder_layer",
    "GPT_DECODE_KW",
    "GPT_DECODE_SERVE_KW",
    "SERVE_FRAME_SLOTS",
    "build_dlrm",
    "build_xdl",
    "build_candle_uno",
    "build_moe",
    "build_moe_trunk",
    "build_multibranch",
    "build_mlp_unify",
]
