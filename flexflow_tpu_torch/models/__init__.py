"""Model zoo of the port (flexflow_tpu/models/): the decode family and
the transformer encoder / GPT."""

from flexflow_tpu_torch.models.decode import (
    GPT_DECODE_KW,
    GPT_DECODE_SERVE_KW,
    SERVE_FRAME_SLOTS,
    build_gpt_decode,
)
from flexflow_tpu_torch.models.transformer import (
    build_gpt,
    build_transformer,
    encoder_layer,
)

__all__ = [
    "GPT_DECODE_KW",
    "GPT_DECODE_SERVE_KW",
    "SERVE_FRAME_SLOTS",
    "build_gpt",
    "build_gpt_decode",
    "build_transformer",
    "encoder_layer",
]
