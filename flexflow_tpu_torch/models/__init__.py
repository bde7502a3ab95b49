"""Model zoo of the port (flexflow_tpu/models/): the decode family so
far."""

from flexflow_tpu_torch.models.decode import (
    GPT_DECODE_KW,
    GPT_DECODE_SERVE_KW,
    SERVE_FRAME_SLOTS,
    build_gpt_decode,
)

__all__ = [
    "GPT_DECODE_KW",
    "GPT_DECODE_SERVE_KW",
    "SERVE_FRAME_SLOTS",
    "build_gpt_decode",
]
