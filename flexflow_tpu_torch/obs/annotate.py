"""Named phase annotations — the part of flexflow_tpu/obs/annotate.py
(annotate.py:44-104) the serving executor uses.

``phase_span(tag)`` wraps a dispatch-level phase (``ff.phase/step``,
``ff.phase/decode_frame``, ``ff.phase/prefill_chunk``) in a
``torch.profiler.record_function`` range, so a ``torch.profiler``
capture shows it on the host timeline, plus a ``torch.cuda.nvtx``
range when CUDA is present.  It does so only while armed
(``arm()``/``disarm()``); disarmed it is one module-global check and a
shared null context.  The reference's lane stamps (``lane_stamp``,
``LANES``, ``scope``) belong to the training step's sync lanes and come
with a later slice.
"""

from __future__ import annotations

import contextlib

PHASE_PREFIX = "ff.phase/"
STEP_PHASE = PHASE_PREFIX + "step"
DECODE_PHASE = PHASE_PREFIX + "decode_frame"
PREFILL_PHASE = PHASE_PREFIX + "prefill_chunk"

_ARMED = False
_NULL = contextlib.nullcontext()


def arm() -> None:
    global _ARMED
    _ARMED = True


def disarm() -> None:
    global _ARMED
    _ARMED = False


def armed() -> bool:
    return _ARMED


@contextlib.contextmanager
def _span(tag: str):
    import torch

    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(tag):
        if nvtx:
            torch.cuda.nvtx.range_push(tag)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def phase_span(tag: str):
    """Context manager: a profiler range (and an NVTX range on a CUDA
    host) while armed, a shared null context otherwise."""
    if not _ARMED:
        return _NULL
    return _span(tag)
