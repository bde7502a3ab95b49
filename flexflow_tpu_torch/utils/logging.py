"""Indent-scoped search logging — a copy of
flexflow_tpu/utils/logging.py (reference:
src/runtime/recursive_logger.cc + include/flexflow/utils/
recursive_logger.h — TAG_ENTER/TAG_EXIT indented traces of the search
recursion, e.g. substitution.cc:2011).

``enabled`` is resolved LAZILY against FLEXFLOW_TPU_SEARCH_LOG at each
call unless pinned — the module-singleton ``SEARCH_LOG`` used to read
the env var once at import, so tests (and the obs config) could never
toggle it afterwards.  ``set_enabled(True/False)`` pins; ``set_enabled
(None)`` re-arms the env lookup.  When the structured-event bus
(flexflow_tpu_torch/obs) is enabled, every log line is additionally routed
through it as a ``search.log`` event so the JSONL telemetry log holds
the full search trace.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Optional, TextIO

_BUS = None  # lazily bound flexflow_tpu_torch.obs.events.BUS


def _bus():
    global _BUS
    if _BUS is None:
        from flexflow_tpu_torch.obs.events import BUS

        _BUS = BUS
    return _BUS


class RecursiveLogger:
    """Depth-indented logger; enabled via FLEXFLOW_TPU_SEARCH_LOG=1 or
    explicitly."""

    def __init__(self, category: str = "search",
                 enabled: Optional[bool] = None, stream: TextIO = None):
        self.category = category
        self._enabled = enabled  # None = defer to the env var per call
        self.stream = stream or sys.stderr
        self.depth = 0

    @property
    def enabled(self) -> bool:
        if self._enabled is None:
            return os.environ.get(
                "FLEXFLOW_TPU_SEARCH_LOG", "") not in ("", "0")
        return self._enabled

    @enabled.setter
    def enabled(self, value: Optional[bool]) -> None:
        self._enabled = value

    def set_enabled(self, value: Optional[bool]) -> None:
        """Pin stream logging on/off; ``None`` re-arms the lazy env
        lookup (the import-time-snapshot behavior this replaces could
        never be toggled by tests)."""
        self._enabled = value

    def log(self, msg: str) -> None:
        if self.enabled:
            self.stream.write(f"[{self.category}] {'  ' * self.depth}{msg}\n")
        bus = _bus()
        if bus.enabled:
            bus.emit("search.log", msg=msg, depth=self.depth,
                     category=self.category)

    @contextlib.contextmanager
    def enter(self, msg: str = ""):
        """TAG_ENTER equivalent: indent everything logged inside."""
        if msg:
            self.log(msg)
        self.depth += 1
        try:
            yield self
        finally:
            self.depth -= 1


SEARCH_LOG = RecursiveLogger("search")
