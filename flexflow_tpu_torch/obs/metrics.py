"""In-process metrics registry: counters, gauges, histograms.

Always-on (an increment is a python int add — cheaper than the
branchy alternatives) and in-memory only; the event bus persists a
snapshot on demand (``METRICS.emit_snapshot()``) and ``model.fit``
routes its step-profile summary through here instead of ad-hoc
prints.  Metric objects are stable across ``reset()`` so modules may
cache them at import time.

The port's copy of flexflow_tpu/obs/metrics.py, imports rewired; the
event schemas, environment variables and file formats are the
reference's, so ``tools/ffobs.py`` reads the port's logs.
"""

from __future__ import annotations

import random as _random
import threading
import zlib as _zlib
from typing import Dict, List


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bounded-sample histogram: exact count/sum/min/max, percentiles
    from a SEEDED RESERVOIR (Vitter's algorithm R) over the whole
    stream.  The previous first-``max_samples`` window froze a
    long-running serving process's p99 on its first minutes of
    traffic; the reservoir keeps a uniform sample of everything
    observed at the same bounded memory.  The seed derives from the
    metric name, so a replayed stream reproduces the identical summary
    (deterministic under test)."""

    __slots__ = ("name", "count", "sum", "min", "max", "_samples",
                 "max_samples", "_rng")

    def __init__(self, name: str, max_samples: int = 4096):
        self.name = name
        self.max_samples = max_samples
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples: List[float] = []
        self._rng = _random.Random(
            _zlib.crc32(name.encode("utf-8", "ignore")))

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._samples) < self.max_samples:
            self._samples.append(v)
        else:
            # algorithm R: keep each of the `count` observations with
            # probability max_samples/count — a uniform sample of the
            # whole stream, not a frozen prefix
            j = self._rng.randrange(self.count)
            if j < self.max_samples:
                self._samples[j] = v

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0}
        s = sorted(self._samples)

        def pct(p: float) -> float:
            return s[min(len(s) - 1, int(p * (len(s) - 1) + 0.5))]

        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.sum / self.count,
            "min": self.min,
            "max": self.max,
            "p50": pct(0.50),
            "p95": pct(0.95),
            "p99": pct(0.99),
        }


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            return h

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {
                    k: h.summary() for k, h in self._histograms.items()
                },
            }

    def reset(self) -> None:
        """Zero every metric IN PLACE — cached metric objects held by
        instrumented modules stay valid."""
        with self._lock:
            for c in self._counters.values():
                c.value = 0
            for g in self._gauges.values():
                g.value = 0.0
            for h in self._histograms.values():
                h.count = 0
                h.sum = 0.0
                h.min = float("inf")
                h.max = float("-inf")
                h._samples.clear()
                # re-seed so a replay after reset() reproduces the
                # identical reservoir (the determinism contract)
                h._rng = _random.Random(
                    _zlib.crc32(h.name.encode("utf-8", "ignore")))

    def emit_snapshot(self) -> None:
        """Persist the current snapshot through the event bus (no-op
        when the bus is disabled)."""
        from flexflow_tpu_torch.obs.events import BUS

        if BUS.enabled:
            BUS.emit("metrics.snapshot", **self.snapshot())


METRICS = MetricsRegistry()
