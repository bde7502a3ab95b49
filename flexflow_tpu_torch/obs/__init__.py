"""Observability for the port — flexflow_tpu/obs/ without JAX.

Stdlib-light, so ``import flexflow_tpu_torch.obs`` stays cheap and
tooling (tools/ffobs.py) reads the artifacts with either package:

* ``events`` — the structured-event bus with a JSONL sink
  (``FLEXFLOW_TPU_OBS=<path>`` or ``FFConfig.obs_log_file``; one
  boolean check per ``emit()`` when off), the reference's schemas.
* ``metrics`` — the in-process registry of counters, gauges and
  histograms.
* ``trace``/``drift`` — Chrome-trace export of the SIMULATED task
  timeline, and ``DriftReport``: predicted against measured step.
* ``annotate``/``trace_ingest`` — the MEASURED side of the loop:
  ``torch.profiler`` ranges keyed by phase and sync-bucket lane id
  stamped onto the executed step, and a reader that matches a
  ``runtime.profiler.device_trace`` capture back to the simulator's
  predicted lanes by tag (``LaneDriftReport``).
* ``exposition`` — Prometheus text of the metrics registry (and a
  stdlib HTTP endpoint on loopback, ``FLEXFLOW_TPU_METRICS_PORT``).
* ``tracing``/``flight``/``slo`` — request span trees for serving
  (``FLEXFLOW_TPU_TRACE``), the bounded flight recorder
  (``FLEXFLOW_TPU_FLIGHT_DIR``), and multi-window SLO burn rates.
"""

from flexflow_tpu_torch.obs.drift import DriftReport, build_drift_report  # noqa: F401
from flexflow_tpu_torch.obs.events import BUS, EventBus, validate_event  # noqa: F401
from flexflow_tpu_torch.obs.exposition import (  # noqa: F401
    maybe_start_from_env as _maybe_start_metrics,
    render_prometheus,
    start_metrics_server,
)
from flexflow_tpu_torch.obs.flight import FLIGHT, FlightRecorder  # noqa: F401
from flexflow_tpu_torch.obs.metrics import METRICS, MetricsRegistry  # noqa: F401
from flexflow_tpu_torch.obs.slo import burn_rates, first_fire_indices  # noqa: F401
from flexflow_tpu_torch.obs.trace import write_chrome_trace  # noqa: F401
from flexflow_tpu_torch.obs.trace_ingest import (  # noqa: F401
    LaneDriftReport,
    apply_lane_measurements,
    build_lane_drift_report,
)
from flexflow_tpu_torch.obs.tracing import (  # noqa: F401
    Span,
    TRACER,
    Tracer,
    forest_stats,
    span_forest,
)

__all__ = [
    "BUS",
    "EventBus",
    "FLIGHT",
    "FlightRecorder",
    "METRICS",
    "MetricsRegistry",
    "DriftReport",
    "LaneDriftReport",
    "Span",
    "TRACER",
    "Tracer",
    "apply_lane_measurements",
    "build_drift_report",
    "build_lane_drift_report",
    "burn_rates",
    "first_fire_indices",
    "forest_stats",
    "render_prometheus",
    "span_forest",
    "start_metrics_server",
    "validate_event",
    "write_chrome_trace",
]

# FLEXFLOW_TPU_METRICS_PORT arms the exposition endpoint process-wide
_maybe_start_metrics()
