"""Prometheus text exposition of the metrics registry — a copy of
flexflow_tpu/obs/exposition.py.

The registry (``obs/metrics.py``) is in-process; operators scrape.
``render_prometheus`` turns a registry snapshot into Prometheus text
format 0.0.4 (counters, gauges, and histogram SUMMARIES — count/sum
plus quantile series, the shape a reservoir-sampled histogram can
honestly export).  ``start_metrics_server`` serves it from a stdlib
``http.server`` daemon thread at ``/metrics``;
``FLEXFLOW_TPU_METRICS_PORT=<port>`` arms it process-wide at import
(``maybe_start_from_env``, called by ``flexflow_tpu_torch.obs``).  Offline,
``tools/ffobs.py metrics`` renders the same text from a
``metrics.snapshot`` event in a JSONL log — no live process needed.

Stdlib-only.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Dict, Optional

PREFIX = "flexflow_tpu"
_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

_QUANTILES = ("p50", "p95", "p99")


def _metric_name(name: str) -> str:
    """Dotted registry names -> Prometheus-legal metric names
    (``fit.step_s`` -> ``flexflow_tpu_fit_step_s``)."""
    return f"{PREFIX}_{_NAME_RE.sub('_', name)}"


def _split_labels(name: str):
    """Registry names carry optional inline labels after ``|``
    (``decode.ttft_s|replica=0,slo=interactive`` — the fleet's
    per-replica/per-class series, runtime/decode.py).  Returns
    (base_name, [(key, value), ...]); a malformed suffix stays part of
    the name rather than dropping the series."""
    if "|" not in name:
        return name, []
    base, _, raw = name.partition("|")
    labels = []
    for part in raw.split(","):
        if "=" not in part:
            return name, []
        k, _, v = part.partition("=")
        k = k.strip()
        v = v.strip()
        if not k or not v:
            return name, []
        labels.append((_NAME_RE.sub("_", k), v.replace('"', "'")))
    return base, labels


def _label_block(labels, extra: str = "") -> str:
    """``{k="v",...}`` rendering; ``extra`` is a pre-formatted pair
    (the summary quantile) merged into the same block."""
    pairs = [f'{k}="{v}"' for k, v in labels]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt(v) -> str:
    if v is None:
        return "NaN"
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if isinstance(v, float) else str(v)


def render_prometheus(snapshot: Dict[str, dict]) -> str:
    """Prometheus text for a ``MetricsRegistry.snapshot()``-shaped
    dict (also the payload of a ``metrics.snapshot`` JSONL event):
    counters -> ``counter``, gauges -> ``gauge``, histograms ->
    ``summary`` (count/sum exact, quantiles from the seeded
    reservoir)."""
    lines = []
    typed = set()  # one TYPE line per base metric, labeled series share it

    def _type(m: str, kind: str) -> None:
        if (m, kind) not in typed:
            typed.add((m, kind))
            lines.append(f"# TYPE {m} {kind}")

    for name, value in sorted((snapshot.get("counters") or {}).items()):
        base, labels = _split_labels(name)
        m = _metric_name(base)
        _type(m, "counter")
        lines.append(f"{m}{_label_block(labels)} {_fmt(value)}")
    for name, value in sorted((snapshot.get("gauges") or {}).items()):
        base, labels = _split_labels(name)
        m = _metric_name(base)
        _type(m, "gauge")
        lines.append(f"{m}{_label_block(labels)} {_fmt(value)}")
    for name, summ in sorted((snapshot.get("histograms") or {}).items()):
        if not isinstance(summ, dict):
            continue
        base, labels = _split_labels(name)
        m = _metric_name(base)
        _type(m, "summary")
        for q in _QUANTILES:
            if q in summ:
                block = _label_block(labels,
                                     extra=f'quantile="0.{q[1:]}"')
                lines.append(f"{m}{block} {_fmt(summ[q])}")
        lab = _label_block(labels)
        lines.append(f"{m}_count{lab} {_fmt(summ.get('count', 0))}")
        if "sum" in summ:
            lines.append(f"{m}_sum{lab} {_fmt(summ['sum'])}")
        for extra in ("min", "max", "mean"):
            if extra in summ:
                lines.append(f"{m}_{extra}{lab} {_fmt(summ[extra])}")
    return "\n".join(lines) + ("\n" if lines else "")


class MetricsServer:
    """Daemon-threaded ``/metrics`` endpoint over the live registry.
    ``port=0`` binds an ephemeral port (tests); ``.port`` reports the
    bound one."""

    def __init__(self, port: int, registry=None, host: str = "127.0.0.1"):
        import http.server

        if registry is None:
            from flexflow_tpu_torch.obs.metrics import METRICS as registry  # noqa: N813

        reg = registry

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = render_prometheus(reg.snapshot()).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *_a):  # scrapes must not spam stderr
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            (host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="ff-metrics",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


_SERVER: Optional[MetricsServer] = None


def start_metrics_server(port: int, registry=None) -> MetricsServer:
    """Start (or return the already-running) exposition endpoint and
    emit a ``metrics.exposition`` event when the bus is armed."""
    global _SERVER
    if _SERVER is not None:
        return _SERVER
    _SERVER = MetricsServer(port, registry=registry)
    from flexflow_tpu_torch.obs.events import BUS

    if BUS.enabled:
        BUS.emit("metrics.exposition", port=_SERVER.port,
                 host=_SERVER.host)
    return _SERVER


def stop_metrics_server() -> None:
    global _SERVER
    if _SERVER is not None:
        _SERVER.close()
        _SERVER = None


def maybe_start_from_env() -> Optional[MetricsServer]:
    """``FLEXFLOW_TPU_METRICS_PORT=<port>`` arms the endpoint at
    import; unset/0/invalid/unbindable stays silent — telemetry must
    never break imports."""
    raw = os.environ.get("FLEXFLOW_TPU_METRICS_PORT", "")
    try:
        port = int(raw)
    except ValueError:
        return None
    if port <= 0:
        return None
    try:
        return start_metrics_server(port)
    except OSError:
        return None
