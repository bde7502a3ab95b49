"""Structured-event bus: JSONL sink, env/FFConfig-gated.

Every event is one JSON object per line with at least ``ts`` (unix
seconds, float) and ``kind`` (a registered name from EVENT_KINDS);
kind-specific required payload fields are declared alongside so tests
and ``tools/ffobs.py validate`` can check emitted logs mechanically.

Disabled (the default) the bus costs ONE attribute check per emit —
instrumentation stays in the hot search loops without a measurable
tax.  Enable with ``FLEXFLOW_TPU_OBS=/path/to/log.jsonl`` (read at
import; ``BUS.configure`` re-arms at any time).

The port's copy of flexflow_tpu/obs/events.py, imports rewired; the
event schemas, environment variables and file formats are the
reference's, so ``tools/ffobs.py`` reads the port's logs.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
import zlib
from typing import Dict, List, Optional

from flexflow_tpu_torch.obs.flight import FLIGHT

SCHEMA_VERSION = 1

# kind -> payload fields that must be present (beyond ts/kind).
# Extra fields are always allowed; the schema floors, not ceilings.
EVENT_KINDS = {
    # bus lifecycle
    "obs.meta": {"schema", "pid"},
    # search layer (the reference's strategy search)
    "search.begin": {"nodes", "devices"},
    "search.baseline": {"cost_s"},
    "search.substitution": {"xfer", "action"},
    "search.candidate": {"cost_s", "best_s", "improved"},
    "search.split": {"op", "pre_nodes", "post_nodes"},
    # k-way chain decomposition (production-scale graphs)
    "search.chain": {"nodes", "segments"},
    "search.chain_done": {"bound_s", "cost_s"},
    # series-parallel decomposition (search/decompose.py): one
    # event per oversized (sub)graph naming the chosen decomposition —
    # mode "chain" (width-1 bottleneck cuts, the degenerate case),
    # "sp" (bounded-width frontier cuts), or "fallback" with the
    # ``reason`` the graph degraded to binary recursion, so a
    # bottleneck-free thousand-node graph can never slow down silently
    "search.decompose": {"nodes", "mode"},
    "search.decompose_done": {"mode", "bound_s", "cost_s"},
    "search.floor": {"kept_dp", "dp_cost_s", "searched_cost_s"},
    "search.result": {"cost_s", "rewritten"},
    "search.perf": {"search_seconds", "calibration_seconds", "full_sims",
                    "delta_sims"},
    "search.log": {"msg"},
    # joint strategy x comm-plan co-search (search/comm_plan.py): one
    # event per comm-plan decision — served=True rode the signature
    # memo ("memo") or the persistent layer ("disk"), False paid the
    # full choose_sync_schedule sweep ("search")
    "search.comm_plan": {"served", "source", "groups"},
    # the per-group optimizer-state sharding choice the co-search
    # adopted for its final result (ZeRO-1 dimension)
    "search.zero_groups": {"groups", "credit_s"},
    # serve-objective result (search/serving.py, FFConfig.objective):
    # the SHD16x-gated p99/KV-residency numbers of the returned strategy
    "search.serve": {"p99_s", "kv_bytes_per_device"},
    # KV-lane decision (the search's _choose_kv_precision): the
    # chosen pool dtype, whether it was searched or pinned, the
    # declared shared-prefix pages, and the per-dtype priced p99 map
    "search.kv": {"dtype", "searched", "shared_prefix_pages"},
    # prefill/decode disaggregation search (search/disaggregation.py):
    # one event per proposal decision — colocated vs disaggregated
    # serve-currency step, the KV-handoff price, and whether the
    # two-block placement was adopted (honest zero = adopted=False)
    "search.disagg": {"adopted", "colocated_ms", "disagg_ms",
                      "handoff_ms"},
    # one event per fleet proposal decision (search/fleet.py): the
    # N-replica partition, routing policy, per-class p99 roll-up and
    # whether the fleet beat the single replica (honest zero =
    # adopted=False)
    "search.fleet": {"adopted", "replicas", "single_ms", "fleet_ms"},
    # fleet router (runtime/fleet.py): one event per routed request —
    # which replica the searched per-class fractions dispatched it to
    "fleet.route": {"rid", "replica", "slo"},
    # elastic fleet re-size (runtime/controller.py research_fleet):
    # measured per-class p99 drift triggered a fleet re-search that
    # may change N
    "fleet.scale": {"step", "from_replicas", "to_replicas"},
    # continuous-batching decode executor (runtime/decode.py): one
    # event per composed decode frame (admissions/evictions/page
    # residency + measured latency, predicted_s when a serving pricer
    # supplied one) and one end-of-run roll-up — the decode phase of
    # the predicted-vs-measured story (ffobs report renders both)
    "decode.frame": {"frame", "active", "admitted", "evicted",
                     "pages_in_use"},
    "decode.summary": {"frames", "completed", "measured_p50_s",
                       "measured_p99_s"},
    # per-request serving lifecycle (runtime/decode.py): one event per
    # completed request carrying its spans — queue wait, TTFT (enqueue
    # -> first generated token), TPOT (steady per-token), e2e — the
    # request-level currency of the serving telemetry.  Armed requests
    # only: the executor checks the bus ONCE per frame when off.
    "decode.request": {"rid", "phase"},
    # chunked prefill lane (runtime/prefill.py): one event per admitted
    # prompt that went through the batched KV writer — tokens written,
    # chunk passes paid (vs one decode frame per token without it)
    "decode.prefill": {"rid", "tokens", "chunks"},
    # radix prefix sharing (runtime/decode.py PageAllocator): one
    # prefix_hit per admission that claimed trie-cached pages by
    # refcount instead of allocating (pages claimed, prompt tokens
    # skipped); one cow per copy-on-write page copy at a mid-page
    # divergence (the reserve-on-divergence path)
    "decode.prefix_hit": {"rid", "pages", "tokens"},
    "decode.cow": {"rid", "src_page", "dst_page", "tokens"},
    # device-trace ingestion + lane matching (obs/trace_ingest.py):
    # one trace.ingest per parsed capture, one trace.lane_match per
    # predicted sync-bucket lane (matched by annotation tag, never by
    # fuzzy kernel name)
    "trace.ingest": {"path", "events", "lanes"},
    "trace.lane_match": {"lane", "matched"},
    # Prometheus exposition endpoint start (obs/exposition.py,
    # FLEXFLOW_TPU_METRICS_PORT)
    "metrics.exposition": {"port"},
    # DP inner loop (search/dp.py)
    "dp.split": {"op", "pre_nodes", "post_nodes", "cost_s"},
    "dp.summary": {"memo_hits", "memo_misses"},
    # calibration / cost-model provenance
    "calibration.ignored": {"backend", "machine"},
    "calibration.staleness": {"ratio", "threshold"},
    # the automatic re-probe policy acting on a drift-stale table:
    # deferred=False re-probed on the live backend, True fell back to
    # the roofline (live backend cannot probe for the machine model)
    "calibration.reprobe": {"backend", "deferred"},
    # compile-time strategy explanation (model.py)
    "strategy.table": {"rows"},
    # static analysis (flexflow_tpu/analysis): one event per finding —
    # "pass" is the producing pass (invariants/sharding/equivalence/
    # strategy), "code" the stable finding code (PCG0xx/SHD1xx/…)
    "analysis.finding": {"pass", "code"},
    # runtime (model.fit / runtime/profiler.py)
    "profile.summary": {"steps"},
    "drift.report": {"predicted_s", "measured_s", "ratio", "stale"},
    "metrics.snapshot": {"counters"},
    # always-on training controller (runtime/controller.py): the
    # drift→re-search→hot-swap / elastic-recovery decision stream, plus
    # the deterministic fault-injection harness (runtime/faults.py)
    "fault.injected": {"fault", "step"},
    "controller.research": {"step", "trigger", "search_seconds"},
    "controller.swap": {"step", "swap_seconds", "fallback"},
    "controller.recovery": {"step", "cause"},
    "controller.retry": {"step", "attempt"},
    "controller.fallback": {"step", "reason"},
    # the measured-p99 drift watch (serving currency): the controller
    # saw a measured decode p99 vs the searched prediction; drifted
    # past threshold => the next step re-searches with this trigger
    "controller.p99_drift": {"step", "ratio", "drifted"},
    # SLO burn-rate watch (obs/slo.py via controller.observe_burn_rate):
    # one event per class per observation — multi-window error-budget
    # burn; fired=True arms a re-search BEFORE raw p99 crosses the
    # drift threshold
    "controller.burn_rate": {"step", "slo", "fast", "slow", "fired"},
    "controller.summary": {"steps", "swaps", "recoveries"},
    # request-scoped tracing (obs/tracing.py): one trace.span per
    # CLOSED span when the bus is armed; trace.open lines appear only
    # in flight-recorder dumps (the in-flight requests at dump time)
    "trace.span": {"trace_id", "span", "span_id", "dur_s"},
    "trace.open": {"trace_id", "span", "span_id"},
    # flight recorder (obs/flight.py): flight.meta heads every dump
    # file; flight.dump is emitted on the bus when a post-mortem was
    # written (fault injection, controller fallback, atexit/SIGTERM)
    "flight.meta": {"reason", "events", "dropped"},
    "flight.dump": {"path", "events", "open_spans", "reason"},
    # event-volume guard roll-up: per-kind counts the sampler
    # suppressed (emitted at close so totals stay exactly recoverable)
    "obs.sampled": {"counts"},
}

_VALID_ACTIONS = frozenset(
    {"pushed", "pruned", "duplicate", "invalid", "pinned"}
)


def validate_event(obj) -> List[str]:
    """Schema errors for one decoded JSONL event ([] = valid)."""
    errors: List[str] = []
    if not isinstance(obj, dict):
        return ["event is not a JSON object"]
    ts = obj.get("ts")
    if not isinstance(ts, (int, float)):
        errors.append("missing/non-numeric 'ts'")
    kind = obj.get("kind")
    if not isinstance(kind, str) or not kind:
        errors.append("missing 'kind'")
        return errors
    required = EVENT_KINDS.get(kind)
    if required is None:
        errors.append(f"unknown kind {kind!r}")
        return errors
    for field in required:
        if field not in obj:
            errors.append(f"{kind}: missing field {field!r}")
    if kind == "search.substitution" and obj.get("action") not in _VALID_ACTIONS:
        errors.append(
            f"search.substitution: action {obj.get('action')!r} not in "
            f"{sorted(_VALID_ACTIONS)}"
        )
    return errors


class EventBus:
    """Append-only JSONL event sink.  Thread-safe; ``enabled`` is a
    plain attribute so the disabled fast path is one load + branch."""

    def __init__(self):
        self.enabled = False
        self.path: Optional[str] = None
        self._sink = None
        self._lock = threading.Lock()
        self._atexit_armed = False
        # event-volume guard: kind -> rate (float < 1.0, probability)
        # or cap (int >= 1, first-N).  None = no sampling configured,
        # so the armed hot path pays a single ``is not None`` check.
        self._sample: Optional[Dict[str, float]] = None
        self._sample_seed = 0
        self._emitted: Dict[str, int] = {}
        self.sampled_out: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def configure(self, path: str) -> None:
        """Open (or switch to) a JSONL sink at ``path`` and enable the
        bus.  Idempotent for a repeated identical path.  Writes are
        block-buffered (a per-event flush syscall would tax the chatty
        per-candidate search events); an atexit hook drains the buffer
        on normal interpreter exit, and flush()/close() do so on
        demand."""
        with self._lock:
            if not self._atexit_armed:
                atexit.register(self.flush)
                self._atexit_armed = True
            if self._sink is not None and self.path == path:
                self.enabled = True
                return
            if self._sink is not None:
                self._sink.close()
            self._sink = open(path, "a")
            self.path = path
            self.enabled = True
        self.emit("obs.meta", schema=SCHEMA_VERSION, pid=os.getpid())

    def configure_sampling(self, spec, seed: int = 0) -> None:
        """Arm the per-kind event-volume guard.  ``spec`` is either a
        dict or a ``"kind=rate,kind=cap"`` string: a value < 1.0 keeps
        that fraction of events (deterministic, seeded — the keep
        decision hashes (kind, ordinal, seed), so it is independent of
        interleaving across kinds); an integer >= 1 caps the kind at
        its first N events.  Unlisted kinds are never sampled.
        Suppressed events are counted exactly in ``sampled_out`` and
        rolled up as one ``obs.sampled`` event at close, so totals
        stay recoverable from the log."""
        if isinstance(spec, str):
            parsed: Dict[str, float] = {}
            for part in spec.split(","):
                part = part.strip()
                if not part:
                    continue
                name, _, val = part.partition("=")
                v = float(val)
                parsed[name.strip()] = v if v < 1.0 else int(v)
            spec = parsed
        self._sample = dict(spec) if spec else None
        self._sample_seed = int(seed)
        self._emitted = {}
        self.sampled_out = {}

    def _sample_keep(self, kind: str) -> bool:
        rate = self._sample.get(kind)  # type: ignore[union-attr]
        if rate is None:
            return True
        n = self._emitted.get(kind, 0) + 1
        self._emitted[kind] = n
        if isinstance(rate, int):
            keep = n <= rate
        else:
            h = zlib.crc32(f"{kind}:{n}:{self._sample_seed}".encode())
            keep = h < rate * 2**32
        if not keep:
            self.sampled_out[kind] = self.sampled_out.get(kind, 0) + 1
        return keep

    def close(self) -> None:
        if self.enabled and self.sampled_out:
            self.emit("obs.sampled", counts=dict(self.sampled_out))
        with self._lock:
            self.enabled = False
            if self._sink is not None:
                self._sink.close()
                self._sink = None
            self.path = None

    def flush(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.flush()

    # ------------------------------------------------------------------
    def emit(self, kind: str, **payload) -> None:
        # flight recorder sees EVERY event, armed bus or not — the
        # post-mortem ring must survive the off-by-default discipline
        # (one plain-attribute check + a deque append, no encoding)
        if FLIGHT.enabled:
            FLIGHT.record(kind, payload)
        if not self.enabled:
            return
        if self._sample is not None and not self._sample_keep(kind):
            return
        evt = {"ts": time.time(), "kind": kind}
        evt.update(payload)
        try:
            line = json.dumps(evt, default=_jsonable)
        except (TypeError, ValueError):  # never let telemetry crash work
            line = json.dumps({"ts": evt["ts"], "kind": kind,
                               "error": "unserializable payload"})
        with self._lock:
            if self._sink is not None:
                self._sink.write(line + "\n")


def _jsonable(obj):
    """Best-effort coercion for payload values (numpy scalars, views).
    ``tolist`` first: ``item()`` raises on arrays with size != 1."""
    for attr in ("tolist", "item"):
        fn = getattr(obj, attr, None)
        if fn is not None:
            try:
                return fn()
            except (TypeError, ValueError):
                continue
    return repr(obj)


BUS = EventBus()

_env = os.environ.get("FLEXFLOW_TPU_OBS", "")
if _env and _env != "0":
    try:
        BUS.configure(_env if _env not in ("1", "true") else "ffobs.jsonl")
    except OSError:  # unwritable path must not break imports
        pass
del _env

_env = os.environ.get("FLEXFLOW_TPU_OBS_SAMPLE", "")
if _env:
    try:
        BUS.configure_sampling(
            _env,
            seed=int(os.environ.get("FLEXFLOW_TPU_OBS_SAMPLE_SEED", "0")))
    except ValueError:  # malformed spec must not break imports
        pass
del _env
