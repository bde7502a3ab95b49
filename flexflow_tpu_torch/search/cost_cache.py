"""Persistent cost cache — warm starts for the strategy search; a copy
of flexflow_tpu/search/cost_cache.py.  Off unless a path is given
(``FFConfig.cost_cache_file`` or ``FLEXFLOW_TPU_COST_CACHE``).

The reference's measured-cost cache lives for one process
(ProfilingRecord hash map, simulator.cc:515-554); every bench sweep,
CI run, or repeat compile here used to re-derive identical per-node
cost rows and re-run identical searches from scratch.  This module
persists two layers, both keyed under ONE ``signature`` that
fingerprints the whole cost surface (machine spec, device count,
calibration-table content, precision/sharding mode flags, schema
version):

* **Row cache** — ``Simulator._node_costs`` rows ``(fwd_s, full_s,
  sync_s, mem_bytes)`` per (op structural digest, machine view).  The
  native DP digests (`search/dp.py _node_digest`) are baked from these
  rows, so serving them from disk warms both engines.
* **Search-result cache** — ``optimize_strategy``'s final
  ``(best_graph, strategy, cost)`` per (graph structural digest,
  search-knob tuple).  The search is a deterministic pure function of
  (graph, knobs, cost surface); repeated searches — bench sweeps
  across the model zoo, re-runs after unrelated code edits, CI —
  return the stored result instead of re-searching.  Graphs are
  pickled (operator descriptors are plain immutable python objects);
  anything unpicklable silently skips storing.

Invalidation is WHOLESALE on signature change: a recalibration, a
different machine model, or a bumped ``SCHEMA_VERSION`` abandons every
stored row.  A ``calibration_stale`` flag (set when a measured
DriftReport flags the calibration table, obs/drift.py) makes the cache
refuse to serve until the table is re-probed — a stale surface must
not keep seeding searches.

Knobs: ``FFConfig.cost_cache_file`` / ``--cost-cache-file`` /
``--no-cost-cache``; env ``FLEXFLOW_TPU_COST_CACHE`` (path, or ``0``
to disable) when the config leaves it unset.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import pickle
import sys
from typing import Dict, Optional, Tuple

from flexflow_tpu_torch.obs.metrics import METRICS

SCHEMA_VERSION = 1
# sub-schema of the persisted DP-memo rows ("dp_rows"/"dp_schema" keys,
# additive to SCHEMA_VERSION so caches written before the layer existed
# stay valid).  An UNKNOWN dp_schema drops the dp layer loudly (stderr +
# fflint CCH405) and keeps the rest of the cache — corrupt memo rows
# must cost a recompute, never serve a wrong strategy.
# v2: stable_node_digests substitutes input tensor_guids by rank of
# appearance (matching stable_graph_digest), so input-bearing segments
# key consistently across builds — v1 rows for such segments were
# permanently dead keys that still counted against DP_MAX_ROWS.
DP_SCHEMA = 2
# sub-schema of the persisted comm-plan memo rows ("comm_plans"/
# "comm_schema" keys, search/comm_plan.py): the co-search's chosen
# sync schedules / precision maps / zero-sharding choices per
# synced-group signature.  Same additive discipline as the dp layer —
# an unknown comm_schema drops ONLY this layer, loudly (stderr +
# fflint CCH407), and a re-search rebuilds it.
COMM_SCHEMA = 1
# sub-schema of the persisted SP-SEGMENT memo rows ("sp_rows"/
# "sp_schema" keys): finished series-parallel segment SOLVES — the
# whole unity recursion over one segment, substitutions included — as
# guid-free strategy rows under stable digests (driver._persist_sp_row)
# keyed by segment digest + pinned boundary-view tuple + search knobs.
# Same additive fail-LOUD discipline: an unknown sp_schema drops only
# this layer (stderr + fflint CCH409) and segments re-solve.
SP_SCHEMA = 1

_ROW_HITS = METRICS.counter("cost_cache.row_hits")
_ROW_MISSES = METRICS.counter("cost_cache.row_misses")
_RESULT_HITS = METRICS.counter("cost_cache.result_hits")
_RESULT_MISSES = METRICS.counter("cost_cache.result_misses")
_DP_HITS = METRICS.counter("cost_cache.dp_row_hits")
_DP_MISSES = METRICS.counter("cost_cache.dp_row_misses")
_COMM_HITS = METRICS.counter("cost_cache.comm_plan_hits")
_COMM_MISSES = METRICS.counter("cost_cache.comm_plan_misses")
_SP_HITS = METRICS.counter("cost_cache.sp_row_hits")
_SP_MISSES = METRICS.counter("cost_cache.sp_row_misses")

RowKey = Tuple[str, Tuple[int, ...], int]


def resolve_cost_cache_path(config) -> Optional[str]:
    """The on-disk cache path for a config, or None when disabled.
    Explicit ``cost_cache_file`` wins; empty string disables; unset
    falls back to the FLEXFLOW_TPU_COST_CACHE environment variable
    (its value ``0``/empty likewise disables)."""
    path = getattr(config, "cost_cache_file", None)
    if path is None:
        path = os.environ.get("FLEXFLOW_TPU_COST_CACHE") or None
    if not path or path == "0":
        return None
    return path


def calibration_digest(calibration) -> Optional[str]:
    """Content fingerprint of a CalibrationTable — the cache must
    invalidate when any measured record changes, not merely when the
    file path does."""
    if calibration is None:
        return None
    h = hashlib.sha256()
    h.update(repr(getattr(calibration, "backend", None)).encode())
    for k, v in sorted(calibration._t.items()):
        h.update(repr((k, v)).encode())
    for k, v in sorted(calibration._clusters.items()):
        h.update(repr((k, v)).encode())
    return h.hexdigest()[:16]


def cost_signature(cost_model) -> str:
    """Fingerprint of everything a cost row / search result depends on
    besides the (op, view) key itself — the ``calibration_signature``
    axis of the cache key."""
    m = cost_model.machine
    parts = {
        "schema": SCHEMA_VERSION,
        "python_hash_stable": True,
        "machine": [
            m.num_devices, m.devices_per_host, m.peak_flops,
            m.hbm_bandwidth, m.hbm_capacity, m.ici_bandwidth,
            m.ici_latency, list(m.ici_torus), m.dcn_bandwidth,
            m.dcn_latency, m.reshard_overhead_s, m.name, m.platform,
            [list(lvl) for lvl in m.slice_levels],
        ],
        "num_devices": cost_model.num_devices,
        "zero_dp_shard": cost_model.zero_dp_shard,
        "inference": cost_model.inference,
        "sync_precision": cost_model.sync_precision,
        "network": cost_model.network is not None,
        "calibration": calibration_digest(cost_model.calibration),
    }
    if getattr(cost_model, "sync_ef", False):
        # EF changes the priced sync seconds (EF_PASSES in
        # _quant_overhead, the int8→int8_ef upgrade) so its rows must
        # not cross-serve plain-int8 runs — extension-only keying:
        # sync_ef=off signatures stay byte-identical to caches written
        # before the flag existed (same discipline as search_key's
        # co_search marker)
        parts["sync_ef"] = True
    serving = getattr(cost_model, "serving", None)
    if serving is not None:
        # serve-objective rows price the decode ops' cache stream at
        # the arrival model's ragged quantile load — a different cost
        # surface per ServingSpec.  Extension-only: objective="train"
        # signatures stay byte-identical to every cache written before
        # the serving dimension existed
        parts["serving"] = list(serving.signature())
    return hashlib.sha256(
        json.dumps(parts, sort_keys=True).encode()).hexdigest()[:16]


def stable_graph_digest(graph) -> str:
    """Process-stable structural digest of a PCG (graph.hash() uses
    python tuple hashing, which PYTHONHASHSEED randomizes across
    processes — unusable as a persistent key).  Hashes the topo-ordered
    op signatures plus position-indexed edges.  InputOp signatures
    embed the frontend's GLOBAL tensor_guid counter (process-lifetime,
    build-order dependent); the digest replaces it with the input's
    rank of appearance, which carries the same distinctness.  Cached on
    the graph object (cleared by Graph._invalidate on mutation) — the
    persistent DP memo keys every tier-2 segment query by it."""
    cached = getattr(graph, "_stable_gd_cache", None)
    if cached is not None:
        return cached
    order = graph.topo_order()
    pos = {n.guid: i for i, n in enumerate(order)}
    # input-rank substitution lives in ONE place (the same rule keys
    # the per-node digests the dp/sp memo rows pair under)
    sigs = graph.stable_sig_reprs()
    h = hashlib.blake2b(digest_size=16)
    for node in order:
        h.update(sigs[node.guid].encode())
        for e in sorted(
            (pos[e.src], e.src_idx, e.dst_idx)
            for e in graph.in_edges[node.guid]
        ):
            h.update(repr(e).encode())
        h.update(b";")
    out = h.hexdigest()
    graph._stable_gd_cache = out
    return out


class CostCache:
    """One on-disk cache file (JSON rows + pickled search results in a
    sidecar), bound to a single cost ``signature``.  Load once per
    search/bench process; ``save()`` persists atomically when dirty."""

    def __init__(self, path: str, signature: str):
        self.path = path
        self.signature = signature
        self.rows: Dict[RowKey, Tuple[float, float, float, float]] = {}
        self.results: Dict[str, tuple] = {}
        # persisted tier-2 DP memo rows (dp-row layer): key string ->
        # {"cost": float, "strategy": [[node_digest, dims, replica,
        # start], ...]} — guid-free, remappable onto isomorphic
        # segments in any process (search/dp.py serves them).
        # ``dp_loaded`` marks rows that arrived FROM DISK: only those
        # are served — within one run the in-process DP memo already
        # covers anything this run wrote, so a cold cache stays inert
        # and the bit-identical regression gate holds
        self.dp_rows: Dict[str, dict] = {}
        self.dp_loaded = False
        # persisted comm-plan memo rows (comm-plan layer,
        # search/comm_plan.py): signature digest -> jsonable
        # CommPlanEntry.  Only consulted under FFConfig.co_search, so
        # the layer is inert on every sequential-pipeline run and the
        # bit-identical regression gate holds by construction.
        self.comm_plans: Dict[str, dict] = {}
        # persisted SP-SEGMENT memo rows (sp-row layer): key string ->
        # {"cost": float, "strategy": [[node_digest, dims, replica,
        # start], ...]} — whole series-parallel segment solves
        # (driver.sp_optimize) under guid-free stable digests.
        # ``sp_loaded`` marks rows FROM DISK: only those are served —
        # within one run the in-process segment cache already covers
        # this run's writes, so a cold cache stays inert and the chain
        # bit-identity gate holds.
        self.sp_rows: Dict[str, dict] = {}
        self.sp_loaded = False
        self.stale = False
        self.invalidated = False  # file existed with another signature
        self._dirty = False
        self.row_hits = 0
        self.row_misses = 0
        self.result_hits = 0
        self.result_misses = 0
        self.dp_row_hits = 0
        self.dp_row_misses = 0
        self.comm_plan_hits = 0
        self.comm_plan_misses = 0
        self.sp_row_hits = 0
        self.sp_row_misses = 0
        self._load()

    # ------------------------------------------------------------------
    @property
    def result_path(self) -> str:
        return self.path + ".results.pkl"

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            self.invalidated = True
            return
        if data.get("signature") != self.signature or \
                data.get("schema") != SCHEMA_VERSION:
            # wholesale invalidation: the cost surface moved (new
            # calibration, different machine/flags, or schema bump)
            self.invalidated = True
            return
        if data.get("calibration_stale"):
            # a measured DriftReport flagged the calibration this cache
            # was keyed by: refuse to serve anything derived from it
            self.stale = True
            print(
                "flexflow_tpu_torch cost cache: calibration flagged STALE by a "
                "measured drift report — recalibrate (--calibrate / "
                "bench_search.py --calibrate) or pass --no-cost-cache; "
                "refusing to serve cached rows",
                file=sys.stderr,
            )
            return
        for r in data.get("rows", []):
            self.rows[(r["sig"], tuple(r["degrees"]), int(r["replica"]))] = (
                tuple(float(x) for x in r["row"])
            )
        dp = data.get("dp_rows")
        if dp:
            if data.get("dp_schema") != DP_SCHEMA:
                # fail LOUD, not wrong: an unknown/missing dp sub-schema
                # means these memo rows were written by a different
                # layout — drop the layer (one recompute), keep the
                # still-valid row/result layers
                print(
                    f"flexflow_tpu_torch cost cache: persisted DP-memo rows "
                    f"carry unknown dp_schema "
                    f"{data.get('dp_schema')!r} (known: {DP_SCHEMA}) — "
                    f"dropping the dp-row layer; rows will be "
                    f"recomputed (run tools/fflint.py cache to "
                    f"inspect)",
                    file=sys.stderr,
                )
            elif isinstance(dp, dict):
                self.dp_rows = dp
                self.dp_loaded = True
        sp = data.get("sp_rows")
        if sp:
            if data.get("sp_schema") != SP_SCHEMA:
                # same fail-LOUD discipline as the dp layer: an unknown
                # sub-schema drops ONLY the sp-row layer (segments
                # re-solve, one recompute each), keeps the rest
                print(
                    f"flexflow_tpu_torch cost cache: persisted sp-segment memo "
                    f"rows carry unknown sp_schema "
                    f"{data.get('sp_schema')!r} (known: {SP_SCHEMA}) — "
                    f"dropping the sp-row layer; segments will be "
                    f"re-solved (run tools/fflint.py cache to inspect)",
                    file=sys.stderr,
                )
            elif isinstance(sp, dict):
                self.sp_rows = sp
                self.sp_loaded = True
        cp = data.get("comm_plans")
        if cp:
            if data.get("comm_schema") != COMM_SCHEMA:
                # same fail-LOUD discipline as the dp layer: unknown
                # layout drops only the comm-plan layer (one re-search
                # per signature), keeps row/result/dp layers intact
                print(
                    f"flexflow_tpu_torch cost cache: persisted comm-plan rows "
                    f"carry unknown comm_schema "
                    f"{data.get('comm_schema')!r} (known: {COMM_SCHEMA}) "
                    f"— dropping the comm-plan layer; plans will be "
                    f"re-searched (run tools/fflint.py cache to "
                    f"inspect)",
                    file=sys.stderr,
                )
            elif isinstance(cp, dict):
                self.comm_plans = cp
        if os.path.exists(self.result_path):
            try:
                with open(self.result_path, "rb") as f:
                    blob = pickle.load(f)
                if blob.get("signature") == self.signature:
                    self.results = blob.get("results", {})
            except Exception:
                # a corrupt/unreadable result sidecar only costs a
                # recompute, never a failure
                self.results = {}

    def save(self) -> None:
        if not self._dirty or self.stale:
            return
        # a drift check may have marked the ON-DISK file stale after we
        # loaded it (model.fit in this or another process): rewriting
        # would silently un-mark it and resurrect rows derived from a
        # flagged calibration table — honor the mark instead
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    if json.load(f).get("calibration_stale"):
                        self.stale = True
                        return
            except (OSError, ValueError):
                pass
        rows = [
            {"sig": k[0], "degrees": list(k[1]), "replica": k[2],
             "row": list(v)}
            for k, v in sorted(self.rows.items())
        ]
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {"schema": SCHEMA_VERSION, "signature": self.signature,
                 "calibration_stale": False, "rows": rows,
                 "dp_schema": DP_SCHEMA, "dp_rows": self.dp_rows,
                 "comm_schema": COMM_SCHEMA,
                 "comm_plans": self.comm_plans,
                 "sp_schema": SP_SCHEMA, "sp_rows": self.sp_rows},
                f,
            )
        os.replace(tmp, self.path)
        try:
            tmp = self.result_path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(
                    {"signature": self.signature, "results": self.results},
                    f, protocol=4,
                )
            os.replace(tmp, self.result_path)
        except Exception:
            # unpicklable payloads (exotic op attributes) degrade to a
            # row-only cache
            try:
                os.remove(tmp)
            except OSError:
                pass
        self._dirty = False

    # ---- row layer ----------------------------------------------------
    @staticmethod
    def row_key(op, mv) -> RowKey:
        return (
            repr(op.signature()),
            tuple(mv.dim_degrees),
            int(mv.replica_degree),
        )

    def get(self, op, mv) -> Optional[Tuple[float, float, float, float]]:
        if self.stale:
            return None
        hit = self.rows.get(self.row_key(op, mv))
        if hit is None:
            self.row_misses += 1
            _ROW_MISSES.inc()
            return None
        self.row_hits += 1
        _ROW_HITS.inc()
        return hit

    def put(self, op, mv, row: Tuple[float, float, float, float]) -> None:
        if self.stale:
            return
        if not all(isinstance(x, (int, float)) for x in row):
            return
        self.rows[self.row_key(op, mv)] = tuple(float(x) for x in row)
        self._dirty = True

    # ---- DP memo-row layer (tier-2 segment results) -------------------
    def get_dp_row(self, key: str) -> Optional[dict]:
        """The persisted tier-2 DP memo row for a (segment digest,
        fixed-view digest, budget, start) key, or None.  The payload is
        guid-free: ``strategy`` pairs process-stable node digests
        (Graph.stable_node_digests) with view tuples; search/dp.py
        remaps it onto the caller's guids."""
        if self.stale:
            return None
        hit = self.dp_rows.get(key)
        if hit is None:
            self.dp_row_misses += 1
            _DP_MISSES.inc()
            return None
        self.dp_row_hits += 1
        _DP_HITS.inc()
        return hit

    # ---- sp-segment memo-row layer (series-parallel segment solves) ---
    def get_sp_row(self, key: str) -> Optional[dict]:
        """The persisted sp-segment memo row for a (segment digest,
        boundary-pin digest, knobs) key, or None.  The payload is
        guid-free like the dp layer's; driver._serve_sp_row remaps it
        onto the caller's segment and re-lints before serving."""
        if self.stale:
            return None
        hit = self.sp_rows.get(key)
        if hit is None:
            self.sp_row_misses += 1
            _SP_MISSES.inc()
            return None
        self.sp_row_hits += 1
        _SP_HITS.inc()
        return hit

    # soft bound mirroring DP_MAX_ROWS — a 10k-node sweep over many
    # boundary tuples must not grow the file without limit
    SP_MAX_ROWS = 20000

    def put_sp_row(self, key: str, cost: float, strategy_rows) -> None:
        if self.stale or not math.isfinite(cost):
            return
        if key in self.sp_rows:
            return  # deterministic solve: first write wins
        if len(self.sp_rows) >= self.SP_MAX_ROWS:
            return
        self.sp_rows[key] = {"cost": float(cost),
                             "strategy": strategy_rows}
        self._dirty = True

    # ---- comm-plan memo layer (co-search, search/comm_plan.py) --------
    def get_comm_plan(self, key: str) -> Optional[dict]:
        """The persisted comm-plan row for a synced-group signature
        digest, or None.  The payload is the jsonable CommPlanEntry
        (schedule + precision map + zero map + credit); comm_plan.py
        validates it structurally and treats malformation as a miss."""
        if self.stale:
            return None
        hit = self.comm_plans.get(key)
        if hit is None:
            self.comm_plan_misses += 1
            _COMM_MISSES.inc()
            return None
        self.comm_plan_hits += 1
        _COMM_HITS.inc()
        return hit

    # soft bound mirroring DP_MAX_ROWS — a signature-rich sweep must
    # not grow the file without limit
    COMM_MAX_ROWS = 20000

    def put_comm_plan(self, key: str, payload: dict) -> None:
        if self.stale:
            return
        if key in self.comm_plans:
            return  # deterministic choice: first write wins
        if len(self.comm_plans) >= self.COMM_MAX_ROWS:
            return
        self.comm_plans[key] = payload
        self._dirty = True

    # soft bound on the persisted memo: a production sweep over many
    # large graphs must not grow COST_CACHE.json without limit — beyond
    # the cap new rows cost a recompute next run, nothing breaks
    DP_MAX_ROWS = 20000

    def put_dp_row(self, key: str, cost: float, strategy_rows) -> None:
        if self.stale or not math.isfinite(cost):
            return
        if key in self.dp_rows:
            return  # deterministic DP: first write wins, stays stable
        if len(self.dp_rows) >= self.DP_MAX_ROWS:
            return
        self.dp_rows[key] = {"cost": float(cost),
                             "strategy": strategy_rows}
        self._dirty = True

    # ---- search-result layer -----------------------------------------
    @staticmethod
    def search_key(graph, config) -> str:
        # custom substitution rules are part of the search function:
        # fingerprint the FILE CONTENT, not just its presence — edited
        # rules must not be shadowed by a result cached under old ones
        sub_digest = None
        if config.substitution_json:
            try:
                with open(config.substitution_json, "rb") as f:
                    sub_digest = hashlib.sha256(f.read()).hexdigest()[:12]
            except OSError:
                sub_digest = "unreadable"
        knobs = (
            config.search_devices, config.search_budget,
            config.search_alpha, config.base_optimize_threshold,
            config.search_improvement_margin,
            sub_digest,
        )
        if getattr(config, "co_search", False):
            # extension-only keying: a joint co-search result is a
            # different function value, but sequential-pipeline keys
            # must stay byte-identical to caches written before the
            # flag existed
            knobs = knobs + ("co_search",)
        if getattr(config, "objective", "train") == "serve":
            # the serve objective is a different search function (p99
            # currency + serving lint gate) — same extension-only rule
            knobs = knobs + (
                "serve",
                float(getattr(config, "serve_p99_budget_ms", 0.0) or 0.0),
            )
            if getattr(config, "serve_fleet", "off") == "search":
                # fleet searches price replica blocks at partial
                # occupancy (arrival shares) — a different search
                # function again.  Extension-only: serve_fleet=off
                # keys stay byte-identical to pre-fleet caches
                knobs = knobs + (
                    "fleet",
                    int(getattr(config, "serve_fleet_max_replicas", 4)),
                    float(getattr(config, "serve_fleet_offered_load",
                                  0.85)),
                )
            if getattr(config, "kv_precision", "off") != "off":
                # the KV-precision lane re-prices the decode cache
                # stream per pool dtype — a different search function.
                # Extension-only: kv_precision=off keys stay
                # byte-identical to pre-lane caches
                knobs = knobs + ("kv", config.kv_precision)
            if int(getattr(config, "serve_shared_prefix_pages", 0) or 0):
                # prefix sharing discounts KV residency (the memory
                # feasibility check), so results ranked under it must
                # not cross-serve unshared runs — same extension rule
                knobs = knobs + (
                    "kvshared",
                    int(config.serve_shared_prefix_pages),
                )
        return stable_graph_digest(graph) + ":" + hashlib.sha256(
            repr(knobs).encode()).hexdigest()[:12]

    def get_search_result(self, graph, config):
        """The stored search payload for (graph digest, knobs) under
        this cost surface, or None.  The payload shape is the driver's
        (orig_topo_guids, best_graph_or_None, strategy, cost)."""
        if self.stale:
            return None
        blob = self.results.get(self.search_key(graph, config))
        if blob is None:
            self.result_misses += 1
            _RESULT_MISSES.inc()
            return None
        try:
            payload = pickle.loads(blob)
        except Exception:
            self.result_misses += 1
            _RESULT_MISSES.inc()
            return None
        self.result_hits += 1
        _RESULT_HITS.inc()
        return payload

    def drop_search_result(self, graph, config) -> bool:
        """Evict the stored result for (graph, knobs) — the driver calls
        this when a served payload fails the static-analysis gate
        (corrupt pickle, illegal strategy), so a bad entry costs one
        recompute instead of being served forever.  Returns True when an
        entry was dropped."""
        key = self.search_key(graph, config)
        if key in self.results:
            del self.results[key]
            self._dirty = True
            return True
        return False

    def put_search_result(self, graph, config, payload,
                          cost: float) -> None:
        if self.stale or not math.isfinite(cost):
            return
        try:
            blob = pickle.dumps(payload, protocol=4)
        except Exception:
            return  # unpicklable op payloads: result layer declines
        self.results[self.search_key(graph, config)] = blob
        self._dirty = True


def load_for_simulator(config, sim) -> Optional[CostCache]:
    """Attach-or-None: resolve the configured path and bind a CostCache
    to the simulator's exact cost surface."""
    path = resolve_cost_cache_path(config)
    if path is None:
        return None
    cache = CostCache(path, cost_signature(sim.cost))
    sim.cost_cache = cache
    return cache


def mark_calibration_stale(path: str) -> bool:
    """Flip the on-disk ``calibration_stale`` flag — called when a
    measured DriftReport flags the calibration table (staleness
    must gate the cache, not just warn).  Returns
    True when a cache file was marked."""
    if not path or not os.path.exists(path):
        return False
    try:
        with open(path) as f:
            data = json.load(f)
        data["calibration_stale"] = True
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
        return True
    except (OSError, ValueError):
        return False
