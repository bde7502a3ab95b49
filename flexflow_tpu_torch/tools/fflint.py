#!/usr/bin/env python
"""fflint — static-analysis linter for flexflow_tpu_torch artifacts and
the rewrite registry (flexflow_tpu_torch/analysis as a CI-friendly CLI;
tools/fflint.py on the port, run as ``python -m
flexflow_tpu_torch.tools.fflint``).  Strategy and cost-cache files are
the JAX package's formats, so it lints either package's files.

Subcommands:

  fflint strategy FILE...     lint exported strategy files (STR2xx):
                              provenance digest present, views
                              well-formed — stdlib-only
  fflint cache FILE...        lint persistent cost-cache files (CCH4xx):
                              schema/signature shape, row
                              well-formedness, staleness — stdlib-only
  fflint registry [--devices N] [--substitution-json FILE]
                              prove the substitution registry: the
                              hand-zoo regression proof PLUS the
                              generative proof (analysis/proofgen.py —
                              proof graphs synthesized from each
                              rewrite's own anchor_types; EQV305 =
                              factory coverage hole, EQV306 = unproven
                              JSON rule).  Reports both passes'
                              wall-clock so the CI verification budget
                              stays a number.  Imports the package
                              and evaluates the proofs on --device
                              (default cuda; cpu where there is no
                              card)
  fflint all [--root DIR]     the CI entry point: lint every committed
                              COST_CACHE*.json / *strategy*.json under
                              DIR (default .) plus the full registry
  fflint pre-commit [--skip-registry]
                              the git hook gate: lint the STAGED
                              artifact files + prove the registry
                              (.githooks/pre-commit runs this; enable
                              with `git config core.hooksPath .githooks`)

Exit codes: 0 clean, 1 findings, 2 usage error.  ``--json`` switches
every subcommand to machine-readable output: one JSON object per line
(findings first, a ``{"summary": ...}`` object last) — the exit-code
contract is identical.  Artifact subcommands import nothing but the
standard library, so they run anywhere the files land (same discipline
as the ffobs tool).
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
from typing import List, Tuple

META_KEY = "__meta__"  # mirrors search/strategy_io.py (stdlib path)
CACHE_SCHEMA_VERSIONS = (1,)  # mirrors search/cost_cache.SCHEMA_VERSION
DP_SCHEMA_VERSIONS = (2,)  # mirrors search/cost_cache.DP_SCHEMA
COMM_SCHEMA_VERSIONS = (1,)  # mirrors search/cost_cache.COMM_SCHEMA
SP_SCHEMA_VERSIONS = (1,)  # mirrors search/cost_cache.SP_SCHEMA


def _load_json(path: str):
    try:
        with open(path) as f:
            return json.load(f), None
    except OSError as e:
        return None, f"unreadable: {e}"
    except ValueError as e:
        return None, f"not JSON: {e}"


# ---------------------------------------------------------------------------
# strategy files (stdlib)


def _calibration_digest(data) -> str:
    """Stdlib mirror of ``search/cost_cache.calibration_digest`` over a
    CALIBRATION.json payload: identical bytes hashed in identical order
    to what ``CalibrationTable.load`` + the package digest produce, so
    the STR210 comparison below proves the same signature the search
    keyed its caches (and the exported ``__meta__``) under."""
    import hashlib

    h = hashlib.sha256()
    h.update(repr(data.get("backend")).encode())
    records = {}
    for r in data.get("records", []):
        records[(r["sig"], tuple(r["degrees"]), int(r["replica"]))] = \
            float(r["seconds"])
    for k, v in sorted(records.items()):
        h.update(repr((k, v)).encode())
    clusters = {}
    for r in data.get("clusters", []):
        clusters[(tuple(r["sigs"]), tuple(r["degrees"]),
                  int(r["replica"]))] = float(r["seconds"])
    for k, v in sorted(clusters.items()):
        h.update(repr((k, v)).encode())
    return h.hexdigest()[:16]


def _lint_calibration_signature(meta, strategy_path: str,
                                calibration_path) -> List[Tuple[str, str, str]]:
    """STR210: a persisted ``__meta__.calibration_signature`` that no
    longer matches the LIVE calibration table is a STALE strategy —
    the cost surface it was ranked under has rotated (a re-probe, a
    drift fix) and the file's predicted numbers no longer describe this
    machine.  Warn, matching the import-side severity philosophy for
    provenance that is suspicious but not provably wrong."""
    sig = meta.get("calibration_signature")
    if not isinstance(sig, str) or not sig:
        return []
    if calibration_path is None:
        # default: the CALIBRATION.json living next to the strategy
        # file is "the live table" for that artifact set
        calibration_path = os.path.join(
            os.path.dirname(os.path.abspath(strategy_path)),
            "CALIBRATION.json")
    if not os.path.exists(calibration_path):
        return []
    data, err = _load_json(calibration_path)
    if err or not isinstance(data, dict):
        return [("warn", "STR210",
                 f"cannot check calibration_signature: live table "
                 f"{calibration_path} is unreadable ({err})")]
    try:
        live = _calibration_digest(data)
    except (KeyError, TypeError, ValueError) as e:
        # valid JSON, malformed rows: STR210 is warn-only by contract —
        # the hook must not traceback over a table the package itself
        # would refuse to load
        return [("warn", "STR210",
                 f"cannot check calibration_signature: live table "
                 f"{calibration_path} has malformed rows "
                 f"({type(e).__name__}: {e})")]
    if live != sig:
        return [("warn", "STR210",
                 f"STALE: exported under calibration signature {sig} "
                 f"but the live table ({calibration_path}) digests to "
                 f"{live} — the cost surface rotated since this "
                 f"strategy was searched; re-search or re-export")]
    return []


def lint_strategy_file(path: str,
                       calibration_path=None) -> List[Tuple[str, str, str]]:
    """(severity, code, message) findings for one exported strategy
    file.  Graph-side checks (digest match, coverage, view legality
    against the op) need the graph and run at import time
    (search/strategy_io.import_strategy) — this lints what a file alone
    can prove.  ``calibration_path`` pins the live CALIBRATION.json the
    STR210 staleness check compares against (default: the strategy
    file's sibling)."""
    data, err = _load_json(path)
    if err:
        return [("error", "STR200", err)]
    if not isinstance(data, dict):
        return [("error", "STR200", "top level is not a JSON object")]
    out: List[Tuple[str, str, str]] = []
    meta = data.get(META_KEY)
    if not isinstance(meta, dict) or not meta.get("graph_digest"):
        # warn, matching import_strategy's severity for the same code:
        # legacy pre-digest files import (with a warning), so they must
        # not fail CI either
        out.append((
            "warn", "STR203",
            "no __meta__.graph_digest — import cannot prove the file "
            "matches its target graph (re-export with this tree)"))
    if isinstance(meta, dict) and "sync_schedule" in meta:
        out += _lint_sync_schedule_meta(meta["sync_schedule"])
    if isinstance(meta, dict) and "zero_groups" in meta:
        out += _lint_zero_groups_meta(
            meta["zero_groups"],
            {k for k in data if k != META_KEY})
    if isinstance(meta, dict) and "placement" in meta:
        out += _lint_placement_meta(
            meta["placement"],
            {k: v for k, v in data.items() if k != META_KEY})
    if isinstance(meta, dict) and "pipeline" in meta:
        out += _lint_pipeline_meta(
            meta["pipeline"], {k for k in data if k != META_KEY})
    if isinstance(meta, dict) and "serving" in meta:
        out += _lint_serving_meta(meta["serving"])
    if isinstance(meta, dict) and "disaggregation" in meta:
        out += _lint_disagg_meta(meta["disaggregation"], meta)
    if isinstance(meta, dict) and "fleet" in meta:
        out += _lint_fleet_meta(meta["fleet"], meta)
    if isinstance(meta, dict) and "kv" in meta:
        out += _lint_kv_meta(meta["kv"], meta)
    if isinstance(meta, dict):
        out += _lint_calibration_signature(meta, path, calibration_path)
    views = {k: v for k, v in data.items() if k != META_KEY}
    if not views:
        out.append(("error", "STR202", "file names no ops at all"))
    for name, v in sorted(views.items()):
        if not isinstance(v, dict):
            out.append(("error", "STR204", f"op {name!r}: entry is not an "
                        "object"))
            continue
        dims = v.get("dims")
        # an empty dims list is legal: a scalar-output op's trivial view
        if (not isinstance(dims, list)
                or any(not isinstance(d, int) or d < 1 for d in dims)):
            out.append(("error", "STR204",
                        f"op {name!r}: malformed dims {dims!r}"))
        rep = v.get("replica", 1)
        if not isinstance(rep, int) or rep < 1:
            out.append(("error", "STR204",
                        f"op {name!r}: malformed replica {rep!r}"))
        start = v.get("start", 0)
        if not isinstance(start, int) or start < 0:
            out.append(("error", "STR204",
                        f"op {name!r}: malformed start {start!r}"))
    return out


_SCHEDULE_SCHEMA = 1  # mirrors search/sync_schedule.SCHEDULE_SCHEMA
_BUCKET_PRECISIONS = ("fp32", "bf16", "int8", "int8_ef")


def _lint_serving_meta(sv) -> List[Tuple[str, str, str]]:
    """STR209: structural lint of a persisted ``__meta__.serving``
    block (the serve-objective provenance, search/serving.py).
    Graph-side legality (frame-geometry coherence with the decode ops,
    KV residency vs HBM — SHD160-163) needs the graph + machine model
    and runs at import/compile time."""
    if not isinstance(sv, dict):
        return [("error", "STR209", "serving meta is not an object")]
    out: List[Tuple[str, str, str]] = []
    if sv.get("objective") != "serve":
        out.append(("error", "STR209",
                    f"serving meta objective {sv.get('objective')!r} is "
                    f"not 'serve'"))
    for k in ("max_seqs", "page_size", "pages_per_seq"):
        v = sv.get(k)
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            out.append(("error", "STR209",
                        f"serving meta {k} is not a positive int: {v!r}"))
    q = sv.get("quantile", 0.99)
    if not isinstance(q, (int, float)) or isinstance(q, bool) \
            or not (0.0 < float(q) < 1.0):
        out.append(("error", "STR209",
                    f"serving meta quantile {q!r} outside (0, 1)"))
    b = sv.get("p99_budget_ms", 0.0)
    if not isinstance(b, (int, float)) or isinstance(b, bool) \
            or float(b) < 0.0:
        out.append(("error", "STR209",
                    f"serving meta p99_budget_ms {b!r} is negative or "
                    f"non-numeric"))
    p99 = sv.get("predicted_p99_step_ms")
    if p99 is not None and (
            not isinstance(p99, (int, float)) or isinstance(p99, bool)
            or not math.isfinite(float(p99)) or float(p99) <= 0.0):
        out.append(("error", "STR209",
                    f"serving meta predicted_p99_step_ms {p99!r} is not "
                    f"a positive finite number"))
    kv = sv.get("kv_bytes_per_device")
    if kv is not None and (
            not isinstance(kv, (int, float)) or isinstance(kv, bool)
            or not math.isfinite(float(kv)) or float(kv) < 0.0):
        out.append(("error", "STR209",
                    f"serving meta kv_bytes_per_device {kv!r} is not a "
                    f"non-negative finite number"))
    return out


_KV_DTYPES = ("fp32", "bf16", "int8")


def _lint_kv_meta(kv, meta) -> List[Tuple[str, str, str]]:
    """STR213: structural lint of a persisted ``__meta__.kv`` block
    (the searched KV-precision + prefix-sharing provenance,
    search/driver.py ``_choose_kv_precision``).  Graph-side legality
    (dtype agreement with the decode ops' own attrs, refcount-factor
    coherence with the armed ServingSpec — SHD168/169) needs the graph
    and runs at import/compile time; this proves what the file alone
    can: a known pool dtype, the scale-layout discipline (int8 carries
    per-(page, slot) scales, fp32/bf16 carry none), sharing accounting
    coherent with itself and with the sibling ``__meta__.serving``
    frame, and finite per-dtype prices."""
    if not isinstance(kv, dict):
        return [("error", "STR213", "kv meta is not an object")]
    out: List[Tuple[str, str, str]] = []
    dt = kv.get("dtype")
    if dt not in _KV_DTYPES:
        out.append(("error", "STR213",
                    f"kv meta pool dtype {dt!r} is not one of "
                    f"{'/'.join(_KV_DTYPES)}"))
    layout = kv.get("scale_layout", "none")
    if dt == "int8" and layout != "page_slot":
        out.append(("error", "STR213",
                    f"int8 pool requires scale_layout 'page_slot', got "
                    f"{layout!r}"))
    if dt in ("fp32", "bf16") and layout not in ("none", None):
        out.append(("error", "STR213",
                    f"{dt} pool must not carry scales "
                    f"(scale_layout={layout!r})"))
    if not isinstance(kv.get("searched", False), bool):
        out.append(("error", "STR213",
                    f"kv meta searched flag is not a bool: "
                    f"{kv.get('searched')!r}"))
    shared = kv.get("shared_prefix_pages", 0)
    if not isinstance(shared, int) or isinstance(shared, bool) \
            or shared < 0:
        out.append(("error", "STR213",
                    f"kv meta shared_prefix_pages is not a "
                    f"non-negative int: {shared!r}"))
        shared = 0
    sv = meta.get("serving") if isinstance(meta, dict) else None
    pps = sv.get("pages_per_seq") if isinstance(sv, dict) else None
    mseq = sv.get("max_seqs") if isinstance(sv, dict) else None
    if isinstance(pps, int) and not isinstance(pps, bool) \
            and shared >= pps > 0:
        out.append(("error", "STR213",
                    f"kv meta shared_prefix_pages={shared} >= the "
                    f"sibling __meta__.serving pages_per_seq={pps} — a "
                    f"sequence cannot share its whole allotment (the "
                    f"last token's scatter needs a private page)"))
    factor = kv.get("shared_residency_factor", 1.0)
    if not isinstance(factor, (int, float)) or isinstance(factor, bool) \
            or not math.isfinite(float(factor)) \
            or not (0.0 < float(factor) <= 1.0):
        out.append(("error", "STR213",
                    f"kv meta shared_residency_factor {factor!r} "
                    f"outside (0, 1]"))
    elif shared == 0 and float(factor) != 1.0:
        out.append(("error", "STR213",
                    f"kv meta claims a residency discount "
                    f"(factor={factor!r}) with shared_prefix_pages=0 — "
                    f"sharing that prices but never happens is an OOM "
                    f"deferred"))
    elif (shared > 0 and isinstance(pps, int) and isinstance(mseq, int)
          and not isinstance(pps, bool) and not isinstance(mseq, bool)
          and mseq > 0 and pps > shared):
        expect = (mseq * (pps - shared) + shared) / float(mseq * pps)
        if abs(float(factor) - expect) > 1e-9:
            out.append(("error", "STR213",
                        f"kv meta shared_residency_factor {factor!r} "
                        f"does not match the refcount arithmetic for "
                        f"shared_prefix_pages={shared} over the sibling "
                        f"serving frame ({mseq}x{pps} pages): expected "
                        f"{expect:.9f}"))
    p99 = kv.get("predicted_p99_step_ms")
    if p99 is not None:
        if not isinstance(p99, dict):
            out.append(("error", "STR213",
                        f"kv meta predicted_p99_step_ms is not an "
                        f"object: {p99!r}"))
        else:
            for k, v in sorted(p99.items()):
                if k not in _KV_DTYPES:
                    out.append(("error", "STR213",
                                f"kv meta predicted_p99_step_ms keys an "
                                f"unknown dtype {k!r}"))
                if not isinstance(v, (int, float)) or isinstance(v, bool) \
                        or not math.isfinite(float(v)) or float(v) <= 0.0:
                    out.append(("error", "STR213",
                                f"kv meta predicted_p99_step_ms[{k!r}] "
                                f"{v!r} is not a positive finite number"))
            if dt in _KV_DTYPES and p99 and dt not in p99:
                out.append(("error", "STR213",
                            f"kv meta chose dtype {dt!r} but the priced "
                            f"map never priced it: "
                            f"{sorted(p99.keys())}"))
    b = kv.get("kv_bytes_per_device")
    if b is not None and (
            not isinstance(b, (int, float)) or isinstance(b, bool)
            or not math.isfinite(float(b)) or float(b) < 0.0):
        out.append(("error", "STR213",
                    f"kv meta kv_bytes_per_device {b!r} is not a "
                    f"non-negative finite number"))
    return out


def _lint_disagg_meta(dm, meta) -> List[Tuple[str, str, str]]:
    """STR211: structural lint of a persisted
    ``__meta__.disaggregation`` block (the searched prefill/decode
    two-block placement + SLO classes, search/disaggregation.py).
    Graph-side legality (pool-geometry agreement with the decode ops,
    the shared-parameter-set bridge — SHD164/165) needs the graph and
    runs at import/compile time; this proves what the file alone can:
    a coherent disjoint frame, a sane chunk, pool geometry that agrees
    with the sibling ``__meta__.serving`` block, finite prices, and a
    well-formed SLO-class table."""
    if not isinstance(dm, dict):
        return [("error", "STR211", "disaggregation meta is not an "
                 "object")]
    out: List[Tuple[str, str, str]] = []
    ints = {}
    for k in ("num_devices", "prefill_devices", "decode_devices",
              "chunk", "prefill_seq_len", "max_seqs", "page_size",
              "pages_per_seq"):
        v = dm.get(k)
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            out.append(("error", "STR211",
                        f"disaggregation meta {k} is not a positive "
                        f"int: {v!r}"))
        else:
            ints[k] = v
    if ("prefill_devices" in ints and "decode_devices" in ints
            and "num_devices" in ints
            and ints["prefill_devices"] + ints["decode_devices"]
            > ints["num_devices"]):
        out.append(("error", "STR211",
                    f"disaggregation blocks overflow: prefill "
                    f"{ints['prefill_devices']} + decode "
                    f"{ints['decode_devices']} devices on a "
                    f"{ints['num_devices']}-device machine"))
    sv = meta.get("serving") if isinstance(meta, dict) else None
    if isinstance(sv, dict):
        for k in ("max_seqs", "page_size", "pages_per_seq"):
            if k in ints and isinstance(sv.get(k), int) \
                    and sv[k] != ints[k]:
                out.append(("error", "STR211",
                            f"disaggregation meta {k}={ints[k]} "
                            f"disagrees with __meta__.serving "
                            f"{k}={sv[k]} — one page allocator must "
                            f"serve both sides of the handoff"))
    for k in ("colocated_step_ms", "disagg_step_ms", "handoff_ms",
              "prefill_tokens_per_frame"):
        v = dm.get(k)
        if v is not None and (
                not isinstance(v, (int, float)) or isinstance(v, bool)
                or not math.isfinite(float(v)) or float(v) < 0.0):
            out.append(("error", "STR211",
                        f"disaggregation meta {k} {v!r} is not a "
                        f"non-negative finite number"))
    classes = dm.get("slo_classes", [])
    if not isinstance(classes, list):
        return out + [("error", "STR211",
                       f"disaggregation meta slo_classes is not a "
                       f"list: {str(classes)[:60]}")]
    seen = set()
    for i, c in enumerate(classes):
        if not isinstance(c, dict) or not isinstance(c.get("name"), str) \
                or not c.get("name"):
            out.append(("error", "STR211",
                        f"slo_classes[{i}] is not a named class "
                        f"object"))
            continue
        if c["name"] in seen:
            out.append(("error", "STR211",
                        f"slo_classes[{i}] duplicates {c['name']!r}"))
        seen.add(c["name"])
        p = c.get("priority", 0)
        if not isinstance(p, int) or isinstance(p, bool):
            out.append(("error", "STR211",
                        f"slo class {c['name']!r} priority {p!r} is "
                        f"not an int"))
        df = c.get("deadline_frames", 0)
        if not isinstance(df, int) or isinstance(df, bool) or df < 0:
            out.append(("error", "STR211",
                        f"slo class {c['name']!r} deadline_frames "
                        f"{df!r} is not a non-negative int"))
        q = c.get("quantile", 0.99)
        if not isinstance(q, (int, float)) or isinstance(q, bool) \
                or not (0.0 < float(q) < 1.0):
            out.append(("error", "STR211",
                        f"slo class {c['name']!r} quantile {q!r} "
                        f"outside (0, 1)"))
    return out


def _lint_fleet_meta(fm, meta) -> List[Tuple[str, str, str]]:
    """STR212: structural lint of a persisted ``__meta__.fleet`` block
    (the searched N-replica serving fleet + per-SLO-class routing,
    search/fleet.py).  Graph-side legality (per-block view legality,
    pool-geometry agreement with the decode ops — SHD166/167) needs the
    graph and runs at import/compile time; this proves what the file
    alone can: disjoint replica blocks that fit the machine, replicas
    that actually carry a strategy, routing rows that sum to one over
    known classes, pool geometry that agrees with the sibling
    ``__meta__.serving`` block, and finite prices."""
    if not isinstance(fm, dict):
        return [("error", "STR212", "fleet meta is not an object")]
    out: List[Tuple[str, str, str]] = []
    n = fm.get("num_devices")
    if not isinstance(n, int) or isinstance(n, bool) or n < 1:
        out.append(("error", "STR212",
                    f"fleet meta num_devices is not a positive int: "
                    f"{n!r}"))
        n = None
    reps = fm.get("replicas")
    if not isinstance(reps, list) or not reps:
        return out + [("error", "STR212",
                       "fleet meta replicas is not a non-empty list")]
    spans = []
    for i, r in enumerate(reps):
        if not isinstance(r, dict):
            out.append(("error", "STR212",
                        f"replicas[{i}] is not an object"))
            continue
        ok = True
        for k in ("devices", "decode_devices"):
            v = r.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                out.append(("error", "STR212",
                            f"replicas[{i}] {k} is not a positive int: "
                            f"{v!r}"))
                ok = False
        for k in ("start", "prefill_devices"):
            v = r.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                out.append(("error", "STR212",
                            f"replicas[{i}] {k} is not a non-negative "
                            f"int: {v!r}"))
                ok = False
        if ok:
            pre, dec, dev = (r["prefill_devices"], r["decode_devices"],
                             r["devices"])
            if (pre + dec > dev) if pre else (dec != dev):
                out.append(("error", "STR212",
                            f"replicas[{i}] phase split prefill={pre} "
                            f"decode={dec} does not fit its "
                            f"{dev}-device block"))
            spans.append((r["start"], dev, i))
            if n is not None and r["start"] + dev > n:
                out.append(("error", "STR212",
                            f"replicas[{i}] overflows the machine: "
                            f"start {r['start']} + {dev} devices > "
                            f"{n}"))
        share = r.get("share")
        if not isinstance(share, (int, float)) or isinstance(share, bool) \
                or not math.isfinite(float(share)) \
                or not (0.0 <= float(share) <= 1.0):
            out.append(("error", "STR212",
                        f"replicas[{i}] share {share!r} outside "
                        f"[0, 1]"))
        for k in ("step_ms", "handoff_ms"):
            v = r.get(k)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or not math.isfinite(float(v)) or float(v) < 0.0:
                out.append(("error", "STR212",
                            f"replicas[{i}] {k} {v!r} is not a "
                            f"non-negative finite number"))
        ops = r.get("strategy_ops")
        if not isinstance(ops, int) or isinstance(ops, bool) or ops < 1:
            out.append(("error", "STR212",
                        f"replicas[{i}] carries no searched strategy "
                        f"(strategy_ops={ops!r}) — a replica without "
                        f"one cannot be deployed"))
    spans.sort()
    for (s0, w0, i0), (s1, w1, i1) in zip(spans, spans[1:]):
        if s0 + w0 > s1:
            out.append(("error", "STR212",
                        f"replicas[{i0}] and replicas[{i1}] overlap: "
                        f"[{s0}, {s0 + w0}) vs [{s1}, {s1 + w1})"))
    sv = meta.get("serving") if isinstance(meta, dict) else None
    if isinstance(sv, dict):
        for k in ("max_seqs", "page_size", "pages_per_seq"):
            fv = fm.get(k)
            if isinstance(fv, int) and isinstance(sv.get(k), int) \
                    and sv[k] != fv:
                out.append(("error", "STR212",
                            f"fleet meta {k}={fv} disagrees with "
                            f"__meta__.serving {k}={sv[k]} — every "
                            f"replica's page allocator must match the "
                            f"decode graph's frame"))
    for k in ("single_step_ms", "fleet_step_ms"):
        v = fm.get(k)
        if v is not None and (
                not isinstance(v, (int, float)) or isinstance(v, bool)
                or not math.isfinite(float(v)) or float(v) < 0.0):
            out.append(("error", "STR212",
                        f"fleet meta {k} {v!r} is not a non-negative "
                        f"finite number"))
    classes = fm.get("slo_classes", [])
    names = set()
    if not isinstance(classes, list):
        out.append(("error", "STR212",
                    f"fleet meta slo_classes is not a list: "
                    f"{str(classes)[:60]}"))
        classes = []
    for i, c in enumerate(classes):
        if not isinstance(c, dict) or not isinstance(c.get("name"), str) \
                or not c.get("name"):
            out.append(("error", "STR212",
                        f"slo_classes[{i}] is not a named class "
                        f"object"))
            continue
        if c["name"] in names:
            out.append(("error", "STR212",
                        f"slo_classes[{i}] duplicates {c['name']!r}"))
        names.add(c["name"])
        w = c.get("weight", 1.0)
        if not isinstance(w, (int, float)) or isinstance(w, bool) \
                or not math.isfinite(float(w)) or float(w) <= 0.0:
            out.append(("error", "STR212",
                        f"slo class {c['name']!r} weight {w!r} is not "
                        f"a positive finite number"))
    routing = fm.get("routing")
    if not isinstance(routing, dict) or not routing:
        return out + [("error", "STR212",
                       "fleet meta routing is not a non-empty object")]
    for cname, row in sorted(routing.items()):
        if names and cname not in names:
            out.append(("error", "STR212",
                        f"routing names unknown SLO class {cname!r}"))
        if not isinstance(row, list) or len(row) != len(reps):
            out.append(("error", "STR212",
                        f"routing[{cname!r}] is not a "
                        f"{len(reps)}-replica fraction row: {row!r}"))
            continue
        bad = [f for f in row
               if not isinstance(f, (int, float)) or isinstance(f, bool)
               or not math.isfinite(float(f))
               or not (0.0 <= float(f) <= 1.0)]
        if bad:
            out.append(("error", "STR212",
                        f"routing[{cname!r}] has fractions outside "
                        f"[0, 1]: {bad!r}"))
            continue
        total = sum(float(f) for f in row)
        if abs(total - 1.0) > 1e-3:
            out.append(("error", "STR212",
                        f"routing[{cname!r}] fractions sum to "
                        f"{total:.6f}, not 1"))
    for cname in sorted(names - set(routing)):
        out.append(("error", "STR212",
                    f"SLO class {cname!r} has no routing row — its "
                    f"requests would route nowhere"))
    return out


def _lint_zero_groups_meta(zg, op_names) -> List[Tuple[str, str, str]]:
    """STR207: structural lint of a persisted ``__meta__.zero_groups``
    map (the co-searched per-group optimizer-state sharding,
    search/comm_plan.py).  Graph-side legality (the op actually syncs,
    the shard factor is achievable — SHD140/141) needs the graph and
    runs at import/compile time; this proves what the file alone can:
    a list of unique op names the file itself covers."""
    out: List[Tuple[str, str, str]] = []
    if not isinstance(zg, list):
        return [("error", "STR207", "zero_groups is not a list")]
    if not zg:
        out.append(("error", "STR207",
                    "zero_groups is empty — an empty map is persisted "
                    "as ABSENT, so an empty list is a writer bug"))
    seen = set()
    for i, name in enumerate(zg):
        if not isinstance(name, str) or not name:
            out.append(("error", "STR207",
                        f"zero_groups[{i}] is not an op name: {name!r}"))
            continue
        if name in seen:
            out.append(("error", "STR207",
                        f"zero_groups[{i}] duplicates {name!r}"))
        seen.add(name)
        if name not in op_names:
            out.append(("error", "STR207",
                        f"zero_groups[{i}] names op {name!r} the "
                        f"strategy file does not cover"))
    return out


def _view_parts(v) -> int:
    """Total parts of a strategy-file view entry (product of dim
    degrees x replica) — 0 when the entry is malformed (STR204 owns
    that failure)."""
    dims = v.get("dims") if isinstance(v, dict) else None
    rep = v.get("replica", 1) if isinstance(v, dict) else None
    if (not isinstance(dims, list)
            or any(not isinstance(d, int) or d < 1 for d in dims)
            or not isinstance(rep, int) or rep < 1):
        return 0
    parts = rep
    for d in dims:
        parts *= d
    return parts


def _lint_placement_meta(pm, views) -> List[Tuple[str, str, str]]:
    """STR208: structural lint of a persisted ``__meta__.placement``
    block (the 2-block device frame a placed proposal executes under,
    analysis/placement.py).  Graph-side legality (cut shape, sink
    ownership, crossing tensors — SHD153-155) needs the graph and runs
    at proposal/import time; this proves what the file alone can: a
    coherent disjoint 2-block frame that the file's own start_part
    views actually inhabit."""
    out: List[Tuple[str, str, str]] = []
    if not isinstance(pm, dict):
        return [("error", "STR208", "placement meta is not an object")]
    n = pm.get("num_devices")
    if not isinstance(n, int) or n < 2:
        out.append(("error", "STR208",
                    f"placement meta has malformed num_devices {n!r}"))
        n = None
    blocks = pm.get("blocks")
    ok_blocks = (
        isinstance(blocks, list) and len(blocks) == 2
        and all(isinstance(b, list) and len(b) == 2
                and all(isinstance(x, int) and x >= 0 for x in b)
                and b[1] >= 1 for b in blocks)
    )
    if not ok_blocks:
        return out + [("error", "STR208",
                       f"placement meta needs exactly 2 [start, parts] "
                       f"blocks, got {str(blocks)[:80]}")]
    (s0, p0), (s1, p1) = blocks
    if s0 != 0:
        out.append(("error", "STR208",
                    f"placement block A starts at device {s0}, not 0"))
    if s1 < s0 + p0:
        out.append(("error", "STR208",
                    f"placement blocks overlap: A spans [0, {p0}) but B "
                    f"starts at {s1}"))
    if n is not None and s1 + p1 > n:
        out.append(("error", "STR208",
                    f"placement blocks overflow: B spans [{s1}, "
                    f"{s1 + p1}) on a {n}-device machine"))
    starts = {s0, s1}
    for name, v in sorted(views.items()):
        sv = v.get("start", 0) if isinstance(v, dict) else 0
        if sv not in starts:
            out.append(("error", "STR208",
                        f"op {name!r} starts at device {sv!r}, outside "
                        f"the declared blocks {sorted(starts)}"))
            continue
        cap = p0 if sv == s0 else p1
        parts = _view_parts(v)
        if parts > cap:
            out.append(("error", "STR208",
                        f"op {name!r} needs {parts} parts but its block "
                        f"at device {sv} spans only {cap}"))
    return out


def _lint_pipeline_meta(pm, op_names) -> List[Tuple[str, str, str]]:
    """STR208: structural lint of a persisted ``__meta__.pipeline``
    block (a staged proposal's S x M frame + optional explicit stage
    cut, analysis/placement.py).  Graph-side legality (coverage vs the
    actual graph, boundary-edge coherence — SHD150-152) runs at
    proposal/import time."""
    out: List[Tuple[str, str, str]] = []
    if not isinstance(pm, dict):
        return [("error", "STR208", "pipeline meta is not an object")]
    s = pm.get("num_stages")
    m = pm.get("num_microbatches")
    if not isinstance(s, int) or s < 2:
        out.append(("error", "STR208",
                    f"pipeline meta has malformed num_stages {s!r} "
                    f"(need an int >= 2)"))
        s = None
    if not isinstance(m, int) or m < 1 or (s is not None and m < s):
        out.append(("error", "STR208",
                    f"pipeline meta has malformed num_microbatches "
                    f"{m!r} (need an int >= num_stages)"))
    stages = pm.get("stages")
    if stages is None:
        return out
    if not isinstance(stages, list) or (
            s is not None and len(stages) != s):
        return out + [("error", "STR208",
                       f"pipeline meta declares num_stages {s!r} but "
                       f"carries {len(stages) if isinstance(stages, list) else stages!r} stage lists")]
    seen = set()
    for i, stage in enumerate(stages):
        if not isinstance(stage, list) or not stage:
            out.append(("error", "STR208",
                        f"pipeline meta stages[{i}] is empty or not a "
                        f"list"))
            continue
        for op in stage:
            if not isinstance(op, str) or not op:
                out.append(("error", "STR208",
                            f"pipeline meta stages[{i}] has a non-name "
                            f"entry {op!r}"))
                continue
            if op in seen:
                out.append(("error", "STR208",
                            f"pipeline meta covers op {op!r} twice — it "
                            f"would run twice per tick"))
            seen.add(op)
            if op not in op_names:
                out.append(("error", "STR208",
                            f"pipeline meta stages[{i}] names op {op!r} "
                            f"the strategy file does not cover"))
    return out


def _lint_sync_schedule_meta(sched) -> List[Tuple[str, str, str]]:
    """STR205: structural lint of a persisted ``__meta__.sync_schedule``
    (the searched comm plan, search/sync_schedule.py).  Graph-side
    legality (coverage, issue order vs readiness, precision coherence —
    SHD12x) needs the graph and runs at import/compile time."""
    out: List[Tuple[str, str, str]] = []
    if not isinstance(sched, dict):
        return [("error", "STR205", "sync_schedule is not an object")]
    if sched.get("schema") != _SCHEDULE_SCHEMA:
        out.append(("error", "STR205",
                    f"sync_schedule schema {sched.get('schema')!r} unknown "
                    f"(known: {_SCHEDULE_SCHEMA})"))
    buckets = sched.get("buckets")
    if not isinstance(buckets, list) or not buckets:
        return out + [("error", "STR205", "sync_schedule has no buckets")]
    seen_ops = set()
    for i, b in enumerate(buckets):
        if not isinstance(b, dict):
            out.append(("error", "STR205",
                        f"sync_schedule buckets[{i}] is not an object"))
            continue
        if not isinstance(b.get("name"), str) or not b.get("name"):
            out.append(("error", "STR205",
                        f"sync_schedule buckets[{i}] has no name"))
        if b.get("precision", "fp32") not in _BUCKET_PRECISIONS:
            out.append(("error", "STR205",
                        f"sync_schedule buckets[{i}] precision "
                        f"{b.get('precision')!r} unknown"))
        ops = b.get("ops")
        if (not isinstance(ops, list) or not ops
                or any(not isinstance(o, str) for o in ops)):
            out.append(("error", "STR205",
                        f"sync_schedule buckets[{i}] has malformed ops "
                        f"{str(ops)[:80]}"))
            continue
        for o in ops:
            if o in seen_ops:
                out.append(("error", "STR205",
                            f"sync_schedule covers op {o!r} twice — its "
                            f"gradient would sync twice"))
            seen_ops.add(o)
        if b.get("plan") is not None:
            out += _lint_reduction_plan_meta(b["plan"], i)
    return out


_PLAN_STAGE_KINDS = ("reduce_scatter", "allreduce", "all_gather")
# mirrors search/reduction_plan.STAGE_KINDS (stdlib path)


def _lint_reduction_plan_meta(plan, bi: int) -> List[Tuple[str, str, str]]:
    """STR206: structural lint of a persisted per-bucket reduction plan
    (the staged hierarchical comm shape, search/reduction_plan.py).
    Machine-side legality (level coverage vs the topology the groups
    span — SHD13x) needs the graph + machine model and runs at
    import/compile time."""
    where = f"sync_schedule buckets[{bi}] plan"
    out: List[Tuple[str, str, str]] = []
    if not isinstance(plan, dict):
        return [("error", "STR206", f"{where} is not an object")]
    if not isinstance(plan.get("name"), str) or not plan.get("name"):
        out.append(("error", "STR206", f"{where} has no name"))
    stages = plan.get("stages")
    if not isinstance(stages, list) or not stages:
        return out + [("error", "STR206", f"{where} has no stages")]
    ar_levels = []
    for j, s in enumerate(stages):
        if not isinstance(s, dict):
            out.append(("error", "STR206",
                        f"{where} stages[{j}] is not an object"))
            continue
        kind = s.get("kind")
        if kind not in _PLAN_STAGE_KINDS:
            out.append(("error", "STR206",
                        f"{where} stages[{j}] kind {kind!r} unknown "
                        f"(known: {list(_PLAN_STAGE_KINDS)})"))
        level = s.get("level")
        if not isinstance(level, int) or level < 0:
            out.append(("error", "STR206",
                        f"{where} stages[{j}] malformed level {level!r}"))
        prec = s.get("precision", "fp32")
        if prec not in _BUCKET_PRECISIONS:
            out.append(("error", "STR206",
                        f"{where} stages[{j}] precision {prec!r} unknown"))
        elif kind != "allreduce" and prec != "fp32":
            out.append(("error", "STR206",
                        f"{where} stages[{j}] compresses a {kind} stage "
                        f"— only the cross-level allreduce may"))
        if kind == "allreduce":
            ar_levels.append(level)
    if len(ar_levels) != 1:
        out.append(("error", "STR206",
                    f"{where} must have exactly one cross-level "
                    f"allreduce stage (found {len(ar_levels)})"))
    return out


# ---------------------------------------------------------------------------
# cost-cache files (stdlib)


def lint_cache_file(path: str) -> List[Tuple[str, str, str]]:
    data, err = _load_json(path)
    if err:
        return [("error", "CCH400", err)]
    if not isinstance(data, dict):
        return [("error", "CCH400", "top level is not a JSON object")]
    out: List[Tuple[str, str, str]] = []
    if data.get("schema") not in CACHE_SCHEMA_VERSIONS:
        out.append(("error", "CCH401",
                    f"unknown schema {data.get('schema')!r} (known: "
                    f"{list(CACHE_SCHEMA_VERSIONS)})"))
    sig = data.get("signature")
    if (not isinstance(sig, str) or len(sig) != 16
            or any(c not in "0123456789abcdef" for c in sig)):
        out.append(("error", "CCH401",
                    f"malformed cost-surface signature {sig!r} (expect 16 "
                    "hex chars)"))
    if data.get("calibration_stale"):
        out.append(("warn", "CCH403",
                    "calibration_stale is set: the cache refuses to serve "
                    "until recalibration (drift gate, obs/drift.py)"))
    rows = data.get("rows", [])
    if not isinstance(rows, list):
        return out + [("error", "CCH402", "rows is not a list")]
    seen = set()
    for i, r in enumerate(rows):
        ok = (
            isinstance(r, dict)
            and isinstance(r.get("sig"), str)
            and isinstance(r.get("degrees"), list)
            and all(isinstance(d, int) and d >= 1 for d in r["degrees"])
            and isinstance(r.get("replica"), int) and r["replica"] >= 1
            and isinstance(r.get("row"), list) and len(r["row"]) == 4
            and all(isinstance(x, (int, float)) and math.isfinite(x)
                    and x >= 0 for x in r["row"])
        )
        if not ok:
            out.append(("error", "CCH402", f"rows[{i}] malformed: "
                        f"{str(r)[:120]}"))
            continue
        key = (r["sig"], tuple(r["degrees"]), r["replica"])
        if key in seen:
            out.append(("error", "CCH402",
                        f"rows[{i}] duplicates key for degrees "
                        f"{r['degrees']} replica {r['replica']}"))
        seen.add(key)
    sidecar = path + ".results.pkl"
    if os.path.exists(sidecar) and os.path.getsize(sidecar) == 0:
        out.append(("error", "CCH404", f"empty results sidecar {sidecar}"))
    out += _lint_dp_rows(data)
    out += _lint_sp_rows(data)
    out += _lint_comm_plans(data)
    return out


def _lint_digest_row_layer(data, rows_key, schema_key, versions,
                           code_schema, code_row,
                           ) -> List[Tuple[str, str, str]]:
    """Shared shape lint for the digest-keyed memo-row layers — the
    dp-row layer (tier-2 segment strategies) and the sp-row layer
    (whole series-parallel segment solves) persist the SAME row layout:
    ``{"cost": float, "strategy": [[hex digest, degrees, replica,
    start], ...]}`` under '<graph digest>:<pin/knob digest>' keys.  An
    unknown sub-schema is the DISTINCT loud-drop error; malformed rows
    get the layer's row code."""
    layer = data.get(rows_key)
    if layer is None:
        return []
    out: List[Tuple[str, str, str]] = []
    if data.get(schema_key) not in versions:
        out.append(("error", code_schema,
                    f"{rows_key} present but {schema_key} "
                    f"{data.get(schema_key)!r} unknown (known: "
                    f"{list(versions)}) — the loader will drop "
                    f"the whole {rows_key} layer"))
    if not isinstance(layer, dict):
        return out + [("error", code_row,
                       f"{rows_key} is not an object")]
    for key, row in sorted(layer.items()):
        where = f"{rows_key}[{key[:32]}...]" if len(key) > 32 else \
            f"{rows_key}[{key}]"
        if not isinstance(key, str) or ":" not in key:
            out.append(("error", code_row,
                        f"{where}: malformed key (expect "
                        f"'<graph digest>:<pin/knob digest>')"))
        if not isinstance(row, dict):
            out.append(("error", code_row, f"{where}: row is not an "
                        "object"))
            continue
        cost = row.get("cost")
        if not isinstance(cost, (int, float)) or not math.isfinite(cost) \
                or cost < 0:
            out.append(("error", code_row,
                        f"{where}: malformed cost {cost!r}"))
        strat = row.get("strategy")
        if not isinstance(strat, list) or not strat:
            out.append(("error", code_row, f"{where}: no strategy rows"))
            continue
        for j, entry in enumerate(strat):
            ok = (
                isinstance(entry, list) and len(entry) == 4
                and isinstance(entry[0], str) and entry[0]
                and all(c in "0123456789abcdef" for c in entry[0])
                and isinstance(entry[1], list)
                and all(isinstance(d, int) and d >= 1 for d in entry[1])
                and isinstance(entry[2], int) and entry[2] >= 1
                and isinstance(entry[3], int) and entry[3] >= 0
            )
            if not ok:
                out.append(("error", code_row,
                            f"{where}: strategy[{j}] malformed: "
                            f"{str(entry)[:100]}"))
    return out


def _lint_dp_rows(data) -> List[Tuple[str, str, str]]:
    """CCH405/406: the persisted DP-memo-row layer (search/cost_cache.py
    dp_rows — tier-2 segment strategies under process-stable digests).
    An unknown ``dp_schema`` is a DISTINCT error (CCH405): the loader
    drops the layer loudly rather than serving rows written under
    another layout; malformed rows are CCH406."""
    return _lint_digest_row_layer(
        data, "dp_rows", "dp_schema", DP_SCHEMA_VERSIONS,
        "CCH405", "CCH406")


def _lint_sp_rows(data) -> List[Tuple[str, str, str]]:
    """CCH409/410: the persisted SP-SEGMENT memo-row layer
    (search/cost_cache.py sp_rows — whole series-parallel segment
    solves keyed by segment digest + boundary-view-tuple pins + search
    knobs, driver._persist_sp_row).  Same row layout and fail-LOUD
    discipline as the dp layer: unknown ``sp_schema`` is CCH409 (the
    loader drops the layer, segments re-solve), malformed rows are
    CCH410 (the in-process reader treats them as a miss — one
    re-solve, never a wrong stamped strategy)."""
    return _lint_digest_row_layer(
        data, "sp_rows", "sp_schema", SP_SCHEMA_VERSIONS,
        "CCH409", "CCH410")


def _lint_comm_plans(data) -> List[Tuple[str, str, str]]:
    """CCH407/408: the persisted comm-plan memo layer
    (search/cost_cache.py ``comm_plans`` — the co-search's chosen sync
    schedules/precision maps/zero choices per synced-group signature,
    search/comm_plan.py).  An unknown ``comm_schema`` is a DISTINCT
    error (CCH407): the loader drops the layer loudly rather than
    serving plans written under another layout; malformed rows are
    CCH408 (the in-process reader treats them as a miss — one
    re-search, never a wrong plan)."""
    cp = data.get("comm_plans")
    if cp is None:
        return []
    out: List[Tuple[str, str, str]] = []
    if data.get("comm_schema") not in COMM_SCHEMA_VERSIONS:
        out.append(("error", "CCH407",
                    f"comm_plans present but comm_schema "
                    f"{data.get('comm_schema')!r} unknown (known: "
                    f"{list(COMM_SCHEMA_VERSIONS)}) — the loader will "
                    f"drop the whole comm-plan layer"))
    if not isinstance(cp, dict):
        return out + [("error", "CCH408", "comm_plans is not an object")]
    for key, row in sorted(cp.items()):
        where = f"comm_plans[{key[:32]}...]" if len(key) > 32 else \
            f"comm_plans[{key}]"
        if (not isinstance(key, str) or len(key) != 24
                or any(c not in "0123456789abcdef" for c in key)):
            out.append(("error", "CCH408",
                        f"{where}: malformed key (expect a 24-hex-char "
                        f"signature digest)"))
        if not isinstance(row, dict):
            out.append(("error", "CCH408",
                        f"{where}: row is not an object"))
            continue
        sched = row.get("schedule")
        if not isinstance(sched, dict):
            out.append(("error", "CCH408", f"{where}: no schedule"))
        else:
            for sev, _code, msg in _lint_sync_schedule_meta(sched):
                out.append((sev, "CCH408", f"{where}: {msg}"))
        if not isinstance(row.get("adopted"), bool):
            out.append(("error", "CCH408",
                        f"{where}: malformed adopted "
                        f"{row.get('adopted')!r}"))
        pmap = row.get("pmap", {})
        if (not isinstance(pmap, dict)
                or any(not isinstance(k, str) or v not in
                       _BUCKET_PRECISIONS for k, v in pmap.items())):
            out.append(("error", "CCH408",
                        f"{where}: malformed pmap {str(pmap)[:80]}"))
        zero = row.get("zero", [])
        if (not isinstance(zero, list)
                or any(not isinstance(z, str) or not z for z in zero)):
            out.append(("error", "CCH408",
                        f"{where}: malformed zero list "
                        f"{str(zero)[:80]}"))
        credit = row.get("credit", 0.0)
        if (not isinstance(credit, (int, float))
                or not math.isfinite(credit) or credit < 0):
            out.append(("error", "CCH408",
                        f"{where}: malformed credit {credit!r}"))
    return out


# ---------------------------------------------------------------------------
# rewrite registry (imports flexflow_tpu_torch; the proofs run on a device)


def lint_registry(num_devices: int, substitution_json: str = "",
                  device: str = "cuda",
                  ) -> Tuple[List[Tuple[str, str, str]], dict]:
    """(findings, info) for the registry proof: the hand-zoo pass (the
    regression anchor) over the factory xfers, then the GENERATIVE
    pass (analysis/proofgen.py) over factory + any JSON rules —
    factory xfers must anchor on generated graphs (EQV305 closed by
    construction), unproven JSON rules are listed as EQV306.  ``info``
    carries both passes' wall-clock (the CI verification budget) and
    the generation stats.  Every proof evaluates on ``device``."""
    import time as _time

    from flexflow_tpu_torch.analysis.equivalence import verify_registry
    from flexflow_tpu_torch.analysis.proofgen import verify_registry_generated
    from flexflow_tpu_torch.search.substitution import generate_all_pcg_xfers

    factory = generate_all_pcg_xfers(num_devices)
    t0 = _time.perf_counter()
    findings = list(verify_registry(num_devices=num_devices,
                                    xfers=factory, device=device))
    t_zoo = _time.perf_counter() - t0
    xfers = list(factory)
    if substitution_json:
        from flexflow_tpu_torch.search.substitution_loader import (
            load_substitution_json,
        )

        xfers += load_substitution_json(substitution_json)
    t0 = _time.perf_counter()
    gen_findings, stats = verify_registry_generated(
        num_devices=num_devices, xfers=xfers, device=device)
    t_gen = _time.perf_counter() - t0
    findings += gen_findings
    info = {
        "zoo_seconds": round(t_zoo, 3),
        "proofgen_seconds": round(t_gen, 3),
        "xfers": stats["xfers"],
        "graphs_generated": stats["graphs_generated"],
        "proofs": stats["proofs"],
        "lanes": stats["lanes"],
        "unproven": stats["unproven"],
    }
    return ([(f.severity, f.code, f.message) for f in findings], info)


# ---------------------------------------------------------------------------


def _report(path: str, findings: List[Tuple[str, str, str]],
            as_json: bool = False) -> int:
    errors = 0
    for sev, code, msg in findings:
        if as_json:
            # machine-readable contract: one JSON object per finding
            # line (exit codes unchanged — CI keys on both)
            print(json.dumps({"path": path, "severity": sev,
                              "code": code, "msg": msg}))
        else:
            print(f"{path}: {sev.upper()} [{code}] {msg}")
        if sev == "error":
            errors += 1
    return errors


def _summary(args, text: str, **payload) -> None:
    if getattr(args, "json", False):
        print(json.dumps({"summary": True, "cmd": args.cmd, **payload}))
    else:
        print(text)


def cmd_strategy(args) -> int:
    errors = 0
    for path in args.files:
        errors += _report(
            path,
            lint_strategy_file(
                path, calibration_path=getattr(args, "calibration", None)),
            args.json)
    _summary(args,
             f"fflint strategy: {len(args.files)} file(s), {errors} "
             f"error(s)", files=len(args.files), errors=errors)
    return 1 if errors else 0


def cmd_cache(args) -> int:
    errors = 0
    for path in args.files:
        errors += _report(path, lint_cache_file(path), args.json)
    _summary(args,
             f"fflint cache: {len(args.files)} file(s), {errors} "
             f"error(s)", files=len(args.files), errors=errors)
    return 1 if errors else 0


def cmd_registry(args) -> int:
    findings, info = lint_registry(
        args.devices, getattr(args, "substitution_json", "") or "",
        args.device)
    errors = _report("registry", findings, args.json)
    _summary(
        args,
        f"fflint registry: {args.devices}-device rewrite registry, "
        f"{errors} error(s)\n"
        f"  zoo proof {info['zoo_seconds']}s; generative proof "
        f"{info['proofgen_seconds']}s — {info['proofs']} proofs over "
        f"{info['graphs_generated']} generated graphs "
        f"({info['xfers']} xfers, lanes {info['lanes']}, "
        f"{info['unproven']} unproven)",
        errors=errors, **info)
    return 1 if errors else 0


def _staged_blobs(root: str, tmpdir: str) -> Optional[List[Tuple[str, str]]]:
    """``(repo-relative path, staged-blob temp file under tmpdir)`` for
    every artifact path staged for commit, or None when git is
    unavailable / not a repository — pre-commit then lints the whole
    tree like ``all``.  The lint must read the STAGED content
    (``git show :path``), not the working tree: a file fixed after
    ``git add`` would otherwise let the corrupt staged blob land (and
    vice versa)."""
    import subprocess

    try:
        proc = subprocess.run(
            ["git", "diff", "--cached", "--name-only", "--diff-filter=d"],
            cwd=root, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    out: List[Tuple[str, str]] = []
    for rel in proc.stdout.splitlines():
        if not rel or not rel.endswith(".json"):
            continue
        base = os.path.basename(rel)
        if not (base.startswith("COST_CACHE") or "strategy" in base.lower()):
            continue
        blob = subprocess.run(
            ["git", "show", f":{rel}"], cwd=root, capture_output=True,
            timeout=30)
        if blob.returncode != 0:
            continue
        # mirror the repo-relative path: same-basename artifacts in
        # different directories must not overwrite each other's blobs
        tmp = os.path.join(tmpdir, rel)
        os.makedirs(os.path.dirname(tmp) or tmpdir, exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(blob.stdout)
        out.append((rel, tmp))
    return out


def cmd_precommit(args) -> int:
    """The git pre-commit gate: lint the STAGED artifact blobs (cost
    caches / strategy files — stdlib, fast) and prove the rewrite
    registry (``fflint registry`` — imports the package).
    Install via the committed hook file:

        git config core.hooksPath .githooks

    Skip once with ``git commit --no-verify``; skip the slow registry
    proof with ``--skip-registry`` (artifact lints still run)."""
    import tempfile

    errors = 0
    # the staged blobs live in one throwaway dir — the hook runs on
    # every commit, so leaking it would accumulate unboundedly
    with tempfile.TemporaryDirectory(prefix="fflint_staged_") as tmpdir:
        staged = _staged_blobs(args.root, tmpdir)
        if staged is None:
            print("fflint pre-commit: no git staging info — linting the "
                  "whole tree")
            staged = [
                (p, p) for p in sorted(glob.glob(
                    os.path.join(args.root, "**", "*.json"),
                    recursive=True))
                if os.path.basename(p).startswith("COST_CACHE")
                or "strategy" in os.path.basename(p).lower()
            ]
        caches = [(rel, p) for rel, p in staged
                  if os.path.basename(rel).startswith("COST_CACHE")]
        strategies = [(rel, p) for rel, p in staged
                      if "strategy" in os.path.basename(rel).lower()]
        for rel, path in caches:
            errors += _report(rel, lint_cache_file(path), args.json)
        for rel, path in strategies:
            # the staged blob lives in the temp mirror, but its "live
            # CALIBRATION.json sibling" (STR210) is the one in the repo
            errors += _report(
                rel,
                lint_strategy_file(path, calibration_path=os.path.join(
                    args.root, os.path.dirname(rel), "CALIBRATION.json")),
                args.json)
    if not args.skip_registry:
        findings, _info = lint_registry(args.devices, device=args.device)
        errors += _report("registry", findings, args.json)
    _summary(args,
             f"fflint pre-commit: {len(caches)} cache file(s), "
             f"{len(strategies)} strategy file(s)"
             + ("" if args.skip_registry else
                f", registry @ {args.devices} devices")
             + f" — {errors} error(s)",
             caches=len(caches), strategies=len(strategies),
             errors=errors)
    return 1 if errors else 0


def cmd_all(args) -> int:
    errors = 0
    caches = sorted(glob.glob(
        os.path.join(args.root, "**", "COST_CACHE*.json"), recursive=True))
    strategies = sorted(
        p for p in glob.glob(os.path.join(args.root, "**", "*.json"),
                             recursive=True)
        if "strategy" in os.path.basename(p).lower()
    )
    for path in caches:
        errors += _report(path, lint_cache_file(path), args.json)
    for path in strategies:
        errors += _report(path, lint_strategy_file(path), args.json)
    findings, info = lint_registry(args.devices, device=args.device)
    errors += _report("registry", findings, args.json)
    _summary(args,
             f"fflint all: {len(caches)} cache file(s), "
             f"{len(strategies)} strategy file(s), registry @ "
             f"{args.devices} devices — {errors} error(s) "
             f"(registry proofs: zoo {info['zoo_seconds']}s + "
             f"generative {info['proofgen_seconds']}s)",
             caches=len(caches), strategies=len(strategies),
             errors=errors, **info)
    return 1 if errors else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fflint", description=__doc__)
    common = argparse.ArgumentParser(add_help=False)
    proofs = argparse.ArgumentParser(add_help=False)
    proofs.add_argument("--device", default="cuda",
                        help="the device the registry proofs evaluate on "
                             "(default cuda; cpu where there is no card)")
    common.add_argument("--json", action="store_true",
                        help="machine-readable output: one JSON object "
                             "per finding line, a summary object last "
                             "(exit codes unchanged)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("strategy", parents=[common],
                       help="lint exported strategy files")
    p.add_argument("files", nargs="+")
    p.add_argument("--calibration", default=None,
                   help="live CALIBRATION.json the STR210 staleness "
                        "check compares __meta__.calibration_signature "
                        "against (default: each strategy file's "
                        "sibling)")
    p.set_defaults(fn=cmd_strategy)
    p = sub.add_parser("cache", parents=[common],
                       help="lint persistent cost-cache files")
    p.add_argument("files", nargs="+")
    p.set_defaults(fn=cmd_cache)
    p = sub.add_parser("registry", parents=[common, proofs],
                       help="numeric-equivalence proof of the rewrite "
                            "registry — hand zoo + generated proof "
                            "graphs (imports the package)")
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--substitution-json", default="",
                   help="also prove the rules of this JSON collection "
                        "(unproven rules are listed as EQV306)")
    p.set_defaults(fn=cmd_registry)
    p = sub.add_parser("all", parents=[common, proofs],
                       help="lint committed artifacts + registry")
    p.add_argument("--root", default=".")
    p.add_argument("--devices", type=int, default=8)
    p.set_defaults(fn=cmd_all)
    p = sub.add_parser("pre-commit", parents=[common, proofs],
                       help="git pre-commit gate: lint STAGED artifact "
                            "files + prove the rewrite registry "
                            "(install: git config core.hooksPath "
                            ".githooks)")
    p.add_argument("--root", default=".")
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--skip-registry", action="store_true",
                   help="artifact lints only (skips the package-importing "
                        "registry proof)")
    p.set_defaults(fn=cmd_precommit)
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
