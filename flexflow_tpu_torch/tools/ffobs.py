#!/usr/bin/env python
"""ffobs — render flexflow_tpu_torch telemetry (JSONL event logs) as a
strategy-explanation report (tools/ffobs.py on the port).

The obs event bus (flexflow_tpu_torch/obs, enabled via FLEXFLOW_TPU_OBS
or FFConfig.obs_log_file / --obs-log) records why the search chose what
it chose — substitutions applied/rejected, DP splits and memo hit
rates, the champion-vs-DP floor decision, the final per-node view
table with its predicted compute/sync breakdown — and what execution
then measured (profile summaries, predicted-vs-measured DriftReports).
This tool turns that log back into something a human debugs with.  The
port's logs and the JAX package's share one schema, so it reads both.

It imports the port's obs modules only where a subcommand needs them,
and no JAX, so it runs wherever the port does.

Usage (python -m flexflow_tpu_torch.tools.ffobs ...):
  ffobs report <log.jsonl> [--top N]      strategy-explanation report
  ffobs validate <log.jsonl>              schema-check every line
  ffobs metrics <log.jsonl>               Prometheus text from the
                                          last metrics.snapshot event
  ffobs trace <log.jsonl>                 render request/episode span
                                          trees (also reads
                                          flight-recorder dumps)
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter, defaultdict
from typing import Dict, List, Optional


def read_events(path: str) -> List[dict]:
    events = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise SystemExit(f"{path}:{lineno}: not JSON: {e}")
    return events


def _ms(v: Optional[float]) -> str:
    if v is None:
        return "—"
    try:
        if v != v or v in (float("inf"), float("-inf")):
            return str(v)
        return f"{v * 1e3:.4f}"
    except TypeError:
        return str(v)


def _view_str(view: dict) -> str:
    dims = "x".join(str(d) for d in view.get("dims", []))
    s = dims or "1"
    if view.get("replica", 1) != 1:
        s += f" r{view['replica']}"
    if view.get("start", 0):
        s += f" @{view['start']}"
    return s


def last_run(events: List[dict]) -> List[dict]:
    """Events of the most recent run only: the JSONL sink appends
    across runs (crash-safe), and each run opens with an ``obs.meta``
    — counting sections would otherwise aggregate every past run."""
    for i in range(len(events) - 1, -1, -1):
        if events[i].get("kind") == "obs.meta":
            return events[i:]
    return events


def render_report(events: List[dict], top: int = 10,
                  all_runs: bool = False) -> str:
    runs = sum(1 for e in events if e.get("kind") == "obs.meta")
    if not all_runs:
        events = last_run(events)
    lines: List[str] = ["# ffobs strategy-explanation report", ""]
    if runs > 1:
        lines.append(
            f"({runs} runs in this log; reporting "
            + ("ALL of them summed" if all_runs else "the LAST only —")
            + (" use --all-runs for the aggregate)" if not all_runs
               else ")"))
        lines.append("")

    # ---- search outer loop ------------------------------------------------
    begins = [e for e in events if e.get("kind") == "search.begin"]
    baselines = [e for e in events if e.get("kind") == "search.baseline"]
    results = [e for e in events if e.get("kind") == "search.result"]
    floors = [e for e in events if e.get("kind") == "search.floor"]
    if begins:
        b = begins[-1]
        lines.append(
            f"Search: {b.get('nodes')} nodes on {b.get('devices')} devices "
            f"(budget {b.get('budget')}, timeout {b.get('timeout_s')}s, "
            f"calibrated={b.get('calibrated')})"
        )
    if baselines:
        lines.append(
            f"Baseline DP-search cost: {_ms(baselines[-1].get('cost_s'))} ms")
    if floors:
        fl = floors[-1]
        verdict = ("kept plain data parallelism (win below margin)"
                   if fl.get("kept_dp") else "accepted searched strategy")
        lines.append(
            f"Champion-vs-DP floor: {verdict} — DP "
            f"{_ms(fl.get('dp_cost_s'))} ms vs searched "
            f"{_ms(fl.get('searched_cost_s'))} ms"
        )
    if results:
        r = results[-1]
        lines.append(
            f"Result: {_ms(r.get('cost_s'))} ms/iter, "
            f"rewritten={r.get('rewritten')}, {r.get('nodes')} nodes"
        )
    lines.append("")

    # ---- substitution provenance -----------------------------------------
    subs = [e for e in events if e.get("kind") == "search.substitution"]
    if subs:
        by_action = Counter(e.get("action") for e in subs)
        lines.append(
            "Substitution candidates: "
            + ", ".join(f"{a}={n}" for a, n in sorted(by_action.items()))
        )
        by_xfer = defaultdict(Counter)
        for e in subs:
            by_xfer[e.get("xfer")][e.get("action")] += 1
        pushed = sorted(
            by_xfer.items(), key=lambda kv: -kv[1].get("pushed", 0))
        shown = [x for x in pushed if x[1].get("pushed")][:top]
        if shown:
            lines.append("Top pushed rewrites:")
            for name, actions in shown:
                lines.append(
                    f"  {name}: pushed={actions.get('pushed', 0)} "
                    f"pruned={actions.get('pruned', 0)} "
                    f"duplicate={actions.get('duplicate', 0)}"
                )
    cands = [e for e in events if e.get("kind") == "search.candidate"]
    if cands:
        improved = sum(1 for e in cands if e.get("improved"))
        lines.append(
            f"Fully-costed candidates: {len(cands)} ({improved} improved "
            f"the champion)"
        )
    splits = [e for e in events if e.get("kind") in ("search.split", "dp.split")]
    if splits:
        ops = Counter(e.get("op") for e in splits)
        lines.append(
            "Split points: "
            + ", ".join(f"{op} x{n}" for op, n in ops.most_common(top))
        )
    dpsum = [e for e in events if e.get("kind") == "dp.summary"]
    if dpsum:
        d = dpsum[-1]
        hits, misses = d.get("memo_hits", 0), d.get("memo_misses", 0)
        rate = hits / max(1, hits + misses)
        lines.append(
            f"DP memo: {hits} hits / {misses} misses ({rate:.0%} hit rate), "
            f"native={d.get('native_hits', 0)}, "
            f"greedy-fallbacks={d.get('greedy_hits', 0)}"
        )
    perf = [e for e in events if e.get("kind") == "search.perf"]
    if perf:
        p = perf[-1]
        ds, fs = p.get("delta_sims", 0), p.get("full_sims", 0)
        drate = ds / max(1, ds + fs)
        rh = p.get("cache_row_hits", 0)
        rm = p.get("cache_row_misses", 0)
        line = (
            f"Search perf: {p.get('search_seconds')}s search + "
            f"{p.get('calibration_seconds')}s calibration; "
            f"{len(cands)} candidates fully costed; simulations: "
            f"{ds} delta / {fs} full ({drate:.0%} delta-served, "
            f"{p.get('delta_bails', 0)} bails)"
        )
        if rh + rm:
            line += (f"; cost-cache rows: {rh}/{rh + rm} hits "
                     f"({rh / (rh + rm):.0%})")
        if p.get("result_cache_hit"):
            line += "; RESULT served from the persistent cost cache"
        lines.append(line)
        cp, cr = p.get("ctx_patch_hits", 0), p.get("ctx_rebuilds", 0)
        if cp + cr:
            lines.append(
                f"Native DP ctx assembly: {cp} patched from the parent's "
                f"ctx / {cr} full rebuilds "
                f"({cp / max(1, cp + cr):.0%} incremental)")
        stamped = p.get("segments_stamped", 0)
        served = p.get("dp_rows_served", 0)
        if stamped or served:
            lines.append(
                f"Segment reuse: {stamped} isomorphic segments stamped "
                f"(lint-gated), {served} tier-2 DP results served from "
                f"persisted memo rows")
        md = p.get("match_delta_scans", 0)
        if md:
            scanned = p.get("match_nodes_rescanned", 0)
            skipped = p.get("match_nodes_skipped", 0)
            denom = max(1, scanned + skipped)
            lines.append(
                f"Delta matching: {md} dirty-region rescans / "
                f"{p.get('match_full_scans', 0)} full scans; "
                f"{scanned} nodes rescanned, {skipped} served from the "
                f"parent ({skipped / denom:.0%} of match work skipped)")
        mi = p.get("match_index_skips", 0)
        if mi:
            lines.append(
                f"Match seed index: {mi} matcher calls skipped (node op "
                f"type cannot anchor the pattern)")
        mv = p.get("match_vec_skips", 0)
        if mv:
            lines.append(
                f"Vectorized matcher: {mv} matcher calls pruned by the "
                f"numpy predicate filters before the python matcher ran")
        mw = p.get("match_worker_batches", 0)
        if mw:
            lines.append(
                f"Match workers: {mw} full-scan sweeps dispatched to the "
                f"process pool (FLEXFLOW_TPU_MATCH_WORKERS)")
        sps = p.get("sp_rows_served", 0)
        if sps:
            lines.append(
                f"SP segment memo: {sps} whole-segment solves served "
                f"from persisted sp-rows (re-linted before serving)")
        cps = p.get("comm_plan_serves")
        cpr = p.get("comm_plan_searches")
        if cps is not None:
            total = max(1, (cps or 0) + (cpr or 0))
            lines.append(
                f"Co-search comm plans: {cps} served from the "
                f"signature memo / {cpr} re-searched "
                f"({(cps or 0) / total:.0%} serve rate) — every "
                f"candidate priced with its best sync "
                f"schedule/precision/zero plan")
    # series-parallel decomposition decisions (search.decompose): one
    # line per oversized (sub)graph — a fallback to binary recursion is
    # REPORTED here instead of being a mystery slowdown
    decos = [e for e in events if e.get("kind") == "search.decompose"]
    for e in decos:
        mode = e.get("mode")
        if mode == "fallback":
            lines.append(
                f"Decomposition: {e.get('nodes')} nodes FELL BACK to "
                f"binary recursion (reason: {e.get('reason')}) — no "
                f"bounded-width series cuts")
        else:
            lines.append(
                f"Decomposition: {e.get('nodes')} nodes via "
                f"{'bottleneck chain (width-1)' if mode == 'chain' else 'series-parallel frontier cuts'} "
                f"— {e.get('cuts')} cuts (max width "
                f"{e.get('max_width')}), {e.get('segments')} segments "
                f"(largest {e.get('max_segment')})")
    dones = [e for e in events if e.get("kind") == "search.decompose_done"]
    if dones:
        d = dones[-1]
        lines.append(
            f"Decomposition result ({d.get('mode')}): DP bound "
            f"{_ms(d.get('bound_s'))} ms -> merged+simulated "
            f"{_ms(d.get('cost_s'))} ms over {d.get('segments')} segments")
    # per-candidate comm-plan decision lines (search.comm_plan events):
    # one roll-up by source so a chatty search stays one line each
    plans = [e for e in events if e.get("kind") == "search.comm_plan"]
    if plans:
        from collections import Counter as _Counter

        by_src = _Counter(e.get("source", "?") for e in plans)
        adopted = sum(1 for e in plans
                      if not e.get("served") and e.get("adopted"))
        lines.append(
            f"Comm-plan decisions: "
            + ", ".join(f"{src} x{n}" for src, n in by_src.most_common())
            + (f"; {adopted} fresh searches adopted bucketing"
               if adopted else ""))
    zg = [e for e in events if e.get("kind") == "search.zero_groups"]
    if zg and zg[-1].get("groups"):
        z = zg[-1]
        lines.append(
            f"Optimizer-state sharding (ZeRO-1, per-group): "
            f"{len(z['groups'])} group(s) "
            f"[{', '.join(z['groups'][:6])}"
            + ("…" if len(z["groups"]) > 6 else "")
            + f"] — credited {_ms(z.get('credit_s'))} ms/iter update win")
    lines.append("")

    # ---- strategy table ---------------------------------------------------
    # prefer the last JOINT-SEARCH table: bench runs also compile
    # forced-DP baselines and sweep variants after the searched program
    tables = [e for e in events if e.get("kind") == "strategy.table"]
    searched_tables = [e for e in tables if e.get("searched")]
    table = (searched_tables or tables)[-1] if tables else None
    rows = table.get("rows", []) if table else []
    if not rows and results:
        rows = results[-1].get("table", []) or []
    if rows:
        lines.append(
            f"## Chosen strategy ({len(rows)} ops, predicted "
            f"{_ms(table.get('predicted_s')) if table else '—'} ms/iter"
            + (f", {len(tables)} strategies compiled this run"
               if len(tables) > 1 else "")
            + ")"
        )
        lines.append("")
        lines.append("| op | type | view | fwd ms | full ms | sync ms | "
                     "sync precision |")
        lines.append("|---|---|---|---|---|---|---|")
        for row in rows:
            lines.append(
                f"| {row.get('op')} | {row.get('type')} | "
                f"{_view_str(row.get('view', {}))} | "
                f"{_ms(row.get('fwd_s'))} | {_ms(row.get('full_s'))} | "
                f"{_ms(row.get('sync_s'))} | "
                f"{row.get('sync_precision', '—')} |"
            )
        lines.append("")
        costly = sorted(
            (r for r in rows if isinstance(r.get("full_s"), (int, float))),
            key=lambda r: -r["full_s"])[:top]
        if costly:
            lines.append(
                "Top predicted-cost ops (the drift candidates to check "
                "first when measured steps run slow):")
            for r in costly:
                lines.append(
                    f"  {r['op']}: {_ms(r['full_s'])} ms compute + "
                    f"{_ms(r.get('sync_s'))} ms sync "
                    f"[{_view_str(r.get('view', {}))}]"
                )
        lines.append("")

    # ---- runtime: profile + drift ----------------------------------------
    profs = [e for e in events if e.get("kind") == "profile.summary"]
    if profs:
        p = profs[-1]
        note = " (INCLUDES COMPILE STEP)" if p.get("includes_compile") else ""
        lines.append(
            f"Measured steps: {p.get('steps')}  mean "
            f"{_ms(p.get('mean_s'))} ms  p95 {_ms(p.get('p95_s'))} ms{note}"
        )
    drifts = [e for e in events if e.get("kind") == "drift.report"]
    if drifts:
        d = drifts[-1]
        lines.append("")
        lines.append("## Drift (predicted vs measured)")
        lines.append("")
        flag = (" — CALIBRATION STALE" if d.get("calibration_stale")
                else " — STALE" if d.get("stale") else "")
        lines.append(
            f"Step: predicted {_ms(d.get('predicted_s'))} ms, measured "
            f"{_ms(d.get('measured_s'))} ms, ratio "
            f"{d.get('ratio'):.2f}{flag}"
        )
        phases = d.get("phases", {})
        if phases:
            lines.append("| phase | predicted ms | measured ms | ratio |")
            lines.append("|---|---|---|---|")
            for k, v in phases.items():
                r = v.get("ratio")
                lines.append(
                    f"| {k} | {_ms(v.get('predicted_s'))} | "
                    f"{_ms(v.get('measured_s'))} | "
                    f"{f'{r:.2f}' if isinstance(r, (int, float)) else '—'} |"
                )
        buckets = d.get("sync_buckets") or []
        if buckets:
            measured_any = any(
                b.get("measured_s") is not None for b in buckets)
            lines.append("")
            lines.append(
                "Sync-schedule buckets (predicted lanes"
                + (", measured side from a tag-matched device-trace "
                   "capture)" if measured_any else
                   "; measured side None until a device_trace capture "
                   "is tag-matched — obs/trace_ingest.py):"))
            lines.append(
                "| bucket | groups | precision | plan | issue-ready ms | "
                "sync ms | exposed ms | measured issue ms | "
                "measured sync ms | per-level ms |")
            lines.append("|---|---|---|---|---|---|---|---|---|---|")
            for b in buckets:
                lv = b.get("predicted_levels_s") or {}
                lv_cell = " ".join(
                    f"{k}={_ms(v)}" for k, v in lv.items()) or "—"
                lines.append(
                    f"| {b.get('name')} | {b.get('ops')} | "
                    f"{b.get('precision')} | "
                    f"{b.get('plan') or 'flat'} | "
                    f"{_ms(b.get('predicted_ready_s'))} | "
                    f"{_ms(b.get('predicted_sync_s'))} | "
                    f"{_ms(b.get('predicted_exposed_s'))} | "
                    f"{_ms(b.get('measured_issue_s'))} | "
                    f"{_ms(b.get('measured_s'))} | "
                    f"{lv_cell} |")
        # only the aggregate step has both sides (single-sided phases
        # carry no ratio by design); rank the measured host phases by
        # their share of the step instead to point at where time went
        measured = d.get("measured_s")
        shares = sorted(
            ((k, v["measured_s"]) for k, v in phases.items()
             if k != "step" and isinstance(v.get("measured_s"),
                                           (int, float))),
            key=lambda kv: -kv[1])
        if measured and shares:
            k, v = shares[0]
            lines.append(
                f"Largest measured phase: {k!r} at {_ms(v)} ms "
                f"({v / measured:.0%} of the step)")
    # ---- measured lanes: device-trace ingestion + tag matching ------------
    ingests = [e for e in events if e.get("kind") == "trace.ingest"]
    matches = [e for e in events if e.get("kind") == "trace.lane_match"]
    if ingests or matches:
        lines.append("")
        lines.append("## Measured lanes (device-trace capture)")
        lines.append("")
        if ingests:
            i = ingests[-1]
            lines.append(
                f"Ingested {i.get('path')}: {i.get('events')} trace "
                f"events, {i.get('lanes')} annotated lane(s), "
                f"{i.get('steps')} step window(s)")
        if matches:
            matched = sum(1 for e in matches if e.get("matched"))
            lines.append(
                f"Lane matching (by annotation tag, never kernel "
                f"names): {matched}/{len(matches)} predicted sync "
                f"lanes matched")
            lines.append(
                "| lane | matched | samples | predicted sync ms | "
                "measured sync ms | sync-share ratio |")
            lines.append("|---|---|---|---|---|---|")
            for e in matches:
                r = e.get("sync_frac_ratio")
                lines.append(
                    f"| {e.get('lane')} | "
                    f"{'yes' if e.get('matched') else 'NO'} | "
                    f"{e.get('samples', 0)} | "
                    f"{_ms(e.get('predicted_sync_s'))} | "
                    f"{_ms(e.get('measured_sync_s'))} | "
                    f"{f'{r:.3f}' if isinstance(r, (int, float)) else '—'} |")
            lines.append(
                "(sync-share ratio: each side's lane duration as a "
                "fraction of its own step — the scale-free drift "
                "signal a host-clock capture supports; ICI/DCN wire "
                "behavior stays simulated until a TPU capture)")

    # ---- serving: serve-objective result + decode executor phase ---------
    serves = [e for e in events if e.get("kind") == "search.serve"]
    if serves:
        s = serves[-1]
        budget = s.get("budget_ms") or 0
        kv = s.get("kv_bytes_per_device") or 0
        lines.append("")
        lines.append(
            f"Serve objective: predicted p99 decode step "
            f"{_ms(s.get('p99_s'))} ms"
            + (f" (SLO budget {budget:.3f} ms)" if budget else "")
            + f", KV residency {kv / 1e6:.1f} MB/device"
            + (" — champion-vs-DP floor kept plain DP"
               if s.get("kept_dp") else ""))
    kvs = [e for e in events if e.get("kind") == "search.kv"]
    if kvs:
        k = kvs[-1]
        p99 = k.get("p99_ms") or {}
        priced = ", ".join(f"{d} {v} ms" for d, v in sorted(p99.items()))
        lines.append(
            f"KV lane: pool dtype {k.get('dtype')!r} "
            + ("searched" if k.get("searched") else "pinned")
            + (f" (priced: {priced})" if priced else "")
            + (f"; {k.get('shared_prefix_pages')} shared prefix "
               f"page(s)/seq priced into residency"
               if k.get("shared_prefix_pages") else ""))
    disaggs = [e for e in events if e.get("kind") == "search.disagg"]
    if disaggs:
        d = disaggs[-1]
        verdict = (
            f"ADOPTED prefill[0:{d.get('prefill_devices')}) + "
            f"decode[{d.get('prefill_devices')}:"
            f"{(d.get('prefill_devices') or 0) + (d.get('decode_devices') or 0)})"
            if d.get("adopted") else "colocated stays optimal")
        lines.append(
            f"Disaggregation search: colocated "
            f"{d.get('colocated_ms')} ms vs disaggregated "
            f"{d.get('disagg_ms')} ms per frame (KV handoff "
            f"{d.get('handoff_ms')} ms"
            + (", spans DCN" if d.get("spans_dcn") else "")
            + f") — {verdict}")
    # ---- serving fleet: N-replica search + router + elastic re-size ------
    fleets = [e for e in events if e.get("kind") == "search.fleet"]
    scales = [e for e in events if e.get("kind") == "fleet.scale"]
    routes = [e for e in events if e.get("kind") == "fleet.route"]
    if fleets or scales or routes:
        lines.append("")
        lines.append("## Serving fleet")
        lines.append("")
        if fleets:
            f = fleets[-1]
            verdict = (f"ADOPTED {f.get('replicas')} replica(s) "
                       f"{f.get('partition')} policy "
                       f"{f.get('policy')!r}" if f.get("adopted")
                       else "single replica stays optimal")
            lines.append(
                f"Fleet search: single-replica {f.get('single_ms')} ms "
                f"vs fleet {f.get('fleet_ms')} ms weighted per-class "
                f"p99 (offered load x{f.get('load_scale')}) — "
                f"{verdict}")
            blocks = f.get("blocks") or []
            if blocks:
                lines.append("")
                lines.append("| replica | devices | span | phase split | "
                             "share | slots | step ms |")
                lines.append("|---|---|---|---|---|---|---|")
                for b in blocks:
                    s0 = b.get("start") or 0
                    split = (f"{b.get('prefill_devices')}+"
                             f"{b.get('decode_devices')}"
                             if b.get("prefill_devices") else "colocated")
                    lines.append(
                        f"| {b.get('replica')} | {b.get('devices')} | "
                        f"[{s0}, {s0 + (b.get('devices') or 0)}) | "
                        f"{split} | {b.get('share')} | "
                        f"{b.get('occupancy_slots')} | "
                        f"{b.get('step_ms')} |")
            routing = f.get("routing") or {}
            per_class = f.get("per_class_ms") or {}
            if routing:
                lines.append("")
                lines.append("| SLO class | routing fractions | "
                             "predicted p99 ms |")
                lines.append("|---|---|---|")
                for name, row in sorted(routing.items()):
                    lines.append(f"| {name} | {row} | "
                                 f"{per_class.get(name)} |")
        for e in scales:
            lines.append(
                f"Elastic re-size at step {e.get('step')}: "
                f"{e.get('from_replicas')} -> {e.get('to_replicas')} "
                f"replica(s) at offered load x{e.get('load_scale')}"
                + (" — RESIZED" if e.get("resized") else ""))
        if routes:
            per_rep: Dict[object, int] = {}
            for e in routes:
                per_rep[e.get("replica")] = \
                    per_rep.get(e.get("replica"), 0) + 1
            dist = ", ".join(f"replica {r}: {c}"
                             for r, c in sorted(per_rep.items(),
                                                key=lambda kv: str(kv[0])))
            lines.append(f"Router: {len(routes)} request(s) routed "
                         f"({dist})")
        # measured per-class p99 from the per-request stream — the
        # other side of the search's predicted per-class table
        fin = [e for e in events if e.get("kind") == "decode.request"
               and e.get("phase") == "finish"]
        if fin:
            by_slo: Dict[str, list] = {}
            for e in fin:
                if isinstance(e.get("ttft_s"), (int, float)):
                    by_slo.setdefault(e.get("slo") or "standard",
                                      []).append(float(e["ttft_s"]))
            if by_slo:
                lines.append("")
                lines.append("| SLO class | completions | measured "
                             "TTFT p99 ms |")
                lines.append("|---|---|---|")
                for name, vals in sorted(by_slo.items()):
                    vals.sort()
                    p99 = vals[min(len(vals) - 1,
                                   int(0.99 * (len(vals) - 1)))]
                    lines.append(f"| {name} | {len(vals)} | "
                                 f"{_ms(p99)} |")
    frames = [e for e in events if e.get("kind") == "decode.frame"]
    summaries = [e for e in events if e.get("kind") == "decode.summary"]
    if frames or summaries:
        lines.append("")
        lines.append("## Decode phase (continuous-batching executor)")
        lines.append("")
        if summaries:
            s = summaries[-1]
            lines.append(
                f"{s.get('frames')} frames, {s.get('completed')} "
                f"sequences completed ({s.get('admitted')} admitted / "
                f"{s.get('evicted')} evicted); measured frame latency "
                f"p50 {_ms(s.get('measured_p50_s'))} ms, p99 "
                f"{_ms(s.get('measured_p99_s'))} ms"
                + (f"; predicted {_ms(s.get('predicted_step_s'))} ms"
                   if s.get("predicted_step_s") else ""))
            if s.get("requests_recorded"):
                lines.append(
                    f"Per-request telemetry ({s['requests_recorded']} "
                    f"completions): TTFT p50 {_ms(s.get('ttft_p50_s'))} "
                    f"/ p99 {_ms(s.get('ttft_p99_s'))} ms, TPOT p50 "
                    f"{_ms(s.get('tpot_p50_s'))} / p99 "
                    f"{_ms(s.get('tpot_p99_s'))} ms, e2e p99 "
                    f"{_ms(s.get('e2e_p99_s'))} ms, queue wait p99 "
                    f"{_ms(s.get('queue_p99_s'))} ms")
            if s.get("prefill_p50_s") is not None:
                # the TTFT split (queue + prefill + first decode frame
                # sum to TTFT): which phase the prompt path's cost
                # lives in — the attribution that makes the chunked-
                # prefill win a number per phase, not a vibe
                lines.append(
                    f"TTFT split (p50): queue "
                    f"{_ms(s.get('queue_p50_s'))} + prefill "
                    f"{_ms(s.get('prefill_p50_s'))} + first frame "
                    f"{_ms(s.get('first_frame_p50_s'))} ms "
                    f"(p99: {_ms(s.get('queue_p99_s'))} + "
                    f"{_ms(s.get('prefill_p99_s'))} + "
                    f"{_ms(s.get('first_frame_p99_s'))} ms)")
            if s.get("prefill_chunks"):
                lines.append(
                    f"Chunked prefill lane: {s.get('prefill_tokens')} "
                    f"prompt tokens in {s.get('prefill_chunks')} "
                    f"chunk pass(es) — vs one decode frame per token "
                    f"without the lane")
            if "prefix_hits" in s:
                # radix prefix sharing roll-up (PageAllocator trie):
                # claimed vs privately-allocated pages and the CoW
                # copies the reserve-on-divergence path paid
                total_pg = ((s.get("shared_pages") or 0)
                            + (s.get("private_pages") or 0))
                rate = (100.0 * (s.get("prefix_hits") or 0)
                        / max(1, s.get("admitted") or 0))
                lines.append(
                    f"Prefix sharing: {s.get('prefix_hits')} of "
                    f"{s.get('admitted')} admission(s) hit the trie "
                    f"({rate:.0f}%), {s.get('shared_pages')} page(s) "
                    f"claimed shared vs {s.get('private_pages')} "
                    f"private"
                    + (f" ({100.0 * (s.get('shared_pages') or 0) / total_pg:.0f}% of the pool walk)"
                       if total_pg else "")
                    + f", {s.get('prefix_tokens')} prompt token(s) "
                      f"skipped, {s.get('cow_copies')} copy-on-write "
                      f"page cop(ies)")
            if s.get("expired") or s.get("preempted"):
                lines.append(
                    f"SLO scheduling: {s.get('expired', 0)} request(s) "
                    f"expired past their deadline, "
                    f"{s.get('preempted', 0)} preemption(s)")
            if s.get("slo_classes"):
                lines.append("")
                lines.append("| SLO class | completed | TTFT p99 ms | "
                             "e2e p99 ms |")
                lines.append("|---|---|---|---|")
                for name, row in sorted(s["slo_classes"].items()):
                    lines.append(
                        f"| {name} | {row.get('completed')} | "
                        f"{_ms(row.get('ttft_p99_s'))} | "
                        f"{_ms(row.get('e2e_p99_s'))} |")
        requests = [e for e in events if e.get("kind") == "decode.request"]
        if requests:
            lines.append("")
            lines.append("| request | tokens | frames | queue ms | "
                         "TTFT ms | TPOT ms | e2e ms |")
            lines.append("|---|---|---|---|---|---|---|")
            for e in requests[-8:]:  # tail; the full stream is JSONL
                lines.append(
                    f"| {e.get('rid')} | {e.get('tokens')} | "
                    f"{e.get('frames')} | {_ms(e.get('queue_s'))} | "
                    f"{_ms(e.get('ttft_s'))} | {_ms(e.get('tpot_s'))} | "
                    f"{_ms(e.get('e2e_s'))} |")
        if frames:
            admitted = sum(e.get("admitted") or 0 for e in frames)
            evicted = sum(e.get("evicted") or 0 for e in frames)
            peak_pages = max(e.get("pages_in_use") or 0 for e in frames)
            lines.append(
                f"Admission/eviction across {len(frames)} frames: "
                f"{admitted} admitted, {evicted} evicted, peak page "
                f"residency {peak_pages} pages")
            lines.append("")
            lines.append("| frame | live | +admit | -evict | pages | "
                         "predicted ms | measured ms |")
            lines.append("|---|---|---|---|---|---|---|")
            for e in frames[-8:]:  # the tail tells the story; full
                # trace stays in the JSONL
                lines.append(
                    f"| {e.get('frame')} | {e.get('active')} | "
                    f"{e.get('admitted')} | {e.get('evicted')} | "
                    f"{e.get('pages_in_use')} | "
                    f"{_ms(e.get('predicted_s'))} | "
                    f"{_ms(e.get('measured_s'))} |")
    # ---- always-on controller: faults, swaps, recoveries ------------------
    faults = [e for e in events if e.get("kind") == "fault.injected"]
    researches = [e for e in events
                  if e.get("kind") == "controller.research"]
    swaps = [e for e in events if e.get("kind") == "controller.swap"]
    recoveries = [e for e in events
                  if e.get("kind") == "controller.recovery"]
    fallbacks = [e for e in events
                 if e.get("kind") == "controller.fallback"]
    csummaries = [e for e in events
                  if e.get("kind") == "controller.summary"]
    if faults or swaps or recoveries or csummaries:
        lines.append("")
        lines.append("## Always-on controller (swap/recovery phases)")
        lines.append("")
        if csummaries:
            s = csummaries[-1]
            lines.append(
                f"{s.get('steps')} steps driven: {s.get('swaps')} hot "
                f"swap(s), {s.get('recoveries')} recover(ies), "
                f"{s.get('retries')} retr(ies), {s.get('fallbacks')} "
                f"monolithic-fp32 fallback(s)")
        for e in faults:
            lines.append(
                f"Fault injected at step {e.get('step')}: "
                f"{e.get('fault')}"
                + (f" (arg {e.get('arg')})"
                   if e.get("arg") is not None else ""))
        for e in researches:
            cal_s = e.get("calibration_seconds") or 0.0
            lines.append(
                f"Re-search at step {e.get('step')} "
                f"({e.get('trigger')}): "
                f"{(e.get('search_seconds') or 0.0):.3f}s"
                + (f" (+{cal_s:.3f}s re-probe)" if cal_s else "")
                + (" — served WARM from the result cache"
                   if e.get("warm") else ""))
        for e in swaps:
            lines.append(
                f"Hot swap at step {e.get('step')}: "
                f"{(e.get('swap_seconds') or 0.0):.3f}s, "
                f"{e.get('fresh') or 0} fresh / "
                f"{e.get('dropped') or 0} dropped state entries"
                + (" — FELL BACK to monolithic fp32 sync"
                   if e.get("fallback") else ""))
        for e in recoveries:
            extra = ""
            if e.get("cause") == "device_loss":
                extra = f" onto {e.get('devices')} surviving device(s)"
            elif e.get("cause") == "checkpoint":
                extra = (f" from newest complete step "
                         f"{e.get('restored_step')}")
            lines.append(
                f"Recovery at step {e.get('step')}: "
                f"{e.get('cause')}{extra}")
        for e in fallbacks:
            lines.append(
                f"Fallback at step {e.get('step')}: {e.get('reason')}")
    p99s = [e for e in events if e.get("kind") == "controller.p99_drift"]
    for e in p99s:
        r = e.get("ratio")
        lines.append(
            f"Serving p99 watch at step {e.get('step')}: measured "
            f"{_ms(e.get('measured_s'))} ms vs searched "
            f"{_ms(e.get('predicted_s'))} ms "
            f"(ratio {f'{r:.2f}' if isinstance(r, (int, float)) else '—'})"
            + (" — DRIFTED, re-search triggered" if e.get("drifted")
               else ""))
    burns = [e for e in events if e.get("kind") == "controller.burn_rate"]
    for e in burns:

        def _b(v):
            return f"{v:.1f}x" if isinstance(v, (int, float)) else "—"

        lines.append(
            f"SLO burn-rate watch at step {e.get('step')} "
            f"[{e.get('slo')}]: fast {_b(e.get('fast'))} / slow "
            f"{_b(e.get('slow'))} of budget"
            + (" — FIRED, re-search triggered" if e.get("fired")
               else ""))
    dumps = [e for e in events if e.get("kind") == "flight.dump"]
    for e in dumps:
        lines.append(
            f"Flight-recorder dump ({e.get('reason')}): "
            f"{e.get('events')} ring event(s) + {e.get('open_spans')} "
            f"open span(s) -> {e.get('path')}")

    # ---- request traces ---------------------------------------------------
    from flexflow_tpu_torch.obs.tracing import forest_stats, span_forest

    forest = span_forest(events)
    if forest:
        total, depth, orphans = forest_stats(forest)
        lines.append("")
        lines.append("## Request traces")
        lines.append("")
        lines.append(
            f"{len(forest)} trace(s), {total} span(s), max depth "
            f"{depth}, {orphans} orphan span(s)"
            + (" — ORPHANS ARE A VALIDATION FAILURE (a span named a "
               "parent the log never closed)" if orphans else ""))
        outcomes: Counter = Counter()
        for spans in forest.values():
            for e in spans:
                if e.get("parent_id") is None:
                    outcomes[e.get("outcome") or
                             ("open" if e.get("kind") == "trace.open"
                              else "?")] += 1
        if outcomes:
            lines.append(
                "Root outcomes: "
                + ", ".join(f"{k}={v}"
                            for k, v in sorted(outcomes.items())))
        lines.append("(render the trees with `ffobs.py trace <log>`)")

    stale = [e for e in events if e.get("kind") == "calibration.staleness"]
    if stale:
        s = stale[-1]
        lines.append(
            f"CALIBRATION STALENESS flagged: measured/predicted = "
            f"{s.get('ratio'):.2f} beyond threshold "
            f"{s.get('threshold')} — re-probe with --calibrate"
        )
    ignored = [e for e in events if e.get("kind") == "calibration.ignored"]
    for e in ignored:
        lines.append(
            f"Calibration ignored: probed on {e.get('backend')!r} but the "
            f"machine model is {e.get('machine')!r}"
        )

    logs = [e for e in events if e.get("kind") == "search.log"]
    if logs:
        lines.append("")
        lines.append(f"(search log: {len(logs)} lines captured; last: "
                     f"{logs[-1].get('msg')!r})")
    return "\n".join(lines) + "\n"


def cmd_report(args) -> int:
    events = read_events(args.log)
    sys.stdout.write(
        render_report(events, top=args.top, all_runs=args.all_runs))
    return 0


def cmd_metrics(args) -> int:
    """Render the newest ``metrics.snapshot`` event of a JSONL log in
    Prometheus text format — the offline twin of the live
    ``FLEXFLOW_TPU_METRICS_PORT`` endpoint (obs/exposition.py)."""
    from flexflow_tpu_torch.obs.exposition import render_prometheus

    events = read_events(args.log)
    snaps = [e for e in events if e.get("kind") == "metrics.snapshot"]
    if not snaps:
        print(f"{args.log}: no metrics.snapshot event "
              f"(call METRICS.emit_snapshot() with the bus armed)",
              file=sys.stderr)
        return 1
    snap = snaps[-1]
    sys.stdout.write(render_prometheus({
        "counters": snap.get("counters") or {},
        "gauges": snap.get("gauges") or {},
        "histograms": snap.get("histograms") or {},
    }))
    return 0


_SPAN_META = ("ts", "kind", "trace_id", "span", "span_id", "parent_id",
              "start_s", "dur_s", "end_s")


def _span_label(e: dict) -> str:
    bits = [str(e.get("span"))]
    dur = e.get("dur_s")
    if dur is not None:
        bits.append(f"{dur * 1e3:.3f} ms")
    elif e.get("kind") == "trace.open":
        bits.append("OPEN")
    attrs = dict(e.get("attrs") or {})
    attrs.update({k: v for k, v in e.items()
                  if k not in _SPAN_META and k != "attrs"})
    if attrs:
        bits.append(", ".join(f"{k}={v}"
                              for k, v in sorted(attrs.items())))
    return "  ".join(bits)


def render_trace_trees(events: List[dict],
                       trace_id: Optional[str] = None,
                       limit: int = 0) -> str:
    """Span forests as indented trees — from a bus JSONL
    (``trace.span`` events) or a flight-recorder dump (``trace.span``
    + ``trace.open`` lines).  Orphan spans (a ``parent_id`` the log
    holds no span for) are listed per trace as validation failures."""
    from flexflow_tpu_torch.obs.tracing import span_forest

    forest = span_forest(events)
    if trace_id is not None:
        forest = {t: s for t, s in forest.items() if t == trace_id}
        if not forest:
            return f"no spans for trace {trace_id!r}\n"
    lines: List[str] = []
    shown = 0
    for tid, spans in forest.items():
        if limit and shown >= limit:
            lines.append(
                f"... {len(forest) - shown} more trace(s) "
                f"(raise --limit)")
            lines.append("")
            break
        shown += 1
        by_id = {e.get("span_id"): e for e in spans
                 if e.get("span_id") is not None}
        children: Dict[int, List[dict]] = defaultdict(list)
        roots: List[dict] = []
        orphans: List[dict] = []
        for e in spans:
            pid = e.get("parent_id")
            if pid is None:
                roots.append(e)
            elif pid in by_id:
                children[pid].append(e)
            else:
                orphans.append(e)
        lines.append(f"trace {tid}  ({len(spans)} spans)")

        def walk(e: dict, depth: int, seen: tuple) -> None:
            lines.append("  " * depth + _span_label(e))
            sid = e.get("span_id")
            if sid in seen:  # defensive: a cyclic log must not hang
                return
            for c in sorted(children.get(sid, ()),
                            key=lambda c: (c.get("start_s")
                                           or c.get("ts") or 0)):
                walk(c, depth + 1, seen + (sid,))

        for r in sorted(roots, key=lambda e: (e.get("start_s")
                                              or e.get("ts") or 0)):
            walk(r, 1, ())
        for o in orphans:
            lines.append(f"  ORPHAN (parent {o.get('parent_id')} "
                         f"missing): {_span_label(o)}")
        lines.append("")
    if not lines:
        return ("no trace.span events (arm the tracer: "
                "FLEXFLOW_TPU_TRACE=1 with the bus on, or read a "
                "flight dump)\n")
    return "\n".join(lines)


def cmd_trace(args) -> int:
    events = read_events(args.log)
    out = render_trace_trees(events, trace_id=args.trace,
                            limit=args.limit)
    sys.stdout.write(out)
    from flexflow_tpu_torch.obs.tracing import forest_stats, span_forest

    forest = span_forest(events)
    if forest:
        total, depth, orphans = forest_stats(forest)
        print(f"{len(forest)} trace(s), {total} span(s), max depth "
              f"{depth}, {orphans} orphan span(s)")
        return 1 if orphans else 0
    return 0


def cmd_validate(args) -> int:
    from flexflow_tpu_torch.obs.events import validate_event

    events = read_events(args.log)
    bad = 0
    for i, e in enumerate(events, 1):
        errors = validate_event(e)
        if errors:
            bad += 1
            print(f"{args.log}:{i}: {'; '.join(errors)}")
    print(f"{len(events)} events, {bad} invalid")
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ffobs", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_rep = sub.add_parser("report", help="render a strategy-explanation "
                           "report from a JSONL event log")
    p_rep.add_argument("log")
    p_rep.add_argument("--top", type=int, default=10)
    p_rep.add_argument("--all-runs", action="store_true",
                       help="aggregate every run appended to the log "
                            "instead of the last one")
    p_rep.set_defaults(fn=cmd_report)
    p_val = sub.add_parser("validate", help="schema-check every event line")
    p_val.add_argument("log")
    p_val.set_defaults(fn=cmd_validate)
    p_met = sub.add_parser(
        "metrics", help="render the last metrics.snapshot event as "
                        "Prometheus text (offline exposition)")
    p_met.add_argument("log")
    p_met.set_defaults(fn=cmd_metrics)
    p_tr = sub.add_parser(
        "trace", help="render request/controller span trees from a "
                      "trace JSONL or flight-recorder dump (exit 1 on "
                      "orphan spans)")
    p_tr.add_argument("log")
    p_tr.add_argument("--trace", default=None,
                      help="render only this trace id")
    p_tr.add_argument("--limit", type=int, default=20,
                      help="max trees to render (0 = all)")
    p_tr.set_defaults(fn=cmd_trace)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
