"""Search driver — Unity's outer loop, plus the legacy MCMC search; a
copy of flexflow_tpu/search/driver.py.

Re-implements GraphSearchHelper (reference:
src/runtime/substitution.cc:1779-2470):

* ``optimize_strategy(return_graph=True)`` — the full Unity algorithm:
  recursively split large graphs at low-rewrite-traffic bottlenecks
  (find_split_node, :1879-2004), enumerate boundary shardings at each
  split (possible_split_output_tensor_shapes, :2372 — here: the
  bottleneck op's compact boundary views), and run a best-first
  substitution search over each small-enough segment (base_optimize,
  :2007-2089) with ``cost > alpha * best`` pruning and a pop budget,
  candidates ranked by a cheap strategy-extension estimate and only
  popped candidates paying for the full DP (a wall-clock-bounded
  variant of the reference's budget discipline).
* ``mcmc_optimize`` — FFModel::mcmc_optimize (reference:
  src/runtime/model.cc:3033-3122), simulated annealing over per-op views.

Scaling disciplines (the reference's equivalents cited inline):

- **Structural segment cache**: optimized segments are cached by
  guid-free structural key and *remapped* onto isomorphic segments
  (repeated transformer layers cost one optimization, not twelve) —
  the role of the reference's cached_optimized_graphs (:2091-2188),
  which can key purely by hash because its machine views don't carry
  node identity.
- **Split scores precomputed once**: find_split_node scores rewrite
  traffic from a single find_matches sweep over the original graph
  instead of re-matching every xfer at every recursion level.
- **Wall-clock deadline**: ``config.search_timeout_s`` bounds the
  whole joint search; on expiry every loop returns its best-so-far
  (the reference bounds work with the pop budget alone; a Python
  implementation needs the harder guarantee).

What the port changes: calibration probes run on the config's torch
device (``FFConfig.device``: the card, or the CPU when asked), which is
the "live backend" the reference reads from ``jax.devices()``.  The
serve objective runs as the reference's (``objective="serve"``: the
search prices decode graphs in the p99 currency of search/serving.py,
its result passes the serving gate and ``LAST_SERVING_META`` records
it; ``_choose_kv_precision`` prices the KV lane into
``LAST_KV_META``).  The gradient-sync
dimensions run as the reference's: ``sync_schedule="search"``
(``_build_sync_schedule``: ``LAST_SYNC_SCHEDULE``), ``co_search`` (the
``JointPricer`` of search/comm_plan.py: ``LAST_ZERO_GROUPS``) and the
match-worker pool ``FLEXFLOW_TPU_MATCH_WORKERS`` (search/
match_workers.py).
"""

from __future__ import annotations

import contextlib
import gc
import heapq
import math
import random
import time
from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import Graph, Node
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.obs.events import BUS
from flexflow_tpu_torch.obs.metrics import METRICS
from flexflow_tpu_torch.search import decompose as _decompose
from flexflow_tpu_torch.search.dp import (
    DP_PERSIST_MIN_NODES,
    SearchHelper,
    Strategy,
    _pair_views,
    canon_fixed_views,
    canonicalize_strategy,
    decode_strategy_rows,
    encode_strategy_rows,
)
from flexflow_tpu_torch.search.simulator import Simulator
from flexflow_tpu_torch.search.substitution import generate_all_pcg_xfers
from flexflow_tpu_torch.search.views import boundary_views

_SEG_STAMPS = METRICS.counter("search.segments_stamped")
_SP_ROWS_SERVED = METRICS.counter("search.sp_rows_served")

# decomposition provenance of the LAST optimize_strategy call in this
# process (reset per run, cumulative over recursion levels): which
# decomposition each oversized (sub)graph took, how many bounded-width
# cuts/segments it produced, and how the segment solves were answered —
# merged into LAST_SEARCH_STATS / the search.perf event
LAST_DECOMPOSE: Dict[str, object] = {}

# production-scale threshold: above this node count the binary
# sequence_optimize recursion is replaced by the K-WAY chain
# decomposition (the reference's chain_optimize, here sp_optimize's
# chain mode) — one bottleneck sweep, one segment
# solve per isomorphism class x boundary-view pair, a chain DP over
# boundary views, one final merge+simulate.  The binary recursion's
# per-level merge simulations and find_split_node sweeps are O(n^2)-ish
# at thousand-node scale; every zoo graph sits below this threshold
# (the native DP engine's own ceiling), so the bit-identical regression
# gate on the zoo holds trivially.
CHAIN_MIN_NODES = 256


@contextlib.contextmanager
def _relaxed_gc():
    """Raise the generational-GC thresholds for the duration of the
    substitution loop: candidate generation churns through thousands of
    acyclic container objects per second (graphs, snapshots, edge
    lists) that refcounting frees promptly, and the default gen-0
    cadence was a measured slice of search wall time.  Thresholds are
    restored on exit; nothing is disabled, so genuine cycles still
    collect."""
    prev = gc.get_threshold()
    gc.set_threshold(max(prev[0], 100_000), 1_000, 1_000)
    try:
        yield
    finally:
        gc.set_threshold(*prev)


def _worker_batches() -> int:
    """Process-lifetime count of match batches dispatched to the
    opt-in match-worker pool (search/match_workers.py) — 0 when the
    pool was never armed."""
    from flexflow_tpu_torch.search import match_workers

    return match_workers.BATCHES.value


def _pooled_matches(xfers, graph, config, num_devices):
    """The opt-in match-worker pool (``FLEXFLOW_TPU_MATCH_WORKERS`` >=
    2, search/match_workers.py ``find_all_matches``): every xfer's
    matches, or None for the serial sweep, which finds the same."""
    from flexflow_tpu_torch.search import match_workers

    return match_workers.find_all_matches(xfers, graph, config,
                                          num_devices)


def _load_xfers(config: FFConfig, num_devices: int) -> list:
    xfers = list(generate_all_pcg_xfers(num_devices))
    if config.substitution_json:
        from flexflow_tpu_torch.search.substitution_loader import load_substitution_json

        xfers += load_substitution_json(config.substitution_json)
    return xfers


class _UnityOptimizer:
    """One graph_optimize run: shared memo/caches (reference:
    cached_optimized_graphs, substitution.cc:2091-2188)."""

    def __init__(
        self,
        helper: SearchHelper,
        config: FFConfig,
        xfers: list,
        deadline: Optional[float] = None,
    ):
        self.helper = helper
        self.config = config
        self.xfers = xfers
        self.deadline = deadline
        # structural key -> (orig segment nodes/groups, optimized graph,
        # cost, strategy, fixed guid->view at store time)
        self.cache: Dict[Tuple, Tuple] = {}
        # sp-row serve memos: (row key, canonical served strategy) ->
        # lint verdict / ambiguous re-price (the SHD1xx lint and the
        # simulated cost are guid-renaming-invariant, so serves whose
        # remap lands on the same canonical form share them — same
        # discipline as the segment-cache stamp-lint memo)
        self._sp_lint_ok: Dict[Tuple, bool] = {}
        self._sp_cost_memo: Dict[Tuple, float] = {}
        self._edge_scores: Optional[Dict[Tuple[int, int], int]] = None
        # joint co-search depth gate: the exposed-comm joint currency is
        # only meaningful for WHOLE-graph candidates — a segment priced
        # in isolation gets charged its full exposed sync tail, which
        # the merged graph hides under the other segments' backward, so
        # joint-priced segment solves compose into provably worse
        # merges.  Interior recursion levels therefore rank in the
        # legacy scalar bound (identical trajectory to the sequential
        # pipeline) and every TOP-level grounding — substitution
        # proposals on the full graph, split/chain merges, the DP
        # floor — is re-validated jointly.
        self._depth = 0

    def _expired(self) -> bool:
        return self.deadline is not None and time.monotonic() > self.deadline

    # -- split-node choice (reference: find_split_node :1879-2004) ---------
    def _score_edges(self, graph: Graph) -> Dict[Tuple[int, int], int]:
        """One find_matches sweep over the top-level graph; recursion
        levels reuse the scores (segment guids are preserved by
        split_at_node, so edge keys stay valid)."""
        if self._edge_scores is None:
            scores: Dict[Tuple[int, int], int] = {}
            pooled = _pooled_matches(
                self.xfers, graph, self.config, self.helper.num_devices)
            for xi, xf in enumerate(self.xfers):
                ms = pooled[xi] if pooled is not None \
                    else xf.find_matches(graph)
                for m in ms:
                    guids = set(m.values()) if isinstance(m, dict) else {m.guid}
                    for g in guids:
                        for e in graph.in_edges.get(g, []):
                            scores[(e.src, e.dst)] = scores.get((e.src, e.dst), 0) + 1
                        for e in graph.out_edges.get(g, []):
                            scores[(e.src, e.dst)] = scores.get((e.src, e.dst), 0) + 1
            self._edge_scores = scores
        return self._edge_scores

    def find_split_node(self, graph: Graph) -> Optional[Node]:
        if graph.num_nodes <= self.config.base_optimize_threshold:
            return None
        bottlenecks = graph.bottlenecks()
        if not bottlenecks:
            return None
        # score edges by how many rewrite matches touch them — splitting
        # where no rewrite straddles keeps the segments' search spaces
        # independent
        edge_scores = self._edge_scores or {}
        threshold = self.config.base_optimize_threshold
        best, best_key = None, None
        for bn in bottlenecks:
            weight = sum(
                edge_scores.get((e.src, e.dst), 0)
                for e in graph.out_edges[bn.guid]
            )
            try:
                pre, _post = graph.split_at_node(bn)
            except ValueError:
                continue
            size = pre.num_nodes
            # prefer low rewrite traffic, then pre-size closest to (but
            # under) the threshold (reference tie-break :1980-1999)
            under = size <= threshold
            key = (weight, 0 if under else 1, -size if under else size)
            if best_key is None or key < best_key:
                best, best_key = bn, key
        return best

    # -- boundary view enumeration (reference: :2372) ----------------------
    def _boundary_views(self, node: Node) -> List[MachineView]:
        return boundary_views(node.op, self.helper.num_devices)

    # -- segment cache with isomorphic remapping ---------------------------
    def _cache_store(self, key, graph, fixed, result):
        g_opt, cost, strategy = result
        self.cache[key] = (
            dict(graph.node_hashes()),
            sorted(graph.nodes),
            g_opt,
            cost,
            dict(strategy),
            {g: v for g, v in fixed.items() if g in graph.nodes},
            # stamp-lint memo: {lint class -> verdict}, filled on the
            # first remapped serve of each class.  The SHD1xx lint is
            # guid-renaming-invariant, so serves sharing a lint class
            # share the verdict (the 10k-node sweep paid ~10k redundant
            # lints without this).  For entries whose hash groups are
            # all singletons the remap pairing is unique — one class;
            # AMBIGUOUS entries key the class by the served strategy's
            # canonical form, since a different pairing is a different
            # strategy and may lint differently
            {},
            # ambiguity flag: True when any structural-hash group has
            # >1 member, i.e. a remapped serve would RE-PRICE (the
            # honest-cost rule).  Singleton-group entries serve their
            # stored cost to cost-only queries (_cache_cost) without
            # paying the remap — the dp-memo precedent
            len(set(graph.node_hashes().values())) != graph.num_nodes,
        )

    def _cache_load(self, key, graph, fixed):
        hit = self.cache.get(key)
        if hit is None:
            return None
        s_nh, s_guids, g_opt, cost, strategy, s_fixed, lint_memo, amb = hit
        if s_guids == sorted(graph.nodes):
            return g_opt, cost, dict(strategy)
        # isomorphic segment with different guids: pair nodes by
        # structural hash group (fixed guids first, so pins land on the
        # pinned nodes), remap the stored optimized graph + strategy
        nh = graph.node_hashes()
        cur_groups: Dict[int, List[int]] = {}
        for g in sorted(graph.nodes):
            cur_groups.setdefault(nh[g], []).append(g)
        stored_groups: Dict[int, List[int]] = {}
        for g in s_guids:
            stored_groups.setdefault(s_nh[g], []).append(g)
        mapping: Dict[int, int] = {}
        for h, s_list in stored_groups.items():
            c_list = cur_groups.get(h)
            if c_list is None or len(c_list) != len(s_list):
                return None
            used = set()
            s_pinned = [g for g in s_list if g in s_fixed]
            c_pinned = [g for g in c_list if g in fixed]
            for sg in s_pinned:
                match = next(
                    (cg for cg in c_pinned if fixed[cg] == s_fixed[sg]), None
                )
                if match is None:
                    return None
                mapping[sg] = match
                used.add(match)
                c_pinned.remove(match)
            s_rest = [g for g in s_list if g not in s_fixed]
            c_rest = [g for g in c_list if g not in used]
            for sg, cg in zip(s_rest, c_rest):
                mapping[sg] = cg
        g2, full = g_opt.remap(mapping, fresh_start=graph._next_guid)
        _keep_own_ops(g2, graph)
        strat2 = {full[g]: v for g, v in strategy.items() if g in full}
        # the per-group pairing may not follow a single isomorphism when
        # hash groups have >1 member — re-simulate so the returned cost
        # is honest for the remapped strategy 
        if any(len(v) > 1 for v in stored_groups.values()):
            cost = self.helper._price(g2, strat2)
        # segment STAMP: a solved segment transplanted onto an
        # isomorphic sibling (repeated transformer layers).  Stamped
        # strategies must still prove legal — the always-on SHD1xx gate
        # the fresh path passes; a lint failure costs one re-search of
        # this segment, never an illegal serve.  The verdict is linted
        # once per LINT CLASS and memoized (see _cache_store): the lint
        # is guid-renaming-invariant, so serves whose remap lands on
        # the same canonical strategy share it
        lkey = canonicalize_strategy(g2, strat2) if amb else True
        verdict = lint_memo.get(lkey)
        if verdict is None:
            from flexflow_tpu_torch.analysis import errors_only, lint_strategy

            verdict = not errors_only(
                lint_strategy(g2, strat2, self.helper.num_devices))
            lint_memo[lkey] = verdict
        if not verdict:
            return None
        self.helper.segments_stamped += 1
        _SEG_STAMPS.inc()
        return g2, cost, strat2

    # -- series-parallel decomposition (bounded-width cuts) ----------------
    def _record_decompose(self, **kw) -> None:
        d = LAST_DECOMPOSE
        d["decompose_calls"] = d.get("decompose_calls", 0) + 1
        if "decompose_mode" not in d and "mode" in kw:
            d["decompose_mode"] = kw["mode"]
        if kw.get("mode") == "fallback":
            d["decompose_fallbacks"] = d.get("decompose_fallbacks", 0) + 1
        d["decompose_cuts"] = d.get("decompose_cuts", 0) + kw.get("cuts", 0)
        d["sp_segments"] = d.get("sp_segments", 0) + kw.get("segments", 0)
        if kw.get("max_width"):
            d["decompose_max_width"] = max(
                d.get("decompose_max_width", 0), kw["max_width"])
        if BUS.enabled:
            BUS.emit("search.decompose", **kw)

    def sp_optimize(
        self, graph: Graph, fixed: Strategy
    ) -> Optional[Tuple[Graph, float, Strategy]]:
        """Series-parallel sequence optimization — ``chain_optimize``
        generalized to bounded-width frontier cuts (search/decompose.py)
        so graphs with NO bottleneck chain (multi-branch MoE trunks,
        persistent-skip stacks, disaggregated placement graphs) still
        decompose instead of degenerating to the binary recursion's
        whole-graph brute force.  Cut selection tries the chain path's bottleneck
        rule FIRST (mode "chain": width-1 cuts, bit-identical cuts and
        solves to ``chain_optimize`` — the degenerate case), then
        bounded-width frontiers (mode "sp"): the DP state becomes a
        TUPLE of boundary views, one per crossing node, with nodes that
        persist across consecutive cuts (skip connections) carrying one
        view through.  Segment solves ride the same memoized
        ``sequence_optimize`` recursion — the structural segment cache
        stamps isomorphism classes, and finished solves persist as
        guid-free sp-memo rows (cost_cache.py sp-row layer) a cold
        process can serve.  Emits ``search.decompose`` naming the
        chosen decomposition — or the fallback reason, so a silent
        degradation to binary recursion cannot happen."""
        threshold = max(4, self.config.base_optimize_threshold)
        cuts, mode = _decompose.find_series_cuts(graph, fixed, threshold)
        if cuts is None:
            self._record_decompose(
                nodes=graph.num_nodes, mode="fallback", reason=mode)
            return None
        segments = _decompose.split_series(graph, cuts)
        if segments is None:
            self._record_decompose(
                nodes=graph.num_nodes, mode="fallback",
                reason="stale_crossing")
            return None
        max_width = max(c.width for c in cuts)
        self._record_decompose(
            nodes=graph.num_nodes, mode=mode, cuts=len(cuts),
            max_width=max_width, segments=len(segments),
            max_segment=max(s[0].num_nodes for s in segments),
        )

        views_at = {
            g: self._boundary_views(graph.nodes[g])
            for c in cuts for g in c.crossing
        }

        def pin_views(seg, in_cross, u, out_cross, v):
            f2 = dict(fixed)
            if u is not None:
                for g, vv in zip(in_cross, u):
                    f2[g] = vv
            if v is not None:
                for g, vv in zip(out_cross, v):
                    f2[g] = vv
            return f2

        def solve(seg, in_cross, u, out_cross, v):
            f2 = pin_views(seg, in_cross, u, out_cross, v)
            served = self._serve_sp_row(seg, f2)
            if served is not None:
                return served
            res = self.sequence_optimize(seg, f2)
            self._persist_sp_row(seg, f2, res)
            return res

        def solve_cost(seg, in_cross, u, out_cross, v):
            """The DP enumeration needs only the segment COST — for
            unambiguous cached entries the stored cost IS the served
            cost (no re-price), so skip the remap/strategy
            materialization the merge replay will pay exactly once.
            In chain mode ambiguous/cold entries take the full solve,
            so every float the DP compares is identical to the chain
            path's (the bit-identity gate); in sp mode the stored cost
            also serves AMBIGUOUS entries — the DP total is a ranking
            bound either way (segment sums double-count the crossing
            nodes), and the merge replay still materializes, lints,
            and honestly re-simulates the composed winner."""
            f2 = pin_views(seg, in_cross, u, out_cross, v)
            key = (seg.hash(), canon_fixed_views(seg, f2))
            hit = self.cache.get(key)
            if hit is not None and (
                    mode != "chain" or not hit[7]
                    or hit[1] == sorted(seg.nodes)):
                return hit[3]
            return solve(seg, in_cross, u, out_cross, v)[1]

        # chain DP over boundary-view tuples: state = the out-cut's
        # view tuple (None at the chain ends).  Per-segment costs
        # double-count the shared crossing nodes and ignore
        # cross-segment overlap — the same pruning-bound currency the
        # chain path sums; the merged graph's one simulation at the
        # end is the honest cost.
        prev: Dict[object, Tuple[float, tuple]] = {None: (0.0, ())}
        for seg, in_cross, out_cross in segments:
            in_states = list(prev)
            if self._expired():
                in_states = in_states[:1]
            cur: Dict[object, Tuple[float, tuple]] = {}
            for u in in_states:
                c_in, path = prev[u]
                carry = dict(zip(in_cross, u)) if u is not None else None
                if out_cross:
                    v_states = _decompose.boundary_tuples(
                        views_at, out_cross, carry=carry)
                    if self._expired():
                        v_states = v_states[:1]
                else:
                    v_states = [None]
                for v in v_states:
                    got = cur.get(v)
                    if got is not None and c_in >= got[0]:
                        continue  # even a free segment cannot win
                    c_seg = solve_cost(seg, in_cross, u, out_cross, v)
                    total = c_in + c_seg
                    if (got is None or total < got[0]) and math.isfinite(
                            total):
                        cur[v] = (total, path + (u,))
            if not cur:
                self._record_decompose(
                    nodes=graph.num_nodes, mode="fallback",
                    reason="infeasible_lane")
                return None  # no feasible lane: binary recursion
            if len(cur) > _decompose.MAX_CUT_TUPLES:
                # beam: carried cut members multiply the state count
                # (each tower tail that persists across cuts keeps its
                # own view lanes) — keep the cheapest states.  Chain
                # cuts share no members, so chain-mode states never
                # exceed the per-node view count and the bit-identity
                # gate is untouched.  Stable sort: ties keep insertion
                # order, so the pruning is deterministic.
                keep = sorted(cur.items(), key=lambda kv: kv[1][0])
                cur = dict(keep[:_decompose.MAX_CUT_TUPLES])
            prev = cur
        if None not in prev:
            self._record_decompose(
                nodes=graph.num_nodes, mode="fallback",
                reason="infeasible_lane")
            return None
        bound, path = prev[None]
        pins = path[1:] + (None,)

        merged_g, merged_s = None, {}
        for (seg, in_cross, out_cross), v in zip(segments, pins):
            u = (
                tuple(merged_s[g] for g in in_cross)
                if in_cross else None
            )
            g_i, _, s_i = solve(seg, in_cross, u, out_cross, v)
            if merged_g is None:
                # the accumulator must be owned: g_i may be a cached
                # segment object the in-place merges below would corrupt
                merged_g, merged_s = g_i.copy(), dict(s_i)
            else:
                _decompose.merge_segment_into(
                    merged_g, merged_s, g_i, s_i, set(in_cross))
            if v is not None:
                for g, vv in zip(out_cross, v):
                    merged_s[g] = vv
        c_true = self.helper._price(merged_g, merged_s)
        if BUS.enabled:
            BUS.emit("search.decompose_done", mode=mode, bound_s=bound,
                     cost_s=c_true, segments=len(segments))
        return merged_g, c_true, merged_s

    # -- persistent sp-segment memo rows (cost_cache.py sp-row layer) ------
    def _sp_row_key(self, seg: Graph, f2: Strategy) -> str:
        """Guid-free persistent key for one SP segment solve: stable
        segment digest + stable pinned boundary views + every knob that
        changes the solve's answer beyond the cache's cost-surface
        signature (the segment solve runs the FULL unity recursion —
        substitutions included — so the rewrite-registry knobs join
        the DP-shape knobs)."""
        from hashlib import blake2b

        from flexflow_tpu_torch.search.cost_cache import stable_graph_digest

        sub_digest = getattr(self, "_sub_digest", False)
        if sub_digest is False:
            sub_digest = None
            if self.config.substitution_json:
                import hashlib

                try:
                    with open(self.config.substitution_json, "rb") as f:
                        sub_digest = hashlib.sha256(
                            f.read()).hexdigest()[:12]
                except OSError:
                    sub_digest = "unreadable"
            self._sub_digest = sub_digest
        snh = seg.stable_node_digests()
        pins = tuple(sorted(
            (snh[g], tuple(v.dim_degrees), int(v.replica_degree),
             int(v.start_part))
            for g, v in f2.items() if g in seg.nodes
        ))
        knobs = (
            self.config.search_budget, self.config.search_alpha,
            self.config.base_optimize_threshold,
            self.helper.num_devices, sub_digest,
        )
        if self.helper.joint is not None:
            # joint-currency rows live under their own key family —
            # same extension-only discipline as the dp-row layer
            knobs = knobs + ("co_search",)
        tail = blake2b(repr((pins, knobs)).encode(),
                       digest_size=10).hexdigest()
        return stable_graph_digest(seg) + ":" + tail

    def _serve_sp_row(self, seg: Graph, f2: Strategy):
        """(graph, cost, strategy) from a persisted sp-segment memo row
        remapped onto this segment's guids, or None.  Same serving
        discipline as the persistent DP memo: rows LOADED from disk
        only (the in-process segment cache covers this run's own
        writes, so a cold cache stays inert and the chain bit-identity
        gate holds), the shared ``_pair_views`` pairing rule over
        stable digests, ambiguous pairings re-simulated for an honest
        cost, and the stamped strategy re-linted SHD1xx — a corrupt
        row costs one re-solve, never a wrong serve."""
        cc = self.helper.sim.cost_cache
        if (cc is None or not getattr(cc, "sp_loaded", False) or cc.stale
                or seg.num_nodes < DP_PERSIST_MIN_NODES):
            return None
        key = self._sp_row_key(seg, f2)
        row = cc.get_sp_row(key)
        if row is None:
            return None
        decoded = decode_strategy_rows(row)
        if decoded is None:
            return None
        cost, canon = decoded
        strategy, ambiguous = _pair_views(
            seg, seg.stable_node_digests(), canon, f2)
        if strategy is None or len(strategy) != seg.num_nodes:
            return None
        # lint + ambiguous re-price memoized per (row, canonical served
        # strategy): a remap landing on the same canonical form is the
        # same strategy up to isomorphism, so verdict and simulated
        # float are shared; a DIFFERENT pairing is a different class
        # and pays its own lint/price (the verdict is
        # exactly as pairing-dependent as the cost)
        mkey = (key, canonicalize_strategy(seg, strategy)) if ambiguous \
            else (key, True)
        if ambiguous:
            # interior currency: segment solves rank in the scalar
            # simulation (the driver's depth gate), so the honest
            # re-price for an ambiguous pairing is the scalar sim too
            got = self._sp_cost_memo.get(mkey)
            if got is None:
                got = self.helper.sim.simulate(seg, strategy)
                self._sp_cost_memo[mkey] = got
            cost = got
        if mkey not in self._sp_lint_ok:
            from flexflow_tpu_torch.analysis import errors_only, lint_strategy

            self._sp_lint_ok[mkey] = not errors_only(
                lint_strategy(seg, strategy, self.helper.num_devices))
        if not self._sp_lint_ok[mkey]:
            return None
        self.helper.sp_rows_served += 1
        _SP_ROWS_SERVED.inc()
        return seg, cost, strategy

    def _persist_sp_row(self, seg: Graph, f2: Strategy, res) -> None:
        """Persist a finished segment solve as a guid-free sp-memo row.
        Only UN-REWRITTEN solves persist into the JSON layer (a
        rewritten segment graph cannot be expressed as digest-keyed
        strategy rows on the original segment; it still rides the
        in-process segment cache and the whole-result pickle layer)."""
        g_opt, cost, strategy = res
        cc = self.helper.sim.cost_cache
        if (cc is None or cc.stale or not math.isfinite(cost)
                or seg.num_nodes < DP_PERSIST_MIN_NODES or not strategy):
            return
        if sorted(g_opt.nodes) != sorted(seg.nodes):
            return  # rewritten: structure moved off the segment digest
        rows = encode_strategy_rows(seg, strategy)
        if rows is None:
            return
        cc.put_sp_row(self._sp_row_key(seg, f2), float(cost), rows)

    # -- recursive sequence optimization (reference: :2190-2370) -----------
    def sequence_optimize(
        self, graph: Graph, fixed: Strategy
    ) -> Tuple[Graph, float, Strategy]:
        """Depth-gated wrapper: interior recursion levels suspend the
        joint pricer (``SearchHelper.joint_scope`` — THE shared gate
        rule), the top level restores it."""
        top = self._depth == 0
        self._depth += 1
        try:
            with self.helper.joint_scope(top):
                return self._sequence_optimize(graph, fixed)
        finally:
            self._depth -= 1

    def _sequence_optimize(
        self, graph: Graph, fixed: Strategy
    ) -> Tuple[Graph, float, Strategy]:
        key = (graph.hash(), canon_fixed_views(graph, fixed))
        hit = self._cache_load(key, graph, fixed)
        if hit is not None:
            return hit
        if graph.num_nodes > CHAIN_MIN_NODES:
            decomposed = self.sp_optimize(graph, fixed)
            if decomposed is not None:
                self._cache_store(key, graph, fixed, decomposed)
                return decomposed
        bn = self.find_split_node(graph)
        if bn is None or bn.guid in fixed:
            result = self.base_optimize(graph, fixed)
        else:
            try:
                pre, post = graph.split_at_node(bn)
            except ValueError:
                result = self.base_optimize(graph, fixed)
                self._cache_store(key, graph, fixed, result)
                return result
            if BUS.enabled:
                BUS.emit(
                    "search.split", op=bn.op.name,
                    pre_nodes=pre.num_nodes, post_nodes=post.num_nodes,
                    boundary_views=len(self._boundary_views(bn)),
                )
            best: Tuple[Optional[Graph], float, Strategy] = (None, math.inf, {})
            best_bound = math.inf
            for v in self._boundary_views(bn):
                f2 = dict(fixed)
                f2[bn.guid] = v
                g_pre, c_pre, s_pre = self.sequence_optimize(pre, f2)
                if c_pre >= best_bound:
                    continue
                g_post, c_post, s_post = self.sequence_optimize(post, f2)
                # c_pre + c_post double-counts the pinned bottleneck and
                # ignores cross-segment overlap — it is only a pruning
                # bound; the merged graph's own simulation decides
                # (dp.graph_cost re-validates the same way)
                total = c_pre + c_post
                if total >= best_bound * 1.5:
                    continue
                best_bound = min(best_bound, total)
                merged_g, merged_s = _merge_split(
                    g_pre, s_pre, g_post, s_post, bn.guid
                )
                merged_s[bn.guid] = v
                c_true = self.helper._price(merged_g, merged_s)
                if c_true < best[1]:
                    best = (merged_g, c_true, merged_s)
                if self._expired():
                    break
            if best[0] is None:
                result = self.base_optimize(graph, fixed)
            else:
                result = best  # type: ignore[assignment]
        self._cache_store(key, graph, fixed, result)
        return result

    # -- best-first over substitutions (reference: :2007-2089) -------------
    def base_optimize(
        self, graph: Graph, fixed: Strategy
    ) -> Tuple[Graph, float, Strategy]:
        """Two-tier best-first search: every candidate gets a cheap
        estimate (simulate under the parent's optimized strategy
        extended with default views for inserted nodes); only popped
        candidates — at most ``search_budget`` — pay for the full DP.
        The reference full-costs every candidate (substitution.cc:
        2007-2089) because its DP is C++ with measured-cost caches; the
        estimate keeps identical best-first structure at tractable cost."""
        helper, config = self.helper, self.config
        best_cost, best_strategy = helper.graph_cost(graph, fixed)
        best_graph = graph
        counter = 0
        # heap entries: (estimate, counter, graph, parent_strategy)
        heap: list = [(best_cost, counter, graph, best_strategy)]
        seen = {graph.hash()}
        budget = config.search_budget
        pinned = set(fixed)
        while heap and budget > 0 and not self._expired():
            est, _, g, parent_s = heapq.heappop(heap)
            if est > config.search_alpha * best_cost:
                break
            budget -= 1
            if g is not graph:
                # full DP for the popped candidate (tier 2)
                cost, strat = helper.graph_cost(g, fixed)
                if BUS.enabled:
                    BUS.emit(
                        "search.candidate", cost_s=cost, est_s=est,
                        best_s=best_cost, improved=cost < best_cost,
                        nodes=g.num_nodes,
                    )
                if cost < best_cost:
                    best_cost, best_strategy, best_graph = cost, strat, g
                parent_s = strat
            # arm the delta baseline on the popped parent: every child
            # candidate's tier-1 estimate below is then an incremental
            # re-cost of the substitution's dirty cone instead of a
            # full O(nodes+edges) schedule derivation (the reference's
            # SIMULATE_DELTA discipline, simulator.h).  Priming the
            # parent's ancestor hashes makes the children's dedup
            # hashing incremental the same way.
            g.prime_delta_hashes()
            self.helper.sim.set_baseline(
                g, self._estimate_strategy(g, parent_s, fixed))
            emit = BUS.enabled  # per-candidate events are chatty: one
            # branch when telemetry is off, full accept/reject
            # provenance when it is on
            # delta-aware matching: a popped
            # candidate re-matches only the dirty region around its
            # substitution, seeded by the parent's matches (attached at
            # push time below) + the changed-guid sets.  All xfers'
            # matches are collected BEFORE applying any, so every child
            # inherits the complete parent-match payload.
            parent_matches = getattr(g, "_parent_match_guids", None)
            matches_by_xfer: List[list] = []
            match_payload: Dict[int, List[int]] = {}
            pooled = None
            if parent_matches is None:
                # parent-less pops pay a full per-xfer sweep — the
                # opt-in match-worker pool fans it out across processes
                # (serial path when FLEXFLOW_TPU_MATCH_WORKERS is off)
                pooled = _pooled_matches(
                    self.xfers, g, self.config, self.helper.num_devices)
            for xi, xf in enumerate(self.xfers):
                delta_fn = getattr(xf, "find_matches_delta", None)
                if pooled is not None:
                    ms = pooled[xi]
                    if delta_fn is not None:
                        match_payload[xi] = [n.guid for n in ms]
                elif delta_fn is not None:
                    ms = delta_fn(
                        g,
                        parent_matches.get(xi) if parent_matches else None)
                    match_payload[xi] = [n.guid for n in ms]
                else:
                    # dict-match xfers (BatchEmbeddingsXfer) group over
                    # the WHOLE graph — no local delta applies
                    ms = xf.find_matches(g)
                matches_by_xfer.append(ms)
            for xi, xf in enumerate(self.xfers):
                for m in matches_by_xfer[xi]:
                    g2 = xf.apply(g, m)
                    if g2 is None:
                        if emit:
                            BUS.emit("search.substitution", xfer=xf.name,
                                     action="invalid")
                        continue
                    # a rewrite must not consume a pinned boundary node
                    if any(p not in g2.nodes for p in pinned if p in g.nodes):
                        if emit:
                            BUS.emit("search.substitution", xfer=xf.name,
                                     action="pinned")
                        continue
                    h = g2.hash()
                    if h in seen:
                        if emit:
                            BUS.emit("search.substitution", xfer=xf.name,
                                     action="duplicate")
                        continue
                    seen.add(h)
                    e2 = self._estimate(g2, parent_s, fixed)
                    if e2 < config.search_alpha * best_cost:
                        counter += 1
                        g2._parent_match_guids = match_payload
                        heapq.heappush(heap, (e2, counter, g2, parent_s))
                        if emit:
                            BUS.emit("search.substitution", xfer=xf.name,
                                     action="pushed", est_s=e2,
                                     best_s=best_cost)
                    elif emit:
                        BUS.emit("search.substitution", xfer=xf.name,
                                 action="pruned", est_s=e2,
                                 best_s=best_cost)
                if self._expired():
                    break
        self.helper.sim.clear_baseline()
        return best_graph, best_cost, best_strategy

    @staticmethod
    def _estimate_strategy(graph: Graph, parent_s: Strategy,
                           fixed: Strategy) -> Strategy:
        """The estimate's view resolution — parent strategy where guids
        survive, default/fixed views for inserted nodes.  ONE rule
        shared by the estimate and its delta baseline, so an unchanged
        node always resolves to the identical view object and the
        dirty-set diff stays at the substitution's true footprint."""
        strat: Strategy = {}
        for guid, node in graph.nodes.items():
            v = fixed.get(guid) or parent_s.get(guid)
            if v is None:
                v = node.op.fixed_machine_view() or MachineView.trivial(
                    node.op.output_shapes[0].ndim
                )
            strat[guid] = v
        return strat

    def _estimate(self, graph: Graph, parent_s: Strategy, fixed: Strategy) -> float:
        """Cheap candidate cost: parent strategy where guids survive,
        default/fixed views for inserted nodes, one simulation — served
        as a delta re-cost of the substitution's dirty cone against the
        popped parent's armed baseline (simulate_rewrite) whenever the
        candidate carries its changed-guid sets; full simulation
        otherwise."""
        sim = self.helper.sim
        fixed_get = fixed.get
        parent_get = parent_s.get

        def resolve(node):
            v = fixed_get(node.guid) or parent_get(node.guid)
            if v is None:
                v = node.op.fixed_machine_view() or MachineView.trivial(
                    node.op.output_shapes[0].ndim
                )
            return v

        got = sim.simulate_rewrite(graph, resolve)
        if got is not None:
            return got
        return sim.simulate(
            graph, self._estimate_strategy(graph, parent_s, fixed))


def _keep_own_ops(stamped: Graph, segment: Graph) -> None:
    """Give a stamped segment its own operators back, in place.

    ``Graph.remap`` moves the stored segment's op objects onto the
    sibling's guids: equal signatures (so equal costs, hashes and
    digests), but the stored layer's NAMES (layer 0's nodes come back
    holding ``layer2_ln1``...).  Names key the weights and the strategy
    files, so the reference's searched graph can hold one name several
    times and its lowering then gives those layers one set of weights
    (ROADMAP Queue C).  Each of the sibling's own nodes takes its own op
    again; a node the stamp inserted (a parallel op of the stored
    rewrite) takes a clone under a fresh name.  Nothing the search
    prices changes."""
    from flexflow_tpu_torch.search.substitution import _uname

    for guid, node in list(stamped.nodes.items()):
        own = segment.nodes.get(guid)
        if own is not None:
            op = own.op
        else:
            op = object.__new__(type(node.op))
            op.__dict__.update(node.op.__dict__)
            op.attrs = dict(node.op.attrs)
            op.name = _uname(node.op.name.rsplit("_x", 1)[0])
        if op is not node.op:
            stamped.nodes[guid] = Node(guid, op)
    stamped._invalidate()


def _merge_split(
    pre_g: Graph,
    pre_s: Strategy,
    post_g: Graph,
    post_s: Strategy,
    bn_guid: int,
) -> Tuple[Graph, Strategy]:
    """Union of the two optimized segments.  Original nodes are disjoint
    apart from the shared bottleneck; nodes INSERTED by rewrites may
    collide between segments (both sides allocate from the same starting
    guid) and are renumbered on the post side."""
    g = Graph()
    g._next_guid = max(pre_g._next_guid, post_g._next_guid)
    for guid, n in pre_g.nodes.items():
        g.nodes[guid] = n
        g.in_edges[guid] = list(pre_g.in_edges[guid])
        g.out_edges[guid] = list(pre_g.out_edges[guid])
    remap: Dict[int, int] = {}
    for guid in post_g.nodes:
        if guid in pre_g.nodes and guid != bn_guid:
            remap[guid] = g._next_guid
            g._next_guid += 1
    from flexflow_tpu_torch.core.graph import Edge

    for guid, n in post_g.nodes.items():
        ng = remap.get(guid, guid)
        if ng not in g.nodes:
            g.nodes[ng] = n if ng == guid else Node(ng, n.op)
            g.in_edges.setdefault(ng, [])
            g.out_edges.setdefault(ng, [])
    for guid in post_g.nodes:
        for e in post_g.out_edges[guid]:
            ne = Edge(
                remap.get(e.src, e.src),
                remap.get(e.dst, e.dst),
                e.src_idx,
                e.dst_idx,
            )
            g.out_edges[ne.src].append(ne)
            g.in_edges[ne.dst].append(ne)
    strategy = dict(pre_s)
    for guid, v in post_s.items():
        strategy[remap.get(guid, guid)] = v
    g._invalidate()
    return g, strategy


# perf observability of the LAST optimize_strategy call in this
# process: bench_search splits its per-model timing into calibration
# vs search and records the delta/cache hit rates from here
LAST_SEARCH_STATS: Dict[str, object] = {}

# the gradient-sync schedule the LAST optimize_strategy chose (and
# gated) under config.sync_schedule="search" — compile() adopts it for
# the strategy the search just returned instead of re-running the
# choice; None when the mode is off or the monolithic baseline won
LAST_SYNC_SCHEDULE = None

# the per-group optimizer-state sharding map the LAST optimize_strategy
# chose under config.co_search (search/comm_plan.py choose_zero_groups):
# op names whose ZeRO-1 reduce-scatter/all-gather placement genuinely
# shrinks the update term — compile() adopts it the way it adopts
# LAST_SYNC_SCHEDULE; () when co-search is off or nothing qualifies
LAST_ZERO_GROUPS: tuple = ()

# the serving provenance of the LAST optimize_strategy run under
# config.objective="serve" (search/serving.py): the SHD16x-gated
# objective + SLO budget + frame geometry + predicted p99 + per-device
# KV residency — compile() persists it as __meta__.serving behind the
# digest gate (fflint strategy checks it stdlib-only, STR209); None
# under the default train objective
LAST_SERVING_META = None

# KV-lane provenance of the last serve-objective search: chosen pool
# dtype + scale layout + prefix-sharing residency accounting — compile()
# persists it as __meta__.kv behind the digest gate (fflint strategy
# checks it stdlib-only, STR213; SHD168/169 re-lint at import); None
# when the lane is unarmed (kv_precision="off" and no declared sharing)
LAST_KV_META = None


def _kv_candidate_graph(graph, dtype: str):
    """A pricing CLONE of ``graph`` whose decode ops carry
    ``kv_dtype=dtype`` — the caller's graph (and the frontend digest
    the strategy export is keyed to) is never mutated; attr ADOPTION
    happens in model.py, after the export meta is computed on the
    export side and after the SHD168/169 re-lint passes on the import
    side.  fp32 adds no attr (extension-only discipline), so the
    original graph IS the fp32 candidate."""
    if dtype == "fp32":
        return graph
    from flexflow_tpu_torch.core.graph import Node
    from flexflow_tpu_torch.core.optype import OperatorType

    g2 = graph.copy()
    for guid, node in list(g2.nodes.items()):
        op = node.op
        if op.op_type != OperatorType.DECODE_ATTENTION:
            continue
        a = op.attrs
        clone = type(op)(
            op.name, op.input_shapes,
            embed_dim=a["embed_dim"], num_heads=a["num_heads"],
            page_size=a["page_size"], pages_per_seq=a["pages_per_seq"],
            num_pages=a["num_pages"], use_kernel=a["use_kernel"],
            kv_dtype=dtype, kernel_initializer=op._kernel_init,
        )
        g2.nodes[guid] = Node(guid, clone)
    g2._invalidate()
    return g2


def _choose_kv_precision(graph, strategy, config, serving, calibration):
    """The KV-lane decision for a finished serve-objective result:
    price the pool-dtype candidates (fp32/bf16/int8 under
    ``kv_precision="search"``, the single pinned dtype otherwise)
    through the SAME p99 currency the search ranked in — each
    candidate's decode cache stream shrinks with the dtype while the
    quantize-overhead term (KV_QUANT_PASSES, the EQuARX discipline
    wire precision already pays) charges the write path — and return
    the ``__meta__.kv`` provenance block, or None when the lane is
    unarmed.  Pricing uses fresh simulators with the persistent cost
    cache detached (lane probes are result provenance, not the
    search's cost surface)."""
    lane = getattr(config, "kv_precision", "off")
    sharing = int(getattr(serving, "shared_prefix_pages", 0) or 0) \
        if serving is not None else 0
    if serving is None or not strategy or (lane == "off" and not sharing):
        return None
    from flexflow_tpu_torch.search.serving import kv_residency_bytes
    from flexflow_tpu_torch.search.simulator import Simulator

    if lane == "search":
        cands = ["fp32", "bf16", "int8"]
    elif lane == "off":
        cands = ["fp32"]  # sharing armed alone: pool dtype stays put
    else:
        cands = [lane]
    priced = {}
    graphs = {}
    for dt in cands:
        g = _kv_candidate_graph(graph, dt)
        graphs[dt] = g
        sim = Simulator(
            config.machine_spec, num_devices=config.search_devices,
            calibration=calibration, inference=True, serving=serving,
        )
        priced[dt] = sim.simulate(g, strategy)
    best = min(cands, key=lambda d: priced[d])
    meta = {
        "dtype": best,
        "searched": lane == "search",
        "scale_layout": "page_slot" if best == "int8" else "none",
        "shared_prefix_pages": sharing,
        "shared_residency_factor": serving.shared_residency_factor(),
        "predicted_p99_step_ms": {
            d: round(t * 1e3, 6) for d, t in sorted(priced.items())},
        "kv_bytes_per_device": kv_residency_bytes(
            graphs[best], strategy, config.search_devices,
            serving=serving),
    }
    BUS.emit(
        "search.kv", dtype=best, searched=lane == "search",
        shared_prefix_pages=sharing,
        p99_ms={d: round(t * 1e3, 6) for d, t in sorted(priced.items())},
        kv_bytes_per_device=meta["kv_bytes_per_device"],
    )
    return meta


def _build_sync_schedule(graph, strategy, sim, config, joint=None):
    """Choose + legality-gate the gradient-sync schedule for a search
    result (search/sync_schedule.py) — runs on BOTH the fresh and the
    cache-served paths of ``optimize_strategy``, so every result this
    function hands out carries a linted schedule (or None).  The gate
    (SHD12x) is always-on inside ``choose_sync_schedule``; a failure
    there is a builder bug and raises.

    Under co-search (``joint`` bound) the schedule is SERVED from the
    JointPricer's comm-plan memo — the plan the winning strategy was
    actually priced with — instead of re-running the sweep, and the
    memoized per-group optimizer-sharding choice lands in
    ``LAST_ZERO_GROUPS``.  Served plans (memo or disk) still pass the
    full SHD12x/SHD14x legality gates against THIS (graph, strategy):
    a corrupt persisted plan costs one re-search, never an illegal
    artifact."""
    global LAST_SYNC_SCHEDULE, LAST_ZERO_GROUPS
    LAST_SYNC_SCHEDULE = None
    LAST_ZERO_GROUPS = ()
    if getattr(config, "sync_schedule", "off") != "search" or not strategy:
        return None
    from flexflow_tpu_torch.search.sync_precision import choose_sync_precision
    from flexflow_tpu_torch.search.sync_schedule import (
        choose_sync_schedule,
        lint_gate,
    )

    if joint is not None:
        entry = joint.plan_for(graph, strategy, sim)
        schedule = None
        if entry is not None and entry.adopted:
            schedule = entry.schedule
            lint_gate(graph, strategy, schedule, entry.pmap,
                      cost_model=sim.cost)
        if entry is not None and entry.zero:
            from flexflow_tpu_torch.analysis import (
                AnalysisError,
                emit_findings,
                errors_only,
                lint_zero_map,
            )

            bad = errors_only(lint_zero_map(
                graph, strategy, entry.zero, sim.cost))
            if bad:
                # a served zero map that fails the always-on gate is a
                # plan bug (or a corrupt persisted row): fail loudly
                # like every other artifact this tree produces
                emit_findings(bad)
                raise AnalysisError(
                    "co-search produced an illegal per-group "
                    "optimizer-sharding map", bad)
            LAST_ZERO_GROUPS = tuple(entry.zero)
        LAST_SEARCH_STATS["sync_schedule"] = {
            "buckets": len(schedule.buckets) if schedule is not None else 0,
            "co_search": True,
            "zero_groups": len(LAST_ZERO_GROUPS),
        }
        if BUS.enabled:
            BUS.emit(
                "search.zero_groups", groups=list(LAST_ZERO_GROUPS),
                credit_s=entry.zero_credit if entry is not None else 0.0,
            )
        LAST_SYNC_SCHEDULE = schedule
        return schedule

    pmap = {}
    if getattr(config, "sync_precision", "fp32") != "fp32":
        pmap = choose_sync_precision(graph, strategy, sim.cost)
    schedule, info = choose_sync_schedule(graph, strategy, sim, pmap, config)
    LAST_SEARCH_STATS["sync_schedule"] = {
        "buckets": info.get("buckets", 0),
        "monolithic_s": info.get("monolithic_s"),
        "scheduled_s": info.get("scheduled_s"),
    }
    if schedule is not None:
        from flexflow_tpu_torch.utils.logging import SEARCH_LOG

        SEARCH_LOG.log(
            f"sync schedule: {len(schedule.buckets)} buckets beat the "
            f"monolithic sync "
            f"({info['monolithic_s'] * 1e3:.4f} -> "
            f"{info['scheduled_s'] * 1e3:.4f} ms/iter simulated)"
        )
    LAST_SYNC_SCHEDULE = schedule
    return schedule



def _lint_findings(graph, strategy, num_devices):
    """Error-level static-analysis findings for a search result: graph
    well-formedness + strategy/sharding legality (flexflow_tpu_torch/analysis).
    The always-on gate of ``optimize_strategy`` — a few propagate calls
    per node, negligible next to the search itself."""
    from flexflow_tpu_torch.analysis import check_graph, errors_only, lint_strategy

    return errors_only(
        check_graph(graph) + lint_strategy(graph, strategy, num_devices))


def _serve_cached_search(cache, graph: Graph, config: FFConfig):
    """Remap a cached search result onto the caller's graph.  The
    digest key is guid-free (stable_graph_digest), so the stored
    original-graph topo guid sequence is positionally isomorphic to
    the caller's — original nodes map 1:1, rewrite-inserted nodes get
    fresh guids (Graph.remap)."""
    got = cache.get_search_result(graph, config)
    if got is None:
        return None
    orig_topo, best_graph, strategy, cost = got
    caller_topo = [n.guid for n in graph.topo_order()]
    if len(orig_topo) != len(caller_topo):
        return None
    pos = dict(zip(orig_topo, caller_topo))
    if best_graph is None:
        # un-rewritten result: strategies transfer positionally onto
        # the caller's (structurally identical) graph
        strat2 = {pos[g]: v for g, v in strategy.items() if g in pos}
        return graph, strat2, cost
    mapping = {og: cg for og, cg in pos.items() if og in best_graph.nodes}
    g2, full = best_graph.remap(mapping, fresh_start=graph._next_guid)
    strat2 = {full[g]: v for g, v in strategy.items() if g in full}
    return g2, strat2, cost


def load_calibration(config: FFConfig):
    """The CalibrationTable at config.calibration_file, or None.  The
    platform-coherence check (measured records must come from the
    backend the machine model describes) runs in optimize_strategy so
    it can log; callers that need the coherent table directly use
    coherent_calibration."""
    if not config.calibration_file:
        return None
    import os

    from flexflow_tpu_torch.search.calibration import CalibrationTable

    if not os.path.exists(config.calibration_file):
        return None
    return CalibrationTable.load(config.calibration_file)


def coherent_calibration(config: FFConfig):
    """load_calibration + the same platform-coherence rule the search
    applies — so OTHER scorers (e.g. compile's pipeline proposal) rank
    in the SAME cost currency as the search that just ran."""
    calibration = load_calibration(config)
    if calibration is not None and calibration.backend not in (
            None, config.machine_spec.platform):
        return None
    return calibration


def optimize_strategy(
    graph: Graph, config: FFConfig, return_graph: bool = False
) -> "Strategy | Tuple[Graph, Strategy]":
    """Find a good (graph, strategy).  With ``return_graph=True`` — the
    default compile path — the joint Unity search runs: graph rewrites
    compete with view assignment and the best REWRITTEN graph is
    returned for lowering.  With False only strategies on the original
    graph are explored (strategy-only mode, e.g. for export).

    ``config.verify`` arms the post-rewrite invariant checker for THIS
    search only (same checks as FLEXFLOW_TPU_VERIFY=1, scoped instead
    of process-sticky)."""
    if getattr(config, "verify", False):
        from flexflow_tpu_torch.analysis.invariants import scoped_verify

        with scoped_verify(True):
            return _optimize_strategy(graph, config, return_graph)
    return _optimize_strategy(graph, config, return_graph)


def _optimize_strategy(
    graph: Graph, config: FFConfig, return_graph: bool = False
) -> "Strategy | Tuple[Graph, Strategy]":
    from flexflow_tpu_torch.utils.logging import SEARCH_LOG as log

    global LAST_SERVING_META, LAST_KV_META
    t_start = time.monotonic()
    # re-entrant discipline: a search that raises part-way must not
    # leave the PREVIOUS run's stats for a consumer to misread
    LAST_SEARCH_STATS.clear()
    LAST_DECOMPOSE.clear()
    # snapshot the delta-matching counters so search.perf reports THIS
    # search's rescan shrink, not the process-lifetime aggregate
    from flexflow_tpu_torch.search import substitution as _subst

    match_base = (
        _subst._SCANS.value, _subst._DELTA_SCANS.value,
        _subst._DELTA_NODES.value, _subst._DELTA_SKIPPED.value,
        _subst._INDEX_SKIPS.value, _subst._VEC_SKIPS.value,
        _worker_batches(),
    )
    t_cal = 0.0  # seconds spent probing/persisting calibration — split
    # out of the reported search time
    n = config.search_devices
    calibration = load_calibration(config)
    target = config.machine_spec.platform
    # the live backend: the torch device the config runs on (the
    # reference reads jax.devices()[0].platform)
    live = config.torch_device().type
    if calibration is not None and calibration.backend not in (None, target):
        # measured records are only coherent with a simulator whose
        # machine model describes the backend they were probed on —
        # e.g. CPU milliseconds would poison an H100-modeled search
        log.log(
            f"ignoring calibration probed on {calibration.backend!r} "
            f"(machine model is {config.machine_spec.name!r})"
        )
        BUS.emit("calibration.ignored", backend=calibration.backend,
                 machine=config.machine_spec.name)
        calibration = None
    reprobe = False
    if calibration is not None and getattr(calibration, "stale", False):
        # automatic re-probe policy: a DriftReport flagged this table
        # stale.  When the live backend matches the machine model,
        # RE-PROBE instead of only warning; otherwise the stale table
        # must not keep seeding searches, so fall back to the roofline.
        ratio = getattr(calibration, "stale_ratio", None)
        attempts = getattr(calibration, "reprobes", 0)
        cap = getattr(type(calibration), "MAX_AUTO_REPROBES", 2)
        if attempts >= cap:
            log.log(
                f"calibration table still drift-stale after {attempts} "
                f"auto re-probes (measured/predicted "
                f"{ratio if ratio else '?'}): persistent cost-model "
                f"gap — using the analytic roofline; re-probe manually "
                f"with calibrate=True if the machine changed"
            )
            BUS.emit("calibration.reprobe", backend=live, ratio=ratio,
                     deferred=True, attempts=attempts)
            calibration = None
        elif live == target:
            log.log(
                f"calibration table is drift-stale "
                f"(measured/predicted {ratio if ratio else '?'}): "
                f"re-probing on the live backend "
                f"(attempt {attempts + 1}/{cap})"
            )
            BUS.emit("calibration.reprobe", backend=live, ratio=ratio,
                     deferred=False, attempts=attempts)
            calibration.begin_reprobe()
            reprobe = True
        else:
            log.log(
                f"calibration table is drift-stale but the live backend "
                f"({live!r}) cannot re-probe for "
                f"{config.machine_spec.name!r}: using the analytic "
                f"roofline until a re-probe runs on the modeled backend"
            )
            BUS.emit("calibration.reprobe", backend=live, ratio=ratio,
                     deferred=True)
            calibration = None
    can_probe = False
    if config.calibrate or reprobe:
        # probe this graph's (op, view) costs on the live backend before
        # ranking — the reference's default (it measures lazily inside
        # the search, simulator.cc:515-554; model.cu:38-74).  Probes
        # resume from the loaded table; with calibration_file set they
        # persist, so repeat compiles pay nothing.
        can_probe = live == target
        if not can_probe:
            log.log(
                f"calibrate requested but the live backend ({live!r}) "
                f"does not match the machine model "
                f"({config.machine_spec.name!r}): keeping the analytic "
                f"roofline.  Probe on the modeled backend and pass "
                f"calibration_file instead."
            )
        else:
            from flexflow_tpu_torch.search.calibration import calibrate_graph

            with log.enter(
                f"calibrating (op, view) costs on the live backend "
                f"(budget {config.calibration_budget_s:.0f}s)"
            ):
                t0 = time.monotonic()
                calibration = calibrate_graph(
                    graph, n, calibration,
                    time_budget_s=config.calibration_budget_s,
                    **_probe_kwargs(config))
                t_cal += time.monotonic() - t0
                log.log(f"{len(calibration)} measured records")
            if config.calibration_file:
                calibration.save(config.calibration_file)
    serving = None
    if getattr(config, "objective", "train") == "serve":
        # serving objective (search/serving.py): derive the arrival
        # model from the graph's own decode ops and arm it at SIM
        # CONSTRUCTION (before the cost cache computes its signature) —
        # the whole search then ranks in the p99 decode-latency
        # currency.  A serve search of a graph with no decode ops
        # degenerates to train pricing; say so instead of silently
        # renaming the objective.
        if config.comp_mode != "inference":
            # a decode step runs no backward and no gradient sync:
            # pricing the p99 currency with training costs would mint
            # an SLO number for a step that never executes — refuse
            # loudly (the same discipline as the serve+co_search guard)
            raise ValueError(
                "objective='serve' requires comp_mode='inference' "
                "(set FFConfig.comp_mode or pass "
                "model.compile(comp_mode='inference')): a decode step "
                "has no backward, so the training currency would price "
                "an SLO the serving step never runs")
        from flexflow_tpu_torch.search.serving import serving_spec_for

        serving = serving_spec_for(graph, config)
        if serving is None:
            log.log(
                "objective='serve' on a graph with no decode-attention "
                "ops: nothing is ragged here — pricing falls back to "
                "the train (mean step) currency"
            )
    sim = Simulator.for_config(config, calibration=calibration,
                               serving=serving)
    floor_sim = sim  # the sim the champion-vs-DP floor must score with
    helper = SearchHelper(sim, n)
    joint = None
    if getattr(config, "co_search", False):
        # joint strategy x comm-plan co-search (search/comm_plan.py):
        # bind one comm-plan memo to this search — every candidate the
        # helper or the unity loop grounds is then priced with its
        # best sync schedule/precision/zero plan through the
        # exposed-comm simulation instead of the legacy per-node
        # overlap credit
        from flexflow_tpu_torch.search.comm_plan import JointPricer

        joint = JointPricer(config, cost_cache=sim.cost_cache)
        helper.joint = joint

    def _price(s, g, st):
        """Candidate grounding in the search's currency: joint
        exposed-comm under co-search, legacy scalar otherwise."""
        if joint is not None:
            return joint.price(s, g, st)
        return s.simulate(g, st)


    BUS.emit(
        "search.begin", nodes=graph.num_nodes, devices=n,
        budget=config.search_budget, timeout_s=config.search_timeout_s,
        calibrated=calibration is not None,
    )

    # persistent search-result cache: the search is a deterministic
    # pure function of (graph structure, knobs, cost surface), so a
    # warm cache serves the finished (graph, strategy) — repeat
    # compiles skip the whole search
    cache = sim.cost_cache
    if cache is not None and return_graph:
        served = _serve_cached_search(cache, graph, config)
        if served is not None:
            best_graph, best_strategy, best_cost = served
            # gate the served result on the same static analysis the
            # fresh search passes: a corrupt pickled graph or an
            # illegal strategy must cost one recompute, not be reused
            bad = _lint_findings(best_graph, best_strategy, n)
            if bad:
                from flexflow_tpu_torch.analysis import emit_findings

                emit_findings(bad)
                log.log(
                    f"cost cache: served search result FAILED the "
                    f"static-analysis gate ({bad[0]}); dropping the "
                    f"entry and searching fresh"
                )
                cache.drop_search_result(graph, config)
                served = None
        if served is not None and serving is not None:
            # serve objective: served artifacts pass the SAME always-on
            # SHD16x serving gate as fresh results — an over-budget or
            # geometry-incoherent entry costs one re-search, never an
            # illegal serve
            from flexflow_tpu_torch.analysis import (
                emit_findings,
                errors_only,
                lint_serving,
            )

            sfind = lint_serving(best_graph, best_strategy, serving,
                                 floor_sim.cost,
                                 predicted_p99_s=best_cost)
            emit_findings(sfind)
            sbad = errors_only(sfind)
            if sbad:
                log.log(
                    f"cost cache: served search result FAILED the "
                    f"serving gate ({sbad[0]}); dropping the entry and "
                    f"searching fresh"
                )
                cache.drop_search_result(graph, config)
                served = None
        _served_kv_meta = None
        if served is not None and serving is not None:
            # KV lane (kv_precision / shared-prefix residency): served
            # results pass the SAME always-on SHD168/169 gate as fresh
            # ones before the provenance block is recorded — a served
            # entry that cannot carry a legal __meta__.kv costs one
            # re-search, never an illegal artifact
            _served_kv_meta = _choose_kv_precision(
                best_graph, best_strategy, config, serving, calibration)
            if _served_kv_meta is not None:
                from flexflow_tpu_torch.analysis import (
                    emit_findings,
                    errors_only,
                    lint_kv,
                )

                kfind = lint_kv(best_graph, best_strategy,
                                _served_kv_meta, serving=serving)
                emit_findings(kfind)
                kbad = errors_only(kfind)
                if kbad:
                    log.log(
                        f"cost cache: served search result FAILED the "
                        f"KV-lane gate ({kbad[0]}); dropping the entry "
                        f"and searching fresh"
                    )
                    cache.drop_search_result(graph, config)
                    served = None
        if served is not None:
            log.log(
                f"cost cache: served searched strategy "
                f"({best_cost * 1e3:.4f} ms/iter) for {graph.num_nodes}-"
                f"node graph — skipping the search"
            )
            LAST_SERVING_META = None
            LAST_KV_META = _served_kv_meta
            if serving is not None:
                from flexflow_tpu_torch.search.serving import kv_residency_bytes

                LAST_SERVING_META = {
                    "objective": "serve",
                    "p99_budget_ms": serving.p99_budget_ms,
                    "max_seqs": serving.max_seqs,
                    "page_size": serving.page_size,
                    "pages_per_seq": serving.pages_per_seq,
                    "quantile": serving.quantile,
                    "predicted_p99_step_ms": round(best_cost * 1e3, 6),
                    "kv_bytes_per_device": kv_residency_bytes(
                        best_graph, best_strategy, n, serving=serving),
                }
            _emit_search_done(
                floor_sim, best_graph, graph, best_strategy, best_cost,
                kept_dp=False, helper=helper, t_start=t_start,
                t_cal=t_cal, result_cache_hit=True,
                match_base=match_base,
            )
            # cache-served results pass the SAME schedule choice + gate
            # as fresh ones — the persisted artifact never skips it
            _build_sync_schedule(best_graph, best_strategy, sim, config,
                                 joint=joint)
            return best_graph, best_strategy
    with log.enter(f"optimize_strategy: {graph.num_nodes} nodes, {n} devices"):
        if (return_graph and config.search_budget > 0
                and graph.num_nodes > CHAIN_MIN_NODES):
            # production scale: the flat whole-graph DP recursion is
            # super-linear past the native engine's ceiling.  Seed with
            # the batch-parallel floor; the chain decomposition inside
            # the unity loop carries the real per-segment DP, and the
            # champion-vs-DP floor below still gates the final answer.
            from flexflow_tpu_torch.compiler.lowering import (
                data_parallel_strategy as _dps,
            )

            best_strategy = _dps(graph, n)
            best_cost = _price(sim, graph, best_strategy)
            log.log(
                f"baseline data-parallel cost: {best_cost * 1e3:.4f} "
                f"ms/iter (whole-graph DP deferred to the segment "
                f"chain search at this scale)")
        else:
            best_cost, best_strategy = helper.graph_cost(graph)
            log.log(f"baseline DP-search cost: {best_cost * 1e3:.4f} ms/iter")
    BUS.emit("search.baseline", cost_s=best_cost)
    best_graph = graph
    search_expired = False

    if return_graph and config.search_budget > 0:
        xfers = _load_xfers(config, n)
        deadline = (
            time.monotonic() + config.search_timeout_s
            if config.search_timeout_s > 0
            else None
        )
        opt = _UnityOptimizer(helper, config, xfers, deadline=deadline)
        with _relaxed_gc(), log.enter(f"unity outer loop: {len(xfers)} xfers"):
            opt._score_edges(graph)
            g2, c2, s2 = opt.sequence_optimize(graph, {})
            if (c2 < best_cost and s2 and can_probe
                    and calibration is not None and g2 is not graph):
                # rewrites can introduce ops the pre-rewrite probe pass
                # never measured; comparing measured originals against
                # roofline rewrites biases acceptance toward rewrites.
                # Probe the rewritten graph's new (op, view)s — inside
                # the remaining search_timeout_s budget — and re-SCORE
                # both candidate (graph, strategy) pairs with the same
                # table before accepting.
                from flexflow_tpu_torch.search.calibration import (
                    calibrate_graph,
                )

                budget = config.calibration_budget_s
                if deadline is not None:
                    budget = min(budget, max(0.0, deadline - time.monotonic()))
                n_before = len(calibration)
                ncl_before = calibration.num_clusters
                if budget > 0:
                    t0 = time.monotonic()
                    calibrate_graph(g2, n, calibration, time_budget_s=budget,
                                    **_probe_kwargs(config))
                    t_cal += time.monotonic() - t0
                if (len(calibration) > n_before
                        or calibration.num_clusters > ncl_before):
                    log.log(
                        f"probed {len(calibration) - n_before} rewritten-"
                        f"graph records + "
                        f"{calibration.num_clusters - ncl_before} clusters; "
                        f"re-scoring on equal footing"
                    )
                    if config.calibration_file:
                        calibration.save(config.calibration_file)
                    sim2 = Simulator.for_config(config, calibration=calibration,
                                                serving=serving)
                    floor_sim = sim2  # sim's _node_costs cache predates
                    # the new probes; the floor must not mix tables
                    best_cost = _price(sim2, graph, best_strategy)
                    c2 = _price(sim2, g2, s2)
            if c2 < best_cost and s2:
                log.log(
                    f"substitution improved: {best_cost * 1e3:.4f}"
                    f" -> {c2 * 1e3:.4f} ms/iter"
                )
                best_cost, best_strategy, best_graph = c2, s2, g2
            search_expired = opt._expired()

    # Champion-vs-DP floor: the simulator's fidelity is finite, so a
    # predicted win below the uncertainty margin is noise — and executing
    # a mixed-view strategy for a noise-level win pays real resharding
    # that plain DP never pays.  DP is always in the search space, so
    # this can only replace a sub-margin champion, never a genuine
    # winner.
    from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy

    dp_strategy = data_parallel_strategy(graph, n)
    dp_cost = _price(floor_sim, graph, dp_strategy)
    margin = max(0.0, config.search_improvement_margin)
    kept_dp = math.isfinite(dp_cost) and best_cost > dp_cost * (1.0 - margin)
    BUS.emit("search.floor", kept_dp=kept_dp, dp_cost_s=dp_cost,
             searched_cost_s=best_cost, margin=margin)
    if kept_dp:
        log.log(
            f"searched win {(1.0 - best_cost / dp_cost) * 100:.2f}% is "
            f"below the {margin * 100:.0f}% uncertainty margin: "
            f"keeping plain data parallelism"
        )
        best_cost, best_strategy, best_graph = dp_cost, dp_strategy, graph

    # static-analysis gate: the returned (graph, strategy) must pass
    # graph invariants + the sharding legality lint BEFORE it is
    # persisted or handed to the lowering.  A failure here is a search
    # bug, not a user error — fail loudly.  Non-finite results (nothing
    # feasible fits) are not fatal: findings are emitted and logged.
    bad = _lint_findings(best_graph, best_strategy, n) if best_strategy \
        else []
    if bad:
        from flexflow_tpu_torch.analysis import AnalysisError, emit_findings

        emit_findings(bad)
        if math.isfinite(best_cost):
            raise AnalysisError(
                "optimize_strategy produced an illegal (graph, strategy) "
                "pair", bad)
        log.log(
            f"static analysis: infeasible search result also fails the "
            f"legality lint ({bad[0]}); returning it, NOT persisting"
        )

    # serving gate (objective="serve", always-on like the strategy
    # lint above): the result must be a LEGAL serving artifact — frame
    # geometry coherent with the spec, KV residency within HBM, decode
    # views the executor's fixed frames can shard (SHD160-162; SHD163
    # warns on a blown SLO) — before it is returned or persisted.
    LAST_SERVING_META = None
    LAST_KV_META = None
    if serving is not None and best_strategy and math.isfinite(best_cost):
        from flexflow_tpu_torch.analysis import (
            AnalysisError,
            emit_findings,
            errors_only,
            lint_kv,
            lint_serving,
        )
        from flexflow_tpu_torch.search.serving import kv_residency_bytes

        sfind = lint_serving(best_graph, best_strategy, serving,
                             floor_sim.cost, predicted_p99_s=best_cost)
        emit_findings(sfind)
        sbad = errors_only(sfind)
        if sbad:
            raise AnalysisError(
                "serve-objective search produced an illegal serving "
                "artifact", sbad)
        kv = kv_residency_bytes(best_graph, best_strategy, n,
                                serving=serving)
        LAST_SERVING_META = {
            "objective": "serve",
            "p99_budget_ms": serving.p99_budget_ms,
            "max_seqs": serving.max_seqs,
            "page_size": serving.page_size,
            "pages_per_seq": serving.pages_per_seq,
            "quantile": serving.quantile,
            "predicted_p99_step_ms": round(best_cost * 1e3, 6),
            "kv_bytes_per_device": kv,
        }
        BUS.emit("search.serve", p99_s=best_cost,
                 budget_ms=serving.p99_budget_ms,
                 kv_bytes_per_device=kv, kept_dp=kept_dp)
        # KV lane (kv_precision / shared-prefix residency): choose the
        # pool dtype in the same p99 currency and gate the provenance
        # block on SHD168/169 — always-on, like the serving gate above
        LAST_KV_META = _choose_kv_precision(
            best_graph, best_strategy, config, serving, calibration)
        if LAST_KV_META is not None:
            kfind = lint_kv(best_graph, best_strategy, LAST_KV_META,
                            serving=serving)
            emit_findings(kfind)
            kbad = errors_only(kfind)
            if kbad:
                LAST_KV_META = None
                raise AnalysisError(
                    "KV-precision lane produced an illegal __meta__.kv "
                    "artifact", kbad)

    # persist: cost rows accumulated this search + the finished result
    # (only complete searches — a deadline-truncated result is not the
    # pure function's value and must not be served forever)
    cache = floor_sim.cost_cache
    if cache is not None:
        if (return_graph and not search_expired and math.isfinite(best_cost)
                and not bad):
            payload = (
                [nd.guid for nd in graph.topo_order()],
                best_graph if best_graph is not graph else None,
                dict(best_strategy),
                best_cost,
            )
            cache.put_search_result(graph, config, payload, best_cost)
        cache.save()

    _emit_search_done(
        floor_sim, best_graph, graph, best_strategy, best_cost,
        kept_dp=kept_dp, helper=helper, t_start=t_start, t_cal=t_cal,
        result_cache_hit=False, match_base=match_base,
    )

    if best_strategy and math.isfinite(best_cost):
        _build_sync_schedule(best_graph, best_strategy, floor_sim, config,
                             joint=joint)
    else:
        global LAST_SYNC_SCHEDULE, LAST_ZERO_GROUPS
        LAST_SYNC_SCHEDULE = None
        LAST_ZERO_GROUPS = ()

    if return_graph:
        return best_graph, best_strategy
    return best_strategy


def _probe_kwargs(config: FFConfig) -> dict:
    """Where calibration probes run: the config's device, in its
    compute dtype."""
    return {"device": config.torch_device(),
            "compute_dtype": config.torch_compute_dtype}


def _emit_search_done(
    floor_sim, best_graph, graph, best_strategy, best_cost, kept_dp,
    helper, t_start, t_cal, result_cache_hit, match_base=(0, 0, 0, 0, 0),
) -> None:
    """Search-completion telemetry: the final result/summary events
    plus the search-perf roll-up (delta-vs-full simulation counts,
    delta-matching rescan shrink, and persistent-cache hit rates) that
    bench_search and ffobs report."""
    from flexflow_tpu_torch.search import substitution as _subst

    sim = helper.sim
    cache = floor_sim.cost_cache or sim.cost_cache
    stats = {
        "search_seconds": round(
            max(0.0, time.monotonic() - t_start - t_cal), 3),
        "calibration_seconds": round(t_cal, 3),
        "full_sims": sim.full_sims + (
            floor_sim.full_sims if floor_sim is not sim else 0),
        "delta_sims": sim.delta_sims + (
            floor_sim.delta_sims if floor_sim is not sim else 0),
        "delta_bails": sim.delta_bails + (
            floor_sim.delta_bails if floor_sim is not sim else 0),
        # delta-aware find_matches: full-scan
        # calls vs dirty-region rescans, and the node-visit shrink the
        # rescans bought (skipped = clean nodes served from the parent)
        "match_full_scans": _subst._SCANS.value - match_base[0],
        "match_delta_scans": _subst._DELTA_SCANS.value - match_base[1],
        "match_nodes_rescanned": _subst._DELTA_NODES.value - match_base[2],
        "match_nodes_skipped": _subst._DELTA_SKIPPED.value - match_base[3],
        # per-op-type seed index: matcher
        # calls skipped because the node's op type cannot anchor the
        # xfer's pattern
        "match_index_skips": _subst._INDEX_SKIPS.value - (
            match_base[4] if len(match_base) > 4 else 0),
        "cache_row_hits": cache.row_hits if cache else 0,
        "cache_row_misses": cache.row_misses if cache else 0,
        "result_cache_hit": bool(result_cache_hit),
        # segment-reuse mechanics: incremental native
        # ctx assembly, persisted DP memo rows, and isomorphic-segment
        # stamping — the counters the scale sweep and ffobs report
        "ctx_patch_hits": helper.ctx_patch_hits,
        "ctx_rebuilds": helper.ctx_rebuilds,
        "segments_stamped": helper.segments_stamped,
        "dp_rows_served": helper.dp_rows_served,
        "dp_memo_hits": helper.memo_hits,
        "dp_memo_misses": helper.memo_misses,
        # series-parallel decomposition: which
        # decomposition each oversized (sub)graph took, the bounded-
        # width cut counts, and the sp-memo-row serves — the counters
        # the --sp-scale sweep and ffobs report
        "sp_rows_served": helper.sp_rows_served,
        "match_vec_skips": _subst._VEC_SKIPS.value - (
            match_base[5] if len(match_base) > 5 else 0),
        "match_worker_batches": _worker_batches() - (
            match_base[6] if len(match_base) > 6 else 0),
        **LAST_DECOMPOSE,
    }
    if helper.joint is not None:
        # joint strategy x comm-plan co-search: how often the candidate
        # pricing SERVED a memoized plan vs paid the full
        # choose_sync_schedule sweep (the ≥80% serve-rate acceptance
        # gate reads exactly these)
        stats["comm_plan_serves"] = helper.joint.serves
        stats["comm_plan_searches"] = helper.joint.searches
    LAST_SEARCH_STATS.clear()
    LAST_SEARCH_STATS.update(stats)
    if not BUS.enabled:
        return
    BUS.emit(
        "search.result", cost_s=best_cost,
        rewritten=best_graph is not graph,
        nodes=best_graph.num_nodes, kept_dp=kept_dp,
        table=floor_sim.strategy_table_rows(best_graph, best_strategy),
    )
    BUS.emit(
        "dp.summary", memo_hits=helper.memo_hits,
        memo_misses=helper.memo_misses,
        native_hits=helper.native_hits,
        greedy_hits=helper.greedy_hits,
    )
    BUS.emit("search.perf", **stats)


def mcmc_optimize(
    graph: Graph,
    config: FFConfig,
    iterations: int = 500,
    temperature: float = 0.05,
    seed: int = 0,
) -> Strategy:
    """Legacy MLSys'19 search: random single-op view rewrites, accepted
    if better or with prob exp(-alpha*delta)
    (reference: model.cc:3033-3122 rewrite/mcmc_optimize)."""
    from flexflow_tpu_torch.search.views import candidate_views

    n = config.search_devices
    sim = Simulator.for_config(config)
    rng = random.Random(seed)
    nodes = graph.topo_order()

    from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy

    current = dict(data_parallel_strategy(graph, n))
    cur_cost = sim.simulate(graph, current)
    best, best_cost = dict(current), cur_cost
    # single-op rewrites on a fixed graph are the ideal delta-simulation
    # case: each proposal perturbs one node (plus its consumers' edge
    # xfers), so re-cost rides the armed baseline; re-arm on accept
    sim.set_baseline(graph, current)
    for _ in range(iterations):
        node = rng.choice(nodes)
        if node.op.fixed_machine_view() is not None:
            continue
        views = candidate_views(node.op, n)
        v = rng.choice(views)
        old = current.get(node.guid)
        current[node.guid] = v
        c = sim.simulate(graph, current)
        delta = c - cur_cost
        if delta <= 0 or rng.random() < math.exp(-delta / max(temperature * cur_cost, 1e-12)):
            cur_cost = c
            sim.set_baseline(graph, current)
            if c < best_cost:
                best, best_cost = dict(current), c
        else:
            if old is None:
                current.pop(node.guid, None)
            else:
                current[node.guid] = old
    return best
