"""DP over graph splits — Unity's inner loop; a copy of
flexflow_tpu/search/dp.py.

Re-implements the algorithm of SearchHelper::graph_cost
(reference: src/runtime/graph.cc:79-295, 1276-1526): given a *fixed*
PCG, find the min-cost MachineView assignment by

* sequence-splitting at bottleneck nodes and enumerating the split
  node's views (graph.cc:96-159) — several bottleneck candidates are
  tried and memoization makes the overlap cheap,
* nonsequence-splitting independent components over SEQUENTIAL /
  VERTICAL resource partitions with real device-block offsets
  (graph.cc:161-295 execute_nonsequence_split; MachineResource
  start_gpu_id becomes MachineView.start_part),
* brute-forcing small leaves against the event-driven simulator,
* memoizing by (graph hash, fixed-view constraints, device budget,
  placement offset) (graph.cc:1356 dp_state hash).

One deliberate difference: the reference's views place ops on physical
device boxes; here views are degree vectors plus a contiguous-block
offset, and the lowering realizes placement from the degrees alone
(offsets are a simulator-level planning notion, see MachineView
docstring).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch.core.graph import Graph, Node
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.obs.events import BUS
from flexflow_tpu_torch.obs.metrics import METRICS
from flexflow_tpu_torch.search.simulator import Simulator
from flexflow_tpu_torch.search.views import boundary_views, candidate_views

# cached metric handles (registry objects are stable across reset())
_MEMO_HITS = METRICS.counter("dp.memo_hits")
_MEMO_MISSES = METRICS.counter("dp.memo_misses")
_NATIVE_HITS = METRICS.counter("dp.native_hits")
_CTX_PATCHES = METRICS.counter("dp.ctx_patch_hits")
_CTX_REBUILDS = METRICS.counter("dp.ctx_rebuilds")
_DP_ROWS_SERVED = METRICS.counter("dp.rows_served")

# persistent DP memo: rows below this node count are not worth the
# stable-digest hashing (tiny leaves re-solve in microseconds, and the
# small-segment storm would bloat COST_CACHE.json for nothing)
DP_PERSIST_MIN_NODES = 6


def _ctx_check_enabled() -> bool:
    """FLEXFLOW_TPU_DELTA_CHECK=1 also arms the ctx-patch oracle: every
    PATCHED native-DP ctx is re-derived by the full build and asserted
    identical (same topo order, same packed view/candidate arrays) —
    the incremental-assembly contract as a runtime check, mirroring the
    delta-simulation oracle in search/simulator.py."""
    import os

    return os.environ.get("FLEXFLOW_TPU_DELTA_CHECK", "") not in ("", "0")


CTX_CHECK = _ctx_check_enabled()


def _same_stamp(a, b) -> bool:
    """Element-wise stamp comparison: numbers by value, everything else
    by identity (id() of a freed CostModel can be reallocated — holding
    the references in the stamp prevents reuse, `is` detects swaps)."""
    return len(a) == len(b) and all(
        x is y or x == y if isinstance(x, (int, bool, float)) else x is y
        for x, y in zip(a, b)
    )


def _assert_ctx_equal(patched, rebuilt) -> None:
    """The ctx-patch oracle: a PATCHED native-DP ctx must be
    indistinguishable from a full rebuild — same topo order, same
    budgets, same packed per-view cost/candidate arrays, same edge
    matrices.  The C engine is a deterministic function of these
    inputs, so array equality is the whole contract."""
    import numpy as _np

    assert [n.guid for n in patched["topo"]] == \
        [n.guid for n in rebuilt["topo"]], "ctx patch: topo order diverged"
    assert patched["budgets"] == rebuilt["budgets"], \
        "ctx patch: budget set diverged"
    a, b = patched["pack"], rebuilt["pack"]
    assert set(a) == set(b), "ctx patch: pack keys diverged"
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, _np.ndarray):
            assert va.shape == vb.shape and bool((va == vb).all()), (
                f"ctx patch: packed array {k!r} diverged")
        else:
            assert va == vb, f"ctx patch: pack entry {k!r} diverged"
    ea, eb = patched["edges"], rebuilt["edges"]
    assert len(ea) == len(eb), "ctx patch: edge count diverged"
    for (sa, da, ga, ma), (sb, db, gb, mb) in zip(ea, eb):
        assert (sa, da, ga) == (sb, db, gb), "ctx patch: edge diverged"
        assert ma is mb or bool((ma == mb).all()), \
            "ctx patch: edge matrix diverged"


Strategy = Dict[int, MachineView]

# canonical strategy: ((node_structural_hash, view), ...) ordered by
# (hash, guid) at store time — guid-free, remappable onto isomorphic
# graphs (see Graph.node_hashes)
CanonStrategy = Tuple[Tuple[int, MachineView], ...]


def canon_fixed_views(graph: Graph, fixed: Strategy) -> Tuple:
    """Guid-free canonical form of pinned boundary views — the shared
    memo-key component for the DP memo and the driver's segment cache
    (must stay in lock-step; both import this)."""
    nh = graph.node_hashes()
    return tuple(
        sorted(
            (nh[g], v.dim_degrees, v.replica_degree, v.start_part)
            for g, v in fixed.items()
            if g in graph.nodes
        )
    )


def canonicalize_strategy(graph: Graph, strategy: Strategy) -> CanonStrategy:
    nh = graph.node_hashes()
    order = sorted(
        (g for g in strategy if g in graph.nodes), key=lambda g: (nh[g], g)
    )
    return tuple((nh[g], strategy[g]) for g in order)


def reconstruct_strategy(
    graph: Graph, canon: CanonStrategy, fixed: Optional[Strategy] = None
) -> Optional[Strategy]:
    """Map a canonical strategy onto ``graph``'s guids.  Nodes sharing a
    structural hash are interchangeable; ``fixed`` guids are pinned to
    their required views first (a group sibling takes the other view).
    Returns (strategy, ambiguous): ``ambiguous`` is True when any hash
    group holds >1 node — the in-group guid-order pairing is then not
    guaranteed to follow a single isomorphism across groups, so the
    caller must re-simulate rather than trust the cached cost.  Strategy
    is None when the canonical form does not fit at all (hash
    collision — caller recomputes)."""
    return _pair_views(graph, graph.node_hashes(), canon, fixed)


def _pair_views(graph: Graph, nh, canon, fixed: Optional[Strategy]):
    """The ONE guid-pairing rule shared by the in-process memo
    (``reconstruct_strategy``, int node hashes) and the persistent DP
    memo (stable hex digests): group guids by structural key, honor
    ``fixed`` pins first, pair the rest in sorted-guid order.  Both
    layers MUST pair identically or a warm serve could diverge from the
    in-process replay of the same row."""
    groups: Dict[int, List[int]] = {}
    for g in sorted(graph.nodes):
        groups.setdefault(nh[g], []).append(g)
    views: Dict[int, List[MachineView]] = {}
    for h, v in canon:
        views.setdefault(h, []).append(v)
    strategy: Strategy = {}
    fixed = fixed or {}
    ambiguous = False
    for h, guids in groups.items():
        vs = views.get(h)
        if vs is None or len(vs) != len(guids):
            return None, False
        if len(guids) > 1:
            ambiguous = True
        vs = list(vs)
        rest = []
        for g in guids:
            want = fixed.get(g)
            if want is not None:
                try:
                    vs.remove(want)
                except ValueError:
                    return None, False
                strategy[g] = want
            else:
                rest.append(g)
        for g, v in zip(rest, vs):
            strategy[g] = v
    return strategy, ambiguous


def encode_strategy_rows(graph: Graph, strategy: Strategy):
    """The persisted memo-row strategy encoding shared by the dp-row
    and sp-row layers: ``[[stable node digest, degrees, replica,
    start], ...]`` sorted by (digest, guid).  Returns None when
    ``strategy`` does not cover the graph exactly (a partial strategy
    is not a persistable result).  MUST stay the decode's inverse —
    fflint's _lint_digest_row_layer lints the same shape."""
    snh = graph.stable_node_digests()
    rows = [
        [snh[g], list(strategy[g].dim_degrees),
         int(strategy[g].replica_degree), int(strategy[g].start_part)]
        for g in sorted(strategy, key=lambda g: (snh.get(g, ""), g))
        if g in graph.nodes
    ]
    if len(rows) != graph.num_nodes:
        return None
    return rows


def decode_strategy_rows(row: dict):
    """(cost, canonical digest-keyed strategy) from a persisted memo
    row, or None on any malformation — the reader side of
    ``encode_strategy_rows``, shared by the dp-row and sp-row serves
    (a corrupt row is a miss, never a crash or a wrong serve)."""
    try:
        cost = float(row["cost"])
        canon = tuple(
            (h, MachineView(tuple(int(x) for x in dims), int(rep),
                            int(st)))
            for h, dims, rep, st in row["strategy"]
        )
    except (KeyError, TypeError, ValueError):
        return None
    return cost, canon


class SearchHelper:
    def __init__(
        self,
        simulator: Simulator,
        num_devices: int,
        leaf_threshold: int = 4,
        max_views_per_op: int = 16,
        max_bottleneck_tries: int = 2,
    ):
        self.sim = simulator
        self.num_devices = num_devices
        self.leaf_threshold = leaf_threshold
        self.max_views_per_op = max_views_per_op
        self.max_bottleneck_tries = max_bottleneck_tries
        self.memo: Dict[Tuple, Tuple[float, Strategy]] = {}
        self._views_cache: Dict[Tuple, List[MachineView]] = {}
        # native-DP digests shared across every graph this helper
        # searches (rewritten variants repeat the same op signatures);
        # cleared when the calibration table's version moves on
        # (_node_digest), so stale generations never accumulate
        self._node_digest_cache: Dict[Tuple, dict] = {}
        self._node_digest_version: object = None
        self._edge_matrix_cache: Dict[Tuple, object] = {}
        # diagnostic: how often the greedy fallback decided a subgraph —
        # zero on the model zoo (tests assert this)
        self.greedy_hits = 0
        # memo-cache effectiveness (mirrored into the global obs
        # metrics registry; the driver emits them as dp.summary)
        self.memo_hits = 0
        self.memo_misses = 0
        self.native_hits = 0
        # incremental ctx assembly + persistent DP memo + segment
        # stamping effectiveness (search.perf: ctx_patch_hits/
        # ctx_rebuilds/dp_rows_served/segments_stamped — the driver's
        # _UnityOptimizer increments segments_stamped on cache remaps)
        self.ctx_patch_hits = 0
        self.ctx_rebuilds = 0
        self.dp_rows_served = 0
        self.segments_stamped = 0
        # persisted sp-segment memo rows served (driver._serve_sp_row:
        # whole SP-segment solves — substitution search included —
        # answered from the cost cache's sp-row layer)
        self.sp_rows_served = 0
        # joint strategy x comm-plan co-search (search/comm_plan.py):
        # when the driver binds a JointPricer here, every cost this
        # helper GROUNDS (the _finish re-validation, its DP floor, the
        # ambiguous-pairing re-simulations, the native engine's
        # winners) is priced in the joint exposed-comm currency — the
        # enumeration interiors (split bounds, leaf brute force,
        # native DP) keep ranking in the fast legacy scalar currency
        # and the joint gate re-prices their winners.  None (default)
        # keeps every path bit-identical to the sequential pipeline.
        self.joint = None
        # depth gate mirroring the driver's sequence_optimize gate: the
        # joint currency grounds only the TOP-level graph_cost query
        # (the whole candidate graph) — an interior split segment
        # priced jointly in isolation is charged the full exposed sync
        # tail the merged graph hides under the other segments'
        # backward, so joint-priced segments compose into provably
        # worse merges (and every novel segment signature would pay an
        # unmemoized plan sweep).  Interior recursion suspends the
        # pricer; the top-level _finish re-prices the composed winner
        # jointly.
        self._joint_depth = 0

    def _price(self, graph, strategy) -> float:
        """Ground-truth pricing of one (graph, strategy): the joint
        exposed-comm currency under co-search, the legacy scalar
        simulation otherwise."""
        if self.joint is not None:
            return self.joint.price(self.sim, graph, strategy)
        return self.sim.simulate(graph, strategy)

    @contextmanager
    def joint_scope(self, top: bool):
        """THE depth-gate rule, shared by every gated recursion
        (``graph_cost``/``graph_cost_only`` here, the driver's
        ``sequence_optimize``): interior levels suspend the joint
        pricer — a segment priced jointly in isolation is charged the
        exposed sync tail the merged graph hides — and the top level
        keeps it, so composed winners ground jointly exactly once."""
        saved = self.joint
        if not top:
            self.joint = None
        try:
            yield
        finally:
            self.joint = saved

    # ------------------------------------------------------------------
    def _views(self, node: Node, budget: int, start: int = 0) -> List[MachineView]:
        key = (node.op.signature(), budget, start)
        if key not in self._views_cache:
            views = candidate_views(
                node.op, budget, max_views=self.max_views_per_op
            )
            if start:
                views = [dataclasses.replace(v, start_part=start) for v in views]
            self._views_cache[key] = views
        return self._views_cache[key]

    def _bviews(self, node: Node, budget: int, start: int = 0) -> List[MachineView]:
        """Compact diverse view set for split-boundary pinning — the DP
        state count is intervals x boundary-view products, so this stays
        at the reference's ~4-view scale (graph.cc:1778 registers only
        1-D divisor views)."""
        key = ("b", node.op.signature(), budget, start)
        if key not in self._views_cache:
            views = boundary_views(node.op, budget)
            if start:
                views = [dataclasses.replace(v, start_part=start) for v in views]
            self._views_cache[key] = views
        return self._views_cache[key]

    def _fixed_view(self, node: Node, start: int) -> Optional[MachineView]:
        fv = node.op.fixed_machine_view()
        if fv is not None and start:
            fv = dataclasses.replace(fv, start_part=start)
        return fv

    # ------------------------------------------------------------------
    # native DP engine (native/src/dp_engine.cpp): the ENTIRE graph_cost
    # recursion in C++ for the default cost currency — the reference
    # keeps this loop in C++ for the same reason (graph.cc:79-295).
    # Eligibility: no placement-overlap credit (starts are cost-inert in
    # the default currency — the planning mode stays Python) and <=256
    # nodes; every pinned view must exist in the exported view sets.
    # Fusion-cluster ratios are per-(member, own-view) quantities
    # (simulate()'s cluster_scale note) and bake into the exported rows
    # — a cluster-bearing table no longer forces the python path.
    def _native_dp_ctx(self, graph: Graph):
        if self.sim.placement_overlap:
            return None
        if graph.num_nodes > 256 or graph.num_nodes == 0:
            return None
        # staleness stamp: the digest bakes in the graph's structure and
        # THIS helper's costing surface — a mutated graph (graph.hash()
        # changes; Graph._invalidate clears its cache on mutation) or a
        # different machine/device configuration must re-digest
        # strong refs in the stamp compared with `is`: id() of a freed
        # CostModel can be reallocated to a new one and validate a
        # stale digest; holding the reference prevents address reuse
        # outright
        cal = self.sim.cost.calibration
        stamp = (
            graph.hash(), self.num_devices, self.sim.machine,
            self.sim.cost, cal,
            # content fingerprint: the same table OBJECT mutated in
            # place (driver's in-place recalibration pattern, or a
            # same-key re-measurement) must invalidate the ctx, or
            # baked rows keep pre-mutation costs while the python
            # engine sees the new records.  version bumps on EVERY put.
            getattr(cal, "version", -1) if cal is not None else -1,
            self.sim.inference,
            self.leaf_threshold, self.max_bottleneck_tries,
        )

        cached = getattr(graph, "_ndp_ctx", None)
        if cached == "ineligible":
            return None  # hard override (tests force the Python path)
        if cached is not None and _same_stamp(cached[0], stamp):
            return cached[1]  # may be None (= ineligible)
        from flexflow_tpu_torch import native as _native

        if _native.get_lib() is None:
            graph._ndp_ctx = (stamp, None)
            return None
        # incremental assembly: a substitution candidate patches its
        # parent's ctx from the changed-guid seed sets instead of
        # re-deriving every per-node block (the per-pop tier-2
        # rebuild); a failed patch falls back to the full
        # build, and FLEXFLOW_TPU_DELTA_CHECK asserts patched == rebuilt
        ctx = None
        try:
            ctx = self._patch_native_dp(graph, stamp)
        except Exception:
            ctx = None
        if ctx is not None:
            self.ctx_patch_hits += 1
            _CTX_PATCHES.inc()
            if CTX_CHECK:
                _assert_ctx_equal(ctx, self._build_native_dp(graph))
        else:
            try:
                ctx = self._build_native_dp(graph)
            except Exception:
                ctx = None
            self.ctx_rebuilds += 1
            _CTX_REBUILDS.inc()
        graph._ndp_ctx = (stamp, ctx)
        return ctx

    def _node_digest(self, node: Node, budgets: List[int]):
        """Per-op-signature digest shared across every graph this
        helper searches (rewritten variants repeat the same ops): the
        union candidate-view list, per-view (cost row, propagated
        sharding), per-budget candidate/boundary/default index lists,
        and the trivial/fixed view indices."""
        cal = self.sim.cost.calibration
        # digest rows bake per-(op, view) calibration lookups, so an
        # in-place recalibration must re-bake them.  The cache is
        # CLEARED on a version change rather than keyed by it — a
        # version-widened key retains every superseded generation of
        # rows and grows without bound across calibration rounds
        ver = getattr(cal, "version", None) if cal is not None else None
        if self._node_digest_version != ver:
            self._node_digest_cache.clear()
            self._node_digest_version = ver
        sig = node.op.signature()
        hit = self._node_digest_cache.get(sig)
        if hit is not None:
            return hit
        import numpy as _np

        sim = self.sim
        views: List[MachineView] = []
        view_key: Dict[Tuple, int] = {}

        def intern(mv: MachineView) -> int:
            key = (mv.dim_degrees, mv.replica_degree)
            got = view_key.get(key)
            if got is None:
                got = len(views)
                view_key[key] = got
                views.append(
                    dataclasses.replace(mv, start_part=0)
                    if mv.start_part else mv
                )
            return got

        nd = node.op.output_shapes[0].ndim
        shape = node.op.output_shapes[0]
        trivial = intern(MachineView.trivial(nd))
        fv = node.op.fixed_machine_view()
        fixed = intern(fv) if fv is not None else -1
        cand_lists, bview_lists, defaults = [], [], []
        for b in budgets:
            cand_lists.append([intern(v) for v in self._views(node, b)])
            bview_lists.append([intern(v) for v in self._bviews(node, b)])
            # _default_strategy's per-node dp view for this budget
            mv = None
            if nd and 0 in node.op.splittable_output_dims():
                d = b
                while d > 1 and shape.sizes[0] % d != 0:
                    d //= 2
                if d > 1:
                    mv = MachineView.data_parallel(nd, d)
            defaults.append(intern(mv) if mv is not None else trivial)
        nv = len(views)
        rows = _np.zeros((nv, 4), dtype=_np.float64)  # fwd full sync mem
        parts = _np.ones(nv, dtype=_np.int32)
        valid = _np.zeros(nv, dtype=_np.uint8)
        annots: List[Optional[object]] = []
        for vi, mv in enumerate(views):
            osh = sim._propagate(node, mv)
            annots.append(osh)
            if osh is None:
                continue
            rows[vi] = sim._node_costs(node, mv)
            parts[vi] = mv.num_parts
            valid[vi] = 1
        digest = {
            "views": views, "view_key": view_key, "rows": rows,
            "parts": parts, "valid": valid, "annots": annots,
            "cand": cand_lists, "bview": bview_lists,
            "default": defaults, "trivial": trivial, "fixed": fixed,
            # flat per-signature arrays (node-major, budget-minor once
            # concatenated): _pack_native_dp assembles a ctx by
            # concatenating these per node instead of re-flattening
            # python lists per (node, budget) on every build
            "cand_counts": _np.asarray(
                [len(c) for c in cand_lists], dtype=_np.int32),
            "cand_flat": _np.asarray(
                [i for lst in cand_lists for i in lst], dtype=_np.int32),
            "bview_counts": _np.asarray(
                [len(b) for b in bview_lists], dtype=_np.int32),
            "bview_flat": _np.asarray(
                [i for lst in bview_lists for i in lst], dtype=_np.int32),
            "default_arr": _np.asarray(defaults, dtype=_np.int32),
        }
        self._node_digest_cache[sig] = digest
        return digest

    def _edge_matrix(self, src: Node, dst: Node, src_idx: int,
                     dst_idx: int, budgets: List[int]):
        """Baked xfer matrix over the two ops' union view lists —
        a pure function of the endpoint signatures (+ this helper's
        budgets), so isomorphic edges across all searched graphs share
        one bake."""
        key = (src.op.signature(), dst.op.signature(), src_idx, dst_idx)
        hit = self._edge_matrix_cache.get(key)
        if hit is not None:
            return hit
        import numpy as _np

        sim = self.sim
        ds, dd = self._node_digest(src, budgets), self._node_digest(
            dst, budgets)
        shape = src.op.output_shapes[src_idx]
        mat = _np.empty((len(ds["views"]), len(dd["views"])),
                        dtype=_np.float64)
        for svi, s_osh in enumerate(ds["annots"]):
            for dvi, d_osh in enumerate(dd["annots"]):
                if s_osh is None or d_osh is None:
                    mat[svi, dvi] = math.inf
                    continue
                src_annot = (
                    s_osh.outputs[src_idx]
                    if src_idx < len(s_osh.outputs) else None
                )
                dst_annot = (
                    d_osh.inputs[dst_idx]
                    if dst_idx < len(d_osh.inputs) else None
                )
                mat[svi, dvi] = sim.cost.xfer_cost(
                    shape, src_annot, dst_annot)
        self._edge_matrix_cache[key] = mat
        return mat

    def _dp_budgets(self) -> Tuple[List[int], List[int]]:
        cands = sorted(self._budget_cands())
        return sorted(set(cands) | {self.num_devices}), cands

    def _node_block(self, node: Node, budgets: List[int], membership):
        """Per-node assembly unit of the native-DP ctx: the shared
        per-signature digest plus this GRAPH's cluster-scaled cost rows
        (scaling is chain-contextual, so it adjusts a per-graph copy,
        never the digest cache).  ``cm_key`` fingerprints the chain
        context the rows were scaled under — the patch path may reuse a
        block only while it matches."""
        d = self._node_digest(node, budgets)
        rows = d["rows"]
        cm_key = None
        cm = membership.get(node.guid) if membership else None
        if cm is not None:
            cm_key = (tuple(m.guid for m in cm[0]), cm[1])
            rows = rows.copy()
            for vi, mv in enumerate(d["views"]):
                if not d["valid"][vi]:
                    continue
                rows[vi] = self.sim.cluster_scaled_costs(
                    node, mv, tuple(rows[vi]), membership)
        return {"digest": d, "rows": rows, "cm_key": cm_key}

    def _assemble_native_dp(self, graph: Graph, blocks: Dict[int, dict],
                            budgets: List[int], cands: List[int]):
        """Concatenate per-node blocks (topo order) into the packed
        arrays the native engine consumes, upload, and return the ctx.
        The per-(node, budget) candidate/boundary lists ride the
        digests' pre-flattened arrays (``cand_flat``/``bview_flat``), so
        assembly is numpy concatenation instead of the O(nodes x
        budgets) python loops the per-pop rebuild used to pay."""
        import numpy as _np

        from flexflow_tpu_torch import native as _native

        sim = self.sim
        topo = graph.topo_order()
        n = len(topo)
        index = {node.guid: i for i, node in enumerate(topo)}
        guid_rank = {g: r for r, g in enumerate(sorted(graph.nodes))}

        digests = [blocks[node.guid]["digest"] for node in topo]
        rows_list = [blocks[node.guid]["rows"] for node in topo]
        ndp = _native.NativeDPGraph(
            n, self.num_devices, sim.machine.hbm_capacity,
            include_update=not sim.inference,
            leaf_threshold=self.leaf_threshold,
            max_tries=self.max_bottleneck_tries,
        )
        node_off = _np.zeros(n + 1, dtype=_np.int32)
        _np.cumsum([len(d["views"]) for d in digests], out=node_off[1:])
        pack = {
            "node_off": node_off,
            "fwd": _np.concatenate([r[:, 0] for r in rows_list]),
            "full": _np.concatenate([r[:, 1] for r in rows_list]),
            "sync": _np.concatenate([r[:, 2] for r in rows_list]),
            "mem": _np.concatenate([r[:, 3] for r in rows_list]),
            "parts": _np.concatenate([d["parts"] for d in digests]),
            "valid": _np.concatenate([d["valid"] for d in digests]),
            "fixed": _np.asarray([d["fixed"] for d in digests],
                                 dtype=_np.int32),
            "trivial": _np.asarray([d["trivial"] for d in digests],
                                   dtype=_np.int32),
            "guid_rank": _np.asarray(
                [guid_rank[node.guid] for node in topo], dtype=_np.int32),
        }
        ndp.set_views(node_off, pack["fwd"], pack["full"], pack["sync"],
                      pack["mem"], pack["parts"], pack["valid"])
        ndp.set_node_meta(pack["fixed"], pack["trivial"], pack["guid_rank"])
        ndp.set_budgets(budgets, cands)
        nb = len(budgets)
        cand_counts = _np.concatenate([d["cand_counts"] for d in digests])
        bview_counts = _np.concatenate([d["bview_counts"] for d in digests])
        cand_off = _np.zeros(n * nb + 1, dtype=_np.int64)
        bview_off = _np.zeros(n * nb + 1, dtype=_np.int64)
        _np.cumsum(cand_counts, out=cand_off[1:])
        _np.cumsum(bview_counts, out=bview_off[1:])
        pack["cand_off"] = cand_off
        pack["bview_off"] = bview_off
        pack["cand_idx"] = _np.concatenate([d["cand_flat"] for d in digests])
        pack["bview_idx"] = _np.concatenate(
            [d["bview_flat"] for d in digests])
        pack["default_idx"] = _np.concatenate(
            [d["default_arr"] for d in digests])
        ndp.set_lists(cand_off, pack["cand_idx"], bview_off,
                      pack["bview_idx"], pack["default_idx"])

        edges = []
        for guid in graph.nodes:
            for e in graph.out_edges[guid]:
                mat = self._edge_matrix(
                    graph.nodes[e.src], graph.nodes[e.dst],
                    e.src_idx, e.dst_idx, budgets)
                has_grad = not graph.nodes[e.src].op.is_gradient_free
                ndp.add_edge(index[e.src], index[e.dst], has_grad, mat)
                if CTX_CHECK:
                    edges.append((index[e.src], index[e.dst], has_grad, mat))
        ctx = {"ndp": ndp, "index": index,
               "views": [d["views"] for d in digests],
               "view_key": [d["view_key"] for d in digests],
               "topo": topo, "budgets": set(budgets), "blocks": blocks}
        if CTX_CHECK:
            # pack/edges duplicate what blocks + the native graph already
            # hold; only the patched-vs-rebuilt oracle reads them.
            ctx["pack"] = pack
            ctx["edges"] = edges
        return ctx

    def _build_native_dp(self, graph: Graph):
        budgets, cands = self._dp_budgets()
        membership = self.sim.cluster_membership(graph)
        blocks = {
            node.guid: self._node_block(node, budgets, membership)
            for node in graph.topo_order()
        }
        return self._assemble_native_dp(graph, blocks, budgets, cands)

    def _patch_native_dp(self, graph: Graph, stamp):
        """Incremental ctx assembly: a substitution candidate reuses its
        parent ctx's per-node blocks outside the changed-guid seed sets
        (the same sets that drive delta simulation and delta matching)
        and re-derives blocks only for the dirty cone.  A block is a
        pure function of (op signature, budgets, chain membership, cost
        surface); the stamp tail proves the surface matches and
        ``cm_key`` proves the chain context does.  Returns None when
        ineligible — the caller falls back to the full build — and the
        FLEXFLOW_TPU_DELTA_CHECK oracle asserts patched == rebuilt."""
        cv = getattr(graph, "_changed_vs", None)
        if cv is None:
            return None
        parent = cv[0]()
        if parent is None:
            return None
        pcached = getattr(parent, "_ndp_ctx", None)
        if pcached in (None, "ineligible") or pcached[1] is None:
            return None
        if not _same_stamp(pcached[0][1:], stamp[1:]):
            return None  # costing surface moved under the parent ctx
        pblocks = pcached[1].get("blocks")
        if pblocks is None:
            return None
        dirty = set(cv[1]) | set(cv[2])
        budgets, cands = self._dp_budgets()
        membership = self.sim.cluster_membership(graph)
        blocks: Dict[int, dict] = {}
        for node in graph.topo_order():
            g = node.guid
            pb = None if g in dirty else pblocks.get(g)
            if pb is not None:
                cm = membership.get(g) if membership else None
                cm_key = (
                    (tuple(m.guid for m in cm[0]), cm[1])
                    if cm is not None else None
                )
                if cm_key != pb["cm_key"]:
                    pb = None  # chain context shifted under a clean guid
            blocks[g] = pb if pb is not None else self._node_block(
                node, budgets, membership)
        return self._assemble_native_dp(graph, blocks, budgets, cands)

    def _budget_cands(self) -> List[int]:
        """_sub_budgets' candidate sizes (shared with the native DP)."""
        divs = [d for d in range(1, self.num_devices + 1)
                if self.num_devices % d == 0]
        cands = set(divs)
        dph = getattr(self.sim.machine, "devices_per_host", 0)
        if 1 < dph < self.num_devices:
            cands.update(
                k * dph for k in range(1, self.num_devices // dph + 1)
            )
        return sorted(cands)

    def _native_graph_cost(self, graph: Graph, fixed: Strategy,
                           budget: int) -> Optional[Tuple[float, Strategy]]:
        ctx = self._native_dp_ctx(graph)
        if ctx is None or budget not in ctx["budgets"]:
            return None
        index, view_key = ctx["index"], ctx["view_key"]
        fixed_native: Dict[int, int] = {}
        for g, v in fixed.items():
            if g not in index:
                continue
            vi = view_key[index[g]].get((v.dim_degrees, v.replica_degree))
            if vi is None:
                return None  # pinned view outside the exported sets
            fixed_native[index[g]] = vi
        ndp = ctx["ndp"]
        before = ndp.greedy_hits()
        cost, assign = ndp.graph_cost(
            list(index.values()), fixed_native, budget)
        self.greedy_hits += ndp.greedy_hits() - before
        strategy: Strategy = {}
        for node in ctx["topo"]:
            vi = int(assign[index[node.guid]])
            if vi >= 0:
                strategy[node.guid] = ctx["views"][index[node.guid]][vi]
        # keep the caller's pinned views object-identical (start offsets
        # on fixed boundary views are preserved even though they are
        # cost-inert in this currency)
        for g, v in fixed.items():
            if g in strategy:
                strategy[g] = v
        # mirror the result into the Python memo: isomorphic graphs with
        # different guids (repeated blocks seen through other Graph
        # objects) then reuse it via canonical remapping exactly as the
        # Python path would.  Under co-search the caller routes this
        # winner through _finish (joint re-pricing + floor), which owns
        # the memo write there — mirroring the native scalar cost would
        # poison the joint-currency memo.
        if self.joint is None:
            key = (graph.hash(), canon_fixed_views(graph, fixed), budget, 0)
            if key not in self.memo:
                self.memo[key] = (
                    float(cost), canonicalize_strategy(graph, strategy))
                self._persist_dp_row(graph, fixed, budget, 0, float(cost),
                                     strategy)
        return float(cost), strategy

    # ------------------------------------------------------------------
    # persistent DP memo (cost_cache.py dp-row layer): tier-2 segment
    # results keyed by PROCESS-STABLE digests, so a cold process skips
    # DP on any segment a prior run has solved.  Serving is restricted
    # to rows LOADED from disk — within one run the in-process memo is
    # a superset of anything this run wrote, so the layer is inert on a
    # cold cache and the bit-identical regression gate holds.

    def _dp_cache_warm(self) -> bool:
        cc = self.sim.cost_cache
        return cc is not None and getattr(cc, "dp_loaded", False) \
            and not cc.stale

    def _dp_persist_key(self, graph: Graph, fixed: Strategy, budget: int,
                        start: int) -> str:
        """Guid-free persistent key: stable graph digest + stable
        canonical pinned views + every knob that changes the DP's
        answer and is not already in the cache's cost-surface signature
        (budget/start plus this helper's search shape)."""
        from hashlib import blake2b

        from flexflow_tpu_torch.search.cost_cache import stable_graph_digest

        snh = graph.stable_node_digests()
        pins = tuple(sorted(
            (snh[g], tuple(v.dim_degrees), int(v.replica_degree),
             int(v.start_part))
            for g, v in fixed.items() if g in graph.nodes
        ))
        knobs = (budget, start, self.num_devices, self.leaf_threshold,
                 self.max_views_per_op, self.max_bottleneck_tries,
                 bool(self.sim.placement_overlap))
        if self.joint is not None:
            # joint-currency rows live under their own key family so a
            # sequential-pipeline run never serves a co-searched cost
            # (extension-only: off-mode keys stay byte-identical)
            knobs = knobs + ("co_search",)
        tail = blake2b(repr((pins, knobs)).encode(),
                       digest_size=10).hexdigest()
        return stable_graph_digest(graph) + ":" + tail

    def _serve_persistent_dp(self, graph, fixed, budget, start):
        """(cost, strategy) from a persisted DP memo row remapped onto
        this graph's guids, or None.  The remap uses the SAME pairing
        rule as the in-process memo (_pair_views) over stable digests;
        ambiguous pairings are re-simulated for an honest cost, and the
        stamped strategy must still pass the SHD1xx legality lint — a
        corrupt row costs one recompute, never a wrong serve."""
        if graph.num_nodes < DP_PERSIST_MIN_NODES:
            return None
        cc = self.sim.cost_cache
        row = cc.get_dp_row(
            self._dp_persist_key(graph, fixed, budget, start))
        if row is None:
            return None
        decoded = decode_strategy_rows(row)
        if decoded is None:
            return None
        cost, canon = decoded
        strategy, ambiguous = _pair_views(
            graph, graph.stable_node_digests(), canon, fixed)
        if strategy is None or len(strategy) != graph.num_nodes:
            return None
        if ambiguous:
            cost = self._price(graph, strategy)
        from flexflow_tpu_torch.analysis import errors_only, lint_strategy

        if errors_only(lint_strategy(graph, strategy, self.num_devices)):
            return None
        key = self._memo_key(graph, fixed, budget, start)
        if key not in self.memo:
            self.memo[key] = (cost, canonicalize_strategy(graph, strategy))
        self.dp_rows_served += 1
        _DP_ROWS_SERVED.inc()
        return cost, strategy

    def _persist_dp_row(self, graph, fixed, budget, start, cost,
                        strategy) -> None:
        cc = self.sim.cost_cache
        if (cc is None or cc.stale or not math.isfinite(cost)
                or graph.num_nodes < DP_PERSIST_MIN_NODES or not strategy):
            return
        rows = encode_strategy_rows(graph, strategy)
        if rows is None:
            return  # partial coverage is not a DP result
        cc.put_dp_row(self._dp_persist_key(graph, fixed, budget, start),
                      float(cost), rows)

    def _memo_lookup(self, graph, key, fixed):
        """The in-process structural memo hit path (reconstruction +
        ambiguity grounding) shared by graph_cost and the warm-serve
        prelude."""
        hit = self.memo.get(key)
        if hit is None:
            return None
        cost, canon = hit
        strategy, ambiguous = reconstruct_strategy(graph, canon, fixed)
        if strategy is None:
            return None
        if ambiguous:
            # multi-member hash groups: the in-group pairing may not
            # follow one isomorphism, so the cached cost may not match
            # this strategy — ground it in the sim
            cost = self._price(graph, strategy)
        return cost, strategy

    # ------------------------------------------------------------------
    def _memo_key(self, graph, fixed, budget: int, start: int) -> Tuple:
        """In-process memo key.  Joint-priced rows (top-level queries
        under co-search) live under their own key family so a
        scalar-currency lookup can never serve an exposed-comm cost
        into a bound comparison (and vice versa) — the same
        extension-only marker the persistent dp layer carries."""
        key = (graph.hash(), canon_fixed_views(graph, fixed), budget, start)
        if self.joint is not None:
            key = key + ("co_search",)
        return key

    def graph_cost(
        self,
        graph: Graph,
        fixed: Optional[Strategy] = None,
        budget: Optional[int] = None,
        start: int = 0,
    ) -> Tuple[float, Strategy]:
        """Depth-gated wrapper (see ``joint_scope``): interior split
        recursion suspends the joint pricer, the top level keeps it."""
        top = self._joint_depth == 0
        self._joint_depth += 1
        try:
            with self.joint_scope(top):
                return self._graph_cost_gated(graph, fixed, budget, start)
        finally:
            self._joint_depth -= 1

    def _graph_cost_gated(
        self,
        graph: Graph,
        fixed: Optional[Strategy] = None,
        budget: Optional[int] = None,
        start: int = 0,
    ) -> Tuple[float, Strategy]:
        """Min cost + argmin strategy for ``graph`` with some nodes' views
        pinned by ``fixed`` (split-boundary nodes), using ``budget``
        devices beginning at device ``start``."""
        fixed = fixed or {}
        budget = budget or self.num_devices
        if self._dp_cache_warm() or self.joint is not None:
            # warm prelude: the in-process memo first (repeat queries
            # must not re-lint a served row), then the persisted rows —
            # BEFORE the native engine, which is the work being skipped.
            # Co-search also takes this prelude: _finish's joint
            # re-pricing is the expensive step there, so repeat queries
            # must serve the memoized joint cost instead of re-pricing
            key = self._memo_key(graph, fixed, budget, start)
            got = self._memo_lookup(graph, key, fixed)
            if got is not None:
                self.memo_hits += 1
                _MEMO_HITS.inc()
                return got
            if self._dp_cache_warm():
                served = self._serve_persistent_dp(graph, fixed, budget,
                                                   start)
                if served is not None:
                    return served
        if start == 0:
            native = self._native_graph_cost(graph, fixed, budget)
            if native is not None:
                self.native_hits += 1
                _NATIVE_HITS.inc()
                if self.joint is not None:
                    # the native engine enumerated in the legacy scalar
                    # currency; its winner still passes the joint gate
                    # (re-price + DP floor + memo) like every other
                    # DP result
                    key = self._memo_key(graph, fixed, budget, start)
                    return self._finish(graph, key, native[0], native[1],
                                        fixed, budget, start)
                return native
        # structural memo: keyed by graph hash + guid-free canonical
        # fixed views, so isomorphic segments with different guids
        # (repeated transformer layers, Inception blocks) share work.
        # Cached strategies are canonical and remapped onto the caller's
        # guids (reconstruct_strategy); a guid-set key would block
        # exactly this sharing and make 12-layer search intractable.
        key = self._memo_key(graph, fixed, budget, start)
        got = self._memo_lookup(graph, key, fixed)
        if got is not None:
            self.memo_hits += 1
            _MEMO_HITS.inc()
            return got

        self.memo_misses += 1
        _MEMO_MISSES.inc()
        cost, strategy = self._graph_cost_uncached(graph, fixed, budget, start)
        return self._finish(graph, key, cost, strategy, fixed, budget, start)

    def graph_cost_only(
        self,
        graph: Graph,
        fixed: Optional[Strategy] = None,
        budget: Optional[int] = None,
        start: int = 0,
    ) -> float:
        """Depth-gated like ``graph_cost`` (see ``joint_scope``)."""
        top = self._joint_depth == 0
        self._joint_depth += 1
        try:
            with self.joint_scope(top):
                return self._graph_cost_only_gated(graph, fixed, budget,
                                                   start)
        finally:
            self._joint_depth -= 1

    def _graph_cost_only_gated(
        self,
        graph: Graph,
        fixed: Optional[Strategy] = None,
        budget: Optional[int] = None,
        start: int = 0,
    ) -> float:
        """Cost without strategy materialization — memo hits skip the
        canonical-strategy reconstruction, which dominates enumeration
        loops (the reference's templated float-only graph_cost,
        graph.cc:1456-1526, exists for exactly this reason)."""
        fixed = fixed or {}
        budget = budget or self.num_devices
        if self._dp_cache_warm() or self.joint is not None:
            key = self._memo_key(graph, fixed, budget, start)
            hit = self.memo.get(key)
            if hit is not None:
                self.memo_hits += 1
                _MEMO_HITS.inc()
                return hit[0]
            if self._dp_cache_warm():
                served = self._serve_persistent_dp(graph, fixed, budget,
                                                   start)
                if served is not None:
                    return served[0]
        if start == 0:
            native = self._native_graph_cost(graph, fixed, budget)
            if native is not None:
                self.native_hits += 1
                _NATIVE_HITS.inc()
                if self.joint is not None:
                    key = self._memo_key(graph, fixed, budget, start)
                    return self._finish(graph, key, native[0], native[1],
                                        fixed, budget, start)[0]
                return native[0]
        key = self._memo_key(graph, fixed, budget, start)
        hit = self.memo.get(key)
        if hit is not None:
            # the cached cost is achievable on any isomorphic graph, so
            # no reconstruction is needed for cost-only queries
            self.memo_hits += 1
            _MEMO_HITS.inc()
            return hit[0]
        self.memo_misses += 1
        _MEMO_MISSES.inc()
        cost, strategy = self._graph_cost_uncached(graph, fixed, budget, start)
        return self._finish(graph, key, cost, strategy, fixed, budget, start)[0]

    def _finish(self, graph, key, cost, strategy, fixed, budget, start):
        # Re-validate against the simulator: split-based composition
        # over-counts boundary nodes and assumes realizable overlap; the
        # event-driven sim of the full (sub)graph is ground truth.
        # Under co-search this is THE DP re-validation the co-search
        # prices jointly: the composed strategy and the DP floor both
        # carry their best comm plan into the comparison.
        if strategy:
            cost = self._price(graph, strategy)
        # Floor: the batch-parallel default is always in the search
        # space, so the result must never be worse than it (the split
        # composition optimizes a bound, not the true cost, and can
        # otherwise steer to a worse re-validated strategy).
        dp = self._default_strategy(graph, fixed, budget, start)
        c_dp = self._price(graph, dp)
        if c_dp < cost:
            cost, strategy = c_dp, dp
        self.memo[key] = (cost, canonicalize_strategy(graph, strategy))
        self._persist_dp_row(graph, fixed, budget, start, cost, strategy)
        return cost, strategy

    def _default_strategy(self, graph, fixed, budget, start) -> Strategy:
        """Batch-parallel-where-possible assignment honoring ``fixed``
        (the reference's --only-data-parallel construction,
        graph.cc:1572-1597, restricted to the segment's resources)."""
        out: Strategy = {}
        for guid, node in graph.nodes.items():
            if guid in fixed:
                out[guid] = fixed[guid]
                continue
            fv = self._fixed_view(node, start)
            if fv is not None:
                out[guid] = fv
                continue
            shape = node.op.output_shapes[0]
            nd = shape.ndim
            mv = None
            if nd and 0 in node.op.splittable_output_dims():
                d = budget
                while d > 1 and shape.sizes[0] % d != 0:
                    d //= 2
                if d > 1:
                    mv = MachineView.data_parallel(nd, d)
            if mv is None:
                mv = MachineView.trivial(nd)
            if start:
                mv = dataclasses.replace(mv, start_part=start)
            out[guid] = mv
        return out

    def _graph_cost_uncached(self, graph, fixed, budget, start):
        n_free = sum(1 for g in graph.nodes if g not in fixed)
        if graph.num_nodes <= self.leaf_threshold or n_free <= 2:
            return self._leaf_cost(graph, fixed, budget, start)

        # nonsequence split: independent components (graph.cc:161-295)
        comps = graph.weakly_connected_components()
        if len(comps) > 1:
            return self._component_cost(graph, fixed, budget, start, comps)

        # sequence split at a bottleneck (graph.cc:96-159).  Several
        # candidates are tried (first/middle/last of the bottleneck
        # chain); the memo makes revisited intervals cheap, and chains
        # reach the same optimum from any split point.  Large graphs try
        # a single balanced split and fewer boundary views — the state
        # count is intervals x boundary-view-pairs, and the reference
        # keeps the same product small via 1-D views + its outer-loop
        # threshold (graph.cc:1778, substitution.cc:2007).
        bottlenecks = [b for b in graph.bottlenecks() if b.guid not in fixed]
        large = graph.num_nodes > 6 * self.leaf_threshold
        tries = (
            [bottlenecks[len(bottlenecks) // 2]]
            if (large and bottlenecks)
            else self._pick_bottlenecks(bottlenecks)
        )
        # enumerate with cost-only DP; materialize the winner's strategy
        # once at the end (memo hits make it two reconstructions)
        best_c, best_plan = math.inf, None
        for bn in tries:
            try:
                pre, post = graph.split_at_node(bn)
            except ValueError:
                continue
            for v in self._bviews(bn, budget, start):
                f2 = dict(fixed)
                f2[bn.guid] = v
                c_pre = self.graph_cost_only(pre, f2, budget, start)
                if c_pre >= best_c:
                    continue
                c_post = self.graph_cost_only(post, f2, budget, start)
                total = c_pre + c_post
                if total < best_c:
                    best_c, best_plan = total, (pre, post, f2, bn.guid, v)
        if best_plan is not None:
            pre, post, f2, bn_guid, v = best_plan
            if BUS.enabled:
                BUS.emit(
                    "dp.split", op=graph.nodes[bn_guid].op.name,
                    pre_nodes=pre.num_nodes, post_nodes=post.num_nodes,
                    cost_s=best_c, budget=budget,
                )
            _, s_pre = self.graph_cost(pre, f2, budget, start)
            _, s_post = self.graph_cost(post, f2, budget, start)
            s = dict(s_pre)
            s.update(s_post)
            s[bn_guid] = v
            return best_c, s

        # no usable bottleneck: nonsequence split BETWEEN the boundary
        # nodes — drop sources/sinks, partition the interior's parallel
        # branches (reference: find_optimal_nonsequence_graph_time,
        # graph.cc:241-295, where source/sink carry NodeAssignments).
        # This is the Inception shape: branches diverging from one node
        # and reconverging at a concat.
        interior = self._interior_split(graph, fixed, budget, start)
        if interior is not None:
            return interior
        # leaf brute force (compact-view fallback inside) before the
        # per-node greedy — mid-size branch interiors land here
        return self._leaf_cost(graph, fixed, budget, start)

    def _interior_split(self, graph, fixed, budget, start):
        srcs = {g for g in graph.nodes if not graph.in_edges[g]}
        sinks = {g for g in graph.nodes if not graph.out_edges[g]}
        bounds = srcs | sinks
        interior = set(graph.nodes) - bounds
        if not interior or not bounds:
            return None
        inner = graph._subgraph(interior)
        comps = inner.weakly_connected_components()
        if len(comps) < 2:
            return None
        unfixed = sorted(b for b in bounds if b not in fixed)
        choice_lists = [
            self._bviews(graph.nodes[b], budget, start) for b in unfixed
        ]
        n_combos = 1
        for c in choice_lists:
            n_combos *= max(1, len(c))
        if n_combos > 256:
            # too many boundary choices: pin them to the batch-parallel
            # default and let the components search freely
            choice_lists = [c[:1] for c in choice_lists]
        best = (math.inf, {})
        for combo in itertools.product(*choice_lists):
            f2 = dict(fixed)
            for b, v in zip(unfixed, combo):
                f2[b] = v
            c_in, _ = self._component_cost(
                inner, f2, budget, start, comps, cost_only=True
            )
            if c_in >= best[0]:
                continue
            _, s_in = self._component_cost(inner, f2, budget, start, comps)
            strategy = {g: v for g, v in f2.items() if g in graph.nodes}
            strategy.update(s_in)
            c = self.sim.simulate(graph, strategy)
            if c < best[0]:
                best = (c, strategy)
        if best[0] < math.inf:
            return best
        return None

    def _pick_bottlenecks(self, bottlenecks: List[Node]) -> List[Node]:
        k = self.max_bottleneck_tries
        if len(bottlenecks) <= k:
            return bottlenecks
        # evenly spaced sample including the middle (the reference
        # tie-breaks toward balanced splits, substitution.cc:1980-1999)
        idxs = sorted({
            round(i * (len(bottlenecks) - 1) / (k - 1)) for i in range(k)
        } | {len(bottlenecks) // 2})
        return [bottlenecks[i] for i in idxs][:k + 1]

    # ------------------------------------------------------------------
    def _sub_budgets(self, budget: int) -> List[Tuple[int, int]]:
        """(first, rest) device-count pairs for a VERTICAL or
        HORIZONTAL resource split (reference: graph.cc:161-295 tries
        gpu-dim and node-dim resource partitions).  VERTICAL budgets
        are divisors of the machine size (view degrees must factor
        onto the global mesh); HORIZONTAL adds whole-host multiples —
        node-granular partitions that need not divide the device count
        (e.g. 16 of 24 devices = 2 of 3 hosts).  Each side's views are
        still divisor-constrained; the budget only bounds them."""
        divs = [d for d in range(1, self.num_devices + 1)
                if self.num_devices % d == 0]
        cands = set(divs)
        dph = getattr(self.sim.machine, "devices_per_host", 0)
        if 1 < dph < self.num_devices:
            cands.update(
                k * dph for k in range(1, self.num_devices // dph + 1)
            )
        pairs = []
        for a in sorted(cands):
            if a >= budget:
                continue
            rest = budget - a
            b = max((d for d in sorted(cands) if d <= rest), default=0)
            if b >= 1:
                pairs.append((a, b))
        return pairs

    def _component_cost(self, graph, fixed, budget, start, comps, cost_only=False):
        """Independent subgraphs, reference-style first-vs-rest
        recursion (graph.cc:161-295): SEQUENTIAL (both use the full
        budget, costs add) vs VERTICAL (disjoint device blocks, costs
        max) over every valid budget split, both orientations.
        Enumerates with cost-only DP; the winner's strategies are
        materialized once at the end."""
        comps = sorted(comps, key=lambda c: (-len(c), min(c)))
        first = graph._subgraph(comps[0])
        rest_guids = set(graph.nodes) - comps[0]
        rest = graph._subgraph(rest_guids)

        # SEQUENTIAL: full budget for both, run one after the other
        c_seq = self.graph_cost_only(first, fixed, budget, start) + \
            self.graph_cost_only(rest, fixed, budget, start)
        # plan: (ga, a_budget, a_start, gb, b_budget, b_start)
        best_c = c_seq
        best_plan = (first, budget, start, rest, budget, start)

        # VERTICAL: disjoint contiguous blocks, run concurrently
        for a, b in self._sub_budgets(budget):
            for first_a in (True, False):  # flip_graphs (graph.cc:172)
                ga, gb = (first, rest) if first_a else (rest, first)
                ca = self.graph_cost_only(ga, fixed, a, start)
                if ca >= best_c:
                    continue
                cb = self.graph_cost_only(gb, fixed, b, start + a)
                par = max(ca, cb)
                if par < best_c:
                    best_c = par
                    best_plan = (ga, a, start, gb, b, start + a)
        if cost_only:
            return best_c, None
        ga, ba, sa, gb, bb, sb = best_plan
        _, s_a = self.graph_cost(ga, fixed, ba, sa)
        _, s_b = self.graph_cost(gb, fixed, bb, sb)
        s = dict(s_a)
        s.update(s_b)
        return best_c, s

    # ------------------------------------------------------------------
    def _leaf_cost(self, graph, fixed, budget, start):
        """Brute force over candidate-view products for free nodes —
        runs on the native engine when available (native/src/
        sim_engine.cpp ffn_sim_brute_force), falling back to the
        equivalent Python loop."""
        free = [graph.nodes[g] for g in sorted(graph.nodes) if g not in fixed]
        if not free:
            strategy = {g: v for g, v in fixed.items() if g in graph.nodes}
            return self.sim.simulate(graph, strategy), strategy
        choices = [self._views(n, budget, start) for n in free]
        total_combos = 1
        for c in choices:
            total_combos *= len(c)
        if total_combos > 262144:
            # rich view products too big: fall back to the compact
            # boundary sets (still covers DP/TP/hybrid/contraction) —
            # vastly better than the per-node greedy for mid-size
            # multi-branch interiors (attention blocks)
            choices = [self._bviews(n, budget, start) for n in free]
            total_combos = 1
            for c in choices:
                total_combos *= len(c)
        base = {g: v for g, v in fixed.items() if g in graph.nodes}
        if 0 < total_combos <= 262144:
            # the native engine enumerates big products cheaply
            # (native/src/sim_engine.cpp ffn_sim_brute_force)
            native = self._native_leaf(graph, base, free, choices)
            if native is not None:
                return native
        if total_combos > 4096:
            return self._greedy_cost(graph, fixed, budget, start)
        best = (math.inf, {})
        for combo in itertools.product(*choices):
            strategy = dict(base)
            for node, v in zip(free, combo):
                strategy[node.guid] = v
            c = self.sim.simulate(graph, strategy)
            if c < best[0]:
                best = (c, strategy)
        return best

    def _native_leaf(self, graph, base, free, choices):
        node_views = {g: [v] for g, v in base.items()}
        for node, views in zip(free, choices):
            node_views[node.guid] = list(views)
        built = self.sim.build_native(graph, node_views)
        if built is None:
            return None
        ns, index = built
        assign = [0] * ns.num_nodes
        free_idx = [index[n.guid] for n in free]
        cost, best = ns.brute_force(
            free_idx, assign, include_update=not self.sim.inference
        )
        if not math.isfinite(cost):
            return (math.inf, {})
        strategy = {
            guid: node_views[guid][best[i]] for guid, i in index.items()
        }
        return cost, strategy

    # ------------------------------------------------------------------
    def _greedy_cost(self, graph, fixed, budget, start):
        """Fallback for odd topologies: assign views in topo order,
        choosing each node's view to minimize the simulated cost of the
        prefix assigned so far (keeps the xfer terms local).  Native
        when available (ffn_sim_greedy)."""
        self.greedy_hits += 1
        base = {g: v for g, v in fixed.items() if g in graph.nodes}
        native = self._native_greedy(graph, base, budget, start)
        if native is not None:
            return native
        strategy: Strategy = dict(base)
        for node in graph.topo_order():
            if node.guid in strategy:
                continue
            best_v, best_c = None, math.inf
            for v in self._views(node, budget, start):
                strategy[node.guid] = v
                c = self.sim.simulate(graph, strategy)
                if c < best_c:
                    best_v, best_c = v, c
            strategy[node.guid] = best_v
        return self.sim.simulate(graph, strategy), strategy

    def _native_greedy(self, graph, base, budget, start):
        node_views = {}
        enum_counts = {}
        for guid, node in graph.nodes.items():
            if guid in base:
                node_views[guid] = [base[guid]]
                enum_counts[guid] = 0
            else:
                cands = list(self._views(node, budget, start))
                default = self._fixed_view(node, start) or MachineView.trivial(
                    node.op.output_shapes[0].ndim
                )
                node_views[guid] = cands + [default]
                enum_counts[guid] = len(cands)
        built = self.sim.build_native(graph, node_views)
        if built is None:
            return None
        ns, index = built
        n = ns.num_nodes
        assign = [0] * n
        is_free = [False] * n
        counts = [0] * n
        for guid, i in index.items():
            counts[i] = enum_counts[guid]
            if guid in base:
                assign[i] = 0
            else:
                is_free[i] = True
                assign[i] = len(node_views[guid]) - 1  # default view
        cost, best = ns.greedy(
            is_free, counts, assign, include_update=not self.sim.inference
        )
        strategy = {
            guid: node_views[guid][best[i]] for guid, i in index.items()
        }
        return cost, strategy
