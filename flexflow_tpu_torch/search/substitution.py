"""Graph substitutions — Unity's outer loop rewrites; a copy of
flexflow_tpu/search/substitution.py.  The batched-embedding rewrite
builds the port's stack, batched lookup and unstack ops
(ops/shape_ops.py, ops/embedding.py), which the search prices as the
reference's does and a searched graph then runs.

Re-implements the GraphXfer machinery (reference:
src/runtime/substitution.cc:491-760 find_matches/run;
:1619-1758 generate_all_pcg_xfers) as first-class rewrite objects:
a matcher over PCG nodes plus an apply() that produces a new Graph
with parallel ops inserted/removed.

Note on expressiveness: in this framework the DP assigns partition
degrees directly, so the classic "partition_X_combine" xfers do not
*enable* parallelism (they make data movement explicit instead of
implicit GSPMD resharding).  They are kept because (a) explicit
movement nodes give the search control over WHERE resharding happens
(e.g. combine early while the tensor is small), and (b) the
simplification xfers (fusing/cancelling adjacent parallel ops,
reference: parallel_op.cc:25-58 join algebra) clean up searched graphs.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from flexflow_tpu_torch.analysis import invariants as _invariants
from flexflow_tpu_torch.core.graph import Edge, Graph, Node
from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.obs.metrics import METRICS
from flexflow_tpu_torch.parallel.parallel_ops import (
    CombineOp,
    ReductionOp,
    RepartitionOp,
    ReplicateOp,
)

Match = Node

# obs telemetry: match-machinery volume (the per-candidate accept/
# reject provenance is emitted by the driver, which owns the decision)
_SCANS = METRICS.counter("substitution.find_matches_calls")
_MATCHES = METRICS.counter("substitution.matches_found")
_APPLIES = METRICS.counter("substitution.applies")
# delta-aware matching: per-pop rescans of the
# DIRTY REGION only — these counters prove the shrink (search.perf)
_DELTA_SCANS = METRICS.counter("substitution.delta_match_calls")
_DELTA_NODES = METRICS.counter("substitution.delta_match_nodes_scanned")
_DELTA_SKIPPED = METRICS.counter("substitution.delta_match_nodes_skipped")
# per-op-type seed index: matcher calls skipped
# because the node's op type cannot anchor the pattern (search.perf
# match_index_skips) — at thousand-node scale candidate generation is
# the dominant per-pop cost, and most of it was matchers returning
# False on the very first op-type check
_INDEX_SKIPS = METRICS.counter("substitution.match_index_skips")
# vectorized matcher core: anchor-typed candidates
# additionally pruned by numpy predicate columns (divisibility,
# predecessor/successor op-type guards) BEFORE the python matcher runs
# — the matcher confirms survivors, so the filter only has to be a
# sound superset, and the FLEXFLOW_TPU_DELTA_CHECK full-scan oracle
# proves it per xfer
_VEC_SKIPS = METRICS.counter("substitution.match_vec_skips")

# below this candidate count the numpy mask costs more than the
# matcher calls it saves — zoo-scale graphs keep the exact chain path
VEC_MIN_CANDS = 16

# how many undirected hops around the changed-guid seed sets a rescan
# covers.  Every built-in matcher reads only its node's edge lists plus
# properties of DIRECT neighbors (their op attrs — immutable per guid —
# and their edge-list lengths), so radius 1 is sufficient; 2 is the
# safety margin for future matchers.  The FLEXFLOW_TPU_DELTA_CHECK
# oracle asserts delta == full at runtime.
DELTA_MATCH_RADIUS = 2


def _delta_check_enabled() -> bool:
    import os

    return os.environ.get("FLEXFLOW_TPU_DELTA_CHECK", "") not in ("", "0")


DELTA_MATCH_CHECK = _delta_check_enabled()


def _op_type_index(graph: Graph):
    """``(op type -> topo-ordered node list, guid -> topo position)``
    for ``graph``, cached on the graph instance keyed by the identity
    of its ``topo_order()`` list — any structural change invalidates
    the topo cache (``Graph._invalidate``), so a fresh topo list means
    a fresh index; COW clones start without the attribute and build
    their own.  One O(nodes) sweep amortized over every anchor-typed
    xfer's ``find_matches`` on this graph."""
    topo = graph.topo_order()
    cached = getattr(graph, "_op_type_index", None)
    if cached is not None and cached[0] is topo:
        return cached[1], cached[2]
    idx: Dict[OperatorType, List[Node]] = {}
    pos: Dict[int, int] = {}
    for i, n in enumerate(topo):
        idx.setdefault(n.op.op_type, []).append(n)
        pos[n.guid] = i
    graph._op_type_index = (topo, idx, pos)
    return idx, pos


def _match_columns(graph: Graph):
    """Per-node numpy predicate columns over the topo order — the
    vectorized matcher core's shared input.  One O(nodes + edges)
    python sweep, cached on the graph instance keyed by the identity of
    its ``topo_order()`` list (the ``_op_type_index`` discipline: any
    structural change invalidates the topo cache, so a fresh topo list
    means fresh columns), then every anchor-typed xfer's
    ``vec_filter`` is pure numpy over row slices.  Columns cover the
    cheap checks every factory matcher leads with: output-dim sizes
    (divisibility), in/out edge counts, distinct-successor counts, and
    the predecessor/successor op-type guards."""
    topo = graph.topo_order()
    cached = getattr(graph, "_match_cols", None)
    if cached is not None and cached[0] is topo:
        return cached[1]
    import numpy as np

    n = len(topo)
    max_nd = 1
    for node in topo:
        nd = len(node.op.output_shapes[0].sizes)
        if nd > max_nd:
            max_nd = nd
    ndim = np.zeros(n, dtype=np.int64)
    sizes = np.zeros((n, max_nd), dtype=np.int64)
    n_in = np.zeros(n, dtype=np.int64)
    n_out = np.zeros(n, dtype=np.int64)
    n_succ = np.zeros(n, dtype=np.int64)
    max_replica = np.zeros(n, dtype=np.int64)
    pred_has_repartition = np.zeros(n, dtype=bool)
    pred_has_replicate = np.zeros(n, dtype=bool)
    pred_all_combine = np.zeros(n, dtype=bool)
    succ_all_parallel = np.zeros(n, dtype=bool)
    succ_all_repartition = np.zeros(n, dtype=bool)
    succ_has_combine = np.zeros(n, dtype=bool)
    succ_has_act = np.zeros(n, dtype=bool)
    act_is_none = np.zeros(n, dtype=bool)
    in_edges, out_edges, nodes = graph.in_edges, graph.out_edges, graph.nodes
    T = OperatorType
    for i, node in enumerate(topo):
        op = node.op
        sz = op.output_shapes[0].sizes
        ndim[i] = len(sz)
        sizes[i, :len(sz)] = sz
        g = node.guid
        ie, oe = in_edges[g], out_edges[g]
        n_in[i] = len(ie)
        n_out[i] = len(oe)
        max_replica[i] = op.max_replica_degree()
        act_is_none[i] = getattr(op, "attrs", {}).get("activation") is None
        all_comb = bool(ie)
        for e in ie:
            pt = nodes[e.src].op.op_type
            if pt is T.REPARTITION:
                pred_has_repartition[i] = True
            elif pt is T.REPLICATE:
                pred_has_replicate[i] = True
            if pt is not T.COMBINE:
                all_comb = False
        pred_all_combine[i] = all_comb
        all_par = all_rep = bool(oe)
        succs = set()
        for e in oe:
            succs.add(e.dst)
            st = nodes[e.dst].op.op_type
            if st is T.COMBINE:
                succ_has_combine[i] = True
            if st in _FUSABLE_ACTS:
                succ_has_act[i] = True
            if not st.is_parallel_op():
                all_par = False
            if st is not T.REPARTITION:
                all_rep = False
        n_succ[i] = len(succs)
        succ_all_parallel[i] = all_par
        succ_all_repartition[i] = all_rep
    cols = {
        "ndim": ndim, "sizes": sizes, "n_in": n_in, "n_out": n_out,
        "n_succ": n_succ, "max_replica": max_replica,
        "pred_has_repartition": pred_has_repartition,
        "pred_has_replicate": pred_has_replicate,
        "pred_all_combine": pred_all_combine,
        "succ_all_parallel": succ_all_parallel,
        "succ_all_repartition": succ_all_repartition,
        "succ_has_combine": succ_has_combine,
        "succ_has_act": succ_has_act,
        "act_is_none": act_is_none,
    }
    graph._match_cols = (topo, cols)
    return cols


def _mark(g: Graph, ins=(), outs=()) -> None:
    """Record which guids a rewrite perturbed on the working graph:
    ``ins`` = nodes whose in-edge list changed (every NEW node guid
    must appear here), ``outs`` = nodes whose out-edge list changed.
    Supersets are safe — the delta simulator only does extra work for
    over-marked nodes, never returns a different float."""
    touched = getattr(g, "_delta_touched", None)
    if touched is None:
        touched = (set(), set())
        g._delta_touched = touched
    touched[0].update(ins)
    touched[1].update(outs)


def _finish_rewrite(parent: Graph, g: Optional[Graph],
                    name: Optional[str] = None) -> Optional[Graph]:
    """Promote the working-graph touched sets into the changed-guid
    annotation delta consumers read (``g._changed_vs`` = parent weakref
    + changed-in/changed-out guid frozensets) — the dirty-frontier seed
    the delta simulator and the delta graph hash both key on.  Rewrites
    built outside this module (substitution_loader JSON rules) carry no
    sets; consumers fall back to a structural diff.

    Under verification (``FLEXFLOW_TPU_VERIFY=1`` / ``--verify``) every
    rewrite result passes the full graph-invariant check here — the ONE
    chokepoint all ``GraphXfer.apply`` paths flow through — so a splice
    that leaves a dangling edge, a doubly-fed slot, or a shape
    disagreement with re-inference fails loudly at the rewrite, not
    three layers later in a simulated cost."""
    if g is None:
        return None
    touched = getattr(g, "_delta_touched", None)
    if touched is not None:
        g._changed_vs = (
            weakref.ref(parent), frozenset(touched[0]), frozenset(touched[1])
        )
    if _invariants.verification_enabled():
        _invariants.assert_graph_ok(
            g, context=f"after rewrite {name or 'unnamed'!r}")
    return g


@dataclass
class GraphXfer:
    """A rewrite: match a node, produce a rewritten graph.

    ``anchor_types`` — the op types a match can ANCHOR on (the matcher
    provably returns False for every other type, because its first
    check is the type test).  When set, ``find_matches`` consults the
    per-op-type seed index instead of calling the matcher on every
    node: only nodes whose type can anchor the pattern are scanned,
    the rest count into ``match_index_skips``.  ``None`` (rewrites
    built outside this module, e.g. substitution_loader JSON rules
    whose matcher shape is unknown) keeps the full scan.  Identity
    with the unindexed scan is asserted under FLEXFLOW_TPU_DELTA_CHECK.
    """

    name: str
    matcher: Callable[[Graph, Node], bool]
    apply_fn: Callable[[Graph, Node], Optional[Graph]]
    anchor_types: Optional[frozenset] = None
    # vectorized candidate filter: ``vec_filter(cols, rows) -> bool
    # mask`` over ``_match_columns`` row indices.  A SOUND SUPERSET of
    # the matcher (never drops a true match — the matcher still
    # confirms every survivor); factories derive it from the same
    # predicates their matcher leads with, and the DELTA_CHECK oracle
    # asserts indexed+filtered == full scan.
    vec_filter: Optional[Callable] = None

    def _vec_prune(self, graph: Graph, cands: List[Match],
                   pos) -> List[Match]:
        if self.vec_filter is None or len(cands) < VEC_MIN_CANDS:
            return cands
        import numpy as np

        cols = _match_columns(graph)
        rows = np.fromiter((pos[n.guid] for n in cands),
                           dtype=np.int64, count=len(cands))
        mask = self.vec_filter(cols, rows)
        kept = [n for n, k in zip(cands, mask) if k]
        _VEC_SKIPS.inc(len(cands) - len(kept))
        return kept

    def find_matches(self, graph: Graph) -> List[Match]:
        _SCANS.inc()
        if self.anchor_types is None:
            out = [n for n in graph.topo_order() if self.matcher(graph, n)]
        else:
            idx, pos = _op_type_index(graph)
            cands: List[Node] = []
            for t in self.anchor_types:
                cands.extend(idx.get(t, ()))
            if len(self.anchor_types) > 1:
                # per-type lists are topo-ordered; a multi-type anchor
                # set needs the merged topo order the full scan yields
                cands.sort(key=lambda n: pos[n.guid])
            _INDEX_SKIPS.inc(len(pos) - len(cands))
            cands = self._vec_prune(graph, cands, pos)
            out = [n for n in cands if self.matcher(graph, n)]
            if DELTA_MATCH_CHECK:
                full = [n for n in graph.topo_order()
                        if self.matcher(graph, n)]
                assert [n.guid for n in out] == [n.guid for n in full], (
                    f"indexed find_matches diverged from the full scan "
                    f"for {self.name}: the declared anchor_types "
                    f"{sorted(t.value for t in self.anchor_types)} do "
                    f"not cover the matcher"
                )
        if out:
            _MATCHES.inc(len(out))
        return out

    def find_matches_delta(
        self, graph: Graph, parent_match_guids: Optional[List[int]]
    ) -> List[Match]:
        """Matches of ``graph`` computed incrementally from its rewrite
        parent's matches: only the DIRTY REGION — the changed-guid seed
        sets ``GraphXfer.apply`` attached (``graph._changed_vs``),
        expanded ``DELTA_MATCH_RADIUS`` undirected hops — is rescanned;
        a parent match surviving OUTSIDE that region still matches (the
        matcher reads only its local neighborhood, all of it unchanged)
        and a parent non-match outside it still does not.  Identical
        result to ``find_matches``, in the same topo order — asserted
        at runtime under FLEXFLOW_TPU_DELTA_CHECK=1.  Falls back to the
        full scan when no parent matches or seed sets are available
        (delta-aware find_matches)."""
        cv = getattr(graph, "_changed_vs", None)
        if parent_match_guids is None or cv is None:
            return self.find_matches(graph)
        nodes = graph.nodes
        region = {g for g in cv[1] if g in nodes}
        region.update(g for g in cv[2] if g in nodes)
        frontier = set(region)
        for _ in range(DELTA_MATCH_RADIUS):
            nxt = set()
            for g in frontier:
                for e in graph.in_edges.get(g, ()):
                    nxt.add(e.src)
                for e in graph.out_edges.get(g, ()):
                    nxt.add(e.dst)
            nxt -= region
            if not nxt:
                break
            region |= nxt
            frontier = nxt
        if 2 * len(region) >= len(nodes):
            return self.find_matches(graph)  # no shrink to win
        topo = graph.topo_order()
        pos = {n.guid: i for i, n in enumerate(topo)}
        hits = {
            g for g in parent_match_guids if g in nodes and g not in region
        }
        anchors = self.anchor_types
        idx_skips = 0
        cands: List[Node] = []
        for g in region:
            # the seed index rule applies inside the dirty region too:
            # a node whose type cannot anchor the pattern never matches
            # (the DELTA_CHECK oracle below proves it per xfer)
            if anchors is not None and nodes[g].op.op_type not in anchors:
                idx_skips += 1
                continue
            cands.append(nodes[g])
        if idx_skips:
            _INDEX_SKIPS.inc(idx_skips)
        # the vectorized predicate filter feeds the delta scan too —
        # hits is a set re-sorted below, so pruning order is free
        for n in self._vec_prune(graph, cands, pos):
            if self.matcher(graph, n):
                hits.add(n.guid)
        out = [nodes[g] for g in sorted(hits, key=pos.__getitem__)]
        _DELTA_SCANS.inc()
        _DELTA_NODES.inc(len(region))
        _DELTA_SKIPPED.inc(len(nodes) - len(region))
        if out:
            _MATCHES.inc(len(out))
        if DELTA_MATCH_CHECK:
            full = [n for n in topo if self.matcher(graph, n)]
            assert [n.guid for n in out] == [n.guid for n in full], (
                f"delta find_matches diverged from full for {self.name}: "
                f"{[n.guid for n in out]} != {[n.guid for n in full]}"
            )
        return out

    def apply(self, graph: Graph, match: Match) -> Optional[Graph]:
        _APPLIES.inc()
        return _finish_rewrite(graph, self.apply_fn(graph, match), self.name)


# ---------------------------------------------------------------------------
# The splice helpers below are the ONLY audited paths for raw edge-list
# surgery: _insert_before/_insert_after splice a node into an edge
# (COPY-ON-WRITE: the clone shares every untouched edge list with the
# parent and REPLACES — never mutates — the few lists the splice
# changes), and _bypass_node deletes a node and bridges its input to
# every consumer (in-place; rewrites that delete must work on a full
# graph.copy()).  Rewrites compose these instead of hand-rolling edge
# lists, so the delta marks, cache invalidation, and the
# no-consumer-reads-a-deleted-guid assertion live in one place — and
# verification (_finish_rewrite) checks the composed result.


def _bypass_node(g: Graph, guid: int) -> Optional[List[Edge]]:
    """Checked delete-and-bridge splice: remove ``guid`` (a node with a
    single meaningful input edge — the parallel-op/identity shape) and
    reconnect its producer to every consumer, preserving consumer input
    slots.  Returns the bridged edges, or None when the node is not
    bypassable (no input edge) so the caller's apply can decline the
    match instead of corrupting the graph.  MUTATES ``g`` in place:
    callers must pass a full copy(), never a COW clone."""
    in_list = g.in_edges.get(guid)
    if not in_list:
        return None
    up = in_list[0]
    out_edges = list(g.out_edges.get(guid, ()))
    g.remove_node(guid)
    bridged: List[Edge] = []
    for e in out_edges:
        # the audited contract of every delete-style rewrite: no
        # surviving consumer may be left reading a deleted guid
        assert e.dst in g.nodes, (
            f"_bypass_node({guid}): consumer {e.dst} was already deleted"
        )
        ne = Edge(up.src, e.dst, up.src_idx, e.dst_idx)
        g.out_edges[ne.src].append(ne)
        g.in_edges[ne.dst].append(ne)
        bridged.append(ne)
    g._invalidate()
    _mark(g, ins=[e.dst for e in out_edges], outs=(up.src,))
    return bridged


def _insert_before(graph: Graph, node: Node, dst_idx: int, make_op,
                   cow: bool = True) -> Optional[Graph]:
    """New graph with ``make_op(input_shape)`` spliced into the edge
    feeding input ``dst_idx`` of ``node``.  Pass ``cow=False`` when the
    caller will afterwards MUTATE the result in place (remove_node) —
    in-place surgery on a COW clone would corrupt the shared parent."""
    edges = [e for e in graph.in_edges[node.guid] if e.dst_idx == dst_idx]
    if not edges:
        return None
    e = edges[0]
    src_shape = graph.nodes[e.src].op.output_shapes[e.src_idx]
    new_op = make_op(src_shape)
    if new_op is None:
        return None
    g = graph.copy_cow() if cow else graph.copy()
    mid = Node(g._next_guid, new_op)
    g._next_guid += 1
    e1 = Edge(e.src, mid.guid, e.src_idx, 0)
    e2 = Edge(mid.guid, node.guid, 0, e.dst_idx)
    g.nodes[mid.guid] = mid
    g.in_edges[mid.guid] = [e1]
    g.out_edges[mid.guid] = [e2]
    g.in_edges[node.guid] = [
        x for x in g.in_edges[node.guid] if x is not e] + [e2]
    g.out_edges[e.src] = [
        x for x in g.out_edges[e.src] if x is not e] + [e1]
    g._invalidate()  # direct edge-list surgery bypasses add_edge
    _mark(g, ins=(mid.guid, node.guid), outs=(e.src,))
    return g


def _insert_after(graph: Graph, node: Node, out_idx: int, make_op,
                  copy: bool = True) -> Optional[Graph]:
    """``copy=False`` splices into ``graph`` itself — for two-step
    rewrites whose first step already produced a fresh (COW) clone;
    the discarded intermediate was pure overhead.  Either way the
    surgery replaces edge lists, honoring the COW discipline."""
    g = graph.copy_cow() if copy else graph
    shape = node.op.output_shapes[out_idx]
    new_op = make_op(shape)
    if new_op is None:
        return None
    mid = Node(g._next_guid, new_op)
    g._next_guid += 1
    g.nodes[mid.guid] = mid
    old_out = g.out_edges[node.guid]
    outs = [e for e in old_out if e.src_idx == out_idx]
    e1 = Edge(node.guid, mid.guid, out_idx, 0)
    g.out_edges[node.guid] = [
        e for e in old_out if e.src_idx != out_idx] + [e1]
    mid_out = []
    for e in outs:
        ne = Edge(mid.guid, e.dst, 0, e.dst_idx)
        mid_out.append(ne)
        g.in_edges[e.dst] = [
            x for x in g.in_edges[e.dst] if x is not e] + [ne]
    g.in_edges[mid.guid] = [e1]
    g.out_edges[mid.guid] = mid_out
    g._invalidate()
    _mark(g, ins=[mid.guid] + [e.dst for e in outs], outs=(node.guid,))
    return g


_xfer_counter = [0]


def _uname(base: str) -> str:
    _xfer_counter[0] += 1
    return f"{base}_x{_xfer_counter[0]}"


_PROTO_CACHE: Dict[Tuple, object] = {}


def _proto_op(cls, base: str, shape, **kw):
    """Construct-or-clone a parallel-op descriptor.  Operator.__init__
    re-derives output shapes and weight specs — two such constructions
    per candidate across tens of thousands of candidates was a real
    slice of the search — but every instance of (class, logical input
    shape, attrs) is structurally identical except for its unique debug
    name, so later instances clone a cached prototype and stamp a fresh
    name.  Safe because operators are immutable descriptors (ops/base
    docstring); the attrs dict is still copied per clone as insurance."""
    key = (cls, shape.sizes, shape.dtype.value,
           tuple(sorted(kw.items())))
    proto = _PROTO_CACHE.get(key)
    if proto is None:
        proto = cls(_uname(base), [shape], **kw)
        _PROTO_CACHE[key] = proto
        return proto
    clone = object.__new__(cls)
    clone.__dict__.update(proto.__dict__)
    clone.name = _uname(base)
    clone.attrs = dict(proto.attrs)
    return clone


# ---------------------------------------------------------------------------
def make_partition_combine_xfer(
    op_type: OperatorType, degree: int, dim: int = 0
) -> GraphXfer:
    """Repartition(input, dim) → op → Combine — the
    create_partition_*_combine family (reference: substitution.cc:70-115,
    generated per divisor degree :1648-1712)."""

    def matcher(graph: Graph, node: Node) -> bool:
        if node.op.op_type is not op_type:
            return False
        if node.op.op_type.is_parallel_op():
            return False
        out = node.op.output_shapes[0]
        if dim >= out.ndim or out.sizes[dim] % degree != 0:
            return False
        # skip if already wrapped
        preds = [graph.nodes[e.src].op.op_type for e in graph.in_edges[node.guid]]
        return OperatorType.REPARTITION not in preds

    def apply_fn(graph: Graph, node: Node) -> Optional[Graph]:
        g = _insert_before(
            graph,
            node,
            0,
            lambda s: _proto_op(RepartitionOp, "repartition", s,
                                dim=dim, degree=degree)
            if dim < s.ndim and s.sizes[dim] % degree == 0
            else None,
        )
        if g is None:
            return None
        return _insert_after(
            g,
            g.nodes[node.guid],
            0,
            lambda s: _proto_op(CombineOp, "combine", s, dim=dim, degree=1),
            copy=False,
        )

    def vec_filter(c, rows):
        # exactly the matcher's leading predicates, vectorized: dim in
        # range, divisible size, no Repartition predecessor (the types
        # this factory anchors on are never parallel ops)
        if dim >= c["sizes"].shape[1]:
            return c["ndim"][rows] > dim  # all-False mask, right shape
        return (
            (c["ndim"][rows] > dim)
            & (c["sizes"][rows, dim] % degree == 0)
            & ~c["pred_has_repartition"][rows]
        )

    return GraphXfer(
        name=f"partition_{op_type.value}_combine_d{degree}_dim{dim}",
        matcher=matcher,
        apply_fn=apply_fn,
        anchor_types=frozenset({op_type}),
        vec_filter=vec_filter,
    )


def make_replicate_reduce_xfer(op_type: OperatorType, degree: int) -> GraphXfer:
    """Replicate(input) → op(contraction-split) → Reduction — the
    create_replicate_linear_combine / replicate_attention_reduce family
    (reference: substitution.cc:76-93)."""

    def matcher(graph: Graph, node: Node) -> bool:
        if node.op.op_type is not op_type:
            return False
        if node.op.max_replica_degree() % degree != 0 or degree < 2:
            return False
        preds = [graph.nodes[e.src].op.op_type for e in graph.in_edges[node.guid]]
        return OperatorType.REPLICATE not in preds

    def apply_fn(graph: Graph, node: Node) -> Optional[Graph]:
        g = _insert_before(
            graph,
            node,
            0,
            lambda s: _proto_op(ReplicateOp, "replicate", s, degree=degree),
        )
        if g is None:
            return None
        return _insert_after(
            g,
            g.nodes[node.guid],
            0,
            lambda s: _proto_op(ReductionOp, "reduction", s, degree=degree),
            copy=False,
        )

    def vec_filter(c, rows):
        return (
            (c["max_replica"][rows] % degree == 0)
            & ~c["pred_has_replicate"][rows]
        )

    return GraphXfer(
        name=f"replicate_{op_type.value}_reduce_d{degree}",
        matcher=matcher,
        apply_fn=apply_fn,
        anchor_types=frozenset({op_type}),
        vec_filter=vec_filter,
    )


def make_simplify_xfer() -> GraphXfer:
    """Cancel a Repartition directly followed by its inverse Combine
    (reference: graph simplification / fuse_parallel_ops,
    parallel_op.cc:25-58)."""

    def matcher(graph: Graph, node: Node) -> bool:
        if node.op.op_type is not OperatorType.REPARTITION:
            return False
        succs = graph.successors(node.guid)
        return (
            len(succs) == 1
            and graph.nodes[succs[0]].op.op_type is OperatorType.COMBINE
            and graph.nodes[succs[0]].op.attrs.get("dim")
            == node.op.attrs.get("dim")
        )

    def apply_fn(graph: Graph, node: Node) -> Optional[Graph]:
        g = graph.copy()
        comb_guid = g.successors(node.guid)[0]
        # bypass the repartition (bridging its input to the combine),
        # then the combine — two audited splices, same final edges as
        # the old one-shot surgery
        if _bypass_node(g, node.guid) is None:
            return None
        if _bypass_node(g, comb_guid) is None:
            return None
        return g

    return GraphXfer(
        name="cancel_repartition_combine", matcher=matcher, apply_fn=apply_fn,
        anchor_types=frozenset({OperatorType.REPARTITION}),
        # sole successor which is a Combine; the dim equality stays
        # with the matcher
        vec_filter=lambda c, rows: (
            (c["n_succ"][rows] == 1) & c["succ_has_combine"][rows]
        ),
    )


_FUSABLE_ACTS = {
    OperatorType.RELU: "relu",
    OperatorType.SIGMOID: "sigmoid",
    OperatorType.TANH: "tanh",
    OperatorType.GELU: "gelu",
}


def make_linear_activation_fusion_xfer() -> GraphXfer:
    """Fuse Linear followed by a sole-consumer activation into the
    Linear's fused-activation attribute (reference: the generated
    linear_relu fusion xfer, substitution.cc:1619-1758).  XLA fuses the
    kernels either way — the win is a smaller PCG for the search."""

    def matcher(graph: Graph, node: Node) -> bool:
        if node.op.op_type is not OperatorType.LINEAR:
            return False
        if node.op.attrs.get("activation") is not None:
            return False
        succs = graph.successors(node.guid)
        if len(succs) != 1 or len(graph.out_edges[node.guid]) != 1:
            return False
        nxt = graph.nodes[succs[0]].op
        return nxt.op_type in _FUSABLE_ACTS

    def apply_fn(graph: Graph, node: Node) -> Optional[Graph]:
        from flexflow_tpu_torch.ops.linear import LinearOp

        g = graph.copy()
        act_guid = g.successors(node.guid)[0]
        act_name = _FUSABLE_ACTS[g.nodes[act_guid].op.op_type]
        fused = LinearOp(
            _uname(f"{node.op.name}_{act_name}"),
            list(node.op.input_shapes),
            out_dim=node.op.attrs["out_dim"],
            activation=act_name,
            use_bias=node.op.attrs["use_bias"],
            kernel_initializer=node.op._kernel_init,
            bias_initializer=node.op._bias_init,
            param_dtype=node.op.attrs.get("param_dtype", "float32"),
        )
        out_edges = list(g.out_edges[act_guid])
        in_edges = list(g.in_edges[node.guid])
        g.remove_node(node.guid)
        g.remove_node(act_guid)
        nn = Node(g._next_guid, fused)
        g._next_guid += 1
        g.add_node(nn)
        for e in in_edges:
            ne = Edge(e.src, nn.guid, e.src_idx, e.dst_idx)
            g.out_edges[e.src].append(ne)
            g.in_edges[nn.guid].append(ne)
        for e in out_edges:
            ne = Edge(nn.guid, e.dst, 0, e.dst_idx)
            g.out_edges[nn.guid].append(ne)
            g.in_edges[e.dst].append(ne)
        g._invalidate()
        _mark(g, ins=[nn.guid] + [e.dst for e in out_edges],
              outs=[nn.guid] + [e.src for e in in_edges])
        return g

    return GraphXfer(
        name="fuse_linear_activation", matcher=matcher, apply_fn=apply_fn,
        anchor_types=frozenset({OperatorType.LINEAR}),
        vec_filter=lambda c, rows: (
            c["act_is_none"][rows]
            & (c["n_succ"][rows] == 1) & (c["n_out"][rows] == 1)
            & c["succ_has_act"][rows]
        ),
    )


def make_parallel_chain_fusion_xfer() -> GraphXfer:
    """Collapse chains of adjacent parallel ops: a Repartition / Combine
    / Replicate whose every consumer is itself a parallel op is
    redundant — all four are identity computations whose only content is
    the sharding constraint, and the downstream op re-constrains.  This
    is the FusedParallelOp join algebra (reference:
    src/runtime/parallel_op.cc:25-58, fused_parallel_op.cc) expressed as
    deletion: the fused chain IS the last op's constraint."""

    _SPLICEABLE = {
        OperatorType.REPARTITION,
        OperatorType.COMBINE,
        OperatorType.REPLICATE,
    }

    def matcher(graph: Graph, node: Node) -> bool:
        if node.op.op_type not in _SPLICEABLE:
            return False
        outs = graph.out_edges[node.guid]
        if not outs or not graph.in_edges[node.guid]:
            return False
        return all(
            graph.nodes[e.dst].op.op_type.is_parallel_op() for e in outs
        )

    def apply_fn(graph: Graph, node: Node) -> Optional[Graph]:
        g = graph.copy()
        if _bypass_node(g, node.guid) is None:
            return None
        return g

    return GraphXfer(
        name="fuse_parallel_op_chain", matcher=matcher, apply_fn=apply_fn,
        anchor_types=frozenset(_SPLICEABLE),
        vec_filter=lambda c, rows: (
            (c["n_out"][rows] > 0) & (c["n_in"][rows] > 0)
            & c["succ_all_parallel"][rows]
        ),
    )


def make_combine_concat_sink_xfer() -> GraphXfer:
    """N branches each ending Combine(dim d) feeding one Concat: drop
    the per-branch combines and combine ONCE after the concat — the
    branches stay sharded through the concat and the expensive gather
    happens on the concatenated tensor a single time (reference:
    create_combine_inception / create_partition_concat_combine,
    substitution.cc:1693-1758)."""

    def matcher(graph: Graph, node: Node) -> bool:
        if node.op.op_type is not OperatorType.CONCAT:
            return False
        in_edges = graph.in_edges[node.guid]
        if len(in_edges) < 2:
            return False
        keys = set()
        for e in in_edges:
            p = graph.nodes[e.src]
            if p.op.op_type is not OperatorType.COMBINE:
                return False
            if len(graph.out_edges[e.src]) != 1:
                return False
            keys.add((p.op.attrs["dim"], p.op.attrs["degree"]))
        if len(keys) != 1:  # uniform (dim, degree) or the sunk combine
            return False  # would express a different sharding
        return next(iter(keys))[0] != node.op.attrs.get("axis")

    def apply_fn(graph: Graph, node: Node) -> Optional[Graph]:
        g = graph.copy()
        dim = degree = None
        for e in list(g.in_edges[node.guid]):
            comb = g.nodes[e.src]
            dim = comb.op.attrs["dim"]
            degree = comb.op.attrs["degree"]
            if _bypass_node(g, comb.guid) is None:
                return None
        return _insert_after(
            g,
            g.nodes[node.guid],
            0,
            lambda s: _proto_op(CombineOp, "combine", s,
                                dim=dim, degree=degree),
            copy=False,
        )

    return GraphXfer(
        name="sink_combine_through_concat", matcher=matcher, apply_fn=apply_fn,
        anchor_types=frozenset({OperatorType.CONCAT}),
        vec_filter=lambda c, rows: (
            (c["n_in"][rows] >= 2) & c["pred_all_combine"][rows]
        ),
    )


_HOISTABLE_UNARY = {
    OperatorType.RELU,
    OperatorType.SIGMOID,
    OperatorType.TANH,
    OperatorType.GELU,
    OperatorType.EXP,
    OperatorType.IDENTITY,
}


def make_unary_hoist_partition_xfer() -> GraphXfer:
    """A unary op fanning out to k branches that each immediately
    Repartition the same way: hoist ONE Repartition above the unary and
    delete the k copies — the shared activation is resharded once,
    before the cheap elementwise op (reference:
    leading_relu_branch_partition, substitution.cc:1735-1748)."""

    def matcher(graph: Graph, node: Node) -> bool:
        if node.op.op_type not in _HOISTABLE_UNARY:
            return False
        outs = graph.out_edges[node.guid]
        if len(outs) < 2:
            return False
        keys = set()
        for e in outs:
            c = graph.nodes[e.dst]
            if c.op.op_type is not OperatorType.REPARTITION:
                return False
            keys.add((c.op.attrs["dim"], c.op.attrs["degree"]))
        if len(keys) != 1:
            return False
        # not already partitioned above
        preds = [graph.nodes[e.src].op.op_type for e in graph.in_edges[node.guid]]
        return OperatorType.REPARTITION not in preds

    def apply_fn(graph: Graph, node: Node) -> Optional[Graph]:
        reps = [graph.nodes[e.dst] for e in graph.out_edges[node.guid]]
        dim = reps[0].op.attrs["dim"]
        degree = reps[0].op.attrs["degree"]
        g = _insert_before(
            graph,
            node,
            0,
            lambda s: _proto_op(RepartitionOp, "repartition", s,
                                dim=dim, degree=degree)
            if dim < s.ndim and s.sizes[dim] % degree == 0
            else None,
            cow=False,  # the rep deletions below mutate in place
        )
        if g is None:
            return None
        for rep in reps:
            if _bypass_node(g, rep.guid) is None:
                return None
        return g

    return GraphXfer(
        name="hoist_partition_above_unary", matcher=matcher, apply_fn=apply_fn,
        anchor_types=frozenset(_HOISTABLE_UNARY),
        vec_filter=lambda c, rows: (
            (c["n_out"][rows] >= 2) & c["succ_all_repartition"][rows]
            & ~c["pred_has_repartition"][rows]
        ),
    )


_PARTITION_DIMS = {
    OperatorType.LINEAR: (0, 1),
    OperatorType.MULTIHEAD_ATTENTION: (0, 1),  # dim 1 = sequence (SP)
    OperatorType.EW_ADD: (0, 1),
    OperatorType.RELU: (0,),
    OperatorType.CONCAT: (0,),
    OperatorType.SOFTMAX: (0,),
    OperatorType.CONV2D: (0,),
    OperatorType.POOL2D: (0,),
    OperatorType.FLAT: (0,),
    OperatorType.LAYERNORM: (0,),
    OperatorType.EMBEDDING: (0,),
}


def generate_all_pcg_xfers(num_devices: int) -> List[GraphXfer]:
    """All rewrites for the device count, one per divisor degree —
    mirrors generate_all_pcg_xfers (reference: substitution.cc:1619-1758):
    partition/combine families per op type and dim, replicate/reduce
    (row- and head-parallel), branch combining for inception-style PCGs,
    partition hoisting, linear+activation fusion, and the parallel-op
    chain simplifications."""
    degrees = [d for d in range(2, num_devices + 1) if num_devices % d == 0]
    xfers: List[GraphXfer] = [
        BatchEmbeddingsXfer(),
        make_simplify_xfer(),
        make_parallel_chain_fusion_xfer(),
        make_linear_activation_fusion_xfer(),
        make_combine_concat_sink_xfer(),
        make_unary_hoist_partition_xfer(),
    ]
    for d in degrees:
        for t, dims in _PARTITION_DIMS.items():
            for dim in dims:
                xfers.append(make_partition_combine_xfer(t, d, dim=dim))
        xfers.append(make_replicate_reduce_xfer(OperatorType.LINEAR, d))
        xfers.append(make_replicate_reduce_xfer(OperatorType.MULTIHEAD_ATTENTION, d))
    return xfers


class BatchEmbeddingsXfer:
    """Fuse K parallel same-signature embeddings into
    Stack(ids) -> BatchedEmbedding -> Unstack (TPU-native branch
    batching; no reference equivalent — the reference PLACES each
    table's subgraph on different GPUs instead, mapper.cc:371-475,
    which pure-SPMD GSPMD cannot express.  Sharding the stacked branch
    dim realizes the same table parallelism).  Duck-typed like
    GraphXfer (find_matches/apply)."""

    name = "batch_parallel_embeddings"
    # same contract as GraphXfer.anchor_types: the scan below provably
    # only reads EMBEDDING nodes, so the per-op-type seed index serves
    # it (and analysis/proofgen synthesizes its proof graphs from it)
    anchor_types = frozenset({OperatorType.EMBEDDING})

    def find_matches(self, graph: Graph) -> List[Dict[int, int]]:
        idx, pos = _op_type_index(graph)
        embeds = idx.get(OperatorType.EMBEDDING, [])
        _INDEX_SKIPS.inc(len(pos) - len(embeds))
        groups: Dict[Tuple, List[int]] = {}
        for n in embeds:  # per-type lists are topo-ordered — identical
            groups.setdefault(n.op.signature(), []).append(n.guid)
        return [
            {i: g for i, g in enumerate(gs)}
            for gs in groups.values()
            if len(gs) >= 2
        ]

    def apply(self, graph: Graph, match: Dict[int, int]) -> Optional[Graph]:
        from flexflow_tpu_torch.ops.embedding import BatchedEmbeddingOp
        from flexflow_tpu_torch.ops.shape_ops import StackOp, UnstackOp

        g = graph.copy()
        guids = [match[i] for i in range(len(match))]
        ops = [g.nodes[gu].op for gu in guids]
        a = ops[0].attrs
        id_srcs = []
        for gu in guids:
            e = next((e for e in g.in_edges[gu] if e.dst_idx == 0), None)
            if e is None:
                return None
            id_srcs.append((e.src, e.src_idx))
        in_shapes = [g.nodes[s].op.output_shapes[si] for s, si in id_srcs]

        stack = Node(g._next_guid, StackOp(_uname("stack_ids"), in_shapes))
        g._next_guid += 1
        g.add_node(stack)
        for slot, (s, si) in enumerate(id_srcs):
            e = Edge(s, stack.guid, si, slot)
            g.out_edges[s].append(e)
            g.in_edges[stack.guid].append(e)

        be = Node(
            g._next_guid,
            BatchedEmbeddingOp(
                _uname("batched_embed"),
                [stack.op.output_shapes[0]],
                num_tables=len(guids),
                num_entries=a["num_entries"],
                out_dim=a["out_dim"],
                aggr=a["aggr"],
                kernel_initializer=ops[0]._kernel_init,
                param_dtype=a["param_dtype"],
            ),
        )
        g._next_guid += 1
        g.add_node(be)
        e = Edge(stack.guid, be.guid, 0, 0)
        g.out_edges[stack.guid].append(e)
        g.in_edges[be.guid].append(e)

        un = Node(
            g._next_guid, UnstackOp(_uname("unstack"), [be.op.output_shapes[0]])
        )
        g._next_guid += 1
        g.add_node(un)
        e = Edge(be.guid, un.guid, 0, 0)
        g.out_edges[be.guid].append(e)
        g.in_edges[un.guid].append(e)

        consumers = []
        for k, gu in enumerate(guids):
            for old in list(g.out_edges[gu]):
                ne = Edge(un.guid, old.dst, k, old.dst_idx)
                g.out_edges[un.guid].append(ne)
                g.in_edges[old.dst].append(ne)
                consumers.append(old.dst)
        for gu in guids:
            g.remove_node(gu)
        g._invalidate()
        try:
            g.topo_order()
        except ValueError:
            return None
        new = (stack.guid, be.guid, un.guid)
        _mark(g, ins=list(new) + consumers,
              outs=list(new) + [s for s, _ in id_srcs])
        return _finish_rewrite(graph, g, self.name)
