"""Series-parallel decomposition of the PCG — generalized graph cuts
for production-scale search; a copy of flexflow_tpu/search/decompose.py
(``chain_optimize``, the reference's regression oracle for this
module, is the reference driver's and is not copied).

The chain path (``chain_optimize``) decomposes *chain-structured* graphs: it cuts
at single-node bottlenecks (articulation nodes every source→sink path
crosses).  A multi-branch MoE trunk, a persistent-skip stack, or a
disaggregated prefill/decode placement graph has NO such bottleneck —
every interior node is bypassed by some path — and used to fall back to
the binary recursion, which degenerates to a whole-graph brute
force/greedy past the native DP ceiling (the mystery thousand-node
slowdown).

This module generalizes the cut: a **frontier cut** at topo position
``p`` is the set of prefix nodes (``topo[0..p]``) that still feed the
suffix.  Its *width* is the number of such nodes.  A width-1 frontier
cut whose crossing node sits at ``p`` is exactly a bottleneck — the
chain decomposition is the degenerate case — and a width-k cut
(``k <= MAX_CUT_WIDTH``, the same bounded-boundary discipline as the
placed executor's MAX_CROSSING_TENSORS) cuts the shapes bottleneck
finding cannot: the segment DP then pins a *tuple* of boundary views,
one per crossing node, instead of a single view.

The scan is one O(nodes + edges) sweep (``frontier_widths``); cut
selection (``find_series_cuts``) first applies the EXACT bottleneck
spacing rule of the chain path — so chain-shaped graphs produce
bit-identical cuts, pins, and therefore solves (test-enforced against
the retained ``chain_optimize`` oracle) — and only reaches for wider
frontiers when the chain rule finds no usable chain.  Parallel
composition (disconnected components) is handled by the driver/DP
layers as before; segments the cuts produce re-enter the driver's
recursion, so a still-large segment decomposes again — the recursive
SP-tree build, expressed through the existing memoized recursion
instead of an explicit tree datatype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch.core.graph import Edge, Graph, Node

# bounded-width cut ceiling: the widest boundary-view tuple the segment
# DP will pin.  Mirrors the placed executor's MAX_CROSSING_TENSORS
# discipline (compiler/placement_lowering.py) — a cut wider than this
# costs more in boundary enumeration than the split saves.
MAX_CUT_WIDTH = 8

# boundary-view tuples enumerated per cut: the full per-node
# boundary_views product when it fits, else index-aligned "profiles"
# (pure-DP across the cut, pure-TP across the cut, ...) — the product
# of k 4-view sets is 4^k, and the DP is states^2 per segment.
MAX_CUT_TUPLES = 16

# minimum usable cuts for the generalized path (the chain rule keeps
# the chain path's own >= 4 floor; two wide cuts already bound every segment to
# ~a third of the graph, which the recursion decomposes further)
MIN_SP_CUTS = 2


@dataclass(frozen=True)
class SeriesCut:
    """A frontier cut AFTER topo position ``pos``: ``crossing`` is the
    sorted tuple of prefix guids with >=1 edge into the suffix."""

    pos: int
    crossing: Tuple[int, ...]

    @property
    def width(self) -> int:
        return len(self.crossing)


def frontier_widths(graph: Graph) -> Tuple[List[Node], List[int]]:
    """(topo order, per-position frontier width): ``widths[i]`` is the
    number of distinct nodes in ``topo[0..i]`` that still feed
    ``topo[i+1..]``.  One O(nodes + edges) sweep — the per-node pending
    out-edge count drops as consumers enter the prefix."""
    topo = graph.topo_order()
    pending = {g: len(graph.out_edges[g]) for g in graph.nodes}
    live = 0
    widths: List[int] = []
    for node in topo:
        g = node.guid
        for e in graph.in_edges[g]:
            pending[e.src] -= 1
            if pending[e.src] == 0:
                live -= 1
        if pending[g] > 0:
            live += 1
        widths.append(live)
    return topo, widths


def _crossing_at(graph: Graph, topo: List[Node],
                 positions: Sequence[int]) -> Dict[int, Tuple[int, ...]]:
    """The crossing sets for selected cut ``positions`` — a second
    incremental sweep that snapshots the live frontier only where a cut
    was chosen."""
    want = set(positions)
    pending = {g: len(graph.out_edges[g]) for g in graph.nodes}
    frontier: set = set()
    out: Dict[int, Tuple[int, ...]] = {}
    for i, node in enumerate(topo):
        g = node.guid
        for e in graph.in_edges[g]:
            pending[e.src] -= 1
            if pending[e.src] == 0:
                frontier.discard(e.src)
        if pending[g] > 0:
            frontier.add(g)
        if i in want:
            out[i] = tuple(sorted(frontier))
    return out


def chain_cuts(graph: Graph, fixed, threshold: int,
               ) -> Optional[List[SeriesCut]]:
    """The chain path's bottleneck spacing rule, verbatim, expressed as width-1
    SeriesCuts: >= 8 un-pinned bottlenecks, cuts at every
    ``threshold``-spaced bottleneck topo position (never the last
    node), >= 4 cuts or None.  ``find_series_cuts`` tries this FIRST so
    chain-shaped graphs keep bit-identical cuts to the chain path."""
    bottlenecks = [b for b in graph.bottlenecks() if b.guid not in fixed]
    if len(bottlenecks) < 8:
        return None
    order = {n.guid: i for i, n in enumerate(graph.topo_order())}
    cuts: List[SeriesCut] = []
    last = 0
    for bn in bottlenecks:
        at = order[bn.guid]
        if at - last >= threshold and at < len(order) - 1:
            cuts.append(SeriesCut(pos=at, crossing=(bn.guid,)))
            last = at
    if len(cuts) < 4:
        return None
    return cuts


def find_series_cuts(graph: Graph, fixed, threshold: int,
                     max_width: int = MAX_CUT_WIDTH,
                     ) -> Tuple[Optional[List[SeriesCut]], str]:
    """(cuts, mode) for ``graph``: mode ``"chain"`` when the chain
    bottleneck rule applies (width-1 cuts, bit-identical to
    chain_optimize), ``"sp"`` for bounded-width frontier cuts, and
    ``(None, reason)`` when neither yields a usable series
    decomposition (the caller falls back to binary recursion and emits
    the reason on the ``search.decompose`` obs event)."""
    got = chain_cuts(graph, fixed, threshold)
    if got is not None:
        return got, "chain"
    topo, widths = frontier_widths(graph)
    n = len(topo)
    # windowed min-width selection: inside each [last+threshold,
    # last+2*threshold) window take the narrowest eligible frontier —
    # narrow cuts mean small boundary-view tuples, so prefer them even
    # a few positions later
    positions: List[int] = []
    last = 0
    i = 0
    while i < n - 1:
        if i - last < threshold:
            i += 1
            continue
        best_pos, best_w = None, max_width + 1
        j = i
        while j < n - 1 and j - last < 2 * threshold:
            if 1 <= widths[j] < best_w:
                best_pos, best_w = j, widths[j]
            j += 1
        if best_pos is None:
            # no bounded frontier in this window: slide forward
            i = j
            last = j - threshold
            continue
        positions.append(best_pos)
        last = best_pos
        i = best_pos + 1
    if len(positions) < MIN_SP_CUTS:
        return None, "no_bounded_cuts"
    crossing = _crossing_at(graph, topo, positions)
    cuts = [SeriesCut(pos=p, crossing=crossing[p]) for p in positions]
    cuts = [c for c in cuts
            if c.crossing and not any(g in fixed for g in c.crossing)]
    if len(cuts) < MIN_SP_CUTS:
        return None, "cuts_pinned"
    return cuts, "sp"


def split_series(graph: Graph, cuts: List[SeriesCut],
                 ) -> Optional[List[Tuple[Graph, Tuple[int, ...],
                                          Tuple[int, ...]]]]:
    """Split ``graph`` into len(cuts)+1 segments: segment ``i`` holds
    the topo interval between cut ``i-1`` (exclusive) and cut ``i``
    (inclusive), PLUS cut ``i-1``'s crossing nodes replayed as sources
    carrying only their into-segment edges — the multi-node analogue of
    ``split_at_node`` keeping the bottleneck on both sides.  Returns
    ``[(segment, in_crossing, out_crossing)]`` with ``()`` at the chain
    ends, or None when an edge skips over a cut entirely (a crossing
    node must catch every prefix→suffix edge by construction, so None
    here means the cut list is stale for this graph)."""
    topo = graph.topo_order()
    pos = {n.guid: i for i, n in enumerate(topo)}
    bounds = [-1] + [c.pos for c in cuts] + [len(topo) - 1]
    crossings = [()] + [c.crossing for c in cuts] + [()]
    segments = []
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i], bounds[i + 1]
        in_cross = crossings[i]
        interior = {n.guid for n in topo[lo + 1: hi + 1]}
        seg_nodes = set(interior)
        seg_nodes.update(in_cross)
        seg = Graph()
        seg._next_guid = graph._next_guid
        # sorted insertion: segment node/edge dict order must be
        # deterministic (and match the ascending-guid order the chain
        # path's iterative split_at_node preserves) — downstream float
        # accumulation orders depend on it, and the chain bit-identity
        # gate compares exact floats
        for g in sorted(seg_nodes):
            seg.add_node(graph.nodes[g])
        for g in sorted(seg_nodes):
            for e in graph.out_edges[g]:
                if e.dst in interior:
                    seg.out_edges[e.src].append(e)
                    seg.in_edges[e.dst].append(e)
        # sanity: every interior in-edge must originate inside the
        # segment (interior or the in-crossing) — otherwise an edge
        # skipped the cut and the decomposition is unsound
        for g in interior:
            for e in graph.in_edges[g]:
                if e.src not in seg_nodes:
                    return None
        segments.append((seg, in_cross, crossings[i + 1]))
    return segments


def boundary_tuples(views_per_guid: Dict[int, list],
                    crossing: Tuple[int, ...],
                    carry: Optional[Dict[int, object]] = None,
                    max_tuples: int = MAX_CUT_TUPLES) -> List[tuple]:
    """Boundary-view tuples for one cut, aligned with ``crossing``
    order.  ``carry`` pins guids shared with the previous cut to their
    already-chosen view (a persistent-skip node crossing many cuts must
    keep ONE view, or consecutive segment solves would disagree about
    it).  Full cartesian product when it fits ``max_tuples`` —
    degenerating to exactly the per-node boundary_views list at width
    1 — else index-aligned profiles (all-DP, all-TP, ..., all-trivial
    across the cut)."""
    lists = []
    for g in crossing:
        if carry is not None and g in carry:
            lists.append([carry[g]])
        else:
            lists.append(list(views_per_guid[g]))
    total = 1
    for lst in lists:
        total *= max(1, len(lst))
    if total <= max_tuples:
        import itertools

        return [tuple(t) for t in itertools.product(*lists)]
    depth = max(len(lst) for lst in lists)
    out = []
    seen = set()
    for k in range(depth):
        t = tuple(lst[min(k, len(lst) - 1)] for lst in lists)
        if t not in seen:
            seen.add(t)
            out.append(t)
    return out[:max_tuples]


def merge_segment_into(acc_g: Graph, acc_s, post_g: Graph, post_s,
                       shared) -> None:
    """Append one solved segment into the merge accumulator — the
    multi-node generalization of the driver's ``_merge_split``
    (original nodes are disjoint apart from the shared crossing;
    rewrite-inserted guids may collide between segments and are
    renumbered on the post side).  In place: the repeated-copy merge
    was O(n^2) over a 660-segment 10k-node replay.  ``acc_g`` must be
    OWNED by the caller (never a cached segment object), and node/edge
    insertion order matches the chain path's iterative merge —
    downstream float accumulation orders, and therefore the chain
    bit-identity gate, depend on it."""
    if post_g._next_guid > acc_g._next_guid:
        acc_g._next_guid = post_g._next_guid
    remap: Dict[int, int] = {}
    for guid in post_g.nodes:
        if guid in acc_g.nodes and guid not in shared:
            remap[guid] = acc_g._next_guid
            acc_g._next_guid += 1
    for guid, n in post_g.nodes.items():
        ng = remap.get(guid, guid)
        if ng not in acc_g.nodes:
            acc_g.nodes[ng] = n if ng == guid else Node(ng, n.op)
            acc_g.in_edges.setdefault(ng, [])
            acc_g.out_edges.setdefault(ng, [])
    for guid in post_g.nodes:
        for e in post_g.out_edges[guid]:
            ne = Edge(
                remap.get(e.src, e.src),
                remap.get(e.dst, e.dst),
                e.src_idx,
                e.dst_idx,
            )
            acc_g.out_edges[ne.src].append(ne)
            acc_g.in_edges[ne.dst].append(ne)
    for guid, v in post_s.items():
        acc_s[remap.get(guid, guid)] = v
    acc_g._invalidate()
