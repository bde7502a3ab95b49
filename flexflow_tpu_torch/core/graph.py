"""The Parallel Computation Graph (PCG) — a copy of
flexflow_tpu/core/graph.py (the whole ``Graph``: construction, splits,
hashing, dominators, the native graph engines through
``flexflow_tpu_torch.native``), rewired to the port.

A DAG of operator nodes connected by tensor edges — the IR that the
auto-parallelization search rewrites and costs.  Re-implements the
capabilities of the reference's PCG (reference: src/runtime/graph.cc:299-362,
include/flexflow/graph.h:240, dominators.h) in pure Python with no
runtime coupling: nodes hold immutable operator descriptors, and
parallelization strategies live *outside* the graph as
``{node_guid: MachineView}`` maps, so one graph can be costed under
many strategies without copying.

Provides the graph algorithms the search needs: topological order,
dominators/post-dominators, bottleneck (articulation) node finding
(reference: graph.cc:580), sequence/horizontal splits
(reference: graph.cc:96-295), structural hashing for memoization
(reference: graph.cc:1356), and graphviz export.
"""

from __future__ import annotations

from heapq import heapify, heappop, heappush
from typing import Dict, List, NamedTuple, Optional, Set, Tuple


class Edge(NamedTuple):
    """Tensor edge: output ``src_idx`` of ``src`` feeds input ``dst_idx`` of ``dst``.

    A NamedTuple, not a dataclass: substitution candidate generation
    constructs hundreds of thousands per search, and the frozen-
    dataclass ``object.__setattr__`` init was a measured hotspot."""

    src: int  # node guid
    dst: int  # node guid
    src_idx: int = 0
    dst_idx: int = 0


class Node:
    """A PCG node: guid + operator descriptor.

    ``op`` is any object exposing ``op_type``, ``name``,
    ``output_shapes`` and a stable ``signature()`` used for structural
    hashing (operators from flexflow_tpu_torch.ops satisfy this).
    """

    __slots__ = ("guid", "op")

    def __init__(self, guid: int, op):
        self.guid = guid
        self.op = op

    def __repr__(self) -> str:
        return f"Node({self.guid}, {getattr(self.op, 'name', self.op)})"


class Graph:
    """Directed multigraph of operator nodes (the PCG)."""

    def __init__(self):
        self.nodes: Dict[int, Node] = {}
        self.in_edges: Dict[int, List[Edge]] = {}
        self.out_edges: Dict[int, List[Edge]] = {}
        self._next_guid = 1
        self._topo_cache: Optional[List[Node]] = None
        self._hash_cache: Optional[int] = None
        self._node_hash_cache: Optional[Dict[int, int]] = None
        self._anc_hash_cache: Optional[Dict[int, int]] = None
        # process-stable digests (persistent DP memo keys) — computed
        # lazily by stable_node_digests / cost_cache.stable_graph_digest
        self._stable_nh_cache: Optional[Dict[int, str]] = None
        self._stable_gd_cache: Optional[str] = None

    # ---- construction ----------------------------------------------------
    def new_node(self, op) -> Node:
        node = Node(self._next_guid, op)
        self._next_guid += 1
        self.add_node(node)
        return node

    def _invalidate(self) -> None:
        self._topo_cache = None
        self._hash_cache = None
        self._node_hash_cache = None
        self._anc_hash_cache = None
        self._stable_nh_cache = None
        self._stable_gd_cache = None

    def add_node(self, node: Node) -> None:
        if node.guid in self.nodes:
            return
        self._invalidate()
        self.nodes[node.guid] = node
        self.in_edges.setdefault(node.guid, [])
        self.out_edges.setdefault(node.guid, [])
        self._next_guid = max(self._next_guid, node.guid + 1)

    def add_edge(self, src: Node, dst: Node, src_idx: int = 0, dst_idx: int = 0) -> None:
        self.add_node(src)
        self.add_node(dst)
        self._invalidate()
        e = Edge(src.guid, dst.guid, src_idx, dst_idx)
        self.out_edges[src.guid].append(e)
        self.in_edges[dst.guid].append(e)

    def remove_node(self, guid: int) -> None:
        self._invalidate()
        for e in list(self.in_edges.get(guid, [])):
            self.out_edges[e.src].remove(e)
        for e in list(self.out_edges.get(guid, [])):
            self.in_edges[e.dst].remove(e)
        self.in_edges.pop(guid, None)
        self.out_edges.pop(guid, None)
        self.nodes.pop(guid, None)

    def __getstate__(self):
        # pickle structure only: derived caches rebuild on demand, and
        # delta annotations (_changed_vs parent weakref, touched sets)
        # are meaningless outside the process that made them — the
        # persistent search-result cache pickles rewritten graphs
        return {
            "nodes": self.nodes,
            "in_edges": self.in_edges,
            "out_edges": self.out_edges,
            "_next_guid": self._next_guid,
        }

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._topo_cache = None
        self._hash_cache = None
        self._node_hash_cache = None
        self._anc_hash_cache = None
        self._stable_nh_cache = None
        self._stable_gd_cache = None

    def copy(self) -> "Graph":
        g = Graph()
        g._next_guid = self._next_guid
        # nodes are immutable (op descriptors shared); C-level copies —
        # candidate generation clones the graph once per substitution
        g.nodes = dict(self.nodes)
        g.in_edges = {k: list(v) for k, v in self.in_edges.items()}
        g.out_edges = {k: list(v) for k, v in self.out_edges.items()}
        return g

    def copy_cow(self) -> "Graph":
        """Copy-on-write clone: edge LISTS are shared with the parent.
        Callers must REPLACE a node's edge list to change it, never
        mutate one in place (substitution._insert_before/_insert_after
        follow this; remove_node does NOT — rewrites that delete nodes
        take a full copy()).  Candidate generation applies thousands of
        single-splice rewrites per search; sharing the untouched lists
        is most of a copy's cost back, and lets delta consumers detect
        unchanged nodes by list identity."""
        g = Graph()
        g._next_guid = self._next_guid
        g.nodes = dict(self.nodes)
        g.in_edges = dict(self.in_edges)
        g.out_edges = dict(self.out_edges)
        return g

    # ---- queries ---------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_edges(self) -> int:
        return sum(len(v) for v in self.out_edges.values())

    def sources(self) -> List[Node]:
        return [self.nodes[g] for g in self.nodes if not self.in_edges[g]]

    def sinks(self) -> List[Node]:
        return [self.nodes[g] for g in self.nodes if not self.out_edges[g]]

    def predecessors(self, guid: int) -> List[int]:
        seen, out = set(), []
        for e in self.in_edges[guid]:
            if e.src not in seen:
                seen.add(e.src)
                out.append(e.src)
        return out

    def successors(self, guid: int) -> List[int]:
        seen, out = set(), []
        for e in self.out_edges[guid]:
            if e.dst not in seen:
                seen.add(e.dst)
                out.append(e.dst)
        return out

    def topo_order(self) -> List[Node]:
        """Deterministic Kahn topological order (ties by guid); cached —
        the search costs one graph thousands of times."""
        if self._topo_cache is not None:
            return self._topo_cache
        indeg = {g: len(self.in_edges[g]) for g in self.nodes}
        ready = [g for g, d in indeg.items() if d == 0]
        order: List[Node] = []
        heapify(ready)
        while ready:
            g = heappop(ready)
            order.append(self.nodes[g])
            for e in self.out_edges[g]:
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    heappush(ready, e.dst)
        if len(order) != len(self.nodes):
            raise ValueError("graph has a cycle")
        self._topo_cache = order
        return order

    # ---- structural hash (memoization key) -------------------------------
    def _sig_repr(self, node: Node) -> str:
        op = node.op
        sig = getattr(op, "_sig_repr_cache", None)
        if sig is None:
            sig = repr(op.signature()) if hasattr(op, "signature") else repr(op)
            try:
                op._sig_repr_cache = sig  # ops are immutable; see base.py
            except AttributeError:
                pass
        return sig

    def hash(self) -> int:
        """Structure-and-op hash, stable across guid renumbering.

        Iteratively refines per-node hashes from op signatures and
        predecessor hashes — same role as the reference's graph hash
        used to memoize DP states (reference: src/runtime/graph.cc:1356).
        """
        if self._hash_cache is not None:
            return self._hash_cache
        h = self._anc_hash_cache or self._anc_hash_map()
        out = hash(tuple(sorted(h[n.guid] for n in self.sinks())))
        self._hash_cache = out
        return out

    def _anc_hash_map(self) -> Dict[int, int]:
        """Ancestor-refined per-node hashes (the forward half of
        ``node_hashes``) — in-process tuple hashing: every consumer
        (DP memo, driver segment cache, best-first seen-set) lives in
        this process, and the search hashes tens of thousands of
        rewritten graphs (blake2b-over-strings here was a measured 6s
        of the Inception search).

        Delta path: a substituted graph carries the changed-guid sets
        its rewrite touched (substitution._finish_rewrite); when the
        parent has PRIMED hashes (``prime_delta_hashes``, called on
        best-first pop), the clean cone copies the parent's values —
        the per-node hash is a pure function of sig + pred hashes, so
        the copy is exact — and only the dirty cone pays the tuple
        building.  The map is NOT cached here: storing a per-node dict
        on all ~10^4 candidate graphs of a search was measured as 2s of
        pure GC pressure on Inception."""
        h: Dict[int, int] = {}
        in_edges = self.in_edges
        ph = None
        cv = getattr(self, "_changed_vs", None)
        if cv is not None:
            parent = cv[0]()
            if parent is not None:
                ph = parent._anc_hash_cache
        if ph is not None:
            dirty = cv[1]
            # start from the parent's map (C-level copy; stale entries
            # for removed nodes are never read) and rewrite only the
            # cone whose hash actually moved — `diff` tracks it
            h = dict(ph)
            diff: Set[int] = set()
            for node in self.topo_order():
                g = node.guid
                el = in_edges[g]
                if g not in dirty:
                    for e in el:
                        if e.src in diff:
                            break
                    else:
                        continue  # parent's value stands
                if len(el) == 1:  # the common case: skip the sort
                    e = el[0]
                    ins = ((h[e.src], e.src_idx, e.dst_idx),)
                else:
                    ins = tuple(sorted(
                        (h[e.src], e.src_idx, e.dst_idx) for e in el))
                v = hash((self._sig_repr(node), ins))
                if v != h.get(g):
                    diff.add(g)
                    h[g] = v
        else:
            for node in self.topo_order():
                el = in_edges[node.guid]
                if len(el) == 1:
                    e = el[0]
                    ins = ((h[e.src], e.src_idx, e.dst_idx),)
                else:
                    ins = tuple(sorted(
                        (h[e.src], e.src_idx, e.dst_idx) for e in el))
                h[node.guid] = hash((self._sig_repr(node), ins))
        return h

    def prime_delta_hashes(self) -> Dict[int, int]:
        """Retain this graph's ancestor-hash map so derived rewrites
        hash incrementally.  Called for graphs that become substitution
        PARENTS (best-first pops) — a bounded set, unlike the candidate
        stream."""
        if self._anc_hash_cache is None:
            self._anc_hash_cache = self._anc_hash_map()
        return self._anc_hash_cache

    def node_hashes(self) -> Dict[int, int]:
        """Bidirectional per-node structural hashes: combines each
        node's ancestor-refined and descendant-refined hash, so two
        nodes get equal hashes only when their full structural contexts
        match.  Nodes with equal hashes are interchangeable under graph
        isomorphism — the basis for guid-independent DP memoization
        (reference memoizes by the same kind of structural hash,
        graph.cc:1356; here per-node so cached *strategies* can be
        remapped onto isomorphic segments, e.g. repeated transformer
        layers)."""
        if self._node_hash_cache is not None:
            return self._node_hash_cache
        topo = self.topo_order()
        anc: Dict[int, int] = {}
        for node in topo:
            ins = sorted(
                (anc[e.src], e.src_idx, e.dst_idx)
                for e in self.in_edges[node.guid]
            )
            anc[node.guid] = hash((self._sig_repr(node), tuple(ins)))
        desc: Dict[int, int] = {}
        for node in reversed(topo):
            outs = sorted(
                (desc[e.dst], e.src_idx, e.dst_idx)
                for e in self.out_edges[node.guid]
            )
            desc[node.guid] = hash((self._sig_repr(node), tuple(outs)))
        combined = {g: hash((anc[g], desc[g])) for g in self.nodes}
        self._node_hash_cache = combined
        return combined

    def stable_sig_reprs(self) -> Dict[int, str]:
        """Per-node signature strings for PROCESS-STABLE digesting —
        the ONE input-handling rule shared by ``stable_node_digests``
        and ``cost_cache.stable_graph_digest`` (they key the same
        persisted memo rows and must stay in lock-step): InputOp
        signatures embed the frontend's GLOBAL tensor_guid counter
        (process-lifetime, build-order dependent), so the input's rank
        of appearance in topo order is substituted — it carries the
        same distinctness without the counter, letting graphs/segments
        containing model inputs digest identically across builds."""
        input_rank: Dict[object, int] = {}
        sigs: Dict[int, str] = {}
        for node in self.topo_order():
            op = node.op
            if op.op_type.value == "input":
                shape = op.output_shapes[0]
                sigs[node.guid] = repr((
                    "input", shape.sizes, shape.dtype.value,
                    input_rank.setdefault(
                        op.attrs.get("tensor_guid"), len(input_rank)),
                ))
            else:
                sigs[node.guid] = self._sig_repr(node)
        return sigs

    def stable_node_digests(self) -> Dict[int, str]:
        """Process-stable analogue of ``node_hashes``: per-node
        structural digests combining the ancestor- and descendant-
        refined context, as blake2b hex over signature strings instead
        of python tuple hashes (PYTHONHASHSEED randomizes those across
        processes).  Nodes with equal digests are interchangeable under
        graph isomorphism — the pairing rule the persistent DP memo
        (search/cost_cache.py dp-row layer) stores strategies under, so
        a COLD process can remap a row solved by any prior run.  Cached
        per graph; only consumers that persist/serve rows compute it."""
        if self._stable_nh_cache is not None:
            return self._stable_nh_cache
        from hashlib import blake2b

        def h(payload: str) -> str:
            return blake2b(payload.encode(), digest_size=12).hexdigest()

        topo = self.topo_order()
        sigs = self.stable_sig_reprs()
        anc: Dict[int, str] = {}
        for node in topo:
            ins = sorted(
                (anc[e.src], e.src_idx, e.dst_idx)
                for e in self.in_edges[node.guid]
            )
            anc[node.guid] = h(sigs[node.guid] + repr(ins))
        desc: Dict[int, str] = {}
        for node in reversed(topo):
            outs = sorted(
                (desc[e.dst], e.src_idx, e.dst_idx)
                for e in self.out_edges[node.guid]
            )
            desc[node.guid] = h(sigs[node.guid] + repr(outs))
        combined = {g: h(anc[g] + desc[g]) for g in self.nodes}
        self._stable_nh_cache = combined
        return combined

    def remap(self, mapping: Dict[int, int], fresh_start: Optional[int] = None) -> Tuple["Graph", Dict[int, int]]:
        """New graph with guids renamed through ``mapping``; nodes not in
        the mapping get fresh guids from ``fresh_start`` (default: after
        every mapped guid).  Returns (graph, full mapping incl. fresh
        assignments).  Used to transplant a cached optimized segment onto
        an isomorphic segment with different guids."""
        full = dict(mapping)
        nxt = fresh_start if fresh_start is not None else (
            max(list(mapping.values()) + [self._next_guid]) + 1
        )
        for guid in sorted(self.nodes):
            if guid not in full:
                full[guid] = nxt
                nxt += 1
        g = Graph()
        g._next_guid = nxt
        for guid in self.nodes:
            ng = full[guid]
            n = self.nodes[guid]
            g.nodes[ng] = n if ng == guid else Node(ng, n.op)
            g.in_edges[ng] = []
            g.out_edges[ng] = []
        for guid in self.nodes:
            for e in self.out_edges[guid]:
                ne = Edge(full[e.src], full[e.dst], e.src_idx, e.dst_idx)
                g.out_edges[ne.src].append(ne)
                g.in_edges[ne.dst].append(ne)
        return g, full

    # ---- dominators & bottlenecks ----------------------------------------
    def dominators(self) -> Dict[int, Set[int]]:
        """dom(v) = set of nodes on every path from any source to v
        (multi-source DAG variant, reference: include/flexflow/dominators.h)."""
        dom: Dict[int, Set[int]] = {}
        for node in self.topo_order():
            preds = self.predecessors(node.guid)
            if not preds:
                dom[node.guid] = {node.guid}
            else:
                inter = set(dom[preds[0]])
                for p in preds[1:]:
                    inter &= dom[p]
                inter.add(node.guid)
                dom[node.guid] = inter
        return dom

    def post_dominators(self) -> Dict[int, Set[int]]:
        return self.reversed().dominators()

    def reversed(self) -> "Graph":
        g = Graph()
        g._next_guid = self._next_guid
        for guid, n in self.nodes.items():
            g.nodes[guid] = n
            g.in_edges[guid] = [Edge(e.dst, e.src, e.src_idx, e.dst_idx) for e in self.out_edges[guid]]
            g.out_edges[guid] = [Edge(e.dst, e.src, e.src_idx, e.dst_idx) for e in self.in_edges[guid]]
        return g

    def bottlenecks(self) -> List[Node]:
        """Nodes through which *every* source→sink path passes, in topo
        order, excluding sources/sinks — the sequence-split candidates
        (reference: src/runtime/graph.cc:580 find_bottleneck_node).
        Runs on the native bitset engine when available
        (native/src/graph_algos.cpp ffn_graph_bottlenecks)."""
        if not self.nodes:
            return []
        native = self._native_call("graph_bottlenecks")
        if native is not None:
            idx_to_guid, result = native
            return [self.nodes[idx_to_guid[i]] for i in result]
        sink_guids = [n.guid for n in self.sinks()]
        src_guids = {n.guid for n in self.sources()}
        dom = self.dominators()
        pdom = self.post_dominators()
        common_dom = None
        for s in sink_guids:
            common_dom = set(dom[s]) if common_dom is None else common_dom & dom[s]
        common_pdom = None
        for s in src_guids:
            common_pdom = set(pdom[s]) if common_pdom is None else common_pdom & pdom[s]
        cands = (common_dom or set()) & (common_pdom or set())
        cands -= src_guids
        cands -= set(sink_guids)
        order = {n.guid: i for i, n in enumerate(self.topo_order())}
        return [self.nodes[g] for g in sorted(cands, key=lambda g: order[g])]

    # ---- splits (used by DP search) --------------------------------------
    def split_at_node(self, node: Node) -> Tuple["Graph", "Graph"]:
        """Sequence split: (prefix including ``node``, suffix with ``node``
        as its source) — reference: src/runtime/graph.cc:96-159."""
        order = self.topo_order()
        idx = {n.guid: i for i, n in enumerate(order)}
        pivot = idx[node.guid]
        first, second = Graph(), Graph()
        first._next_guid = second._next_guid = self._next_guid
        pre_guids = {n.guid for n in order[: pivot + 1]}
        for guid, n in self.nodes.items():
            if guid in pre_guids:
                first.add_node(n)
            if guid not in pre_guids or guid == node.guid:
                second.add_node(n)
        for guid in self.nodes:
            for e in self.out_edges[guid]:
                s_pre, d_pre = e.src in pre_guids, e.dst in pre_guids
                if s_pre and d_pre:
                    first.out_edges[e.src].append(e)
                    first.in_edges[e.dst].append(e)
                elif not s_pre and not d_pre:
                    second.out_edges[e.src].append(e)
                    second.in_edges[e.dst].append(e)
                elif e.src == node.guid and not d_pre:
                    second.out_edges[e.src].append(e)
                    second.in_edges[e.dst].append(e)
                else:
                    # crossing edge not through the bottleneck: caller must
                    # only split at true bottlenecks
                    raise ValueError(f"split_at_node: edge {e} crosses the split")
        return first, second

    def split_horizontal(self) -> Optional[Tuple["Graph", "Graph"]]:
        """Partition into two independent (vertex-disjoint, no crossing
        edges) subgraphs if the PCG is disconnected between them —
        reference: src/runtime/graph.cc:161-295 nonsequence split."""
        comps = self.weakly_connected_components()
        if len(comps) < 2:
            return None
        half = len(comps) // 2
        a_guids = set().union(*comps[:half])
        return self._subgraph(a_guids), self._subgraph(
            set(self.nodes) - a_guids
        )

    def _native_call(self, fn_name: str):
        """Run a native graph algorithm over dense indices (sorted-guid
        order, matching the Python tie-breaks). None = lib unavailable."""
        try:
            from flexflow_tpu_torch import native
        except ImportError:
            return None
        fn = getattr(native, fn_name)
        guids = sorted(self.nodes)
        index = {g: i for i, g in enumerate(guids)}
        edges = [
            (index[e.src], index[e.dst])
            for g in self.nodes
            for e in self.out_edges[g]
        ]
        result = fn(len(guids), edges)
        if result is None:
            return None
        return guids, result

    def weakly_connected_components(self) -> List[Set[int]]:
        native = self._native_call("graph_components")
        if native is not None:
            guids, labels = native
            comps: Dict[int, Set[int]] = {}
            for g, lbl in zip(guids, labels):
                comps.setdefault(lbl, set()).add(g)
            # native labels are assigned in smallest-member order already
            return [comps[k] for k in sorted(comps)]
        parent = {g: g for g in self.nodes}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for guid in self.nodes:
            for e in self.out_edges[guid]:
                ra, rb = find(e.src), find(e.dst)
                if ra != rb:
                    parent[ra] = rb
        comps: Dict[int, Set[int]] = {}
        for g in self.nodes:
            comps.setdefault(find(g), set()).add(g)
        # deterministic order (and native-path parity): by smallest member
        return sorted(comps.values(), key=min)

    def _subgraph(self, guids: Set[int]) -> "Graph":
        g = Graph()
        g._next_guid = self._next_guid
        for guid in guids:
            g.add_node(self.nodes[guid])
        for guid in guids:
            for e in self.out_edges[guid]:
                if e.dst in guids:
                    g.out_edges[e.src].append(e)
                    g.in_edges[e.dst].append(e)
        return g

    # ---- verification ----------------------------------------------------
    def check(self, strict_shapes: bool = True) -> list:
        """Well-formedness findings for this PCG ([] = sound) — the
        static-analysis invariant pass (flexflow_tpu_torch/analysis,
        PCG0xx codes) as an instance method for interactive debugging.
        Lazy import: the graph core stays dependency-free."""
        from flexflow_tpu_torch.analysis.invariants import check_graph

        return check_graph(self, strict_shapes=strict_shapes)

    # ---- export ----------------------------------------------------------
    def to_dot(self, strategy: Optional[Dict[int, object]] = None) -> str:
        """Graphviz export (reference: substitution.cc:1790
        export_strategy_computation_graph_file)."""
        lines = ["digraph PCG {", "  rankdir=TB;"]
        for guid, n in sorted(self.nodes.items()):
            label = getattr(n.op, "name", str(n.op))
            if strategy and guid in strategy:
                label += f"\\n{strategy[guid]}"
            lines.append(f'  n{guid} [label="{label}" shape=box];')
        for guid in sorted(self.nodes):
            for e in self.out_edges[guid]:
                lines.append(f"  n{e.src} -> n{e.dst};")
        lines.append("}")
        return "\n".join(lines)

    def write_dot(self, path: str, strategy=None) -> None:
        with open(path, "w") as f:
            f.write(self.to_dot(strategy))
