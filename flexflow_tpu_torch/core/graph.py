"""The Parallel Computation Graph — the construction and ordering part
of flexflow_tpu/core/graph.py.

A DAG of operator nodes connected by tensor edges.  The reference's
search algorithms (dominators, splits, structural hashing) come with
the search slice; the decode path needs only building the graph and
walking it in topological order.
"""

from __future__ import annotations

from heapq import heapify, heappop, heappush
from typing import Dict, List, NamedTuple, Optional


class Edge(NamedTuple):
    """Tensor edge: output ``src_idx`` of ``src`` feeds input ``dst_idx``
    of ``dst``."""

    src: int  # node guid
    dst: int  # node guid
    src_idx: int = 0
    dst_idx: int = 0


class Node:
    """A PCG node: guid + operator descriptor."""

    __slots__ = ("guid", "op")

    def __init__(self, guid: int, op):
        self.guid = guid
        self.op = op

    def __repr__(self) -> str:
        return f"Node({self.guid}, {getattr(self.op, 'name', self.op)})"


class Graph:
    """Directed multigraph of operator nodes."""

    def __init__(self):
        self.nodes: Dict[int, Node] = {}
        self.in_edges: Dict[int, List[Edge]] = {}
        self.out_edges: Dict[int, List[Edge]] = {}
        self._next_guid = 1
        self._topo_cache: Optional[List[Node]] = None

    def new_node(self, op) -> Node:
        node = Node(self._next_guid, op)
        self._next_guid += 1
        self.add_node(node)
        return node

    def add_node(self, node: Node) -> None:
        if node.guid in self.nodes:
            return
        self._topo_cache = None
        self.nodes[node.guid] = node
        self.in_edges.setdefault(node.guid, [])
        self.out_edges.setdefault(node.guid, [])
        self._next_guid = max(self._next_guid, node.guid + 1)

    def add_edge(self, src: Node, dst: Node, src_idx: int = 0,
                 dst_idx: int = 0) -> None:
        self.add_node(src)
        self.add_node(dst)
        self._topo_cache = None
        e = Edge(src.guid, dst.guid, src_idx, dst_idx)
        self.out_edges[src.guid].append(e)
        self.in_edges[dst.guid].append(e)

    def sinks(self) -> List[Node]:
        return [self.nodes[g] for g in self.nodes if not self.out_edges[g]]

    def topo_order(self) -> List[Node]:
        """Deterministic Kahn topological order (ties by guid), as the
        reference orders it."""
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
