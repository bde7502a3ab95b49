"""The port's ``core.graph.Graph`` against the reference's: the nine
contracts of tests/test_graph.py on the port's class, and the
structural hashes the search keys its memos by (``hash``,
``node_hashes``, ``stable_node_digests``, ``stable_graph_digest``)
equal to the JAX package's on the same builder calls."""

from __future__ import annotations

import pickle

import numpy as np
import pytest

import flexflow_tpu as ff
import flexflow_tpu.models as jmods
import flexflow_tpu_torch as tff
import flexflow_tpu_torch.models as tmods
from flexflow_tpu.search.cost_cache import stable_graph_digest as ref_digest
from flexflow_tpu_torch.core.graph import Graph
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.search.cost_cache import stable_graph_digest


class FakeOp:
    def __init__(self, name):
        self.name = name
        self.op_type = name

    def signature(self):
        return ("fake", self.name)


def chain(names):
    g = Graph()
    nodes = [g.new_node(FakeOp(n)) for n in names]
    for a, b in zip(nodes, nodes[1:]):
        g.add_edge(a, b)
    return g, nodes


def test_topo_order_chain():
    g, _ = chain(["a", "b", "c", "d"])
    assert [n.op.name for n in g.topo_order()] == ["a", "b", "c", "d"]


def test_diamond_dominators_and_bottlenecks():
    g = Graph()
    a, b, c, d, e = (g.new_node(FakeOp(x)) for x in "abcde")
    for s, t in ((a, b), (a, c), (b, d), (c, d), (d, e)):
        g.add_edge(s, t)
    dom = g.dominators()
    assert dom[d.guid] == {a.guid, d.guid}
    assert dom[e.guid] == {a.guid, d.guid, e.guid}
    assert [n.op.name for n in g.bottlenecks()] == ["d"]


def test_split_at_bottleneck():
    g, (a, b, c, d) = chain(["a", "b", "c", "d"])
    first, second = g.split_at_node(b)
    assert {n.op.name for n in first.nodes.values()} == {"a", "b"}
    assert {n.op.name for n in second.nodes.values()} == {"b", "c", "d"}
    assert [n.op.name for n in second.sources()] == ["b"]


def test_split_crossing_edge_rejected():
    g = Graph()
    a, b, c = (g.new_node(FakeOp(x)) for x in "abc")
    g.add_edge(a, b)
    g.add_edge(a, c)
    g.add_edge(b, c)
    with pytest.raises(ValueError):
        g.split_at_node(b)


def test_hash_stable_under_renumbering():
    g1, _ = chain(["a", "b", "c"])
    g2 = Graph()
    n3 = g2.new_node(FakeOp("c"))
    n1 = g2.new_node(FakeOp("a"))
    n2 = g2.new_node(FakeOp("b"))
    g2.add_edge(n1, n2)
    g2.add_edge(n2, n3)
    assert g1.hash() == g2.hash()
    g3, _ = chain(["a", "b", "x"])
    assert g1.hash() != g3.hash()


def test_components_and_horizontal_split():
    g = Graph()
    a, b, c, d = (g.new_node(FakeOp(x)) for x in "abcd")
    g.add_edge(a, b)
    g.add_edge(c, d)
    assert len(g.weakly_connected_components()) == 2
    ga, gb = g.split_horizontal()
    assert ga.num_nodes == 2 and gb.num_nodes == 2


def test_cycle_detection():
    g = Graph()
    a, b = (g.new_node(FakeOp(x)) for x in "ab")
    g.add_edge(a, b)
    g.add_edge(b, a)
    with pytest.raises(ValueError):
        g.topo_order()


def test_dot_export():
    g, _ = chain(["x", "y"])
    dot = g.to_dot()
    assert "digraph PCG" in dot and "x" in dot and "->" in dot


def test_machine_view():
    mv = MachineView.data_parallel(3, 8)
    assert mv.num_parts == 8
    assert mv.dim_degrees == (8, 1, 1)
    assert MachineView.trivial(2).is_trivial


# ---- the same builder calls in both packages ------------------------------
GPT = dict(vocab=128, num_layers=2, hidden=32, num_heads=4, ff_dim=64,
           seq_len=64)
TR = dict(num_layers=2, hidden=32, num_heads=4, ff_dim=64, seq_len=16)


def _mlp(pkg, cfg):
    m = pkg.FFModel(cfg)
    x = m.create_tensor([16, 32])
    t = m.dense(x, 64, activation="relu", name="fc1")
    a = m.dense(t, 32, name="fa")
    b = m.dense(t, 32, name="fb")
    m.dense(m.add(a, b, name="join"), 8, name="head")
    return m


BUILDS = {
    "gpt": lambda pkg, mods, cfg: mods.build_gpt(cfg, **GPT),
    "transformer": lambda pkg, mods, cfg: mods.build_transformer(
        cfg, layer_norm=True, **TR),
    "branchy_mlp": lambda pkg, mods, cfg: _mlp(pkg, cfg),
}


def _pair(name):
    """The same builder calls in both packages.  An input's signature
    holds its tensor's guid, a per-package counter: both counters start
    at one value, so ``hash``/``node_hashes`` (which keep it) can be
    compared too."""
    from flexflow_tpu.core.ptensor import Tensor as RefTensor
    from flexflow_tpu_torch.core.ptensor import Tensor

    start = max(RefTensor._next_guid, Tensor._next_guid)
    RefTensor._next_guid = Tensor._next_guid = start
    ref = BUILDS[name](ff, jmods, ff.FFConfig(batch_size=16, num_devices=4))
    port = BUILDS[name](tff, tmods, tff.FFConfig(batch_size=16, num_devices=4,
                                                 device="cpu"))
    return ref.graph, port.graph


def _by_name(graph, values):
    return {graph.nodes[g].op.name: v for g, v in values.items()}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_structural_hashes_equal_the_reference(name):
    ref, port = _pair(name)
    assert [n.op.name for n in port.topo_order()] == [
        n.op.name for n in ref.topo_order()]
    assert port.hash() == ref.hash()
    assert _by_name(port, port.node_hashes()) == _by_name(
        ref, ref.node_hashes())
    assert _by_name(port, port.stable_node_digests()) == _by_name(
        ref, ref.stable_node_digests())
    assert stable_graph_digest(port) == ref_digest(ref)
    assert [n.op.name for n in port.bottlenecks()] == [
        n.op.name for n in ref.bottlenecks()]


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_copy_pickle_remap_and_native_keep_the_structure(name, monkeypatch):
    _, g = _pair(name)
    digest = stable_graph_digest(g)
    for other in (g.copy(), g.copy_cow(), pickle.loads(pickle.dumps(g))):
        assert stable_graph_digest(other) == digest
        assert other.hash() == g.hash()
    shift = {guid: guid + 100 for guid in g.nodes}
    moved, full = g.remap(shift)
    assert sorted(moved.nodes) == sorted(full[x] for x in g.nodes)
    assert moved.hash() == g.hash() and stable_graph_digest(moved) == digest
    assert g.check() == []
    # the native graph engine and the Python path agree
    native = [n.guid for n in g.bottlenecks()]
    comps = g.weakly_connected_components()
    monkeypatch.setattr(Graph, "_native_call", lambda self, fn: None)
    assert [n.guid for n in g.bottlenecks()] == native
    assert g.weakly_connected_components() == comps
    # removing a node leaves a graph the invariant pass still accepts
    sink = g.sinks()[0]
    h = g.copy()
    h.remove_node(sink.guid)
    assert sink.guid not in h.nodes and h.check() == []
    np.testing.assert_equal(len(h.nodes), len(g.nodes) - 1)
