"""The port's strategy search against the JAX package's, on the same
builder calls and the reference's machine specs (``tpu_v5e(n)`` and
``host_cpu(n)``), at n = 4 and 8:

* ``candidate_views`` and ``boundary_views`` per op equal;
* the simulated step of the trivial, data-parallel and Megatron
  strategies within 1e-9 relative;
* ``SearchHelper``'s DP: the same cost and views, and the port's native
  engine equal to its Python path;
* the substitution registry's xfer names equal;
* ``optimize_strategy(return_graph=True)``: the same views per stable
  node digest and the same ``stable_graph_digest`` of the returned
  graph, on ``mlp_model`` and ``big_weight_model`` of
  tests/test_search.py (the latter must find a tensor split), a
  transformer and a GPT;
* strategy files exported by either package import into the other and
  pass ``tools/fflint.py strategy``;
* ``MachineSpec`` round-trips through ``to_file``/``from_file``, the
  H100 spec included.

The searches run with no deadline (``search_timeout_s=0``) and no match
workers, so the host's speed cannot change an answer."""

from __future__ import annotations

import math
import os
import subprocess
import sys

import pytest

import flexflow_tpu as ff
import flexflow_tpu.models as jmods
import flexflow_tpu_torch as tff
import flexflow_tpu_torch.models as tmods
from flexflow_tpu.compiler.lowering import (
    data_parallel_strategy as ref_dp_strategy,
)
from flexflow_tpu.core.machine import MachineSpec as RefSpec
from flexflow_tpu.core.machine import MachineView as RefView
from flexflow_tpu.search import driver as ref_driver
from flexflow_tpu.search import strategy_io as ref_io
from flexflow_tpu.search.cost_cache import stable_graph_digest as ref_digest
from flexflow_tpu.search.dp import SearchHelper as RefHelper
from flexflow_tpu.search.simulator import Simulator as RefSim
from flexflow_tpu.search.substitution import (
    generate_all_pcg_xfers as ref_xfers,
)
from flexflow_tpu.search.views import boundary_views as ref_bviews
from flexflow_tpu.search.views import candidate_views as ref_cviews
from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy
from flexflow_tpu_torch.core.machine import MachineSpec, MachineView
from flexflow_tpu_torch.search import driver, strategy_io
from flexflow_tpu_torch.search.cost_cache import stable_graph_digest
from flexflow_tpu_torch.search.dp import SearchHelper
from flexflow_tpu_torch.search.simulator import Simulator
from flexflow_tpu_torch.search.substitution import generate_all_pcg_xfers
from flexflow_tpu_torch.search.views import boundary_views, candidate_views

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = ("tpu_v5e", "host_cpu")
WORLDS = (4, 8)
REL = 1e-9


def mlp_model(pkg, cfg, batch=64, in_dim=128, hidden=256, classes=16):
    """tests/test_search.py's ``mlp_model``."""
    m = pkg.FFModel(cfg)
    x = m.create_tensor([batch, in_dim])
    t = m.dense(x, hidden, activation="relu", name="fc1")
    t = m.dense(t, hidden, activation="relu", name="fc2")
    m.dense(t, classes, name="head")
    return m


def big_weight_model(pkg, cfg):
    """tests/test_search.py's ``big_weight_model``: tiny batch, big
    weights, where data parallelism must lose to a tensor split."""
    return mlp_model(pkg, cfg, batch=8, in_dim=2048, hidden=2048)


MODELS = {
    "mlp": (lambda pkg, mods, cfg: mlp_model(pkg, cfg), 64),
    "big_weight": (lambda pkg, mods, cfg: big_weight_model(pkg, cfg), 8),
    "transformer": (lambda pkg, mods, cfg: mods.build_transformer(
        cfg, num_layers=2, hidden=64, num_heads=4, ff_dim=128,
        seq_len=64), 8),
    "gpt": (lambda pkg, mods, cfg: mods.build_gpt(
        cfg, vocab=128, num_layers=2, hidden=64, num_heads=4, ff_dim=128,
        seq_len=64), 8),
}


def build_pair(name, spec, n):
    """The same model in both packages, each with its package's copy of
    the reference spec ``spec`` at n devices."""
    build, batch = MODELS[name]
    common = dict(batch_size=batch, num_devices=n, search_timeout_s=0,
                  compute_dtype="float32")
    ref = build(ff, jmods, ff.FFConfig(
        machine_spec=getattr(RefSpec, spec)(n), cost_cache_file="",
        **common))
    port = build(tff, tmods, tff.FFConfig(
        machine_spec=getattr(MachineSpec, spec)(n), device="cpu", **common))
    return ref, port


def views_by_digest(graph, strategy):
    digests = graph.stable_node_digests()
    out = {}
    for guid, v in strategy.items():
        out.setdefault(digests[guid], []).append(
            (tuple(v.dim_degrees), v.replica_degree, v.start_part))
    return {k: sorted(v) for k, v in out.items()}


def by_name(graph, strategy):
    return {graph.nodes[g].op.name: (tuple(v.dim_degrees), v.replica_degree,
                                     v.start_part)
            for g, v in strategy.items()}


def megatron(model, view_cls):
    """Megatron dp 2 x tp 2 (MHA and ff2 row-parallel, ff1
    column-parallel), every other op batch-split 2 ways where it can
    be."""
    views = {}
    for node in model.graph.topo_order():
        op = node.op
        nd = op.output_shapes[0].ndim
        degs = [1] * nd
        if nd and 0 in op.splittable_output_dims():
            degs[0] = 2
        views[node.guid] = view_cls(tuple(degs))
        if op.op_type.value == "multihead_attention" or op.name.endswith(
                "_ff2"):
            views[node.guid] = view_cls((2, 1, 1), replica_degree=2)
        elif op.name.endswith("_ff1"):
            views[node.guid] = view_cls((2, 1, 2))
    return views


def close(a, b):
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= REL * max(abs(a), abs(b))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_candidate_and_boundary_views_equal_the_reference(name, n):
    ref, port = build_pair(name, "tpu_v5e", n)
    for rn, tn in zip(ref.graph.topo_order(), port.graph.topo_order()):
        assert tn.op.name == rn.op.name
        for fn, ref_fn in ((candidate_views, ref_cviews),
                           (boundary_views, ref_bviews)):
            got = [(v.dim_degrees, v.replica_degree, v.start_part)
                   for v in fn(tn.op, n)]
            want = [(v.dim_degrees, v.replica_degree, v.start_part)
                    for v in ref_fn(rn.op, n)]
            assert got == want, (tn.op.name, fn.__name__)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("spec", SPECS)
def test_simulated_costs_equal_the_reference(spec, n):
    """Trivial, data-parallel and Megatron strategies on the GPT and the
    transformer, training and inference, within 1e-9 relative."""
    for name in ("gpt", "transformer"):
        ref, port = build_pair(name, spec, n)
        strategies = (
            ({}, {}),
            (ref_dp_strategy(ref.graph, n),
             data_parallel_strategy(port.graph, n)),
            (megatron(ref, RefView), megatron(port, MachineView)),
        )
        for inference in (False, True):
            rsim = RefSim(getattr(RefSpec, spec)(n), num_devices=n,
                          inference=inference)
            tsim = Simulator(getattr(MachineSpec, spec)(n), num_devices=n,
                             inference=inference)
            for rs, ts in strategies:
                got = tsim.simulate(port.graph, ts)
                want = rsim.simulate(ref.graph, rs)
                assert math.isfinite(got) and close(got, want), (
                    name, spec, n, inference, got, want)
                assert close(tsim.peak_memory(port.graph, ts),
                             rsim.peak_memory(ref.graph, rs))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", ("mlp", "gpt"))
def test_search_helper_dp_equal_and_native_equals_python(name, n,
                                                         monkeypatch):
    ref, port = build_pair(name, "tpu_v5e", n)
    rcost, rstrat = RefHelper(RefSim(RefSpec.tpu_v5e(n), num_devices=n),
                              n).graph_cost(ref.graph)
    helper = SearchHelper(Simulator(MachineSpec.tpu_v5e(n), num_devices=n),
                          n)
    cost, strat = helper.graph_cost(port.graph)
    assert close(cost, rcost)
    assert views_by_digest(port.graph, strat) == views_by_digest(
        ref.graph, rstrat)
    ctx = getattr(port.graph, "_ndp_ctx", None)
    assert ctx not in (None, "ineligible") and ctx[1] is not None, (
        "the native DP engine did not engage")
    assert helper.native_hits > 0
    from flexflow_tpu import native as ref_native
    from flexflow_tpu_torch import native

    # the Python paths everywhere, as FLEXFLOW_TPU_NO_NATIVE=1 leaves
    # them: equal to the native cost, and to the reference's Python path
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(ref_native, "get_lib", lambda: None)
    ref, port = build_pair(name, "tpu_v5e", n)
    py = SearchHelper(Simulator(MachineSpec.tpu_v5e(n), num_devices=n), n)
    pcost, pstrat = py.graph_cost(port.graph)
    rpcost, rpstrat = RefHelper(RefSim(RefSpec.tpu_v5e(n), num_devices=n),
                                n).graph_cost(ref.graph)
    assert py.native_hits == 0
    assert close(pcost, cost) and close(pcost, rpcost)
    assert views_by_digest(port.graph, pstrat) == views_by_digest(
        ref.graph, rpstrat)


@pytest.mark.parametrize("n", (1, 2, 4, 8))
def test_xfer_names_equal_the_reference(n):
    assert [x.name for x in generate_all_pcg_xfers(n)] == [
        x.name for x in ref_xfers(n)]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_optimize_strategy_equals_the_reference(name, spec, n):
    ref, port = build_pair(name, spec, n)
    assert stable_graph_digest(port.graph) == ref_digest(ref.graph)
    rgraph, rstrat = ref_driver.optimize_strategy(ref.graph, ref.config,
                                                  return_graph=True)
    graph, strat = driver.optimize_strategy(port.graph, port.config,
                                            return_graph=True)
    assert stable_graph_digest(graph) == ref_digest(rgraph)
    assert views_by_digest(graph, strat) == views_by_digest(rgraph, rstrat)
    for key in ("full_sims", "delta_sims", "match_full_scans",
                "dp_memo_hits"):
        assert driver.LAST_SEARCH_STATS[key] == \
            ref_driver.LAST_SEARCH_STATS[key], key
    if name == "big_weight":  # tests/test_search.py's assertion
        fcs = [v for g, v in strat.items()
               if graph.nodes[g].op.name in ("fc1", "fc2")]
        assert any(v.dim_degrees[1] > 1 or v.replica_degree > 1
                   for v in fcs), fcs


def test_stamped_segments_keep_their_own_ops():
    """Where the search stamps a solved layer onto its isomorphic
    siblings, each sibling keeps its own ops (and so its own op names,
    which key the weights): the reference's searched graph names layer
    2's ops on layers 0-2 (ROADMAP Queue C); the port's graph is the
    same up to names, with every name once."""
    build = lambda pkg, mods, cfg: mods.build_gpt(  # noqa: E731
        cfg, vocab=128, num_layers=4, hidden=64, num_heads=4, ff_dim=128,
        seq_len=256)
    common = dict(batch_size=8, num_devices=4, search_timeout_s=0)
    ref = build(ff, jmods, ff.FFConfig(machine_spec=RefSpec.tpu_v5e(4),
                                       cost_cache_file="", **common))
    port = build(tff, tmods, tff.FFConfig(machine_spec=MachineSpec.tpu_v5e(4),
                                          device="cpu", **common))
    rgraph, rstrat = ref_driver.optimize_strategy(ref.graph, ref.config,
                                                  return_graph=True)
    graph, strat = driver.optimize_strategy(port.graph, port.config,
                                            return_graph=True)
    assert driver.LAST_SEARCH_STATS["segments_stamped"] > 0
    assert graph.num_nodes > port.graph.num_nodes  # the rewrite won
    assert stable_graph_digest(graph) == ref_digest(rgraph)
    assert views_by_digest(graph, strat) == views_by_digest(rgraph, rstrat)
    names = [nd.op.name for nd in graph.nodes.values()]
    assert len(set(names)) == len(names)
    for guid, node in port.graph.nodes.items():
        assert graph.nodes[guid].op is node.op
    ref_names = [nd.op.name for nd in rgraph.nodes.values()]
    assert len(set(ref_names)) < len(ref_names)  # the reference's fault


@pytest.mark.parametrize("n", WORLDS)
def test_strategy_files_cross_import_and_pass_fflint(tmp_path, n):
    ref, port = build_pair("gpt", "tpu_v5e", n)
    # strategy-only mode: views on the frontend graph, whose op names
    # both packages share
    rstrat = ref_driver.optimize_strategy(ref.graph, ref.config)
    strat = driver.optimize_strategy(port.graph, port.config)
    assert by_name(port.graph, strat) == by_name(ref.graph, rstrat)
    from_ref, from_port = tmp_path / "ref_strategy.json", \
        tmp_path / "port_strategy.json"
    ref_io.export_strategy(str(from_ref), ref.graph, rstrat)
    strategy_io.export_strategy(str(from_port), port.graph, strat)
    into_port = strategy_io.import_strategy(str(from_ref), port.graph)
    into_ref = ref_io.import_strategy(str(from_port), ref.graph)
    assert by_name(port.graph, into_port) == by_name(port.graph, strat)
    assert by_name(ref.graph, into_ref) == by_name(ref.graph, rstrat)
    assert strategy_io.read_meta(str(from_port))["graph_digest"] == \
        ref_io.read_meta(str(from_ref))["graph_digest"]
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "fflint.py"),
         "strategy", str(from_ref), str(from_port)],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("spec", ("tpu_v5e", "tpu_v5p", "host_cpu",
                                  "h100_sxm"))
def test_machine_spec_round_trips_through_a_file(tmp_path, spec):
    m = getattr(MachineSpec, spec)(8)
    path = str(tmp_path / f"{spec}.json")
    m.to_file(path)
    assert MachineSpec.from_file(path) == m
    if spec != "h100_sxm":  # the reference reads the port's file
        assert RefSpec.from_file(path) == getattr(RefSpec, spec)(8)
    cfg = tff.FFConfig(device="cpu", num_devices=8, machine_model_file=path)
    assert cfg.machine_spec == m


def test_h100_spec_prices_nvswitch_and_the_default_config_uses_it():
    spec = MachineSpec.h100_sxm(4)
    assert (spec.platform, spec.peak_flops, spec.hbm_bandwidth,
            spec.hbm_capacity, spec.ici_bandwidth) == (
        "cuda", 9.89e14, 3.35e12, 80e9, 4.5e11)
    assert tff.FFConfig(device="cpu", num_devices=4).machine_spec == spec
    sim = Simulator(spec, num_devices=4)
    topo = sim.cost.network.topology
    assert topo.num_nodes == 5 and topo.torus_dims == ()  # 4 GPUs + switch
    # a GPU-to-GPU flow crosses the switch: two links, one link latency
    t = sim.cost.network.p2p_time(0, 3, 4.5e8)
    assert close(t, 4.5e8 / spec.ici_bandwidth + spec.ici_latency)


def test_mcmc_optimize_runs_and_stays_feasible():
    _, port = build_pair("mlp", "tpu_v5e", 8)
    s = driver.mcmc_optimize(port.graph, port.config, iterations=50, seed=1)
    sim = Simulator.for_config(port.config)
    assert sim.simulate(port.graph, s) < math.inf
