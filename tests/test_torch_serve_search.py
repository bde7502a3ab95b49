"""The serve objective's search against the JAX package's, under the
reference's own ``MachineSpec``s (``tpu_v5e``, ``host_cpu``): the
arrival model (``search/serving.py``), the serve-objective views and
costs, the KV lane's dtype, the disaggregation and fleet proposals, the
four serving lints on the reference's own bad inputs
(tests/test_serving.py:349, test_kv.py:409, test_prefill.py:431,
test_fleet.py:154), and ``__meta__`` files read both ways between the
packages (the import path re-lints every block).

Views, codes, partitions and routes match exactly; costs within 1e-9
relative."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

import flexflow_tpu as ff
from flexflow_tpu import analysis as jan
from flexflow_tpu.core.machine import MachineSpec as JaxSpec
from flexflow_tpu.core.machine import MachineView as JaxView
from flexflow_tpu.model import _adopt_kv_dtype as jax_adopt_kv_dtype
from flexflow_tpu.models import build_gpt_decode as jax_build
from flexflow_tpu.search import driver as jax_driver
from flexflow_tpu.search import serving as jax_serving
from flexflow_tpu.search.disaggregation import (
    propose_disaggregation as jax_propose_disaggregation,
)
from flexflow_tpu.search.fleet import propose_fleet as jax_propose_fleet
from flexflow_tpu.search.machine_model import CostModel as JaxCostModel
from flexflow_tpu.search.simulator import Simulator as JaxSimulator

import flexflow_tpu_torch as tff
from flexflow_tpu_torch import analysis as tan
from flexflow_tpu_torch.core.machine import MachineSpec, MachineView
from flexflow_tpu_torch.model import _adopt_kv_dtype
from flexflow_tpu_torch.models import build_gpt_decode
from flexflow_tpu_torch.search import driver, serving, strategy_io
from flexflow_tpu_torch.search.disaggregation import propose_disaggregation
from flexflow_tpu_torch.search.fleet import propose_fleet
from flexflow_tpu_torch.search.machine_model import CostModel
from flexflow_tpu_torch.search.simulator import Simulator

COST_TOL = 1e-9
# the reference's canonical decode config (models/decode.py
# GPT_DECODE_KW) and a tiny one for the proposals
DECODE_KW = dict(vocab=2048, num_layers=2, hidden=256, num_heads=8,
                 ff_dim=512, page_size=16, pages_per_seq=16)
TINY_KW = dict(vocab=128, num_layers=2, hidden=64, num_heads=4, ff_dim=64,
               page_size=8, pages_per_seq=4)
# test_fleet.py's mixed-SLO table and decode config
FLEET_SLO = ("interactive:2:64:0.99:1,standard:1:0:0.99:2,"
             "batch:0:0:0.9:5")
FLEET_KW = dict(vocab=256, num_layers=2, hidden=64, num_heads=4,
                ff_dim=128, page_size=8, pages_per_seq=8)


def _pair(kw, batch, n, spec, **cfg):
    """(port model, JAX model) of the decode graph, serve objective."""
    common = dict(batch_size=batch, num_devices=n, objective="serve",
                  comp_mode="inference", **cfg)
    pm = build_gpt_decode(tff.FFConfig(
        device="cpu", cost_cache_file=None,
        machine_spec=getattr(MachineSpec, spec)(n), **common), **kw)
    jm = jax_build(ff.FFConfig(
        cost_cache_file="", machine_spec=getattr(JaxSpec, spec)(n),
        **common), **kw)
    return pm, jm


def _by_name(graph, views):
    return {graph.nodes[g].op.name: (tuple(v.dim_degrees), v.replica_degree,
                                     v.start_part)
            for g, v in views.items()}


def views_by_digest(graph, views):
    """Views keyed by stable node digest: the names of ops a rewrite
    inserts count up per process."""
    digests = graph.stable_node_digests()
    out = {}
    for guid, v in views.items():
        out.setdefault(digests[guid], []).append(
            (tuple(v.dim_degrees), v.replica_degree, v.start_part))
    return {k: sorted(v) for k, v in out.items()}


def _close(a, b):
    assert a == pytest.approx(b, rel=COST_TOL, abs=0.0)


def _search_both(pm, jm):
    pg, pv = driver.optimize_strategy(pm.graph, pm.config, return_graph=True)
    jg, jv = jax_driver.optimize_strategy(jm.graph, jm.config,
                                          return_graph=True)
    return (pg, pv), (jg, jv)


# ---------------------------------------------------------------------------
# the arrival model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(max_seqs=16, page_size=16, pages_per_seq=16),
    dict(max_seqs=32, page_size=16, pages_per_seq=64, quantile=0.9,
         prompt_tokens_mean=200, decode_tokens_mean=40),
    dict(max_seqs=8, page_size=8, pages_per_seq=4, shared_prefix_pages=2,
         seed=3, samples=64),
])
def test_serving_spec_matches_the_reference(kw):
    mine, ref = serving.ServingSpec(**kw), jax_serving.ServingSpec(**kw)
    np.testing.assert_array_equal(mine.sample_lengths(),
                                  ref.sample_lengths())
    for b in (1, 2, 4, 8):
        assert mine.load_factor(b) == ref.load_factor(b)
    for slots in (1, 3, kw["max_seqs"]):
        assert (mine.with_occupancy(slots).load_factor(2)
                == ref.with_occupancy(slots).load_factor(2))
    assert mine.prefill_tokens_per_frame() == ref.prefill_tokens_per_frame()
    assert mine.shared_residency_factor() == ref.shared_residency_factor()
    assert mine.signature() == ref.signature()


# ---------------------------------------------------------------------------
# the serve-objective search and its KV lane
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv,sharing", [("off", 0), ("search", 0),
                                        ("search", 2), ("bf16", 0)])
def test_serve_search_views_costs_and_kv_lane_match(kv, sharing):
    pm, jm = _pair(DECODE_KW, 16, 8, "tpu_v5e", kv_precision=kv,
                   serve_shared_prefix_pages=sharing,
                   serve_p99_budget_ms=0.05, search_timeout_s=0)
    (pg, pv), (jg, jv) = _search_both(pm, jm)
    assert views_by_digest(pg, pv) == views_by_digest(jg, jv)
    assert driver.LAST_SERVING_META == jax_driver.LAST_SERVING_META
    assert driver.LAST_KV_META == jax_driver.LAST_KV_META
    assert (driver.LAST_KV_META is None) == (kv == "off" and not sharing)
    spec = serving.serving_spec_for(pg, pm.config)
    jspec = jax_serving.serving_spec_for(jg, jm.config)
    for q in (0.5, 0.99):
        _close(Simulator(pm.config.machine_spec, num_devices=8,
                         inference=True,
                         serving=spec.with_quantile(q)).simulate(pg, pv),
               JaxSimulator(jm.config.machine_spec, num_devices=8,
                            inference=True,
                            serving=jspec.with_quantile(q)
                            ).simulate(jg, jv))
    _close(serving.kv_residency_bytes(pg, pv, 8, serving=spec),
           jax_serving.kv_residency_bytes(jg, jv, 8, serving=jspec))


def test_serve_search_picks_head_split_decode_views():
    """The reference's serving-regime config (GPT_DECODE_SERVE_KW at 32
    slots): the serve objective's decode views differ from the train
    objective's, in both packages alike."""
    kw = dict(vocab=4096, num_layers=2, hidden=512, num_heads=8,
              ff_dim=1024, page_size=32, pages_per_seq=128)
    pm, jm = _pair(kw, 32, 8, "tpu_v5e", search_timeout_s=0)
    (pg, pv), (jg, jv) = _search_both(pm, jm)
    assert views_by_digest(pg, pv) == views_by_digest(jg, jv)
    decode = {pg.nodes[g].op.name: v for g, v in pv.items()
              if pg.nodes[g].op.op_type.name == "DECODE_ATTENTION"}
    assert decode and any(v.replica_degree > 1 for v in decode.values())


# ---------------------------------------------------------------------------
# the disaggregation and fleet proposals
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_proposals():
    """Both packages' searched tiny decode graph on tpu_v5e(4) and its
    disaggregation and fleet proposals."""
    pm, jm = _pair(TINY_KW, 8, 4, "tpu_v5e", kv_precision="search",
                   serve_disaggregation="search", serve_fleet="search",
                   serve_slo_classes="interactive:1:0,batch:0:0",
                   search_timeout_s=0)
    (pg, pv), (jg, jv) = _search_both(pm, jm)
    return dict(
        port=(pm, pg, pv, propose_disaggregation(pg, pv, pm.config),
              propose_fleet(pg, pv, pm.config)),
        jax=(jm, jg, jv, jax_propose_disaggregation(jg, jv, jm.config),
             jax_propose_fleet(jg, jv, jm.config)))


def test_disaggregation_proposal_matches(tiny_proposals):
    *_, prop, _ = tiny_proposals["port"]
    *_, ref, _ = tiny_proposals["jax"]
    assert prop.adopted == ref.adopted
    assert prop.to_meta() == ref.to_meta()
    for field in ("colocated_step_s", "disagg_step_s", "handoff_s",
                  "prefill_tokens_per_frame"):
        _close(getattr(prop, field), getattr(ref, field))
    assert (prop.prefill_devices, prop.decode_devices) == (
        ref.prefill_devices, ref.decode_devices)


def _fleet_pair():
    pm, jm = _pair(FLEET_KW, 8, 8, "host_cpu", serve_slo_classes=FLEET_SLO,
                   serve_fleet_max_replicas=3, search_budget=4,
                   search_timeout_s=0)
    (pg, pv), (jg, jv) = _search_both(pm, jm)
    return (pm, pg, pv, propose_fleet(
        pg, pv, pm.config, base_graph=pm.graph if pg is not pm.graph
        else None)), (jm, jg, jv, jax_propose_fleet(
            jg, jv, jm.config, base_graph=jm.graph if jg is not jm.graph
            else None))


@pytest.fixture(scope="module")
def fleets():
    return _fleet_pair()


def test_fleet_proposal_matches(fleets, tiny_proposals):
    for (pm, pg, pv, prop), (jm, jg, jv, ref) in (
            (fleets[0], fleets[1]),
            (tiny_proposals["port"][:3] + tiny_proposals["port"][4:],
             tiny_proposals["jax"][:3] + tiny_proposals["jax"][4:])):
        assert prop is not None and ref is not None
        assert prop.adopted == ref.adopted
        assert prop.to_meta() == ref.to_meta()
        assert prop.routing == ref.routing
        assert prop.routing_policy == ref.routing_policy
        _close(prop.fleet_cost_s, ref.fleet_cost_s)
        _close(prop.single_cost_s, ref.single_cost_s)
        for c, v in ref.per_class_p99_s.items():
            _close(prop.per_class_p99_s[c], v)
        for a, b in zip(prop.replicas, ref.replicas):
            assert (a.start, a.devices, a.prefill_devices,
                    a.decode_devices, a.occupancy_slots) == (
                b.start, b.devices, b.prefill_devices, b.decode_devices,
                b.occupancy_slots)
            _close(a.step_s, b.step_s)
            assert views_by_digest(a.graph, a.strategy) == views_by_digest(
                b.graph, b.strategy)
    assert fleets[0][3].adopted  # the heterogeneous host fleet


# ---------------------------------------------------------------------------
# the four serving lints on the reference's bad inputs
# ---------------------------------------------------------------------------
def _codes(findings):
    return sorted(f.code for f in findings)


def test_lint_serving_codes_match():
    pm, jm = _pair(DECODE_KW, 16, 8, "tpu_v5e")
    pv = {n.guid: MachineView.trivial(n.op.output_shapes[0].ndim)
          for n in pm.graph.topo_order()}
    jv = {n.guid: JaxView.trivial(n.op.output_shapes[0].ndim)
          for n in jm.graph.topo_order()}
    pspec = serving.serving_spec_for(pm.graph, pm.config)
    jspec = jax_serving.serving_spec_for(jm.graph, jm.config)
    pcm = CostModel(pm.config.machine_spec, num_devices=8, inference=True)
    jcm = JaxCostModel(jm.config.machine_spec, num_devices=8, inference=True)

    def both(fn):
        got = _codes(fn(tan.lint_serving, pm.graph, pv, pspec, pcm,
                        MachineView))
        want = _codes(fn(jan.lint_serving, jm.graph, jv, jspec, jcm,
                         JaxView))
        assert got == want
        return got

    assert both(lambda lint, g, v, s, cm, V: lint(g, v, s, cm)) == []
    assert "SHD160" in both(lambda lint, g, v, s, cm, V: lint(
        g, v, dataclasses.replace(s, page_size=s.page_size * 2,
                                  _factors={}), cm))
    assert both(lambda lint, g, v, s, cm, V: lint(g, v, None, cm)) == [
        "SHD160"]
    assert "SHD161" in both(lambda lint, g, v, s, cm, V: lint(
        g, v, s, type(cm)(dataclasses.replace(cm.machine, hbm_capacity=1e6),
                          num_devices=8, inference=True)))

    def head3(lint, g, v, s, cm, V):
        bad = dict(v)
        for n in g.topo_order():
            if n.op.op_type.name == "DECODE_ATTENTION":
                bad[n.guid] = V(dim_degrees=(1, 1, 1), replica_degree=3)
        return lint(g, bad, s, cm)

    assert "SHD162" in both(head3)
    assert "SHD163" in both(lambda lint, g, v, s, cm, V: lint(
        g, v, dataclasses.replace(s, p99_budget_ms=1e-6, _factors={}), cm,
        predicted_p99_s=1.0))


def test_lint_kv_codes_match():
    small = dict(vocab=64, num_layers=1, hidden=32, num_heads=2, ff_dim=32,
                 page_size=4, pages_per_seq=4)
    pm = build_gpt_decode(tff.FFConfig(batch_size=4, device="cpu"), **small)
    jm = jax_build(ff.FFConfig(batch_size=4, num_devices=1,
                               cost_cache_file=""), **small)
    pv = {n.guid: MachineView.trivial(n.op.output_shapes[0].ndim)
          for n in pm.graph.topo_order()}
    jv = {n.guid: JaxView.trivial(n.op.output_shapes[0].ndim)
          for n in jm.graph.topo_order()}
    spec = dict(max_seqs=4, page_size=4, pages_per_seq=4,
                shared_prefix_pages=2)
    pspec, jspec = serving.ServingSpec(**spec), jax_serving.ServingSpec(**spec)
    good = {"dtype": "int8", "searched": True, "scale_layout": "page_slot",
            "shared_prefix_pages": 2,
            "shared_residency_factor": (4 * 2 + 2) / (4 * 4)}
    metas = [good, {**good, "dtype": "fp4"},
             {**good, "scale_layout": "none"}, {**good, "dtype": "fp32"},
             {**good, "shared_prefix_pages": 4},
             {**good, "shared_residency_factor": 0.2},
             {**good, "shared_prefix_pages": 1}, "not-a-mapping"]
    seen = []
    for meta in metas:
        got = _codes(tan.lint_kv(pm.graph, pv, meta, serving=pspec))
        assert got == _codes(jan.lint_kv(jm.graph, jv, meta, serving=jspec))
        seen.append(got)
    assert seen[0] == [] and all(seen[1:])
    # post-adoption coherence: ops carrying another dtype than the meta
    _adopt_kv_dtype(pm.graph, "bf16")
    jax_adopt_kv_dtype(jm.graph, "bf16")
    assert "SHD169" in _codes(tan.lint_kv(pm.graph, pv, good, serving=pspec))
    assert _codes(tan.lint_kv(pm.graph, pv, good, serving=pspec)) == _codes(
        jan.lint_kv(jm.graph, jv, good, serving=jspec))


def test_lint_disaggregation_codes_match(tiny_proposals):
    pm, pg, pv, prop, _ = tiny_proposals["port"]
    jm, jg, jv, _, _ = tiny_proposals["jax"]
    meta = prop.to_meta()
    bads = [meta, dict(meta, prefill_devices=4),
            dict(meta, decode_devices=0), dict(meta, chunk=0),
            dict(meta, page_size=meta["page_size"] * 2),
            dict(meta, slo_classes=[{"name": "a", "quantile": 2.0}]),
            dict(meta, slo_classes=[{"name": "a"}, {"name": "a"}])]
    seen = []
    for bad in bads:
        got = _codes(tan.lint_disaggregation(pm.graph, bad, pm.config))
        assert got == _codes(jan.lint_disaggregation(jm.graph, bad,
                                                     jm.config))
        seen.append(got)
    assert not [c for c in seen[0] if c.startswith("SHD16")]
    assert "SHD164" in seen[1] and "SHD164" in seen[2]
    assert "SHD164" in seen[3] and "SHD165" in seen[4]
    assert "SHD165" in seen[5] and "SHD165" in seen[6]


def test_lint_fleet_codes_match(fleets):
    (pm, _, _, prop), (jm, _, _, _) = fleets
    meta = prop.to_meta()

    def corrupt(**kw):
        c = json.loads(json.dumps(meta))
        c.update(kw)
        return c

    bads = [meta, corrupt(replicas=[])]
    bad = corrupt()
    bad["replicas"][1]["start"] = 0
    bads.append(bad)
    bad = corrupt()
    bad["replicas"][0]["devices"] = 16
    bads.append(bad)
    bad = corrupt()
    bad["replicas"][0]["prefill_devices"] = bad["replicas"][0]["devices"]
    bads.append(bad)
    bads.append(corrupt(page_size=meta["page_size"] * 2))
    bad = corrupt()
    bad["routing"]["interactive"] = bad["routing"]["interactive"] + [0.0]
    bads.append(bad)
    bad = corrupt()
    bad["routing"]["standard"] = [f * 0.5 for f in bad["routing"]["standard"]]
    bads.append(bad)
    bad = corrupt()
    bad["routing"]["bulk"] = bad["routing"]["batch"]
    bads.append(bad)
    bad = corrupt()
    del bad["routing"]["batch"]
    bads.append(bad)
    bads.append(corrupt(slo_classes=meta["slo_classes"]
                        + [meta["slo_classes"][0]]))
    seen = []
    for bad in bads:
        got = _codes(tan.lint_fleet(pm.graph, bad, pm.config))
        assert got == _codes(jan.lint_fleet(jm.graph, bad, jm.config))
        seen.append(got)
    assert not tan.errors_only(tan.lint_fleet(pm.graph, meta, pm.config))
    assert all("SHD166" in c for c in seen[1:5])
    assert all("SHD167" in c for c in seen[5:])


# ---------------------------------------------------------------------------
# __meta__ files both ways
# ---------------------------------------------------------------------------
def _serve_cfg_kw(n=4):
    return dict(batch_size=8, num_devices=n, objective="serve",
                comp_mode="inference", kv_precision="search",
                serve_disaggregation="search", serve_fleet="search",
                serve_slo_classes="interactive:1:0,batch:0:0",
                search_timeout_s=0)


def test_port_export_imports_in_the_reference(tmp_path):
    """The port's searched export (``FFModel._search``: views plus the
    serving, kv, disaggregation and fleet blocks) imports in the JAX
    package, whose compile re-lints every block and adopts the pool
    dtype; a corrupt kv block is refused by both."""
    pm = build_gpt_decode(tff.FFConfig(
        device="cpu", cost_cache_file=None,
        machine_spec=MachineSpec.tpu_v5e(4), **_serve_cfg_kw()), **TINY_KW)
    graph, export, _, _ = pm._search("inference")
    meta = export[strategy_io.META_KEY]
    assert {"serving", "kv", "disaggregation", "fleet"} <= set(meta)
    assert pm.fleet.to_meta() == meta["fleet"]
    assert pm.disaggregation.to_meta() == meta["disaggregation"]
    path = tmp_path / "port.json"
    path.write_text(json.dumps(export))
    jm = jax_build(ff.FFConfig(
        cost_cache_file="", machine_spec=JaxSpec.tpu_v5e(4),
        import_strategy_file=str(path), **_serve_cfg_kw()), **TINY_KW)
    jm.compile(loss_type="sparse_categorical_crossentropy", metrics=[],
               comp_mode="inference")
    assert {n.op.attrs.get("kv_dtype", "fp32") for n in jm.graph.topo_order()
            if n.op.op_type.name == "DECODE_ATTENTION"} == {
        meta["kv"]["dtype"]}
    bad = dict(export, __meta__=dict(meta, kv=dict(meta["kv"],
                                                   scale_layout="none")))
    path.write_text(json.dumps(bad))
    jm = jax_build(ff.FFConfig(
        cost_cache_file="", machine_spec=JaxSpec.tpu_v5e(4),
        import_strategy_file=str(path), **_serve_cfg_kw()), **TINY_KW)
    with pytest.raises(jan.AnalysisError):
        jm.compile(loss_type="sparse_categorical_crossentropy", metrics=[],
                   comp_mode="inference")
    pm = build_gpt_decode(tff.FFConfig(
        device="cpu", cost_cache_file=None,
        machine_spec=MachineSpec.tpu_v5e(4), import_strategy_file=str(path),
        **_serve_cfg_kw()), **TINY_KW)
    with pytest.raises(tan.AnalysisError):
        pm._choose_strategy("inference", None)


def test_reference_export_imports_in_the_port(tmp_path):
    """The JAX package's serve-objective export (its compile with
    ``export_strategy_file``) imports in the port: the views, the four
    blocks re-linted and kept (``serve_meta``), the kv dtype to adopt;
    a fleet block whose routing misses a class is refused."""
    path = tmp_path / "ref.json"
    jm = jax_build(ff.FFConfig(
        cost_cache_file="", machine_spec=JaxSpec.tpu_v5e(4),
        export_strategy_file=str(path), **_serve_cfg_kw()), **TINY_KW)
    jm.compile(loss_type="sparse_categorical_crossentropy", metrics=[],
               comp_mode="inference")
    meta = json.loads(path.read_text())["__meta__"]
    assert {"serving", "kv", "fleet"} <= set(meta)
    pm = build_gpt_decode(tff.FFConfig(
        device="cpu", cost_cache_file=None,
        machine_spec=MachineSpec.tpu_v5e(4), import_strategy_file=str(path),
        **_serve_cfg_kw()), **TINY_KW)
    views, _ = pm._choose_strategy("inference", None)
    assert pm.serve_meta == {k: meta[k] for k in
                             ("serving", "kv", "disaggregation", "fleet")
                             if k in meta}
    assert pm._kv_adopt == meta["kv"]["dtype"]
    assert _by_name(pm.graph, {g: v for g, v in views.items()
                               if g != "__meta__"}) == {
        jm.graph.nodes[g].op.name: (tuple(v.dim_degrees), v.replica_degree,
                                    v.start_part)
        for g, v in jm.strategy.items()}
    data = json.loads(path.read_text())
    del data["__meta__"]["fleet"]["routing"]["batch"]
    path.write_text(json.dumps(data))
    pm = build_gpt_decode(tff.FFConfig(
        device="cpu", cost_cache_file=None,
        machine_spec=MachineSpec.tpu_v5e(4), import_strategy_file=str(path),
        **_serve_cfg_kw()), **TINY_KW)
    with pytest.raises(tan.AnalysisError) as e:
        pm._choose_strategy("inference", None)
    assert "SHD167" in {f.code for f in e.value.findings}
