"""The search's pipeline and placement proposals and their lints, in one
process with no world, against the JAX package's on the same graphs and
machine specs (the reference tests' and ``__graft_entry__.py``'s):

* ``propose_pipeline`` (stages, microbatches), ``propose_pipeline_general``
  (stages, microbatches, the stage cut by op name, ``executable``, cost
  within 1e-9) and ``propose_placement`` (every view, ``start_part``
  included) equal the reference's, each on the flat search's graph and
  baseline (equal to 1e-9);
* ``lint_pipeline_stages``, ``lint_placement`` and ``placement_meta``
  give the reference's findings (code, message, node, op) on legal and
  illegal inputs;
* a strategy file whose ``__meta__.pipeline`` is malformed or illegal
  is refused at compile with the reference's findings."""

from __future__ import annotations

import dataclasses
import json
import math

import pytest

import flexflow_tpu_torch as tff

# (kind, devices, batch): the reference tests' graphs and specs
CASES = {
    "pp_memory_bound": (8, 16),      # tests/test_pipeline.py:165
    "pp_single_host": (8, 16),       # :199
    "general_prime": (8, 16),        # :217
    "deep_prime": (8, 16),           # tests/test_staged_pipeline.py:75
    "graft_pp": (4, 16),             # __graft_entry__.py:258-302
    "two_tables": (8, 64),           # tests/test_placement.py:170
}


def _pkg(name):
    if name == "ref":
        import flexflow_tpu as ff

        return ff
    return tff


def _mod(pkg, path):
    from importlib import import_module

    return import_module(f"{pkg.__name__}.{path}")


def _spec(pkg, kind, n):
    MS = _mod(pkg, "core.machine").MachineSpec
    if kind == "pp_single_host":
        return MS.host_cpu(n)
    if kind == "two_tables":
        return dataclasses.replace(MS.tpu_v5e(n), devices_per_host=4,
                                   ici_torus=(), hbm_capacity=20e6)
    if kind == "graft_pp":
        return MS(num_devices=n, devices_per_host=n // 2, platform="cpu",
                  hbm_capacity=48e6)
    cap = 48e6 if kind == "pp_memory_bound" else 40e6
    return MS(num_devices=n, devices_per_host=4, platform="cpu",
              hbm_capacity=cap)


def _build(pkg, kind):
    n, batch = CASES[kind]
    kw = {"device": "cpu"} if pkg is tff else {"cost_cache_file": ""}
    cfg = pkg.FFConfig(batch_size=batch, num_devices=n,
                       compute_dtype="float32", search_timeout_s=0,
                       machine_spec=_spec(pkg, kind, n), **kw)
    m = pkg.FFModel(cfg)
    if kind == "two_tables":
        towers = []
        for i in range(2):
            ids = m.create_tensor([64, 2], dtype="int32", name=f"ids{i}")
            towers.append(m.embedding(ids, 23003, 61, aggr="sum",
                                      name=f"emb{i}"))
        c = m.concat(towers, axis=1, name="interact")
        h = m.dense(c, 64, activation="relu", name="top0")
        m.dense(h, 8, name="out")
        return m, cfg
    w0 = 128 if kind == "pp_single_host" else 1021
    widths = {"general_prime": (1019, 1013, 1009, 1021),
              "deep_prime": (1019, 1013, 1009, 997, 991, 983, 977, 1021),
              }.get(kind, (w0,) * 4)
    t = m.create_tensor([16, w0])
    for i, w in enumerate(widths):
        t = m.dense(t, w, activation="relu", name=f"layer{i}_fc")
    m.dense(t, w0, name="head")
    return m, cfg


def _proposals(pkg, kind):
    m, cfg = _build(pkg, kind)
    drv = _mod(pkg, "search.driver")
    ps = _mod(pkg, "search.pipeline_search")
    pls = _mod(pkg, "search.placement_search")
    Sim = _mod(pkg, "search.simulator").Simulator
    g, strat = drv.optimize_strategy(m.graph, cfg, return_graph=True)
    cal = drv.coherent_calibration(cfg)
    sim = Sim.for_config(cfg, calibration=cal)
    base = sim.simulate(g, strat)
    pp = ps.propose_pipeline(g, cfg, sim, base)
    gen = (ps.propose_pipeline_general(g, cfg, sim, base)
           if not math.isfinite(base) else None)
    placed = pls.propose_placement(g, cfg, base, calibration=cal)
    names = {guid: nd.op.name for guid, nd in g.nodes.items()}
    return {
        "baseline": base,
        "pipeline": None if pp is None else (pp.num_stages,
                                             pp.num_microbatches),
        "general": None if gen is None else (
            gen.num_stages, gen.num_microbatches,
            [[names[x] for x in st] for st in gen.stage_guids],
            gen.executable),
        "general_cost": None if gen is None else gen.cost,
        "placement": None if placed is None else sorted(
            (names[k], tuple(v.dim_degrees), v.replica_degree, v.start_part)
            for k, v in placed.items()),
    }


def _close(a, b):
    if a is None or b is None:
        return a is b
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= 1e-9 * max(abs(a), abs(b))


@pytest.fixture(scope="module")
def proposals():
    return {kind: (_proposals(_pkg("ref"), kind), _proposals(tff, kind))
            for kind in CASES}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_proposals_equal_the_reference(proposals, kind):
    ref, got = proposals[kind]
    assert _close(got["baseline"], ref["baseline"])
    assert got["pipeline"] == ref["pipeline"]
    assert got["general"] == ref["general"]
    assert _close(got["general_cost"], ref["general_cost"])
    assert got["placement"] == ref["placement"]


def test_the_cases_cover_each_proposal(proposals):
    """Each proposal fires on some case and stays off on others."""
    got = {k: v[1] for k, v in proposals.items()}
    assert got["pp_memory_bound"]["pipeline"] is not None
    assert got["graft_pp"]["pipeline"] is not None
    assert got["pp_single_host"]["pipeline"] is None
    assert got["pp_single_host"]["placement"] is None
    assert got["deep_prime"]["general"] is not None
    assert got["deep_prime"]["placement"] is None
    assert got["two_tables"]["placement"] is not None


def _findings(fs):
    return [(f.code, f.message, f.node, f.op) for f in fs]


def _stage_inputs(pkg, m, cfg):
    """Legal and illegal stage partitions of the stacked graph:
    (name, stage_guids, S, M)."""
    ps = _mod(pkg, "search.pipeline_search")
    good = ps.stacked_stage_guids(m.graph, 2)
    topo = [n.guid for n in m.graph.topo_order()]
    return [
        ("good", good, 2, 4),
        ("structure_only", None, 2, 4),
        ("one_stage", [topo], 1, 4),
        ("stages_dont_split", good, 3, 4),
        ("too_few_microbatches", good, 2, 1),
        ("batch_does_not_divide", good, 2, 5),
        ("count_mismatch", good + [[]], 2, 4),
        ("duplicate", [good[0] + [good[1][0]], good[1]], 2, 4),
        ("uncovered", [good[0], good[1][1:]], 2, 4),
        ("unknown_guid", [good[0] + [10 ** 6], good[1]], 2, 4),
        ("backward_edge", [good[1], good[0]], 2, 4),
    ]


def _lint_pipeline(pkg):
    m, cfg = _build(pkg, "pp_memory_bound")
    lint = _mod(pkg, "analysis").lint_pipeline_stages
    return {name: _findings(lint(m.graph, sg, S, M, cfg))
            for name, sg, S, M in _stage_inputs(pkg, m, cfg)}


def test_lint_pipeline_stages_equals_the_reference():
    ref, got = _lint_pipeline(_pkg("ref")), _lint_pipeline(tff)
    assert got == ref
    assert got["good"] == [] and got["structure_only"] == []
    codes = {k: {c for c, *_ in v} for k, v in got.items()}
    assert codes["duplicate"] == {"SHD151"}
    assert codes["backward_edge"] == {"SHD152"}
    assert "SHD150" in codes["one_stage"]


def _placements(pkg):
    """Placed strategies of the embedding + MLP model: (name, views)."""
    MV = _mod(pkg, "core.machine").MachineView
    kw = {"device": "cpu"} if pkg is tff else {}
    cfg = pkg.FFConfig(batch_size=16, num_devices=8, compute_dtype="float32",
                       **kw)
    m = pkg.FFModel(cfg)
    ids = m.create_tensor([16, 4], dtype="int32", name="ids")
    e = m.embedding(ids, 64, 8, name="emb")
    h = m.flat(e, name="flatten")
    h = m.dense(h, 32, activation="relu", name="mlp1")
    m.dense(h, 4, name="head")

    def strat(starts, deg=4):
        out = {}
        for node in m.graph.topo_order():
            nd = node.op.output_shapes[0].ndim
            out[node.guid] = MV(dim_degrees=(deg,) + (1,) * (nd - 1),
                                start_part=starts.get(node.op.name, 0))
        return out

    cases = [
        ("good", strat({"mlp1": 4, "head": 4})),
        ("overlap", strat({"mlp1": 2, "head": 2})),
        ("overflow", strat({"mlp1": 6, "head": 6})),
        ("three_blocks", strat({"mlp1": 4, "head": 6}, 2)),
        ("first_not_zero", strat({"ids": 2, "emb": 2, "flatten": 2,
                                  "mlp1": 4, "head": 4}, 2)),
        ("back_edge", strat({"emb": 4, "flatten": 4, "mlp1": 4})),
        ("sink_in_a", strat({"emb": 4, "flatten": 4})),
        ("one_block", strat({})),
    ]
    return m, cfg, cases


def _lint_placements(pkg):
    m, cfg, cases = _placements(pkg)
    an = _mod(pkg, "analysis")
    return {name: (_findings(an.lint_placement(m.graph, s, cfg)),
                   an.placement_meta(m.graph, s, cfg))
            for name, s in cases}


def test_lint_placement_and_meta_equal_the_reference():
    ref, got = _lint_placements(_pkg("ref")), _lint_placements(tff)
    assert got == ref
    assert got["good"] == ([], {"num_devices": 8,
                                "blocks": [[0, 4], [4, 4]]})
    codes = {k: {c for c, *_ in v[0]} for k, v in got.items()}
    assert codes["overlap"] == {"SHD154"}
    assert "SHD155" in codes["back_edge"] and "SHD155" in codes["sink_in_a"]
    assert codes["three_blocks"] == {"SHD153"}


BAD_META = {
    "not_an_object": [1, 2],
    "non_integer": {"num_stages": "2", "num_microbatches": 4},
    "stages_not_names": {"num_stages": 2, "num_microbatches": 4,
                         "stages": [[1, 2], [3]]},
    "unknown_op": {"num_stages": 2, "num_microbatches": 4,
                   "stages": [["nope"], ["head"]]},
    "too_few_microbatches": {"num_stages": 2, "num_microbatches": 1},
}


def _import_refusal(pkg, tmp_path, name):
    """The findings a compile raises importing a strategy file whose
    ``__meta__.pipeline`` is ``BAD_META[name]``."""
    m, cfg = _build(pkg, "pp_single_host")
    an = _mod(pkg, "analysis")
    sio = _mod(pkg, "search.strategy_io")
    lowering = _mod(pkg, "compiler.lowering")
    views = lowering.data_parallel_strategy(m.graph, cfg.num_devices)
    path = tmp_path / f"{pkg.__name__}_{name}.json"
    sio.export_strategy(str(path), m.graph, views)
    data = json.loads(path.read_text())
    data["__meta__"]["pipeline"] = BAD_META[name]
    path.write_text(json.dumps(data))
    m.config.import_strategy_file = str(path)
    with pytest.raises(an.AnalysisError) as e:
        m.compile(loss_type="mean_squared_error", metrics=[])
    return [(f.code, f.message) for f in e.value.findings]


@pytest.mark.parametrize("name", sorted(BAD_META))
def test_bad_pipeline_meta_is_refused_as_the_reference(tmp_path, name):
    got = _import_refusal(tff, tmp_path, name)
    assert got and got == _import_refusal(_pkg("ref"), tmp_path, name)


def test_default_pick_for_gpt2_small_on_h100_sxm4():
    """``compile(strategy=None)``'s search with FFConfig's defaults (both
    proposal flags on, ``MachineSpec.h100_sxm(4)``, no calibration; no
    deadline, so the pick is a function of the graph) on ``build_gpt``
    at GPT-2-small widths, seq 1024, batch 8: the pick ``chip_smoke.py``
    phase 10 lowers on the card.  On one host the gradient sync rides
    NVLink and neither proposal beats the flat winner: data parallelism
    over 4 ranks with the vocab head split 4 ways."""
    from collections import Counter

    from flexflow_tpu_torch.models import build_gpt

    cfg = tff.FFConfig(batch_size=8, compute_dtype="bfloat16", num_devices=4,
                       device="cpu", search_timeout_s=0)
    assert cfg.enable_pipeline_search and cfg.enable_placement_search
    assert cfg.machine_spec.name == _mod(tff, "core.machine").MachineSpec \
        .h100_sxm(4).name
    m = build_gpt(cfg, vocab=32000, num_layers=12, hidden=768, num_heads=12,
                  ff_dim=3072, seq_len=1024)
    graph, export, _, proposal = m._search("training")
    meta = export.pop("__meta__")
    assert "pipeline" not in meta and "placement" not in meta
    assert proposal is None
    views = Counter((tuple(v["dims"]), v["replica"], v["start"])
                    for v in export.values())
    assert views == Counter({((4, 1, 1), 1, 0): 87, ((1, 1, 1), 1, 0): 3,
                             ((4, 1), 1, 0): 1, ((1, 1), 1, 0): 1,
                             ((1, 1, 4), 1, 0): 1})
    head = export["lm_head"]
    assert (head["dims"], head["replica"]) == ([1, 1, 4], 1)
