"""The joint strategy x comm-plan co-search in the port
(``search/comm_plan.py``, ``FFConfig(co_search=True)``) against the JAX
package's, then ``compile(strategy=None)`` with it over a gloo world of
4 CPU ranks.

Search side (one process, the reference's ``tpu_v5e`` spec; test
tests/test_co_search.py's MLP and a two-layer transformer): the picks
of ``optimize_strategy`` (views per stable node digest, the schedule,
the ZeRO groups, the search's sync stats), ``choose_zero_groups`` and
``zero_update_factor`` under data parallelism and under a tensor
split, ``JointPricer`` prices (1e-9 relative) with its memo serving a
repeated signature, ``signature_digest`` and the comm-plan row's round
trip, and ``lint_zero_map``'s codes equal the reference's.

Over ranks: ``compile(strategy=None)`` with ``co_search=True`` searches
once on rank 0 and every rank lowers one digest, one set of views and
one comm plan (the reference's schedule and ZeRO groups); 3 ``fit``
steps from the reference's initial weights give its losses within 1e-5;
the exported strategy file's ``__meta__`` (``sync_schedule``,
``zero_groups``) imports into the port and into the JAX package, each
adopting the same plan; a file carrying the port's
``__meta__.sync_precision`` map (``sync_precision="int8"``) imports into
the port with that map, and into the JAX package, which ignores it.

The rank function imports no JAX: the spawned ranks import this module
to find it."""

from __future__ import annotations

import math

import numpy as np
import pytest

import flexflow_tpu_torch as tff
from flexflow_tpu_torch.runtime.distributed import spawn

from test_torch_worlds import shared_world

N, BATCH, STEPS, LR = 4, 64, 3, 0.05
SEARCH = dict(search_timeout_s=0, enable_pipeline_search=False,
              enable_placement_search=False, search_budget=6)
CCE = dict(loss_type="sparse_categorical_crossentropy", metrics=[])


def mlp(pkg, cfg):
    """tests/test_co_search.py's ``_mlp_graph`` model."""
    m = pkg.FFModel(cfg)
    x = m.create_tensor([cfg.batch_size, 128], name="cs_x")
    t = m.dense(x, 512, activation="relu", name="cs_fc1")
    t = m.dense(t, 512, activation="relu", name="cs_fc2")
    m.dense(t, 16, name="cs_head")
    return m


def transformer(pkg, mods, cfg):
    return mods.build_transformer(cfg, num_layers=2, hidden=256,
                                  num_heads=4, ff_dim=512, seq_len=16)


def views_by_digest(graph, strategy):
    digests = graph.stable_node_digests()
    out = {}
    for guid, v in strategy.items():
        out.setdefault(digests[guid], []).append(
            (tuple(v.dim_degrees), v.replica_degree))
    return {k: sorted(v) for k, v in out.items()}


def close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        if math.isinf(a) or math.isinf(b):
            return a == b
        return abs(a - b) <= 1e-9 * max(abs(a), abs(b), 1e-300)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
    return a == b


def _pair(name, n, **kw):
    import flexflow_tpu as ff
    import flexflow_tpu.models as jmods
    from flexflow_tpu.core.machine import MachineSpec as RefSpec
    import flexflow_tpu_torch.models as tmods
    from flexflow_tpu_torch.core.machine import MachineSpec

    common = dict(batch_size=BATCH if name == "mlp" else 8, num_devices=n,
                  **kw)
    rcfg = ff.FFConfig(machine_spec=RefSpec.tpu_v5e(n), cost_cache_file="",
                       **common)
    cfg = tff.FFConfig(machine_spec=MachineSpec.tpu_v5e(n), device="cpu",
                       **common)
    if name == "mlp":
        return mlp(ff, rcfg), mlp(tff, cfg)
    return transformer(ff, jmods, rcfg), transformer(tff, tmods, cfg)


@pytest.mark.parametrize("name", ("mlp", "transformer"))
@pytest.mark.parametrize("prec", ("fp32", "search"))
def test_co_search_picks_equal_the_reference(name, prec):
    from flexflow_tpu.search import driver as ref_driver
    from flexflow_tpu.search.cost_cache import stable_graph_digest as rdig
    from flexflow_tpu_torch.search import driver
    from flexflow_tpu_torch.search.cost_cache import stable_graph_digest

    ref, port = _pair(name, 8, sync_precision=prec, co_search=True,
                      **SEARCH)
    assert port.config.sync_schedule == "search"  # co_search turns it on
    rg, rs = ref_driver.optimize_strategy(ref.graph, ref.config,
                                          return_graph=True)
    g, s = driver.optimize_strategy(port.graph, port.config,
                                    return_graph=True)
    assert stable_graph_digest(g) == rdig(rg)
    assert views_by_digest(g, s) == views_by_digest(rg, rs)
    assert driver.LAST_ZERO_GROUPS == ref_driver.LAST_ZERO_GROUPS
    assert (driver.LAST_SYNC_SCHEDULE is None) == (
        ref_driver.LAST_SYNC_SCHEDULE is None)
    if driver.LAST_SYNC_SCHEDULE is not None:
        assert close(driver.LAST_SYNC_SCHEDULE.to_jsonable(),
                     ref_driver.LAST_SYNC_SCHEDULE.to_jsonable())
    assert close(driver.LAST_SEARCH_STATS["sync_schedule"],
                 ref_driver.LAST_SEARCH_STATS["sync_schedule"])
    if name == "mlp":
        assert driver.LAST_ZERO_GROUPS  # dp replicates the dense layers


def _tensor_split(graph, view_cls, n):
    """Data parallelism with cs_fc1 split on its features n ways."""
    from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy

    s = data_parallel_strategy(graph, n)
    for node in graph.topo_order():
        if node.op.name == "cs_fc1":
            s[node.guid] = view_cls((1, n))
    return s


def test_zero_groups_and_joint_prices_equal_the_reference():
    from flexflow_tpu.compiler.lowering import data_parallel_strategy as rdp
    from flexflow_tpu.core.machine import MachineView as RefView
    from flexflow_tpu.search import comm_plan as rcp
    from flexflow_tpu.search.simulator import Simulator as RefSim
    from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy
    from flexflow_tpu_torch.core.machine import MachineView
    from flexflow_tpu_torch.search import comm_plan as pcp
    from flexflow_tpu_torch.search.simulator import Simulator

    ref, port = _pair("mlp", 8, sync_precision="search", co_search=True)
    for split in (False, True):
        if split:
            rs = _tensor_split(ref.graph, RefView, 8)
            rs = {g: RefView(tuple(v.dim_degrees), v.replica_degree)
                  for g, v in rs.items()}
            s = _tensor_split(port.graph, MachineView, 8)
        else:
            rs, s = rdp(ref.graph, 8), data_parallel_strategy(port.graph, 8)
        rsim = RefSim(ref.config.machine_spec, num_devices=8,
                      sync_precision="search")
        sim = Simulator(port.config.machine_spec, num_devices=8,
                        sync_precision="search")
        got = pcp.choose_zero_groups(port.graph, s, sim.cost)
        want = rcp.choose_zero_groups(ref.graph, rs, rsim.cost)
        assert got[0] == want[0] and close(got[1], want[1])
        for rnode, node in zip(ref.graph.topo_order(),
                               port.graph.topo_order()):
            assert close(pcp.zero_update_factor(sim.cost, node.op,
                                                s[node.guid]),
                         rcp.zero_update_factor(rsim.cost, rnode.op,
                                                rs[rnode.guid]))
        sig = pcp.synced_signature(port.graph, s)
        assert pcp.signature_digest(sig, port.config) == \
            rcp.signature_digest(rcp.synced_signature(ref.graph, rs),
                                 ref.config)
        jp, rjp = pcp.JointPricer(port.config), rcp.JointPricer(ref.config)
        c = jp.price(sim, port.graph, s)
        assert close(c, rjp.price(rsim, ref.graph, rs))
        assert jp.price(sim, port.graph, dict(s)) == c
        assert (jp.searches, jp.serves) == (1, 1)
        entry = jp.plan_for(port.graph, s, sim)
        rentry = rjp.plan_for(ref.graph, rs, rsim)
        assert close(entry.to_jsonable(), rentry.to_jsonable())
        back = pcp.CommPlanEntry.from_jsonable(entry.to_jsonable())
        assert back.to_jsonable() == entry.to_jsonable()


def test_lint_zero_map_codes_equal_the_reference():
    from flexflow_tpu.analysis import lint_zero_map as ref_lint
    from flexflow_tpu.compiler.lowering import data_parallel_strategy as rdp
    from flexflow_tpu.search.machine_model import CostModel as RefCost
    from flexflow_tpu_torch.analysis import lint_zero_map
    from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy
    from flexflow_tpu_torch.core.machine import MachineView
    from flexflow_tpu_torch.search.machine_model import CostModel

    ref, port = _pair("mlp", 8)
    rs, s = rdp(ref.graph, 8), data_parallel_strategy(port.graph, 8)
    rcm = RefCost(ref.config.machine_spec, num_devices=8)
    cm = CostModel(port.config.machine_spec, num_devices=8)
    relu = next(n.op.name for n in port.graph.topo_order()
                if not n.op._weight_specs)
    cases = [["cs_fc1", "cs_fc2"], [], ["nope"], [relu],
             ["cs_fc1", "cs_fc1"]]
    for zmap in cases:
        got = [f.code for f in lint_zero_map(port.graph, s, zmap, cm)]
        want = [f.code for f in ref_lint(ref.graph, rs, zmap, rcm)]
        assert got == want, zmap
    tp = _tensor_split(port.graph, MachineView, 8)
    assert [f.code for f in lint_zero_map(port.graph, tp, ["cs_fc1"],
                                          cm)] == ["SHD140"]


# ---- compile(strategy=None) with co_search over ranks --------------------
def _config(pkg, spec_cls, **kw):
    return pkg.FFConfig(batch_size=BATCH, num_devices=N,
                        compute_dtype="float32", co_search=True,
                        machine_spec=spec_cls.tpu_v5e(N), **SEARCH, **kw)


def _data():
    rng = np.random.default_rng(5)
    return (rng.normal(size=(STEPS * BATCH, 128)).astype(np.float32),
            rng.integers(0, 16, STEPS * BATCH).astype(np.int32))


def _rank(rank, start, x, y, path, path8):
    import torch.distributed as dist

    from flexflow_tpu_torch.core.machine import MachineSpec
    from flexflow_tpu_torch.interop import params_from_numpy
    from flexflow_tpu_torch.search.cost_cache import stable_graph_digest

    m = mlp(tff, _config(tff, MachineSpec, device="cpu",
                         export_strategy_file=path))
    m.compile(optimizer=tff.SGDOptimizer(lr=LR), **CCE)
    out = {"digest": stable_graph_digest(m.graph),
           "views": views_by_digest(m.graph, m.strategy),
           "meta": m.sync_meta(),
           "lowered": (None if m.compiled.sync_schedule is None
                       else m.compiled.sync_schedule.to_jsonable(),
                       m.compiled.zero_groups)}
    m.params = params_from_numpy(start, "cpu", m.compiled)
    m.fit(x, y, shuffle=False, verbose=False)
    out["losses"] = list(m.step_losses)
    # the exported file, imported back
    i = mlp(tff, _config(tff, MachineSpec, device="cpu",
                         import_strategy_file=path))
    i.compile(optimizer=tff.SGDOptimizer(lr=LR), **CCE)
    out["imported_meta"] = i.sync_meta()
    # a sync_precision map through a strategy file
    c = mlp(tff, tff.FFConfig(batch_size=BATCH, num_devices=N, device="cpu",
                              only_data_parallel=True, sync_precision="int8",
                              machine_spec=MachineSpec.tpu_v5e(N),
                              export_strategy_file=path8))
    c.compile(optimizer=tff.SGDOptimizer(lr=LR), **CCE)
    dist.barrier()  # rank 0 has written the export
    j = mlp(tff, tff.FFConfig(batch_size=BATCH, num_devices=N, device="cpu",
                              machine_spec=MachineSpec.tpu_v5e(N),
                              import_strategy_file=path8))
    j.compile(optimizer=tff.SGDOptimizer(lr=LR), **CCE)
    out["int8_meta"] = (c.sync_precision_map, j.sync_precision_map,
                        j.compiled.sync_precision)
    return out


def _reference(x, y):
    import flexflow_tpu as ff
    from flexflow_tpu.core.machine import MachineSpec as RefSpec
    from flexflow_tpu.search.cost_cache import stable_graph_digest

    m = mlp(ff, _config(ff, RefSpec, cost_cache_file=""))
    m.compile(optimizer=ff.SGDOptimizer(lr=LR), **CCE)
    out = {"digest": stable_graph_digest(m.graph),
           "views": views_by_digest(m.graph, m.strategy),
           "schedule": (None if m.sync_schedule is None
                        else m.sync_schedule.to_jsonable()),
           "zero": tuple(m.zero_groups),
           "start": {op: {w: np.array(v) for w, v in ws.items()}
                     for op, ws in m.params.items()}}
    out["losses"] = [h["loss"] for h in m.fit(x=x, y=y, verbose=False,
                                              shuffle=False)]
    return out


def _ref_import(path):
    import flexflow_tpu as ff
    from flexflow_tpu.core.machine import MachineSpec as RefSpec

    m = mlp(ff, _config(ff, RefSpec, cost_cache_file="",
                        import_strategy_file=path))
    m.compile(optimizer=ff.SGDOptimizer(lr=LR), **CCE)
    return (None if m.sync_schedule is None
            else m.sync_schedule.to_jsonable(), tuple(m.zero_groups))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    x, y = _data()
    root = tmp_path_factory.mktemp("co_search")

    def compute():
        ref = _reference(x, y)
        path = str(root / "strategy.json")
        path8 = str(root / "strategy_int8.json")
        ranks = spawn(_rank, N, (ref["start"], x, y, path, path8),
                      init_method=f"file://{root / 'rendezvous'}",
                      device="cpu", timeout=600)
        ref["imported"] = _ref_import(path)
        ref["imported_int8"] = _ref_import(path8)
        return ref, ranks

    return shared_world(tmp_path_factory, "torch_co_search", compute)


def test_one_search_one_comm_plan_on_every_rank(world):
    ref, ranks = world
    for r in ranks:
        assert r["digest"] == ref["digest"]
        assert r["views"] == ref["views"]
        assert r["meta"] == ranks[0]["meta"]
        sched, zero = r["lowered"]
        assert tuple(zero) == ref["zero"] and zero
        assert close(sched, ref["schedule"])


def test_co_searched_training_equals_the_reference(world):
    ref, ranks = world
    for r in ranks:
        assert len(r["losses"]) == STEPS
        np.testing.assert_allclose(r["losses"][-1], ref["losses"][-1],
                                   rtol=1e-5)


def test_the_comm_plan_round_trips_through_a_strategy_file(world):
    ref, ranks = world
    meta = ranks[0]["meta"]
    assert meta["zero_groups"] == sorted(ref["zero"])
    for r in ranks:
        assert r["imported_meta"] == meta
    sched, zero = ref["imported"]
    assert zero == ref["zero"]
    assert close(sched, ref["schedule"])
    # __meta__.sync_precision: the port adopts it on import (with no
    # sync_precision in its config); the JAX package's import ignores it
    for r in ranks:
        made, adopted, lowered = r["int8_meta"]
        assert made and adopted == made == lowered
    assert ref["imported_int8"] == (None, ())
