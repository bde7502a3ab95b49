"""The port's ``FleetExecutor`` (runtime/fleet.py) against the JAX
package's, and a fleet over rank blocks.

* Routing: the reference's synthetic step (tests/test_fleet.py:310-333:
  each frame's next token a function of the token and its position) on
  replicas of both packages, the same seeded mixed-SLO trace: every
  request routed to the same replica, the same tokens, the deficit
  router's fractions, its validation, the per-class roll-up, and one
  ``fleet.route`` event per dispatch with the reference's fields.
* Over ranks: a gloo world of 4 runs a two-replica fleet, replica 0 a
  head split 2 on ranks 0-1 and replica 1 a batch split 2 on ranks 2-3
  (``fleet_over_ranks``: every rank routes the whole trace and steps
  its block's replica); every rank ends with the fleet's tokens, which
  equal a one-process fleet's of the same model (two one-device
  replicas), and the same routing.

The rank function imports no JAX: the spawned ranks import this module
to find it."""

from __future__ import annotations

import json

import numpy as np
import pytest

from flexflow_tpu.runtime import decode as jax_decode
from flexflow_tpu.runtime.fleet import FleetExecutor as JaxFleet

from flexflow_tpu_torch.runtime import decode
from flexflow_tpu_torch.runtime.fleet import FleetExecutor

from test_torch_worlds import shared_world

SLO = (("interactive", 2, 0, 0.99), ("standard", 1, 0, 0.99),
       ("batch", 0, 0, 0.9))
ROUTINGS = [
    {"interactive": [0.5, 0.5], "standard": [0.5, 0.5],
     "batch": [0.5, 0.5]},
    {"interactive": [1.0, 0.0, 0.0], "standard": [0.2, 0.5, 0.3],
     "batch": [0.0, 0.4, 0.6]},
]
KW = dict(vocab=128, num_layers=2, hidden=64, num_heads=4, ff_dim=64,
          page_size=8, pages_per_seq=4)
B = 8


def _synthetic_step(vocab=97):
    def step(ids, table, lens):
        ids = np.asarray(ids)
        lens = np.asarray(lens)
        nxt = (ids[:, 0] * 7 + lens * 13 + 5) % vocab
        logits = np.zeros((ids.shape[0], 1, vocab), np.float32)
        logits[np.arange(ids.shape[0]), 0, nxt] = 1.0
        return logits

    return step


def _port_step(vocab=97):
    import torch

    step = _synthetic_step(vocab)
    return lambda *a: torch.from_numpy(step(*a))


def _fleet(mod, fleet_cls, routing, step, seed):
    slo = [mod.SLOClass(n, priority=p, deadline_frames=d, quantile=q)
           for n, p, d, q in SLO]
    reps = [mod.ContinuousBatchingExecutor(
        step(), max_seqs=4, page_size=4, pages_per_seq=4, slo_classes=slo)
        for _ in range(len(next(iter(routing.values()))))]
    return fleet_cls(reps, routing, slo_classes=slo, seed=seed)


def _trace(mod, n=24, seed=5):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        cls = ("interactive", "standard", "batch")[int(rng.integers(0, 3))]
        plen = int(rng.integers(1, 6))
        reqs.append(mod.DecodeRequest(
            rid=f"r{i:02d}", prompt=list(map(int, rng.integers(1, 96,
                                                               size=plen))),
            max_new_tokens=int(rng.integers(1, 4)), slo=cls))
    return reqs


@pytest.mark.parametrize("routing", range(len(ROUTINGS)))
@pytest.mark.parametrize("seed", (0, 11))
def test_routing_and_tokens_match_the_reference(routing, seed, tmp_path):
    from flexflow_tpu.obs.events import BUS as JAX_BUS

    from flexflow_tpu_torch.obs.events import BUS

    logs = {}
    for name, bus, mod, cls, step in (
            ("port", BUS, decode, FleetExecutor, _port_step),
            ("jax", JAX_BUS, jax_decode, JaxFleet, _synthetic_step)):
        path = tmp_path / f"{name}.jsonl"
        bus.configure(str(path))
        try:
            fl = _fleet(mod, cls, ROUTINGS[routing], step, seed)
            out = fl.run(_trace(mod), max_frames=500)
            bus.flush()
        finally:
            bus.close()
        routes = [json.loads(line) for line in path.read_text().splitlines()]
        routes = [{k: e[k] for k in ("rid", "replica", "slo")}
                  for e in routes if e.get("kind") == "fleet.route"]
        summ = fl.summary()
        logs[name] = (dict(fl.assignments), out, routes,
                      {k: summ[k] for k in ("replicas", "routing",
                                            "completed")},
                      sorted(summ["slo_classes"]),
                      [r["rid"] for r in fl.request_records])
    assert logs["port"] == logs["jax"]
    assert len(logs["port"][2]) == 24


def test_deficit_router_tracks_fractions_as_the_reference():
    picks = {}
    for name, mod, cls, step in (("port", decode, FleetExecutor, _port_step),
                                 ("jax", jax_decode, JaxFleet,
                                  _synthetic_step)):
        fl = _fleet(mod, cls, {"standard": [0.7, 0.3]}, step, 0)
        reqs = [mod.DecodeRequest(rid=f"s{i}", prompt=[1 + i],
                                  max_new_tokens=1, slo="standard")
                for i in range(20)]
        picks[name] = [fl.route(r) for r in reqs] + [fl.route(
            mod.DecodeRequest(rid="x", prompt=[1], max_new_tokens=1,
                              slo="mystery"))]
    assert picks["port"] == picks["jax"]
    assert abs(picks["port"][:20].count(0) - 14) <= 1


def test_routing_validation_as_the_reference():
    reps = [decode.ContinuousBatchingExecutor(_port_step(), max_seqs=2,
                                              page_size=4, pages_per_seq=4)
            for _ in range(2)]
    for args in (([], {"standard": [1.0]}), (reps, {"standard": [1.0]}),
                 (reps, {"standard": [0.0, 0.0]})):
        with pytest.raises(ValueError):
            FleetExecutor(*args)
    fl = FleetExecutor(reps, {"standard": [1.0, 1.0]})
    assert fl.routing == {"standard": (0.5, 0.5)}
    assert [r.replica_label for r in reps] == ["0", "1"]


# ---------------------------------------------------------------------------
# a fleet over rank blocks
# ---------------------------------------------------------------------------
def _requests(mod):
    rng = np.random.default_rng(4)
    return [mod.DecodeRequest(
        rid=f"q{i}", prompt=rng.integers(0, KW["vocab"],
                                         size=int(rng.integers(1, 12))
                                         ).tolist(),
        max_new_tokens=int(rng.integers(2, 8)),
        slo=("interactive", "batch")[i % 2]) for i in range(14)]


def _proposal(graph, views):
    """Two replica blocks of 2 ranks: a head split, a batch split."""
    from flexflow_tpu_torch.search.fleet import FleetProposal, FleetReplica

    reps = tuple(FleetReplica(
        index=i, devices=2, start=2 * i, prefill_devices=0,
        decode_devices=2, share=0.5, occupancy_slots=B, step_s=0.0,
        handoff_s=0.0, spans_dcn=False, strategy=views[i], graph=None)
        for i in range(2))
    return FleetProposal(
        num_devices=4, replicas=reps,
        routing={"interactive": (0.75, 0.25), "batch": (0.25, 0.75)},
        routing_policy="test", single_cost_s=1.0, fleet_cost_s=0.5,
        per_class_p99_s={}, single_per_class_p99_s={}, adopted=True,
        max_seqs=B, page_size=KW["page_size"],
        pages_per_seq=KW["pages_per_seq"], offered_load=0.85,
        load_scale=1.0, slo_classes=({"name": "interactive", "priority": 1},
                                     {"name": "batch", "priority": 0}))


def _views(graph, b, r):
    from flexflow_tpu_torch.core.machine import MachineView

    views = {}
    for node in graph.topo_order():
        nd = node.op.output_shapes[0].ndim
        if node.op.op_type.name == "DECODE_ATTENTION":
            views[node.guid] = MachineView((b, 1, 1), replica_degree=r)
        else:
            views[node.guid] = MachineView((b,) + (1,) * (nd - 1))
    return views


def _executor(step, index):
    return decode.ContinuousBatchingExecutor(
        step, max_seqs=B, page_size=KW["page_size"],
        pages_per_seq=KW["pages_per_seq"], prefill_fn=step.prefill,
        prefill_chunk=4)


def _model(n):
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.models import build_gpt_decode

    return build_gpt_decode(FFConfig(batch_size=B, device="cpu",
                                     num_devices=n, compute_dtype="float32",
                                     seed=3), **KW)


def _fleet_rank(rank):
    from flexflow_tpu_torch.runtime.fleet import RemoteReplica, fleet_over_ranks

    m = _model(4)
    prop = _proposal(m.graph, [_views(m.graph, 1, 2), _views(m.graph, 2, 1)])
    fl = fleet_over_ranks(m, prop, _executor, prefill_chunk=4, seed=1)
    out = fl.run(_requests(decode))
    from test_torch_examples import example_rank_legs
    from test_torch_halo import halo_rank_legs
    from test_torch_seq_split import seq_split_rank_legs
    from test_torch_zoo import zoo_rank_legs
    from test_torch_view_sweep import pinned_rank_legs, sweep_rank_legs
    from test_torch_zoo_ranks import searched_zoo_rank_legs

    return {"tokens": out, "assignments": dict(fl.assignments),
            "remote": [isinstance(r, RemoteReplica) for r in fl.replicas],
            "records": len(fl.request_records),
            "per_replica": [s.get("completed") for s in
                            fl.summary()["per_replica"]],
            # the zoo's split legs share this world (tests/test_torch_zoo)
            "zoo": zoo_rank_legs(),
            # and the multi-rank examples (tests/test_torch_examples)
            "examples": example_rank_legs(),
            # and the halo exchange's cases (tests/test_torch_halo)
            "halo": halo_rank_legs(),
            # and batch_matmul's split sequence mask
            # (tests/test_torch_seq_split)
            "seq_split": seq_split_rank_legs(),
            # and the zoo's searched picks (tests/test_torch_zoo_ranks)
            "searched_zoo": searched_zoo_rank_legs(),
            # and every op's candidate views, and Queue C's pinned views
            # (tests/test_torch_view_sweep)
            "sweep": sweep_rank_legs(), "pinned": pinned_rank_legs()}


def _one_process_fleet():
    from flexflow_tpu_torch.runtime.decode import SLOClass, compiled_decode_step

    reps = []
    for _ in range(2):
        m = _model(1)
        m.compile(comp_mode="inference")
        reps.append(_executor(compiled_decode_step(m, prefill_chunk=4), 0))
    slo = [SLOClass("interactive", 1), SLOClass("batch", 0)]
    fl = FleetExecutor(reps, {"interactive": (0.75, 0.25),
                              "batch": (0.25, 0.75)}, slo_classes=slo,
                       seed=1)
    return fl.run(_requests(decode)), dict(fl.assignments)


@pytest.fixture(scope="module")
def fleet_world(tmp_path_factory):
    from flexflow_tpu_torch.runtime.distributed import spawn

    root = tmp_path_factory.mktemp("fleet_world")

    def compute():
        ranks = spawn(_fleet_rank, 4, (),
                      init_method=f"file://{root / 'rendezvous'}",
                      device="cpu", timeout=600)
        return ranks, _one_process_fleet()

    return shared_world(tmp_path_factory, "torch_fleet_world", compute)


def test_fleet_over_rank_blocks_gives_the_one_process_tokens(fleet_world):
    ranks, (tokens, assignments) = fleet_world
    assert set(tokens) == {r.rid for r in _requests(decode)}
    for r in ranks:
        assert r["tokens"] == tokens
        assert r["assignments"] == assignments
    assert set(assignments.values()) == {0, 1}


def test_every_rank_steps_only_its_block(fleet_world):
    ranks, _ = fleet_world
    assert [r["remote"] for r in ranks] == [
        [False, True], [False, True], [True, False], [True, False]]
    for r in ranks:  # the roll-up is the whole fleet's on every rank
        assert r["records"] == 0  # the bus was off: no request records
        assert sum(r["per_replica"]) == 14
