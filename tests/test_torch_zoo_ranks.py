"""The zoo's searched strategies over ranks: each builder under
``compile(strategy=None)`` with ``num_devices=4`` on
``MachineSpec.h100_sxm(4)`` (rank 0 searches, every rank lowers its
pick), 2 SGD steps on tests/test_torch_fleet.py's gloo world of 4
(``_fleet_rank`` calls ``searched_zoo_rank_legs``), against one
process training the model unsplit from the same weights.

The shapes are small but chosen so that each pick splits more than
the batch (``SEARCHED``): DLRM at its default widths with 1000-row
tables (out-dim and vocabulary splits of the tables and the MLPs),
candle_uno with three feature towers at width 512 (out-dim and
in-dim splits), the MoE (expert splits), mlp_unify (out-dim splits),
AlexNet at CIFAR-10 size (out-dim and in-dim splits of its dense
head), a ResNet of one block per stage at 32x32 (out- and in-channel
splits of its convs and batch norms) and the same ResNet with grouped
convs (4 groups, base width 16: ResNeXt's block), whose pick splits a
grouped conv's out channels.  Checked: every rank
holds the one searched graph and views; the pick splits a dim other
than the batch or a replica; the losses and the whole weights within
fp32 1e-5 of one process (the ResNet's updates within the zoo's
measured bound, ``SENSITIVE``); the batch norms' running statistics
after the first step within 1e-5 (whole on every rank, also under a
split of the channels); every weight a rank holds whole is the same
bits on every rank.

The rank function imports no JAX."""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as tff
import flexflow_tpu_torch.models as tmods
from flexflow_tpu_torch.core.machine import MachineSpec
from flexflow_tpu_torch.interop import params_to_numpy

from test_torch_fleet import fleet_world  # noqa: F401  (the shared world)

N = 4
TOL = 1e-5
LR = 0.01
CCE = dict(loss_type="sparse_categorical_crossentropy", metrics=[])
MSE = dict(loss_type="mean_squared_error", metrics=[])
SEARCH = dict(search_timeout_s=0, enable_pipeline_search=False,
              enable_placement_search=False)
ID_RANGE = 1000  # below every table's rows
# The ResNet's batch norms make its updates chaotic at this size: in
# one process, a 1e-6 change of the input moves its first update by up
# to 1.5e-2 relative (L2) and its second loss by 1.2e-2, as the ranks'
# summation order does (a ReLU input within rounding of zero passes its
# gradient on one side only and the batch norm spreads it over its
# channel; tests/test_torch_zoo.py measured the same against the JAX
# package), and the second step compounds it.  Its first loss is held
# to TOL, its first update (L2, each weight) and its second loss to
# that file's measured bound.
SENSITIVE = ("resnet", "resnet_groups")
RESNET_UPDATE_TOL = 5e-2  # tests/test_torch_zoo.py's

# name -> (builder, widths, batch, loss)
SEARCHED = {
    "dlrm": ("build_dlrm", dict(embedding_sizes=(1000, 1000)), 8, MSE),
    "candle_uno": ("build_candle_uno", dict(
        feature_shapes={"dose": 1, "cell.rnaseq": 64,
                        "drug.descriptors": 256},
        input_features=["dose1", "cell.rnaseq", "drug1.descriptors"],
        dense_layers=(512,) * 3, dense_feature_layers=(512,) * 3), 8, MSE),
    "moe": ("build_moe", dict(in_dim=32, num_classes=4, num_exp=4,
                              num_select=2, hidden=16), 16, CCE),
    "mlp": ("build_mlp_unify", dict(in_dim=64, hidden=(64, 64),
                                    num_classes=4), 16, CCE),
    "alexnet": ("build_alexnet_cifar10", {}, 8, CCE),
    "resnet": ("build_resnet", dict(num_classes=10, image=32,
                                    layers=(1, 1, 1, 1)), 8, CCE),
    # ResNeXt's grouped convs at 4 groups: the pick splits the last
    # stage's out channels (ROADMAP Queue C)
    "resnet_groups": ("build_resnet", dict(
        num_classes=10, image=32, layers=(1, 1, 1, 1), groups=4,
        base_width=16), 8, CCE),
}


def _config(name, n):
    _, _, batch, _ = SEARCHED[name]
    return tff.FFConfig(batch_size=batch, device="cpu", num_devices=n,
                        compute_dtype="float32",
                        machine_spec=MachineSpec.h100_sxm(N), **SEARCH)


def _build(name, n):
    build, kw, _, _ = SEARCHED[name]
    return getattr(tmods, build)(_config(name, n), **kw)


def zoo_data(model, loss, steps, seed):
    """``steps`` batches of (inputs, labels) for the graph's inputs:
    normal floats, ids below ``ID_RANGE``; class ids or normal targets
    of the sink's shape."""
    rng = np.random.default_rng(seed)
    inputs = [n for n in model.graph.topo_order()
              if n.op.op_type.value == "input"]
    inputs.sort(key=lambda n: n.op.attrs["tensor_guid"])
    sink = model.compiled._sink.op.output_shapes[0].sizes
    out = []
    for _ in range(steps):
        xs = []
        for node in inputs:
            shape = node.op.output_shapes[0]
            if shape.dtype.value.startswith("int"):
                xs.append(rng.integers(0, ID_RANGE, size=shape.sizes)
                          .astype(np.int32))
            else:
                xs.append(rng.normal(size=shape.sizes).astype(np.float32))
        if loss is CCE:
            y = rng.integers(0, sink[-1], size=sink[:-1]).astype(np.int32)
        else:
            y = rng.normal(size=sink).astype(np.float32)
        out.append((xs, y))
    return out


def train_steps(model, batches):
    """SGD steps on this rank's blocks of ``batches`` (step i draws its
    dropout masks from seed i): the losses, and the model state (batch
    norms' running statistics) and the whole weights after the first
    step."""
    c, losses, first_state, first_whole = model.compiled, [], None, None
    for step, (xs, y) in enumerate(batches):
        ins = [torch.from_numpy(np.ascontiguousarray(
            x[c.input_slices(i, x.shape)])) for i, x in enumerate(xs)]
        ys = torch.from_numpy(np.ascontiguousarray(y[c.label_slices(
            y.shape)]))
        model.params, model.opt_state, model.state, loss, _ = c.train_step(
            model.params, model.opt_state, model.state, ins, ys, seed=step)
        losses.append(float(loss))
        if first_state is None:
            first_state = {k: v.detach().numpy().copy()
                           for k, v in model.state.items()}
            first_whole = {op: {w: v.copy() for w, v in ws.items()}
                           for op, ws in params_to_numpy(model.params,
                                                         c).items()}
    return losses, first_state, first_whole


def views_of(model):
    """The pick: (op name, dim degrees, replica degree) per node."""
    return sorted((n.op.name, tuple(model.strategy[n.guid].dim_degrees),
                   model.strategy[n.guid].replica_degree)
                  for n in model.graph.topo_order())


def split_kinds(views):
    """The pick's views counted by kind: batch (dim 0 only), out (a
    later dim), replica (partial sums or a replicated input), none."""
    kinds = collections.Counter()
    for _, degs, r in views:
        if r > 1:
            kinds["replica"] += 1
        if any(d > 1 for d in degs[1:]):
            kinds["out"] += 1
        if degs and degs[0] > 1:
            kinds["batch"] += 1
        if r == 1 and all(d == 1 for d in degs):
            kinds["none"] += 1
    return dict(kinds)


def _leg(name):
    from flexflow_tpu_torch.search.cost_cache import stable_graph_digest

    m = _build(name, N)
    loss = SEARCHED[name][3]
    m.compile(optimizer=tff.SGDOptimizer(lr=LR), **loss)
    losses, state, first = train_steps(m, zoo_data(m, loss, 2, 17))
    local = {op: {w: t.detach().numpy().copy() for w, t in ws.items()}
             for op, ws in m.params.items()}
    return {"digest": stable_graph_digest(m.graph), "views": views_of(m),
            "losses": losses, "whole": params_to_numpy(m.params, m.compiled),
            "local": local, "state": state, "first_whole": first}


def searched_zoo_rank_legs():
    """Each model's searched compile and 2 steps on this rank of a world
    of 4 (a rank function of tests/test_torch_fleet.py calls it)."""
    return {name: _leg(name) for name in SEARCHED}


def one_process_run(name):
    """The same search in this process (no ranks needed) for its graph's
    digest, then the model unsplit on one process trained from the same
    seed: (digest, losses, whole weights).  The searched graphs add
    only parallel ops (repartition, combine, replicate, reduction:
    identities on one process) and keep every weighted op's name."""
    from flexflow_tpu_torch.search import driver
    from flexflow_tpu_torch.search.cost_cache import stable_graph_digest

    graph, _ = driver.optimize_strategy(_build(name, N).graph,
                                        _config(name, N), return_graph=True)
    m = _build(name, 1)
    loss = SEARCHED[name][3]
    m.compile(optimizer=tff.SGDOptimizer(lr=LR), strategy={}, **loss)
    start = {op: {w: v.copy() for w, v in ws.items()}
             for op, ws in params_to_numpy(m.params).items()}
    losses, state, first = train_steps(m, zoo_data(m, loss, 2, 17))
    return (stable_graph_digest(graph), losses, params_to_numpy(m.params),
            state, start, first)


@pytest.fixture(scope="module")
def one_process():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: one_process_run(name) for name in SEARCHED}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(SEARCHED))
def test_every_rank_lowers_one_pick_that_splits_more_than_the_batch(
        fleet_world, one_process, name):
    ranks, _ = fleet_world
    legs = [r["searched_zoo"][name] for r in ranks]
    assert len({leg["digest"] for leg in legs}) == 1
    assert all(leg["views"] == legs[0]["views"] for leg in legs)
    assert legs[0]["digest"] == one_process[name][0]
    kinds = split_kinds(legs[0]["views"])
    assert kinds.get("out", 0) + kinds.get("replica", 0) > 0, kinds


@pytest.mark.parametrize("name", sorted(SEARCHED))
def test_searched_pick_trains_as_one_process(fleet_world, one_process,
                                             name):
    ranks, _ = fleet_world
    _, losses, whole, _, start, first = one_process[name]
    for r in ranks:
        got = r["searched_zoo"][name]
        assert got["whole"].keys() == whole.keys()
        if name in SENSITIVE:  # see SENSITIVE
            assert abs(got["losses"][0] - losses[0]) <= TOL * losses[0]
            assert abs(got["losses"][1] - losses[1]) <= (
                RESNET_UPDATE_TOL * losses[1])
            for op, ws in first.items():
                for w, v in ws.items():
                    upd = v - start[op][w]
                    err = np.linalg.norm(got["first_whole"][op][w] - v)
                    assert err <= RESNET_UPDATE_TOL * max(
                        np.linalg.norm(upd), TOL), (name, op, w)
            continue
        np.testing.assert_allclose(got["losses"], losses, rtol=TOL,
                                   atol=TOL)
        for op, ws in whole.items():
            for w, v in ws.items():
                np.testing.assert_allclose(got["whole"][op][w], v,
                                           rtol=TOL, atol=TOL,
                                           err_msg=f"{name} {op}/{w}")


@pytest.mark.parametrize("name", sorted(SEARCHED))
def test_searched_pick_keeps_the_running_statistics(fleet_world,
                                                    one_process, name):
    """The batch norms' running statistics after the first step (whole
    on every rank, also under a split of the channels) as one
    process's."""
    ranks, _ = fleet_world
    state = one_process[name][3]
    for r in ranks:
        got = r["searched_zoo"][name]["state"]
        assert got.keys() == state.keys()
        for k, v in state.items():
            np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", sorted(SEARCHED))
def test_searched_pick_keeps_whole_weights_bit_equal(fleet_world, name):
    """A weight a rank holds whole (its local copy has the whole's
    shape) is the same bits on every rank."""
    ranks, _ = fleet_world
    first = ranks[0]["searched_zoo"][name]
    for r in ranks[1:]:
        got = r["searched_zoo"][name]
        for op, ws in first["local"].items():
            for w, v in ws.items():
                if v.shape == first["whole"][op][w].shape:
                    np.testing.assert_array_equal(got["local"][op][w], v,
                                                  err_msg=f"{op}/{w}")


def test_the_grouped_resnet_pick_splits_a_grouped_convs_out_channels(
        fleet_world):
    ranks, _ = fleet_world
    grouped = {n.op.name for n in _build("resnet_groups", N).graph
               .topo_order() if n.op.attrs.get("groups", 1) > 1}
    split = [name for name, degs, _ in
             ranks[0]["searched_zoo"]["resnet_groups"]["views"]
             if name in grouped and degs[3] > 1]
    assert split, grouped
