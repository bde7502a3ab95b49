"""Attribute parallelism by halo exchange: a conv or pool whose H or W
is split over ranks (ops/conv.py ``forward_sharded``,
parallel/mesh.py ``halo_exchange``).

Each case is one op on a seeded NHWC input under a view that splits
its H, its W or both over 4 ranks of tests/test_torch_fleet.py's gloo
world (``_fleet_rank`` calls ``halo_rank_legs``):

* 3x3 s1 p1 convs over H, W and both;
* the stem's 7x7 s2 p3 conv over H at 16 rows (ResNet's stem cut);
* a halo wider than a block: 7x7 s1 p3 over 8 rows split 4 ways
  (blocks of 2, 3 rows wanted on each side);
* 3x3 s2 p1 max and average pools over H, and the average over both.

Checked for each: the output, the input's gradient and the kernel's
and bias's gradients (the ranks' addends summed) within 1e-5 of one
process and of the JAX package's run of the same view on its virtual
CPU devices; the bytes each rank's exchanges hand the transport
(``comm_counts()["halo_exchange"]``, forward and backward) equal the
halo slabs the shapes imply (``ops.conv.halo_cells``, chip_smoke.py's
count too), and no rank moves the whole activation (no all-gather
before the op).

The rank function imports no JAX: the ranks import this module, whose
JAX imports are inside the reference's functions."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as tff
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.ops.conv import halo_cells, halo_rows

from test_torch_fleet import fleet_world  # noqa: F401  (the shared world)

N = 4
TOL = 1e-5
BATCH = 2
CHANNELS = 3

# name -> (op, input (H, W), op args, output view)
CASES = {
    "conv3_h": ("conv", (8, 8), dict(k=3, s=1, p=1), (1, 4, 1, 1)),
    "conv3_w": ("conv", (8, 8), dict(k=3, s=1, p=1), (1, 1, 4, 1)),
    "conv3_hw": ("conv", (8, 8), dict(k=3, s=1, p=1), (1, 2, 2, 1)),
    "stem7_s2_h": ("conv", (16, 16), dict(k=7, s=2, p=3), (1, 4, 1, 1)),
    "wide7_h": ("conv", (8, 8), dict(k=7, s=1, p=3), (1, 4, 1, 1)),
    "maxpool3_s2_h": ("max", (16, 8), dict(k=3, s=2, p=1), (1, 4, 1, 1)),
    "avgpool3_s2_h": ("avg", (16, 8), dict(k=3, s=2, p=1), (1, 4, 1, 1)),
    "avgpool3_s2_hw": ("avg", (8, 8), dict(k=3, s=2, p=1), (1, 2, 2, 1)),
}


def _model(pkg, cfg, name):
    kind, (h, w), a, _ = CASES[name]
    m = pkg.FFModel(cfg)
    x = m.create_tensor([BATCH, h, w, CHANNELS], name="x")
    if kind == "conv":
        m.conv2d(x, 4, a["k"], a["k"], a["s"], a["s"], a["p"], a["p"],
                 name="op")
    else:
        m.pool2d(x, a["k"], a["k"], a["s"], a["s"], a["p"], a["p"],
                 pool_type=kind, name="op")
    return m


def _views(model, name):
    out = CASES[name][3]
    return {n.guid: (MachineView(out) if n.op.name == "op"
                     else MachineView.trivial(n.op.output_shapes[0].ndim))
            for n in model.graph.topo_order()}


def _data(name):
    _, (h, w), _, _ = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.normal(size=(BATCH, h, w, CHANNELS)).astype(np.float32)
    return x, rng


def _port_run(name, n):
    """The op's output, input gradient and weight gradients (this rank's
    addends), and the halo bytes this rank sent, on ``n`` ranks (one
    process when n is 1), numpy: it crosses ranks."""
    from flexflow_tpu_torch.interop import params_from_numpy
    from flexflow_tpu_torch.parallel import mesh as pmesh

    m = _model(tff, tff.FFConfig(batch_size=BATCH, device="cpu",
                                 num_devices=n, compute_dtype="float32"),
               name)
    m.compile(strategy=_views(m, name) if n > 1 else {},
              loss_type="mean_squared_error", metrics=[])
    x, rng = _data(name)
    whole = {op: {w: rng.normal(size=t.shape).astype(np.float32) * 0.3
                  for w, t in ws.items()} for op, ws in m.params.items()}
    params = params_from_numpy(whole, "cpu", m.compiled)
    for ws in params.values():
        for t in ws.values():
            t.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    pmesh.reset_comm_counts()
    y, _ = m.compiled.apply(params, m.state, [xt], train=True)
    forward = pmesh.comm_counts()
    cot = m.compiled.gather_output(y).detach()  # whole, for the shape
    cot = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(cot.shape)).astype(np.float32))
    mine = cot[tuple(m.compiled._sink_pl.local_slices(cot.shape,
                                                      m.compiled.mesh))]
    pmesh.reset_comm_counts()
    y.backward(mine)
    backward = pmesh.comm_counts()
    return {"whole": whole, "x": x, "cot": cot.numpy(),
            "out": m.compiled.gather_output(y.detach()).numpy(),
            "x_grad": xt.grad.numpy(),
            "w_grads": {op: {w: t.grad.numpy() for w, t in ws.items()}
                        for op, ws in params.items()},
            "forward": forward, "backward": backward}


def halo_rank_legs():
    """Every case on this rank of a world of 4 (a rank function of
    tests/test_torch_fleet.py calls it)."""
    return {name: _port_run(name, N) for name in CASES}


def _reference_run(name, whole, x, cot):
    """The JAX package's op under the same view on 4 virtual devices:
    (output, input gradient, weight gradients)."""
    import jax
    import jax.numpy as jnp

    import flexflow_tpu as ff

    m = _model(ff, ff.FFConfig(batch_size=BATCH, num_devices=N,
                               compute_dtype="float32"), name)
    m.compile(strategy=_views_ref(m, name),
              loss_type="mean_squared_error", metrics=[])
    params = {op: {w: jnp.asarray(v) for w, v in ws.items()}
              for op, ws in whole.items()}

    def f(p, xx):
        out, _ = m.compiled.apply(p, m.state, [xx], None, False)
        return out

    out, vjp = jax.vjp(f, params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot))
    return (np.asarray(out), np.asarray(gx),
            {op: {w: np.asarray(v) for w, v in ws.items()}
             for op, ws in gp.items()})


def _views_ref(model, name):
    from flexflow_tpu.core.machine import MachineView as RefView

    out = CASES[name][3]
    return {n.guid: (RefView(out) if n.op.name == "op"
                     else RefView.trivial(n.op.output_shapes[0].ndim))
            for n in model.graph.topo_order()}


@pytest.fixture(scope="module")
def one_process():
    return {name: _port_run(name, 1) for name in CASES}


def expected_halo_bytes(name, rank):
    """The halo slabs' bytes (forward, backward) that ``rank`` sends:
    H first on its W block, then W on the H window."""
    _, (h, w), a, view = CASES[name]
    fwd, bwd = halo_cells((h, w), view[1:3], (a["k"],) * 2, (a["s"],) * 2,
                          (a["p"],) * 2, rank)
    unit = BATCH * CHANNELS * 4
    return fwd * unit, bwd * unit


def _summed_w_grads(ranks, name):
    out = {}
    for r in ranks:
        for op, ws in r["halo"][name]["w_grads"].items():
            for w, g in ws.items():
                out.setdefault(op, {}).setdefault(w, 0)
                out[op][w] = out[op][w] + g
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_halo_case_matches_one_process(fleet_world, one_process, name):
    ranks, _ = fleet_world
    want = one_process[name]
    for r in ranks:
        got = r["halo"][name]
        np.testing.assert_array_equal(got["x"], want["x"])
        np.testing.assert_allclose(got["out"], want["out"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["x_grad"], want["x_grad"], rtol=TOL,
                                   atol=TOL)
    summed = _summed_w_grads(ranks, name)
    for op, ws in want["w_grads"].items():
        for w, g in ws.items():
            np.testing.assert_allclose(summed[op][w], g, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} {op}/{w}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_halo_case_matches_the_reference(fleet_world, name):
    ranks, _ = fleet_world
    got = ranks[0]["halo"][name]
    out, gx, gp = _reference_run(name, got["whole"], got["x"], got["cot"])
    np.testing.assert_allclose(got["out"], out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["x_grad"], gx, rtol=TOL, atol=TOL)
    summed = _summed_w_grads(ranks, name)
    for op, ws in gp.items():
        for w, g in ws.items():
            np.testing.assert_allclose(summed[op][w], g, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} {op}/{w}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_halo_bytes_are_the_slabs(fleet_world, name):
    """Each rank sends its halo slabs and nothing else before the op:
    the input reaches the op's layout by a local slice (the input is
    whole on every rank), and the only collective of the forward
    before the output's gather is the halo exchange."""
    ranks, _ = fleet_world
    for rank, r in enumerate(ranks):
        got = r["halo"][name]
        fwd, bwd = expected_halo_bytes(name, rank)
        assert got["forward"]["halo_exchange"]["bytes"] == fwd, (rank, fwd)
        assert got["backward"]["halo_exchange"]["bytes"] == bwd, (rank, bwd)
        assert got["forward"]["all_gather"]["calls"] == 0
        assert got["forward"]["all_reduce_sum"]["calls"] == 0


def test_the_wide_halo_takes_rows_from_several_owners():
    """7x7 over 8 rows in blocks of 2: an inner rank's window reaches
    past its neighbours' blocks, and still not the whole input."""
    for rank in range(N):
        fwd_rows, bwd_rows, window = halo_rows(8, N, 7, 1, 3, rank)
        assert window < 8
        assert bwd_rows > 2  # more than one neighbour's block
    assert expected_halo_bytes("wide7_h", 1)[1] < 8 * 8 * BATCH * CHANNELS * 4
