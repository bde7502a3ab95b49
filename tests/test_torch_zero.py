"""ZeRO-1 in the port (``FFConfig(zero_dp_shard=True)`` and the
per-group ``__meta__.zero_groups``): each rank keeps the optimizer slots
of its shard of every member weight, updates that shard, and
all-gathers the updated weight (compiler/lowering.py).  On gloo worlds
of 2 and 4 CPU ranks, an MLP (64 -> fc1 1024 -> fc2 512 -> head 8,
batch 32, Adam at 1e-3, fp32) trains 3 steps from the JAX package's
initial weights.

* The losses and weights equal the JAX package's own ZeRO-1 run within
  1e-5.
* Against the replicated run of the port: bit for bit at a world of 2;
  within 5e-6 at 4, because the ZeRO gradient is reduce-scattered (on
  gloo: an all-to-all and a sum in rank order, comm/compat.py) where
  the replicated one is all-reduced by gloo, whose summation order
  depends on where an element sits in the payload.  Replicas stay bit
  for bit equal.
* Each rank holds 1/n of every member weight's Adam slots.
* Under Megatron (fc1 column-, fc2 row-parallel, dp 2 x tp 2), where
  the ZeRO axes of a weight are partly axes its gradient does not sum
  over: the same numbers as Megatron without ZeRO, within 5e-6.
* A per-group map (``zero_groups=["fc1"]`` in the strategy's
  ``__meta__``) shards fc1's slots only.
* Checkpoints: a ZeRO-1 world's snapshot (slots saved whole) resumes in
  the JAX package with and without ZeRO, and the JAX package's ZeRO-1
  snapshot resumes in the port's ZeRO world and in a replicated one;
  every continuation's 2 losses and weights equal the uninterrupted
  run's within 1e-5.
* An int8 error-feedback residual is saved as the ranks' sum and each
  rank resumes from an equal share of it.

The rank function imports no JAX: the spawned ranks import this module
to find it."""

from __future__ import annotations

import numpy as np
import pytest

import flexflow_tpu_torch as tff
from flexflow_tpu_torch.runtime.distributed import spawn

from test_torch_worlds import shared_world

BATCH, STEPS, MORE, ALPHA = 32, 3, 2, 1e-3
MLP = (("fc1", 1024, "relu"), ("fc2", 512, "relu"), ("head", 8, None))
CCE = dict(loss_type="sparse_categorical_crossentropy", metrics=[])


def mlp(pkg, cfg):
    m = pkg.FFModel(cfg)
    t = m.create_tensor([BATCH, 64])
    for name, width, act in MLP:
        t = m.dense(t, width, activation=act, name=name)
    return m


def data():
    rng = np.random.default_rng(0)
    n = (STEPS + MORE) * BATCH
    return (rng.normal(size=(n, 64)).astype(np.float32),
            rng.integers(0, 8, n).astype(np.int32))


def _cfg(pkg, n, **kw):
    return pkg.FFConfig(batch_size=BATCH, num_devices=n,
                        compute_dtype="float32", only_data_parallel=True,
                        **kw)


def megatron(m, view_cls):
    out = {}
    for node in m.graph.topo_order():
        name = node.op.name
        nd = node.op.output_shapes[0].ndim
        if name == "fc1":
            out[node.guid] = view_cls((2, 2))
        elif name == "fc2":
            out[node.guid] = view_cls((2, 1), replica_degree=2)
        else:
            out[node.guid] = view_cls((2,) + (1,) * (nd - 1))
    return out


def _rank(rank, n, start, x, y, ckpt_ref, ckpt_root):
    from flexflow_tpu_torch.core.machine import MachineSpec, MachineView
    from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
    from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager

    first, rest = slice(0, STEPS * BATCH), slice(STEPS * BATCH, None)

    def run(name, strategy=None, **kw):
        m = mlp(tff, _cfg(tff, n, device="cpu", **kw))
        s = strategy(m) if strategy else None
        m.compile(optimizer=tff.AdamOptimizer(alpha=ALPHA), strategy=s,
                  **CCE)
        m.params = params_from_numpy(start, "cpu", m.compiled)
        m.fit(x[first], y[first], shuffle=False, verbose=False)
        return m

    def record(m):  # copies: the numpy arrays share the live weights
        return {"losses": list(m.step_losses),
                "weights": {op: {w: v.copy() for w, v in ws.items()}
                            for op, ws in params_to_numpy(
                                m.params, m.compiled).items()}}

    out = {}
    plain, zero = run("plain"), run("zero", zero_dp_shard=True)
    out["plain"], out["zero"] = record(plain), record(zero)
    out["slots"] = {op: {w: (tuple(zero.opt_state["m"][op][w].shape),
                             tuple(plain.opt_state["m"][op][w].shape))
                         for w in ws} for op, ws in zero.params.items()}
    # the ZeRO world's snapshot, then its uninterrupted continuation
    mgr = CheckpointManager(f"{ckpt_root}/port_zero")
    mgr.save(STEPS, zero)
    zero.fit(x[rest], y[rest], shuffle=False, verbose=False)
    out["zero_cont"] = record(zero)
    # the reference's ZeRO snapshot resumed here, with and without ZeRO
    for key, kw in (("from_ref_zero", {"zero_dp_shard": True}),
                    ("from_ref_plain", {})):
        m = mlp(tff, _cfg(tff, n, device="cpu", **kw))
        m.compile(optimizer=tff.AdamOptimizer(alpha=ALPHA), **CCE)
        CheckpointManager(ckpt_ref).restore(m)
        m.fit(x[rest], y[rest], shuffle=False, verbose=False)
        out[key] = record(m)
    if n == 4:
        out["megatron"] = record(run(
            "megatron", lambda m: megatron(m, MachineView)))
        out["megatron_zero"] = record(run(
            "megatron_zero", lambda m: megatron(m, MachineView),
            zero_dp_shard=True))
        # a per-group map in the strategy's __meta__
        g = run("group", lambda m: dict(
            __import__("flexflow_tpu_torch.compiler.lowering", fromlist=[
                "x"]).data_parallel_strategy(m.graph, n),
            __meta__={"zero_groups": ["fc1"]}))
        out["group"] = {op: tuple(g.opt_state["m"][op]["kernel"].shape)
                        for op in ("fc1", "fc2")}
        out["group_weights"] = record(g)["weights"]
        # error feedback: the residual saved summed, resumed in shares
        ef = run("ef", sync_precision="int8", sync_ef="auto",
                 machine_spec=MachineSpec.tpu_v5e(n))
        keys = sorted(k for k in ef.state if k.endswith("/ef_residual"))
        mine = {k: ef.state[k].clone() for k in keys}
        CheckpointManager(f"{ckpt_root}/port_ef").save(STEPS, ef)
        for k in keys:
            ef.state[k].zero_()
        CheckpointManager(f"{ckpt_root}/port_ef").restore(ef)
        out["ef"] = {k: (mine[k].numpy(), ef.state[k].numpy())
                     for k in keys}
    return out


def _ref_model(n, zero):
    import flexflow_tpu as ff

    m = mlp(ff, _cfg(ff, n, zero_dp_shard=zero, cost_cache_file=""))
    m.compile(optimizer=ff.AdamOptimizer(alpha=ALPHA), **CCE)
    return m


def _ref_weights(m):
    return {op: {w: np.array(v) for w, v in ws.items()}
            for op, ws in m.params.items()}


def _world(n, tmp_path_factory):
    x, y = data()
    root = tmp_path_factory.mktemp(f"zero{n}")

    def compute():
        import jax

        from flexflow_tpu.runtime.checkpoint import CheckpointManager

        first, rest = slice(0, STEPS * BATCH), slice(STEPS * BATCH, None)
        ref = {}
        m = _ref_model(n, True)
        ref["start"] = _ref_weights(m)
        ref["losses"] = [h["loss"] for h in m.fit(
            x=x[first], y=y[first], verbose=False, shuffle=False)]
        ref["weights"] = _ref_weights(m)
        CheckpointManager(str(root / "ref_zero"), use_orbax=False).save(
            STEPS, m)
        m.fit(x=x[rest], y=y[rest], verbose=False, shuffle=False)
        ref["cont"] = _ref_weights(m)
        ranks = spawn(_rank, n, (n, ref["start"], x, y,
                                 str(root / "ref_zero"), str(root)),
                      init_method=f"file://{root / 'rendezvous'}",
                      device="cpu", timeout=600)
        # the port's ZeRO snapshot resumed in the reference
        for key, zero in (("port_zero", True), ("port_plain", False)):
            jm = _ref_model(n, zero)
            CheckpointManager(str(root / "port_zero"),
                              use_orbax=False).restore(jm)
            jm.fit(x=x[rest], y=y[rest], verbose=False, shuffle=False)
            ref["from_" + key] = _ref_weights(jm)
        del jax
        return n, ref, ranks

    return shared_world(tmp_path_factory, f"torch_zero_{n}", compute)


@pytest.fixture(scope="module", params=(2, 4))
def world(request, tmp_path_factory):
    return _world(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(4, tmp_path_factory)


def _max_diff(a, b):
    return max(float(np.max(np.abs(a[op][w] - b[op][w])))
               for op in a for w in a[op])


def test_zero1_equals_the_reference_zero1(world):
    n, ref, ranks = world
    for r in ranks:
        assert _max_diff(r["zero"]["weights"], ref["weights"]) <= 1e-5
        np.testing.assert_allclose(r["zero"]["losses"][-1],
                                   ref["losses"][-1], rtol=1e-5)


def test_zero1_equals_the_replicated_run(world):
    n, _, ranks = world
    tol = 0.0 if n == 2 else 5e-6
    for r in ranks:
        assert _max_diff(r["zero"]["weights"], r["plain"]["weights"]) <= tol
        assert _max_diff(r["zero"]["weights"],
                         ranks[0]["zero"]["weights"]) == 0.0
        if n == 2:
            assert r["zero"]["losses"] == r["plain"]["losses"]


def test_each_rank_holds_a_shard_of_the_slots(world):
    n, _, ranks = world
    for r in ranks:
        for op, ws in r["slots"].items():
            for w, (shard, whole) in ws.items():
                if w == "kernel":
                    assert np.prod(shard) * n == np.prod(whole), (op, shard)


def test_zero1_under_megatron_and_a_per_group_map(world4):
    n, _, ranks = world4
    for r in ranks:
        assert _max_diff(r["megatron_zero"]["weights"],
                         r["megatron"]["weights"]) <= 5e-6
        assert _max_diff(r["megatron_zero"]["weights"],
                         ranks[0]["megatron_zero"]["weights"]) == 0.0
        assert np.prod(r["group"]["fc1"]) * n == 64 * 1024
        assert r["group"]["fc2"] == (1024, 512)
        assert _max_diff(r["group_weights"], r["plain"]["weights"]) <= 5e-6


def test_zero1_checkpoints_resume_in_both_packages(world):
    n, ref, ranks = world
    port_cont = ranks[0]["zero_cont"]["weights"]
    for key in ("from_port_zero", "from_port_plain"):
        assert _max_diff(ref[key], port_cont) <= 1e-5, key
    for r in ranks:
        for key in ("from_ref_zero", "from_ref_plain"):
            assert _max_diff(r[key]["weights"], ref["cont"]) <= 1e-5, key
            np.testing.assert_allclose(
                r[key]["losses"], r["zero_cont"]["losses"],
                rtol=1e-5)


def test_error_feedback_residual_resumes_in_equal_shares(world4):
    n, _, ranks = world4
    keys = sorted(ranks[0]["ef"])
    assert keys
    for k in keys:
        total = sum(r["ef"][k][0].astype(np.float64) for r in ranks)
        for r in ranks:
            np.testing.assert_allclose(r["ef"][k][1], total / n, atol=1e-7)
