"""The port's compressed and staged collectives (``flexflow_tpu_torch/
comm/``) against the JAX package's ``flexflow_tpu/comm/`` on the same
numpy inputs: the port on gloo worlds of 2 and 4 CPU ranks, the
reference under ``shard_map`` on as many virtual CPU devices, each rank
or device holding its own addend.

* ``quantize_chunked``: codes and scales equal the reference's.
* ``quantized_allreduce`` (int8, bf16) and ``quantized_allreduce_ef``:
  every element within one output quantum of the reference's (the
  int8 output chunk's scale, the bf16 output's unit in the last place):
  the owner's fp32 sum of the dequantized shards may round its last
  bit differently from XLA's reduction, and the requantization can
  then move a code by one.  Both within ``allreduce_error_bound`` of
  the exact sum; the EF residuals equal the reference's.
* fp32: the sum within 1e-6 of the reference's psum.
* ``comm.compat.reduce_scatter`` (gloo has none: an all-to-all and a
  local sum in rank order) equals the numpy sum of the blocks in rank
  order, bit for bit.
* ``staged_allreduce`` on a two-level machine (two hosts of two ranks):
  fp32 within 1e-6 of the sum, int8 within the flat bound, both within
  one quantum of the reference's; ``plan_axis_groups`` and
  ``mesh_axis_spans`` equal.
* The int8 wire moves (1 + 4/256) bytes per element each way where the
  fp32 all-reduce hands the transport 4 (``comm_counts()``).

The rank function imports no JAX: the spawned ranks import this module
to find it."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.runtime.distributed import spawn

from test_torch_worlds import shared_world

SHAPE = (3, 700)  # 2100 elements: padding in every chunking
CHUNK = 256


def _inputs(n):
    rng = np.random.default_rng(11 + n)
    xs = (rng.normal(size=(n,) + SHAPE) * rng.uniform(
        0.1, 3.0, size=(n, 1, 1))).astype(np.float32)
    rs = (rng.normal(size=(n,) + SHAPE) * 1e-3).astype(np.float32)
    return xs, rs


def _two_level(pkg_spec, n):
    """Two hosts of n / 2 ranks: the reference's ``tpu_v5e`` spec (both
    packages have it) with ``devices_per_host`` n / 2, so
    ``topology_levels()`` has a within-host and a cross-host level."""
    return dataclasses.replace(pkg_spec.tpu_v5e(n), devices_per_host=n // 2)


def _rank(rank, n, xs, rs):
    from flexflow_tpu_torch.comm import (
        compat,
        mesh_axis_spans,
        plan_axis_groups,
        quantized_allreduce,
        quantized_allreduce_ef,
        staged_allreduce,
    )
    from flexflow_tpu_torch.core.machine import MachineSpec
    from flexflow_tpu_torch.parallel import mesh as pmesh
    from flexflow_tpu_torch.runtime import distributed

    mesh = distributed.mesh()
    axes = mesh.names
    x, r = torch.from_numpy(xs[rank]), torch.from_numpy(rs[rank])
    out = {}
    for prec in ("fp32", "bf16", "int8"):
        pmesh.reset_comm_counts()
        out[prec] = quantized_allreduce(x, axes, mesh, prec).numpy()
        out[prec + "_counts"] = pmesh.comm_counts()
    y, nr = quantized_allreduce_ef(x, r, axes, mesh, "int8")
    out["ef"], out["ef_residual"] = y.numpy(), nr.numpy()
    out["rs"] = compat.reduce_scatter(x.reshape(-1)[:2048], axes,
                                      mesh).numpy()
    spec = _two_level(MachineSpec, n)
    st_axes, st_sizes = plan_axis_groups(axes, mesh, spec, 1)
    out["groups"] = (st_axes, st_sizes, mesh_axis_spans(mesh))
    for prec in ("fp32", "int8"):
        out["staged_" + prec] = staged_allreduce(
            x, st_axes, st_sizes, prec, mesh).numpy()
    return out


def _reference(n, xs, rs):
    """The JAX package's collectives under shard_map on n virtual
    devices, each device one addend."""
    import jax
    from jax.sharding import PartitionSpec as P

    from flexflow_tpu.comm import (
        plan_axis_groups,
        quantized_allreduce,
        quantized_allreduce_ef,
        shard_map,
        staged_allreduce,
    )
    from flexflow_tpu.comm.hierarchical import mesh_axis_spans
    from flexflow_tpu.core.machine import MachineSpec
    from flexflow_tpu.parallel.mesh import build_mesh

    mesh = build_mesh(jax.devices()[:n])
    axes = tuple(mesh.axis_names)

    def run(fn, *arrays):
        return np.asarray(shard_map(
            lambda *a: fn(*[v[0] for v in a]), mesh=mesh,
            in_specs=tuple(P(axes) for _ in arrays), out_specs=P(),
        )(*arrays))

    out = {}
    for prec in ("fp32", "bf16", "int8"):
        out[prec] = run(lambda x, p=prec: quantized_allreduce(
            x, axes, precision=p, axis_size=n), xs)
    out["ef"] = run(lambda x, r: quantized_allreduce_ef(
        x, r, axes, precision="int8", axis_size=n)[0], xs, rs)
    st_axes, st_sizes = plan_axis_groups(axes, mesh,
                                         _two_level(MachineSpec, n), 1)
    out["groups"] = (st_axes, st_sizes, mesh_axis_spans(mesh))
    for prec in ("fp32", "int8"):
        out["staged_" + prec] = run(
            lambda x, p=prec: staged_allreduce(x, st_axes, st_sizes, p), xs)
    return out


@pytest.fixture(scope="module", params=(2, 4))
def world(request, tmp_path_factory):
    n = request.param
    xs, rs = _inputs(n)

    def compute():
        rdzv = tmp_path_factory.mktemp(f"comm{n}") / "rendezvous"
        return spawn(_rank, n, (n, xs, rs), init_method=f"file://{rdzv}",
                     device="cpu", timeout=300), _reference(n, xs, rs)

    ranks, ref = shared_world(tmp_path_factory, f"torch_comm_{n}", compute)
    return n, xs, rs, ranks, ref


def _quantum(ref, prec):
    """One output quantum per element of the reference's output: its
    int8 chunk's scale (the chunk's largest magnitude over 127), or the
    bf16 unit in the last place."""
    flat = ref.reshape(-1).astype(np.float64)
    if prec == "bf16":
        mag = np.maximum(np.abs(flat), np.finfo(np.float32).tiny)
        return (2.0 ** (np.floor(np.log2(mag)) - 7)).reshape(ref.shape)
    pad = (-flat.size) % CHUNK
    blocks = np.concatenate([flat, np.zeros(pad)]).reshape(-1, CHUNK)
    scale = np.abs(blocks).max(axis=1, keepdims=True) / 127.0
    return np.broadcast_to(scale, blocks.shape).reshape(-1)[
        :flat.size].reshape(ref.shape)


def test_quantize_chunked_equals_the_reference():
    import jax.numpy as jnp

    from flexflow_tpu.comm import dequantize_chunked as ref_dq
    from flexflow_tpu.comm import quantize_chunked as ref_q
    from flexflow_tpu_torch.comm import dequantize_chunked, quantize_chunked

    rng = np.random.default_rng(3)
    x = (rng.normal(size=(5, 333)) * 2.0).astype(np.float32)
    x[0, :CHUNK] = 0.0  # an all-zero chunk: scale 1, exact round trip
    for chunk in (64, CHUNK):
        q, s = quantize_chunked(torch.from_numpy(x), chunk)
        rq, rsc = ref_q(jnp.asarray(x), chunk)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rsc))
        back = dequantize_chunked(q, s, x.size, x.shape).numpy()
        np.testing.assert_array_equal(
            back, np.asarray(ref_dq(rq, rsc, x.size, x.shape)))
        assert np.abs(back - x).max() <= np.abs(x).max() / 254.0 + 1e-7


@pytest.mark.parametrize("prec", ("int8", "bf16"))
def test_compressed_allreduce_within_one_quantum_and_the_bound(world, prec):
    from flexflow_tpu.comm import allreduce_error_bound as ref_bound
    from flexflow_tpu_torch.comm import allreduce_error_bound

    n, xs, _, ranks, ref = world
    want = xs.astype(np.float64).sum(axis=0)
    bound = allreduce_error_bound(list(xs), prec)
    assert bound == ref_bound(list(xs), prec)
    quantum = _quantum(ref[prec], prec)
    for r in ranks:
        np.testing.assert_array_equal(r[prec], ranks[0][prec])
        assert np.all(np.abs(r[prec] - ref[prec]) <= quantum * 1.0001), (
            float(np.max(np.abs(r[prec] - ref[prec]) / quantum)))
        assert float(np.max(np.abs(r[prec] - want))) <= bound
    assert float(np.max(np.abs(ref[prec] - want))) <= bound


def test_error_feedback_equals_the_reference(world):
    n, xs, rs, ranks, ref = world
    quantum = _quantum(ref["ef"], "int8")
    for i, r in enumerate(ranks):
        assert np.all(np.abs(r["ef"] - ref["ef"]) <= quantum * 1.0001)
        # the residual is the rank's own entry error: (x + r) less its
        # int8 round trip, as the reference's
        from flexflow_tpu.comm import dequantize_chunked, quantize_chunked

        carry = xs[i] + rs[i]
        q, s = quantize_chunked(carry)
        want = carry - np.asarray(dequantize_chunked(q, s, carry.size,
                                                     carry.shape))
        np.testing.assert_allclose(r["ef_residual"], want, atol=1e-7)


def test_fp32_sum_and_the_emulated_reduce_scatter(world):
    n, xs, _, ranks, ref = world
    np.testing.assert_allclose(ranks[0]["fp32"], ref["fp32"], rtol=1e-6,
                               atol=1e-6)
    flat = xs.reshape(n, -1)[:, :2048]
    total = flat[0].copy()
    for j in range(1, n):
        total = total + flat[j]  # fp32, in rank order
    for i, r in enumerate(ranks):
        per = 2048 // n
        np.testing.assert_array_equal(r["rs"], total[i * per:(i + 1) * per])


def test_staged_allreduce_equals_the_reference(world):
    from flexflow_tpu_torch.comm import allreduce_error_bound

    n, xs, _, ranks, ref = world
    got = ranks[0]
    assert got["groups"] == ref["groups"]
    want = xs.astype(np.float64).sum(axis=0)
    np.testing.assert_allclose(got["staged_fp32"], want, rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(got["staged_fp32"], ref["staged_fp32"],
                               rtol=1e-6, atol=1e-5)
    err = float(np.max(np.abs(got["staged_int8"] - want)))
    assert err <= allreduce_error_bound(list(xs), "int8")
    quantum = _quantum(ref["staged_int8"], "int8")
    assert np.all(np.abs(got["staged_int8"] - ref["staged_int8"])
                  <= quantum * 1.0001)
    for r in ranks:
        np.testing.assert_array_equal(r["staged_int8"], got["staged_int8"])


def test_the_int8_wire_moves_a_quarter_of_the_fp32_bytes(world):
    n, _, _, ranks, _ = world
    elems = int(np.prod(SHAPE))
    padded = elems + (-elems) % (n * CHUNK)
    wire = padded + padded // CHUNK * 4  # codes and scales
    c8, c32 = ranks[0]["int8_counts"], ranks[0]["fp32_counts"]
    assert c32["all_reduce_sum"]["bytes"] == 4 * elems
    assert c8["all_reduce_sum"]["calls"] == 0
    assert c8["all_to_all"]["bytes"] == wire
    assert c8["all_gather"]["bytes"] == wire // n


def test_replication_axes_equal_the_reference():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from flexflow_tpu.comm import replication_axes as ref_rep
    from flexflow_tpu.parallel.mesh import build_mesh
    from flexflow_tpu_torch.comm import replication_axes
    from flexflow_tpu_torch.parallel.mesh import Mesh, Placement

    rmesh = build_mesh(jax.devices()[:8])
    mesh = Mesh(8, 0, make_groups=False)
    for dims in (((), ()), (("x0",), ()), (("x1",), ("x0", "x2")),
                 (("x0", "x1", "x2"), ())):
        spec = P(*[d if d else None for d in dims])
        assert replication_axes(Placement(dims), mesh) == ref_rep(
            NamedSharding(rmesh, spec), rmesh)
