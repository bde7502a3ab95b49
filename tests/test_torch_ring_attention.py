"""The port's ring attention on gloo worlds of 2 and 4 CPU ranks
against the JAX package's ``ring_attention`` on the 8-device CPU mesh.

One world of each size is spawned per module (a spawn costs seconds);
every check of that size runs in it.  Rank r holds shard r of q, k and
v (tests/test_kernels.py's shapes: B 2, S 64, H 4, D 16, fp32) and
returns its output shard and the gradients of sum(out * out) with
respect to its shards; the test gathers them and holds them against the
reference's ring over the degree-2 axis ``x0`` or the degree-4 product
ring ``("x0", "x1")``: outputs at 2e-4 (tests/test_kernels.py:61),
gradients at 5e-4 (:383-402).  Measured: outputs 6.9e-7 and gradients
5.2e-6 at most over both worlds.

``ppermute`` is checked on its own: the forward delivers each rank's
tensor along the permutation, the backward returns each cotangent along
the inverse, and a pair (r, r) is a local copy that never reaches
torch.distributed.  The worker functions import no JAX: the spawned
ranks import this module to find them.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.runtime.distributed import spawn

B, S, H, D = 2, 64, 4, 16
CASES = [("contiguous", False), ("contiguous", True), ("zigzag", True)]
CASE_IDS = ["contiguous", "contiguous-causal", "zigzag-causal"]


def _qkv():
    """tests/test_kernels.py's ``qkv(B=2, S=64, H=4, D=16)``."""
    rng = np.random.default_rng(0)
    return [rng.normal(size=(B, S, H, D)).astype(np.float32)
            for _ in range(3)]


def _perms(n):
    """Permutations for the ppermute checks: the identity (all self
    pairs), the ring, and one mixing self pairs and sends (the zigzag
    exchange of the early halves)."""
    owner = [c if c < n else 2 * n - 1 - c for c in range(2 * n)]
    return {"identity": [(i, i) for i in range(n)],
            "ring": [(i, (i + 1) % n) for i in range(n)],
            "zigzag_a": [(i, owner[2 * i]) for i in range(n)]}


def _ring_rank(rank, q, k, v):
    """One rank: every schedule's output shard and gradients, then the
    ppermute checks with the p2p calls recorded."""
    import torch.distributed as dist

    from flexflow_tpu_torch.parallel.mesh import ppermute
    from flexflow_tpu_torch.parallel.ring_attention import ring_attention

    n = dist.get_world_size()
    per = S // n
    rows = slice(rank * per, (rank + 1) * per)
    out = {}
    for schedule, causal in CASES:
        ts = [torch.from_numpy(np.ascontiguousarray(a[:, rows]))
              .requires_grad_(True) for a in (q, k, v)]
        o = ring_attention(*ts, causal=causal, schedule=schedule)
        (o * o).sum().backward()
        out[(schedule, causal)] = (o.detach().numpy(),
                                   [t.grad.numpy() for t in ts])

    peers = []
    real = dist.batch_isend_irecv

    def recording(ops):
        peers.extend(op.peer for op in ops)
        return real(ops)

    dist.batch_isend_irecv = recording
    try:
        for name, perm in _perms(n).items():
            x = torch.full((3,), float(rank), requires_grad=True)
            (y,), _ = ppermute([x], perm)
            (y * (10.0 + rank)).sum().backward()
            out[name] = (y.detach().numpy(), x.grad.numpy(), list(peers))
            peers.clear()
    finally:
        dist.batch_isend_irecv = real
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    n = request.param
    rdzv = tmp_path_factory.mktemp(f"ring{n}") / "rendezvous"
    ranks = spawn(_ring_rank, n, _qkv(), init_method=f"file://{rdzv}",
                  device="cpu", timeout=300)
    return n, ranks


def _jax_ring(n, schedule, causal):
    """(output, gradients of sum(out * out)) of the reference's ring."""
    import jax
    import jax.numpy as jnp

    from flexflow_tpu.parallel.mesh import build_mesh
    from flexflow_tpu.parallel.ring_attention import ring_attention

    mesh = build_mesh(jax.devices()[:8])
    axes = "x0" if n == 2 else ("x0", "x1")
    q, k, v = map(jnp.asarray, _qkv())

    def f(q, k, v):
        return ring_attention(q, k, v, mesh, axes, causal=causal,
                              schedule=schedule)

    out = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_ring_matches_jax(world, case):
    n, ranks = world
    out = np.concatenate([r[case][0] for r in ranks], axis=1)
    grads = [np.concatenate([r[case][1][i] for r in ranks], axis=1)
             for i in range(3)]
    ref_out, ref_grads = _jax_ring(n, *case)
    np.testing.assert_allclose(out, ref_out, rtol=2e-4, atol=2e-4)
    for g, ref in zip(grads, ref_grads):
        np.testing.assert_allclose(g, ref, rtol=5e-4, atol=5e-4)


def test_ring_matches_plain_attention(world):
    """Every schedule against the port's own one-process attention."""
    from flexflow_tpu_torch.kernels.flash_attention import attn_core

    _, ranks = world
    for case in CASES:
        ts = [torch.from_numpy(a).requires_grad_(True) for a in _qkv()]
        ref = attn_core(*ts, case[1], 1.0 / math.sqrt(D))
        (ref * ref).sum().backward()
        out = np.concatenate([r[case][0] for r in ranks], axis=1)
        np.testing.assert_allclose(out, ref.detach().numpy(), rtol=2e-4,
                                   atol=2e-4)
        for i, t in enumerate(ts):
            g = np.concatenate([r[case][1][i] for r in ranks], axis=1)
            np.testing.assert_allclose(g, t.grad.numpy(), rtol=5e-4,
                                       atol=5e-4)


def test_ppermute_backward_is_its_inverse(world):
    """Rank r sends a vector of r's; it receives its source's, and the
    cotangent (10 + receiver) comes back to it from its destination."""
    n, ranks = world
    for name, perm in _perms(n).items():
        dst = dict(perm)
        src = {d: s for s, d in perm}
        for r, res in enumerate(ranks):
            y, grad, _ = res[name]
            np.testing.assert_array_equal(y, np.full(3, float(src[r])))
            np.testing.assert_array_equal(grad,
                                          np.full(3, 10.0 + dst[r]))


def test_self_pairs_never_reach_torch_distributed(world):
    n, ranks = world
    for name, perm in _perms(n).items():
        dst = dict(perm)
        for r, res in enumerate(ranks):
            peers = res[name][2]
            assert r not in peers, (name, r, peers)
            if dst[r] == r:
                assert peers == [], (name, r, peers)
            else:  # one send and one receive, forward and backward
                assert len(peers) == 4, (name, r, peers)
