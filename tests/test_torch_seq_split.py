"""``batch_matmul``'s sequence-length mask under a split of the masked
dim: each rank masks its block of the sequence by the global index
(ops/attention.py ``BatchMatmulOp._seq_mask``), with
``FFConfig(iteration=IterationConfig(seq_length=SEQ_K))`` cutting
inside a block.

Each case is one ``batch_matmul`` under a view over 4 ranks of
tests/test_torch_fleet.py's gloo world (``_fleet_rank`` calls
``seq_split_rank_legs``):

* the rows (``a_seq_length_dim``) split (1, 4, 1);
* the columns (``b_seq_length_dim``) split (1, 1, 4);
* the contraction, masked on both inputs, split 4 ways as partial sums
  (replica degree 4).

Checked for each: the output and both inputs' gradients within fp32
1e-5 of the JAX package's run of the same view on its virtual CPU
devices, and of one process.

The rank function imports no JAX: the ranks import this module, whose
JAX imports are inside the reference's functions."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as tff
from flexflow_tpu_torch.core.machine import MachineView

from test_torch_fleet import fleet_world  # noqa: F401  (the shared world)

N = 4
TOL = 1e-5
B, S, K = 2, 8, 4
SEQ_K = 3  # blocks of 2 rows: the cut falls inside rank 1's block

# name -> (a's shape, b's shape, a_seq_length_dim, b_seq_length_dim,
#          output degrees, replica degree)
CASES = {
    "rows": ((B, S, K), (B, K, S), 1, 2, (1, 4, 1), 1),
    "columns": ((B, S, K), (B, K, S), 1, 2, (1, 1, 4), 1),
    "contraction": ((B, K, S), (B, S, K), 2, 1, (1, 1, 1), 4),
}


def _model(pkg, cfg, name):
    sa, sb, da, db, _, _ = CASES[name]
    m = pkg.FFModel(cfg)
    a = m.create_tensor(list(sa), name="a")
    b = m.create_tensor(list(sb), name="b")
    m.batch_matmul(a, b, a_seq_length_dim=da, b_seq_length_dim=db,
                   name="bmm")
    return m


def _views(model, name, view_cls):
    *_, degs, r = CASES[name]
    return {n.guid: (view_cls(degs, replica_degree=r) if n.op.name == "bmm"
                     else view_cls.trivial(n.op.output_shapes[0].ndim))
            for n in model.graph.topo_order()}


def _data(name):
    sa, sb, *_ = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    return (rng.normal(size=sa).astype(np.float32),
            rng.normal(size=sb).astype(np.float32),
            rng.normal(size=(B, sa[1], sb[2])).astype(np.float32))


def _port_run(name, n):
    """(output, a's gradient, b's gradient) of the case on ``n`` ranks
    (one process when n is 1), numpy: it crosses ranks."""
    m = _model(tff, tff.FFConfig(
        batch_size=B, device="cpu", num_devices=n, compute_dtype="float32",
        iteration=tff.IterationConfig(seq_length=SEQ_K)), name)
    m.compile(strategy=_views(m, name, MachineView) if n > 1 else {},
              loss_type="mean_squared_error", metrics=[])
    a, b, cot = _data(name)
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    y, _ = m.compiled.apply(m.params, m.state, [ta, tb], train=True)
    mine = torch.from_numpy(cot)[tuple(m.compiled._sink_pl.local_slices(
        cot.shape, m.compiled.mesh))]
    y.backward(mine)
    return (m.compiled.gather_output(y.detach()).numpy(), ta.grad.numpy(),
            tb.grad.numpy())


def seq_split_rank_legs():
    """Every case on this rank of a world of 4 (a rank function of
    tests/test_torch_fleet.py calls it)."""
    return {name: _port_run(name, N) for name in CASES}


def _reference_run(name):
    """The JAX package's op under the same view on 4 virtual devices:
    (output, a's gradient, b's gradient)."""
    import jax
    import jax.numpy as jnp

    import flexflow_tpu as ff
    from flexflow_tpu.core.machine import MachineView as RefView

    m = _model(ff, ff.FFConfig(batch_size=B, num_devices=N,
                               compute_dtype="float32",
                               iteration=ff.IterationConfig(
                                   seq_length=SEQ_K)), name)
    m.compile(strategy=_views(m, name, RefView),
              loss_type="mean_squared_error", metrics=[])
    a, b, cot = _data(name)

    def f(x, y):
        out, _ = m.compiled.apply(m.params, m.state, [x, y], None, False)
        return out

    out, vjp = jax.vjp(f, jnp.asarray(a), jnp.asarray(b))
    ga, gb = vjp(jnp.asarray(cot))
    return np.asarray(out), np.asarray(ga), np.asarray(gb)


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_seq_mask_matches_the_reference(fleet_world, name):
    ranks, _ = fleet_world
    want = _reference_run(name)
    one = _port_run(name, 1)
    for rank, r in enumerate(ranks):
        for what, got, ref, single in zip(("out", "a_grad", "b_grad"),
                                          r["seq_split"][name], want, one):
            np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} rank {rank} {what}")
            np.testing.assert_allclose(got, single, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} rank {rank} {what}")
    out = want[0]
    if name != "contraction":  # the masked rows and columns are zero
        assert not out[:, SEQ_K:, :].any() and not out[:, :, SEQ_K:].any()
