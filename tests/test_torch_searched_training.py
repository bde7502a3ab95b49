"""``compile(strategy=None)`` over ranks: the port runs the strategy
search as the JAX package's ``compile`` does and lowers what it finds,
on one gloo world of 4 CPU ranks against the JAX package on 4 virtual
devices with the same flags and machine spec (``tpu_v5e(4)``, no
deadline, both proposal flags False, and again with both on).

A tiny GPT (vocab 128, 2 layers, hidden 32, 4 heads, ff 64, seq 64,
batch 8) trains 2 ``fit`` steps in fp32 with Adam from the JAX model's
initial weights.  Checked: the port picks the JAX package's views (per
stable node digest) on a graph of the same ``stable_graph_digest``;
every rank holds one digest and one set of views (rank 0 searched and
sent them); the losses within 1e-5 relative of the JAX package's; a
compile over 4 ranks with FFConfig's default proposal flags (rank 0
also costs the pipeline and placement proposals) lowers the JAX
package's pick with its losses; ``objective="serve"`` on a training
compile raises on every rank (the reference's ValueError: the serve
currency prices a decode step, which has no backward); and an error of
rank 0's search raises on every rank.  The search on this spec splits the two
embeddings' channels 2 ways and the vocab head's 4 ways and keeps the
rest whole, so the lowering reshards between the splits.

The worker function imports no JAX: the spawned ranks import this
module to find it."""

from __future__ import annotations

import numpy as np
import pytest

import flexflow_tpu_torch as tff
from flexflow_tpu_torch.core.machine import MachineSpec
from flexflow_tpu_torch.interop import params_from_numpy
from flexflow_tpu_torch.models import build_gpt
from flexflow_tpu_torch.runtime.distributed import spawn
from flexflow_tpu_torch.search.cost_cache import stable_graph_digest

N = 4
BATCH = 8
STEPS = 2
ALPHA = 1e-3
GPT = dict(vocab=128, num_layers=2, hidden=32, num_heads=4, ff_dim=64,
           seq_len=64)
CCE = dict(loss_type="sparse_categorical_crossentropy", metrics=["accuracy"])
SEARCH = dict(search_timeout_s=0, enable_pipeline_search=False,
              enable_placement_search=False)


def views_by_digest(graph, strategy):
    digests = graph.stable_node_digests()
    out = {}
    for guid, v in strategy.items():
        out.setdefault(digests[guid], []).append(
            (tuple(v.dim_degrees), v.replica_degree))
    return {k: sorted(v) for k, v in out.items()}


def _data():
    rng = np.random.default_rng(7)
    ids = rng.integers(0, GPT["vocab"], size=(STEPS * BATCH,
                                              GPT["seq_len"] + 1))
    ids = ids.astype(np.int32)
    return ids[:, :-1], ids[:, 1:]


def _rank(rank, start, default_start, x, y):
    """One rank: the searched compile and 2 fit steps, the same with the
    default proposal flags, then compiles that must raise on every
    rank: ``objective="serve"`` on a training compile, and a search
    that fails on rank 0 alone."""
    cfg = tff.FFConfig(batch_size=BATCH, device="cpu", num_devices=N,
                       compute_dtype="float32",
                       machine_spec=MachineSpec.tpu_v5e(N), **SEARCH)
    m = build_gpt(cfg, **GPT)
    m.compile(optimizer=tff.AdamOptimizer(alpha=ALPHA), **CCE)
    out = {"digest": stable_graph_digest(m.graph),
           "views": views_by_digest(m.graph, m.strategy),
           "stats": m.search_stats}
    m.params = params_from_numpy(start, "cpu", m.compiled)
    m.fit(x, y, shuffle=False, verbose=False)
    out["losses"] = list(m.step_losses)
    d = build_gpt(tff.FFConfig(batch_size=BATCH, device="cpu", num_devices=N,
                               compute_dtype="float32",
                               machine_spec=MachineSpec.tpu_v5e(N),
                               search_timeout_s=0), **GPT)
    d.compile(optimizer=tff.AdamOptimizer(alpha=ALPHA), **CCE)
    d.params = params_from_numpy(default_start, "cpu", d.compiled)
    d.opt_state = d.optimizer.init_state(d.params)
    d.fit(x, y, shuffle=False, verbose=False)
    out["default_flags"] = {"kind": type(d.compiled).__name__,
                            "digest": stable_graph_digest(d.graph),
                            "views": views_by_digest(d.graph, d.strategy),
                            "losses": list(d.step_losses)}
    # a search option this compile refuses: every rank raises it
    out["serve"] = _compile_error(build_gpt(tff.FFConfig(
        batch_size=BATCH, device="cpu", num_devices=N,
        compute_dtype="float32", machine_spec=MachineSpec.tpu_v5e(N),
        objective="serve", **SEARCH), **GPT))
    # an error of rank 0's search alone (its optimize_strategy made to
    # raise on rank 0 only) reaches every rank instead of leaving them
    # waiting
    from flexflow_tpu_torch.search import driver

    search = driver.optimize_strategy
    if rank == 0:
        driver.optimize_strategy = _failing_search
    try:
        out["rank0_error"] = _compile_error(build_gpt(tff.FFConfig(
            batch_size=BATCH, device="cpu", num_devices=N,
            compute_dtype="float32", machine_spec=MachineSpec.tpu_v5e(N),
            **SEARCH), **GPT))
    finally:
        driver.optimize_strategy = search
    return out


def _failing_search(graph, config, return_graph=False):
    raise NotImplementedError("rank 0's search failed on purpose")


def _compile_error(model):
    """The message of the NotImplementedError or ValueError ``model``'s
    compile raises, or None when it compiles."""
    try:
        model.compile(optimizer=tff.AdamOptimizer(alpha=ALPHA), **CCE)
    except (NotImplementedError, ValueError) as e:
        return str(e)
    return None


def _jax_run(x, y, out, **flags):
    """The JAX package's compile(strategy=None) on 4 virtual devices and
    its 2 steps (with ``flags``, default: the proposal flags off); fills
    ``out``."""
    import jax
    import jax.numpy as jnp

    import flexflow_tpu as ff
    import flexflow_tpu.models as jmods
    from flexflow_tpu.core.machine import MachineSpec as RefSpec
    from flexflow_tpu.search.cost_cache import stable_graph_digest as digest

    jm = jmods.build_gpt(ff.FFConfig(
        batch_size=BATCH, num_devices=N, compute_dtype="float32",
        machine_spec=RefSpec.tpu_v5e(N), cost_cache_file="",
        **(flags or SEARCH)), **GPT)
    jm.compile(optimizer=ff.AdamOptimizer(alpha=ALPHA), **CCE)
    out["kind"] = type(jm.compiled).__name__
    out["digest"] = digest(jm.graph)
    out["views"] = views_by_digest(jm.graph, jm.strategy)
    out["start"] = {op: {w: np.array(v) for w, v in ws.items()}
                    for op, ws in jm.params.items()}
    params, opt, state = jm.params, jm.opt_state, jm.state
    losses = []
    for i in range(STEPS):
        rows = slice(i * BATCH, (i + 1) * BATCH)
        params, opt, state, loss, _ = jm.compiled.train_step(
            params, opt, state, jax.random.key(i),
            [jax.device_put(jnp.asarray(x[rows]),
                            jm.compiled.input_sharding(0))],
            jax.device_put(jnp.asarray(y[rows]),
                           jm.compiled.batch_sharding()))
        losses.append(float(loss))
    out["losses"] = losses


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    x, y = _data()
    ref, default = {}, {}
    _jax_run(x, y, ref)
    _jax_run(x, y, default, search_timeout_s=0)  # FFConfig's flags
    ref["default"] = default
    rdzv = tmp_path_factory.mktemp("searched") / "rendezvous"
    ranks = spawn(_rank, N, (ref["start"], default["start"], x, y),
                  init_method=f"file://{rdzv}", device="cpu", timeout=600)
    return ranks, ref


def test_searched_views_and_graph_equal_the_jax_package(world):
    ranks, ref = world
    r0 = ranks[0]
    assert r0["digest"] == ref["digest"]
    assert r0["views"] == ref["views"]
    # a mixed strategy, not plain data parallelism
    degrees = {v for vs in r0["views"].values() for v in vs}
    assert ((1, 1, 4), 1) in degrees and ((1, 1, 2), 1) in degrees, degrees
    assert r0["stats"]["search_seconds"] >= 0


def test_every_rank_holds_one_digest_and_one_strategy(world):
    ranks, _ = world
    assert len({r["digest"] for r in ranks}) == 1
    assert all(r["views"] == ranks[0]["views"] for r in ranks)
    assert all(r["stats"] == ranks[0]["stats"] for r in ranks)


def test_losses_match_the_jax_package(world):
    ranks, ref = world
    for r in ranks:
        assert len(r["losses"]) == STEPS
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)


def test_default_proposal_flags_over_ranks_raise_naming_item_8(world):
    """With FFConfig's defaults (both proposal flags on) the compile
    over 4 ranks runs the flat search and the proposals, as the JAX
    package's does, and lowers the JAX package's pick: the same
    lowering, graph and views, and the same losses from its weights.
    (The name is kept from the refusal this check replaced: the
    proposals are ported, ROADMAP Queue A item 8.)"""
    ranks, ref = world
    want = ref["default"]
    for r in ranks:
        got = r["default_flags"]
        assert got["kind"] == want["kind"]
        assert got["digest"] == want["digest"]
        assert got["views"] == want["views"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)


def test_unported_search_option_raises_on_every_rank(world):
    ranks, _ = world
    for r in ranks:
        msg = r["serve"]
        assert msg is not None and "objective='serve'" in msg, msg
        assert "requires comp_mode='inference'" in msg, msg


def test_rank0_search_error_raises_on_every_rank(world):
    ranks, _ = world
    for r in ranks:
        msg = r["rank0_error"]
        assert msg is not None and "failed on purpose" in msg, msg
