"""Dropout in the port against the JAX package, and the port's own mask
draw.

1. ``attn_core_dropout`` against the reference's ``_attn_core_dropout``
   given one numpy mask: output and the q, k, v gradients within 1e-6
   in fp32, causal and not.
2. A model with an MHA (attention dropout 0.1) and a ``DropoutOp``
   (rate 0.2) trains 3 steps in both packages from the JAX model's
   weights.  The masks are the reference's own: the test draws them in
   JAX with the reference's key chain (``jax.random.key(step)``, then
   ``op_rng``'s ``fold_in(key, hash(op_name) & 0x7FFFFFFF)``, then
   ``bernoulli``) and hands them to the port through
   ``LoweringContext.mask_source``; the parity tests pin the salted
   ``hash`` to crc32 on both sides (``pin_reference_masks``), so every
   interpreter trains on the same masks.  Losses and weights within
   1e-5 (fp32).
3. The port's draw (ops/base.py): the kept fraction of 1e6 draws is
   within 4 sigma of ``keep``; two steps, and two ops, draw different
   masks; one (seed, op) draws the same mask twice; a rank's block of a
   batch or head split, and a microbatch's rows, equal those rows of
   the one-process mask; two interpreters with different
   ``PYTHONHASHSEED`` draw the same mask (the reference's salted
   ``hash(op_name)`` does not: ROADMAP, reference-side oddities).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.ops import base as jax_base
from flexflow_tpu.core.machine import MachineView as JView
from flexflow_tpu.kernels.flash_attention import (
    _attn_core_dropout as jax_attn_core_dropout,
)
import flexflow_tpu_torch as tff
from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
from flexflow_tpu_torch.kernels.flash_attention import attn_core_dropout
from flexflow_tpu_torch.ops.base import (
    LoweringContext,
    draw_keep_mask,
    stream_key,
)

ROOT = Path(__file__).resolve().parent.parent
KEEP = 0.9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def salted_fold(op_name: str) -> int:
    """What the reference's ``op_rng`` folds into the step key: this
    interpreter's salted ``hash`` of the op's name."""
    return hash(op_name) & 0x7FFFFFFF


def pinned_fold(op_name: str) -> int:
    """The same key, pinned: crc32 of the name, as the port's
    ``op_key``, the same in every interpreter."""
    return zlib.crc32(op_name.encode()) & 0x7FFFFFFF


def reference_mask(seed: int, op_name: str, shape, keep: float,
                   split: int = 1, part: int = 0,
                   fold=salted_fold) -> torch.Tensor:
    """The reference's mask for ``op_name`` at step key
    ``jax.random.key(seed)`` (part ``part`` of ``split`` under gradient
    accumulation, whose microbatches take ``jax.random.split``'s
    keys)."""
    key = jax.random.key(seed)
    if split > 1:
        key = jax.random.split(key, split)[part]
    key = jax.random.fold_in(key, fold(op_name))
    return torch.from_numpy(np.array(jax.random.bernoulli(key, keep,
                                                          tuple(shape))))


def reference_masks(ga: int = 1, fold=salted_fold):
    """A ``LoweringContext.mask_source`` that hands the port the
    reference's masks (module docstring)."""
    def source(ctx, op_name, shape, keep):
        part = ctx.row_base // shape[0] if ga > 1 else 0
        return reference_mask(int(ctx.seed), op_name, shape, keep, ga, part,
                              fold)
    return source


def pin_reference_masks(monkeypatch):
    """Key the reference's draws by ``pinned_fold`` for this test (its
    ``op_rng`` patched) and hand the port the same masks.  With the
    salted key each interpreter trains on other masks, and a parity
    test's result then depends on the interpreter: tests/test_torch_zoo's
    AlexNet, 3 SGD steps at fp32 1e-5, was off by up to 7.5x its
    tolerance under 4 of 12 ``PYTHONHASHSEED`` values (a ReLU or pool
    flip in one step, the libraries' summation orders), alone and in
    the whole suite alike."""
    def op_rng(self, op_name):
        if self.rng is None:
            return jax.random.key(0)
        return jax.random.fold_in(self.rng, pinned_fold(op_name))

    monkeypatch.setattr(jax_base.LoweringContext, "op_rng", op_rng)
    monkeypatch.setattr(LoweringContext, "mask_source",
                        reference_masks(fold=pinned_fold))


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True])
def test_attn_core_dropout_matches_the_reference(causal):
    rng = np.random.default_rng(0)
    b, sq, sk, h, d = 2, 12, 12, 3, 8
    q, k, v, g = (rng.normal(size=s).astype(np.float32)
                  for s in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d),
                            (b, sq, h, d)))
    mask = rng.random((b, h, sq, sk)) < KEEP
    scale = 1.0 / np.sqrt(d)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = attn_core_dropout(tq, tk, tv, torch.from_numpy(mask), causal,
                            scale, KEEP)
    out.backward(torch.from_numpy(g))

    def f(q_, k_, v_):
        y = jax_attn_core_dropout(q_, k_, v_, jnp.asarray(mask), causal,
                                  float(scale), KEEP)
        return jnp.sum(y * g), y

    (_, jy), jg = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, ref in ((out, jy), (tq.grad, jg[0]), (tk.grad, jg[1]),
                     (tv.grad, jg[2])):
        ref = np.asarray(ref)
        err = np.abs(got.detach().numpy() - ref).max()
        assert err <= 1e-6 * max(np.abs(ref).max(), 1.0), err


# ---------------------------------------------------------------------------
def _dropout_model(pkg, cfg):
    m = pkg.FFModel(cfg)
    x = m.create_tensor([cfg.batch_size, 8, 16], name="feat")
    t = m.multihead_attention(x, x, x, embed_dim=16, num_heads=2,
                              dropout=1.0 - KEEP, name="dmha")
    t = m.dropout(t, rate=0.2, name="drop")
    m.dense(t, 16, name="dhead")
    return m


def test_mha_and_dropout_op_train_like_the_reference(monkeypatch):
    mse = dict(loss_type="mean_squared_error",
               metrics=["mean_squared_error"])
    jm = _dropout_model(ff, ff.FFConfig(batch_size=4, num_devices=1,
                                        compute_dtype="float32",
                                        cost_cache_file=""))
    jm.compile(optimizer=ff.AdamOptimizer(alpha=1e-2),
               strategy={n.guid: JView.trivial(n.op.output_shapes[0].ndim)
                         for n in jm.graph.topo_order()}, **mse)
    pm = _dropout_model(tff, tff.FFConfig(batch_size=4, device="cpu",
                                          compute_dtype="float32"))
    pm.compile(optimizer=tff.AdamOptimizer(alpha=1e-2), **mse)
    pm.params = params_from_numpy({op: {w: np.array(v) for w, v in ws.items()}
                                   for op, ws in jm.params.items()})
    pm.opt_state = pm.optimizer.init_state(pm.params)
    pin_reference_masks(monkeypatch)
    rng = np.random.default_rng(1)
    for step in (1, 2, 3):
        x = rng.normal(size=(4, 8, 16)).astype(np.float32)
        y = rng.normal(size=(4, 8, 16)).astype(np.float32)
        jm.params, jm.opt_state, jm.state, jl, _ = jm.compiled.train_step(
            jm.params, jm.opt_state, jm.state, jax.random.key(step),
            [jnp.asarray(x)], jnp.asarray(y))
        pm.params, pm.opt_state, pm.state, pl, _ = pm.compiled.train_step(
            pm.params, pm.opt_state, pm.state, [torch.from_numpy(x)],
            torch.from_numpy(y), seed=step)
        assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl))
    got = params_to_numpy(pm.params)
    for op, ws in jm.params.items():
        for w, v in ws.items():
            np.testing.assert_allclose(got[op][w], np.asarray(v), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{op}/{w}")
    # without the source the port draws its own masks: another loss
    monkeypatch.setattr(LoweringContext, "mask_source", None)
    *_, own, _ = pm.compiled.train_step(
        pm.params, pm.opt_state, pm.state, [torch.from_numpy(x)],
        torch.from_numpy(y), seed=4)
    assert np.isfinite(float(own))


@pytest.mark.parametrize("rates", [(0.1, 0.0), (0.0, 0.2), (0.0, 0.0)])
def test_a_step_without_a_seed_raises_only_with_dropout(rates):
    """With a dropout op or attention dropout, a step needs its own seed
    (one default seed would draw the same masks every step); without
    dropout it runs unseeded."""
    attn, rate = rates
    m = tff.FFModel(tff.FFConfig(batch_size=2, device="cpu",
                                 compute_dtype="float32"))
    x = m.create_tensor([2, 8, 16], name="feat")
    t = m.multihead_attention(x, x, x, embed_dim=16, num_heads=2,
                              dropout=attn, name="mha")
    m.dense(m.dropout(t, rate=rate, name="drop"), 16, name="head")
    m.compile(optimizer=tff.SGDOptimizer(lr=0.1),
              loss_type="mean_squared_error")
    c, rng = m.compiled, np.random.default_rng(0)
    ins = [torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))]
    lab = torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
    if attn or rate:
        with pytest.raises(ValueError, match="own seed"):
            c.train_step(m.params, m.opt_state, m.state, ins, lab)
        with pytest.raises(ValueError, match="own seed"):
            c.train_steps(m.params, m.opt_state, m.state, [ins[0][None]],
                          lab[None])
        *_, loss, _ = c.train_step(m.params, m.opt_state, m.state, ins, lab,
                                   seed=1)
    else:
        *_, loss, _ = c.train_step(m.params, m.opt_state, m.state, ins, lab)
    assert np.isfinite(float(loss))


# ---------------------------------------------------------------------------
def _mask(seed, op, shape, starts=None, local=None):
    key = stream_key(torch.tensor(seed, dtype=torch.int64), op)
    return draw_keep_mask(key, KEEP, shape, starts or (0,) * len(shape),
                          local or shape)


def test_keep_fraction_within_four_sigma():
    n = 1_000_000
    kept = float(_mask(7, "layer0_mha", (n,)).double().mean())
    sigma = np.sqrt(KEEP * (1 - KEEP) / n)
    assert abs(kept - KEEP) <= 4 * sigma, (kept, sigma)


def test_masks_differ_across_steps_and_ops_and_repeat_per_seed_and_op():
    shape = (4, 2, 16, 16)
    a = _mask(1, "layer0_mha", shape)
    assert torch.equal(a, _mask(1, "layer0_mha", shape))
    assert not torch.equal(a, _mask(2, "layer0_mha", shape))
    assert not torch.equal(a, _mask(1, "layer1_mha", shape))
    # different, and not merely shifted: agreement near keep^2 + drop^2
    agree = float((a == _mask(2, "layer0_mha", shape)).double().mean())
    assert abs(agree - (KEEP ** 2 + (1 - KEEP) ** 2)) < 0.05


@pytest.mark.parametrize("dim,parts", [(0, 2), (0, 4), (1, 2)])
def test_a_block_is_its_rows_of_the_one_process_mask(dim, parts):
    """A rank's block (batch split: dim 0; head split: dim 1), or a
    microbatch's rows under gradient accumulation (dim 0 with the
    offset a ``row_base`` adds), equals those rows of the whole mask."""
    shape = (8, 4, 16, 16)
    whole = _mask(3, "layer2_mha", shape)
    per = shape[dim] // parts
    for p in range(parts):
        starts = [0, 0, 0, 0]
        starts[dim] = p * per
        local = list(shape)
        local[dim] = per
        block = _mask(3, "layer2_mha", shape, starts, local)
        assert torch.equal(block, whole.narrow(dim, p * per, per))


def test_row_base_offsets_a_microbatch():
    """``LoweringContext.dropout_mask`` adds ``row_base`` to dim 0."""
    shape = (8, 2, 8, 8)
    seed = torch.tensor(5, dtype=torch.int64)
    whole = LoweringContext(seed=seed).dropout_mask(
        "m", KEEP, shape, (0, 0, 0, 0), shape)
    micro = LoweringContext(seed=seed, row_base=4).dropout_mask(
        "m", KEEP, shape, (0, 0, 0, 0), (4, 2, 8, 8))
    assert torch.equal(micro, whole[4:])


def test_the_draw_ignores_the_interpreters_hash_seed():
    code = ("import hashlib, torch\n"
            "from flexflow_tpu_torch.ops.base import draw_keep_mask, "
            "stream_key\n"
            "k = stream_key(torch.tensor(11), 'layer0_mha')\n"
            "m = draw_keep_mask(k, 0.9, (2, 2, 8, 8), (0, 0, 0, 0), "
            "(2, 2, 8, 8))\n"
            "print(hash('layer0_mha'), hashlib.sha1(m.numpy().tobytes())"
            ".hexdigest())\n")
    outs = []
    for hs in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hs,
                   PYTHONPATH=str(ROOT))
        got = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert got.returncode == 0, got.stderr
        outs.append(got.stdout.split())
    assert outs[0][0] != outs[1][0]  # the salted hash differs
    assert outs[0][1] == outs[1][1]  # the mask does not
    local = _mask(11, "layer0_mha", (2, 2, 8, 8))
    assert hashlib.sha1(local.numpy().tobytes()).hexdigest() == outs[0][1]
