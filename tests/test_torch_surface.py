"""The port's exported surface against the JAX package's.

* Every name each reference ``__init__.py`` exports (its ``__all__``
  or its lazy table) resolves in the port's counterpart, apart from
  ``JAX_ONLY``: JAX idioms with no counterpart, one reason each.
* ``FFConfig`` has the reference's fields with its defaults, plus
  ``device``; ``parse_args`` maps the reference's parallelism flags.
* ``FFConfig(iteration=IterationConfig(seq_length=k))`` masks
  ``batch_matmul``'s sequence tail as the reference does: the forward
  and both input gradients within fp32 1e-5 on the flat lowering (the
  pipelined lowering's leg runs in tests/test_torch_pipeline.py's world
  of 4, ``seq_mask_rank_leg``, against the reference's flat lowering).
* ``UniformInitializer`` draws in its bounds and repeats under a seed;
  ``NoOp`` is the identity with the reference's ``infer``.
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import importlib
import os

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as tff
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu_torch.config import FFConfig, IterationConfig

from test_torch_pipeline import world as pipeline_world  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_ONLY = {
    ("flexflow_tpu.comm", "shard_map"):
        "absorbs jax.shard_map's API drift between JAX versions",
    ("flexflow_tpu.comm", "force_cpu_devices"):
        "sets the number of JAX's virtual CPU devices; the port's ranks "
        "are processes",
    ("flexflow_tpu.parallel", "annot_partition_spec"):
        "returns a jax.sharding.PartitionSpec; the port's layout is "
        "parallel.mesh.placement's Placement",
    ("flexflow_tpu.parallel", "pipeline_spmd"):
        "the reference's lax.scan over stages on one program; the port "
        "runs GPipe over ranks (parallel.pipeline.pipeline_gpipe)",
}

# the port's default is one rank; the reference's 0 is every visible
# device, which the port takes as num_devices=0 too
DEFAULTS_THAT_DIFFER = {"num_devices": (0, 1)}


def _exported(path):
    """The names a package ``__init__.py`` exports: its ``__all__`` and
    its lazy table (or, without ``__all__``, what it imports)."""
    tree = ast.parse(open(path).read())
    names, lazy, imported = None, set(), set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if not isinstance(target, ast.Name):
                    continue
                if target.id == "__all__" and isinstance(
                        node.value, (ast.List, ast.Tuple)):
                    names = [e.value for e in node.value.elts
                             if isinstance(e, ast.Constant)]
                if target.id == "_LAZY" and isinstance(node.value, ast.Dict):
                    lazy |= {k.value for k in node.value.keys}
        if isinstance(node, ast.ImportFrom):
            imported |= {a.asname or a.name for a in node.names}
    out = set(names or ()) | lazy
    if names is None:
        out |= imported
    return sorted(out - {"__version__"})


REF_INITS = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "flexflow_tpu", "**",
                                    "__init__.py"), recursive=True))


@pytest.mark.parametrize("init", REF_INITS)
def test_every_reference_export_resolves_in_the_port(init):
    ref_mod = os.path.dirname(init).replace(os.sep, ".")
    port_mod = "flexflow_tpu_torch" + ref_mod[len("flexflow_tpu"):]
    port = importlib.import_module(port_mod)
    missing = []
    for name in _exported(os.path.join(ROOT, init)):
        if (ref_mod, name) in JAX_ONLY:
            assert not hasattr(port, name), (port_mod, name)
            continue
        if not hasattr(port, name):
            missing.append(name)
        elif name in getattr(port, "__all__", [name]):
            continue
        else:
            missing.append(f"{name} (not in __all__)")
    assert not missing, (port_mod, missing)


def test_kernels_flash_attention_is_the_module_of_the_wrapper():
    """The reference's ``kernels.flash_attention`` is its wrapper; the
    port's name is the module that holds the wrapper of that name, and
    stays the module once every port module is imported."""
    import flexflow_tpu_torch.compiler.graphs  # noqa: F401
    import flexflow_tpu_torch.kernels as kernels

    assert kernels.flash_attention.__name__ == (
        "flexflow_tpu_torch.kernels.flash_attention")
    assert callable(kernels.flash_attention.flash_attention)


def test_the_jax_only_names_are_still_the_references():
    """Each listed exclusion is a name the reference still exports."""
    for (mod, name) in JAX_ONLY:
        path = os.path.join(ROOT, *mod.split("."), "__init__.py")
        assert name in _exported(path), (mod, name)


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    return f.default_factory()


def _value(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def test_ffconfig_has_the_references_fields_and_defaults():
    ref = {f.name: f for f in dataclasses.fields(JConfig)}
    port = {f.name: f for f in dataclasses.fields(FFConfig)}
    assert set(port) == set(ref) | {"device"}
    for name, f in ref.items():
        want, got = _value(_default(f)), _value(_default(port[name]))
        if name in DEFAULTS_THAT_DIFFER:
            assert (want, got) == DEFAULTS_THAT_DIFFER[name], name
            continue
        assert got == want, name
    assert _default(port["device"]) == "cuda"
    assert dataclasses.asdict(IterationConfig()) == dataclasses.asdict(
        ff.IterationConfig())


@pytest.mark.parametrize("argv", [
    [], ["--enable-parameter-parallel"], ["--enable-attribute-parallel"],
    ["--enable-parameter-parallel", "--enable-attribute-parallel",
     "--only-data-parallel", "-b", "4"]])
def test_parse_args_sets_the_parallelism_flags_as_the_reference(argv):
    got, want = FFConfig.parse_args(argv), JConfig.parse_args(argv)
    for f in ("enable_parameter_parallel", "enable_attribute_parallel",
              "enable_inplace_optimizations", "only_data_parallel",
              "param_dtype", "perform_fusion", "batch_size"):
        assert getattr(got, f) == getattr(want, f), f
    assert _value(got.iteration) == _value(want.iteration)


def test_the_accepted_fields_construct():
    cfg = FFConfig(device="cpu", enable_parameter_parallel=False,
                   enable_attribute_parallel=False,
                   enable_inplace_optimizations=False,
                   param_dtype="bfloat16", perform_fusion=False,
                   iteration=IterationConfig(seq_length=3))
    assert not cfg.enable_parameter_parallel
    assert cfg.iteration.seq_length == 3


# ---- batch_matmul's sequence-length mask ---------------------------------
B, S, K = 2, 6, 5


def _bmm_model(pkg, cfg_cls, iteration, **extra):
    m = pkg.FFModel(cfg_cls(batch_size=B, compute_dtype="float32",
                            iteration=iteration, **extra))
    a = m.create_tensor([B, S, K], name="a")
    b = m.create_tensor([B, K, S], name="b")
    m.batch_matmul(a, b, a_seq_length_dim=1, b_seq_length_dim=2, name="bmm")
    return m


def _bmm_inputs():
    rng = np.random.default_rng(3)
    return (rng.normal(size=(B, S, K)).astype(np.float32),
            rng.normal(size=(B, K, S)).astype(np.float32),
            rng.normal(size=(B, S, S)).astype(np.float32))


def _reference_bmm(k, a, b, cot):
    import jax
    import jax.numpy as jnp

    m = _bmm_model(ff, ff.FFConfig, ff.IterationConfig(seq_length=k),
                   num_devices=1)
    m.compile(loss_type="mean_squared_error", metrics=[])

    def f(x, y):
        out, _ = m.compiled.apply(m.params, m.state, [x, y], None, False)
        return out

    out, vjp = jax.vjp(f, jnp.asarray(a), jnp.asarray(b))
    ga, gb = vjp(jnp.asarray(cot))
    return np.asarray(out), np.asarray(ga), np.asarray(gb)


@pytest.mark.parametrize("k", [-1, 1, 4, S])
def test_seq_length_masks_batch_matmul_as_the_reference(k):
    a, b, cot = _bmm_inputs()
    m = _bmm_model(tff, FFConfig, IterationConfig(seq_length=k),
                   device="cpu")
    m.compile(loss_type="mean_squared_error", metrics=[])
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out, _ = m.compiled.apply(m.params, m.state, [ta, tb], train=True)
    out.backward(torch.from_numpy(cot))
    want = _reference_bmm(k, a, b, cot)
    for got, ref in zip((out.detach(), ta.grad, tb.grad), want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    if 0 < k < S:  # the tail is masked: its rows and columns are zero
        assert not out.detach()[:, k:, :].any()
        assert not out.detach()[:, :, k:].any()
        assert not ta.grad[:, k:].any() and not tb.grad[:, :, k:].any()


# the pipelined lowering's leg: tests/test_torch_pipeline.py's world of
# 4 runs seq_mask_rank_leg (pp 2 x dp 2, 2 microbatches)
PIPE_BATCH, PIPE_SEQ, PIPE_D, PIPE_K = 8, 6, 8, 4


def seq_mask_model(pkg, cfg_cls, n, **extra):
    """Two blocks of ``h = dense(x)``, ``s = bmm(h, h^T)`` masked on the
    sequence and ``x = bmm(s, h)`` masked on the contraction, then a
    head; ``iteration.seq_length`` = ``PIPE_K``."""
    m = pkg.FFModel(cfg_cls(
        batch_size=PIPE_BATCH, compute_dtype="float32", num_devices=n,
        iteration=pkg.IterationConfig(seq_length=PIPE_K), **extra))
    x = m.create_tensor([PIPE_BATCH, PIPE_SEQ, PIPE_D], name="x")
    for i in range(2):
        h = m.dense(x, PIPE_D, activation="tanh", name=f"layer{i}_proj")
        t = m.transpose(h, [0, 2, 1], name=f"layer{i}_t")
        s = m.batch_matmul(h, t, a_seq_length_dim=1, b_seq_length_dim=2,
                           name=f"layer{i}_scores")
        x = m.batch_matmul(s, h, a_seq_length_dim=2, b_seq_length_dim=1,
                           name=f"layer{i}_mix")
    m.dense(x, PIPE_D, name="head")
    return m


def seq_mask_data():
    rng = np.random.default_rng(9)
    return (rng.normal(size=(PIPE_BATCH, PIPE_SEQ, PIPE_D)).astype(
                np.float32) * 0.5,
            rng.normal(size=(PIPE_BATCH, PIPE_SEQ, PIPE_D)).astype(
                np.float32))


def seq_mask_rank_leg(start):
    """One pipelined training step (pp 2 x dp 2, 2 microbatches) of
    ``seq_mask_model`` from ``start``: (loss, whole weights)."""
    from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
    from flexflow_tpu_torch.parallel.pipeline import PipelineConfig

    m = seq_mask_model(tff, FFConfig, 4, device="cpu")
    m.compile(optimizer=tff.SGDOptimizer(lr=0.1),
              pipeline=PipelineConfig(num_stages=2, num_microbatches=2),
              loss_type="mean_squared_error", metrics=[])
    kind = type(m.compiled).__name__
    m.params = params_from_numpy(start, "cpu", m.compiled)
    x, y = seq_mask_data()
    c = m.compiled
    xs = [torch.from_numpy(x[c.input_slices(0, x.shape)])]
    ys = torch.from_numpy(y[c.label_slices(y.shape)])
    m.params, m.opt_state, m.state, loss, _ = c.train_step(
        m.params, m.opt_state, m.state, xs, ys)
    return kind, float(loss), params_to_numpy(m.params, c)


def reference_seq_mask_step():
    """The reference's flat lowering, one device, the same step: (start
    weights, loss, weights after)."""
    import jax
    import jax.numpy as jnp

    m = seq_mask_model(ff, ff.FFConfig, 1)
    m.compile(optimizer=ff.SGDOptimizer(lr=0.1),
              loss_type="mean_squared_error", metrics=[])
    start = {op: {w: np.array(v) for w, v in ws.items()}
             for op, ws in m.params.items()}
    x, y = seq_mask_data()
    params, _, _, loss, _ = m.compiled.train_step(
        m.params, m.opt_state, m.state, jax.random.key(0),
        [jnp.asarray(x)], jnp.asarray(y))
    return start, float(loss), {op: {w: np.asarray(v) for w, v in ws.items()}
                                for op, ws in params.items()}


def test_seq_length_masks_the_pipelined_lowering_as_the_reference(
        pipeline_world):
    ranks, ref, _ = pipeline_world
    _, want_loss, want = ref["seq_mask"]
    for r in ranks:
        kind, loss, got = r["seq_mask"]
        assert kind == "PipelinedCompiledModel"
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss,
                                                                 want_loss)
        assert got.keys() == want.keys()
        for op, ws in want.items():
            for w, v in ws.items():
                np.testing.assert_allclose(got[op][w], v, rtol=1e-5,
                                           atol=1e-5, err_msg=f"{op}/{w}")


# ---- UniformInitializer and NoOp -----------------------------------------
@pytest.mark.parametrize("lo,hi", [(-0.05, 0.05), (0.5, 2.0), (-3.0, -1.0)])
def test_uniform_initializer_draws_in_its_bounds_and_repeats(lo, hi):
    init = tff.UniformInitializer(seed=3, min_val=lo, max_val=hi)
    draws = [init.init(torch.Generator().manual_seed(s), (64, 32))
             for s in (7, 7, 8)]
    assert draws[0].dtype == torch.float32
    assert float(draws[0].min()) >= lo and float(draws[0].max()) <= hi
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    # the draws fill the interval
    assert float(draws[0].max() - draws[0].min()) > 0.9 * (hi - lo)
    ref = ff.UniformInitializer(seed=3, min_val=lo, max_val=hi)
    assert (init.seed, init.min_val, init.max_val) == (
        ref.seed, ref.min_val, ref.max_val)


def test_uniform_initializer_initialises_a_dense_kernel():
    m = tff.FFModel(FFConfig(batch_size=4, device="cpu",
                             compute_dtype="float32"))
    x = m.create_tensor([4, 16], name="x")
    m.dense(x, 8, name="fc", kernel_initializer=tff.UniformInitializer(
        min_val=0.25, max_val=0.5))
    m.compile(loss_type="mean_squared_error", metrics=[])
    k = m.get_weight("fc", "kernel")
    assert k.min() >= 0.25 and k.max() <= 0.5


@pytest.mark.parametrize("shape", [(4,), (2, 3), (2, 3, 5)])
def test_noop_is_the_identity_with_the_references_infer(shape):
    from flexflow_tpu.core.ptensor import ParallelTensorShape as RefShape
    from flexflow_tpu.ops.inout import NoOp as RefNoOp

    from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
    from flexflow_tpu_torch.ops import NoOp

    op = NoOp("noop", [ParallelTensorShape.make(shape, "float32")])
    ref = RefNoOp("noop", [RefShape.make(shape, "float32")])
    assert op.output_shapes[0].sizes == ref.output_shapes[0].sizes
    assert op.op_type.value == ref.op_type.value
    assert op.splittable_output_dims() == ref.splittable_output_dims()
    x = torch.randn(shape)
    (y,) = op.forward(None, [x], {})
    assert y is x
