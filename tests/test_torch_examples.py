"""The port's example scripts (``flexflow_tpu_torch/examples/``) against
the reference's (``examples/``), in this process, at the CI sizes of
``tests/test_examples.py`` with ``-ll:tpu 1 --only-data-parallel`` and
``device="cpu"``.

* ``common``'s data helpers give the reference's arrays bit for bit.
* Every single-rank example but ``inception`` and ``pytorch_bert`` runs
  to its end, and its graph (op kinds, names and output shapes in
  topological order) equals the reference example's under the same
  argv; ``inception`` and ``pytorch_bert`` are held by their graphs
  alone (the port's run stops at ``compile`` too).  The reference's
  model is caught by wrapping ``flexflow_tpu.FFModel.compile``, which
  then stops the reference script: its compile builds XLA programs for
  minutes on a CPU (ResNet's), and under ``--only-data-parallel`` it
  lowers the graph as built.
* ``gpt``, ``transformer`` and ``mlp_unify`` train in fp32 from the
  reference's initial weights (``interop.params_from_numpy``): every
  step's loss within rtol 1e-5 of the reference's; ``transformer`` also
  at its card widths, cut to one layer.
* ``digits_accuracy`` reaches its 0.90 gate; the examples that need
  ``transformers``, TensorFlow or scikit-learn raise an ImportError
  naming the package when it is absent; a card config on a host
  without CUDA raises.
* ``staged_pipeline``'s search stages its stack on the card's machine
  spec (``h100_sxm(4)``, two hosts, 40 MB) as on the CPU's.
* ``placed_dlrm``, ``ulysses_sp`` and ``staged_pipeline`` run in
  ``tests/test_torch_fleet.py``'s gloo world of 4 (its rank function
  calls ``example_rank_legs``) and lower what the reference lowers on 4
  virtual devices: the same kind of lowering, stages and views.

Module level imports no JAX: the world's ranks import this module."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import sys
import traceback

import numpy as np
import pytest

import flexflow_tpu_torch as tff
from flexflow_tpu_torch.examples import common
from test_torch_fleet import fleet_world  # noqa: F401  (the shared world)

ONE = ["-ll:tpu", "1", "--only-data-parallel"]
# (example, argv): tests/test_examples.py's CI argv, one device
SINGLE = [
    ("alexnet", ["-b", "8", "-e", "1"]),
    ("mlp_unify", ["-b", "16", "-e", "1"]),
    ("transformer", ["-b", "4", "-e", "1"]),
    ("gpt", ["-b", "4", "-e", "1"]),
    ("dlrm", ["-b", "8", "-e", "1"]),
    ("xdl", ["-b", "8", "-e", "1"]),
    ("candle_uno", ["-b", "8", "-e", "1"]),
    ("moe", ["-b", "8", "-e", "1"]),
    ("keras_mnist_mlp", ["-b", "16", "-e", "1"]),
    ("pytorch_import", ["-b", "8", "-e", "1"]),
    ("resnet", ["-b", "4", "-e", "1"]),
    ("onnx_import", ["-b", "16", "-e", "1"]),
    ("tf_keras_import", ["-b", "8", "-e", "1"]),
    ("digits_accuracy", ["-b", "32", "-e", "12"]),
    ("keras_cifar10_cnn", ["-b", "16", "-e", "1"]),
    ("keras_reuters_mlp", ["-b", "16", "-e", "1"]),
]
GRAPH_ONLY = [("inception", ["-b", "2", "-e", "1"]),
              ("pytorch_bert", ["-b", "2", "-e", "1"])]
LOSSES = ("gpt", "transformer", "mlp_unify")
LOSS_RTOL = 1e-5
# over 4 ranks, without --only-data-parallel (the staged pick is the
# search's)
MULTI = [
    ("placed_dlrm", ["-b", "32", "-e", "1", "-ll:tpu", "4"]),
    ("ulysses_sp", ["-b", "8", "-e", "1", "-ll:tpu", "4"]),
    ("staged_pipeline", ["-b", "16", "-e", "1", "-ll:tpu", "4"]),
]


class _Stop(Exception):
    """Raised by a wrapped ``fit``/``compile`` to end a script there."""


def graph_signature(graph):
    return [(n.op.op_type.name, n.op.name,
             [tuple(s.sizes) for s in n.op.output_shapes])
            for n in graph.topo_order()]


def port_config(argv, **replaced):
    return dataclasses.replace(tff.FFConfig.parse_args(argv), device="cpu",
                               **replaced)


@contextlib.contextmanager
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers a
    conv net's threads would contend for the host's cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def run_port(name, argv, start=None, stop_at=None, **replaced):
    """The port's example ``name`` on the CPU (one torch thread); returns
    its FFModel.  ``start``: weights to train from (set as ``fit``
    begins); ``stop_at="compile"``: stop there and return the built
    model."""
    mod = importlib.import_module(f"flexflow_tpu_torch.examples.{name}")
    cfg = port_config(argv, **replaced)
    got = {}
    with pytest.MonkeyPatch.context() as mp, one_thread():
        if stop_at == "compile":
            def compile_(self, *a, **k):
                got["model"] = self
                raise _Stop

            mp.setattr(tff.FFModel, "compile", compile_)
        if start is not None:
            from flexflow_tpu_torch.interop import params_from_numpy

            fit = tff.FFModel.fit

            def fit_from(self, *a, **k):
                self.params = params_from_numpy(start, "cpu", self.compiled)
                self.opt_state = self.optimizer.init_state(self.params)
                return fit(self, *a, **k)

            mp.setattr(tff.FFModel, "fit", fit_from)
        try:
            out = mod.main(argv, cfg)
        except _Stop:
            return got["model"]
    return getattr(out, "ffmodel", out)


def run_reference(name, argv, stop_at="compile", fp32=False):
    """The reference's ``examples/<name>.py`` in this process under
    ``argv``: {"model"} caught at ``stop_at`` ("fit" or "compile"), or
    with ``stop_at=None`` trained to its end with {"start", "losses"}
    (its initial weights and every step's loss)."""
    import flexflow_tpu as ff

    got = {}
    with pytest.MonkeyPatch.context() as mp:
        if fp32:
            parse = ff.FFConfig.parse_args

            def parse_fp32(argv=None):
                cfg = parse(argv)
                cfg.compute_dtype = "float32"
                return cfg

            mp.setattr(ff.FFConfig, "parse_args", staticmethod(parse_fp32))
        if stop_at == "compile":
            def compile_(self, *a, **k):
                got["model"] = self
                raise _Stop

            mp.setattr(ff.FFModel, "compile", compile_)
        fit = ff.FFModel.fit

        def fit_(self, *a, **k):
            got["model"] = self
            if stop_at == "fit":
                raise _Stop
            got["start"] = {op: {w: np.array(v) for w, v in ws.items()}
                            for op, ws in self.params.items()}
            comp, losses = self.compiled, []
            step = comp.train_step

            def recorded(*a2, **k2):
                out = step(*a2, **k2)
                losses.append(float(out[3]))
                return out

            comp.train_step = recorded
            try:
                return fit(self, *a, **k)
            finally:
                got["losses"] = losses
                del comp.train_step

        mp.setattr(ff.FFModel, "fit", fit_)
        mp.setattr(sys, "argv", [f"{name}.py", *argv])
        with contextlib.suppress(_Stop):
            importlib.import_module(f"examples.{name}").main()
    return got


# ---- common.py ------------------------------------------------------------
def test_lm_sequence_data_is_bit_equal_to_the_reference():
    from examples import common as ref

    for args in ((16, 32, 512, 0), (5, 17, 97, 3)):
        for a, b in zip(common.lm_sequence_data(*args),
                        ref.lm_sequence_data(*args)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", ["dlrm", "transformer", "gpt"])
def test_synthetic_inputs_and_labels_are_bit_equal_to_the_reference(name):
    """On each side's built model."""
    from examples import common as ref

    argv = dict(SINGLE)[name] + ONE
    rm = run_reference(name, argv, stop_at="compile")["model"]
    pm = run_port(name, argv, stop_at="compile")
    for loss in ("sparse_categorical_crossentropy", "mean_squared_error"):
        got = common.synthetic_inputs(pm, 24) + [
            common.synthetic_labels(pm, 24, loss)]
        want = ref.synthetic_inputs(rm, 24) + [
            ref.synthetic_labels(rm, 24, loss)]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ---- the single-rank examples ---------------------------------------------
@pytest.mark.parametrize("name,argv", SINGLE, ids=[n for n, _ in SINGLE])
def test_example_runs_and_builds_the_reference_graph(name, argv):
    argv = argv + ONE
    pm = run_port(name, argv)
    assert pm.compiled is not None and pm.step_losses
    assert np.isfinite(pm.step_losses).all()
    ref = run_reference(name, argv)["model"]
    assert graph_signature(pm.graph) == graph_signature(ref.graph)


@pytest.mark.parametrize("name,argv", GRAPH_ONLY,
                         ids=[n for n, _ in GRAPH_ONLY])
def test_graph_only_example_builds_the_reference_graph(name, argv):
    argv = argv + ONE
    pm = run_port(name, argv, stop_at="compile")
    ref = run_reference(name, argv, stop_at="compile")["model"]
    assert graph_signature(pm.graph) == graph_signature(ref.graph)


@pytest.mark.parametrize("name", LOSSES)
def test_losses_equal_the_reference_from_its_weights(name):
    argv = dict(SINGLE)[name] + ONE
    ref = run_reference(name, argv, stop_at=None, fp32=True)
    pm = run_port(name, argv, start=ref["start"], compute_dtype="float32")
    assert len(ref["losses"]) == 8
    np.testing.assert_allclose(pm.step_losses, ref["losses"],
                               rtol=LOSS_RTOL)


# the transformer example at its card widths (hidden 512, 8 heads, ff
# 2048, seq 512: both sides take their flash route, not causal), cut to
# one layer and a batch of 2 so the test stays short
CARD_WIDTHS_ONE_LAYER = dict(num_layers=1, hidden=512, num_heads=8,
                             ff_dim=2048, seq_len=512)


def test_transformer_at_its_card_widths_trains_as_the_reference():
    """From the reference's weights in fp32, every step's loss within
    rtol 1e-5 of the reference's.  At its full 12 layers on the card the
    example's SGD diverges on every attention route (chip_smoke.py phase
    18 (b)); here, cut in depth, it does not."""
    import examples.transformer as ref_example
    from flexflow_tpu_torch.examples import transformer

    argv = ["-b", "2", "-e", "1"] + ONE
    build = ref_example.build_transformer
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_example, "build_transformer",
                   lambda cfg, **kw: build(cfg, **CARD_WIDTHS_ONE_LAYER))
        ref = run_reference("transformer", argv, stop_at=None, fp32=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transformer, "sizes",
                   lambda cfg: dict(CARD_WIDTHS_ONE_LAYER))
        pm = run_port("transformer", argv, start=ref["start"],
                      compute_dtype="float32")
    assert pm.graph.nodes and len(ref["losses"]) == 8
    assert [tuple(t.sizes) for t in pm._input_tensors] == [(2, 512, 512)]
    np.testing.assert_allclose(pm.step_losses, ref["losses"],
                               rtol=LOSS_RTOL)


def test_digits_accuracy_reaches_its_gate():
    from flexflow_tpu_torch.examples import digits_accuracy
    from flexflow_tpu_torch.keras import datasets

    m = run_port("digits_accuracy", dict(SINGLE)["digits_accuracy"] + ONE)
    _, (xte, yte) = datasets.digits.load_data()
    logs = m.evaluate(x=(xte / 16.0).reshape(len(xte), 64).astype(
        np.float32), y=yte.astype(np.int32))
    assert logs["accuracy"] >= digits_accuracy.TARGET == 0.90


@pytest.mark.parametrize("name,package", [
    ("pytorch_bert", "transformers"), ("tf_keras_import", "tensorflow"),
    ("digits_accuracy", "sklearn")])
def test_missing_package_raises_an_import_error_naming_it(
        name, package, monkeypatch):
    monkeypatch.setitem(sys.modules, package, None)
    with pytest.raises(ImportError, match=package):
        run_port(name, ["-b", "8", "-e", "1"] + ONE)


def test_a_card_config_without_cuda_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from flexflow_tpu_torch.examples import gpt

    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt.main(["-b", "2", "-e", "1"])


@pytest.mark.parametrize("card", [False, True], ids=["cpu_spec", "card_spec"])
def test_staged_pipeline_search_stages_the_stack_on_either_spec(card):
    """On the card the example models ``h100_sxm(4)`` where the
    reference models ``tpu_v5e(4)``, with the same two hosts and 40 MB:
    the search still finds no flat strategy and proposes the 4-stage
    pipeline there (the search alone, in one process)."""
    from flexflow_tpu_torch.examples import staged_pipeline

    got = {}

    def compile_(self, *a, **k):
        got["model"] = self
        raise _Stop

    with pytest.MonkeyPatch.context() as mp, pytest.raises(_Stop):
        mp.setattr(tff.FFModel, "compile", compile_)
        staged_pipeline.run(port_config(dict(MULTI)["staged_pipeline"]))
    m = got["model"]
    m.config.machine_spec = staged_pipeline.machine_spec(4, card)
    _, export, _, proposal = m._search("training")
    assert set(export) == {"__meta__"}  # no flat strategy fits
    assert proposal is not None and proposal.num_stages == 4


# ---- the multi-rank examples, in test_torch_fleet's world of 4 ------------
def example_rank_legs():
    """On a rank of a world of 4: each multi-rank example's
    ``job_summary``, or the traceback it raised."""
    out = {}
    for name, argv in MULTI:
        mod = importlib.import_module(f"flexflow_tpu_torch.examples.{name}")
        try:
            out[name] = common.job_summary(mod.main(argv, port_config(argv)))
        except Exception:  # reported by the tests below, per example
            out[name] = {"error": traceback.format_exc()}
    return out


def reference_pick(name, argv):
    m = run_reference(name, argv, stop_at="fit")["model"]
    views = {}
    for guid, v in (m.strategy or {}).items():
        if guid in m.graph.nodes:
            views[m.graph.nodes[guid].op.name] = (
                tuple(v.dim_degrees), v.replica_degree, v.start_part)
    return {"kind": type(m.compiled).__name__,
            "num_stages": getattr(m.compiled, "num_stages", None),
            "num_microbatches": getattr(m.compiled, "num_microbatches",
                                        None),
            "views": views}


@pytest.mark.parametrize("name,argv", MULTI, ids=[n for n, _ in MULTI])
def test_multi_rank_example_lowers_the_reference_pick(
        fleet_world, name, argv):  # noqa: F811
    ranks, _ = fleet_world
    want = reference_pick(name, argv)
    for r in ranks:
        got = r["examples"][name]
        assert "error" not in got, got.get("error")
        assert got["kind"] == want["kind"]
        assert got["num_stages"] == want["num_stages"]
        if want["num_microbatches"] is not None:  # a staged pipeline's
            assert got["num_microbatches"] == want["num_microbatches"]
        assert got["views"] == want["views"]
        assert got["losses"] and np.isfinite(got["losses"]).all()
