"""The port's torch.fx importer (``flexflow_tpu_torch/frontends/torch_fx.py``)
against the JAX package's.

* ``torch_to_flexflow``: both packages write byte-equal record files for
  the same module: an MLP, a CNN through the NCHW bridge, batch norm in
  eval mode, the function zoo of tests/test_frontends.py:101,
  ``scaled_dot_product_attention`` with positional arguments and
  ``chip_smoke.FxBert`` (phase 17's module) at 2 layers; each package's
  ``PyTorchModel`` reads the other's file and builds the same graph.
* Imports from the module (records traced lazily from the FFModel's
  input shapes): both packages' ``transfer_torch_weights`` copy the
  same arrays, the forwards are within 1e-5 (fp32) of each other and
  of the torch module, and 3 SGD steps (``train_step``, the step ``fit``
  runs) give losses within 1e-5 relative and weights within 1e-5.
* ``FxBert`` at 2 layers, hidden 32 (the chip phase's module cut in
  depth and width): imported from ``example_inputs``, weights, forward
  and 3 Adam steps against the source module and the reference's
  import; ``transformers.BertModel`` as tests/test_frontends.py:215
  imports it (skipped where ``transformers`` is missing).
* A bfloat16 module: ``transfer_torch_weights`` carries its weights
  bit for bit into the fp32 parameters, and a folded bfloat16 buffer
  becomes a constant of the imported graph (the JAX package's importer
  refuses both: numpy's ``.numpy()`` has no bfloat16).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import flexflow_tpu as ff
from flexflow_tpu.core.machine import MachineView as JView
from flexflow_tpu.frontends import PyTorchModel as JPyTorchModel
from flexflow_tpu.frontends import torch_to_flexflow as j_torch_to_flexflow
from flexflow_tpu.frontends import transfer_torch_weights as j_transfer
import flexflow_tpu_torch as tff
from flexflow_tpu_torch.frontends import (
    PyTorchModel,
    torch_to_flexflow,
    transfer_torch_weights,
)
from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy

from chip_smoke import FxBert

TOL = 1e-5
LR = 0.05
MSE = dict(loss_type="mean_squared_error", metrics=["mean_squared_error"])
CCE = dict(loss_type="sparse_categorical_crossentropy",
           metrics=["accuracy"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# helpers the other frontend and keras test files share
def ref_config(batch, **kw):
    return ff.FFConfig(batch_size=batch, num_devices=1,
                       only_data_parallel=True, compute_dtype="float32",
                       cost_cache_file="", **kw)


def port_config(batch, **kw):
    return tff.FFConfig(batch_size=batch, device="cpu",
                        only_data_parallel=True, compute_dtype="float32",
                        **kw)


def trivial(jm):
    return {n.guid: JView.trivial(n.op.output_shapes[0].ndim)
            for n in jm.graph.topo_order()}


def compile_pair(jm, pm, adam=False, **loss):
    """Both models compiled alike (the reference on one device without
    its search, the port data parallel on one)."""
    if adam:
        jm.compile(optimizer=ff.AdamOptimizer(alpha=1e-3),
                   strategy=trivial(jm), **loss)
        pm.compile(optimizer=tff.AdamOptimizer(alpha=1e-3), **loss)
    else:
        jm.compile(optimizer=ff.SGDOptimizer(lr=LR), strategy=trivial(jm),
                   **loss)
        pm.compile(optimizer=tff.SGDOptimizer(lr=LR), **loss)
    assert [n.op.name for n in pm.graph.topo_order()] == [
        n.op.name for n in jm.graph.topo_order()]


def take_reference(jm, pm):
    """The reference's weights and state into the port."""
    pm.params = params_from_numpy({
        op: {w: np.array(v) for w, v in ws.items()}
        for op, ws in jm.params.items()})
    pm.opt_state = pm.optimizer.init_state(pm.params)
    for k, v in jm.state.items():
        pm.set_state_var(k, np.asarray(v))


def close(got, ref, tol=TOL, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(got - ref).max()) <= tol * scale, (
        what, float(np.abs(got - ref).max()))


def forwards(jm, pm, xs):
    """Each package's forward of ``xs`` (numpy), as numpy."""
    ref = jm.compiled.forward_fn()(jm.params, jm.state,
                                   [jnp.asarray(x) for x in xs])
    got = pm.compiled.forward_fn()(pm.params, pm.state,
                                   [torch.from_numpy(x) for x in xs])
    return got.detach().numpy(), np.asarray(ref)


def same_params(jm, pm, tol=0.0):
    got = params_to_numpy(pm.params)
    assert set(got) == set(jm.params)
    for op, ws in jm.params.items():
        assert set(got[op]) == set(ws), op
        for w, v in ws.items():
            np.testing.assert_allclose(got[op][w], np.asarray(v), rtol=tol,
                                       atol=tol, err_msg=f"{op}/{w}")


def steps_pair(jm, pm, batches, tol=TOL):
    """One ``train_step`` per batch on each side: losses within ``tol``
    relative, then the weights and the state within ``tol``."""
    for step, (xs, y) in enumerate(batches, 1):
        jm.params, jm.opt_state, jm.state, jl, _ = jm.compiled.train_step(
            jm.params, jm.opt_state, jm.state, jax.random.key(step),
            [jnp.asarray(x) for x in xs], jnp.asarray(y))
        pm.params, pm.opt_state, pm.state, pl, _ = pm.compiled.train_step(
            pm.params, pm.opt_state, pm.state,
            [torch.from_numpy(x) for x in xs], torch.from_numpy(y),
            seed=step)
        assert abs(float(pl) - float(jl)) <= tol * max(abs(float(jl)),
                                                       1e-3), (
            step, float(pl), float(jl))
    same_params(jm, pm, tol)
    for k, v in jm.state.items():
        np.testing.assert_allclose(pm.state[k].numpy(), np.asarray(v),
                                   rtol=tol, atol=tol, err_msg=k)


# ---------------------------------------------------------------------------
class SmallMLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(16, 32)
        self.act = nn.ReLU()
        self.fc2 = nn.Linear(32, 4)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class SmallCNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, padding=1)
        self.pool = nn.MaxPool2d(2, 2)
        self.conv2 = nn.Conv2d(8, 8, 3, padding=1)
        self.flatten = nn.Flatten()
        self.fc = nn.Linear(8 * 4 * 4, 10)

    def forward(self, x):
        x = self.pool(torch.relu(self.conv1(x)))
        x = self.pool(torch.relu(self.conv2(x)))
        return self.fc(self.flatten(x))


class FuncZoo(nn.Module):
    """tests/test_frontends.py:101's call_function/call_method zoo."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(8, 8)
        self.ln = nn.LayerNorm(8)

    def forward(self, x):
        a = self.fc(x)
        b = torch.sigmoid(a) * 2.0 + x
        c = torch.cat([a, b], dim=1).reshape(x.shape[0], 2, 8)
        d = c.transpose(1, 2).mean(dim=2)
        e = self.ln(d + 1.0)
        return torch.softmax(e / 2.0, dim=-1)


class BNNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, padding=1)
        self.bn = nn.BatchNorm2d(4)
        self.flatten = nn.Flatten()
        self.fc = nn.Linear(4 * 8 * 8, 2)

    def forward(self, x):
        return self.fc(self.flatten(torch.relu(self.bn(self.conv(x)))))


class SdpaNet(nn.Module):
    """SDPA with positional (attn_mask, dropout_p, is_causal), a
    negative-bound slice and a bare int subscript
    (tests/test_frontends.py:170)."""

    def __init__(self):
        super().__init__()
        self.proj = nn.Linear(16, 16)

    def forward(self, x):
        b, s, h = x.shape
        q = x.view(b, s, 2, 8).transpose(1, 2)
        y = F.scaled_dot_product_attention(q, q, q, None, 0.0, False)
        y = y.transpose(1, 2).reshape(b, s, h)
        y = self.proj(y)
        y = y[:, :-1]
        return y[0]


def _bn_net(seed=3):
    m = BNNet()
    rng = np.random.default_rng(seed)
    with torch.no_grad():  # non-trivial running statistics
        for _ in range(4):
            m(torch.from_numpy(rng.normal(1.5, 2.0, size=(8, 3, 8, 8))
                               .astype(np.float32)))
    return m


FXBERT = dict(vocab=64, num_layers=2, hidden=32, num_heads=2, ff_dim=64,
              seq_len=16)

# name -> (module factory, input shape, input dtype)
MODULES = {
    "mlp": (SmallMLP, (8, 16), "float32"),
    "cnn": (SmallCNN, (4, 3, 16, 16), "float32"),
    "batchnorm": (_bn_net, (4, 3, 8, 8), "float32"),
    "zoo": (FuncZoo, (4, 8), "float32"),
    "sdpa": (SdpaNet, (4, 6, 16), "float32"),
    "fxbert": (lambda: FxBert(**FXBERT, seed=1), (4, FXBERT["seq_len"]),
               "int32"),
}


def _module(name):
    torch.manual_seed(0)
    make, shape, dtype = MODULES[name]
    return make().eval(), shape, dtype


def _example(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(0, FXBERT["vocab"], size=shape).astype(np.int32)
    return rng.normal(size=shape).astype(np.float32)


def _example_tensor(x):
    t = torch.from_numpy(x)
    return t.long() if x.dtype == np.int32 else t


@pytest.mark.parametrize("name", sorted(MODULES))
def test_record_files_are_byte_equal(name, tmp_path):
    m, shape, dtype = _module(name)
    ex = [_example_tensor(_example(shape, dtype))]
    j_torch_to_flexflow(m, str(tmp_path / "ref.ffir"), ex)
    torch_to_flexflow(m, str(tmp_path / "port.ffir"), ex)
    ref = (tmp_path / "ref.ffir").read_bytes()
    assert (tmp_path / "port.ffir").read_bytes() == ref
    assert ref.startswith(b"flexflow_tpu.torch_fx.v1\n")


@pytest.mark.parametrize("name", ["cnn", "fxbert"])
def test_each_package_reads_the_others_file(name, tmp_path):
    """The port applies the reference's file and the reference the
    port's: the same graph, and after the same weights the same
    forward."""
    m, shape, dtype = _module(name)
    x = _example(shape, dtype)
    ex = [_example_tensor(x)]
    j_torch_to_flexflow(m, str(tmp_path / "ref.ffir"), ex)
    torch_to_flexflow(m, str(tmp_path / "port.ffir"), ex)
    jm = ff.FFModel(ref_config(shape[0]))
    JPyTorchModel(str(tmp_path / "port.ffir")).torch_to_ff(
        jm, [jm.create_tensor(list(shape), dtype=dtype)])
    pm = tff.FFModel(port_config(shape[0]))
    PyTorchModel(str(tmp_path / "ref.ffir")).torch_to_ff(
        pm, [pm.create_tensor(list(shape), dtype=dtype)])
    compile_pair(jm, pm, **MSE)
    assert [type(n.op).__name__ for n in pm.graph.topo_order()] == [
        type(n.op).__name__ for n in jm.graph.topo_order()]
    assert j_transfer(m, jm) == transfer_torch_weights(m, pm) > 0
    same_params(jm, pm)
    got, ref = forwards(jm, pm, [x])
    close(got, ref)
    with torch.no_grad():
        close(got, m(ex[0]).numpy())


@pytest.mark.parametrize("name", ["mlp", "cnn", "batchnorm", "zoo",
                                  "sdpa"])
def test_import_trains_as_the_reference(name):
    """Traced lazily from the FFModel's input shapes, as
    tests/test_frontends.py imports: the forward against the torch
    module (eval mode) and the reference's, then 3 SGD steps."""
    m, shape, dtype = _module(name)
    jm = ff.FFModel(ref_config(shape[0]))
    jouts = JPyTorchModel(m).torch_to_ff(
        jm, [jm.create_tensor(list(shape))])
    pm = tff.FFModel(port_config(shape[0]))
    outs = PyTorchModel(m).torch_to_ff(pm, [pm.create_tensor(list(shape))])
    assert [tuple(t.sizes) for t in outs] == [tuple(t.sizes) for t in jouts]
    compile_pair(jm, pm, **MSE)
    assert j_transfer(m, jm) == transfer_torch_weights(m, pm) > 0
    same_params(jm, pm)
    for k, v in jm.state.items():  # batch norm's running statistics
        np.testing.assert_array_equal(pm.state[k].numpy(), np.asarray(v))
    x = _example(shape, dtype, seed=4)
    with torch.no_grad():
        want = m(torch.from_numpy(x)).numpy()
    got, ref = forwards(jm, pm, [x])  # eval: batch norm's statistics
    close(got, want)
    close(got, ref)
    if name != "sdpa":  # predict's rows are the batch's
        close(pm.predict(x), want)
    if name == "sdpa":  # its output drops the batch dim: no loss over it
        return
    rng = np.random.default_rng(5)
    out = tuple(outs[0].sizes)
    steps_pair(jm, pm, [([_example(shape, dtype, seed=10 + i)],
                         rng.normal(size=out).astype(np.float32))
                        for i in range(3)])


def test_sdpa_refusals_match_the_reference():
    """``is_causal`` (positional) and a non-trivial mask are refused by
    both importers: the decomposition has no causal or masked form."""

    class Causal(nn.Module):
        def forward(self, x):
            b, s, h = x.shape
            q = x.view(b, s, 2, 8).transpose(1, 2)
            return F.scaled_dot_product_attention(q, q, q, None, 0.0, True)

    class Masked(nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("mask", torch.tril(torch.ones(6, 6)).bool())

        def forward(self, x):
            b, s, h = x.shape
            q = x.view(b, s, 2, 8).transpose(1, 2)
            return F.scaled_dot_product_attention(q, q, q,
                                                  attn_mask=self.mask)

    x = torch.zeros(4, 6, 16)
    for mod, match in ((Causal(), "is_causal"), (Masked(), "attn_mask")):
        for model_cls, cfg in ((JPyTorchModel, ref_config(4)),
                               (PyTorchModel, port_config(4))):
            fm = (ff.FFModel(cfg) if model_cls is JPyTorchModel
                  else tff.FFModel(cfg))
            t = fm.create_tensor([4, 6, 16])
            with pytest.raises(NotImplementedError, match=match):
                model_cls(mod, example_inputs=[x]).torch_to_ff(fm, [t])


def test_fxbert_imports_as_its_source_and_the_reference():
    """Phase 17's module at 2 layers, hidden 32: imported from example
    inputs, its attention decomposed as the reference's (no MHA op), the
    weights carried, the forward equal to the source module's and the
    reference import's, then 3 Adam steps alike."""
    m, shape, dtype = _module("fxbert")
    x = _example(shape, dtype)
    ex = [_example_tensor(x)]
    jm = ff.FFModel(ref_config(shape[0]))
    JPyTorchModel(m, example_inputs=ex).torch_to_ff(
        jm, [jm.create_tensor(list(shape), dtype="int32")])
    pm = tff.FFModel(port_config(shape[0]))
    outs = PyTorchModel(m, example_inputs=ex).torch_to_ff(
        pm, [pm.create_tensor(list(shape), dtype="int32")])
    assert [tuple(o.sizes) for o in outs] == [(shape[0], 2)]
    kinds = [n.op.op_type.name for n in pm.graph.topo_order()]
    assert "MULTIHEAD_ATTENTION" not in kinds
    assert kinds.count("BATCH_MATMUL") == 2 * FXBERT["num_layers"]
    compile_pair(jm, pm, adam=True, **CCE)
    n = transfer_torch_weights(m, pm)
    assert n == j_transfer(m, jm) == 16 * FXBERT["num_layers"] + 9
    same_params(jm, pm)
    with torch.no_grad():
        want = m(ex[0]).numpy()
    close(pm.predict(x), want)
    got, ref = forwards(jm, pm, [x])
    close(got, ref)
    rng = np.random.default_rng(6)
    steps_pair(jm, pm, [([_example(shape, dtype, seed=20 + i)],
                         rng.integers(0, 2, size=shape[0]).astype(np.int32))
                        for i in range(3)])


def test_transformers_bert_import():
    """``transformers.BertModel`` traced by its own fx tracer
    (tests/test_frontends.py:215): buffer constants, the mask chain
    folded, SDPA decomposed, the CLS slice; both importers give the same
    graph, the weights carry, and the port's forward is the source
    module's and the reference import's."""
    transformers = pytest.importorskip("transformers")
    from transformers.utils import fx as hf_fx

    cfg = transformers.BertConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, vocab_size=128, max_position_embeddings=32,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    tm = transformers.BertModel(cfg).eval()
    gm = hf_fx.symbolic_trace(tm, input_names=["input_ids"])
    b, s = 4, 8
    ex = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (b, s)))
    jm = ff.FFModel(ref_config(b))
    jouts = JPyTorchModel(gm, example_inputs=[ex]).torch_to_ff(
        jm, [jm.create_tensor([b, s], dtype="int32")])
    pm = tff.FFModel(port_config(b))
    outs = PyTorchModel(gm, example_inputs=[ex]).torch_to_ff(
        pm, [pm.create_tensor([b, s], dtype="int32")])
    assert [tuple(o.sizes) for o in outs] == [
        tuple(o.sizes) for o in jouts] == [(b, s, 32), (b, 32)]
    jm.compile(loss_type="mean_squared_error", metrics=[],
               strategy=trivial(jm))
    pm.compile(loss_type="mean_squared_error", metrics=[])
    assert transfer_torch_weights(tm, pm) == j_transfer(tm, jm) >= 29
    same_params(jm, pm)
    x = ex.numpy().astype(np.int32)
    got, ref = forwards(jm, pm, [x])
    close(got, ref)
    with torch.no_grad():
        out = tm(input_ids=ex)
    want = {(b, s, 32): out.last_hidden_state.numpy(),
            (b, 32): out.pooler_output.numpy()}[got.shape]
    close(got, want)


class BF16Net(nn.Module):
    """A bfloat16 module whose forward multiplies by a bfloat16 buffer
    (folded into a constant of the imported graph)."""

    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(16, 32)
        self.norm = nn.LayerNorm(32)
        self.fc2 = nn.Linear(32, 4)
        self.register_buffer("scale", torch.linspace(0.5, 1.5, 32))

    def forward(self, x):
        return self.fc2(self.norm(torch.relu(self.fc1(x)) * self.scale))


def test_bf16_module_transfers_bit_for_bit():
    torch.manual_seed(2)
    m = BF16Net().to(torch.bfloat16).eval()
    x = torch.from_numpy(_example((8, 16), "float32")).to(torch.bfloat16)
    pm = tff.FFModel(port_config(8))
    PyTorchModel(m, example_inputs=[x]).torch_to_ff(
        pm, [pm.create_tensor([8, 16])])
    consts = [n.op for n in pm.graph.topo_order()
              if n.op.op_type.name == "CONSTANT"]
    assert [c.value.dtype.name for c in consts] == ["bfloat16"]
    assert np.array_equal(np.asarray(consts[0].value, np.float32),
                          m.scale.float().numpy())
    pm.compile(optimizer=tff.SGDOptimizer(lr=LR), **MSE)
    assert transfer_torch_weights(m, pm) == 6
    got = params_to_numpy(pm.params)
    for op, wname, t in (("fc1", "kernel", m.fc1.weight.T),
                         ("fc1", "bias", m.fc1.bias),
                         ("norm", "gamma", m.norm.weight),
                         ("fc2", "kernel", m.fc2.weight.T),
                         ("fc2", "bias", m.fc2.bias)):
        assert got[op][wname].dtype == np.float32
        np.testing.assert_array_equal(got[op][wname],
                                      t.detach().float().numpy())
    out = pm.predict(x.float().numpy())  # the graph computes in fp32
    with torch.no_grad():
        want = m.float()(x.float()).numpy()
    close(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_matmul_gradient(dtype):
    """The imported attention's ``batch_matmul`` runs through
    ``ops/linear.py``'s ``_MatmulAcc32`` on batched operands (on the card
    ``torch.bmm``'s fp32-output form has no derivative): products of the
    operands accumulated in fp32, the backward's from the cotangent cast
    to the compute dtype; fp32 is autograd's ``bmm`` bit for bit."""
    from flexflow_tpu_torch.ops.linear import _MatmulAcc32

    rng = np.random.default_rng(9)
    a, b, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((3, 5, 7), (3, 7, 4), (3, 5, 4)))
    a, b = a.to(dtype).requires_grad_(True), b.to(dtype).requires_grad_(
        True)
    z = _MatmulAcc32.apply(a, b)
    assert z.dtype == torch.float32
    z.backward(g)
    a32, b32 = a.detach().float(), b.detach().float()
    torch.testing.assert_close(z.detach(), torch.bmm(a32, b32), rtol=0,
                               atol=1e-6)
    gd = g.to(dtype).float()
    for got, want in ((a.grad, torch.bmm(gd, b32.transpose(1, 2))),
                      (b.grad, torch.bmm(a32.transpose(1, 2), gd))):
        assert got.dtype == dtype
        torch.testing.assert_close(got, want.to(dtype), rtol=0, atol=0)
