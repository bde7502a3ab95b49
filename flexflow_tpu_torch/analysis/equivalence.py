"""Substitution soundness verifier — the port of
flexflow_tpu/analysis/equivalence.py (pass 2 of the static-analysis
stack: every rewrite in the registry carries an executable proof).

For each registered ``GraphXfer`` (including the duck-typed
``BatchEmbeddingsXfer``) this materializes a small proof graph the
rewrite matches, applies it, evaluates BOTH graphs in the global
(single-device logical) view on random inputs with deterministically
derived weights, and asserts the values of every node surviving the
rewrite agree within dtype tolerance.  Parallel ops are identity
computations in the global view, so a legal rewrite must be value-
preserving node-by-node.

The graphs run through the port's own op forwards (``evaluate_graph``)
in fp32 compute, eval mode, on the card unless ``device`` names the
CPU.  The weights are the reference's: ``make_weights`` draws each
spec's initializer from the key the reference derives
(``fold_in(key(seed), crc32(op/w))``), through a numpy copy of the
threefry-2x32 generator and ``jax.random.uniform``/``normal``'s bit
recipes (``_threefry2x32``, ``_uniform``, ``_normal``), so the proofs
of both packages see the same numbers on the same graph and seed.  The
inputs are numpy's (``default_rng(seed)``), as the reference's; a
bfloat16 input holds float32 values rounded to bfloat16 (numpy has no
bfloat16) and is fed as a bfloat16 tensor.

Weight correspondence across a rewrite ("the bridge"):

* surviving nodes (same guid) reuse the source graph's weights;
* a new weighted op whose weight specs equal a removed op's specs
  inherits that op's weights (linear+activation fusion);
* a new weighted op whose weight shape is ``(K, *removed_shape)``
  stacks the K removed ops' weights in topo order (the
  ``BatchEmbeddingsXfer`` stacked-table contract);
* anything else is an **EQV303** finding.

Finding codes: EQV300 apply declined a reported match, EQV301 value
mismatch, EQV302 evaluation failure, EQV303 unbridgeable weights,
EQV305 a registered rewrite matched no proof graph.
``analysis/proofgen.py`` adds the generated proof graphs and EQV306.
Invariant findings (PCG0xx) of the rewritten graph are passed through.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.analysis.findings import Finding
from flexflow_tpu_torch.analysis.invariants import check_graph

DEFAULT_RTOL = 1e-4
DEFAULT_ATOL = 1e-5


def _f(code: str, message: str, **kw) -> Finding:
    return Finding(code=code, pass_name="equivalence", message=message, **kw)


# ---------------------------------------------------------------------------
# the reference's weight draws: threefry-2x32 keys and bits in numpy
_U32 = np.uint32


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def _threefry2x32(k1, k2, x0: np.ndarray, x1: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The 20-round threefry-2x32 block cipher of JAX's default PRNG
    (``jax._src.prng._threefry2x32_lowering``) on uint32 arrays."""
    with np.errstate(over="ignore"):
        ks = (_U32(k1), _U32(k2), _U32(k1) ^ _U32(k2) ^ _U32(0x1BD11BDA))
        rot = ((13, 15, 26, 6), (17, 29, 16, 24))
        x0 = x0.astype(_U32) + ks[0]
        x1 = x1.astype(_U32) + ks[1]
        for i in range(5):
            for r in rot[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def _key(seed: int) -> Tuple[int, int]:
    """``jax.random.key(seed)`` for a 32-bit seed: the pair (0, seed)."""
    return 0, int(seed) & 0xFFFFFFFF


def _fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    a, b = _threefry2x32(key[0], key[1], np.zeros(1, _U32),
                         np.array([int(data) & 0xFFFFFFFF], _U32))
    return int(a[0]), int(b[0])


def _bits(key: Tuple[int, int], shape) -> np.ndarray:
    """32 random bits per element (the partitionable scheme: the cipher
    of each element's row-major index, its two words xor-ed)."""
    n = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    idx = np.arange(n, dtype=np.uint64)
    a, b = _threefry2x32(key[0], key[1], (idx >> np.uint64(32)).astype(_U32),
                         (idx & np.uint64(0xFFFFFFFF)).astype(_U32))
    return (a ^ b).reshape(shape)


def _uniform(key, shape, lo: float, hi: float) -> np.ndarray:
    """``jax.random.uniform`` in float32."""
    bits = _bits(key, shape)
    one = np.array(1.0, np.float32).view(_U32)
    floats = ((bits >> _U32(9)) | one).view(np.float32) - np.float32(1.0)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    # one rounding of floats * (hi - lo) + lo, as XLA's fused multiply-add
    scaled = (floats.astype(np.float64) * np.float64(hi32 - lo32)
              + np.float64(lo32)).astype(np.float32)
    return np.maximum(lo32, scaled)


def _erfinv(x: np.ndarray) -> np.ndarray:
    """float32 inverse error function (M. Giles' approximation, the one
    XLA's ``ErfInv`` evaluates for float32)."""
    x = x.astype(np.float32)
    w = -np.log((np.float32(1.0) - x) * (np.float32(1.0) + x))
    small = w < 5.0
    ws = w - np.float32(2.5)
    wl = np.sqrt(w) - np.float32(3.0)
    cs = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
          1.50140941)
    cl = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
          2.83297682)
    ps = np.full_like(x, cs[0])
    pl = np.full_like(x, cl[0])
    for c in cs[1:]:
        ps = np.float32(c) + ps * ws
    for c in cl[1:]:
        pl = np.float32(c) + pl * wl
    out = np.where(small, ps, pl) * x
    return np.where(np.abs(x) == 1.0, x * np.float32(np.inf), out).astype(
        np.float32)


def _normal(key, shape) -> np.ndarray:
    """``jax.random.normal`` in float32: sqrt(2) erfinv(u), u uniform on
    (nextafter(-1, 0), 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = _uniform(key, shape, float(lo), 1.0)
    return (np.float32(math.sqrt(2.0)) * _erfinv(u)).astype(np.float32)


def _draw(init, key, shape) -> np.ndarray:
    """The reference initializer's values for the port's ``init``."""
    from flexflow_tpu_torch import initializers as I

    shape = tuple(shape)
    if isinstance(init, I.ZeroInitializer):
        return np.zeros(shape, np.float32)
    if isinstance(init, I.ConstantInitializer):
        return np.full(shape, init.value, np.float32)
    if isinstance(init, I.NormInitializer):
        return (np.float32(init.mean) + np.float32(init.stddev)
                * _normal(key, shape)).astype(np.float32)
    if isinstance(init, I.GlorotUniformInitializer):
        if len(shape) >= 2:
            receptive = math.prod(shape[:-2])
            fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
        else:
            fan_in = fan_out = shape[0] if shape else 1
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(key, shape, -limit, limit)
    lo, hi = getattr(init, "min_val", None), getattr(init, "max_val", None)
    if lo is not None and hi is not None:
        return _uniform(key, shape, lo, hi)
    raise TypeError(f"no reference draw for initializer {init!r}")


# ---------------------------------------------------------------------------
# evaluation in the global view
def make_inputs(graph, seed: int = 0) -> Dict[int, np.ndarray]:
    """Random feed arrays for every InputOp, keyed by guid.  Integer
    inputs are bounded by the smallest vocab among direct embedding
    consumers so lookups stay in range."""
    from flexflow_tpu_torch.core.ptensor import DataType
    from flexflow_tpu_torch.ops.inout import InputOp

    rng = np.random.default_rng(seed)
    out: Dict[int, np.ndarray] = {}
    for node in graph.topo_order():
        if not isinstance(node.op, InputOp):
            continue
        shape = node.op.output_shapes[0]
        dt = shape.dtype
        if dt in (DataType.INT32, DataType.INT64):
            high = 16
            for e in graph.out_edges[node.guid]:
                n_entries = graph.nodes[e.dst].op.attrs.get("num_entries")
                if n_entries:
                    high = min(high, int(n_entries))
            out[node.guid] = rng.integers(0, high, size=shape.sizes).astype(
                np.dtype(dt.value))
        elif dt is DataType.BOOL:
            out[node.guid] = rng.integers(0, 2, size=shape.sizes) > 0
        else:
            x = rng.standard_normal(shape.sizes).astype(np.float32)
            out[node.guid] = torch.from_numpy(x).to(dt.to_torch()).float(
            ).numpy()
    return out


def make_weights(graph, seed: int = 0) -> Dict[int, Dict[str, np.ndarray]]:
    """Deterministic per-op weights from each spec's own initializer,
    keyed by guid, drawn as the reference draws them; the fold key
    depends on the op NAME so sibling ops get distinct values."""
    out: Dict[int, Dict[str, np.ndarray]] = {}
    base = _key(seed)
    for node in graph.topo_order():
        specs = node.op._weight_specs
        if not specs:
            continue
        ws = {}
        for w in specs:
            k = _fold_in(base, zlib.crc32(
                f"{node.op.name}/{w.name}".encode()) & 0x7FFFFFFF)
            v = _draw(w.initializer, k, w.shape)
            ws[w.name] = torch.from_numpy(v).to(w.dtype.to_torch()).float(
            ).numpy()
        out[node.guid] = ws
    return out


def _tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dtype)


@torch.no_grad()
def evaluate_graph(graph, inputs: Dict[int, np.ndarray],
                   weights: Dict[int, Dict[str, np.ndarray]],
                   device="cuda") -> Dict[Tuple[int, int], np.ndarray]:
    """Forward the whole graph in the global view (one logical device,
    float32 compute, eval mode) on ``device`` and return every
    ``(guid, out_idx)`` value as a host array (bfloat16 values as
    float32)."""
    from flexflow_tpu_torch.ops.base import LoweringContext
    from flexflow_tpu_torch.ops.inout import InputOp

    dev = torch.device(device)
    ctx = LoweringContext(compute_dtype=torch.float32, train=False,
                          device=dev)
    specs = {}
    for node in graph.topo_order():
        for w in node.op._weight_specs:
            specs[(node.guid, w.name)] = w.dtype.to_torch()
    live: Dict[Tuple[int, int], torch.Tensor] = {}
    for node in graph.topo_order():
        if isinstance(node.op, InputOp):
            dt = node.op.output_shapes[0].dtype.to_torch()
            live[(node.guid, 0)] = _tensor(inputs[node.guid], dt, dev)
            continue
        in_edges = sorted(graph.in_edges[node.guid], key=lambda e: e.dst_idx)
        ins = [live[(e.src, e.src_idx)] for e in in_edges]
        ws = {k: _tensor(v, specs[(node.guid, k)], dev)
              for k, v in weights.get(node.guid, {}).items()}
        outs = node.op.forward(ctx, ins, ws)
        for i, y in enumerate(outs):
            live[(node.guid, i)] = y
    out = {}
    for k, t in live.items():
        t = t.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        out[k] = t.cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# weight bridging across a rewrite
def _spec_key(w) -> Tuple:
    return (w.name, tuple(w.shape), w.dtype.value)


def bridge_weights(src_graph, dst_graph,
                   src_weights: Dict[int, Dict[str, np.ndarray]],
                   ) -> Tuple[Dict[int, Dict[str, np.ndarray]], List[Finding]]:
    findings: List[Finding] = []
    dst_w: Dict[int, Dict[str, np.ndarray]] = {}
    # removed weighted ops, in source topo order (the order
    # BatchEmbeddingsXfer stacks its match groups in)
    pool = [n for n in src_graph.topo_order()
            if n.guid not in dst_graph.nodes and n.op._weight_specs]
    for node in dst_graph.topo_order():
        specs = node.op._weight_specs
        if not specs:
            continue
        if node.guid in src_graph.nodes:
            dst_w[node.guid] = src_weights[node.guid]
            continue
        spec_keys = [_spec_key(w) for w in specs]
        direct = next(
            (p for p in pool
             if [_spec_key(w) for w in p.op._weight_specs] == spec_keys),
            None)
        if direct is not None:
            dst_w[node.guid] = src_weights[direct.guid]
            pool.remove(direct)
            continue
        ws: Dict[str, np.ndarray] = {}
        ok = True
        for w in specs:
            k = w.shape[0] if w.shape else 0
            donors = [p for p in pool
                      if any(_spec_key(x) == (w.name, tuple(w.shape[1:]),
                                              w.dtype.value)
                             for x in p.op._weight_specs)]
            if k >= 2 and len(donors) >= k:
                take = donors[:k]
                ws[w.name] = np.stack(
                    [src_weights[p.guid][w.name] for p in take], axis=0)
                for p in take:
                    pool.remove(p)
            else:
                ok = False
                break
        if ok:
            dst_w[node.guid] = ws
        else:
            findings.append(_f(
                "EQV303",
                f"no weight bridge from the removed ops to new op "
                f"{node.op.name!r} (specs {spec_keys})",
                node=node.guid, op=node.op.name))
    return dst_w, findings


# ---------------------------------------------------------------------------
# the proof
def verify_rewrite(graph, xfer, match, seed: int = 0,
                   rtol: float = DEFAULT_RTOL, atol: float = DEFAULT_ATOL,
                   device="cuda") -> List[Finding]:
    """Numeric-equivalence findings for applying ``xfer`` at ``match``
    ([] = the rewrite is a sound, well-formed, value-preserving
    transformation of this graph); both graphs run on ``device``."""
    from flexflow_tpu_torch.analysis.invariants import GraphInvariantError

    name = getattr(xfer, "name", type(xfer).__name__)
    try:
        g2 = xfer.apply(graph, match)
    except GraphInvariantError as e:
        # with verification armed the apply hook raises at the rewrite
        return list(e.findings)
    if g2 is None:
        return [_f("EQV300",
                   f"{name}: apply declined a match find_matches reported")]
    findings = check_graph(g2)
    if findings:
        return findings
    inputs = make_inputs(graph, seed)
    src_w = make_weights(graph, seed)
    try:
        src_vals = evaluate_graph(graph, inputs, src_w, device)
    except Exception as e:
        return [_f("EQV302",
                   f"{name}: source graph failed to evaluate: "
                   f"{type(e).__name__}: {e}")]
    dst_w, findings = bridge_weights(graph, g2, src_w)
    if findings:
        return findings
    try:
        dst_vals = evaluate_graph(g2, inputs, dst_w, device)
    except Exception as e:
        return [_f("EQV302",
                   f"{name}: rewritten graph failed to evaluate: "
                   f"{type(e).__name__}: {e}")]
    for guid in sorted(graph.nodes.keys() & g2.nodes.keys()):
        node = g2.nodes[guid]
        for i in range(len(node.op.output_shapes)):
            a = src_vals.get((guid, i))
            b = dst_vals.get((guid, i))
            if a is None or b is None:
                continue
            if a.shape != b.shape:
                findings.append(_f(
                    "EQV301",
                    f"{name}: output {i} of {node.op.name!r} changed "
                    f"shape {a.shape} -> {b.shape}",
                    node=guid, op=node.op.name))
            elif not np.issubdtype(a.dtype, np.integer) \
                    and a.dtype != np.bool_:
                if not np.allclose(a.astype(np.float64),
                                   b.astype(np.float64),
                                   rtol=rtol, atol=atol):
                    diff = float(np.max(np.abs(
                        a.astype(np.float64) - b.astype(np.float64))))
                    findings.append(_f(
                        "EQV301",
                        f"{name}: output {i} of {node.op.name!r} diverges "
                        f"(max abs diff {diff:.3e})",
                        node=guid, op=node.op.name))
            elif not np.array_equal(a, b):
                findings.append(_f(
                    "EQV301",
                    f"{name}: integer output {i} of {node.op.name!r} "
                    f"diverges", node=guid, op=node.op.name))
    return findings


# ---------------------------------------------------------------------------
# proof graphs: small models that together match EVERY registered xfer.
# Sizes scale with the device count so every divisor degree the
# registry generates divides the partitioned dims.
def _proof_graphs(num_devices: int = 8) -> List:
    import flexflow_tpu_torch as ff

    n = max(2, num_devices)
    b = max(8, n)  # batch: every divisor of n divides b
    if b % n:
        b = n
    w = 2 * n  # feature width
    # a batch-dividing degree for the hand-placed repartitions
    d_b = next((d for d in (4, 3, 2) if b % d == 0), b)
    graphs = []

    def cfg():
        return ff.FFConfig(batch_size=b, num_devices=num_devices,
                           only_data_parallel=True, device="cpu")

    # linear / relu / fusion / replicate-reduce
    m = ff.FFModel(cfg())
    x = m.create_tensor([b, w], name="pf_mlp_in")
    t = m.dense(x, w, name="pf_fc1")
    t = m.relu(t, name="pf_act")
    t = m.dense(t, w, name="pf_fc2")
    m.dense(t, 4, name="pf_mlp_head")
    graphs.append(m.graph)

    # attention: seq = n, heads = n (head_dim 2)
    m = ff.FFModel(cfg())
    x = m.create_tensor([b, n, w], name="pf_attn_in")
    t = m.multihead_attention(x, x, x, w, n, name="pf_attn")
    m.dense(t, 4, name="pf_attn_head")
    graphs.append(m.graph)

    # conv / pool / flat
    m = ff.FFModel(cfg())
    x = m.create_tensor([b, 8, 8, 8], name="pf_img")
    t = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name="pf_conv")
    t = m.pool2d(t, 2, 2, stride_h=2, stride_w=2, name="pf_pool")
    t = m.flat(t, name="pf_flat")
    m.dense(t, 4, name="pf_conv_head")
    graphs.append(m.graph)

    # embeddings (x2 same-signature) / concat / layernorm / softmax / add
    m = ff.FFModel(cfg())
    outs = []
    for i in range(2):
        ids = m.create_tensor([b, 2], dtype="int32", name=f"pf_ids{i}")
        outs.append(m.embedding(ids, 4 * n, n, aggr="sum",
                                name=f"pf_emb{i}"))
    t = m.concat(outs, axis=1, name="pf_cat")
    a = m.dense(t, w, name="pf_ba")
    b_ = m.dense(t, w, name="pf_bb")
    t = m.add(a, b_, name="pf_add")
    t = m.layer_norm(t, name="pf_ln")
    t = m.softmax(t, name="pf_sm")
    m.dense(t, 4, name="pf_emb_head")
    graphs.append(m.graph)

    # cancel_repartition_combine
    m = ff.FFModel(cfg())
    x = m.create_tensor([b, w], name="pf_cc_in")
    t = m.repartition(x, dim=0, degree=d_b, name="pf_cc_rep")
    t = m.combine(t, dim=0, degree=1, name="pf_cc_comb")
    m.dense(t, 4, name="pf_cc_head")
    graphs.append(m.graph)

    # fuse_parallel_op_chain
    m = ff.FFModel(cfg())
    x = m.create_tensor([b, w], name="pf_ch_in")
    t = m.repartition(x, dim=0, degree=2, name="pf_ch_r1")
    t = m.repartition(t, dim=1, degree=2, name="pf_ch_r2")
    m.dense(t, 4, name="pf_ch_head")
    graphs.append(m.graph)

    # sink_combine_through_concat
    m = ff.FFModel(cfg())
    x = m.create_tensor([b, w], name="pf_sk_in")
    outs = []
    for i in range(3):
        t = m.dense(x, w, name=f"pf_sk_b{i}")
        outs.append(m.combine(t, dim=0, degree=1, name=f"pf_sk_c{i}"))
    t = m.concat(outs, axis=1, name="pf_sk_cat")
    m.dense(t, 4, name="pf_sk_head")
    graphs.append(m.graph)

    # hoist_partition_above_unary
    m = ff.FFModel(cfg())
    x = m.create_tensor([b, w], name="pf_ho_in")
    t = m.relu(x, name="pf_ho_act")
    outs = []
    for i in range(3):
        p = m.repartition(t, dim=0, degree=d_b, name=f"pf_ho_p{i}")
        outs.append(m.dense(p, w, name=f"pf_ho_fc{i}"))
    m.concat(outs, axis=1, name="pf_ho_cat")
    graphs.append(m.graph)

    return graphs


def verify_registry(num_devices: int = 8, seed: int = 0,
                    xfers=None, device="cuda") -> List[Finding]:
    """Executable proof for the whole rewrite registry: every xfer from
    ``generate_all_pcg_xfers(num_devices)`` must match at least one
    proof graph and pass ``verify_rewrite`` there.  [] = the registry
    is sound."""
    from flexflow_tpu_torch.search.substitution import generate_all_pcg_xfers

    if xfers is None:
        xfers = generate_all_pcg_xfers(num_devices)
    graphs = _proof_graphs(num_devices)
    findings: List[Finding] = []
    for xf in xfers:
        name = getattr(xf, "name", type(xf).__name__)
        matched = False
        for g in graphs:
            matches = xf.find_matches(g)
            if not matches:
                continue
            matched = True
            findings += verify_rewrite(g, xf, matches[0], seed=seed,
                                       device=device)
            break
        if not matched:
            findings.append(_f(
                "EQV305",
                f"registered rewrite {name!r} matched no proof graph — "
                f"it carries no executable soundness proof"))
    return findings
