"""FFModel — the model-building API, ported from flexflow_tpu/model.py.

The reference's builder methods (``create_tensor``,
``create_constant``, ``dense``, ``conv2d``, ``pool2d``, ``batch_norm``,
``layer_norm``, ``embedding``, ``multihead_attention``,
``decode_attention``, ``batch_matmul``, ``dropout``, ``softmax``,
``concat``, ``split``, ``flat``, ``reshape``, ``transpose``,
``reverse``, ``cast``, ``mean``, ``top_k``, ``gather``, the MoE ops
``group_by``, ``aggregate``, ``aggregate_spec`` and ``cache``, the
elementwise verbs (``relu`` ... ``scalar_true_divide``, ``add`` ...
``min``) and the parallel ops ``repartition``, ``combine``,
``replicate``, ``reduction``) build a lazy graph;
``compile`` binds it to the config's device, with a strategy (guid ->
``MachineView``) to this rank's shards of every tensor
(compiler/lowering.py), and initialises ``params`` (this rank's
blocks), ``state`` (the decode ops' page pools placed by their
``state_shardings``) and, for training, the optimizer state; an
inference compile adopts the pool dtype onto the decode-attention ops
(``_adopt_kv_dtype``, reference model.py:50-83): a ``__meta__.kv``
block's (searched or imported), else a pinned ``config.kv_precision``,
so the state holds that pool dtype.  An inference compile runs under
any strategy over the job's ranks (a fleet replica, runtime/fleet.py,
over a block of them).  ``fit``, ``evaluate`` and
``predict`` run over numpy data; under a strategy every rank runs them
on its blocks, the losses and metrics are the job's, and ``predict``
returns the whole output on every rank.  ``fit`` also takes the
reference's callbacks, ``recompile_state``, validation data or split,
``checkpoint_dir`` and ``resume`` (``runtime/checkpoint.py``), and
``recompile()`` re-lowers the graph as it was lowered, carrying the
training state over.

``compile(strategy=None)`` chooses the strategy as the reference's
does (model.py:539, 816-850): ``config.only_data_parallel`` gives
``data_parallel_strategy``; otherwise the Unity search runs
(``search.driver.optimize_strategy(..., return_graph=True)``), the
best rewritten graph becomes ``self.graph`` and the lowering takes it.
A job of several ranks searches once: rank 0 calibrates (when asked)
and searches, and sends every rank its export (``strategy_io``) with
the rewritten graph; each rank checks the graph's
``stable_graph_digest`` and imports the views through the export's
digest gate, so no two ranks can lower different strategies.  After
the flat search, for training without ZeRO and with
``enable_pipeline_search``/``enable_placement_search`` (both on by
default), the search costs the reference's proposals in its order
(model.py:850-935): a stacked-block pipeline
(``search/pipeline_search.py::propose_pipeline``), else a two-block
inter-op placement (``search/placement_search.py``), else, when no
flat strategy fits, a general staged pipeline.  The winner rides the
export's ``__meta__`` (``pipeline``, ``placement``) to every rank,
which checks it with the placement lints (``analysis/placement.py``)
and lowers it: ``compile`` picks the placed lowering for a two-block
``start_part`` strategy (always linted first), the pipelined one under
``pipeline`` (``compile(pipeline=PipelineConfig(...), block_of=...)``
or an adopted proposal), the staged one for a stage cut (whose
refusals keep the flat lowering, the reference's one fallback), else
the flat one.  ``config.import_strategy_file`` imports a strategy
file through the digest gate instead of searching, its ``__meta__``
adopted the same way; ``config.export_strategy_file`` writes the
lowered strategy with it.  ``self.pipeline_proposal`` holds an
adopted stage cut.  ``self.strategy`` holds the chosen
views and ``self.search_stats`` the search's ``LAST_SEARCH_STATS``
(its seconds, calibration seconds and counters; rank 0's on every
rank).

Under ``objective="serve"`` an inference compile's search prices the
decode graph in the p99 currency (search/serving.py), with the KV lane
(``kv_precision="search"``), then, as the reference's compile does
(model.py:942-998), the prefill/decode disaggregation proposal
(``serve_disaggregation="search"``; priced and persisted, not
executed) and the fleet (``serve_fleet="search"``), into
``self.disaggregation`` and ``self.fleet`` (rank 0's proposals on
every rank).  Their ``__meta__`` blocks (``serving``, ``kv``,
``disaggregation``, ``fleet``) ride the export, are re-linted
(SHD160-169) on every rank and at import, and are kept in
``self.serve_meta``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import Graph, Node
from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import (
    DataType,
    ParallelTensorShape,
    Tensor,
)
from flexflow_tpu_torch.interop import params_from_numpy
from flexflow_tpu_torch import ops as O


def _adopt_kv_dtype(graph, dtype) -> None:
    """Retype the graph's decode-attention page pools IN PLACE to
    ``dtype`` (``"fp32"``/``"bf16"``/``"int8"``) before the state is
    built.  fp32 (and None or "off") is the attr-free default: nothing
    to adopt, every node stays the same object."""
    if dtype in (None, "off", "fp32"):
        return
    changed = False
    for guid, node in list(graph.nodes.items()):
        op = node.op
        if op.op_type != OperatorType.DECODE_ATTENTION:
            continue
        if op.attrs.get("kv_dtype", "fp32") == dtype:
            continue
        a = op.attrs
        clone = type(op)(
            op.name, op.input_shapes,
            embed_dim=a["embed_dim"], num_heads=a["num_heads"],
            page_size=a["page_size"], pages_per_seq=a["pages_per_seq"],
            num_pages=a["num_pages"], use_kernel=a["use_kernel"],
            kv_dtype=dtype, kernel_initializer=op._kernel_init,
        )
        graph.nodes[guid] = Node(guid, clone)
        changed = True
    if changed:
        graph._invalidate()


# the serve objective's __meta__ blocks (reference model.py:622-720)
_SERVE_META = ("serving", "kv", "disaggregation", "fleet")


def _check_searched_graph(graph) -> None:
    """The searched graph must name each op once (weights are keyed by
    op name)."""
    names = [nd.op.name for nd in graph.nodes.values()]
    if len(set(names)) != len(names):
        dup = sorted({n for n in names if names.count(n) > 1})
        raise RuntimeError(
            f"the searched graph names ops {dup[:4]} more than once; their "
            f"weights would be shared")


def _merge_matching(new, old):
    """``new``'s structure, with ``old``'s tensors at the key paths
    present in both with equal shapes and dtypes (reference
    model.py:37-47)."""
    if isinstance(new, dict) and isinstance(old, dict):
        return {k: _merge_matching(v, old[k]) if k in old else v
                for k, v in new.items()}
    if (isinstance(new, torch.Tensor) and isinstance(old, torch.Tensor)
            and new.shape == old.shape and new.dtype == old.dtype):
        return old
    return new


def _split_validation(x, y, fraction: float, validation_data):
    """(train x, train y, validation data): the last ``fraction`` of the
    samples, before any shuffle, by keras's formula (reference
    model.py:1830-1856)."""
    if validation_data is not None:
        raise ValueError(
            "pass either validation_data or validation_split, not both")
    if not 0.0 < fraction < 1.0:
        raise ValueError(f"validation_split={fraction} not in (0, 1)")
    many = isinstance(x, (list, tuple))
    xs = [np.asarray(a) for a in (x if many else [x])]
    y = np.asarray(y)
    n = len(y)
    cut = int(n * (1.0 - fraction))  # keras's formula
    if cut == n or cut == 0:
        raise ValueError(f"validation_split={fraction} of {n} samples "
                         f"leaves an empty train or validation set")
    val = ([a[cut:] for a in xs] if many else xs[0][cut:], y[cut:])
    return ([a[:cut] for a in xs] if many else xs[0][:cut]), y[:cut], val


def _check_validation(validation_data, batch_size: int) -> None:
    """The reference's checks, before training (model.py:1858-1878)."""
    if not isinstance(validation_data, (tuple, list)) or len(
            validation_data) != 2:
        raise ValueError("validation_data must be an (x, y) pair "
                         "(sample weights are not supported)")
    n = len(np.asarray(validation_data[1]))
    if n < batch_size:
        raise ValueError(
            f"validation set ({n} samples) is smaller than batch_size "
            f"({batch_size}) — evaluate() runs full batches only, so no "
            f"validation metric could ever be computed")
    if n % batch_size:
        print(f"# warning: validation tail of {n % batch_size} samples "
              f"(< batch_size {batch_size}) is dropped each epoch")


def _block_mesh(num_devices: int):
    """The mesh a swap to ``num_devices`` lowers on: None for the whole
    job, the ranks ``[0, num_devices)`` below it.  Every rank of the job
    builds it (``mesh_over`` creates process groups on every rank)."""
    from flexflow_tpu_torch.runtime import distributed

    world = distributed.world_size()
    if num_devices > world:
        raise ValueError(
            f"FFConfig.num_devices={num_devices} but the job has {world} "
            f"rank(s): a swap cannot grow past the job's ranks")
    if num_devices == world:
        return None
    return distributed.mesh_over(start=0, width=num_devices)


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        self.config.torch_device()  # no CUDA for a CUDA config: raise now
        self.graph = Graph()
        self._producer: Dict[int, Tuple[Node, int]] = {}
        self._input_tensors: List[Tensor] = []
        self._name_counts: Dict[str, int] = {}
        self.compiled = None
        self.params = None
        self.state = None
        self.opt_state = None
        self.optimizer = None
        self.last_throughput = None
        self.step_losses: List[float] = []
        self.strategy = None
        self.pipeline_proposal = None
        self.search_stats: Dict = {}
        # the gradient-sync plan the flat lowering runs (compile)
        self.sync_precision_map: Dict[str, str] = {}
        self.sync_schedule = None
        self.zero_groups: Tuple[str, ...] = ()
        # the serve objective's proposals (search/disaggregation.py,
        # search/fleet.py; rank 0's on every rank) and its __meta__
        # blocks (serving, kv, disaggregation, fleet) as adopted
        self.disaggregation = None
        self.fleet = None
        self.serve_meta: Dict[str, dict] = {}
        self._kv_adopt: Optional[str] = None
        self._rng_counter = 0  # the step seed: +1 per optimizer step
        self._compile_ctx = None
        # the drift loop's predicted side (compile, swap_strategy) and
        # its measured reports (runtime/controller.py reads them)
        self.predicted_breakdown = None
        self.drift_report = None
        self.lane_drift_report = None
        self.profile_summary = None  # fit's StepProfiler summary

    def _fresh_name(self, base: str, name: Optional[str]) -> str:
        if name:
            return name
        i = self._name_counts.get(base, 0)
        self._name_counts[base] = i + 1
        return f"{base}_{i}"

    def _shape_of(self, t: Tensor) -> ParallelTensorShape:
        return ParallelTensorShape.make(t.sizes, t.dtype)

    def _add_op(self, op: O.Operator, inputs: Sequence[Tensor]
                ) -> List[Tensor]:
        node = self.graph.new_node(op)
        for i, t in enumerate(inputs):
            src_node, src_idx = self._producer[t.guid]
            self.graph.add_edge(src_node, node, src_idx, i)
        outs = []
        for i, shape in enumerate(op.output_shapes):
            t = Tensor(shape.sizes, shape.dtype, name=f"{op.name}:{i}")
            self._producer[t.guid] = (node, i)
            outs.append(t)
        return outs

    # ---- builder ---------------------------------------------------------
    def create_tensor(self, dims: Sequence[int], dtype="float32",
                      name=None) -> Tensor:
        """Frontend input tensor."""
        name = self._fresh_name("input", name)
        t = Tensor(dims, dtype, name=name)
        op = O.InputOp(name, ParallelTensorShape.make(t.sizes, t.dtype),
                       tensor_guid=t.guid)
        node = self.graph.new_node(op)
        self._producer[t.guid] = (node, 0)
        self._input_tensors.append(t)
        return t

    def create_constant(self, value, dtype=None, name=None) -> Tensor:
        """Compile-time constant tensor (``build_gpt``'s position ids)."""
        arr = np.asarray(value)
        if dtype is not None:
            arr = arr.astype(DataType.from_any(dtype).value)
        name = self._fresh_name("constant", name)
        t = Tensor(arr.shape, str(arr.dtype), name=name)
        op = O.ConstantOp(name, ParallelTensorShape.make(t.sizes, t.dtype),
                          value=arr)
        node = self.graph.new_node(op)
        self._producer[t.guid] = (node, 0)
        return t

    def dense(self, input: Tensor, out_dim: int, activation=None,
              use_bias=True, kernel_initializer=None, bias_initializer=None,
              name=None) -> Tensor:
        op = O.LinearOp(self._fresh_name("dense", name),
                        [self._shape_of(input)], out_dim=out_dim,
                        activation=activation, use_bias=use_bias,
                        kernel_initializer=kernel_initializer,
                        bias_initializer=bias_initializer)
        return self._add_op(op, [input])[0]

    def conv2d(self, input: Tensor, out_channels: int, kernel_h: int,
               kernel_w: int, stride_h: int = 1, stride_w: int = 1,
               padding_h: int = 0, padding_w: int = 0, activation=None,
               groups: int = 1, use_bias=True, kernel_initializer=None,
               bias_initializer=None, name=None) -> Tensor:
        """NHWC conv (ops/conv.py), kernel [kh, kw, cin / groups,
        out_channels]."""
        op = O.Conv2DOp(self._fresh_name("conv2d", name),
                        [self._shape_of(input)], out_channels=out_channels,
                        kernel_h=kernel_h, kernel_w=kernel_w,
                        stride_h=stride_h, stride_w=stride_w,
                        padding_h=padding_h, padding_w=padding_w,
                        groups=groups, activation=activation,
                        use_bias=use_bias,
                        kernel_initializer=kernel_initializer,
                        bias_initializer=bias_initializer)
        return self._add_op(op, [input])[0]

    def pool2d(self, input: Tensor, kernel_h: int, kernel_w: int,
               stride_h: int = 1, stride_w: int = 1, padding_h: int = 0,
               padding_w: int = 0, pool_type: str = "max", activation=None,
               name=None) -> Tensor:
        op = O.Pool2DOp(self._fresh_name("pool2d", name),
                        [self._shape_of(input)], kernel_h=kernel_h,
                        kernel_w=kernel_w, stride_h=stride_h,
                        stride_w=stride_w, padding_h=padding_h,
                        padding_w=padding_w, pool_type=pool_type,
                        activation=activation)
        return self._add_op(op, [input])[0]

    def layer_norm(self, input: Tensor, axes=(-1,), elementwise_affine=True,
                   eps=1e-5, name=None) -> Tensor:
        op = O.LayerNormOp(self._fresh_name("layernorm", name),
                           [self._shape_of(input)], axes=tuple(axes),
                           elementwise_affine=elementwise_affine, eps=eps)
        return self._add_op(op, [input])[0]

    def batch_norm(self, input: Tensor, relu: bool = True,
                   momentum: float = 0.9, name=None) -> Tensor:
        op = O.BatchNormOp(self._fresh_name("batchnorm", name),
                           [self._shape_of(input)], relu=relu,
                           momentum=momentum)
        return self._add_op(op, [input])[0]

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: str = "none", kernel_initializer=None,
                  name=None) -> Tensor:
        op = O.EmbeddingOp(self._fresh_name("embedding", name),
                           [self._shape_of(input)], num_entries=num_entries,
                           out_dim=out_dim, aggr=aggr,
                           kernel_initializer=kernel_initializer)
        return self._add_op(op, [input])[0]

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor,
                            embed_dim: int, num_heads: int, kdim: int = 0,
                            vdim: int = 0, dropout: float = 0.0,
                            bias: bool = False, causal: bool = False,
                            sp_mode: str = "ring", kernel_initializer=None,
                            name=None) -> Tensor:
        """Multi-head attention (ops/attention.py)."""
        op = O.MultiHeadAttentionOp(
            self._fresh_name("attention", name),
            [self._shape_of(query), self._shape_of(key),
             self._shape_of(value)],
            embed_dim=embed_dim, num_heads=num_heads, kdim=kdim, vdim=vdim,
            dropout=dropout, use_bias=bias, causal=causal, sp_mode=sp_mode,
            kernel_initializer=kernel_initializer)
        return self._add_op(op, [query, key, value])[0]

    def decode_attention(self, hidden: Tensor, page_table: Tensor,
                         seq_lens: Tensor, embed_dim: int, num_heads: int,
                         page_size: int = 16, pages_per_seq: int = 8,
                         num_pages: int = 0, use_kernel: bool = True,
                         kernel_initializer=None, name=None) -> Tensor:
        """Single-token decode attention over this layer's paged KV
        cache (ops/decode_attention.py)."""
        op = O.DecodeAttentionOp(
            self._fresh_name("decode_attention", name),
            [self._shape_of(hidden), self._shape_of(page_table),
             self._shape_of(seq_lens)],
            embed_dim=embed_dim, num_heads=num_heads, page_size=page_size,
            pages_per_seq=pages_per_seq, num_pages=num_pages,
            use_kernel=use_kernel, kernel_initializer=kernel_initializer)
        return self._add_op(op, [hidden, page_table, seq_lens])[0]

    def reshape(self, input: Tensor, shape: Sequence[int],
                name=None) -> Tensor:
        op = O.ReshapeOp(self._fresh_name("reshape", name),
                         [self._shape_of(input)], shape=tuple(shape))
        return self._add_op(op, [input])[0]

    def flat(self, input: Tensor, name=None) -> Tensor:
        op = O.FlatOp(self._fresh_name("flat", name), [self._shape_of(input)])
        return self._add_op(op, [input])[0]

    def concat(self, tensors: Sequence[Tensor], axis: int,
               name=None) -> Tensor:
        op = O.ConcatOp(self._fresh_name("concat", name),
                        [self._shape_of(t) for t in tensors], axis=axis)
        return self._add_op(op, list(tensors))[0]

    def split(self, input: Tensor, sizes, axis: int,
              name=None) -> List[Tensor]:
        """``sizes``: the parts' sizes along ``axis``, or their count
        (equal parts)."""
        if isinstance(sizes, int):
            total = input.sizes[axis]
            if total % sizes:
                raise ValueError(f"{total} does not split into {sizes} "
                                 f"equal parts")
            sizes = [total // sizes] * sizes
        op = O.SplitOp(self._fresh_name("split", name),
                       [self._shape_of(input)], sizes=tuple(sizes),
                       axis=axis)
        return self._add_op(op, [input])

    def transpose(self, input: Tensor, perm: Sequence[int],
                  name=None) -> Tensor:
        op = O.TransposeOp(self._fresh_name("transpose", name),
                           [self._shape_of(input)], perm=tuple(perm))
        return self._add_op(op, [input])[0]

    def reverse(self, input: Tensor, axis: int, name=None) -> Tensor:
        op = O.ReverseOp(self._fresh_name("reverse", name),
                         [self._shape_of(input)], axis=axis)
        return self._add_op(op, [input])[0]

    def cast(self, input: Tensor, dtype, name=None) -> Tensor:
        op = O.CastOp(self._fresh_name("cast", name),
                      [self._shape_of(input)], dtype=dtype)
        return self._add_op(op, [input])[0]

    def batch_matmul(self, A: Tensor, B: Tensor, a_seq_length_dim: int = -1,
                     b_seq_length_dim: int = -1, name=None) -> Tensor:
        op = O.BatchMatmulOp(self._fresh_name("bmm", name),
                             [self._shape_of(A), self._shape_of(B)],
                             a_seq_length_dim=a_seq_length_dim,
                             b_seq_length_dim=b_seq_length_dim)
        return self._add_op(op, [A, B])[0]

    def dropout(self, input: Tensor, rate: float = 0.5, seed: int = 0,
                name=None) -> Tensor:
        op = O.DropoutOp(self._fresh_name("dropout", name),
                         [self._shape_of(input)], rate=rate, seed=seed)
        return self._add_op(op, [input])[0]

    def softmax(self, input: Tensor, axis: int = -1, name=None) -> Tensor:
        op = O.SoftmaxOp(self._fresh_name("softmax", name),
                         [self._shape_of(input)], axis=axis)
        return self._add_op(op, [input])[0]

    def mean(self, input: Tensor, dims: Sequence[int], keepdims: bool = False,
             name=None) -> Tensor:
        op = O.MeanOp(self._fresh_name("mean", name), [self._shape_of(input)],
                      dims=tuple(dims), keepdims=keepdims)
        return self._add_op(op, [input])[0]

    def top_k(self, input: Tensor, k: int, sorted: bool = True,
              name=None) -> Tuple[Tensor, Tensor]:
        op = O.TopKOp(self._fresh_name("topk", name), [self._shape_of(input)],
                      k=k, sorted=sorted)
        outs = self._add_op(op, [input])
        return outs[0], outs[1]

    def gather(self, input: Tensor, indices: Tensor, axis: int = 0,
               name=None) -> Tensor:
        op = O.GatherOp(self._fresh_name("gather", name),
                        [self._shape_of(input), self._shape_of(indices)],
                        axis=axis)
        return self._add_op(op, [input, indices])[0]

    # mixture of experts (ops/moe.py)
    def group_by(self, data: Tensor, assign: Tensor, n_experts: int,
                 alpha: float = 1.0, name=None) -> List[Tensor]:
        """(grouped [E, cap, D], expert_idx, pos, valid)."""
        op = O.GroupByOp(self._fresh_name("group_by", name),
                         [self._shape_of(data), self._shape_of(assign)],
                         n_experts=n_experts, alpha=alpha)
        return self._add_op(op, [data, assign])

    def aggregate(self, gates: Tensor, expert_idx: Tensor, pos: Tensor,
                  valid: Tensor, expert_out: Tensor, lambda_bal: float = 0.0,
                  name=None) -> Tensor:
        ins = [gates, expert_idx, pos, valid, expert_out]
        op = O.AggregateOp(self._fresh_name("aggregate", name),
                           [self._shape_of(t) for t in ins],
                           lambda_bal=lambda_bal)
        return self._add_op(op, ins)[0]

    def aggregate_spec(self, gates, expert_idx, pos, valid, expert_out,
                       lambda_bal: float = 0.0, name=None) -> Tensor:
        ins = [gates, expert_idx, pos, valid, expert_out]
        op = O.AggregateSpecOp(self._fresh_name("aggregate_spec", name),
                               [self._shape_of(t) for t in ins],
                               lambda_bal=lambda_bal)
        return self._add_op(op, ins)[0]

    def cache(self, input: Tensor, use_cached: bool = False,
              name=None) -> Tensor:
        op = O.CacheOp(self._fresh_name("cache", name),
                       [self._shape_of(input)], use_cached=use_cached)
        return self._add_op(op, [input])[0]

    # elementwise (the reference's names, model.py:377-451)
    def _unary(self, t: OperatorType, input: Tensor, name=None, scalar=0.0,
               approximate=True):
        op = O.ElementUnaryOp(self._fresh_name(t.value, name),
                              [self._shape_of(input)], unary_type=t,
                              scalar=scalar, approximate=approximate)
        return self._add_op(op, [input])[0]

    def _binary(self, t: OperatorType, a: Tensor, b: Tensor, name=None):
        op = O.ElementBinaryOp(self._fresh_name(t.value, name),
                               [self._shape_of(a), self._shape_of(b)],
                               binary_type=t)
        return self._add_op(op, [a, b])[0]

    def relu(self, x, name=None):
        return self._unary(OperatorType.RELU, x, name)

    def sigmoid(self, x, name=None):
        return self._unary(OperatorType.SIGMOID, x, name)

    def tanh(self, x, name=None):
        return self._unary(OperatorType.TANH, x, name)

    def elu(self, x, name=None):
        return self._unary(OperatorType.ELU, x, name)

    def gelu(self, x, name=None, approximate=True):
        """tanh-approximate by default; ``approximate=False`` for the
        exact erf form."""
        return self._unary(OperatorType.GELU, x, name,
                           approximate=approximate)

    def exp(self, x, name=None):
        return self._unary(OperatorType.EXP, x, name)

    def log(self, x, name=None):
        return self._unary(OperatorType.LOG, x, name)

    def identity(self, x, name=None):
        return self._unary(OperatorType.IDENTITY, x, name)

    def rsqrt(self, x, name=None):
        return self._unary(OperatorType.RSQRT, x, name)

    def pow(self, x, exponent: float, name=None):
        return self._unary(OperatorType.POW, x, name, scalar=exponent)

    def scalar_add(self, x, scalar: float, name=None):
        return self._unary(OperatorType.SCALAR_ADD, x, name, scalar=scalar)

    def scalar_sub(self, x, scalar: float, name=None):
        return self._unary(OperatorType.SCALAR_SUB, x, name, scalar=scalar)

    def scalar_multiply(self, x, scalar: float, name=None):
        return self._unary(OperatorType.SCALAR_MUL, x, name, scalar=scalar)

    def scalar_true_divide(self, x, scalar: float, name=None):
        return self._unary(OperatorType.SCALAR_TRUE_DIV, x, name,
                           scalar=scalar)

    def add(self, a, b, name=None):
        return self._binary(OperatorType.EW_ADD, a, b, name)

    def subtract(self, a, b, name=None):
        return self._binary(OperatorType.EW_SUB, a, b, name)

    def multiply(self, a, b, name=None):
        return self._binary(OperatorType.EW_MUL, a, b, name)

    def divide(self, a, b, name=None):
        return self._binary(OperatorType.EW_DIV, a, b, name)

    def max(self, a, b, name=None):
        return self._binary(OperatorType.EW_MAX, a, b, name)

    def min(self, a, b, name=None):
        return self._binary(OperatorType.EW_MIN, a, b, name)

    # parallel ops (parallel/parallel_ops.py), placed by hand in a
    # strategy's graph
    def repartition(self, input: Tensor, dim: int, degree: int,
                    name=None) -> Tensor:
        from flexflow_tpu_torch.parallel.parallel_ops import RepartitionOp

        op = RepartitionOp(self._fresh_name("repartition", name),
                           [self._shape_of(input)], dim=dim, degree=degree)
        return self._add_op(op, [input])[0]

    def combine(self, input: Tensor, dim: int, degree: int = 1,
                name=None) -> Tensor:
        from flexflow_tpu_torch.parallel.parallel_ops import CombineOp

        op = CombineOp(self._fresh_name("combine", name),
                       [self._shape_of(input)], dim=dim, degree=degree)
        return self._add_op(op, [input])[0]

    def replicate(self, input: Tensor, degree: int, name=None) -> Tensor:
        from flexflow_tpu_torch.parallel.parallel_ops import ReplicateOp

        op = ReplicateOp(self._fresh_name("replicate", name),
                         [self._shape_of(input)], degree=degree)
        return self._add_op(op, [input])[0]

    def reduction(self, input: Tensor, degree: int, name=None) -> Tensor:
        from flexflow_tpu_torch.parallel.parallel_ops import ReductionOp

        op = ReductionOp(self._fresh_name("reduction", name),
                         [self._shape_of(input)], degree=degree)
        return self._add_op(op, [input])[0]

    def node_by_name(self, name: str) -> Node:
        for node in self.graph.nodes.values():
            if node.op.name == name:
                return node
        raise KeyError(name)

    # ---- compile ---------------------------------------------------------
    def compile(self, optimizer=None,
                loss_type="sparse_categorical_crossentropy",
                metrics=("accuracy",), comp_mode: str = "training",
                strategy=None, pipeline=None, block_of=None):
        """Bind the graph to the config's device and initialise
        ``params``/``state`` from ``config.seed``.  ``strategy`` (guid ->
        ``MachineView``, optionally with a ``__meta__`` block) is None or
        trivial for one device, or any combination of batch, sequence,
        out-dim and replica splits over the job's ranks, for training or
        inference (the decode graph's head and sequence-slot splits:
        ops/decode_attention.py), with two ``start_part`` blocks the
        placed lowering.
        ``pipeline`` (a ``PipelineConfig``) runs the repeated blocks
        (``layer<i>_`` names, or ``block_of``) as a GPipe pipeline over
        ``num_stages`` stages of ranks, with the reference's guards.
        ``comp_mode="training"`` also sets the loss, the metrics and the
        optimizer (default: SGD at ``config.learning_rate`` with
        ``config.weight_decay``, as the reference's) and initialises
        ``opt_state``."""
        self._compile(optimizer, loss_type, metrics, comp_mode, strategy,
                      pipeline, block_of)

    def _compile(self, optimizer=None,
                 loss_type="sparse_categorical_crossentropy",
                 metrics=("accuracy",), comp_mode: str = "training",
                 strategy=None, pipeline=None, block_of=None, mesh=None):
        """``compile``; ``mesh`` (``runtime.distributed.mesh_over``)
        lowers a given flat strategy onto a block of the job's ranks
        instead of all of them, as a fleet replica runs
        (runtime/fleet.py); its width is ``config.num_devices``."""
        from flexflow_tpu_torch.optimizers import SGDOptimizer

        if comp_mode not in ("training", "inference"):
            raise ValueError(f"comp_mode must be 'training' or 'inference', "
                             f"got {comp_mode!r}")
        self.config.comp_mode = comp_mode
        if self.config.obs_log_file:
            # the search, compile and fit paths below all emit through
            # the bus once it is armed (reference model.py:487-493)
            from flexflow_tpu_torch.obs.events import BUS

            BUS.configure(self.config.obs_log_file)
        self.pipeline_proposal = None  # a stale proposal from an earlier
        # compile must not choose this one's lowering
        self.disaggregation = self.fleet = None
        self.serve_meta, self._kv_adopt = {}, None
        if mesh is not None and (strategy is None or pipeline is not None):
            raise ValueError(
                "a block compile lowers a given flat strategy onto a "
                "block of ranks; pass strategy= and no pipeline")
        if pipeline is not None and (
                pipeline.num_stages < 1
                or self.config.num_devices % pipeline.num_stages != 0):
            raise ValueError(
                f"pipeline.num_stages={pipeline.num_stages} must divide "
                f"num_devices={self.config.num_devices}")
        if pipeline is not None and self.config.zero_dp_shard:
            raise NotImplementedError(
                "zero_dp_shard is not supported with pipeline= yet — the "
                "pipelined lowering manages its own per-stage placement; "
                "silently ignoring the flag would leave optimizer state "
                "replicated while the user expects 1/N memory")
        if comp_mode == "training":
            self.optimizer = optimizer or SGDOptimizer(
                lr=self.config.learning_rate,
                weight_decay=self.config.weight_decay)
        if strategy is None:
            strategy, pipeline = self._choose_strategy(comp_mode, pipeline)
        else:
            pipeline = self._adopt_meta(strategy, pipeline)
            if pipeline is None:
                self._refuse_unlowerable(strategy, mesh)
        from flexflow_tpu_torch.compiler.lowering import strategy_views

        self.strategy = strategy_views(strategy)  # its __meta__ adopted
        if comp_mode == "inference" and self._kv_adopt is None and (
                self.config.kv_precision != "search"):
            self._kv_adopt = self.config.kv_precision
        self._adopt_sync(strategy, pipeline, comp_mode)
        self._compile_ctx = dict(
            strategy=strategy, pipeline=pipeline, block_of=block_of,
            loss_type=loss_type, mesh=mesh,
            metrics=metrics if comp_mode == "training" else ())
        self.compiled = self._lower(
            strategy, pipeline, block_of, loss_type,
            self._compile_ctx["metrics"],
            self.optimizer if comp_mode == "training" else None, mesh)
        self.params, self.state = self.compiled.init_params(self.config.seed)
        self.opt_state = (self.optimizer.init_state(self._slot_views())
                          if comp_mode == "training" else None)
        self.drift_report = self.lane_drift_report = None
        self.predicted_breakdown = None
        if pipeline is None and self.pipeline_proposal is None:
            self._predict(self.graph, self.strategy)
        self._export_graphs()

    @staticmethod
    def _unlowerable(finding) -> bool:
        """A ``lint_strategy`` finding of a view the flat lowering cannot
        place: a degree that does not divide its dim (SHD102), parts
        that do not divide the devices (SHD103), a replica degree past
        the op's contraction (SHD106; a split of a dim outside the op's
        splittable set, also SHD106, lowers: a sequence split of the
        inputs), degrees that do not factor onto the mesh (SHD108)."""
        return (finding.code in ("SHD102", "SHD103", "SHD108")
                or (finding.code == "SHD106"
                    and "contraction capacity" in finding.message))

    def _refuse_unlowerable(self, strategy, mesh) -> None:
        """Raise ``AnalysisError`` with ``lint_strategy``'s findings when a
        given flat strategy holds a view the lowering cannot place,
        before any weight is placed or collective run (the reference
        refuses such a view as it lowers; a searched, imported or
        trivial view never is one).  A ``num_devices`` other than the
        job's is the lowering's to refuse."""
        from flexflow_tpu_torch.analysis import (
            AnalysisError,
            errors_only,
            lint_strategy,
        )
        from flexflow_tpu_torch.compiler.lowering import strategy_views
        from flexflow_tpu_torch.runtime import distributed

        if mesh is None and self.config.num_devices != (
                distributed.world_size()):
            return
        bad = [f for f in errors_only(lint_strategy(
            self.graph, strategy_views(strategy), self.config.num_devices))
            if self._unlowerable(f)]
        if bad:
            raise AnalysisError("the given strategy holds views the "
                                "lowering cannot place on this "
                                "graph/mesh", bad)

    def _export_graphs(self) -> None:
        """``config.export_strategy_computation_graph_file`` (the graph
        under its views) and ``export_strategy_task_graph_file`` (the
        simulated task graph) as graphviz, from rank 0 (reference
        model.py:1345-1356)."""
        from flexflow_tpu_torch.runtime.distributed import rank

        cfg = self.config
        if rank() != 0:
            return
        if cfg.export_strategy_computation_graph_file:
            self.graph.write_dot(cfg.export_strategy_computation_graph_file,
                                 self.strategy)
        if cfg.export_strategy_task_graph_file:
            from flexflow_tpu_torch.search.simulator import Simulator

            # for_config: the search's devices and modes, as it costed
            Simulator.for_config(cfg).export_task_graph_dot(
                self.graph, self.strategy,
                cfg.export_strategy_task_graph_file)

    def _predict(self, graph, views, sim=None) -> None:
        """The simulator's breakdown of ``views`` on ``graph`` as
        ``predicted_breakdown`` (with ``calibrated`` and ``machine``),
        when something reads it: ``config.profiling``, the obs bus, the
        predicted timeline's file ``config.obs_trace_file`` (written
        here from the same simulation, rank 0) or a calibration file
        (reference model.py:1145-1213).  Telemetry never fails a compile
        or a swap: an error leaves it None."""
        from flexflow_tpu_torch.obs.events import BUS
        from flexflow_tpu_torch.runtime.distributed import rank

        cfg = self.config
        if not views or not (cfg.profiling or BUS.enabled
                             or cfg.obs_trace_file
                             or cfg.calibration_file):
            return
        try:
            if sim is None:
                from flexflow_tpu_torch.search.driver import (
                    coherent_calibration,
                )
                from flexflow_tpu_torch.search.simulator import Simulator

                sim = Simulator.for_config(
                    cfg, calibration=coherent_calibration(cfg))
            bd: Dict = {}
            sched: list = []
            comm: list = []
            sim.simulate(graph, views, breakdown=bd, schedule=sched,
                         comm_schedule=comm, sync_schedule=self.sync_schedule)
            bd["calibrated"] = sim.cost.calibration is not None
            bd["machine"] = cfg.machine_spec.name
            self.predicted_breakdown = bd
            if cfg.obs_trace_file and rank() == 0:
                sim.export_chrome_trace(graph, views, cfg.obs_trace_file,
                                        schedule=sched, comm_schedule=comm,
                                        total_s=bd.get("total_s"))
        except Exception:
            self.predicted_breakdown = None

    def recompile(self):
        """Re-lower the (possibly altered) graph as it was lowered
        (flat, pipelined, placed or staged: ``_lower`` with the last
        compile's strategy and options), carrying params, model state
        and optimizer slots over by name and shape (reference model.py:
        1534-1600); a weight whose shape an alteration changed keeps its
        fresh initialisation."""
        if self._compile_ctx is None:
            raise RuntimeError("call compile() first")
        ctx = self._compile_ctx
        training = self.config.comp_mode == "training"
        self.compiled = self._lower(
            ctx["strategy"], ctx["pipeline"], ctx["block_of"],
            ctx["loss_type"], ctx["metrics"],
            self.optimizer if training else None, ctx["mesh"])
        old = (self.params, self.state, self.opt_state)
        self.params, self.state = self.compiled.init_params(self.config.seed)
        self.params = _merge_matching(self.params, old[0] or {})
        self.state = _merge_matching(self.state, old[1] or {})
        if training:
            self.opt_state = _merge_matching(
                self.optimizer.init_state(self._slot_views()), old[2] or {})
        return self.compiled

    def swap_strategy(self, strategy, graph: Optional[Graph] = None,
                      config: Optional[FFConfig] = None) -> dict:
        """HOT-swap the parallelization strategy between training steps
        (reference model.py:1600-1787; runtime/controller.py drives it):
        the whole live training state (params, optimizer slots, op
        state) is snapshotted in memory (``snapshot_in_memory``, whole
        values gathered from the ranks), the model re-lowers under the
        new (graph, strategy) and every value lands on its new block
        (``restore_in_memory``), a value identity at fp32.  ``config=``
        also swaps the FFConfig: a ``num_devices`` below the job's
        lowers on the ranks ``[0, num_devices)``
        (``runtime.distributed.mesh_over``; the elastic shrink).  Every
        rank of the current mesh calls it; a rank the shrink leaves out
        takes part in the snapshot, then drops its program
        (``compiled`` None) and returns.

        Gated by ``lint_swap`` (SHD170-172 and the flat SHD1xx lint).
        The gradient-sync plan is rebuilt for the new pair; when it
        fails its own gate the swap falls back to the monolithic fp32
        sync.  Pipelined, placed, staged and user-mesh models are
        refused, in the reference's words.  Any failure past the gate
        rolls the model back whole.  The old program's captured CUDA
        graphs and static buffers are released once the new one stands.
        Returns ``{"fallback", "fresh", "dropped", "swap_seconds"}``."""
        if self.compiled is None:
            raise RuntimeError("compile() before swap_strategy")
        from flexflow_tpu_torch.analysis import (
            AnalysisError,
            emit_findings,
            errors_only,
            lint_swap,
        )
        from flexflow_tpu_torch.compiler.lowering import strategy_views
        from flexflow_tpu_torch.compiler.pipeline_lowering import (
            PipelinedCompiledModel,
        )
        from flexflow_tpu_torch.compiler.placement_lowering import (
            SegmentedModel,
        )
        from flexflow_tpu_torch.runtime.checkpoint import snapshot_in_memory

        t0 = time.perf_counter()
        ctx = self._compile_ctx
        if (ctx.get("pipeline") is not None or ctx.get("mesh") is not None
                or isinstance(self.compiled, (PipelinedCompiledModel,
                                              SegmentedModel))):
            raise NotImplementedError(
                "swap_strategy supports the flat SPMD lowering only — "
                "placed/pipelined/staged/user-mesh models manage their "
                "own placement and cannot re-shard live state this way")
        new_config = config if config is not None else self.config
        new_graph = graph if graph is not None else self.graph
        views = strategy_views(strategy)
        bad = errors_only(lint_swap(self.graph, new_graph, views,
                                    new_config.num_devices))
        if bad:
            emit_findings(bad)
            raise AnalysisError(
                "hot-swap target is illegal for the live training state",
                bad)
        mesh = _block_mesh(new_config.num_devices)
        snap = snapshot_in_memory(self)
        rollback = dict(
            config=self.config, graph=self.graph, strategy=self.strategy,
            compiled=self.compiled, params=self.params,
            opt_state=self.opt_state, state=self.state,
            sync_precision_map=self.sync_precision_map,
            sync_schedule=self.sync_schedule, zero_groups=self.zero_groups,
            predicted_breakdown=self.predicted_breakdown,
            _swap_mesh=getattr(self, "_swap_mesh", None))
        try:
            report = self._swap_strategy_inner(snap, new_config, new_graph,
                                               views, mesh, ctx, t0)
        except Exception:
            # a failed swap leaves the OLD program with the OLD state,
            # never config/graph describing a program that does not exist
            for k, v in rollback.items():
                setattr(self, k, v)
            raise
        rollback["compiled"].step_graph.release()
        return report

    def _swap_strategy_inner(self, snap, new_config, new_graph, views, mesh,
                             ctx, t0) -> dict:
        from flexflow_tpu_torch.analysis import AnalysisError, errors_only
        from flexflow_tpu_torch.compiler import lowering
        from flexflow_tpu_torch.runtime.checkpoint import restore_in_memory
        from flexflow_tpu_torch.search.driver import coherent_calibration
        from flexflow_tpu_torch.search.simulator import Simulator
        from flexflow_tpu_torch.utils.logging import SEARCH_LOG

        self.config, self.graph, self.strategy = new_config, new_graph, views
        self._swap_mesh = mesh
        if mesh is not None and not (
                mesh.start <= mesh.rank < mesh.start + mesh.world):
            # the shrink leaves this rank out: its part ended with the
            # snapshot
            self.compiled = self.params = self.opt_state = self.state = None
            return {"fresh": [], "dropped": [], "fallback": False,
                    "swap_seconds": time.perf_counter() - t0}
        # one calibration load and at most one Simulator per swap
        cal = coherent_calibration(self.config)
        sim_box: list = []

        def sim():
            if not sim_box:
                sim_box.append(Simulator.for_config(self.config,
                                                    calibration=cal))
            return sim_box[0]

        # rebuild the gradient-sync plan for the new pair; a searched
        # plan that fails its gate post-swap falls back to the
        # monolithic fp32 sync, never fails the run
        fallback = False
        pmap: Dict[str, str] = {}
        schedule = None
        zero: tuple = ()
        cfg = self.config
        plan = cfg.comp_mode == "training" and cfg.num_devices > 1
        try:
            if plan and cfg.sync_precision != "fp32":
                from flexflow_tpu_torch.search.sync_precision import (
                    choose_sync_precision,
                )

                pmap = choose_sync_precision(new_graph, views, sim().cost)
            if plan and cfg.sync_schedule == "search":
                from flexflow_tpu_torch.search.driver import (
                    _build_sync_schedule,
                )

                schedule = _build_sync_schedule(new_graph, views, sim(), cfg)
            if plan and self.zero_groups and not cfg.zero_dp_shard:
                # the per-group ZeRO map rides along only while it still
                # lints for the new pair
                from flexflow_tpu_torch.analysis import lint_zero_map
                from flexflow_tpu_torch.search.machine_model import CostModel

                zcm = CostModel(cfg.machine_spec,
                                num_devices=cfg.search_devices)
                if not errors_only(lint_zero_map(
                        new_graph, views, sorted(self.zero_groups), zcm)):
                    zero = tuple(self.zero_groups)
        except AnalysisError as e:
            fallback, pmap, schedule, zero = True, {}, None, ()
            SEARCH_LOG.log(
                f"hot swap: searched comm plan failed its legality gate "
                f"post-swap ({e}); falling back to the monolithic fp32 "
                f"sync path")
        self.sync_precision_map = pmap
        self.sync_schedule = schedule
        self.zero_groups = zero
        training = cfg.comp_mode == "training"
        self.compiled = lowering.CompiledModel(
            new_graph, cfg, loss_type=ctx["loss_type"],
            metric_types=ctx["metrics"],
            optimizer=self.optimizer if training else None,
            strategy=views, mesh=mesh, block=mesh is not None,
            sync_precision=pmap, sync_schedule=schedule, zero_groups=zero)
        self.params, self.state = self.compiled.init_params(cfg.seed)
        self.opt_state = (self.optimizer.init_state(self._slot_views())
                          if training else None)
        report = restore_in_memory(self, snap)
        if report["dropped"]:
            SEARCH_LOG.log(
                f"hot swap: {len(report['dropped'])} state entr(ies) have "
                f"no home under the new comm plan and were dropped (e.g. "
                f"{report['dropped'][:3]})")
        ctx.update(strategy=views)
        self.predicted_breakdown = None
        self._predict(new_graph, views, sim())
        report["fallback"] = fallback
        report["swap_seconds"] = time.perf_counter() - t0
        return report

    def _slot_views(self):
        """The parameters as the optimizer slots are sized: a ZeRO-1
        member weight cut to this rank's shard."""
        views = getattr(self.compiled, "slot_views", None)
        return self.params if views is None else views(self.params)

    def _adopt_sync(self, strategy, pipeline, comp_mode: str) -> None:
        """The gradient-sync plan of a training compile over ranks
        (reference model.py:999-1142): the op -> wire precision map
        (``__meta__.sync_precision``, else ``choose_sync_precision``
        under ``config.sync_precision``), the schedule under
        ``config.sync_schedule="search"`` (``__meta__.sync_schedule``,
        re-linted, else ``_build_sync_schedule``) and the per-group
        ZeRO-1 map (``__meta__.zero_groups``, re-linted; ignored under
        ``zero_dp_shard``, which arms every op).  A searched strategy
        brings rank 0's choices in its ``__meta__``, so every rank
        lowers the same plan."""
        from flexflow_tpu_torch.analysis import (
            AnalysisError,
            emit_findings,
            errors_only,
            lint_reduction_plan,
            lint_sync_schedule,
            lint_zero_map,
        )
        from flexflow_tpu_torch.compiler.lowering import strategy_views
        from flexflow_tpu_torch.search.machine_model import CostModel

        self.sync_precision_map, self.sync_schedule = {}, None
        self.zero_groups = ()
        cfg = self.config
        views = strategy_views(strategy)
        meta = (strategy or {}).get("__meta__") or {}
        if (comp_mode != "training" or not views or pipeline is not None
                or cfg.num_devices == 1):
            return
        sim = None

        def simulator():
            from flexflow_tpu_torch.search.driver import coherent_calibration
            from flexflow_tpu_torch.search.simulator import Simulator

            return Simulator.for_config(
                cfg, calibration=coherent_calibration(cfg))

        lint_cm = CostModel(cfg.machine_spec, num_devices=cfg.search_devices)
        pmap = meta.get("sync_precision")
        if pmap is not None:
            from flexflow_tpu_torch.search.sync_schedule import (
                BUCKET_PRECISIONS,
            )

            names = {n.op.name for n in self.graph.topo_order()}
            if not isinstance(pmap, dict) or any(
                    k not in names or v not in BUCKET_PRECISIONS
                    for k, v in pmap.items()):
                raise AnalysisError(
                    "strategy __meta__ carries a malformed sync_precision "
                    "map (expected op name -> fp32|bf16|int8|int8_ef)", [])
            self.sync_precision_map = {k: v for k, v in pmap.items()
                                       if v != "fp32"}
        elif cfg.sync_precision != "fp32":
            from flexflow_tpu_torch.search.sync_precision import (
                choose_sync_precision,
            )

            sim = simulator()
            self.sync_precision_map = choose_sync_precision(
                self.graph, views, sim.cost)
        if cfg.sync_schedule == "search":
            raw = meta.get("sync_schedule")
            if raw is not None:
                from flexflow_tpu_torch.search.sync_schedule import (
                    SyncSchedule,
                )

                try:
                    sched = SyncSchedule.from_jsonable(raw)
                except ValueError as e:
                    raise AnalysisError(
                        f"strategy __meta__ carries a malformed "
                        f"sync_schedule: {e}", []) from e
                bad = errors_only(
                    lint_sync_schedule(self.graph, views, sched,
                                       self.sync_precision_map)
                    + lint_reduction_plan(self.graph, views, sched,
                                          lint_cm))
                if bad:
                    emit_findings(bad)
                    raise AnalysisError(
                        "imported sync_schedule is illegal for this "
                        "graph/strategy", bad)
                self.sync_schedule = sched
            else:
                from flexflow_tpu_torch.search.driver import (
                    _build_sync_schedule,
                )

                self.sync_schedule = _build_sync_schedule(
                    self.graph, views, sim or simulator(), cfg)
        zero = meta.get("zero_groups")
        if zero is not None and not cfg.zero_dp_shard:
            if (not isinstance(zero, list)
                    or any(not isinstance(z, str) for z in zero)):
                raise AnalysisError(
                    "strategy __meta__ carries a malformed zero_groups map "
                    "(expected a list of op names)", [])
            bad = errors_only(lint_zero_map(self.graph, views, zero,
                                            lint_cm))
            if bad:
                emit_findings(bad)
                raise AnalysisError(
                    "imported zero_groups map is illegal for this "
                    "graph/strategy", bad)
            self.zero_groups = tuple(zero)

    def sync_meta(self) -> dict:
        """The gradient-sync plan as ``__meta__`` entries (the
        reference's ``sync_schedule`` and ``zero_groups``, and the
        port's ``sync_precision`` map)."""
        meta = {}
        if self.sync_precision_map:
            meta["sync_precision"] = dict(sorted(
                self.sync_precision_map.items()))
        if self.sync_schedule is not None:
            meta["sync_schedule"] = self.sync_schedule.to_jsonable()
        if self.zero_groups:
            meta["zero_groups"] = sorted(self.zero_groups)
        return meta

    def _choose_strategy(self, comp_mode: str, pipeline):
        """(views, pipeline) for ``compile(strategy=None)`` (module
        docstring): data parallelism over one stage's ranks under
        ``pipeline``, an imported strategy file, data parallelism under
        ``only_data_parallel``, else the search's, with ``self.graph``
        replaced by its graph and a winning proposal adopted."""
        from flexflow_tpu_torch.compiler.lowering import (
            data_parallel_strategy,
        )
        from flexflow_tpu_torch.runtime import distributed

        cfg = self.config
        world = distributed.world_size()
        if pipeline is not None:
            # dp over the ranks left after the pp axis is carved off
            return data_parallel_strategy(
                self.graph, cfg.num_devices // pipeline.num_stages), pipeline
        if cfg.import_strategy_file:
            strategy = self._import_strategy()
            return strategy, self._adopt_meta(strategy, None)
        if cfg.only_data_parallel:
            return data_parallel_strategy(self.graph, cfg.num_devices), None
        if world == 1:
            graph, export, stats, proposal = self._search(comp_mode)
        else:
            graph, export, stats, proposal = self._search_on_rank0(comp_mode)
        _check_searched_graph(graph)
        self.graph = graph
        self.search_stats = stats
        from flexflow_tpu_torch.search import strategy_io

        meta = export.get(strategy_io.META_KEY) or {}
        # no flat strategy fits: the search returns no views (a staged
        # proposal may still lower)
        views = (strategy_io.strategy_from_dict(
            export, graph, source="the searched strategy")
            if len(export) > 1 else {})
        pipeline = self._adopt_meta(
            dict(views, __meta__={k: meta[k] for k in (
                "pipeline", "placement") + _SERVE_META if k in meta}),
            None)
        if proposal is not None:
            self.pipeline_proposal = proposal
        sync = {k: meta[k] for k in ("sync_precision", "sync_schedule",
                                     "zero_groups") if k in meta}
        return (dict(views, __meta__=sync) if sync else views), pipeline

    def _search(self, comp_mode: str):
        """The flat search, then the pipeline and placement proposals in
        the reference's order and under its conditions (model.py:850-935:
        training only, no ZeRO; a pipeline first, then a two-block
        placement, then, when no flat strategy fits, a general staged
        pipeline); for an inference compile under ``objective="serve"``
        the serve proposals instead (model.py:942-998): the prefill/
        decode disaggregation under ``serve_disaggregation="search"``
        and the fleet under ``serve_fleet="search"``, kept in
        ``self.disaggregation`` and ``self.fleet``.  Returns (graph, the
        export of the views to lower with the winning proposal and the
        serve objective's blocks in ``__meta__``, the search's stats,
        the staged proposal or None)."""
        import math

        from flexflow_tpu_torch.compiler.lowering import (
            data_parallel_strategy,
        )
        from flexflow_tpu_torch.search import driver, strategy_io

        cfg = self.config
        base = self.graph  # the narrow-block solves start from it
        graph, views = driver.optimize_strategy(self.graph, cfg,
                                                return_graph=True)
        stats = dict(driver.LAST_SEARCH_STATS)
        meta, proposal = {}, None
        if cfg.objective == "serve" and comp_mode == "inference":
            meta.update(self._serve_proposals(graph, views, base))
        # the search's gradient-sync choices ride the export to every
        # rank (dropped below if a proposal replaces the views)
        searched = views
        sync_meta = {}
        if driver.LAST_SYNC_SCHEDULE is not None:
            sync_meta["sync_schedule"] = (
                driver.LAST_SYNC_SCHEDULE.to_jsonable())
        if driver.LAST_ZERO_GROUPS:
            sync_meta["zero_groups"] = sorted(driver.LAST_ZERO_GROUPS)
        if (cfg.sync_precision != "fp32" and comp_mode == "training"
                and views):
            from flexflow_tpu_torch.search.simulator import Simulator
            from flexflow_tpu_torch.search.sync_precision import (
                choose_sync_precision,
            )

            sim = Simulator.for_config(
                cfg, calibration=driver.coherent_calibration(cfg))
            pmap = choose_sync_precision(graph, views, sim.cost)
            if pmap:
                sync_meta["sync_precision"] = pmap
        if ((cfg.enable_pipeline_search or cfg.enable_placement_search)
                and not cfg.zero_dp_shard and comp_mode == "training"):
            from flexflow_tpu_torch.search.pipeline_search import (
                propose_pipeline,
            )
            from flexflow_tpu_torch.search.simulator import Simulator

            # same cost currency as the flat search that just ran
            calibration = driver.coherent_calibration(cfg)
            sim = Simulator.for_config(cfg, calibration=calibration)
            baseline = sim.simulate(graph, views)
            prop = (propose_pipeline(graph, cfg, sim, baseline)
                    if cfg.enable_pipeline_search else None)
            if prop is not None and (
                    cfg.num_devices % prop.num_stages == 0
                    and cfg.batch_size % prop.num_microbatches == 0):
                views = data_parallel_strategy(
                    graph, cfg.num_devices // prop.num_stages)
                meta["pipeline"] = {"num_stages": prop.num_stages,
                                    "num_microbatches":
                                        prop.num_microbatches}
            elif cfg.enable_placement_search:
                from flexflow_tpu_torch.analysis import placement_meta
                from flexflow_tpu_torch.search.placement_search import (
                    propose_placement,
                )

                placed = propose_placement(graph, cfg, baseline,
                                           calibration=calibration)
                if placed is not None:
                    views = placed
                    meta["placement"] = placement_meta(graph, placed, cfg)
                elif not math.isfinite(baseline):
                    # nothing flat fits: cost the general staged shape
                    from flexflow_tpu_torch.search.pipeline_search import (
                        propose_pipeline_general,
                    )
                    from flexflow_tpu_torch.utils.logging import SEARCH_LOG

                    proposal = propose_pipeline_general(graph, cfg, sim,
                                                        baseline)
                    if proposal is not None:
                        SEARCH_LOG.log(
                            f"staged-pipeline candidate: S="
                            f"{proposal.num_stages} M="
                            f"{proposal.num_microbatches} modeled "
                            f"{proposal.cost * 1e3:.3f} ms/iter "
                            f"(flat is infeasible)")
                        meta["pipeline"] = {
                            "num_stages": proposal.num_stages,
                            "num_microbatches": proposal.num_microbatches,
                            "stages": [[graph.nodes[g].op.name for g in st]
                                       for st in proposal.stage_guids]}
        if views is searched and comp_mode == "training":
            meta.update(sync_meta)
        export = strategy_io.strategy_to_dict(graph, views, meta or None)
        return graph, export, stats, proposal

    def _serve_proposals(self, graph, views, base) -> dict:
        """The serve objective's ``__meta__`` blocks after its search
        (reference model.py:942-998, 1262-1299): the driver's gated
        ``serving`` and ``kv`` provenance, then an adopted
        disaggregation and fleet proposal (priced with the search's
        calibration; both kept in ``self.disaggregation`` and
        ``self.fleet``, honest zeros included)."""
        from flexflow_tpu_torch.search import driver

        cfg = self.config
        meta = {}
        if driver.LAST_SERVING_META:
            meta["serving"] = dict(driver.LAST_SERVING_META)
        if driver.LAST_KV_META:
            meta["kv"] = dict(driver.LAST_KV_META)
        if not views:
            return meta
        calibration = driver.coherent_calibration(cfg)
        base = base if base is not graph else None
        if cfg.serve_disaggregation == "search":
            from flexflow_tpu_torch.search.disaggregation import (
                propose_disaggregation,
            )

            prop = self.disaggregation = propose_disaggregation(
                graph, views, cfg, calibration=calibration, base_graph=base)
            if prop is not None and prop.adopted:
                meta["disaggregation"] = prop.to_meta()
        if cfg.serve_fleet == "search":
            from flexflow_tpu_torch.search.fleet import propose_fleet

            prop = self.fleet = propose_fleet(
                graph, views, cfg, calibration=calibration, base_graph=base)
            if prop is not None and prop.adopted:
                meta["fleet"] = prop.to_meta()
        return meta

    def _search_on_rank0(self, comp_mode: str):
        """Rank 0 runs ``_search``; every rank gets its (graph, export,
        stats, proposal), the graph checked against the digest rank 0
        sent (``_choose_strategy`` then imports the views and the
        proposal's ``__meta__`` through the export's digest gate and the
        placement lints, so no two ranks can lower differently).  Every
        rank gets the serve proposals too (a fleet replica's graph and
        views ride them), and an error of rank 0's search or proposals
        is broadcast in place of its result, so every rank raises it and
        none waits for a result that never comes."""
        import pickle

        import torch.distributed as dist

        from flexflow_tpu_torch.runtime import distributed
        from flexflow_tpu_torch.search.cost_cache import stable_graph_digest

        payload = [None]
        if distributed.rank() == 0:
            try:
                graph, export, stats, proposal = self._search(comp_mode)
                payload[0] = {"graph": graph,
                              "digest": stable_graph_digest(graph),
                              "export": export, "stats": stats,
                              "proposal": proposal,
                              "serve": (self.disaggregation, self.fleet)}
            except Exception as e:
                try:
                    pickle.dumps(e)
                    payload[0] = {"error": e}
                except Exception:
                    payload[0] = {"error": RuntimeError(
                        f"rank 0's strategy search raised "
                        f"{type(e).__name__}: {e}")}
        dist.broadcast_object_list(payload, src=0)
        got = payload[0]
        if "error" in got:
            raise got["error"]
        graph = got["graph"]
        if stable_graph_digest(graph) != got["digest"]:
            raise RuntimeError(
                f"rank {distributed.rank()}: the searched graph arrived with "
                f"digest {stable_graph_digest(graph)}, rank 0 sent "
                f"{got['digest']}")
        self.disaggregation, self.fleet = got["serve"]
        return graph, got["export"], got["stats"], got["proposal"]

    def _import_strategy(self):
        """``config.import_strategy_file`` through the digest gate and
        the flat lint (reference model.py:562-592; with
        ``config.import_strategy_partial`` the gate's findings are
        warnings and the matching views apply), its ``__meta__`` kept
        under the ``"__meta__"`` key for ``_adopt_meta``."""
        from flexflow_tpu_torch.analysis import (
            AnalysisError,
            emit_findings,
            errors_only,
            lint_strategy,
        )
        from flexflow_tpu_torch.search.strategy_io import (
            import_strategy,
            read_meta,
        )

        path = self.config.import_strategy_file
        try:
            strategy = import_strategy(
                path, self.graph,
                allow_partial=self.config.import_strategy_partial)
        except AnalysisError as e:
            err = AnalysisError(
                f"{e}\n(hint: a strategy exported after a REWRITING "
                f"search is keyed to the rewritten graph and cannot "
                f"re-apply to a fresh frontend build — use the persistent "
                f"cost cache (FFConfig.cost_cache_file) for cross-process "
                f"reuse of rewritten searches)")
            err.findings = list(e.findings)
            raise err from e
        bad = errors_only(lint_strategy(self.graph, strategy,
                                        self.config.num_devices))
        if bad:
            emit_findings(bad)
            raise AnalysisError(f"imported strategy {path!r} is illegal for "
                                f"this graph/mesh", bad)
        strategy["__meta__"] = read_meta(path)
        return strategy

    def _adopt_meta(self, strategy, pipeline):
        """Check a strategy's ``__meta__.placement`` and
        ``__meta__.pipeline`` blocks against this graph (SHD150-155; an
        illegal block raises ``AnalysisError`` with its findings) and
        adopt the pipeline one (reference model.py:590-620, 720-816): a
        stage cut becomes ``self.pipeline_proposal`` (the staged
        lowering), S x M alone a ``PipelineConfig`` as if passed to
        ``compile(pipeline=...)``.  Returns the pipeline to lower."""
        from flexflow_tpu_torch.analysis import (
            AnalysisError,
            Finding,
            emit_findings,
            errors_only,
            lint_pipeline_stages,
            lint_placement,
            placement_meta,
        )

        meta = (strategy or {}).get("__meta__") or {}
        views = {k: v for k, v in (strategy or {}).items()
                 if k != "__meta__"}
        self._adopt_serve_meta(views, meta)
        if meta.get("placement") is not None:
            bad = errors_only(lint_placement(self.graph, views,
                                             self.config))
            if not bad and placement_meta(
                    self.graph, views, self.config) != meta["placement"]:
                bad = [Finding(
                    code="SHD153", pass_name="placement",
                    message=("imported __meta__.placement block frame "
                             "disagrees with the device blocks the "
                             "strategy's start_part views actually form"))]
            if bad:
                emit_findings(bad)
                raise AnalysisError(
                    "imported placement proposal is illegal for this "
                    "graph/strategy", bad)
        pmeta = meta.get("pipeline")
        if pmeta is None:
            return pipeline
        bad, stage_guids, ns, nm = [], None, 0, 0
        # a hand-edited meta block may carry ANY JSON type: malformed
        # shapes become findings, never a bare TypeError
        if not isinstance(pmeta, dict):
            bad = [Finding(code="SHD150", pass_name="placement",
                           message="imported __meta__.pipeline is not an "
                                   "object")]
        else:
            ns = pmeta.get("num_stages", 0)
            nm = pmeta.get("num_microbatches", 0)
            stages = pmeta.get("stages")
            if (not isinstance(ns, int) or not isinstance(nm, int)
                    or isinstance(ns, bool) or isinstance(nm, bool)):
                bad = [Finding(
                    code="SHD150", pass_name="placement",
                    message=(f"imported __meta__.pipeline has non-integer "
                             f"num_stages/num_microbatches ({ns!r}, "
                             f"{nm!r})"))]
            elif stages is not None and not (
                    isinstance(stages, list)
                    and all(isinstance(st, list)
                            and all(isinstance(op, str) for op in st)
                            for st in stages)):
                bad = [Finding(
                    code="SHD150", pass_name="placement",
                    message=("imported __meta__.pipeline stages is not a "
                             "list of op-name lists"))]
            elif stages is not None:
                by_name = {n.op.name: n.guid for n in self.graph.topo_order()}
                stage_guids = [[by_name.get(op, -1) for op in st]
                               for st in stages]
        if not bad:
            bad = errors_only(lint_pipeline_stages(
                self.graph, stage_guids, ns, nm, self.config))
        if bad:
            emit_findings(bad)
            raise AnalysisError(
                "imported pipeline proposal is illegal for this "
                "graph/strategy", bad)
        if stage_guids is not None:
            from flexflow_tpu_torch.search.pipeline_search import (
                StagedPipelineProposal,
            )

            self.pipeline_proposal = StagedPipelineProposal(
                num_stages=ns, num_microbatches=nm, stage_guids=stage_guids,
                cost=float("nan"), executable=False)
            return pipeline
        if pipeline is None:
            from flexflow_tpu_torch.parallel.pipeline import PipelineConfig

            if self.config.zero_dp_shard:
                raise NotImplementedError(
                    "zero_dp_shard is not supported with an imported "
                    "pipeline proposal")
            pipeline = PipelineConfig(num_stages=ns, num_microbatches=nm)
        return pipeline

    def _adopt_serve_meta(self, views, meta) -> None:
        """Re-lint the serve objective's ``__meta__`` blocks against this
        graph and strategy, searched or imported (reference model.py:
        622-720; an illegal block raises ``AnalysisError`` with its
        findings): ``serving`` (SHD160-163, priced by an inference cost
        model armed with its spec), ``kv`` (SHD168-169; its pool dtype
        is adopted onto the decode ops when the strategy lowers),
        ``disaggregation`` (SHD164-165) and ``fleet`` (SHD166-167)."""
        if not any(meta.get(k) is not None for k in _SERVE_META):
            return
        from flexflow_tpu_torch.analysis import (
            AnalysisError,
            emit_findings,
            errors_only,
            lint_disaggregation,
            lint_fleet,
            lint_kv,
            lint_serving,
        )

        cfg = self.config

        def gate(bad, what):
            if bad:
                emit_findings(bad)
                raise AnalysisError(f"imported {what} is illegal for this "
                                    f"graph/strategy", bad)

        spec = None
        sv = meta.get("serving")
        if sv is not None:
            from flexflow_tpu_torch.search.machine_model import CostModel
            from flexflow_tpu_torch.search.serving import ServingSpec

            try:
                spec = ServingSpec(
                    max_seqs=int(sv["max_seqs"]),
                    page_size=int(sv["page_size"]),
                    pages_per_seq=int(sv["pages_per_seq"]),
                    p99_budget_ms=float(sv.get("p99_budget_ms", 0.0)),
                    quantile=float(sv.get("quantile", 0.99)),
                    # residency was ranked under the kv block's sharing
                    shared_prefix_pages=int((meta.get("kv") or {}).get(
                        "shared_prefix_pages", 0) or 0))
            except (KeyError, TypeError, ValueError) as e:
                raise AnalysisError(
                    f"imported strategy carries a malformed "
                    f"__meta__.serving block: {e}", []) from e
            gate(errors_only(lint_serving(
                self.graph, views, spec,
                CostModel(cfg.machine_spec, num_devices=cfg.search_devices,
                          inference=cfg.comp_mode == "inference",
                          serving=spec))), "serving provenance")
        if meta.get("kv") is not None:
            gate(errors_only(lint_kv(self.graph, views, meta["kv"],
                                     serving=spec)), "__meta__.kv block")
            self._kv_adopt = meta["kv"].get("dtype")
        if meta.get("disaggregation") is not None:
            gate(errors_only(lint_disaggregation(
                self.graph, meta["disaggregation"], cfg)),
                "disaggregation proposal")
        if meta.get("fleet") is not None:
            gate(errors_only(lint_fleet(self.graph, meta["fleet"], cfg)),
                 "fleet proposal")
        self.serve_meta = {k: meta[k] for k in _SERVE_META
                           if meta.get(k) is not None}

    def _lower(self, strategy, pipeline, block_of, loss_type, metrics,
               optimizer, mesh=None):
        """The compiled model of ``strategy``: the placed lowering for a
        two-block ``start_part`` strategy it can run (after the always-on
        placement lint), the pipelined one under ``pipeline``, the staged
        one for an adopted stage cut (its refusals keep the flat
        lowering, as the reference's do), else the flat one (on
        ``mesh`` when given).  Exports the strategy with its proposal
        and the serve objective's blocks first (from rank 0) when
        ``config.export_strategy_file`` is set; then adopts the pool
        dtype (``kv``, or a pinned ``kv_precision``) onto the decode
        ops, so the export's digests stay those of the attr-free graph
        (reference model.py:1358-1362)."""
        from flexflow_tpu_torch.analysis import (
            AnalysisError,
            emit_findings,
            errors_only,
            lint_placement,
            placement_meta,
        )
        from flexflow_tpu_torch.compiler.lowering import (
            CompiledModel,
            strategy_views,
        )
        from flexflow_tpu_torch.compiler.placement_lowering import placeable

        cfg = self.config
        views = strategy_views(strategy)
        placed = (pipeline is None and bool(views)
                  and placeable(self.graph, views, cfg))
        bad = (errors_only(lint_placement(self.graph, views, cfg))
               if placed else [])
        from flexflow_tpu_torch.runtime.distributed import rank

        if cfg.export_strategy_file and rank() == 0:  # one writer per job
            from flexflow_tpu_torch.search.strategy_io import export_strategy

            meta = {}
            if placed and not bad:
                meta["placement"] = placement_meta(self.graph, views, cfg)
            if self.pipeline_proposal is not None:
                p = self.pipeline_proposal
                meta["pipeline"] = {
                    "num_stages": p.num_stages,
                    "num_microbatches": p.num_microbatches,
                    "stages": [[self.graph.nodes[g].op.name for g in st]
                               for st in p.stage_guids]}
            elif pipeline is not None:
                meta["pipeline"] = {
                    "num_stages": pipeline.num_stages,
                    "num_microbatches": pipeline.num_microbatches}
            if not placed and pipeline is None:
                meta.update(self.sync_meta())
            meta.update(self.serve_meta)
            export_strategy(cfg.export_strategy_file, self.graph, views,
                            meta=meta or None)
        _adopt_kv_dtype(self.graph, self._kv_adopt)
        if (placed or pipeline is not None) and self.sync_meta():
            # the reference's honesty rule: these lowerings run their
            # own gradient paths, so the plan cannot run there
            from flexflow_tpu_torch.utils.logging import SEARCH_LOG

            SEARCH_LOG.log(
                f"the gradient-sync plan ({sorted(self.sync_meta())}) "
                f"does not run in the placed or pipelined lowering; "
                f"gradients sync in fp32")
            self.sync_precision_map, self.sync_schedule = {}, None
            self.zero_groups = ()
        if placed:
            if bad:
                emit_findings(bad)
                raise AnalysisError(
                    "placed strategy is illegal for this graph/mesh", bad)
            from flexflow_tpu_torch.compiler.placement_lowering import (
                PlacedCompiledModel,
            )

            return PlacedCompiledModel(self.graph, views, cfg, loss_type,
                                       list(metrics), optimizer)
        if pipeline is not None:
            from flexflow_tpu_torch.compiler.pipeline_lowering import (
                PipelinedCompiledModel,
            )

            return PipelinedCompiledModel(
                self.graph, cfg, loss_type, list(metrics), optimizer, views,
                pipeline=pipeline, block_of=block_of)
        if (self.pipeline_proposal is not None
                and cfg.comp_mode == "training"):
            from flexflow_tpu_torch.compiler.staged_pipeline_lowering import (
                StagedPipelinedModel,
            )
            from flexflow_tpu_torch.utils.logging import SEARCH_LOG

            p = self.pipeline_proposal
            try:
                return StagedPipelinedModel(
                    self.graph, p.stage_guids, p.num_microbatches, cfg,
                    loss_type, list(metrics), optimizer)
            except (NotImplementedError, ValueError) as e:
                # stateful stages etc.: keep the flat lowering (the
                # proposal stays on self.pipeline_proposal)
                SEARCH_LOG.log(f"staged pipeline refused ({e}); the flat "
                               f"lowering runs")
        return CompiledModel(self.graph, cfg, loss_type=loss_type,
                             metric_types=metrics, optimizer=optimizer,
                             strategy=strategy, mesh=mesh,
                             sync_precision=self.sync_precision_map,
                             sync_schedule=self.sync_schedule,
                             zero_groups=self.zero_groups)

    # ---- training loop ---------------------------------------------------
    def fit(self, x=None, y=None, batch_size: Optional[int] = None,
            epochs: Optional[int] = None, shuffle: bool = True,
            verbose: bool = True, callbacks: Sequence = (),
            recompile_state=None, validation_data=None,
            validation_split: float = 0.0,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
            resume: bool = False):
        """The training loop (reference ``FFModel.fit``, model.py:
        1790-2100): batches from ``SingleDataLoader`` (the reference's
        seeded shuffle), one training step each, metrics summed on the
        device and read once per epoch.  With ``config.trace_steps`` n >
        1, a job of one process, no ``recompile_state`` and at least n
        batches, the batches go n at a time through ``train_steps`` (one
        graph replay for n steps) and the rest one by one, as the
        reference's ``iter_traced`` loop does.  Every optimizer step
        advances ``_rng_counter`` by one and takes it as its seed, so a
        traced run draws the masks of a stepwise one.

        ``callbacks`` follow the keras protocol, duck-typed: ``set_model``
        (when the callback has no model yet), ``on_train_begin``,
        ``on_epoch_begin(epoch)``, ``on_epoch_end(epoch, logs)`` (False
        stops training after the epoch, as does a model's
        ``stop_training`` set True), ``on_train_end``.
        ``recompile_state`` (``runtime.recompile.RecompileState``) is
        checked once per step; the step it re-lowers the model in drops
        its metrics.  ``validation_data=(vx, vy)`` is evaluated after
        each epoch and joins the logs as ``val_*`` keys;
        ``validation_split=f`` holds out the last fraction of (x, y),
        before any shuffle, by keras's formula.  ``checkpoint_dir``
        snapshots the training state every ``checkpoint_every`` epochs
        and after the last (``runtime.checkpoint``); ``resume=True``
        restores the newest complete snapshot and continues at its next
        epoch, the shuffle stream fast-forwarded to it.

        With ``config.profiling`` a ``StepProfiler`` times every step
        (its ``dispatch`` and ``wait`` phases, the device fenced each
        step) and its summary lands on ``profile_summary``, the metrics
        registry and the bus, with a ``DriftReport`` against the
        compile's prediction (reference ``_report_profile``).  With
        ``config.device_trace_dir`` the steps after the first call run
        under ``runtime.profiler.device_trace`` (one ``ff.phase/step``
        range per optimizer step, the sync buckets' lanes stamped; one
        call per step, as under profiling; on the card the first step
        under the profiler opens no range, so no window takes its
        start), and the capture is ingested into ``lane_drift_report``
        against the predicted lanes.
        Telemetry never fails a fit, and with neither set the steps
        launch what they did before.

        Returns the history, one dict per epoch with the metrics'
        report, the epoch's last loss and the ``val_*`` keys.  Sets
        ``last_throughput`` (samples/s after the first call, which is
        fenced and left off the clock with the step's capture, as the
        reference leaves its compile) and ``step_losses`` (every step's
        loss, read after the loop).  Under a strategy every rank runs
        this loop on its blocks of the batches: the samples are the
        job's, the losses and metrics the job's, and only rank 0
        prints."""
        from flexflow_tpu_torch.metrics import PerfMetrics
        from flexflow_tpu_torch.runtime.dataloader import SingleDataLoader
        from flexflow_tpu_torch.runtime.distributed import world_size

        if self.compiled is None:
            raise RuntimeError("call compile() first")
        if self.config.comp_mode != "training":
            raise RuntimeError("model was compiled with comp_mode="
                               "'inference'; recompile with comp_mode="
                               "'training' to fit()")
        batch_size = batch_size or self.config.batch_size
        if validation_split:
            x, y, validation_data = _split_validation(
                x, y, validation_split, validation_data)
        if validation_data is not None:
            _check_validation(validation_data, batch_size)
        ckpt = None
        start_epoch = 0
        if checkpoint_dir is not None:
            from flexflow_tpu_torch.runtime.checkpoint import (
                CheckpointManager,
            )

            ckpt = CheckpointManager(checkpoint_dir)
            if resume and ckpt.latest_step() is not None:
                start_epoch = ckpt.restore(self) + 1
        elif resume:
            raise ValueError("resume=True requires checkpoint_dir")
        for cb in callbacks:
            if hasattr(cb, "set_model") and getattr(cb, "model", None) is None:
                cb.set_model(self)
        xs = x if isinstance(x, (list, tuple)) else [x]
        epochs = epochs or self.config.epochs
        loader = SingleDataLoader(self.compiled, [np.asarray(a) for a in xs],
                                  np.asarray(y), batch_size, shuffle=shuffle,
                                  seed=self.config.seed)
        loader.skip_epochs(start_epoch)  # a resumed epoch N: its order
        if loader.num_batches == 0:
            raise ValueError(f"no full batch: {loader.num_samples} samples "
                             f"< batch_size {batch_size}")
        for cb in callbacks:
            cb.on_train_begin()
        profiler = None
        if self.config.profiling:
            from flexflow_tpu_torch.runtime.profiler import StepProfiler

            profiler = StepProfiler()
        capture_dir = self.config.device_trace_dir
        capture = None  # the live DeviceTrace, from the second call on
        capture_warm = False  # the step that absorbs the profiler's start
        self.lane_drift_report = self.profile_summary = None
        trace_n = max(1, int(self.config.trace_steps))
        use_trace = (trace_n > 1 and world_size() == 1
                     and recompile_state is None and profiler is None
                     and not capture_dir
                     and loader.num_batches >= trace_n)
        metrics = PerfMetrics()
        history = []
        losses = []
        t_start, steps_at_t0, steps_done = None, 0, 0
        self.stop_training = False
        for epoch in range(start_epoch, epochs):
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            metrics.reset()
            acc = None
            batches = (loader.iter_traced(trace_n) if use_trace else
                       (("single", i, l) for i, l in loader))
            for kind, inputs, labels in batches:
                if kind == "single":  # train_step: a stack of one
                    inputs, labels = [x[None] for x in inputs], labels[None]
                n = len(labels)
                seeds = np.arange(self._rng_counter + 1,
                                  self._rng_counter + n + 1, dtype=np.int64)
                self._rng_counter += n
                step_span = None
                if capture is not None and not capture_warm:
                    from flexflow_tpu_torch.obs import annotate

                    # one ff.phase/step range per optimizer step: the
                    # window trace_ingest assigns lane marks to
                    step_span = annotate.phase_span(annotate.STEP_PHASE)
                    step_span.__enter__()
                if profiler is not None:
                    profiler.start_step()
                    profiler.start_phase("dispatch")
                (self.params, self.opt_state, self.state, step_loss,
                 ms) = self.compiled.train_steps(
                    self.params, self.opt_state, self.state, inputs, labels,
                    seeds)
                # the results are static buffers that the next call
                # overwrites: keep a copy of the losses; the metric sums
                # are new tensors
                losses.append(step_loss.clone())
                if profiler is not None:
                    # host phases: issue (dispatch) against the device's
                    # completion (wait); the fence makes the step real
                    profiler.end_phase("dispatch")
                    profiler.start_phase("wait")
                    float(losses[-1][-1])
                    profiler.end_phase("wait")
                    profiler.end_step()
                if step_span is not None:
                    step_span.__exit__(None, None, None)
                elif capture_warm:
                    from flexflow_tpu_torch.obs import annotate

                    float(losses[-1][-1])  # the windows start after it
                    annotate.LANES.clear()
                    capture_warm = False
                if (recompile_state is not None
                        and recompile_state.check(self)):
                    acc = None  # the re-lowered step's metrics may differ
                else:
                    m = {k: v.sum(dim=0) for k, v in ms.items()}
                    acc = m if acc is None else {k: acc[k] + v
                                                 for k, v in m.items()}
                steps_done += n
                if t_start is None:
                    float(losses[-1][-1])  # fence: off the clock
                    if capture_dir:
                        # after the first call (the step's capture), so
                        # the trace holds steady steps only; its start
                        # (seconds of the profiler's set-up on the card)
                        # stays off the throughput clock
                        capture = self._start_capture(capture_dir)
                        # on the card the first step under the profiler
                        # opens no window: a graph replay's kernels went
                        # missing from a window right after the start
                        capture_warm = (capture is not None
                                        and capture.device.type == "cuda")
                    t_start = time.perf_counter()
                    steps_at_t0 = steps_done
            if acc is not None:
                metrics.update(acc)
            logs = metrics.report()
            logs["loss"] = float(losses[-1][-1])
            if verbose and self._prints():
                print(f"epoch {epoch}: loss={logs['loss']:.4f} {metrics}")
            if validation_data is not None:
                vx, vy = validation_data
                val = self.evaluate(x=vx, y=vy, batch_size=batch_size)
                for k, v in val.items():
                    if k != "samples":
                        logs[f"val_{k}"] = v
                if verbose and self._prints():
                    print("  validation: " + " ".join(
                        f"{k}: {v:.4f}" for k, v in logs.items()
                        if k.startswith("val_")))
            history.append(logs)
            stop = False
            for cb in callbacks:
                if cb.on_epoch_end(epoch, logs) is False:
                    stop = True
            stop = stop or bool(self.stop_training)
            if ckpt is not None and (
                    (epoch + 1) % max(1, checkpoint_every) == 0
                    or epoch == epochs - 1 or stop):
                ckpt.save(epoch, self)
            if stop:
                break
        for cb in callbacks:
            cb.on_train_end()
        if ckpt is not None:
            ckpt.close()
        trace_file = None
        if capture is not None:
            try:
                trace_file = capture.stop()  # waits for the device
            except Exception:  # telemetry never fails a fit
                trace_file = None
        if not losses:
            return history
        elapsed = time.perf_counter() - t_start  # float(loss) above fenced
        if steps_done > steps_at_t0 and elapsed > 0:
            self.last_throughput = ((steps_done - steps_at_t0) * batch_size
                                    / elapsed)
            if verbose and self._prints():
                print(f"ELAPSED TIME = {elapsed:.4f}s, THROUGHPUT = "
                      f"{self.last_throughput:.2f} samples/s")
        self.step_losses = torch.cat(losses).tolist()
        if profiler is not None:
            self._report_profile(profiler, verbose and self._prints())
        if trace_file is not None:
            self._ingest_device_trace(trace_file, verbose and self._prints())
        return history

    def _start_capture(self, capture_dir: str):
        """``fit``'s ``device_trace`` over its post-compile steps (None
        when it cannot start: telemetry never fails a fit)."""
        from flexflow_tpu_torch.runtime.profiler import DeviceTrace

        try:
            return DeviceTrace(capture_dir, self.compiled.device).start()
        except Exception:
            return None

    def _ingest_device_trace(self, trace_file: str, verbose: bool) -> None:
        """Close the measured side of the lane loop (reference
        model.py:2101-2150): parse the capture ``fit`` just wrote,
        tag-match it against the compile-time predicted sync lanes and
        fill the per-bucket measured fields of ``drift_report``.  The
        report lands on ``self.lane_drift_report`` (which the
        controller's drift watch reads) and, when exporting, in the
        strategy file's ``__meta__``."""
        from flexflow_tpu_torch.runtime.distributed import rank

        try:
            from flexflow_tpu_torch.obs.events import BUS
            from flexflow_tpu_torch.obs.trace_ingest import (
                apply_lane_measurements,
                build_lane_drift_report,
            )

            report = build_lane_drift_report(
                trace_file, self.predicted_breakdown,
                threshold=self.config.drift_threshold)
            self.lane_drift_report = report
            if report is None:
                return
            apply_lane_measurements(self.drift_report, report)
            if verbose:
                print(f"LANES {report}")
            if self.config.export_strategy_file and rank() == 0:
                from flexflow_tpu_torch.search.strategy_io import attach_meta

                try:
                    attach_meta(self.config.export_strategy_file,
                                lane_drift=report.to_dict())
                except (OSError, ValueError):
                    pass
            BUS.flush()
        except Exception:  # telemetry never fails a fit
            self.lane_drift_report = None

    def _report_profile(self, profiler, verbose: bool) -> None:
        """Step-profile reporting through the obs metrics registry and
        event bus, plus the predicted-against-measured ``DriftReport``
        when compile recorded a prediction, with the reference's
        staleness marks on the calibration table and the cost cache
        (reference model.py:2152-2253)."""
        from flexflow_tpu_torch.obs.drift import build_drift_report
        from flexflow_tpu_torch.obs.events import BUS
        from flexflow_tpu_torch.obs.metrics import METRICS

        s = profiler.summary()
        if s.get("steps") and not s.get("includes_compile"):
            # a compile-contaminated summary stays out of the registry:
            # a gauge has no flag to carry the caveat
            METRICS.gauge("fit.step_mean_s").set(s["mean_s"])
            METRICS.gauge("fit.step_p95_s").set(s["p95_s"])
            METRICS.counter("fit.steps").inc(int(s["steps"]))
            hist = METRICS.histogram("fit.step_s")
            for t in profiler.step_times[1:]:
                hist.observe(t)
        BUS.emit("profile.summary", **s)
        if verbose:
            print(f"PROFILE {profiler}")
        self.profile_summary = s
        pred = self.predicted_breakdown
        if not pred or not s.get("steps") or s.get("includes_compile"):
            return
        report = build_drift_report(
            pred, measured_step_s=s["mean_s"],
            measured_phases=profiler.phase_summary(),
            threshold=self.config.drift_threshold,
            calibrated=bool(pred.get("calibrated")))
        if report is None:
            return
        self.drift_report = report
        BUS.emit("drift.report", **report.to_dict())
        METRICS.gauge("fit.drift_ratio").set(report.ratio)
        cal_file = self.config.calibration_file
        if report.calibration_stale:
            from flexflow_tpu_torch.search.calibration import (
                CalibrationTable,
            )
            from flexflow_tpu_torch.search.cost_cache import (
                mark_calibration_stale,
                resolve_cost_cache_path,
            )
            from flexflow_tpu_torch.utils.logging import SEARCH_LOG

            BUS.emit("calibration.staleness", ratio=report.ratio,
                     threshold=report.threshold)
            lo = 1.0 / (1.0 + report.threshold)
            hi = 1.0 + report.threshold
            SEARCH_LOG.log(
                f"calibration staleness: measured step is "
                f"{report.ratio:.2f}x the calibrated prediction, outside "
                f"[{lo:.2f}x, {hi:.2f}x]")
            # the next search re-probes the drifted records, and the
            # cost cache stops serving rows priced with them
            if cal_file and CalibrationTable.mark_stale_file(
                    cal_file, report.ratio):
                SEARCH_LOG.log(f"calibration table {cal_file} marked "
                               f"stale")
            cache_path = resolve_cost_cache_path(self.config)
            if cache_path and mark_calibration_stale(cache_path):
                SEARCH_LOG.log(f"cost cache {cache_path} marked "
                               f"calibration-stale")
        elif report.calibrated and cal_file:
            from flexflow_tpu_torch.search.calibration import (
                CalibrationTable,
            )

            CalibrationTable.mark_healthy_file(cal_file)
        if verbose:
            print(f"DRIFT {report}")
        if self.config.export_strategy_file:
            from flexflow_tpu_torch.runtime.distributed import rank
            from flexflow_tpu_torch.search.strategy_io import attach_meta

            if rank() == 0:
                try:
                    attach_meta(self.config.export_strategy_file,
                                drift=report.to_dict())
                except (OSError, ValueError):
                    pass
        BUS.flush()

    def _prints(self) -> bool:
        from flexflow_tpu_torch.runtime.distributed import rank

        return rank() == 0

    def evaluate(self, x=None, y=None, batch_size: Optional[int] = None):
        """Loss and metrics over full batches, in order, no gradients
        (the job's, under a strategy)."""
        from flexflow_tpu_torch.metrics import PerfMetrics
        from flexflow_tpu_torch.runtime.dataloader import SingleDataLoader

        xs = x if isinstance(x, (list, tuple)) else [x]
        batch_size = batch_size or self.config.batch_size
        loader = SingleDataLoader(self.compiled, [np.asarray(a) for a in xs],
                                  np.asarray(y), batch_size, shuffle=False)
        metrics = PerfMetrics()
        total_loss, batches = 0.0, 0
        for inputs, labels in loader:
            loss, m = self.compiled.eval_step(self.params, self.state,
                                              inputs, labels)
            total_loss += float(loss)
            batches += 1
            metrics.update(m)
        rep = metrics.report()
        if batches:  # equal-sized batches: the mean of batch means
            rep["loss"] = total_loss / batches
        return rep

    def predict(self, x, batch_size: Optional[int] = None) -> np.ndarray:
        """Batched forward pass, one output row per input row (a short
        tail batch is padded with its last row to batch_size and
        trimmed, as the reference does).  Under a strategy each rank
        feeds its blocks and gets the whole output back."""
        if self.compiled is None:
            raise RuntimeError("call compile() first")
        batch_size = batch_size or self.config.batch_size
        xs = [np.asarray(a) for a in (x if isinstance(x, (list, tuple))
                                      else [x])]
        fwd = self.compiled.forward_fn()
        outs = []
        for i in range(0, xs[0].shape[0], batch_size):
            batch = [a[i:i + batch_size] for a in xs]
            got = batch[0].shape[0]
            if got < batch_size:
                batch = [np.concatenate(
                    [b, np.repeat(b[-1:], batch_size - got, axis=0)])
                    for b in batch]
            ins = [torch.from_numpy(np.ascontiguousarray(
                b[self.compiled.input_slices(j, b.shape)])).to(
                    self.compiled.device) for j, b in enumerate(batch)]
            y = fwd(self.params, self.state, ins)
            outs.append(y[:got].float().cpu().numpy())
        if not outs:
            raise ValueError("predict() got no rows")
        return np.concatenate(outs, axis=0)

    # ------------------------------------------------------------------
    def get_weight(self, op_name: str, weight_name: str = "kernel"
                   ) -> np.ndarray:
        """The whole weight (under a strategy, gathered from the ranks
        that hold it: every rank calls it)."""
        from flexflow_tpu_torch.interop import tensor_to_numpy

        return tensor_to_numpy(self.compiled.gather_weights(
            self.params, [(op_name, weight_name)])[op_name][weight_name])

    def set_state_var(self, key: str, value: np.ndarray) -> None:
        """Overwrite one model-state entry in place (e.g. a batch-norm
        running statistic, key ``"<op>/running_mean"``, or a cache op's
        ``"<op>/cached"``); its tensor keeps its address, so a captured
        step reads the new value."""
        from flexflow_tpu_torch.interop import tensor_from_numpy

        old = self.state[key]
        value = np.asarray(value)
        if tuple(old.shape) != value.shape:
            raise ValueError(f"{key}: shape {value.shape} is not the "
                             f"state's {tuple(old.shape)}")
        with torch.no_grad():
            old.copy_(tensor_from_numpy(value, old.device))

    def set_weight(self, op_name: str, weight_name: str,
                   value: np.ndarray) -> None:
        """Set the whole weight (under a strategy, each rank that holds
        it keeps its block of ``value``)."""
        if not self.compiled.holds(op_name):
            return
        old = self.params[op_name][weight_name]
        new = params_from_numpy({op_name: {weight_name: value}}, old.device,
                                self.compiled)[op_name][weight_name]
        if new.shape != old.shape:
            raise ValueError(f"{op_name}/{weight_name}: shape "
                             f"{np.shape(value)} does not give this rank's "
                             f"{tuple(old.shape)}")
        self.params[op_name][weight_name] = new.to(old.dtype)
