"""FFModel — the model-building API, ported from flexflow_tpu/model.py.

The builder methods the decode graph calls (``create_tensor``,
``embedding``, ``reshape``, ``add``, ``layer_norm``, ``dense``,
``decode_attention``) build a lazy graph; ``compile`` binds it to the
config's device and initialises ``params`` and ``state``.  Only
``comp_mode="inference"`` is ported: training, its optimizers and the
strategy search come with later slices.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import Graph, Node
from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape, Tensor
from flexflow_tpu_torch import ops as O


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

    def dense(self, input: Tensor, out_dim: int, activation=None,
              use_bias=True, kernel_initializer=None, bias_initializer=None,
              name=None) -> Tensor:
        op = O.LinearOp(self._fresh_name("dense", name),
                        [self._shape_of(input)], out_dim=out_dim,
                        activation=activation, use_bias=use_bias,
                        kernel_initializer=kernel_initializer,
                        bias_initializer=bias_initializer)
        return self._add_op(op, [input])[0]

    def layer_norm(self, input: Tensor, axes=(-1,), elementwise_affine=True,
                   eps=1e-5, name=None) -> Tensor:
        op = O.LayerNormOp(self._fresh_name("layernorm", name),
                           [self._shape_of(input)], axes=tuple(axes),
                           elementwise_affine=elementwise_affine, eps=eps)
        return self._add_op(op, [input])[0]

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: str = "none", kernel_initializer=None,
                  name=None) -> Tensor:
        op = O.EmbeddingOp(self._fresh_name("embedding", name),
                           [self._shape_of(input)], num_entries=num_entries,
                           out_dim=out_dim, aggr=aggr,
                           kernel_initializer=kernel_initializer)
        return self._add_op(op, [input])[0]

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

    def add(self, a: Tensor, b: Tensor, name=None) -> Tensor:
        op = O.ElementBinaryOp(self._fresh_name("ew_add", name),
                               [self._shape_of(a), self._shape_of(b)],
                               binary_type=OperatorType.EW_ADD)
        return self._add_op(op, [a, b])[0]

    # ---- compile ---------------------------------------------------------
    def compile(self, comp_mode: str = "training"):
        """Bind the graph to the config's device and initialise
        ``params``/``state`` from ``config.seed``."""
        from flexflow_tpu_torch.compiler.lowering import CompiledModel

        if comp_mode == "training":
            raise NotImplementedError(
                "comp_mode='training' comes with the training slice of the "
                "port (flash attention kernels, losses, optimizers); this "
                "slice serves decode graphs with comp_mode='inference'")
        if comp_mode != "inference":
            raise ValueError(f"comp_mode must be 'training' or 'inference', "
                             f"got {comp_mode!r}")
        self.compiled = CompiledModel(self.graph, self.config)
        self.params, self.state = self.compiled.init_params(self.config.seed)
