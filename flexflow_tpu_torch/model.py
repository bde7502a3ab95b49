"""FFModel — the model-building API, ported from flexflow_tpu/model.py.

The builder methods the decode and transformer graphs call
(``create_tensor``, ``create_constant``, ``embedding``, ``reshape``,
``add``, ``layer_norm``, ``dense``, ``multihead_attention``,
``decode_attention``) build a lazy graph; ``compile`` binds it to the
config's device with the trivial single-device strategy and initialises
``params``, ``state`` and, for training, the optimizer state.  ``fit``,
``evaluate`` and ``predict`` run over numpy data.  The strategy search
and the multi-device lowerings come with later slices.
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
from flexflow_tpu_torch.interop import tensor_from_numpy, tensor_to_numpy
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
        self.opt_state = None
        self.optimizer = None
        self.last_throughput = None
        self.step_losses: List[float] = []

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

    def add(self, a: Tensor, b: Tensor, name=None) -> Tensor:
        op = O.ElementBinaryOp(self._fresh_name("ew_add", name),
                               [self._shape_of(a), self._shape_of(b)],
                               binary_type=OperatorType.EW_ADD)
        return self._add_op(op, [a, b])[0]

    # ---- compile ---------------------------------------------------------
    def compile(self, optimizer=None,
                loss_type="sparse_categorical_crossentropy",
                metrics=("accuracy",), comp_mode: str = "training"):
        """Bind the graph to the config's device with the trivial
        single-device strategy and initialise ``params``/``state`` from
        ``config.seed``.  ``comp_mode="training"`` also sets the loss,
        the metrics and the optimizer (default: SGD at
        ``config.learning_rate`` with ``config.weight_decay``, as the
        reference's) and initialises ``opt_state``."""
        from flexflow_tpu_torch.compiler.lowering import CompiledModel
        from flexflow_tpu_torch.optimizers import SGDOptimizer

        if comp_mode not in ("training", "inference"):
            raise ValueError(f"comp_mode must be 'training' or 'inference', "
                             f"got {comp_mode!r}")
        self.config.comp_mode = comp_mode
        if comp_mode == "training":
            self.optimizer = optimizer or SGDOptimizer(
                lr=self.config.learning_rate,
                weight_decay=self.config.weight_decay)
        self.compiled = CompiledModel(
            self.graph, self.config, loss_type=loss_type,
            metric_types=metrics if comp_mode == "training" else (),
            optimizer=self.optimizer if comp_mode == "training" else None)
        self.params, self.state = self.compiled.init_params(self.config.seed)
        self.opt_state = (self.optimizer.init_state(self.params)
                          if comp_mode == "training" else None)

    # ---- training loop ---------------------------------------------------
    def fit(self, x=None, y=None, batch_size: Optional[int] = None,
            epochs: Optional[int] = None, shuffle: bool = True,
            verbose: bool = True, callbacks: Sequence = (),
            recompile_state=None, validation_data=None,
            validation_split: float = 0.0,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
            resume: bool = False):
        """The training loop (reference ``FFModel.fit``, the subset of
        one device): batches from ``SingleDataLoader`` (the reference's
        seeded shuffle), one ``train_step`` each, metrics summed on the
        device and read once per epoch.  Returns the history, one dict
        per epoch with the metrics' report and the epoch's last loss.
        Sets ``last_throughput`` (samples/s after the first step, which
        is fenced and left off the clock, as the reference does) and
        ``step_losses`` (every step's loss, read after the loop).

        Not ported yet, and raising when asked for: callbacks,
        recompile_state, validation data or split, checkpoints and
        resume."""
        from flexflow_tpu_torch.metrics import PerfMetrics
        from flexflow_tpu_torch.runtime.dataloader import SingleDataLoader

        unported = {"callbacks": bool(callbacks),
                    "recompile_state": recompile_state is not None,
                    "validation_data": validation_data is not None,
                    "validation_split": bool(validation_split),
                    "checkpoint_dir": checkpoint_dir is not None,
                    "checkpoint_every": checkpoint_every != 1,
                    "resume": resume}
        asked = sorted(k for k, v in unported.items() if v)
        if asked:
            raise NotImplementedError(
                f"fit({', '.join(asked)}) is not ported yet")
        if self.compiled is None:
            raise RuntimeError("call compile() first")
        if self.config.comp_mode != "training":
            raise RuntimeError("model was compiled with comp_mode="
                               "'inference'; recompile with comp_mode="
                               "'training' to fit()")
        xs = x if isinstance(x, (list, tuple)) else [x]
        batch_size = batch_size or self.config.batch_size
        epochs = epochs or self.config.epochs
        loader = SingleDataLoader(self.compiled, [np.asarray(a) for a in xs],
                                  np.asarray(y), batch_size, shuffle=shuffle,
                                  seed=self.config.seed)
        if loader.num_batches == 0:
            raise ValueError(f"no full batch: {loader.num_samples} samples "
                             f"< batch_size {batch_size}")
        metrics = PerfMetrics()
        history = []
        losses = []
        t_start, steps_at_t0, steps_done = None, 0, 0
        loss = None
        for epoch in range(epochs):
            metrics.reset()
            acc = None
            for inputs, labels in loader:
                (self.params, self.opt_state, self.state, loss, m) = (
                    self.compiled.train_step(self.params, self.opt_state,
                                             self.state, inputs, labels))
                losses.append(loss)
                acc = m if acc is None else {k: acc[k] + v
                                             for k, v in m.items()}
                steps_done += 1
                if t_start is None:
                    float(loss)  # fence: the first step stays off the clock
                    t_start = time.perf_counter()
                    steps_at_t0 = steps_done
            metrics.update(acc)
            logs = metrics.report()
            logs["loss"] = float(loss)
            if verbose:
                print(f"epoch {epoch}: loss={logs['loss']:.4f} {metrics}")
            history.append(logs)
        elapsed = time.perf_counter() - t_start  # float(loss) above fenced
        if steps_done > steps_at_t0 and elapsed > 0:
            self.last_throughput = ((steps_done - steps_at_t0) * batch_size
                                    / elapsed)
            if verbose:
                print(f"ELAPSED TIME = {elapsed:.4f}s, THROUGHPUT = "
                      f"{self.last_throughput:.2f} samples/s")
        self.step_losses = torch.stack(losses).tolist()
        return history

    def evaluate(self, x=None, y=None, batch_size: Optional[int] = None):
        """Loss and metrics over full batches, in order, no gradients."""
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
        trimmed, as the reference does)."""
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
            ins = [torch.from_numpy(np.ascontiguousarray(b)).to(
                self.compiled.device) for b in batch]
            y = fwd(self.params, self.state, ins)
            outs.append(y[:got].float().cpu().numpy())
        if not outs:
            raise ValueError("predict() got no rows")
        return np.concatenate(outs, axis=0)

    # ------------------------------------------------------------------
    def get_weight(self, op_name: str, weight_name: str = "kernel"
                   ) -> np.ndarray:
        return tensor_to_numpy(self.params[op_name][weight_name])

    def set_weight(self, op_name: str, weight_name: str,
                   value: np.ndarray) -> None:
        old = self.params[op_name][weight_name]
        if tuple(old.shape) != tuple(np.shape(value)):
            raise ValueError(f"{op_name}/{weight_name}: shape "
                             f"{np.shape(value)} != {tuple(old.shape)}")
        self.params[op_name][weight_name] = tensor_from_numpy(
            value, old.device).to(old.dtype)
