"""Graph execution on one device — the single-device part of
flexflow_tpu/compiler/lowering.py (``CompiledModel.init_params`` and
``apply``).

PyTorch runs eagerly, so "lowering" is running each node's ``forward``
in topological order.  Weights are seeded by NAME, as the reference's
``weight_fold_key`` does: each weight draws from its own
``torch.Generator`` seeded from the model seed and crc32 of
``"op/weight"``, so initialisation does not depend on the order the
graph enumerates its nodes.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Sequence, Tuple

import torch

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import Graph, Node
from flexflow_tpu_torch.ops.base import LoweringContext
from flexflow_tpu_torch.ops.inout import InputOp


def weight_generator(seed: int, op_name: str, w_name: str) -> torch.Generator:
    """The CPU generator one weight draws from: keyed by the model seed
    and crc32 of the weight's name."""
    crc = zlib.crc32(f"{op_name}/{w_name}".encode())
    return torch.Generator().manual_seed(((seed & 0xFFFFFFFF) << 32) | crc)


class CompiledModel:
    """A graph bound to one device: ``init_params`` and ``apply``."""

    def __init__(self, graph: Graph, config: FFConfig):
        self.graph = graph
        self.config = config
        self.device = config.torch_device()
        self.compute_dtype = config.torch_compute_dtype
        self._topo = graph.topo_order()
        self._input_nodes: List[Node] = sorted(
            (n for n in self._topo if isinstance(n.op, InputOp)),
            key=lambda n: n.op.attrs.get("tensor_guid", n.guid))
        sinks = graph.sinks()
        if not sinks:
            raise ValueError("empty graph")
        self._sink = sinks[-1]

    def init_params(self, seed: int = 0):
        """Fresh ``params[op_name][weight_name]`` and
        ``state["<op>/<var>"]`` tensors on the model's device."""
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        state: Dict[str, torch.Tensor] = {}
        for node in self._topo:
            op = node.op
            for ws in op._weight_specs:
                w = ws.initializer.init(
                    weight_generator(seed, op.name, ws.name), ws.shape)
                params.setdefault(op.name, {})[ws.name] = w.to(
                    device=self.device, dtype=ws.dtype.to_torch())
            specs = getattr(op, "state_specs", None)
            if specs is None:
                continue
            for name, shape, dtype, fill in specs():
                state[f"{op.name}/{name}"] = torch.full(
                    shape, fill, dtype=dtype, device=self.device)
        return params, state

    @torch.no_grad()
    def apply(self, params, state, inputs: Sequence[torch.Tensor]
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward through the graph; returns (sink output, new state).
        ``inputs`` bind in frontend tensor-guid order."""
        if len(inputs) != len(self._input_nodes):
            raise ValueError(f"expected {len(self._input_nodes)} inputs, "
                             f"got {len(inputs)}")
        ctx = LoweringContext(compute_dtype=self.compute_dtype,
                              state_in=state)
        values: Dict[Tuple[int, int], torch.Tensor] = {}
        for node, x in zip(self._input_nodes, inputs):
            values[(node.guid, 0)] = x
        for node in self._topo:
            if isinstance(node.op, InputOp):
                continue
            edges = sorted(self.graph.in_edges[node.guid],
                           key=lambda e: e.dst_idx)
            ins = [values[(e.src, e.src_idx)] for e in edges]
            outs = node.op.forward(ctx, ins, params.get(node.op.name, {}))
            for i, y in enumerate(outs):
                values[(node.guid, i)] = y
        new_state = dict(state)
        new_state.update(ctx.state_out)
        return values[(self._sink.guid, 0)], new_state
