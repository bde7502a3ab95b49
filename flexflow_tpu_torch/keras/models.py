"""Sequential / functional Model: the JAX package's keras/models.py
(after FlexFlow's python/flexflow/keras/models/base_model.py:127-451 —
compile builds the FFModel + optimizer, fit creates dataloaders and
drives the train loop with callbacks) over the port's FFModel.  The
model lives where ``compile``'s config says (the card by default);
``get_weights`` brings each weight to the host through
``interop.tensor_to_numpy`` (bfloat16 and card tensors included)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.interop import tensor_to_numpy
from flexflow_tpu_torch.keras.layers import InputLayer, KTensor, Layer
from flexflow_tpu_torch.keras.losses import resolve_loss
from flexflow_tpu_torch.keras.metrics import resolve_metrics
from flexflow_tpu_torch.keras.optimizers import resolve_optimizer


class _BaseModel:
    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__.lower()
        self.ffmodel = None
        self.ffconfig: Optional[FFConfig] = None
        self._loss = None
        self._metrics: List[str] = []
        self._optimizer = None
        self.history: List[Dict[str, float]] = []

    def _renumber_auto_names(self) -> None:
        """Auto-generated layer names are renumbered per model in topo
        order at compile time, so weight/checkpoint keys depend only on
        the model structure — not on how many layers any earlier model
        in the process created."""
        counts: Dict[str, int] = {}
        for layer in self._topo_layers():
            if not getattr(layer, "_auto_named", False):
                continue
            base = type(layer).__name__.lower()
            i = counts.get(base, 0)
            counts[base] = i + 1
            layer.name = f"{base}_{i}" if i else base

    # -- to be provided by subclasses -------------------------------------
    def _topo_layers(self) -> List[Layer]:
        raise NotImplementedError

    def _input_layers(self) -> List[InputLayer]:
        raise NotImplementedError

    def _output_tensors(self) -> List[KTensor]:
        raise NotImplementedError

    # ------------------------------------------------------------------
    def compile(self, optimizer="sgd", loss="sparse_categorical_crossentropy",
                metrics=("accuracy",), config: Optional[FFConfig] = None,
                batch_size: Optional[int] = None, **ff_kwargs):
        """Build the FFModel graph and pick a strategy
        (reference: base_model.py:127-194)."""
        import flexflow_tpu_torch as ff

        self.ffconfig = config or FFConfig()
        if batch_size:
            self.ffconfig.batch_size = batch_size
        self._loss = resolve_loss(loss)
        self._metrics = resolve_metrics(metrics)
        self._optimizer = resolve_optimizer(optimizer, self.ffconfig)

        model = ff.FFModel(self.ffconfig)
        self._renumber_auto_names()
        env: Dict[int, object] = {}
        # input tensors are created in user order (Model(inputs=[...]) /
        # Sequential first layer); the lowering binds fit/predict arrays
        # by tensor creation order, so this IS the data binding order
        for inp in self._input_layers():
            kt = inp.outputs[0]
            dims = (self.ffconfig.batch_size,) + tuple(
                int(s) for s in kt.shape[1:]
            )
            env[kt.guid] = model.create_tensor(dims, dtype=kt.dtype, name=inp.name)
        for layer in self._topo_layers():
            if isinstance(layer, InputLayer):
                continue
            ins = [env[t.guid] for t in layer.inbound]
            out = layer.emit(model, ins)
            outs = out if isinstance(out, list) else [out]
            for kt, t in zip(layer.outputs, outs):
                env[kt.guid] = t
        self.ffmodel = model
        model.compile(optimizer=self._optimizer, loss_type=self._loss,
                      metrics=self._metrics, **ff_kwargs)
        return self

    # ------------------------------------------------------------------
    def fit(self, x=None, y=None, epochs: int = 1, batch_size: Optional[int] = None,
            callbacks: Sequence = (), shuffle: bool = True, verbose: bool = True,
            **fit_kwargs):
        """Training with callbacks — delegates to FFModel.fit, the single
        train loop (reference: base_model.py:195-256 + callbacks.py).
        Extra kwargs (checkpoint_dir/checkpoint_every/resume,
        recompile_state) pass through to FFModel.fit."""
        assert self.ffmodel is not None, "call compile() first"
        for cb in callbacks:
            cb.set_model(self)
        self.history = self.ffmodel.fit(
            x=x, y=y, batch_size=batch_size, epochs=epochs, shuffle=shuffle,
            verbose=verbose, callbacks=callbacks, **fit_kwargs,
        )
        return self.history

    def evaluate(self, x=None, y=None, batch_size: Optional[int] = None):
        return self.ffmodel.evaluate(x=x, y=y, batch_size=batch_size)

    def predict(self, x, batch_size: Optional[int] = None):
        """Forward pass over x in batches; one row out per row in —
        delegates to FFModel.predict (the single implementation)."""
        return self.ffmodel.predict(x, batch_size=batch_size)

    # weight access (reference: get_weight_tensor/set_weight_tensor)
    def get_weights(self, layer_name: str) -> Dict[str, np.ndarray]:
        return {k: tensor_to_numpy(v)
                for k, v in self.ffmodel.params[layer_name].items()}

    def set_weights(self, layer_name: str, weights: Dict[str, np.ndarray]):
        for k, v in weights.items():
            self.ffmodel.set_weight(layer_name, k, v)

    def summary(self) -> str:
        lines = [f'Model: "{self.name}"']
        for layer in self._topo_layers():
            shapes = [t.shape for t in layer.outputs]
            lines.append(f"  {layer.name:30s} {type(layer).__name__:20s} {shapes}")
        return "\n".join(lines)


class Sequential(_BaseModel):
    """reference: keras/models Sequential."""

    def __init__(self, layers: Sequence[Layer] = (), name=None):
        super().__init__(name)
        self._layers: List[Layer] = []
        for l in layers:
            self.add(l)

    def add(self, layer: Layer):
        if not self._layers:
            if isinstance(layer, InputLayer):
                self._layers.append(layer)
                return self
            assert layer.input_shape is not None, (
                "first layer needs input_shape= (or add an InputLayer)")
            inp = InputLayer(layer.input_shape)
            self._layers.append(inp)
            layer(inp.outputs[0])
        else:
            prev = self._layers[-1]
            layer(prev.outputs[0])
        self._layers.append(layer)
        return self

    def _topo_layers(self):
        return list(self._layers)

    def _input_layers(self):
        return [self._layers[0]]

    def _output_tensors(self):
        return [self._layers[-1].outputs[0]]


class Model(_BaseModel):
    """Functional API (reference: keras/models Model(inputs, outputs))."""

    def __init__(self, inputs, outputs, name=None):
        super().__init__(name)
        self.inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self.outputs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        self._topo = self._toposort()

    def _toposort(self) -> List[Layer]:
        seen: Dict[int, Layer] = {}
        order: List[Layer] = []

        def visit(t: KTensor):
            layer = t.layer
            if layer is None or id(layer) in seen:
                return
            seen[id(layer)] = layer
            for up in layer.inbound:
                visit(up)
            order.append(layer)

        for t in self.outputs:
            visit(t)
        return order

    def _topo_layers(self):
        return list(self._topo)

    def _input_layers(self):
        # user order from Model(inputs=[...]), NOT topo discovery order —
        # fit([xa, xb], y) must bind arrays to these positions
        declared = [t.layer for t in self.inputs]
        assert all(isinstance(l, InputLayer) for l in declared), (
            "Model(inputs=...) must be Input()/InputLayer tensors")
        extra = [l for l in self._topo
                 if isinstance(l, InputLayer) and l not in declared]
        assert not extra, (
            f"graph reaches Input layers not listed in Model(inputs=...): "
            f"{[l.name for l in extra]}")
        return declared

    def _output_tensors(self):
        return list(self.outputs)
