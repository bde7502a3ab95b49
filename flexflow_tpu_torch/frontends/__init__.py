"""Frontends — import models from other ecosystems onto the port's
FFModel, with the JAX package's exports (flexflow_tpu/frontends):

* ``torch_fx``: the torch.fx symbolic-trace importer and the
  ``torch_to_flexflow`` record file (the same file both packages read);
* ``onnx_frontend``: the ONNX graph importer (``onnx`` when installed,
  else the wire-format reader of ``onnx_minimal``);
* ``tf_keras``: the tf.keras layer-graph importer (TensorFlow only when
  a ``TFKerasModel`` is made).
"""

from flexflow_tpu_torch.frontends.torch_fx import (  # noqa: F401
    PyTorchModel,
    torch_to_flexflow,
    transfer_torch_weights,
)
from flexflow_tpu_torch.frontends.onnx_frontend import ONNXModel  # noqa: F401
from flexflow_tpu_torch.frontends.tf_keras import (  # noqa: F401
    TFKerasModel,
    transfer_tf_weights,
)

__all__ = [
    "PyTorchModel",
    "torch_to_flexflow",
    "transfer_torch_weights",
    "ONNXModel",
    "TFKerasModel",
    "transfer_tf_weights",
]
