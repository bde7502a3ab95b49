"""Carry parameters and state between the JAX package and the port.

``params_from_numpy`` and ``state_from_numpy`` take the reference's
``params[op][weight]`` and ``state["<op>/<var>"]`` dicts as numpy
arrays (``np.asarray`` of each JAX array) and return the port's tensors
on a chosen device; ``params_to_numpy`` is the way back (host numpy
arrays, e.g. to compare gradients and updated weights).  bfloat16 is
carried bit for bit both ways (numpy's ml_dtypes extension type, loaded
only when a bfloat16 tensor goes back).  This is how a test makes both
packages compute the same function.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    a = np.array(a)  # a writable copy the tensor may own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params) -> Dict[str, Dict[str, np.ndarray]]:
    return {op: {w: tensor_to_numpy(v) for w, v in ws.items()}
            for op, ws in params.items()}


def params_from_numpy(params, device="cpu"
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    return {op: {w: tensor_from_numpy(v, device) for w, v in ws.items()}
            for op, ws in params.items()}


def state_from_numpy(state, device="cpu") -> Dict[str, torch.Tensor]:
    return {k: tensor_from_numpy(v, device) for k, v in state.items()}
