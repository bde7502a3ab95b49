"""The forward check of ``__graft_entry__.py::entry`` for the port.

``entry()`` builds the same small Transformer encoder as the
reference's (``build_transformer``: 2 layers, hidden 128, 4 heads, ff
256, seq 64, batch 8, bf16 compute), compiles it for the mean squared
error and returns ``(fn, example_args)``: ``fn(x)`` runs the compiled
forward (``CompiledModel.forward_fn``) on its weights, ``x`` a zero
float32 [8, 64, 128] input.  The model runs on the card unless
``device="cpu"`` asks for the CPU; ``entry(...)[0].model`` is the
model, for copying weights in or out.
"""

from __future__ import annotations

import numpy as np
import torch


def entry(device: str = "cuda"):
    """(fn, example_args): forward of a small Transformer encoder."""
    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.models import build_transformer

    cfg = ff.FFConfig(batch_size=8, num_devices=1, only_data_parallel=True,
                      compute_dtype="bfloat16", device=device)
    model = build_transformer(cfg, num_layers=2, hidden=128, num_heads=4,
                              ff_dim=256, seq_len=64)
    model.compile(loss_type="mean_squared_error",
                  metrics=["mean_squared_error"])
    fwd = model.compiled.forward_fn()

    @torch.no_grad()
    def fn(x):
        x = torch.as_tensor(np.asarray(x)).to(model.compiled.device)
        return fwd(model.params, model.state, [x])

    fn.model = model
    x = np.zeros((8, 64, 128), np.float32)
    return fn, (x,)
