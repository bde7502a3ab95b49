"""``flexflow_tpu_torch.graft_entry.entry`` against
``__graft_entry__.entry``: the same small Transformer encoder (2
layers, hidden 128, 4 heads, ff 256, seq 64, batch 8, bf16 compute),
the port's weights copied from the JAX model (name-seeded, so the JAX
package's rebuild here holds the weights its ``entry`` closes over).
The outputs on the example input and on a random one agree within 2e-2
of the largest output entry (bf16 compute on both sides)."""

from __future__ import annotations

import numpy as np

from flexflow_tpu_torch.graft_entry import entry
from flexflow_tpu_torch.interop import params_from_numpy


def _jax_params():
    import flexflow_tpu as ff
    from flexflow_tpu.models import build_transformer

    cfg = ff.FFConfig(batch_size=8, num_devices=1, only_data_parallel=True,
                      compute_dtype="bfloat16", cost_cache_file="")
    m = build_transformer(cfg, num_layers=2, hidden=128, num_heads=4,
                          ff_dim=256, seq_len=64)
    m.compile(loss_type="mean_squared_error",
              metrics=["mean_squared_error"])
    return {op: {w: np.array(v) for w, v in ws.items()}
            for op, ws in m.params.items()}


def test_entry_matches_the_reference_entry():
    import __graft_entry__

    jfn, (jx,) = __graft_entry__.entry()
    fn, (x,) = entry(device="cpu")
    assert x.shape == jx.shape == (8, 64, 128) and x.dtype == jx.dtype
    fn.model.params = params_from_numpy(_jax_params())
    rng = np.random.default_rng(0)
    for inp in (x, rng.normal(size=x.shape).astype(np.float32)):
        ref = np.asarray(jfn(inp), np.float32)
        got = fn(inp).float().numpy()
        assert got.shape == ref.shape == (8, 64, 128)
        scale = max(float(np.abs(ref).max()), 1e-6)
        assert float(np.abs(got - ref).max()) <= 2e-2 * scale
