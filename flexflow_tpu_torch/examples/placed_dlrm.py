"""Executed inter-op placement example (examples/placed_dlrm.py):
DLRM-style embeddings on the FIRST half of the ranks while the MLP runs
on the SECOND half, the reference mapper's VERTICAL placement
(mapper.cc:371-475), executed as two rank blocks
(compiler/placement_lowering.py).

One process per rank: inside a job ``main`` runs this rank's part (rank
0 prints) and returns the model; otherwise it starts ``-ll:tpu`` ranks
(an even count >= 2) and returns rank 0's ``job_summary``.

Usage: python -m flexflow_tpu_torch.examples.placed_dlrm -b 32 -e 2 -ll:tpu 2
"""
import numpy as np

from flexflow_tpu_torch import FFModel, MachineView
from flexflow_tpu_torch.examples.common import (
    config_of,
    in_job,
    job_summary,
    spawn_ranks,
)


def run(config):
    n = config.num_devices
    if n < 2 or n % 2:
        raise SystemExit(f"need an even device count >= 2, have {n}")
    half = n // 2

    V, D, S = 1000, 16, 4
    m = FFModel(config)
    ids = m.create_tensor([config.batch_size, S], dtype="int32", name="ids")
    e = m.embedding(ids, V, D, name="emb")
    h = m.flat(e, name="flatten")
    h = m.dense(h, 64, activation="relu", name="mlp1")
    h = m.dense(h, 1, name="head")

    strat = {}
    for node in m.graph.topo_order():
        nd = node.op.output_shapes[0].ndim
        start = half if node.op.name in ("mlp1", "head") else 0
        strat[node.guid] = (
            node.op.fixed_machine_view()
            or MachineView(dim_degrees=(half,) + (1,) * (nd - 1),
                           start_part=start)
        )
    m.compile(loss_type="mean_squared_error", metrics=["mean_squared_error"],
              strategy=strat)

    from flexflow_tpu_torch.compiler.placement_lowering import (
        PlacedCompiledModel,
    )

    assert isinstance(m.compiled, PlacedCompiledModel)
    if m._prints():
        print(f"embeddings on ranks [0,{half}), MLP on [{half},{n}) — "
              f"executed, not simulated")

    rng = np.random.default_rng(0)
    xs = rng.integers(0, V, (256, S)).astype(np.int32)
    ys = (xs.sum(axis=1, keepdims=True) / (S * V)).astype(np.float32)
    m.fit(x=xs, y=ys, epochs=config.epochs)
    return m


def _rank(rank, config):
    return job_summary(run(config))


def main(argv=None, config=None):
    config = config_of(argv, config)
    if in_job() or config.num_devices < 2:
        return run(config)
    return spawn_ranks(_rank, config)


if __name__ == "__main__":
    main()
