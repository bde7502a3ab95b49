"""Search-discovered staged pipeline over a HETEROGENEOUS stack
(examples/staged_pipeline.py).

Eight dense layers with pairwise-different PRIME widths: no
tensor-parallel divisor exists and no two layers are isomorphic, so
neither TP nor the stacked-block pipeline applies, and the full
weight+optimizer footprint exceeds the modeled per-device memory (40
MB), so every flat strategy is memory-infeasible.  compile() finds the
balanced S-stage partition itself (search/pipeline_search.py
propose_pipeline_general) and executes it with the general staged
executor (compiler/staged_pipeline_lowering.py).  On the card the
modeled machine is ``MachineSpec.h100_sxm(n)`` where the reference
takes ``tpu_v5e(n)``, with the same two hosts and capacity.

One process per rank: inside a job ``main`` runs this rank's part (rank
0 prints) and returns the model; otherwise it starts ``-ll:tpu`` ranks
(>= 4) and returns rank 0's ``job_summary``.

Usage: python -m flexflow_tpu_torch.examples.staged_pipeline -b 16 -e 2 -ll:tpu 4
"""
import copy
import dataclasses

import numpy as np

from flexflow_tpu_torch import FFModel, SGDOptimizer
from flexflow_tpu_torch.core.machine import MachineSpec
from flexflow_tpu_torch.examples.common import (
    config_of,
    in_job,
    job_summary,
    on_card,
    spawn_ranks,
)

WIDTHS = (1019, 1013, 1009, 997, 991, 983, 977, 1021)


def machine_spec(n: int, card: bool) -> MachineSpec:
    """The memory-bound 2-host machine the regime needs."""
    spec = (MachineSpec.h100_sxm(n) if card
            else MachineSpec(num_devices=n, platform="cpu"))
    return dataclasses.replace(spec, devices_per_host=max(2, n // 2),
                               hbm_capacity=40e6, ici_torus=())


def staged_config(config):
    n = config.num_devices
    if n < 4:
        raise SystemExit(f"need >= 4 devices, have {n}")
    config = copy.copy(config)  # the caller's config stays as it was
    config.machine_spec = machine_spec(n, on_card(config))
    return config


def run(config):
    config = staged_config(config)
    m = FFModel(config)
    t = m.create_tensor([config.batch_size, 1021], name="x")
    for i, w in enumerate(WIDTHS):
        t = m.dense(t, w, activation="relu", name=f"layer{i}_fc")
    m.dense(t, 1021, name="head")
    m.compile(optimizer=SGDOptimizer(lr=0.05),
              loss_type="mean_squared_error",
              metrics=["mean_squared_error"])

    from flexflow_tpu_torch.compiler.staged_pipeline_lowering import (
        StagedPipelinedModel,
    )

    if config.only_data_parallel:
        # the smoke tier runs every example with --only-data-parallel:
        # the search is bypassed, so the flat lowering is expected here
        if m._prints():
            print("only-data-parallel: staged pipelining bypassed")
    else:
        assert isinstance(m.compiled, StagedPipelinedModel), type(m.compiled)
        if m._prints():
            print(f"search staged the stack: S={m.compiled.num_stages} "
                  f"stages x {config.num_devices // m.compiled.num_stages} "
                  f"ranks, M={m.compiled.num_microbatches} microbatches — "
                  f"executed, not simulated")

    rng = np.random.default_rng(0)
    xs = rng.normal(size=(64, 1021)).astype(np.float32)
    ys = np.zeros((64, 1021), np.float32)
    m.fit(x=xs, y=ys, epochs=config.epochs)
    return m


def _rank(rank, config):
    return job_summary(run(config))


def main(argv=None, config=None):
    config = config_of(argv, config)
    if in_job() or config.num_devices < 4:
        return run(config)
    return spawn_ranks(_rank, config)


if __name__ == "__main__":
    main()
