"""Ulysses all-to-all sequence parallelism example
(examples/ulysses_sp.py).

A small encoder whose attention runs under an explicit seq-sharded
strategy with ``sp_mode="ulysses"``: the head-exchange all-to-all pair
(parallel/ulysses.py) serves the sharded sequence dim instead of the
K/V ring, moving 2/n of the ring's wire bytes.  The reference cannot
split MHA's sequence dim at all (substitution.cc:2599-2654: sample-dim
repartition and head split only), so both SP schemes are beyond it.

One process per rank: inside a job ``main`` runs this rank's part (rank
0 prints) and returns the model; otherwise, with ``-ll:tpu`` above 1, it
starts the ranks and returns rank 0's ``job_summary``.

Usage: python -m flexflow_tpu_torch.examples.ulysses_sp -b 8 -e 1 -ll:tpu 4
"""
from flexflow_tpu_torch import FFModel, MachineView
from flexflow_tpu_torch.examples.common import (
    config_of,
    in_job,
    job_summary,
    run_example,
    spawn_ranks,
)


def run(config):
    b, s, e, heads = config.batch_size, 64, 64, 8
    m = FFModel(config)
    x = m.create_tensor([b, s, e], name="tokens")
    t = m.multihead_attention(x, x, x, embed_dim=e, num_heads=heads,
                              causal=True, sp_mode="ulysses", name="mha")
    t = m.dense(t, e, activation="relu", name="ff1")
    t = m.mean(t, dims=[1], name="pool")
    t = m.dense(t, 8, name="head")

    # dp x sp hybrid: batch degree 2 everywhere (the stock DP helper
    # handles divisibility/fixed-view edge cases), the attention also
    # shards its sequence dim sp-ways, served by the ulysses exchange
    from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy

    n = config.num_devices
    sp = max(1, min(4, n // 2, heads))
    strategy = dict(data_parallel_strategy(m.graph, min(2, n)))
    mha = m.node_by_name("mha")
    dp_deg = strategy[mha.guid].dim_degrees[0]
    if n >= dp_deg * sp and s % sp == 0 and b % max(dp_deg, 1) == 0:
        strategy[mha.guid] = MachineView(dim_degrees=(dp_deg, sp, 1))
    m.compile(loss_type="sparse_categorical_crossentropy",
              metrics=["accuracy"], strategy=strategy)
    return run_example(m, "ulysses_sp", loss="sparse_categorical_crossentropy",
                       skip_compile=True)


def _rank(rank, config):
    return job_summary(run(config))


def main(argv=None, config=None):
    config = config_of(argv, config)
    if in_job() or config.num_devices < 2:
        return run(config)
    return spawn_ranks(_rank, config)


if __name__ == "__main__":
    main()
