"""MLP_Unify example, the minimal two-branch MLP whose best strategy
mixes data and model parallelism (examples/mlp_unify.py; reference:
examples/cpp/MLP_Unify/mlp.cc, an osdi22ae workload).  The card takes
the full 8192^3.

Usage: python -m flexflow_tpu_torch.examples.mlp_unify -b 64 -e 1
"""
from flexflow_tpu_torch.examples.common import config_of, on_card, run_example
from flexflow_tpu_torch.models import build_mlp_unify


def widths(config) -> dict:
    if on_card(config):
        return {}  # full 8192^3 (mlp.cc)
    # the reference's CPU smoke size: three 8192^2 dense layers take
    # minutes per epoch on a small host
    return dict(in_dim=1024, hidden=(1024, 1024, 1024))


def main(argv=None, config=None):
    config = config_of(argv, config)
    model = build_mlp_unify(config, **widths(config))
    return run_example(model, "mlp_unify")


if __name__ == "__main__":
    main()
