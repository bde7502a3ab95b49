"""DLRM example (examples/dlrm.py; reference: examples/cpp/DLRM/dlrm.cc;
osdi22ae/dlrm.sh).  The card holds the full 8 x 1M x 64 tables.

Usage: python -m flexflow_tpu_torch.examples.dlrm -b 64 -e 1
"""
from flexflow_tpu_torch.examples.common import config_of, on_card, run_example
from flexflow_tpu_torch.models import build_dlrm


def main(argv=None, config=None):
    config = config_of(argv, config)
    if on_card(config):
        model = build_dlrm(config)  # full reference size (dlrm.cc:27-44)
    else:
        # the reference's CPU smoke size: the full tables with their
        # optimizer state exceed a CI host's memory
        model = build_dlrm(config, embedding_sizes=(100000,) * 8,
                           embedding_dim=32)
    return run_example(model, "dlrm", loss="mean_squared_error",
                       metrics=["mean_squared_error"])


if __name__ == "__main__":
    main()
