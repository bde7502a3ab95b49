"""Transformer example (examples/transformer.py; reference:
examples/cpp/Transformer/transformer.cc; osdi22ae/bert.sh runs this with
-b 8 --budget 30).  On the card the 12-layer encoder at seq 512 takes
the CUDA flash kernels (not causal).

Usage: python -m flexflow_tpu_torch.examples.transformer -b 8 -e 1
"""
from flexflow_tpu_torch.examples.common import config_of, on_card, run_example
from flexflow_tpu_torch.models import build_transformer


def sizes(config) -> dict:
    if on_card(config):
        # full reference size (transformer.cc:112-211: 12-layer encoder)
        return dict(num_layers=12, hidden=512, num_heads=8, ff_dim=2048,
                    seq_len=512)
    # the reference's CPU smoke size
    return dict(num_layers=4, hidden=256, num_heads=4, ff_dim=512,
                seq_len=128)


def main(argv=None, config=None):
    config = config_of(argv, config)
    model = build_transformer(config, **sizes(config))
    return run_example(model, "transformer", loss="mean_squared_error",
                       metrics=["mean_squared_error"])


if __name__ == "__main__":
    main()
