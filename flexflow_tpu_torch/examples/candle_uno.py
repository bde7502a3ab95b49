"""CANDLE-Uno example (examples/candle_uno.py; reference:
examples/cpp/candle_uno/candle_uno.cc).

Usage: python -m flexflow_tpu_torch.examples.candle_uno -b 64 -e 1
"""
from flexflow_tpu_torch.examples.common import config_of, run_example
from flexflow_tpu_torch.models import build_candle_uno


def main(argv=None, config=None):
    config = config_of(argv, config)
    return run_example(build_candle_uno(config), "candle_uno",
                       loss="mean_squared_error",
                       metrics=["mean_squared_error"])


if __name__ == "__main__":
    main()
