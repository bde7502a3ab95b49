"""XDL example, an embedding-heavy ads/recommendation model
(examples/xdl.py; reference: examples/cpp/XDL/xdl.cc).

Usage: python -m flexflow_tpu_torch.examples.xdl -b 256 -e 1
"""
from flexflow_tpu_torch.examples.common import config_of, run_example
from flexflow_tpu_torch.models import build_xdl


def main(argv=None, config=None):
    config = config_of(argv, config)
    return run_example(build_xdl(config), "xdl")


if __name__ == "__main__":
    main()
