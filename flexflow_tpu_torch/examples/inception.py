"""InceptionV3 example (examples/inception.py; reference:
examples/cpp/InceptionV3/inception.cc; osdi22ae/inception.sh runs -b 64
--budget 10).

Usage: python -m flexflow_tpu_torch.examples.inception -b 64 -e 1
"""
from flexflow_tpu_torch import SGDOptimizer
from flexflow_tpu_torch.examples.common import config_of, run_example
from flexflow_tpu_torch.models import build_inception_v3


def main(argv=None, config=None):
    config = config_of(argv, config)
    model = build_inception_v3(config)
    return run_example(model, "inception_v3",
                       optimizer=SGDOptimizer(lr=0.01, momentum=0.9))


if __name__ == "__main__":
    main()
