"""AlexNet example (examples/alexnet.py; reference:
examples/cpp/AlexNet/alexnet.cc).

Usage: python -m flexflow_tpu_torch.examples.alexnet -b 64 -e 1 [--only-data-parallel]
"""
from flexflow_tpu_torch import SGDOptimizer
from flexflow_tpu_torch.examples.common import config_of, run_example
from flexflow_tpu_torch.models import build_alexnet_cifar10


def main(argv=None, config=None):
    config = config_of(argv, config)
    model = build_alexnet_cifar10(config)
    return run_example(model, "alexnet",
                       optimizer=SGDOptimizer(lr=0.01, momentum=0.9))


if __name__ == "__main__":
    main()
