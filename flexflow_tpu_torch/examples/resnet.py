"""ResNet / ResNeXt-50 example (examples/resnet.py; reference:
examples/cpp/ResNet/resnet.cc, examples/cpp/resnext50/resnext.cc).

Usage: python -m flexflow_tpu_torch.examples.resnet -b 64 -e 1 [--resnext] [--only-data-parallel]
"""
import sys

from flexflow_tpu_torch import SGDOptimizer
from flexflow_tpu_torch.examples.common import config_of, run_example
from flexflow_tpu_torch.models import build_resnet, build_resnext50


def main(argv=None, config=None):
    args = sys.argv[1:] if argv is None else list(argv)
    config = config_of(args, config)
    if "--resnext" in args:
        model = build_resnext50(config, num_classes=1000, image=64)
        name = "resnext50"
    else:
        model = build_resnet(config, num_classes=1000, image=64)
        name = "resnet"
    return run_example(model, name,
                       optimizer=SGDOptimizer(lr=0.01, momentum=0.9))


if __name__ == "__main__":
    main()
