"""Real-data accuracy regression example (examples/digits_accuracy.py;
reference: examples/python/keras/accuracy.py + tests/accuracy_tests.sh:
train a model on real data to a checked accuracy).  Uses the UCI digits
bundled with scikit-learn, genuine handwritten scans available with no
download; without scikit-learn it raises an ImportError naming it.

Usage: python -m flexflow_tpu_torch.examples.digits_accuracy -b 32 -e 20
"""
import numpy as np

from flexflow_tpu_torch import FFModel, SGDOptimizer
from flexflow_tpu_torch.examples.common import config_of, require
from flexflow_tpu_torch.keras import datasets

TARGET = 0.90


def main(argv=None, config=None):
    config = config_of(argv, config)
    require("sklearn", "its bundled digits")
    (xtr, ytr), (xte, yte) = datasets.digits.load_data()
    xtr = (xtr / 16.0).reshape(len(xtr), 64).astype(np.float32)
    xte = (xte / 16.0).reshape(len(xte), 64).astype(np.float32)

    m = FFModel(config)
    x = m.create_tensor([config.batch_size, 64], name="pix")
    t = m.dense(x, 64, activation="relu", name="fc1")
    t = m.dense(t, 10, name="fc2")
    m.compile(optimizer=SGDOptimizer(lr=0.1),
              loss_type="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    m.fit(x=xtr, y=ytr.astype(np.int32), epochs=config.epochs)
    logs = m.evaluate(x=xte, y=yte.astype(np.int32))
    print(f"TEST accuracy on real digits: {logs['accuracy']:.4f}")
    if logs["accuracy"] < TARGET:
        raise SystemExit(f"accuracy {logs['accuracy']:.4f} below {TARGET}")
    print("PASS")
    return m


if __name__ == "__main__":
    main()
