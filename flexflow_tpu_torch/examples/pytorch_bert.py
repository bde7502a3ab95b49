"""HuggingFace BERT import example (examples/pytorch_bert.py; reference:
examples/python/pytorch bert_proxy / mt5, which trace hand-built
proxies; this imports the real ``transformers.BertModel`` through
torch.fx and trains it).  Needs ``transformers``: without it ``main``
raises an ImportError naming it.

The importer constant-folds the HF mask-construction chain, decomposes
scaled_dot_product_attention into PCG ops, and carries module buffers
(position ids) as compile-time constants (frontends/torch_fx.py).

Usage: python -m flexflow_tpu_torch.examples.pytorch_bert -b 8 -e 1
"""
import numpy as np
import torch

from flexflow_tpu_torch import AdamOptimizer, FFModel
from flexflow_tpu_torch.examples.common import config_of, require
from flexflow_tpu_torch.frontends import PyTorchModel, transfer_torch_weights


def main(argv=None, config=None):
    config = config_of(argv, config)
    transformers = require("transformers", "the HuggingFace BertModel")
    hf_fx = require("transformers.utils.fx", "HuggingFace's fx tracer")
    B, S, H = config.batch_size, 32, 128

    bcfg = transformers.BertConfig(
        hidden_size=H, num_hidden_layers=4, num_attention_heads=4,
        intermediate_size=4 * H, vocab_size=2048, max_position_embeddings=S,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    )
    tmodel = transformers.BertModel(bcfg).to(config.torch_device())
    tmodel.eval()
    gm = hf_fx.symbolic_trace(tmodel, input_names=["input_ids"])

    model = FFModel(config)
    ids = model.create_tensor([B, S], dtype="int32")
    example = torch.randint(0, bcfg.vocab_size, (B, S),
                            device=config.torch_device())
    outs = PyTorchModel(gm, example_inputs=[example]).torch_to_ff(model, [ids])
    print("imported BERT outputs:", [tuple(o.sizes) for o in outs])

    model.compile(
        optimizer=AdamOptimizer(alpha=1e-4),
        loss_type="mean_squared_error",
        metrics=["mean_squared_error"],
    )
    transfer_torch_weights(tmodel, model)

    rng = np.random.default_rng(config.seed)
    n = B * 8
    x = rng.integers(0, bcfg.vocab_size, (n, S)).astype(np.int32)
    y = rng.normal(size=(n, outs[-1].sizes[-1])).astype(np.float32)
    model.fit(x=x, y=y, epochs=config.epochs)
    return model


if __name__ == "__main__":
    main()
