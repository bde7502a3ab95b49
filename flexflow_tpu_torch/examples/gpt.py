"""GPT-style causal language model (examples/gpt.py; beyond the
reference zoo, whose Transformer example is a non-causal MSE proxy,
transformer.cc:112-211).

Trains next-token prediction with per-token sparse CCE; at the card's
sequence length (512) the causal MHA takes the CUDA flash kernels, and
sharding the seq dim takes the zigzag ring-attention path for long
contexts.

Usage: python -m flexflow_tpu_torch.examples.gpt -b 8 -e 1
"""
from flexflow_tpu_torch import AdamOptimizer
from flexflow_tpu_torch.examples.common import (
    config_of,
    lm_sequence_data,
    on_card,
)
from flexflow_tpu_torch.models import build_gpt


def sizes(config) -> dict:
    """``build_gpt``'s widths: the reference's TPU sizes on the card,
    its CI sizes on the CPU."""
    if on_card(config):
        vocab, layers, hidden, heads, ff_dim, seq = 32000, 12, 768, 12, 3072, 512
    else:  # CI-sized
        vocab, layers, hidden, heads, ff_dim, seq = 512, 2, 64, 4, 128, 32
    return dict(vocab=vocab, num_layers=layers, hidden=hidden,
                num_heads=heads, ff_dim=ff_dim, seq_len=seq)


def main(argv=None, config=None):
    config = config_of(argv, config)
    size = sizes(config)
    model = build_gpt(config, **size)
    model.compile(
        optimizer=AdamOptimizer(alpha=3e-4),
        loss_type="sparse_categorical_crossentropy",
        metrics=["accuracy", "sparse_categorical_crossentropy"],
    )

    n = config.batch_size * 8
    x, y = lm_sequence_data(n, size["seq_len"], size["vocab"],
                            seed=config.seed)
    model.fit(x=x, y=y, epochs=config.epochs)
    return model


if __name__ == "__main__":
    main()
