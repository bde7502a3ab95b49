"""Mixture-of-Experts example with dynamic recompilation
(examples/moe.py; reference: examples/cpp/mixture_of_experts/
moe.cc:46-92: the cache score drives a RecompileState trigger; alter()
flips the gate to the cached expert assignments mid-training).

Usage: python -m flexflow_tpu_torch.examples.moe -b 64 -e 1
"""
from flexflow_tpu_torch.examples.common import config_of, run_example
from flexflow_tpu_torch.models import build_moe
from flexflow_tpu_torch.runtime.recompile import RecompileState, cache_score


def main(argv=None, config=None):
    config = config_of(argv, config)
    model = build_moe(config, use_cache=True)

    # reference moe.cc:73-84: trigger when the gate assignments have
    # stabilized (the cache score, mean |live - cached|, dropped below
    # the initial churn), then switch to the cached assignments
    cache_node = model.node_by_name("gate_cache")
    scores = []

    def trigger(m):
        try:
            s = cache_score(m, "gate_cache")
        except KeyError:
            return False
        scores.append(s)
        return len(scores) >= 3 and s < 0.92 * max(scores[:3])

    def alter(m):
        if m._prints():
            print(f"[moe] recompiling with cached assignments "
                  f"(score={scores[-1]:.4f})")
        cache_node.op.attrs["use_cached"] = True

    return run_example(model, "moe",
                       recompile_state=RecompileState(trigger, alter))


if __name__ == "__main__":
    main()
