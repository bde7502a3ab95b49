"""The port of flexflow_tpu/models/synthetic.py, op names equal to the
reference's (a params dict carries across). Synthetic non-chain PCG
families — the shapes the series-parallel decomposition exists for
(search/decompose.py).

Every real zoo model past ``CHAIN_MIN_NODES`` is a stacked LLM whose
bottleneck chain the decomposition cuts.  The families here are
deliberately **bottleneck-free at depth**: a GSPMD-style sparse/MoE
trunk whose persistent skip from the input bypasses every block
(PAPERS.md arXiv:2105.04663 — the sparse expert-model shape), and a
multi-tower multibranch graph (two-tower rankers, multimodal trunks).
Both scale linearly in their repeat count to 10k+ nodes, and both are
built from ISOMORPHIC repeats so the structural segment cache stamps
one solve across the family — the property ``bench_search.py
--sp-scale`` measures.
"""

from __future__ import annotations

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.model import FFModel


def build_moe_trunk(config: FFConfig, num_blocks: int = 32,
                    num_experts: int = 4, hidden: int = 64,
                    num_classes: int = 8):
    """A dense-mixture trunk with NO bottleneck chain: each block fans
    ``num_experts`` expert MLPs out of the running activation, merges
    them pairwise, and adds a fresh projection of the ORIGINAL input —
    the persistent skip keeps the graph's source on every frontier, so
    no interior node is on every source→sink path and
    ``Graph.bottlenecks()`` is (near-)empty at depth.  ~(3·experts + 3)
    nodes per block: ``num_blocks`` scales it to 10k+ nodes.  Blocks
    are isomorphic — one segment solve stamps the rest."""
    model = FFModel(config)
    b = config.batch_size
    x = model.create_tensor([b, hidden], name="features")
    t = x
    for blk in range(num_blocks):
        experts = []
        for e in range(num_experts):
            h = model.dense(t, hidden, activation="relu",
                            name=f"blk{blk}_e{e}_fc1")
            experts.append(model.dense(h, hidden,
                                       name=f"blk{blk}_e{e}_fc2"))
        mix = experts[0]
        for e, out in enumerate(experts[1:]):
            mix = model.add(mix, out, name=f"blk{blk}_mix{e}")
        # persistent skip: a per-block projection of the INPUT — x's
        # out-edges bypass every earlier block, killing the bottleneck
        # chain that would otherwise form at each block boundary
        skip = model.dense(x, hidden, name=f"blk{blk}_skip")
        t = model.add(mix, skip, name=f"blk{blk}_out")
        # per-block LN keeps a deep trunk numerically trainable (the
        # expert sum grows the activation scale multiplicatively with
        # depth otherwise) — and does not re-introduce a bottleneck:
        # x still bypasses it into every later block
        t = model.layer_norm(t, name=f"blk{blk}_ln")
    out = model.dense(t, num_classes, name="head")
    return model


def build_multibranch(config: FFConfig, num_branches: int = 4,
                      depth: int = 16, hidden: int = 64,
                      num_classes: int = 8):
    """``num_branches`` independent towers from one input, concatenated
    once at the very end — the two-tower/multimodal shape.  The only
    bottlenecks are the input and the final concat/head, so the chain
    rule finds nothing to cut; frontier cuts of width ~branches+1 do.
    ~(branches · depth) nodes: scale either knob."""
    model = FFModel(config)
    b = config.batch_size
    x = model.create_tensor([b, hidden], name="features")
    outs = []
    for br in range(num_branches):
        t = model.dense(x, hidden, activation="relu",
                        name=f"br{br}_fc0")
        for d in range(1, depth):
            t = model.dense(
                t, hidden,
                activation="relu" if d % 2 else None,
                name=f"br{br}_fc{d}")
        outs.append(t)
    t = model.concat(outs, axis=1, name="merge")
    out = model.dense(t, num_classes, name="head")
    return model
