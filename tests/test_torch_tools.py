"""The port's tools (``flexflow_tpu_torch/tools/``) against the
reference's (``tools/``), both run in this process.

* ``ffobs``: every subcommand (``report``, ``validate``, ``metrics``,
  ``trace``) prints what the reference tool prints and exits as it
  does, on two logs: one written by the port's ``transformer`` example
  and one by the reference's, each with ``--obs-log`` (CI size, one
  device, the search on).
* ``fflint``: ``strategy`` and ``cache`` give the reference's findings
  and exit codes on the committed ``COST_CACHE.json``, on a strategy
  file each package exports and on a corrupted copy of each;
  ``registry --devices 4`` gives the reference's finding codes and exit
  code (the port's proofs evaluated on the CPU, ``--device cpu``).
* ``mfu_probe`` and ``mfu_variants`` refuse a CPU config with a
  message: they are card-only, as the reference's are TPU-only."""

from __future__ import annotations

import contextlib
import io
import json
import pathlib

import pytest

import flexflow_tpu_torch as tff
from flexflow_tpu_torch.tools import fflint, ffobs, mfu_probe, mfu_variants

ROOT = pathlib.Path(__file__).resolve().parent.parent
OBS_ARGV = ["-b", "4", "-e", "1", "-ll:tpu", "1"]


def run_tool(main, argv):
    """(exit code, stdout) of a tool's ``main(argv)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()


def reference_tool(name):
    import importlib

    return importlib.import_module(f"tools.{name}").main


@pytest.fixture(scope="module")
def obs_logs(tmp_path_factory):
    """{"port": log, "reference": log}, each written by its package's
    transformer example with ``--obs-log``."""
    from test_torch_examples import run_port, run_reference

    import flexflow_tpu.obs.events as ref_events
    from flexflow_tpu_torch.obs.events import BUS

    d = tmp_path_factory.mktemp("obs_logs")
    logs = {"port": d / "port.jsonl", "reference": d / "reference.jsonl"}
    try:
        run_port("transformer", OBS_ARGV + ["--obs-log", str(logs["port"])])
    finally:
        BUS.close()
    try:
        run_reference("transformer",
                      OBS_ARGV + ["--obs-log", str(logs["reference"])],
                      stop_at=None)
    finally:
        ref_events.BUS.close()
    return logs


@pytest.mark.parametrize("log", ["port", "reference"])
@pytest.mark.parametrize("cmd", [["report"], ["report", "--top", "3"],
                                 ["validate"], ["metrics"], ["trace"]],
                         ids=lambda c: "-".join(c))
def test_ffobs_prints_and_exits_as_the_reference(obs_logs, log, cmd):
    argv = [cmd[0], str(obs_logs[log]), *cmd[1:]]
    got = run_tool(ffobs.main, argv)
    assert got == run_tool(reference_tool("ffobs"), argv)
    if cmd == ["validate"]:
        assert got[0] == 0, got[1]


def test_the_logs_hold_the_search_and_the_fit(obs_logs):
    for log in obs_logs.values():
        kinds = {json.loads(line)["kind"] for line in open(log)}
        assert {"obs.meta", "search.begin", "search.result"} <= kinds, kinds


# ---- fflint ---------------------------------------------------------------
def _strategy_files(tmp_path):
    """A strategy file exported by each package for the same tiny GPT,
    and a copy of each with its provenance digest taken out (STR203, a
    warning) and an op's entry broken (STR204, an error)."""
    import flexflow_tpu as ff
    from flexflow_tpu.models import build_gpt as ref_gpt

    from flexflow_tpu_torch.models import build_gpt

    gpt = dict(vocab=64, num_layers=1, hidden=32, num_heads=2, ff_dim=32,
               seq_len=16)
    files = {}
    for tag, model in (
            ("port", build_gpt(tff.FFConfig(
                batch_size=4, device="cpu", num_devices=1,
                only_data_parallel=True,
                export_strategy_file=str(tmp_path / "port_strategy.json")),
                **gpt)),
            ("reference", ref_gpt(ff.FFConfig(
                batch_size=4, num_devices=1, only_data_parallel=True,
                export_strategy_file=str(tmp_path /
                                         "reference_strategy.json")),
                **gpt))):
        model.compile(loss_type="sparse_categorical_crossentropy")
        files[tag] = model.config.export_strategy_file
        data = json.load(open(files[tag]))
        data.get("__meta__", {}).pop("graph_digest", None)
        data[sorted(k for k in data if k != "__meta__")[0]] = 5
        bad = tmp_path / f"{tag}_bad_strategy.json"
        bad.write_text(json.dumps(data))
        files[f"{tag}_bad"] = str(bad)
    return files


def test_fflint_strategy_findings_equal_the_reference(tmp_path):
    files = _strategy_files(tmp_path)
    for f in files.values():
        argv = ["strategy", f, "--json"]
        got = run_tool(fflint.main, argv)
        assert got == run_tool(reference_tool("fflint"), argv), f
    assert run_tool(fflint.main, ["strategy", files["port"]])[0] == 0
    assert run_tool(fflint.main, ["strategy", files["port_bad"]])[0] == 1


def test_fflint_cache_findings_equal_the_reference(tmp_path):
    cache = str(ROOT / "COST_CACHE.json")
    data = json.load(open(cache))
    data["schema"] = 99  # CCH401
    data["rows"][1] = {"sig": "x"}  # CCH402
    bad = tmp_path / "COST_CACHE_bad.json"
    bad.write_text(json.dumps(data))
    for f in (cache, str(bad)):
        for fmt in ([], ["--json"]):
            argv = ["cache", f, *fmt]
            got = run_tool(fflint.main, argv)
            assert got == run_tool(reference_tool("fflint"), argv), f
    assert run_tool(fflint.main, ["cache", cache])[0] == 0
    assert run_tool(fflint.main, ["cache", str(bad)])[0] == 1


def test_fflint_registry_codes_equal_the_reference():
    def codes(main, argv):
        rc, out = run_tool(main, argv)
        lines = [json.loads(line) for line in out.splitlines() if line]
        return rc, sorted(x["code"] for x in lines if "code" in x)

    from test_torch_examples import one_thread

    with one_thread():
        got = codes(fflint.main, ["registry", "--devices", "4", "--json",
                                  "--device", "cpu"])
    assert got == codes(reference_tool("fflint"),
                        ["registry", "--devices", "4", "--json"])
    assert got[0] == 0


def test_fflint_usage_error_exits_2():
    assert run_tool(fflint.main, ["no-such-subcommand"])[0] == 2


# ---- the card-only experiments --------------------------------------------
@pytest.mark.parametrize("tool", [mfu_probe, mfu_variants],
                         ids=["mfu_probe", "mfu_variants"])
def test_mfu_tool_refuses_a_cpu_config(tool):
    with pytest.raises(SystemExit, match="card-only"):
        tool.main([], tff.FFConfig(device="cpu"))


def test_mfu_variants_route_and_restore_the_attention():
    from flexflow_tpu_torch.ops import attention

    before = attention.FLASH_MIN_SK, attention.attn_core
    with mfu_variants.route("flash"):
        assert attention.flash_route(256, 256, 64, True)
    with mfu_variants.route("bf16probs"):
        assert attention.attn_core is mfu_variants._bf16probs
    assert (attention.FLASH_MIN_SK, attention.attn_core) == before
    assert not attention.flash_route(256, 256, 64, True)
    with pytest.raises(SystemExit, match="unknown variant"):
        with mfu_variants.route("nope"):
            pass


def test_bf16probs_matches_plain_attention_within_bf16():
    """The bf16-probs Function's output and gradients against the port's
    plain attention (``attn_core``) on the same bf16 inputs."""
    import torch

    from flexflow_tpu_torch.kernels.flash_attention import attn_core

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 32, 2, 16, generator=g).bfloat16()
               .requires_grad_() for _ in range(3))
    do = torch.randn(2, 32, 2, 16, generator=g).bfloat16()
    outs = []
    for fn in (mfu_variants._bf16probs, attn_core):
        y = fn(q, k, v, False, 0.25)
        grads = torch.autograd.grad(y, (q, k, v), do)
        outs.append([y.detach().float()] + [t.float() for t in grads])
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) <= 0.05 * float(b.abs().max())
