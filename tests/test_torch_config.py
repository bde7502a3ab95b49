"""The port's command line and its two ``FFConfig`` additions against the
JAX package's config.py.

* ``FFConfig.parse_args``: argvs that between them set every flag of
  the reference's parser (config.py:467-644), each spelling of the flags
  that have two, and unknown flags (left to the caller): every field
  both ``FFConfig``s have is equal, and ``slice_levels`` gives the same
  ``machine_spec.slice_levels``.  The machine specs themselves differ by
  design (``h100_sxm`` here, ``tpu_v5e`` there) unless a machine file
  names one; then they are equal.  ``-ll:tpu`` left at 0 resolves to
  every visible device: the reference's 8 virtual CPU devices, the
  port's visible cards (1 on a host without CUDA).
* ``slice_levels`` and ``num_devices=0`` outside the parser: the same
  normalisation and the same refusals as the reference's.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.config import parse_slice_levels as j_parse_slice_levels
from flexflow_tpu.core.machine import MachineSpec as JSpec
from flexflow_tpu_torch.config import FFConfig, parse_slice_levels

ARGVS = {
    "defaults": [],
    "short": ["-e", "3", "-b", "16", "--lr", "0.1", "--wd", "0.001",
              "-ll:tpu", "4", "--seed", "7"],
    "long": ["--epochs", "2", "--batch-size", "32", "--learning-rate",
             "0.2", "--weight-decay", "0", "--num-devices", "2"],
    "search": ["--budget", "9", "--alpha", "1.2", "--only-data-parallel",
               "--enable-parameter-parallel", "--enable-attribute-parallel",
               "--search-num-nodes", "2", "--search-num-workers", "4",
               "--base-optimize-threshold", "5", "--search-timeout", "0",
               "--search-improvement-margin", "0.1",
               "--disable-pipeline-search", "--substitution-json",
               "subst.json", "--calibration-file", "cal.json",
               "--calibrate", "--calibration-budget", "12.5",
               "-ll:tpu", "8"],
    "search_long": ["--search-budget", "3", "--search-alpha", "1.5",
                    "--search-num-workers", "2"],
    "strategy_files": ["--export-strategy", "out.json", "--import-strategy",
                       "in.json", "--import-strategy-partial",
                       "--taskgraph", "task.dot", "--slice-levels",
                       "16:3.1e9:1e-5,32:1e9:2e-5", "-ll:tpu", "32"],
    "training": ["--profiling", "--trace-steps", "4", "--grad-accum-steps",
                 "2", "--remat", "--zero-dp-shard", "--sync-precision",
                 "int8", "--sync-schedule", "search", "--sync-bucket-bytes",
                 "65536", "--sync-ef", "auto", "-ll:tpu", "4"],
    "co_search": ["--co-search", "--sync-precision", "search"],
    "serving": ["--objective", "serve", "--serve-p99-budget-ms", "25",
                "--serve-disaggregation", "search", "--prefill-chunk", "16",
                "--serve-fleet", "search", "--serve-fleet-max-replicas", "2",
                "--serve-slo-classes", "interactive:1:4:0.9:2,batch:0:0",
                "--kv-precision", "int8", "--serve-shared-prefix-pages",
                "3", "-ll:tpu", "4"],
    "observability": ["--obs-log", "bus.jsonl", "--obs-trace",
                      "predicted.json", "--device-trace-dir", "traces",
                      "--drift-threshold", "0.25", "--cost-cache-file",
                      "cache.json", "--verify"],
    "no_cost_cache": ["--cost-cache-file", "cache.json", "--no-cost-cache",
                      "--kv-precision", "search", "--objective", "serve"],
    "unknown_flags": ["-b", "8", "--model", "net.onnx", "extra", "-x"],
}


def _shared_fields():
    port = {f.name for f in dataclasses.fields(FFConfig)}
    return sorted(port & {f.name for f in dataclasses.fields(JConfig)}
                  - {"machine_spec"})


def _value(v):
    """A field's value, nested dataclasses (``iteration``) as dicts: the
    two packages' ``IterationConfig`` classes differ."""
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def test_the_port_has_every_reference_flag_destination():
    """Every field the reference's parse_args sets exists in the port's
    ``FFConfig`` (the parser builds it from the same keywords)."""
    import inspect

    src = inspect.getsource(JConfig.parse_args)
    body = src[src.index("return FFConfig("):]
    names = {line.split("=")[0].strip() for line in body.splitlines()[1:]
             if "=" in line}
    assert names <= set(_shared_fields()) | {"machine_model_file"}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parse_args_matches_the_reference(name):
    argv = ARGVS[name]
    got, want = FFConfig.parse_args(argv), JConfig.parse_args(argv)
    for f in _shared_fields():
        if f == "num_devices" and "-ll:tpu" not in argv and (
                "--num-devices" not in argv):
            continue
        assert _value(getattr(got, f)) == _value(getattr(want, f)), f
    if "-ll:tpu" not in argv and "--num-devices" not in argv:
        assert got.num_devices == max(1, torch.cuda.device_count())
    assert got.machine_spec.slice_levels == want.machine_spec.slice_levels
    assert got.device == "cuda"
    cpu = dataclasses.replace(got, device="cpu")
    assert cpu.machine_spec.slice_levels == got.machine_spec.slice_levels
    for f in _shared_fields():
        assert getattr(cpu, f) == getattr(got, f), f


def test_machine_model_file_gives_the_same_spec(tmp_path):
    path = str(tmp_path / "machine.json")
    JSpec.tpu_v5e(8).to_file(path)
    argv = ["--machine-model-file", path, "--slice-levels", "16:2e9:1e-5",
            "-ll:tpu", "16"]
    got, want = FFConfig.parse_args(argv), JConfig.parse_args(argv)
    assert dataclasses.asdict(got.machine_spec) == dataclasses.asdict(
        want.machine_spec)
    assert got.machine_spec.slice_levels == ((16, 2e9, 1e-5),)


@pytest.mark.parametrize("value", [
    "16:3.1e9:1e-5", "16:1e9:1e-5,32:5e8:2e-5",
    [(16, 1e9, 1e-5), (32, 5e8, 2e-5)], ((32, 1, 0),)])
def test_slice_levels_normalise_as_the_reference(value):
    assert parse_slice_levels(value) == j_parse_slice_levels(value)
    got = FFConfig(device="cpu", num_devices=32, slice_levels=value)
    want = JConfig(num_devices=32, slice_levels=value)
    assert got.slice_levels == want.slice_levels
    assert got.machine_spec.slice_levels == want.machine_spec.slice_levels


@pytest.mark.parametrize("value", ["16:3.1e9", "32:1e9:1e-5,16:1e9:1e-5",
                                   "12:1e9:1e-5"])
def test_slice_levels_refusals_match_the_reference(value):
    """A malformed spelling, descending spans and a span that is not a
    multiple of a host's 8 devices: refused at construction by both."""
    with pytest.raises(ValueError):
        JConfig(num_devices=32, slice_levels=value)
    with pytest.raises(ValueError):
        FFConfig(device="cpu", num_devices=32, slice_levels=value)


def test_num_devices_zero_is_every_visible_device():
    assert FFConfig(device="cpu", num_devices=0).num_devices == 1
    cfg = FFConfig(num_devices=0)  # the card, default
    assert cfg.num_devices == max(1, torch.cuda.device_count())
    assert cfg.machine_spec.num_devices == cfg.num_devices
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            cfg.torch_device()
    with pytest.raises(ValueError):
        FFConfig(device="cpu", num_devices=-1)
