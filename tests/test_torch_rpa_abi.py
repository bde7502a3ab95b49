"""The C interface of ``csrc/ragged_paged_attention.cu`` against the
wrapper that calls it through ctypes.

The kernels build and run only on the card, so a drift between the
``extern "C"`` declarations and ``kernels/ragged_paged_attention.py``
would otherwise show first as a wrong launch there.  This parses the
source and checks every entry against ``_ENTRY_TYPES`` (the types
``_kernel_entry`` gives it), the launch entries' pointers (the split
workspace and the arrival counters included), ints, float scale and
stream; it runs ``_launch`` and ``_launch_quant`` on CPU tensors against
a recording stand-in for the library, so that the arguments they pass
are checked in order and the workspace has the size the kernel
indexes; and it checks that the head-dim dispatch covers exactly
D / 32 = 1..8.
"""

from __future__ import annotations

import ctypes
import math
import re
import types

import pytest
import torch

from flexflow_tpu_torch.kernels import build
from flexflow_tpu_torch.kernels import ragged_paged_attention as rpa

SOURCE = (build.CSRC / f"{rpa._KERNEL_SOURCE}.cu").read_text()
SPLIT_TOKENS = int(re.search(r"constexpr int kSplitTokens = (\d+);",
                             SOURCE).group(1))
# the ints each launch entry takes after its pointers, in order
LAUNCH_INTS = {
    "ffrpa_launch": ["B", "H", "D", "num_pages", "page_size",
                     "pages_per_seq", "kv_is_bf16"],
    "ffrpa_quant_launch": ["B", "H", "D", "num_pages", "page_size",
                           "pages_per_seq"],
}
LAUNCH_POINTERS = {
    "ffrpa_launch": ["q", "k_pages", "v_pages", "page_table", "seq_lens",
                     "out", "workspace", "counters"],
    "ffrpa_quant_launch": ["q", "k_pages", "v_pages", "k_scale", "v_scale",
                           "page_table", "seq_lens", "out", "workspace",
                           "counters"],
}


def _declarations():
    """name -> [(C type, parameter name)] of every extern "C" function."""
    found = {}
    for name, params in re.findall(
            r'extern "C" int (\w+)\(([^)]*)\)', SOURCE):
        parsed = []
        for p in filter(str.strip, params.split(",")):
            ctype, pname = re.match(r"\s*(.*?)\s*(\w+)\s*$", p).groups()
            parsed.append((" ".join(ctype.split()), pname))
        found[name] = parsed
    return found


def _ctype(ctype):
    if "*" in ctype:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "float": ctypes.c_float}[ctype]


def _typed_entry(name, monkeypatch):
    """``_kernel_entry(name)``'s function as it types it, on a stand-in
    for the built library (nothing is built or loaded)."""
    library = types.SimpleNamespace(
        **{n: types.SimpleNamespace() for n in rpa._ENTRY_TYPES})
    monkeypatch.setattr(build, "load_library", lambda source: library)
    return rpa._kernel_entry.__wrapped__(name)


def test_the_entries_exist():
    assert set(_declarations()) == set(rpa._ENTRY_TYPES)


@pytest.mark.parametrize("name", sorted(rpa._ENTRY_TYPES))
def test_entry_matches_the_wrapper_types(name, monkeypatch):
    params = _declarations()[name]
    fn = _typed_entry(name, monkeypatch)
    assert fn.restype is ctypes.c_int
    assert fn.argtypes == [_ctype(t) for t, _ in params]


@pytest.mark.parametrize("name", sorted(LAUNCH_INTS))
def test_launch_entry_layout(name):
    params = _declarations()[name]
    pointers = LAUNCH_POINTERS[name]
    assert [p for _, p in params[:len(pointers)]] == pointers
    assert all("*" in t for t, _ in params[:len(pointers)])
    ints = params[len(pointers):-2]
    assert [p for _, p in ints] == LAUNCH_INTS[name]
    assert all(t == "int" for t, _ in ints)
    assert params[-2] == ("float", "scale")
    assert params[-1] == ("void*", "stream")


class _Recorder:
    """Stands in for the library's entries: records each launch's
    arguments and answers ``ffrpa_split_tokens`` as the source does."""

    def __init__(self):
        self.calls = []

    def __call__(self, symbol="ffrpa_launch"):
        if symbol == "ffrpa_split_tokens":
            return lambda: SPLIT_TOKENS

        def launch(*args):
            self.calls.append((symbol, args))
            return 0
        return launch


def _operands(pool):
    b, h, d, ps, pps = 3, 2, 64, 5, 7
    num_pages = b * pps
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((b, h, d), generator=gen)
    k = torch.randn((num_pages, ps, h, d), generator=gen)
    v = torch.randn((num_pages, ps, h, d), generator=gen)
    pt = torch.randperm(num_pages, generator=gen).reshape(b, pps).to(
        torch.int32)
    sl = torch.tensor([0, 9, ps * pps], dtype=torch.int32)
    if pool == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    if pool == "int8":
        k, v = k.to(torch.int8), v.to(torch.int8)
        scales = (torch.rand((num_pages, ps), generator=gen),
                  torch.rand((num_pages, ps), generator=gen))
        return q, (k, v, *scales), pt, sl
    return q, (k, v), pt, sl


@pytest.mark.parametrize("pool", ["fp32", "bf16", "int8"])
def test_launch_passes_what_the_entry_declares(pool, monkeypatch):
    recorder = _Recorder()
    monkeypatch.setattr(rpa, "_kernel_entry", recorder)
    monkeypatch.setattr(rpa, "_launch_checks", lambda *a: None)
    monkeypatch.setattr(rpa.torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=1234))
    monkeypatch.setattr(rpa, "_COUNTERS", {})
    q, pools, pt, sl = _operands(pool)
    scale = 0.3
    if pool == "int8":
        out = rpa._launch_quant(q, *pools, pt, sl, scale)
    else:
        out = rpa._launch(q, *pools, pt, sl, scale)
    ((symbol, args),) = recorder.calls
    name = "ffrpa_quant_launch" if pool == "int8" else "ffrpa_launch"
    assert symbol == name
    assert len(args) == len(rpa._ENTRY_TYPES[name])
    pointers = LAUNCH_POINTERS[name]
    b, h, d = q.shape
    ps, pps = pools[0].shape[1], pt.shape[1]
    ws_ptr, counters_ptr = args[len(pointers) - 2:len(pointers)]
    inputs = (q, pools[0], pools[1], *pools[2:], pt, sl)
    assert list(args[:len(inputs)]) == [t.data_ptr() for t in inputs]
    assert args[len(inputs)] == out.data_ptr()
    ints = list(args[len(pointers):-2])
    want = [b, h, d, pools[0].shape[0], ps, pps]
    if pool != "int8":
        want.append(int(pool == "bf16"))
    assert ints == want
    assert args[-2] == pytest.approx(scale)
    assert args[-1] == 1234
    # the workspace holds every split's (acc[D], m, l), the counters
    # every (b, h), zeroed
    splits = math.ceil(ps * pps / SPLIT_TOKENS)
    (counters,) = rpa._COUNTERS.values()
    assert counters.data_ptr() == counters_ptr
    assert counters.numel() >= b * h and not counters.any()
    assert ws_ptr != 0 or b * h * splits * (d + 2) == 0


def test_workspace_size_is_what_the_kernel_indexes(monkeypatch):
    monkeypatch.setattr(rpa, "_kernel_entry", _Recorder())
    monkeypatch.setattr(rpa.torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(rpa, "_COUNTERS", {})
    q = torch.zeros((5, 3, 96))
    ws, counters = rpa._workspace(q, page_size=5, pages_per_seq=61)
    splits = math.ceil(5 * 61 / SPLIT_TOKENS)
    # acc [B*H*splits][D], then (m, l) [B*H*splits][2]
    assert ws.numel() == 5 * 3 * splits * (96 + 2)
    assert ws.dtype == torch.float32
    assert counters.dtype == torch.int32 and counters.numel() == 15
    # a later call on the same stream reuses zeroed counters that fit
    again = rpa._workspace(torch.zeros((2, 3, 96)), 5, 61)[1]
    assert again is counters
    bigger = rpa._workspace(torch.zeros((9, 3, 96)), 5, 61)[1]
    assert bigger.numel() == 27 and not bigger.any()


def test_head_dim_dispatch_covers_32_to_256():
    body = re.search(r"cudaError_t dispatch_d\(.*?\n}\n", SOURCE,
                     re.S).group(0)
    cases = re.findall(r"case (\d+): return f\.template run<(\d+)>\(\);",
                       body)
    assert [int(c) for c, _ in cases] == list(range(1, 9))
    assert all(int(d) == 32 * int(c) for c, d in cases)
    assert body.count("case ") == 8
