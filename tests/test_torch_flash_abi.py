"""The C interface of ``csrc/flash_attention.cu`` against the wrapper
that calls it through ctypes.

The kernels build and run only on the card, so a drift between the
``extern "C"`` declarations and ``kernels/flash_attention.py``'s
``_kernel_entry`` types would otherwise show first as a wrong launch
there.  This parses the source and checks, for each of the four
entries, the pointer operands, the trailing ints (in the order
``_launch`` passes them), the float scale and the stream, and that the
bf16 forward's and bf16 backward's dispatches (``dispatch_fwd_tc``,
``dispatch_bwd_tc``) and the scalar kernels' (``dispatch_d``) take
exactly ``HEAD_DIMS``.
"""

from __future__ import annotations

import ctypes
import re
import types

import pytest

from flexflow_tpu_torch.kernels import build
from flexflow_tpu_torch.kernels import flash_attention as fa

SOURCE = (build.CSRC / f"{fa._KERNEL_SOURCE}.cu").read_text()
ENTRIES = ("ffflash_fwd", "ffflash_fwd_partial", "ffflash_bwd_dq",
           "ffflash_bwd_dkv")
# the ints ``_launch`` passes after the tensors, in its order
LAUNCH_INTS = ["B", "H", "Sq", "Sk", "D", "is_bf16", "causal"]


def _declarations():
    """name -> [(C type, parameter name)] of every extern "C" function."""
    found = {}
    for name, params in re.findall(
            r'extern "C" int (\w+)\(([^)]*)\)', SOURCE):
        parsed = []
        for p in params.split(","):
            ctype, pname = re.match(r"\s*(.*?)\s*(\w+)\s*$", p).groups()
            parsed.append((" ".join(ctype.split()), pname))
        found[name] = parsed
    return found


def _typed_entry(name, monkeypatch):
    """``_kernel_entry(name)``'s function as it types it, on a stand-in
    for the built library (nothing is built or loaded)."""
    library = types.SimpleNamespace(
        **{n: types.SimpleNamespace() for n in ENTRIES})
    monkeypatch.setattr(build, "load_library", lambda source: library)
    return fa._kernel_entry.__wrapped__(name)


def _ctype(ctype):
    if "*" in ctype:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "float": ctypes.c_float}[ctype]


def test_the_four_entries_exist():
    assert set(_declarations()) == set(ENTRIES)


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_matches_the_wrapper_types(name, monkeypatch):
    params = _declarations()[name]
    fn = _typed_entry(name, monkeypatch)
    assert fn.restype is ctypes.c_int
    assert fn.argtypes == [_ctype(t) for t, _ in params]
    # pointers to the tensors, then the ints, the scale and the stream
    n_ptr = len(params) - len(LAUNCH_INTS) - 2
    assert all("*" in t for t, _ in params[:n_ptr])
    assert [p for _, p in params[n_ptr:n_ptr + 7]] == LAUNCH_INTS
    assert params[-2] == ("float", "scale")
    assert params[-1] == ("void*", "stream")


def _dispatch_dims(name):
    """The head dims of the ``case`` labels of the C++ function ``name``."""
    body = re.search(rf"cudaError_t {name}\(.*?\n}}\n", SOURCE,
                     re.S).group(0)
    return tuple(int(d) for d in re.findall(r"case (\d+):", body))


def test_bf16_forward_takes_the_wrappers_head_dims():
    assert _dispatch_dims("dispatch_fwd_tc") == fa.HEAD_DIMS


def test_bf16_backward_takes_the_wrappers_head_dims():
    assert _dispatch_dims("dispatch_bwd_tc") == fa.HEAD_DIMS
    # and run sends every bf16 backward there, not to the scalar kernels
    body = re.search(r"int run\(Which which.*?\n}\n", SOURCE, re.S).group(0)
    assert "if (is_bf16) return (int)dispatch_bwd_tc(which, D, a);" in body


def test_backward_and_fp32_dispatch_take_the_wrappers_head_dims():
    assert _dispatch_dims("dispatch_d") == fa.HEAD_DIMS
