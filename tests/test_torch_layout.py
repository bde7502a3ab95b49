"""The port's layout and its independence from the JAX package.

* Every ``*.py`` under ``flexflow_tpu/`` has a file at the same relative
  path under ``flexflow_tpu_torch/``; the Pallas modules of
  ``flexflow_tpu/kernels/`` are matched by the port's modules of the
  same name (their CUDA kernels live in ``flexflow_tpu_torch/csrc/``).
  No reference module is allowed to be missing.
* Every example script (``examples/*.py``) and tool (``tools/*.py``)
  has a port file at the same name under ``flexflow_tpu_torch/examples/``
  or ``flexflow_tpu_torch/tools/``, but for ``ENTRY_POINTS_MISSING``.
* No module of ``flexflow_tpu_torch/`` and nothing in ``chip_smoke.py``
  imports ``jax``, ``jaxlib`` or ``flexflow_tpu``, nor the root
  ``examples`` or ``tools`` packages (an ``import`` or ``from`` anywhere
  in the file, or ``importlib.import_module`` of one).
"""

from __future__ import annotations

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "flexflow_tpu"
PORT = ROOT / "flexflow_tpu_torch"
ALLOWED_MISSING: frozenset = frozenset()
# tools/benchdiff.py imports nothing but the standard library, so it runs
# on the card's host as it is: the port needs no copy of it
ENTRY_POINTS_MISSING = frozenset({"tools/benchdiff.py"})
FORBIDDEN = {"jax", "jaxlib", "flexflow_tpu", "examples", "tools"}
DYNAMIC = re.compile(r"import_module\(\s*[\"'](jax|jaxlib|flexflow_tpu|"
                     r"examples|tools)(?![\w])")


def _modules(root):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.py")
                  if "_build" not in p.parts)


def test_every_reference_module_has_a_port_file():
    missing = [rel for rel in _modules(REF)
               if not (PORT / rel).is_file() and rel not in ALLOWED_MISSING]
    assert not missing, f"reference modules without a port file: {missing}"
    assert not ALLOWED_MISSING


def test_every_pallas_module_has_a_port_module():
    pallas = [rel for rel in _modules(REF)
              if "pallas_call" in (REF / rel).read_text()]
    assert pallas == ["kernels/flash_attention.py",
                      "kernels/ragged_paged_attention.py"]
    for rel in pallas:
        assert (PORT / rel).is_file(), rel


def test_every_example_and_tool_has_a_port_file():
    """The repo's entry points (the README starts the system through
    ``examples/*.py`` and its tools through ``tools/*.py``) each have a
    port module, but ``tools/benchdiff.py``: it imports nothing but the
    standard library, so it runs on the card's host as it is."""
    entry = sorted(p.relative_to(ROOT).as_posix()
                   for d in ("examples", "tools")
                   for p in (ROOT / d).glob("*.py"))
    assert "examples/gpt.py" in entry and "tools/ffobs.py" in entry
    missing = [rel for rel in entry
               if not (PORT / rel).is_file()
               and rel not in ENTRY_POINTS_MISSING]
    assert not missing, f"entry points without a port file: {missing}"
    assert all((ROOT / rel).is_file() for rel in ENTRY_POINTS_MISSING)


def _port_sources():
    return [PORT / rel for rel in _modules(PORT)] + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_no_jax(path):
    text = path.read_text()
    bad = []
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    bad += [m.group(0) for m in DYNAMIC.finditer(text)]
    assert not bad, f"{path.name} imports {bad}"
