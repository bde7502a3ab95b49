"""The port stands alone: no module of ``flexflow_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and importing every
module of the port leaves ``jax`` and ``flexflow_tpu`` out of
``sys.modules``.  The top-level module name is matched exactly, so
``flexflow_tpu_torch`` is not mistaken for ``flexflow_tpu``."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flexflow_tpu"}
SOURCES = sorted((ROOT / "flexflow_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _top_level_imports(source: str):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = FORBIDDEN.intersection(_top_level_imports(path.read_text()))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_name_check_tells_the_packages_apart():
    src = ("import flexflow_tpu_torch.models\n"
           "from flexflow_tpu_torch.ops import base\n"
           "from flexflow_tpu.ops import base\n"
           "from . import sibling\n")
    assert FORBIDDEN.intersection(_top_level_imports(src)) == {
        "flexflow_tpu"}


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import flexflow_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flexflow_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith(pkg.__name__)]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was imported
