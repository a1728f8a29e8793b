"""The import guards: a run refuses a loaded JAX, ``jaxlib``, ``flax`` or ``rba_tpu``
(compared by whole top-level name), and the reference imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
import types

import pytest

from benchmark import run

from .tiny import REPO


@pytest.mark.parametrize("module,found", [("jax.numpy", ["jax"]), ("jaxlib", ["jaxlib"]), ("flax.linen", ["flax"]),
                                          ("rba_tpu.models", ["rba_tpu"]), ("rba_tpu_torch.models", []),
                                          ("jaxtyping", []), ("rba_tpu2", [])])
def test_forbidden_modules(monkeypatch, module, found):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, module, types.ModuleType(module))
    assert run.forbidden_modules() == found


def test_reference_loads_nothing_of_the_program():
    """Every file of the reference, backbone files in subfolders too, loaded as the harness
    loads a configuration's backbone file."""
    code = """
import sys
from pathlib import Path
from benchmark import run

bench = Path("benchmark")
files = sorted((bench / "reference").rglob("*.py"))
for path in files:
    run.reference_backbone({"reference_backbone": str(path.relative_to(bench))}, bench)
print(len(files), sorted({m.split(".")[0] for m in sys.modules} & {"rba_tpu_torch", "rba_tpu", "jax", "jaxlib"}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip() == f"{len(list((REPO / 'benchmark' / 'reference').rglob('*.py')))} []"


def test_reference_sources_import_only_torch():
    for path in (REPO / "benchmark" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] in ("torch", "math", "contextlib", "typing", "__future__"), (path, name)
