"""The port imports neither jax nor rba_tpu, and its entry points default to the GPU.

jax is imported at interpreter start-up in some images, so ``sys.modules`` cannot
show this; the test reads the import statements of every source file instead.
"""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "rba_tpu")


def _port_files():
    return sorted((ROOT / "rba_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert "chip_smoke.py" in names and "rba_tpu_torch/models/maskformer.py" in names
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_rba_tpu_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_build_model_defaults_to_the_gpu():
    from rba_tpu_torch.config import tiny_test_config
    from rba_tpu_torch.models.maskformer import build_model

    if torch.cuda.is_available():
        model = build_model(tiny_test_config())
        assert next(model.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="GPU"):
            build_model(tiny_test_config())


def test_sweep_defaults_to_the_gpu(tmp_path):
    from rba_tpu_torch.evalx import sweep

    args = ["--models_folder", str(tmp_path), "--datasets_folder", str(tmp_path), "--out_path", str(tmp_path / "out"),
            "--precision", "parity"]
    if torch.cuda.is_available():
        sweep.main(args)  # an empty zoo: nothing to evaluate
    else:
        with pytest.raises(RuntimeError, match="GPU"):
            sweep.main(args)
