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
    # chip_smoke.py also runs tests/d2_synthetic.py on the card; the ranks of the parallel
    # tests run tests/torch_parallel_ranks.py; the selfcheck builds tests/torch_refs.py
    return sorted((ROOT / "rba_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "d2_synthetic.py", ROOT / "tests" / "torch_parallel_ranks.py",
        ROOT / "tests" / "torch_refs.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


TRAINING_MODULES = ("rba_tpu_torch/ops/point_sample.py", "rba_tpu_torch/ops/lsap.py", "rba_tpu_torch/kernels/lsap.py",
                    "rba_tpu_torch/train/matcher.py", "rba_tpu_torch/train/criterion.py",
                    "rba_tpu_torch/train/optimizer.py", "rba_tpu_torch/train/train_step.py",
                    "rba_tpu_torch/train/train_net.py", "rba_tpu_torch/data/mappers.py")


EVALUATION_MODULES = ("rba_tpu_torch/models/inference.py", "rba_tpu_torch/evalx/panoptic.py",
                      "rba_tpu_torch/evalx/seg_evaluators.py", "rba_tpu_torch/evalx/eval_semseg.py",
                      "rba_tpu_torch/data/catalog.py", "rba_tpu_torch/data/categories.py",
                      "rba_tpu_torch/tools/evaluate_pq_semseg.py")


BACKBONE_MODULES = ("rba_tpu_torch/models/backbones.py", "rba_tpu_torch/models/resnet.py",
                    "rba_tpu_torch/models/mix_transformer.py", "rba_tpu_torch/models/wideresnet.py",
                    "rba_tpu_torch/models/vit.py", "rba_tpu_torch/models/mvit.py")


# the last slice (ROADMAP.md §A.8): several GPUs, int8 weights, the utilities and tools
A8_MODULES = ("rba_tpu_torch/parallel/mesh.py", "rba_tpu_torch/parallel/sharded_eval.py",
              "rba_tpu_torch/parallel/tp.py", "rba_tpu_torch/ops/quant.py", "rba_tpu_torch/utils/profiling.py",
              "rba_tpu_torch/utils/debug.py", "rba_tpu_torch/tools/analyze_model.py",
              "rba_tpu_torch/tools/ablation.py", "rba_tpu_torch/tools/selfcheck.py",
              "rba_tpu_torch/tools/boundary_ap.py", "rba_tpu_torch/tools/prepare_coco_semseg.py",
              "rba_tpu_torch/tools/vis_utils.py")


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert "chip_smoke.py" in names and "rba_tpu_torch/models/maskformer.py" in names
    assert (ROOT / "chip_smoke.py").exists()
    # the training slice's modules are among the files checked below
    assert set(TRAINING_MODULES) <= names
    assert set(EVALUATION_MODULES) <= names  # and the closed-set evaluation slice's
    assert set(BACKBONE_MODULES) <= names  # and the backbones'
    assert set(A8_MODULES) <= names  # and the last slice's


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


def test_load_checkpoint_params_defaults_to_the_gpu(tmp_path):
    """A directory with a Detectron2 model_final.pth and no params.npz: converted and
    built on the card by default; without one it raises before reading the file."""
    from rba_tpu_torch.config import tiny_test_config
    from rba_tpu_torch.convert import load_checkpoint_params
    from tests.torch_port_common import d2_state_dict

    sd = d2_state_dict(tiny_test_config(), seed=0)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, tmp_path / "model_final.pth")
    if torch.cuda.is_available():
        model = load_checkpoint_params(str(tmp_path), tiny_test_config())
        assert next(model.parameters()).is_cuda and (tmp_path / "params.npz").exists()
    else:
        with pytest.raises(RuntimeError, match="GPU"):
            load_checkpoint_params(str(tmp_path), tiny_test_config())
        assert not (tmp_path / "params.npz").exists()


def test_trainer_defaults_to_the_gpu(tmp_path):
    """``make_train_state`` and the trainer CLI run on the card unless asked for the CPU."""
    from rba_tpu_torch.config import tiny_test_config
    from rba_tpu_torch.train.train_step import make_train_state

    if torch.cuda.is_available():
        assert next(make_train_state(tiny_test_config()).model.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="GPU"):
            make_train_state(tiny_test_config())


def test_trainer_evaluation_defaults_to_the_gpu(tmp_path):
    """``--eval-only`` runs on the card unless asked for the CPU: without one it raises
    before it reads any data."""
    from rba_tpu_torch.train import train_net
    from tests.test_torch_train_cli import _config

    args = ["--config-file", str(_config(tmp_path / "config.yaml")), "--data-root", str(tmp_path),
            "--output-dir", str(tmp_path / "out"), "--eval-only"]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="GPU"):
        train_net.main(args)


def test_last_slice_entry_points_default_to_the_gpu(tmp_path):
    """The model analysis, the selfcheck, the ablation and the process group run on the
    card unless the caller asks for the CPU: without one they raise."""
    import torch.distributed as dist

    from rba_tpu_torch.parallel.mesh import backend_for, make_mesh
    from rba_tpu_torch.tools import ablation, analyze_model, selfcheck
    from tests.test_torch_train_cli import _config

    assert backend_for("cuda") == "nccl" and backend_for("cpu") == "gloo"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="GPU"):
        analyze_model.main(["--config-file", str(_config(tmp_path / "config.yaml"))])
    with pytest.raises(RuntimeError, match="GPU"):
        selfcheck.run_selfcheck(str(tmp_path), "tiny", n_images=1, hw=(32, 48))
    with pytest.raises(RuntimeError, match="GPU"):
        ablation.main(["--tiny", "--images", "1", "--hw", "32x48", "--workdir", str(tmp_path)])
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="GPU"):
        make_mesh()
    assert not dist.is_initialized()


KERNEL_MODULES = ("window_attention", "fused_rba", "masked_softmax", "fused_mlp", "lsap", "ms_deform_attn",
                  "sr_attention", "rel_pos_attention")


def test_kernels_decide_their_own_routes():
    """Each kernel's module defines its ``takes`` rule and only they read the switch, and
    ``kernels/`` imports nothing from the layers that call it (ops, models, train)."""
    kernels = ROOT / "rba_tpu_torch" / "kernels"
    for name in KERNEL_MODULES:
        tree = ast.parse((kernels / f"{name}.py").read_text())
        assert "takes" in {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}, name
    readers = {p.relative_to(ROOT).as_posix() for p in (ROOT / "rba_tpu_torch").rglob("*.py")
               if "_PLAIN" in p.read_text()}
    assert readers == {f"rba_tpu_torch/kernels/{name}.py" for name in ("__init__", *KERNEL_MODULES)}
    for path in kernels.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                module = (node.module or "") if node.level else (node.module or "").removeprefix("rba_tpu_torch.")
                assert module.split(".")[0] not in ("ops", "models", "train"), (path.name, module)
