"""The port's ``timm-swin`` and ``torchvision`` converter modes
(``rba_tpu_torch/tools/convert_checkpoint.py``) against rba_tpu's CLI on the CPU.

Neither timm nor torchvision weights are here, so the checkpoints are synthetic, seeded
numpy in each library's names and layouts: a timm Swin dict (the Detectron2 Swin names
without ``backbone.``, with timm's classifier, final norm, ``relative_position_index`` and
``attn_mask``, and without the per-output norms) and a torchvision ResNet dict
(``conv1``/``bn1``, ``layer{L}``, ``downsample``, ``num_batches_tracked``, ``fc``).  The
port's CLI runs with jax and rba_tpu blocked in ``sys.modules``; the ``.npz`` it writes
equals rba_tpu's, key for key, dtype and bits.  On a native YAML, which rba_tpu's CLI reads
as a Detectron2 one (ROADMAP.md §C.13), the port's torchvision output equals rba_tpu's
conversion functions under rba_tpu's native config.
"""
import dataclasses
import re
import sys

import numpy as np
import pytest
import torch
import yaml

from rba_tpu import config as jconfig
from rba_tpu.convert import d2_mapping as jd2
from rba_tpu.tools import convert_checkpoint as jcli
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.convert import d2_mapping as td2
from rba_tpu_torch.tools import convert_checkpoint as tcli
from tests.torch_port_common import D2_TINY, assert_trees_equal, d2_backbone_state_dict, d2_state_dict

R101_NATIVE = "configs/cityscapes/semantic-segmentation/maskformer2_R101_bs16_90k_1dl_coco_mix.yaml"


def _resnet_d2_yaml(depth: int) -> dict:
    return {"MODEL": {"BACKBONE": {"NAME": "build_resnet_backbone"},
                      "RESNETS": {"DEPTH": depth, "OUT_FEATURES": ["res2", "res3", "res4", "res5"]}}}


def torchvision_state_dict(cfg, seed: int) -> dict:
    """A seeded torchvision ResNet state dict of ``cfg.resnet``'s depth, from the
    Detectron2 backbone dict of the same seed with the names mapped back."""
    out = {}
    for k, v in d2_backbone_state_dict(cfg, seed).items():
        k = k[len("backbone."):]
        k = k.replace("stem.conv1.norm.", "bn1.").replace("stem.conv1.", "conv1.")
        k = re.sub(r"^res(\d)\.", lambda m: f"layer{int(m[1]) - 1}.", k)
        k = k.replace(".shortcut.norm.", ".downsample.1.").replace(".shortcut.", ".downsample.0.")
        k = re.sub(r"\.conv(\d)\.norm\.", r".bn\1.", k)
        out[k] = v
        if k.endswith("running_var"):
            out[k.replace("running_var", "num_batches_tracked")] = np.array(7, np.int64)
    rng = np.random.default_rng(seed + 5)
    out["fc.weight"] = rng.standard_normal((1000, 2048), dtype=np.float32)
    out["fc.bias"] = rng.standard_normal(1000, dtype=np.float32)
    return out


def timm_swin_state_dict(cfg, seed: int) -> dict:
    """A seeded timm Swin state dict of ``cfg.swin``: Detectron2's Swin names without
    ``backbone.`` or the per-output norms, plus timm's extras."""
    out = {k[len("backbone."):]: v for k, v in d2_state_dict(cfg, seed).items()
           if k.startswith("backbone.") and not re.match(r"backbone\.norm\d\.", k)}
    rng = np.random.default_rng(seed + 5)
    dim = cfg.swin.stage_dim(cfg.swin.num_layers - 1)
    out.update({"head.weight": rng.standard_normal((1000, dim), dtype=np.float32),
                "head.bias": np.zeros(1000, np.float32), "norm.weight": np.ones(dim, np.float32),
                "norm.bias": np.zeros(dim, np.float32),
                "layers.0.blocks.0.attn.relative_position_index": np.arange(16, dtype=np.int64).reshape(4, 4),
                "layers.0.blocks.1.attn_mask": np.zeros((4, 16, 16), np.float32)})
    return out


def _write_pth(path, sd) -> str:
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    return str(path)


def _jax_blocked(monkeypatch):
    """Every jax, jaxlib and rba_tpu module unimportable until the test ends."""
    for name in [n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "rba_tpu")]:
        monkeypatch.setitem(sys.modules, name, None)


def _run_both(tmp_path, capsys, monkeypatch, mode, cfg_path, ckpt):
    common = [mode, "--config", str(cfg_path), "--checkpoint", ckpt]
    jcli.main(common + ["--out", str(tmp_path / "jax.npz")])
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    with monkeypatch.context() as m:
        _jax_blocked(m)
        with pytest.raises(ImportError):
            __import__("jax.numpy")
        tcli.main(common + ["--out", str(tmp_path / "port.npz")])
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_line.replace("port.npz", "X") == jax_line.replace("jax.npz", "X")
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        return {k: a[k] for k in a.files}


@pytest.mark.parametrize("depth", [50, 101])
def test_torchvision_cli_writes_rba_tpus_npz(tmp_path, capsys, monkeypatch, depth):
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(_resnet_d2_yaml(depth)))
    tcfg = tconfig.load_config(str(cfg_path))
    assert tcfg.backbone_name == "resnet" and tcfg.resnet.depth == depth
    ckpt = _write_pth(tmp_path / "resnet.pth", torchvision_state_dict(tcfg, seed=depth))
    got = _run_both(tmp_path, capsys, monkeypatch, "torchvision", cfg_path, ckpt)
    blocks = {k.split("|")[1] for k in got if k.startswith("res4|")}
    assert len(blocks) == tcfg.resnet.stage_blocks[2]  # every block of res4: 6 or 23
    assert not any("fc" in k or "num_batches" in k for k in got)


def test_torchvision_mapping_equals_rba_tpus():
    sd = torchvision_state_dict(tconfig.load_config(R101_NATIVE), seed=3)
    got, want = td2.torchvision_resnet_to_d2(sd), jd2.torchvision_resnet_to_d2(sd)
    assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)


def test_torchvision_cli_on_a_native_config(tmp_path, capsys, monkeypatch):
    """The R101 outlier recipe's native YAML: all 23 res4 blocks, as rba_tpu's own
    conversion functions give them under its native config (``load_config``)."""
    tcfg = tconfig.load_config(R101_NATIVE)
    sd = torchvision_state_dict(tcfg, seed=4)
    ckpt = _write_pth(tmp_path / "resnet101.pth", sd)
    with monkeypatch.context() as m:
        _jax_blocked(m)
        tcli.main(["torchvision", "--config", R101_NATIVE, "--checkpoint", ckpt, "--out", str(tmp_path / "port.npz")])
    want = jd2.convert_resnet_backbone(jd2.torchvision_resnet_to_d2(sd), jconfig.load_config(R101_NATIVE))
    with np.load(tmp_path / "port.npz") as a:
        got = {k: a[k] for k in a.files}
    want_flat = {k.replace(".", "|"): v for k, v in _flat(want)}
    assert sorted(got) == sorted(want_flat)
    assert all(got[k].dtype == v.dtype and np.array_equal(got[k], v) for k, v in want_flat.items())
    assert len({k.split("|")[1] for k in got if k.startswith("res4|")}) == 23


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def test_timm_swin_cli_writes_rba_tpus_npz(tmp_path, capsys, monkeypatch):
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(D2_TINY))
    tcfg = tconfig.load_config(str(cfg_path))
    ckpt = _write_pth(tmp_path / "swin.pth", timm_swin_state_dict(tcfg, seed=2))
    got = _run_both(tmp_path, capsys, monkeypatch, "timm-swin", cfg_path, ckpt)
    # the per-output norms that timm lacks: unit scale, zero bias, fp32
    for i in range(tcfg.swin.num_layers):
        assert got[f"norm{i}|scale"].dtype == np.float32 and np.all(got[f"norm{i}|scale"] == 1)
        assert np.all(got[f"norm{i}|bias"] == 0)
    assert not any(k.startswith(("head", "norm|")) for k in got)


def test_convert_timm_swin_equals_rba_tpus():
    """The conversion function alone, at Swin-L's widths and ``tiny_test_config``'s depths."""
    tcfg, jcfg = (dataclasses.replace(c, swin=dataclasses.replace(c.swin, embed_dim=192, num_heads=(6, 12)))
                  for c in (tconfig.tiny_test_config(), jconfig.tiny_test_config()))
    sd = timm_swin_state_dict(tcfg, seed=6)
    assert_trees_equal(tcli.convert_timm_swin(sd, tcfg), jcli.convert_timm_swin(sd, jcfg))
