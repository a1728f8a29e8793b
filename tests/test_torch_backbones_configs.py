"""Every shipped config with a backbone other than Swin builds in the port.

- Each of the 22 non-Swin YAMLs under ``configs/`` loads (``load_config``), passes
  ``check_supported`` and builds ``RbAModel`` on the ``meta`` device, with the config's
  feature names among its backbone's outputs.
- For one config of each variant (R50, R101, MiT-B3/B4/B5, MViT, ViT, WiderResNet-38),
  the port's parameters have the paths and shapes of rba_tpu's tree, from
  ``jax.eval_shape`` of its ``maskformer_init`` (no weights are made on either side).
"""
from pathlib import Path

import jax
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.models.maskformer import maskformer_init
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.convert.params import jax_path
from rba_tpu_torch.models.maskformer import RbAModel
from tests.torch_port_common import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
NON_SWIN = sorted(p.relative_to(ROOT).as_posix() for p in (ROOT / "configs").rglob("*.yaml")
                  if tconfig.load_config(str(p)).backbone_name != "swin")
VARIANTS = {
    "R50": "maskformer2_R50_bs16_90k.yaml", "R101": "maskformer2_R101_bs16_90k_1dl.yaml",
    "mit_b3": "mix_transformer/maskformer_2_mit_b3_in21k_1dl.yaml",
    "mit_b4": "mix_transformer/maskformer_2_mit_b4_in21k_1dl.yaml",
    "mit_b5": "mix_transformer/maskformer_2_mit_b5_in21k_1dl.yaml",
    "mvit": "mvit/maskformer_2_mvit_in21k_bs16_90k_1dl.yaml", "vit": "vit/maskformer_2_vit_imagenet_bs16_90k.yaml",
    "wideresnet38": "wideresnet/maskformer_2_wideresnet38_imagenet_bs16_90k_1dl.yaml",
}


def test_the_shipped_non_swin_configs():
    families = sorted({tconfig.load_config(str(ROOT / p)).backbone_name for p in NON_SWIN})
    assert len(NON_SWIN) == 22
    assert families == ["mit_b3", "mit_b4", "mit_b5", "mvit", "resnet", "vit", "wideresnet38"]


@pytest.mark.parametrize("path", NON_SWIN)
def test_config_builds(path):
    cfg = tconfig.load_config(str(ROOT / path))
    tconfig.check_supported(cfg)
    with torch.device("meta"):
        model = RbAModel(cfg)
    assert set(cfg.pixel_decoder.in_features) <= set(model.backbone.out_channels)
    assert model.mask_stride(cfg) in (4, 8, 16)


def _port_shapes(model):
    out = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name.endswith(".weight") and len(shape) == 2:
            shape = shape[::-1]
        elif name.endswith(".weight") and len(shape) == 4:
            shape = (shape[2], shape[3], shape[1], shape[0])  # OIHW -> HWIO
        out[jax_path(name, len(shape))] = shape
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_parameter_tree_equals_rba_tpus(variant):
    path = str(ROOT / "configs/cityscapes/semantic-segmentation" / VARIANTS[variant])
    with torch.device("meta"):
        got = _port_shapes(RbAModel(tconfig.load_config(path)))
    tree = jax.eval_shape(lambda k: maskformer_init(k, jconfig.load_config(path)), jax.random.PRNGKey(0))
    want = {"/".join(str(k) for k in p): tuple(leaf.shape) for p, leaf in tree_leaves(tree)}
    assert got == want
