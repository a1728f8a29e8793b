"""HuggingFace checkpoint ingestion in the port (``rba_tpu_torch/convert/hf_mapping.py``):

- the four name mappings equal rba_tpu's bit for bit on randomly initialised tiny HF
  models (Mask2Former, MaskFormer v1, SegFormer, ViTDet), and ``rba_config_from_hf``
  gives rba_tpu's config field for field;
- the port's model, from ``convert_hf_checkpoint``, against the HF model itself at the
  tolerances of ``tests/test_hf_crossval.py`` (atol 2e-5 and rtol 1e-4; 1e-4 for
  SegFormer): Mask2Former on a window-multiple input and on a padded one with projected
  predictor inputs, MaskFormer v1 on a window-multiple input and on one whose last
  stages are smaller than the window (the pad-style Swin), SegFormer (MiT-B0 geometry)
  and ViTDet;
- ``tests/d2_synthetic.py``'s renaming of a Detectron2 dict to HF names (the ``hf``
  phase of ``chip_smoke.py`` runs it on the card) against the state dict
  of a full-width ``Mask2FormerForUniversalSegmentation`` of
  ``facebook/mask2former-swin-base-IN21k-cityscapes-semantic``'s architecture, built on
  the meta device: the same names and shapes."""
import dataclasses
import os

import numpy as np
import pytest
import torch

# HF's models are torch ones: keep transformers from importing TensorFlow, which costs
# seconds (where a test file of this process imported transformers first, it already has)
os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")

from rba_tpu.convert import hf_mapping as jhf  # noqa: E402
from rba_tpu_torch.convert import hf_mapping as thf  # noqa: E402
from rba_tpu_torch.convert import load_jax_params  # noqa: E402
from rba_tpu_torch.models import maskformer as tmf  # noqa: E402
from tests.torch_port_common import assert_trees_equal  # noqa: E402
from tests import test_hf_crossval as jx  # noqa: E402  (the tiny HF models of rba_tpu's own oracle)

ATOL, RTOL = 2e-5, 1e-4


def _nchw(img):
    return torch.from_numpy(img.transpose(0, 3, 1, 2))


def _assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


def _mask2former_case(m, h, w, seed):
    params, cfg = thf.convert_hf_checkpoint(m)
    model = load_jax_params(tmf.build_model(cfg, device="cpu"), params)
    img = jx._image(h, w, seed)
    with torch.no_grad():
        hf = m(pixel_values=_nchw(img))
        ours = tmf.maskformer_forward(model, cfg, torch.from_numpy(img), attention="xla")
    np.testing.assert_allclose(ours["pred_logits"].numpy(), hf.class_queries_logits.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ours["pred_masks"].numpy(), hf.masks_queries_logits.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", ["plain", "padded_and_projected"])
def test_mask2former_matches_hf_and_maps_as_rba_tpu(case):
    """128x128: every stage a window multiple.  132x164: window padding and shifted-window
    masks at all four stages, and hidden_dim 24 != feature_size 32, so the predictor's
    input projections, which HF keeps in a plain list, are harvested from the module."""
    m = jx._tiny_hf_model() if case == "plain" else jx._tiny_hf_model(hidden_dim=24, decoder_layers=4,
                                                                           num_labels=5, seed=3)
    _assert_state_dicts_equal(thf.hf_mask2former_to_d2(m.state_dict()), jhf.hf_mask2former_to_d2(m.state_dict()))
    tcfg, jcfg = thf.rba_config_from_hf(m.config), jhf.rba_config_from_hf(m.config)
    assert dataclasses.asdict(tcfg) == {k: v for k, v in dataclasses.asdict(jcfg).items() if k in
                                        dataclasses.asdict(tcfg)}
    tp, _ = thf.convert_hf_checkpoint(m)
    jp, _ = jhf.convert_hf_checkpoint(m)
    assert_trees_equal(tp, jp)
    if case == "plain":
        _mask2former_case(m, 128, 128, seed=1)
    else:
        _mask2former_case(m, 132, 164, seed=5)


def _v1_model_and_cfg():
    m, _, jcfg = jx._tiny_hf_maskformer_v1()
    from rba_tpu_torch import config as tc

    cfg = tc.RbAConfig(
        swin=tc.SwinConfig(patch_size=4, embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=4,
                           drop_path_rate=0.0),
        pixel_decoder=tc.PixelDecoderConfig(name="BasePixelDecoder", conv_dim=32, mask_dim=32),
        decoder=tc.DecoderConfig(name="StandardTransformerDecoder", hidden_dim=32, num_queries=jcfg.decoder.num_queries,
                                 nheads=4, dim_feedforward=64, dec_layers_total=2, mask_dim=32,
                                 transformer_in_feature="res5"),
        num_classes=7, compute_dtype="float32")
    return m, cfg


@pytest.mark.parametrize("hw", [(128, 160), (48, 64)])
def test_maskformer_v1_matches_hf_and_maps_as_rba_tpu(hw):
    """MaskFormer v1 (pad-style Swin → BasePixelDecoder → DETR decoder) against HF's
    MaskFormerForInstanceSegmentation.  At 48x64 the stage grids are 12x16 / 6x8 / 3x4 /
    2x2: the last two are smaller than the window, so they are zero-padded to one window."""
    m, cfg = _v1_model_and_cfg()
    sd = m.state_dict()
    d2 = thf.hf_maskformer_v1_to_d2(sd)
    _assert_state_dicts_equal(d2, jhf.hf_maskformer_v1_to_d2(sd))
    from rba_tpu_torch.convert.d2_mapping import convert_d2_state_dict

    model = load_jax_params(tmf.build_model(cfg, device="cpu"), convert_d2_state_dict(d2, cfg))
    img = jx._image(*hw, seed=1 if hw == (128, 160) else 2)
    with torch.no_grad():
        hf = m(pixel_values=_nchw(img))
        ours = tmf.maskformer_forward(model, cfg, torch.from_numpy(img), attention="xla")
    np.testing.assert_allclose(ours["pred_logits"].numpy(), hf.class_queries_logits.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ours["pred_masks"].numpy(), hf.masks_queries_logits.numpy(), atol=ATOL, rtol=RTOL)


def test_segformer_matches_hf_and_maps_as_rba_tpu():
    from transformers import SegformerConfig, SegformerModel

    from rba_tpu_torch.convert.d2_mapping import convert_mit_backbone
    from rba_tpu_torch.models import mix_transformer as tmit

    torch.manual_seed(0)
    c = SegformerConfig(num_encoder_blocks=4, depths=[2, 2, 2, 2], sr_ratios=[8, 4, 2, 1],
                        hidden_sizes=[32, 64, 160, 256], patch_sizes=[7, 3, 3, 3], strides=[4, 2, 2, 2],
                        num_attention_heads=[1, 2, 5, 8], mlp_ratios=[4, 4, 4, 4], hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0, drop_path_rate=0.0, reshape_last_stage=True)
    m = SegformerModel(c).eval()
    d2 = thf.hf_segformer_to_d2(m.state_dict())
    _assert_state_dicts_equal(d2, jhf.hf_segformer_to_d2(m.state_dict()))
    model = load_jax_params(tmit.MiT(tmit.MIT_VARIANTS["mit_b0"]), convert_mit_backbone(d2))
    img = jx._image(64, 96)
    with torch.no_grad():
        hf = m(_nchw(img), output_hidden_states=True)
        feats = tmit.mit_apply(model, torch.from_numpy(img), compute_dtype=torch.float32)
    for i, k in enumerate(["res2", "res3", "res4", "res5"]):
        np.testing.assert_allclose(feats[k].numpy(), hf.hidden_states[i].numpy().transpose(0, 2, 3, 1),
                                   atol=1e-4, rtol=1e-4)


def test_vitdet_matches_hf_and_maps_as_rba_tpu():
    """A 3x3 grid from a 2x2 pretrain grid: the bicubic resample of the absolute
    positions, window padding 3 -> 4 in the window blocks, the residual block."""
    from rba_tpu_torch.convert.d2_mapping import convert_vit_backbone
    from rba_tpu_torch.models import vit as tvit

    m = jx._tiny_hf_vitdet(seed=3)
    d2 = thf.hf_vitdet_to_d2(m.state_dict())
    _assert_state_dicts_equal(d2, jhf.hf_vitdet_to_d2(m.state_dict()))
    cfg = tvit.ViTConfig(patch_size=16, embed_dim=32, depth=4, num_heads=4, window_size=2,
                         window_block_indexes=(0, 2), residual_block_indexes=(1,), pretrain_img_size=32,
                         pretrain_use_cls_token=True)
    model = load_jax_params(tvit.ViT(cfg), convert_vit_backbone(d2))
    img = jx._image(48, 48, seed=13)
    with torch.no_grad():
        hf = m(_nchw(img)).last_hidden_state
        ours = tvit.vit_apply(model, torch.from_numpy(img), compute_dtype=torch.float32)
    np.testing.assert_allclose(ours["last_feat"].numpy(), hf.numpy().transpose(0, 2, 3, 1), atol=ATOL, rtol=RTOL)


def test_chip_smoke_hf_names_equal_a_full_width_hf_model():
    """The ``hf`` phase renames a seeded Detectron2 dict of the three-level Swin-B preset
    to HF names: every name and shape of HF's full-width model (``decoder_layers`` 10,
    19 labels), nothing more; and the renamed dict maps back to the Detectron2 dict."""
    from transformers import Mask2FormerConfig, Mask2FormerForUniversalSegmentation, SwinConfig

    from rba_tpu_torch.config import swin_b_1dl
    from tests.d2_synthetic import d2_state_dict, d2_to_hf_names, hf_cityscapes_cfg

    cfg = hf_cityscapes_cfg(swin_b_1dl())
    bb = SwinConfig(image_size=384, patch_size=4, embed_dim=128, depths=[2, 2, 18, 2], num_heads=[4, 8, 16, 32],
                    window_size=12, out_features=["stage1", "stage2", "stage3", "stage4"])
    hcfg = Mask2FormerConfig(backbone_config=bb, num_labels=19, decoder_layers=10)
    with torch.device("meta"):
        hf = Mask2FormerForUniversalSegmentation(hcfg)
    want = {k: tuple(v.shape) for k, v in hf.state_dict().items()
            if not k.startswith("criterion.") and not k.endswith("relative_position_index")}
    sd = d2_state_dict(cfg, 0, pre_rename=False)
    named = d2_to_hf_names(sd)
    assert {k: tuple(v.shape) for k, v in named.items()} == want
    back = thf.hf_mask2former_to_d2(named)
    d2 = {k: v for k, v in sd.items() if not k.endswith(("relative_position_index", "num_batches_tracked"))}
    assert sorted(back) == sorted(d2)
    assert all(np.array_equal(back[k], d2[k]) for k in d2)
