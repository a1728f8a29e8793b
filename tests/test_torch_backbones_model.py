"""Whole models on the non-Swin backbones against rba_tpu on the CPU.

- A tiny three-level R50 model (the full ResNet-50 backbone under a narrow head: res3–res5
  deformable levels, 3 decoder layers) and a stride-16 ViT-B model (the fixed ``ViTConfig()``,
  one ``last_feat`` level, no FPN), each converted from one seeded Detectron2 dict by
  both packages, at fp32: sem_seg within 1e-4 and the score map within 1e-3 of rba_tpu's
  ``maskformer_infer`` (jitted: at fp32 it computes the op-by-op function).
- ``maskformer_infer_rba``: on the R50 model (mask features at stride 4) it is Kernel B's
  path and equals ``maskformer_infer(...)["rba"]``; on the ViT model (stride 16) it is
  ``maskformer_infer(...)["rba"]``, of the input's size.  rba_tpu's own
  ``maskformer_infer_rba`` returns a quarter-size map there (ROADMAP.md §C), recorded by
  a case that holds its shape.
- The pixel decoder with one input feature (ViT) and with five features at one stride
  (WiderResNet-38: four FPN levels that need no resize) against rba_tpu's.
- The mask stride of each family's shipped config, and the trainer's refusal of
  per-pixel heads (it trains every backbone family).
- The open-panoptic evaluator on the stride-16 ViT model: its open branch's map is
  ``open_rba_map`` of the full-resolution logits (Kernel B's ×4 does not fit there), so
  ``predict`` equals rba_tpu's ``panoptic_inference`` with ``rba_map=None``, segments
  and panoptic map.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.convert import d2_mapping as jd2
from rba_tpu.models import maskformer as jmf
from rba_tpu.models import pixel_decoder as jpd
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.convert import load_jax_params
from rba_tpu_torch.kernels import fused_rba as tfr
from rba_tpu_torch.kernels import plain_versions
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.models import pixel_decoder as tpd
from rba_tpu_torch.models.maskformer import RbAModel
from tests.torch_port_common import d2_full_state_dict, max_abs, record, t, to_jax

FP32_TOL = 1e-4
SCORE_TOL = 1e-3
CONFIGS = "configs/cityscapes/semantic-segmentation"


def small_head(pkg, backbone: str, levels):
    """``tiny_test_config``'s narrow head over ``backbone``, its deformable levels
    ``levels`` and FPN inputs ``fpn``, at fp32."""
    base = pkg.tiny_test_config()
    in_features = {"resnet": ("res2", "res3", "res4", "res5"), "vit": ("last_feat",)}[backbone]
    return dataclasses.replace(
        base, backbone_name=backbone, compute_dtype="float32",
        pixel_decoder=dataclasses.replace(base.pixel_decoder, transformer_in_features=levels, in_features=in_features),
        decoder=dataclasses.replace(base.decoder, num_feature_levels=len(levels)))


def model_pair(backbone, levels, seed=0):
    jcfg, tcfg = small_head(jconfig, backbone, levels), small_head(tconfig, backbone, levels)
    params = jd2.convert_d2_state_dict(d2_full_state_dict(tcfg, seed), jcfg)
    model = tmf.build_model(tcfg, device="cpu")
    load_jax_params(model, params)
    return jcfg, tcfg, to_jax(params), model


@pytest.fixture(scope="module")
def r50():
    return model_pair("resnet", ("res3", "res4", "res5"))


@pytest.fixture(scope="module")
def vit():
    return model_pair("vit", ("last_feat",))


def _image(hw, seed=0):
    return (np.random.RandomState(seed).rand(1, *hw, 3) * 255).astype(np.float32)


@pytest.mark.parametrize("name", ["r50", "vit"])
def test_model_equals_rba_tpu_at_fp32(name, request):
    jcfg, tcfg, params, model = request.getfixturevalue(name)
    img = _image((64, 96))
    want = jax.jit(lambda p, x: jmf.maskformer_infer(p, jcfg, x))(params, jnp.asarray(img))
    got = tmf.maskformer_infer(model, tcfg, t(img))
    diffs = dict(sem_seg=max_abs(got["sem_seg"], want["sem_seg"]), rba=max_abs(got["rba"], want["rba"]))
    record(request, **diffs)
    assert diffs["sem_seg"] < FP32_TOL and diffs["rba"] < SCORE_TOL, diffs
    rba = tmf.maskformer_infer_rba(model, tcfg, t(img))
    assert tuple(rba.shape) == (1, 64, 96)
    assert max_abs(rba, got["rba"]) < FP32_TOL
    assert max_abs(rba, want["rba"]) < SCORE_TOL


def test_r50_rba_takes_the_fused_tail(r50, monkeypatch):
    """At stride 4 the score comes from the fused RbA tail (Kernel B's plain version on
    the CPU), on the decoder's bhwq masks."""
    _, tcfg, _, model = r50
    calls = []
    real = tfr.fused_rba_score_reference

    def counted(cls, masks, masks_layout="bqhw"):
        calls.append(tuple(masks.shape))
        return real(cls, masks, masks_layout)

    monkeypatch.setattr(tfr, "fused_rba_score_reference", counted)
    assert model.mask_stride(tcfg) == 4
    with plain_versions():
        tmf.maskformer_infer_rba(model, tcfg, t(_image((64, 96))))
    assert calls == [(1, 16, 24, tcfg.decoder.num_queries)]


def test_vit_rba_takes_maskformer_infer(vit, monkeypatch):
    _, tcfg, _, model = vit
    monkeypatch.setattr(tfr, "fused_rba_score_reference", None)  # never called at stride 16
    monkeypatch.setattr(tmf, "fused_rba_score", None)
    assert model.mask_stride(tcfg) == 16
    with plain_versions():
        assert tuple(tmf.maskformer_infer_rba(model, tcfg, t(_image((64, 96)))).shape) == (1, 64, 96)


def test_rba_tpus_fused_tail_has_the_wrong_size_at_stride_16(vit, request):
    """rba_tpu's ``maskformer_infer_rba`` upsamples stride-16 masks by 4 only: on a 64x96
    frame its map is 16x24, where ``maskformer_infer(...)["rba"]`` is 64x96."""
    jcfg, _, params, _ = vit
    img = jnp.asarray(_image((64, 96)))
    wrong = jax.jit(lambda p, x: jmf.maskformer_infer_rba(p, jcfg, x))(params, img)
    right = jax.jit(lambda p, x: jmf.maskformer_infer(p, jcfg, x)["rba"])(params, img)
    record(request, rba_tpu_infer_rba_h=wrong.shape[1], rba_tpu_infer_rba_w=wrong.shape[2])
    assert wrong.shape == (1, 16, 24) and right.shape == (1, 64, 96)


@pytest.mark.parametrize("case", ["one_feature", "five_at_one_stride"])
def test_pixel_decoder_feature_layouts_equal_rba_tpu(case, request):
    base = tconfig.tiny_test_config().pixel_decoder
    if case == "one_feature":  # ViT: last_feat at stride 16 is the level and the mask features
        channels, hw = {"last_feat": 48}, {"last_feat": (4, 6)}
        kw = dict(in_features=("last_feat",), transformer_in_features=("last_feat",))
    else:  # WiderResNet-38: res4..res7_bn at stride 8, the deformable level res7_bn
        channels = {"res4": 32, "res5": 48, "res6": 64, "res7": 96, "res7_bn": 96}
        hw = dict.fromkeys(channels, (8, 12))
        kw = dict(in_features=tuple(channels), transformer_in_features=("res7_bn",))
    tcfg = dataclasses.replace(base, **kw)
    jcfg = dataclasses.replace(jconfig.tiny_test_config().pixel_decoder, **kw)
    params = jpd.pixel_decoder_init(jax.random.PRNGKey(0), jcfg, channels)
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.02 * rs.randn(*np.shape(a)).astype(np.float32), params)
    model = tpd.PixelDecoder(tcfg, channels)
    load_jax_params(model, params)
    feats = {k: rs.randn(1, *hw[k], c).astype(np.float32) for k, c in channels.items()}
    want = jax.jit(lambda p, f: jpd.pixel_decoder_apply(p, jcfg, f))(to_jax(params), to_jax(feats))
    with torch.no_grad():
        got = tpd.pixel_decoder_apply(model, tcfg, {k: t(v) for k, v in feats.items()})
    assert len(got[2]) == len(want[2]) == 1 and tuple(got[0].shape) == tuple(want[0].shape)
    diffs = dict(mask_features=max_abs(got[0], want[0]), encoder=max_abs(got[1], want[1]))
    record(request, **diffs)
    assert all(v < FP32_TOL for v in diffs.values()), diffs


@pytest.mark.parametrize("path,stride", [
    ("maskformer2_R50_bs16_90k.yaml", 4), ("mix_transformer/maskformer_2_mit_b5_in21k_1dl.yaml", 4),
    ("mvit/maskformer_2_mvit_in21k_bs16_90k_1dl.yaml", 4), ("vit/maskformer_2_vit_imagenet_bs16_90k.yaml", 16),
    ("wideresnet/maskformer_2_wideresnet38_imagenet_bs16_90k_1dl.yaml", 8),
])
def test_mask_stride_of_each_family(path, stride):
    cfg = tconfig.load_config(f"{CONFIGS}/{path}")
    with torch.device("meta"):
        assert RbAModel(cfg).mask_stride(cfg) == stride


def test_training_refuses_per_pixel_heads():
    """Refused until ROADMAP.md §A.6 ported it: the per-pixel head over ResNet-50 trains.
    One step of ``make_train_step`` from one seeded Detectron2 dict: its cross-entropy
    within 1e-5 of rba_tpu's ``per_pixel_losses`` on the same logits, finite metrics."""
    from rba_tpu.models import baseline_heads as jbh
    from rba_tpu_torch.train.train_step import make_train_state, make_train_step

    tcfg = dataclasses.replace(small_head(tconfig, "resnet", ("res5",)), sem_seg_head_name="PerPixelBaselineHead")
    jcfg = dataclasses.replace(small_head(jconfig, "resnet", ("res5",)), sem_seg_head_name="PerPixelBaselineHead")
    params = jd2.convert_d2_state_dict(d2_full_state_dict(tcfg, 0), jcfg)
    model = load_jax_params(tmf.build_model(tcfg, device="cpu"), params)
    rs = np.random.RandomState(0)
    batch = dict(images=(rs.rand(1, 64, 64, 3) * 255).astype(np.float32),
                 sem_seg=rs.choice([0, 1, 2, 255], (1, 64, 64)).astype(np.int32))
    with torch.no_grad():
        logits, _ = tmf.per_pixel_forward(model, tcfg, tmf.preprocess(tcfg, t(batch["images"])))
    want = float(jbh.per_pixel_losses(jcfg, jax.random.PRNGKey(0), jnp.asarray(logits.numpy()), [],
                                      jnp.asarray(batch["sem_seg"]))["loss_sem_seg"])
    metrics = make_train_step(tcfg)(make_train_state(tcfg, model=model), batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert abs(float(metrics["loss_sem_seg"]) - want) <= 1e-5 * max(1.0, abs(want))


@pytest.mark.parametrize("ood_threshold", [-1e9, -2.5])
def test_vit_open_panoptic_equals_rba_tpu(vit, monkeypatch, ood_threshold):
    """One seeded 64x96 frame, object-mask and overlap thresholds 0: the port's
    ``OpenPanopticEvaluator.predict`` on the stride-16 ViT model against rba_tpu's
    ``panoptic_inference`` (``rba_map=None``: the map from the full-resolution logits) on
    rba_tpu's own outputs.  Kernel B (and its plain version) is never called.  At the
    threshold -1e9 the unlabelled pixels form an unknown segment."""
    from rba_tpu.evalx import seg_evaluators as jse
    from rba_tpu.models import inference as jinf
    from rba_tpu_torch.evalx import seg_evaluators as tse

    jcfg, tcfg, params, model = vit
    jcfg, tcfg = ((dataclasses.replace(c, test=dataclasses.replace(c.test, object_mask_threshold=0.0,
                                                                    overlap_threshold=0.0)))
                  for c in (jcfg, tcfg))
    monkeypatch.setattr(tse, "fused_rba_score", None)
    image = np.random.RandomState(7).randint(0, 256, (64, 96, 3)).astype(np.uint8)
    kw = dict(thing_ids=(5, 6), open_panoptic=True, ood_threshold=ood_threshold)
    got_map, got_segs = tse.OpenPanopticEvaluator(tcfg, model, **kw).predict(image)
    mask_cls, mask_pred = jse.OpenPanopticEvaluator(jcfg, params, **kw)._raw_outputs(image)
    want_map, want_segs = jinf.panoptic_inference(jcfg, mask_cls, mask_pred, rba_map=None, **kw)
    assert got_map.shape == (64, 96)
    assert np.array_equal(got_map, want_map) and got_segs == want_segs
    assert any(seg["category_id"] == 255 for seg in got_segs) == (ood_threshold == -1e9)
