"""The non-Swin backbones, Swin's ``ape`` and the bicubic resize against rba_tpu on the CPU.

Each family is built at a small size (the sizes of ``tests/test_backbones.py``),
with weights from one seeded Detectron2 dict that rba_tpu's converter turns into its
tree, and run by both packages on the same seeded input.

- fp32: every output within ``FP32_RTOL`` of rba_tpu's, relative to the output's
  largest value where that exceeds 1 (random frozen batch norms let ResNet and
  WiderResNet maps grow to 1e4).
- The Detectron2 conversion of each family equals rba_tpu's bit for bit, and the
  port's model gives the tree back (``model_to_jax_params``).
- The bicubic resize and the relative-position resampling equal rba_tpu's.

rba_tpu runs jitted (``rba_apply``): at fp32 that is its op-by-op function up to fp32
rounding, with one compile instead of one per op.

The bf16 shares are in ``tests/test_torch_backbones_bf16.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.convert import d2_mapping as jd2
from rba_tpu.models import mix_transformer as jmit
from rba_tpu.models import mvit as jmvit
from rba_tpu.models import resnet as jresnet
from rba_tpu.models import swin as jswin
from rba_tpu.models import vit as jvit
from rba_tpu.models import wideresnet as jwrn
from rba_tpu.ops import resize as jresize
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.convert import d2_mapping as td2
from rba_tpu_torch.convert import load_jax_params, model_to_jax_params
from rba_tpu_torch.models import mix_transformer as tmit
from rba_tpu_torch.models import mvit as tmvit
from rba_tpu_torch.models import resnet as tresnet
from rba_tpu_torch.models import swin as tswin
from rba_tpu_torch.models import vit as tvit
from rba_tpu_torch.models import wideresnet as twrn
from rba_tpu_torch.ops import resize as tresize
from tests.torch_port_common import assert_trees_equal, d2_backbone_state_dict, d2_state_dict, max_abs, t

FP32_RTOL = 1e-4
VIT_SMALL = dict(embed_dim=64, depth=2, num_heads=2, window_size=4, window_block_indexes=(0,),
                 residual_block_indexes=(1,), pretrain_img_size=64)
MVIT_SMALL = dict(img_size=64, embed_dim=32, depth=4, num_heads=1, last_block_indexes=(0, 1, 2, 3),
                  adaptive_kv_stride=2, adaptive_window_size=8)
WRN_SMALL = dict(structure=(1, 1, 1, 1, 1, 1))
FAMILIES = ["resnet", "resnet_stride_in_1x1", "mit_b0", "wideresnet38", "vit", "vit_sfp", "mvit", "swin_ape"]


def _swin_ape_pair(seed):
    tcfg = dataclasses.replace(tconfig.tiny_test_config(), swin=dataclasses.replace(
        tconfig.tiny_test_config().swin, ape=True, pretrain_img_size=64))
    jcfg = dataclasses.replace(jconfig.tiny_test_config(), swin=dataclasses.replace(
        jconfig.tiny_test_config().swin, ape=True, pretrain_img_size=64))
    sd = {k: v for k, v in d2_state_dict(tcfg, seed).items() if k.startswith("backbone.")}
    n, c = 64 // tcfg.swin.patch_size, tcfg.swin.embed_dim
    sd["backbone.absolute_pos_embed"] = np.random.default_rng(seed).standard_normal((1, c, n, n), dtype=np.float32)
    params = jd2.convert_backbone(sd, jcfg)
    model = tswin.Swin(tcfg.swin)
    load_jax_params(model, params)
    return (sd, params, model,
            lambda p, x, dt: jswin.swin_apply(p, jcfg.swin, x, compute_dtype=dt),
            lambda x, dt: tswin.swin_apply(model, tcfg.swin, x, dt, attention="xla"), (64, 96), tcfg, jcfg)


def family_pair(family: str, seed: int = 0):
    """(D2 dict, rba_tpu's tree, the port's module holding it, rba_tpu's apply(params, x,
    dtype), the port's apply(x, dtype), input (H, W), port config, rba_tpu config)."""
    if family == "swin_ape":
        return _swin_ape_pair(seed)
    name = {"resnet_stride_in_1x1": "resnet"}.get(family, family)
    s11 = family == "resnet_stride_in_1x1"
    tcfg = dataclasses.replace(tconfig.RbAConfig(), backbone_name=name, resnet=tconfig.ResNetConfig(stride_in_1x1=s11))
    jcfg = dataclasses.replace(jconfig.RbAConfig(), backbone_name=name, resnet=jconfig.ResNetConfig(stride_in_1x1=s11))
    hw = (64, 96)
    if name == "resnet":
        model = tresnet.ResNet(tcfg.resnet)
        japply = lambda p, x, dt: jresnet.resnet_apply(p, jcfg.resnet, x, dt)  # noqa: E731
        tapply = lambda x, dt: tresnet.resnet_apply(model, x, dt)  # noqa: E731
    elif name == "mit_b0":
        model = tmit.MiT(tmit.MIT_VARIANTS["mit_b0"])
        japply = lambda p, x, dt: jmit.mit_apply(p, jmit.MIT_VARIANTS["mit_b0"], x, dt)  # noqa: E731
        tapply = lambda x, dt: tmit.mit_apply(model, x, dt)  # noqa: E731
    elif name == "wideresnet38":
        model, hw = twrn.WideResNet(twrn.WideResNetConfig(**WRN_SMALL)), (64, 64)
        japply = lambda p, x, dt: jwrn.wideresnet_apply(p, jwrn.WideResNetConfig(**WRN_SMALL), x, dt)  # noqa: E731
        tapply = lambda x, dt: twrn.wideresnet_apply(model, x, dt)  # noqa: E731
    elif name == "vit":
        model = tvit.ViT(tvit.ViTConfig(**VIT_SMALL))
        japply = lambda p, x, dt: jvit.vit_apply(p, jvit.ViTConfig(**VIT_SMALL), x, dt)  # noqa: E731
        tapply = lambda x, dt: tvit.vit_apply(model, x, dt)  # noqa: E731
    elif name == "vit_sfp":
        tcfg = dataclasses.replace(tcfg, pixel_decoder=dataclasses.replace(tcfg.pixel_decoder, conv_dim=32))
        model = torch.nn.Module()  # ViTSFP's layout around the small ViT
        model.vit, model.sfp = tvit.ViT(tvit.ViTConfig(**VIT_SMALL)), tvit.SimpleFeaturePyramid(64, 32)
        jv = jvit.ViTConfig(**VIT_SMALL)
        japply = lambda p, x, dt: jvit.sfp_apply(p["sfp"], jvit.vit_apply(p["vit"], jv, x, dt)["last_feat"])  # noqa
        tapply = lambda x, dt: tvit.sfp_apply(model.sfp, tvit.vit_apply(model.vit, x, dt)["last_feat"])  # noqa
    elif name == "mvit":
        model, hw = tmvit.MViT(tmvit.MViTConfig(**MVIT_SMALL)), (64, 64)
        japply = lambda p, x, dt: jmvit.mvit_apply(p, jmvit.MViTConfig(**MVIT_SMALL), x, dt)  # noqa: E731
        tapply = lambda x, dt: tmvit.mvit_apply(model, x, dt)  # noqa: E731
    sd = d2_backbone_state_dict(tcfg, seed, model=model)
    params = jd2.convert_backbone(sd, jcfg)
    load_jax_params(model, params)
    return sd, params, model, japply, tapply, hw, tcfg, jcfg


def rba_apply(japply, params, x: np.ndarray, dtype):
    """rba_tpu's apply, jitted; the numbers in the tree (the pyramid's scales) stay
    Python numbers."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    static = [i for i, a in enumerate(leaves) if np.ndim(a) == 0]
    arrays = [jnp.asarray(a) for a in leaves if np.ndim(a) != 0]

    def run(arrays, x):
        it = iter(arrays)
        return japply(jax.tree_util.tree_unflatten(tree, [a if i in static else next(it) for i, a in enumerate(leaves)]),
                      x, dtype)

    return {k: np.asarray(v.astype(jnp.float32)) for k, v in jax.jit(run)(arrays, jnp.asarray(x)).items()}


def _image(hw, seed=1):
    return np.random.default_rng(seed).standard_normal((1, *hw, 3), dtype=np.float32)


def rel_err(got, want) -> float:
    scale = max(1.0, float(np.abs(np.asarray(want, np.float64)).max()))
    return max_abs(got, want) / scale


@pytest.mark.parametrize("family", FAMILIES)
def test_backbone_fp32_equals_rba_tpu(family):
    _, params, model, japply, tapply, hw, _, _ = family_pair(family)
    x = _image(hw)
    want = rba_apply(japply, params, x, jnp.float32)
    with torch.no_grad():
        got = tapply(t(x), torch.float32)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == torch.float32
        assert rel_err(got[k], want[k]) < FP32_RTOL, (k, rel_err(got[k], want[k]))


@pytest.mark.parametrize("family", FAMILIES)
def test_conversion_equals_rba_tpu(family):
    """A seeded Detectron2 dict of the family converts to rba_tpu's tree bit for bit, and
    the port's model holding it gives the same tree back."""
    sd, params, model, *_, tcfg, _ = family_pair(family)
    assert_trees_equal(td2.convert_backbone(sd, tcfg), params)
    assert_trees_equal(model_to_jax_params(model), params)


@pytest.mark.parametrize("in_hw,out_hw,align", [
    ((14, 14), (64, 128), False), ((7, 9), (4, 5), False), ((1, 1), (3, 5), False), ((1, 6), (4, 3), True),
    ((5, 4), (5, 4), False), ((3, 8), (11, 2), True),
])
def test_resize_bicubic_equals_rba_tpu(in_hw, out_hw, align):
    x = np.random.default_rng(0).standard_normal((2, 3, *in_hw), dtype=np.float32)
    want = jresize.resize_bicubic(jnp.asarray(x), out_hw, align_corners=align)
    got = tresize.resize_bicubic(t(x), out_hw, align_corners=align)
    assert max_abs(got, np.asarray(want)) < 1e-6
    nhwc = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    want = jresize.resize_bicubic_nhwc(jnp.asarray(nhwc), out_hw, align_corners=align)
    got = tresize.resize_bicubic_nhwc(t(nhwc), out_hw, align_corners=align)
    assert max_abs(got, np.asarray(want)) < 1e-6
    # the same function as torch's own bicubic, up to its fp32 arithmetic
    if in_hw != out_hw:
        ref = torch.nn.functional.interpolate(t(x), size=out_hw, mode="bicubic", align_corners=align)
        assert max_abs(tresize.resize_bicubic(t(x), out_hw, align_corners=align), ref) < 1e-5


def test_resize_bicubic_keeps_dtype_and_identity():
    x = torch.randn(1, 5, 6, 4, dtype=torch.bfloat16)
    assert tresize.resize_bicubic_nhwc(x, (5, 6)) is x
    y = tresize.resize_bicubic_nhwc(x, (9, 3))
    want = jresize.resize_bicubic_nhwc(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), (9, 3))
    assert y.dtype == torch.bfloat16 and np.array_equal(y.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("table,q,k", [(13, 7, 7), (9, 7, 7), (255, 56, 14), (7, 4, 6), (31, 8, 2)])
def test_rel_pos_resampled_equals_rba_tpu(table, q, k):
    rel = np.random.default_rng(0).standard_normal((table, 8), dtype=np.float32)
    want = jvit._rel_pos_resampled(jnp.asarray(rel), q, k)
    assert np.array_equal(tvit.rel_pos_resampled(t(rel), q, k).numpy(), np.asarray(want))


@pytest.mark.parametrize("k,stride,padding,groups,hw", [
    (3, 2, "SAME", 1, (9, 12)), (3, 2, "SAME", 1, (8, 11)), (1, 2, "SAME", 1, (7, 10)), (7, 4, 3, 1, (17, 21)),
    (3, 1, 1, 16, (6, 7)), (2, 2, "VALID", 1, (8, 10)),
])
def test_conv2d_general_equals_rba_tpu(k, stride, padding, groups, hw):
    """The port's ``ops.nn.conv2d`` against rba_tpu's on strides, XLA's SAME split, groups
    and VALID; and rba_tpu's dilated conv of WiderResNet."""
    from rba_tpu.ops import nn as jnn
    from rba_tpu_torch.ops import nn as tnn

    rs = np.random.default_rng(0)
    x = rs.standard_normal((2, *hw, 16), dtype=np.float32)
    w = rs.standard_normal((k, k, 16 // groups, 24 if groups == 1 else 16), dtype=np.float32) * 0.2
    b = rs.standard_normal(w.shape[-1], dtype=np.float32)
    want = jnn.conv2d({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x), stride=stride,
                      padding=padding, feature_group_count=groups)
    got = tnn.conv2d(t(x), t(w.transpose(3, 2, 0, 1)), t(b), stride=stride, padding=padding, groups=groups)
    assert tuple(got.shape) == want.shape and rel_err(got, np.asarray(want)) < 1e-5
    if k == 3 and groups == 1:
        want = jwrn._dilated_conv({"kernel": jnp.asarray(w)}, jnp.asarray(x), stride, 2)
        got = tnn.conv2d(t(x), t(w.transpose(3, 2, 0, 1)), stride=stride, padding=2, dilation=2, dot_1x1=False)
        assert tuple(got.shape) == want.shape and rel_err(got, np.asarray(want)) < 1e-5
