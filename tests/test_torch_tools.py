"""The port's tools and utilities on the CPU, against rba_tpu's where it has them:

- ``tools/selfcheck.py``: the tiny parity self-check (an independent torch model from
  tests/torch_refs.py written as a Detectron2 checkpoint, loaded through the port's
  production path) within 1e-3, and its metrics mode through the port's sweep CLI;
- ``tools/analyze_model.py``: the parameter counts per path prefix and the structure
  lines equal to rba_tpu's; the dot and conv FLOPs of ``maskformer_infer_rba`` at
  ``attention="xla"`` equal to rba_tpu's ``flop_table`` once three lowerings are
  accounted for, each counted here: rba_tpu embeds Swin's patches with a dot and the
  port with a conv; rba_tpu upsamples the FPN's coarser level 2x with two depthwise
  convs and the port with ``F.interpolate`` (no dot or conv); rba_tpu's deformable
  sampling weights its gathered corners with a dot, and its "auto" form takes one-hot
  matmuls at the tiny sizes, where the port's fp32 sampling gathers and sums (no dot).
  The backbone's activations equal;
- ``tools/boundary_ap.py``, ``tools/prepare_coco_semseg.py`` and the numpy parts of
  ``tools/vis_utils.py`` (kmeans, PCA) equal to rba_tpu's, and ``extract_query_embeddings``
  reads the port's model;
- ``utils/debug.checked`` raises at the first NaN inside a model call, naming the op and
  the line; ``utils/profiling``'s trace, timer and checksum."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rba_tpu.models import maskformer as jmf
from rba_tpu.models import swin as jswin
from rba_tpu.ops import deform_sampling as jds
from rba_tpu.ops import resize as jres
from rba_tpu.tools import analyze_model as jam
from rba_tpu.tools import boundary_ap as jbap
from rba_tpu.tools import prepare_coco_semseg as jprep
from rba_tpu.tools import vis_utils as jvis
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.convert.params import model_to_jax_params
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.models import swin as tswin
from rba_tpu_torch.tools import analyze_model as tam
from rba_tpu_torch.tools import boundary_ap as tbap
from rba_tpu_torch.tools import prepare_coco_semseg as tprep
from rba_tpu_torch.tools import selfcheck as tsc
from rba_tpu_torch.tools import vis_utils as tvis
from rba_tpu_torch.utils import debug as tdebug
from rba_tpu_torch.utils import profiling as tprof
from tests.torch_port_common import d2_model_pair, jax_config, t

HW = (64, 96)


@pytest.fixture(scope="module")
def pair():
    tcfg = tconfig.tiny_test_config()
    jcfg = jax_config(tcfg)
    params, model = d2_model_pair(jcfg, tcfg, seed=6)
    return jcfg, tcfg, params, model


def test_selfcheck_tiny(tmp_path):
    r = tsc.run_selfcheck(str(tmp_path), "tiny", n_images=2, hw=HW, device="cpu")
    assert r["pass"] and r["max_score_delta"] <= 1e-3 and r["device"] == "cpu"


def test_selfcheck_metrics_mode_runs_the_port_sweep(tmp_path):
    r = tsc.run_metrics_check(str(tmp_path), "tiny", n_images=2, hw=HW, device="cpu")
    assert r["pass"] and set(r["rows"]) == set(r["datasets"])


def test_parameter_counts_and_structure_equal_rba_tpu(pair):
    _, _, params, model = pair
    assert tam.parameter_count(model) == jam.parameter_count(params)
    got = tam.structure_string(model_to_jax_params(model)).splitlines()
    want = jam.structure_string(params).splitlines()
    assert sorted(got) == sorted(want)  # the port's tree lists its keys in another order


def _patch_embed_flops(cfg, hw):
    p, c = cfg.swin.patch_size, cfg.swin.embed_dim
    return 2.0 * 3 * p * p * c * (hw[0] // p) * (hw[1] // p)


def test_backbone_flops_and_activations_equal_rba_tpu(pair):
    jcfg, tcfg, params, model = pair
    x = np.zeros((1, *HW, 3), np.float32)
    want = jam.flop_table(lambda p, x: jswin.swin_apply(p, jcfg.swin, x, compute_dtype=jnp.float32),
                          params["backbone"], jnp.asarray(x))
    call = lambda x: tswin.swin_apply(model.backbone, tcfg.swin, x, torch.float32, attention="xla")  # noqa: E731
    got = tam.flop_table(call, t(x))
    patch = _patch_embed_flops(tcfg, HW)
    assert "conv" not in want and got["conv"] == patch  # the patch embedding: a dot there, a conv here
    assert got["dot_general"] + got["conv"] == want["dot_general"]
    assert tam.activation_count(call, t(x)) == jam.activation_count(
        lambda p, x: jswin.swin_apply(p, jcfg.swin, x, compute_dtype=jnp.float32), params["backbone"], jnp.asarray(x))


def _sampling_dots(jcfg, hw, method):
    """rba_tpu's dot FLOPs of one encoder layer's deformable sampling (one level, res3)."""
    pd = jcfg.pixel_decoder
    lq, m, p = (hw[0] // 8) * (hw[1] // 8), pd.transformer_nheads, pd.enc_n_points
    args = (jnp.zeros((1, lq, m, pd.conv_dim // m)), jnp.full((1, lq, m, 1, p, 2), 0.5), jnp.zeros((1, lq, m, 1, p)))
    return jam.flop_table(lambda v, loc, a: jds.ms_deform_attn_core(v, [(hw[0] // 8, hw[1] // 8)], loc, a,
                                                                    method=method), *args)["dot_general"]


def test_model_flops_equal_rba_tpu_op_by_op(pair):
    jcfg, tcfg, params, model = pair
    x = np.zeros((1, *HW, 3), np.float32)
    gather = dataclasses.replace(jcfg, pixel_decoder=dataclasses.replace(jcfg.pixel_decoder, sampling_method="gather"))
    want = jam.flop_table(lambda p, x: jmf.maskformer_infer_rba(p, gather, x), params, jnp.asarray(x))
    auto = jam.flop_table(lambda p, x: jmf.maskformer_infer_rba(p, jcfg, x), params, jnp.asarray(x))
    got = tam.flop_table(lambda x: tmf.maskformer_infer_rba(model, tcfg, x, attention="xla"), t(x))
    patch = _patch_embed_flops(tcfg, HW)
    coarse = (HW[0] // 8, HW[1] // 8)  # the FPN's res3 level, upsampled onto res2
    upsample = jam.flop_table(jres.upsample2x_bilinear_nhwc,
                              jnp.zeros((1, *coarse, tcfg.pixel_decoder.conv_dim)))["conv"]
    layers = tcfg.pixel_decoder.transformer_enc_layers
    weighting = layers * _sampling_dots(jcfg, HW, "gather")  # rba_tpu's gather weights its corners with a dot
    onehot = layers * _sampling_dots(jcfg, HW, "auto")  # and "auto" samples with one-hot matmuls here
    assert got["dot_general"] + patch == want["dot_general"] - weighting
    assert got["conv"] - patch == want["conv"] - upsample
    assert auto["conv"] == want["conv"] and auto["dot_general"] - onehot == want["dot_general"] - weighting


def test_boundary_ap_equals_rba_tpu(rng):
    masks = (rng.rand(3, 40, 56) > 0.6).astype(np.float32)
    masks[:, 10:30, 12:40] = 1
    for a, b in [(0, 1), (1, 2), (0, 0)]:
        assert tbap.boundary_iou(masks[a], masks[b]) == jbap.boundary_iou(masks[a], masks[b])
        assert np.array_equal(tbap.mask_to_boundary(masks[a]), jbap.mask_to_boundary(masks[a]))
    preds = [{"pred_masks": masks[:2], "scores": np.array([0.9, 0.4]), "pred_classes": np.array([0, 1])}]
    gts = [{"masks": masks[1:], "classes": np.array([0, 1])}]
    assert tbap.boundary_mask_average_precision(preds, gts, 2) == jbap.boundary_mask_average_precision(preds, gts, 2)


def test_prepare_coco_semseg_equals_rba_tpu(tmp_path, rng):
    ids = rng.randint(0, 3, (24, 32))
    segs = {0: 0, 1: 1 + 256 * 2, 2: 7}  # segment ids in the RGB encoding id = R + 256 G + 256² B
    seg_ids = np.vectorize(segs.get)(ids)
    rgb = np.stack([seg_ids % 256, seg_ids // 256 % 256, seg_ids // 65536], -1).astype(np.uint8)
    (tmp_path / "pan").mkdir()
    Image.fromarray(rgb).save(tmp_path / "pan" / "a.png")
    meta = {"categories": [{"id": 5}, {"id": 9}], "annotations": [
        {"file_name": "a.png", "segments_info": [{"id": segs[1], "category_id": 9}, {"id": segs[2], "category_id": 5}]}]}
    (tmp_path / "pan.json").write_text(json.dumps(meta))
    for mod, out in ((jprep, "want"), (tprep, "got")):
        mod.main(["--panoptic-json", str(tmp_path / "pan.json"), "--panoptic-root", str(tmp_path / "pan"),
                  "--out-dir", str(tmp_path / out)])
    got = np.asarray(Image.open(tmp_path / "got" / "a.png"))
    assert np.array_equal(got, np.asarray(Image.open(tmp_path / "want" / "a.png")))
    assert set(np.unique(got)) == {255, 1, 0}


def test_kmeans_and_pca_equal_rba_tpu(pair, rng):
    _, _, params, model = pair
    x = rng.randn(60, 8).astype(np.float32)
    for got, want in zip(tvis.kmeans_numpy(x, 4), jvis.kmeans_numpy(x, 4)):
        assert np.array_equal(got, want)
    assert np.array_equal(tvis.pca_explained_variance(x), jvis.pca_explained_variance(x))
    assert np.array_equal(tvis.project_2d(x, "pca"), jvis.project_2d(x, "pca"))
    var = tvis.pca_explained_variance(x)
    assert tvis.find_pca_n_components_for_variance_threshold(var, 0.8) == \
        jvis.find_pca_n_components_for_variance_threshold(var, 0.8)
    got, want = tvis.extract_query_embeddings(model), jvis.extract_query_embeddings(params)
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got)


def test_checked_raises_at_the_first_nan(pair):
    _, tcfg, _, model = pair
    img = torch.full((1, 32, 48, 3), 100.0)
    infer = tdebug.checked(lambda x: tmf.maskformer_infer_rba(model, tcfg, x, attention="xla"))
    assert infer(img).shape == (1, 32, 48)
    bias = model.sem_seg_head["predictor"].class_embed.bias
    saved = bias.detach().clone()
    with torch.no_grad():
        bias[0] = float("nan")
    try:
        with pytest.raises(FloatingPointError, match=r"NaN produced by aten\.\w+ .* at .*rba_tpu_torch"):
            infer(img)
    finally:
        with torch.no_grad():
            bias.copy_(saved)
    with pytest.raises(FloatingPointError, match="has NaN/Inf"):
        tdebug.assert_finite(torch.tensor([1.0, float("inf")]), "x")


def test_profiling_utilities(tmp_path, capsys):
    with tprof.device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").exists()
    tdebug.print_stats(torch.arange(4.0), "x")
    assert capsys.readouterr().out.startswith("x: (Min, Max, Mean, STD) 0.0 3.0 1.5 1.118")
