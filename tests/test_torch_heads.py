"""The other heads of the port against rba_tpu on the CPU at the tiny config (fp32), both
converted from one seeded Detectron2 dict (``tests/d2_synthetic.py``), on the same
backbone features:

- ``resize_nearest_nhwc`` bit for bit, at integer and non-integer ratios;
- each head's forward within 1e-5: the FPN pixel decoder (``BasePixelDecoder``) and the
  ``TransformerEncoderPixelDecoder`` (post- and pre-norm), MaskFormer v1's decoder with
  and without its class head and on each ``transformer_in_feature``, the per-pixel heads,
  and the per-pixel and simple decoders; the final outputs and every aux output (the
  per-pixel head on the MSDeformAttn pixel decoder: tests/test_torch_maskformer.py);
- the score map of ``maskformer_infer_rba`` within 1e-5 (Kernel B's plain version on the
  v1 decoder's (logits, masks), the per-pixel heads' ×4 upsampled logits); the per-pixel
  decoder, which has no class head, refused for scoring and training as rba_tpu fails on
  it (ROADMAP.md §C.18);
- the Detectron2 conversion of each head bit for bit with rba_tpu's, where rba_tpu's
  converter reads it (it cannot read the per-pixel and simple decoders: ROADMAP.md §C.18);
- the ``d2`` converter CLI's ``params.npz`` equal to rba_tpu's for the v1 model;
- the Detectron2 YAML keys of the heads read as rba_tpu reads them."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rba_tpu import config as jconfig
from rba_tpu.convert import d2_mapping as jd2
from rba_tpu.models import maskformer as jmf
from rba_tpu.ops import resize as jresize
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.convert import d2_mapping as td2
from rba_tpu_torch.convert import load_jax_params
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.ops import resize as tresize
from rba_tpu_torch.train.train_step import make_train_step
from tests.d2_synthetic import d2_state_dict
from tests.torch_port_common import assert_trees_equal, max_abs, record, t, to_jax

FWD_TOL = 1e-5  # every output, fp32
SCORE_TOL = 1e-5  # the score map, fp32

_V1 = dict(name="StandardTransformerDecoder", dec_layers_total=3)
HEADS = {
    "v1": dict(pixel_decoder=dict(name="BasePixelDecoder"), decoder=dict(_V1, transformer_in_feature="res3")),
    "v1_encoder": dict(pixel_decoder=dict(name="TransformerEncoderPixelDecoder"),
                       decoder=dict(_V1, transformer_in_feature="transformer_encoder", enc_layers=1)),
    "v1_encoder_pre_norm": dict(pixel_decoder=dict(name="TransformerEncoderPixelDecoder"),
                                decoder=dict(_V1, transformer_in_feature="transformer_encoder", enc_layers=1,
                                             pre_norm=True)),
    "v1_pixel_embedding_pre_norm": dict(pixel_decoder=dict(name="BasePixelDecoder"),
                                        decoder=dict(_V1, transformer_in_feature="pixel_embedding", pre_norm=True)),
    "per_pixel": dict(sem_seg_head_name="PerPixelBaselineHead", pixel_decoder=dict(name="BasePixelDecoder")),
    "plus": dict(sem_seg_head_name="PerPixelBaselinePlusHead", pixel_decoder=dict(name="TransformerEncoderPixelDecoder"),
                 decoder=dict(_V1, transformer_in_feature="transformer_encoder", num_queries=7, dec_layers_total=2)),
    "per_pixel_decoder": dict(pixel_decoder=dict(name="BasePixelDecoder"),
                              decoder=dict(name="MultiScalePerPixelDecoder")),
    "simple_decoder": dict(pixel_decoder=dict(name="BasePixelDecoder"), decoder=dict(name="SimpleDecoder")),
}
RBA_TPU_CANNOT_CONVERT = ("per_pixel_decoder", "simple_decoder")


def head_cfg(pkg, name):
    kw = dict(HEADS[name])
    c = pkg.tiny_test_config()
    parts = {k: dataclasses.replace(getattr(c, k), **kw.pop(k, {})) for k in ("pixel_decoder", "decoder")}
    return dataclasses.replace(c, **parts, **kw)


@pytest.mark.parametrize("in_hw,out_hw", [((4, 6), (8, 12)), ((5, 7), (16, 24)), ((9, 13), (17, 25)),
                                          ((8, 12), (5, 7))])
def test_resize_nearest_equals_rba_tpu(in_hw, out_hw):
    x = np.random.RandomState(0).randn(2, *in_hw, 3).astype(np.float32)
    want = np.asarray(jresize.resize_nearest_nhwc(jnp.asarray(x), out_hw))
    got = tresize.resize_nearest_nhwc(torch.from_numpy(x), out_hw).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.fixture(scope="module")
def image():
    return (np.random.RandomState(0).rand(1, 50, 70, 3) * 255).astype(np.float32)


@pytest.fixture
def fixed_backbone(monkeypatch):
    """Both packages' backbones give the same seeded features of the padded 64x96 frame
    (res2 16x24x32, res3 8x12x64): the heads alone are compared, Swin being held in
    tests/test_torch_swin.py (the whole model: tests/test_torch_train_heads.py and the HF
    MaskFormer v1 case of tests/test_torch_hf.py)."""
    import rba_tpu.models.backbones as jbb

    rs = np.random.RandomState(3)
    feats = {"res2": rs.randn(1, 16, 24, 32).astype(np.float32), "res3": rs.randn(1, 8, 12, 64).astype(np.float32)}
    real = jbb.build_backbone

    def build_backbone(cfg):
        init, _, channels = real(cfg)
        return init, lambda p, x, dtype: {k: jnp.asarray(v) for k, v in feats.items()}, channels

    monkeypatch.setattr(jbb, "build_backbone", build_backbone)
    monkeypatch.setattr(tmf, "_backbone_features", lambda *a, **k: {k: t(v) for k, v in feats.items()})


@pytest.mark.parametrize("name", list(HEADS))
def test_head_matches_rba_tpu(name, image, fixed_backbone, request):
    """The conversion, the forward with every aux output, and the score map."""
    jcfg, tcfg = head_cfg(jconfig, name), head_cfg(tconfig, name)
    sd = d2_state_dict(tcfg, 1)
    params = td2.convert_d2_state_dict(sd, tcfg)
    if name in RBA_TPU_CANNOT_CONVERT:
        with pytest.raises(KeyError):
            jd2.convert_d2_state_dict(sd, jcfg)
    else:
        assert_trees_equal(params, jd2.convert_d2_state_dict(sd, jcfg))
    model = load_jax_params(tmf.build_model(tcfg, device="cpu"), params)
    jp = to_jax(params)
    x, xt = jmf.preprocess(jcfg, jnp.asarray(image)), tmf.preprocess(tcfg, t(image))
    with torch.no_grad():
        if tmf.is_per_pixel(tcfg):
            (jl, ja), (tl, ta) = jmf.per_pixel_forward(jp, jcfg, x), tmf.per_pixel_forward(model, tcfg, xt)
            want, got = [{"pred_masks": jl}] + list(ja), [{"pred_masks": tl}] + list(ta)
        else:
            jo, to = jmf.maskformer_forward(jp, jcfg, x), tmf.maskformer_forward(model, tcfg, xt, need_aux=True,
                                                                                 attention="xla")
            want, got = [jo] + jo["aux_outputs"], [to] + to.get("aux_outputs", [])
    assert len(got) == len(want)
    errs = []
    for g, w in zip(got, want):
        keys = sorted(k for k in w if k in ("pred_logits", "pred_masks"))
        assert sorted(k for k in g if k in ("pred_logits", "pred_masks")) == keys
        errs += [max_abs(g[k], w[k]) for k in keys]
    record(request, forward_max_abs=max(errs), outputs=len(got))
    assert max(errs) <= FWD_TOL
    if name == "per_pixel_decoder":  # no class head: neither package scores it (ROADMAP.md §C.18)
        with pytest.raises(ValueError, match="no class head"):
            tmf.maskformer_infer_rba(model, tcfg, t(image))
        with pytest.raises(ValueError, match="no class head"):
            make_train_step(tcfg)
        return
    want = jmf.maskformer_infer_rba(jp, jcfg, jnp.asarray(image))
    got = tmf.maskformer_infer_rba(model, tcfg, t(image))
    record(request, score_max_abs=max_abs(got, want))
    assert got.shape == (1, 50, 70) and max_abs(got, want) <= SCORE_TOL


def test_simple_decoder_trains():
    """One step of ``make_train_step`` on the simple decoder (its forward is held above; the
    criterion and matcher against rba_tpu's in tests/test_torch_criterion.py): finite
    losses of the final layer only (the decoder has no aux outputs), every parameter moved."""
    from rba_tpu_torch.train.train_step import make_train_state

    tcfg = dataclasses.replace(head_cfg(tconfig, "simple_decoder"),
                               loss=dataclasses.replace(tconfig.tiny_test_config().loss, train_num_points=48))
    model = load_jax_params(tmf.build_model(tcfg, device="cpu"), td2.convert_d2_state_dict(d2_state_dict(tcfg, 1),
                                                                                             tcfg))
    rs = np.random.RandomState(0)
    sem = rs.randint(0, 3, (2, 32, 32))
    batch = dict(images=(rs.rand(2, 32, 32, 3) * 255).astype(np.float32), gt_labels=np.tile(np.arange(3), (2, 1)),
                 gt_masks=np.stack([[s == c for c in range(3)] for s in sem]).astype(np.float32),
                 gt_valid=np.ones((2, 3), np.float32), sem_seg=sem)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = make_train_step(tcfg)(make_train_state(tcfg, model=model), batch)
    assert sorted(metrics) == ["grad_norm", "loss_ce", "loss_dice", "loss_mask", "total"]
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(not torch.equal(p, before[n]) for n, p in model.named_parameters())


def test_v1_d2_cli_writes_rba_tpus_npz(tmp_path, capsys):
    """``tools/convert_checkpoint d2`` of both packages on a v1 ``config.yaml`` and
    ``model_final.pth``: the same report and the same ``params.npz``."""
    from rba_tpu.tools import convert_checkpoint as jcli
    from rba_tpu_torch.tools import convert_checkpoint as tcli
    from tests.torch_port_common import D2_TINY

    raw = yaml.safe_load(yaml.safe_dump(D2_TINY))
    raw["MODEL"]["SEM_SEG_HEAD"]["PIXEL_DECODER_NAME"] = "BasePixelDecoder"
    raw["MODEL"]["MASK_FORMER"].update(TRANSFORMER_DECODER_NAME="StandardTransformerDecoder",
                                       TRANSFORMER_IN_FEATURE="res3", ENC_LAYERS=1, PRE_NORM=True)
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    cfg = tconfig.load_d2_config(str(cfg_path))
    sd = d2_state_dict(cfg, 2)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, tmp_path / "model_final.pth")
    common = ["d2", "--config", str(cfg_path), "--checkpoint", str(tmp_path / "model_final.pth")]
    tcli.main(common + ["--out", str(tmp_path / "port.npz")])
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    jcli.main(common + ["--out", str(tmp_path / "jax.npz")])
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_line.replace("port.npz", "X") == jax_line.replace("jax.npz", "X")
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files) and any("dec_layers" in k for k in b.files)
        assert all(np.array_equal(a[k], b[k]) for k in b.files)


@pytest.mark.parametrize("head", [
    dict(SEM_SEG_HEAD=dict(NAME="PerPixelBaselinePlusHead", PIXEL_DECODER_NAME="TransformerEncoderPixelDecoder"),
         MASK_FORMER=dict(TRANSFORMER_DECODER_NAME="StandardTransformerDecoder", TRANSFORMER_IN_FEATURE=
                          "transformer_encoder", PRE_NORM=True, ENC_LAYERS=3, DEC_LAYERS=6, USE_POINT_REND=True)),
    dict(SEM_SEG_HEAD=dict(NAME="PerPixelBaselineHead", PIXEL_DECODER_NAME="BasePixelDecoder"),
         MASK_FORMER=dict(TRANSFORMER_DECODER_NAME="SimpleDecoder", TRANSFORMER_IN_FEATURE="pixel_embedding")),
    dict(SEM_SEG_HEAD=dict(NAME="MaskFormerHead"), MASK_FORMER=dict(TRANSFORMER_DECODER_NAME="MultiScalePerPixelDecoder",
                                                                  ENC_LAYERS="2z")),
])
def test_head_yaml_keys_load_as_rba_tpu(tmp_path, head):
    """``load_d2_config`` and ``load_config`` of a Detectron2 YAML that names the heads:
    every field rba_tpu's ``load_d2_config`` gives, equal."""
    base = tmp_path / "Base.yaml"
    base.write_text(yaml.safe_dump({"MODEL": {"SEM_SEG_HEAD": {"NUM_CLASSES": 19}}}))
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump({"_BASE_": "Base.yaml", "MODEL": head}))
    want = dataclasses.asdict(jconfig.load_d2_config(str(path)))
    for got in (tconfig.load_d2_config(str(path)), tconfig.load_config(str(path))):
        got = dataclasses.asdict(got)
        assert {k: v for k, v in want.items() if k in got} == got
    cfg = tconfig.load_config(str(path))
    assert (cfg.sem_seg_head_name, cfg.pixel_decoder.name, cfg.decoder.name) == (
        head["SEM_SEG_HEAD"].get("NAME"), head["SEM_SEG_HEAD"].get("PIXEL_DECODER_NAME", "MSDeformAttnPixelDecoder"),
        head["MASK_FORMER"]["TRANSFORMER_DECODER_NAME"])
