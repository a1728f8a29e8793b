"""The port's spans (``rba_tpu_torch/utils/profiling.py``): free when no profiler records,
and under a profiler one ``request`` per call of an entry, holding its upload, its layers,
each Kernel A call, each MiT block's attention core, each ViTDet and MViT block's
attention core and MViT's q/k/v pooling, and each deformable-sampling call."""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rba_tpu_torch.config import load_config, tiny_test_config
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.models import mix_transformer as tmit
from rba_tpu_torch.ops import deform_sampling as tds
from rba_tpu_torch.utils import profiling as tprof

HW = (32, 48)


@pytest.fixture(scope="module")
def tiny():
    """The tiny Swin model (mask features at stride 4) on the CPU, and a frame."""
    torch.manual_seed(0)
    cfg = tiny_test_config()
    image = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, *HW, 3)).astype(np.uint8))
    return cfg, tmf.build_model(cfg, device="cpu").eval(), image


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name in tprof.ALL_SPANS]


def _counts(spans):
    counts = {}
    for e in spans:
        counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def _within(inner, outer):
    return outer.time_range.start <= inner.time_range.start and inner.time_range.end <= outer.time_range.end


def test_span_without_a_profiler_never_enters_record_function(tiny, monkeypatch):
    cfg, model, image = tiny

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(tprof, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    out = tmf.maskformer_infer_rba(model, cfg, image)
    assert tuple(out.shape) == (1, *HW) and bool(torch.isfinite(out).all())
    with pytest.raises(AssertionError, match="no profiler"):
        with profile(activities=[ProfilerActivity.CPU]):
            tmf.maskformer_infer_rba(model, cfg, image)


def test_a_request_opens_each_span_of_its_layers_once(tiny):
    cfg, model, image = tiny
    spans = _profiled(lambda: tmf.maskformer_infer_rba(model, cfg, image))
    counts = _counts(spans)
    assert all(counts.get(name) == 1 for name in (tprof.REQUEST, tprof.UPLOAD, *tprof.LAYERS)), counts
    request = next(e for e in spans if e.name == tprof.REQUEST)
    assert all(_within(e, request) for e in spans)
    # the upload is a sibling before preprocess, not inside it
    upload, pre = (next(e for e in spans if e.name == n) for n in (tprof.UPLOAD, "preprocess"))
    assert upload.time_range.end <= pre.time_range.start


def test_kernel_and_sampling_spans_lie_inside_the_request(tiny):
    cfg, model, image = tiny
    spans = _profiled(lambda: tmf.maskformer_infer_rba(model, cfg, image))
    counts = _counts(spans)
    assert counts[tprof.WINDOW_ATTENTION] == sum(cfg.swin.depths)
    assert counts[tds.SPAN] == cfg.pixel_decoder.transformer_enc_layers
    request = next(e for e in spans if e.name == tprof.REQUEST)
    backbone = next(e for e in spans if e.name == "backbone")
    pixel_decoder = next(e for e in spans if e.name == "pixel_decoder")
    for e in spans:
        assert _within(e, request)
        if e.name == tprof.WINDOW_ATTENTION:
            assert _within(e, backbone)
        if e.name == tds.SPAN:
            assert _within(e, pixel_decoder)


def test_maskformer_infer_is_one_request(tiny):
    cfg, model, image = tiny
    counts = _counts(_profiled(lambda: tmf.maskformer_infer(model, cfg, image)))
    assert counts[tprof.REQUEST] == 1 and counts[tprof.UPLOAD] == 1 and counts["rba_tail"] == 1


def test_the_stride_8_fallback_opens_one_request():
    """A model whose mask features lie at stride 8 takes ``maskformer_infer``'s path
    inside ``maskformer_infer_rba``'s one request."""
    torch.manual_seed(1)
    base = tiny_test_config()
    cfg = dataclasses.replace(base, pixel_decoder=dataclasses.replace(base.pixel_decoder, in_features=("res3",)))
    model = tmf.build_model(cfg, device="cpu").eval()
    assert model.mask_stride(cfg) == 8
    image = torch.zeros(1, *HW, 3, dtype=torch.uint8)
    counts = _counts(_profiled(lambda: tmf.maskformer_infer_rba(model, cfg, image)))
    assert counts[tprof.REQUEST] == 1 and counts[tprof.UPLOAD] == 1 and counts["preprocess"] == 1


SHAPES = [(4, 6), (2, 3)]


def _sampling():
    rs = np.random.RandomState(2)
    s, n, m, d, p = sum(h * w for h, w in SHAPES), 1, 2, 4, 2
    value = torch.from_numpy(rs.randn(n, s, m, d).astype(np.float32)).requires_grad_()
    loc = torch.from_numpy(rs.uniform(0, 1, (n, s, m, len(SHAPES), p, 2)).astype(np.float32)).requires_grad_()
    attn = torch.from_numpy(rs.rand(n, s, m, len(SHAPES), p).astype(np.float32)).requires_grad_()
    return tds.ms_deform_attn_core(value * 1, SHAPES, loc * 1, attn * 1), (value, loc, attn)


@pytest.mark.parametrize("profiled", ["forward", "backward"])
def test_sampling_backward_span_is_balanced_when_a_profiler_starts_or_stops(profiled):
    """A profiler over only the forward, or only the backward: the backward closes what
    it opened, and a later profile sees one backward span per backward."""
    if profiled == "forward":
        with profile(activities=[ProfilerActivity.CPU]):
            out, inputs = _sampling()
        out.sum().backward()
    else:
        out, inputs = _sampling()
        spans = _profiled(lambda: out.sum().backward())
        assert _counts(spans) == {tds.BACKWARD_SPAN: 1}
    assert all(x.grad is not None for x in inputs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, _ = _sampling()
        out.sum().backward()
    names = [e.name for e in prof.events()]
    assert names.count(tds.BACKWARD_SPAN) == 1 and names.count(tds.SPAN) == 1


def test_registry_names_the_spans_the_readers_read():
    """The names the benchmark and ``chip_smoke.py`` read are the port's constants."""
    assert tmf.LAYERS == tprof.LAYERS == ("preprocess", "backbone", "pixel_decoder", "transformer_decoder", "rba_tail")
    assert (tds.SPAN, tds.BACKWARD_SPAN) == ("deform_sampling", "deform_sampling_backward")
    assert tprof.TRAIN_STEP == ("forward", "criterion", "backward", "optimizer")
    assert (tprof.REQUEST, tprof.UPLOAD, tprof.WINDOW_ATTENTION) == ("request", "upload", "window_attention")
    assert (tprof.SR_ATTENTION, tprof.REL_POS_ATTENTION, tprof.QKV_POOL) == ("sr_attention", "rel_pos_attention",
                                                                            "qkv_pool")
    assert len(set(tprof.ALL_SPANS)) == len(tprof.ALL_SPANS)


def test_every_span_a_benchmark_reader_reads_is_a_span_of_the_port():
    folder = Path(__file__).resolve().parents[1] / "benchmark" / "layer_metrics"
    read = set()
    for path in folder.glob("*.py"):
        read.update(re.findall(r'^SPAN = "([^"]+)"', path.read_text(), re.M))
    assert {tprof.SR_ATTENTION, tprof.REL_POS_ATTENTION, tprof.QKV_POOL, "backbone"} <= read
    assert read <= set(tprof.ALL_SPANS)


MIT_HW = (64, 96)
MIT_YAML = Path(__file__).resolve().parents[1] / "configs/cityscapes/semantic-segmentation/mix_transformer" / \
    "maskformer_2_mit_b5_in21k_1dl.yaml"


@pytest.fixture(scope="module")
def tiny_mit():
    """RbA's MiT 1dl configuration with MiT-B0 in place of MiT-B5, on the CPU, and a frame."""
    torch.manual_seed(2)
    cfg = dataclasses.replace(load_config(str(MIT_YAML)), backbone_name="mit_b0")
    image = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (1, *MIT_HW, 3)).astype(np.uint8))
    return cfg, tmf.build_model(cfg, device="cpu").eval(), image


def test_mit_request_opens_one_sr_attention_span_per_block(tiny_mit):
    cfg, model, image = tiny_mit
    spans = _profiled(lambda: tmf.maskformer_infer_rba(model, cfg, image))
    counts = _counts(spans)
    assert counts[tprof.SR_ATTENTION] == sum(tmit.MIT_VARIANTS["mit_b0"].depths) == 8
    assert counts[tprof.REQUEST] == counts["backbone"] == 1 and tprof.WINDOW_ATTENTION not in counts
    backbone = next(e for e in spans if e.name == "backbone")
    assert all(_within(e, backbone) for e in spans if e.name == tprof.SR_ATTENTION)


def test_swin_request_opens_no_sr_attention_span(tiny):
    cfg, model, image = tiny
    assert tprof.SR_ATTENTION not in _counts(_profiled(lambda: tmf.maskformer_infer_rba(model, cfg, image)))


def test_mit_span_without_a_profiler_never_enters_record_function(tiny_mit, monkeypatch):
    cfg, model, image = tiny_mit

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(tprof, "record_function", refuse)
    out = tmf.maskformer_infer_rba(model, cfg, image)
    assert tuple(out.shape) == (1, *MIT_HW) and bool(torch.isfinite(out).all())


def test_mit_score_map_is_the_same_under_a_profiler(tiny_mit):
    cfg, model, image = tiny_mit
    plain = tmf.maskformer_infer_rba(model, cfg, image)
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = tmf.maskformer_infer_rba(model, cfg, image)
    assert torch.equal(plain, profiled)


MVIT_HW = (64, 128)
SEMSEG = Path(__file__).resolve().parents[1] / "configs/cityscapes/semantic-segmentation"


def _fp32_model(rel: str, seed: int):
    """The configuration ``rel`` under ``SEMSEG`` at full width and fp32 on the CPU."""
    torch.manual_seed(seed)
    cfg = dataclasses.replace(load_config(str(SEMSEG / rel)), compute_dtype="float32")
    return cfg, tmf.build_model(cfg, device="cpu").eval()


def _frames(batch: int, seed: int = 3):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, 256, (batch, *MVIT_HW, 3)).astype(np.uint8))


@pytest.fixture(scope="module")
def mvit():
    """RbA's MViTv2-B 1dl model at full width, fp32, on the CPU."""
    return _fp32_model("mvit/maskformer_2_mvit_in21k_bs16_90k_1dl.yaml", 3)


@pytest.mark.parametrize("batch", [1, 2])
def test_mvit_request_opens_one_rel_pos_and_one_pool_span_per_block(mvit, batch):
    cfg, model = mvit
    spans = _profiled(lambda: tmf.maskformer_infer_rba(model, cfg, _frames(batch)))
    counts = _counts(spans)
    assert counts[tprof.REL_POS_ATTENTION] == counts[tprof.QKV_POOL] == len(model.backbone.blocks) == 24
    assert counts[tprof.REQUEST] == counts["backbone"] == 1
    assert tprof.SR_ATTENTION not in counts and tprof.WINDOW_ATTENTION not in counts
    backbone = next(e for e in spans if e.name == "backbone")
    assert all(_within(e, backbone) for e in spans if e.name in (tprof.REL_POS_ATTENTION, tprof.QKV_POOL))
    # the pooling precedes its block's attention core and is not inside it
    pools = sorted((e for e in spans if e.name == tprof.QKV_POOL), key=lambda e: e.time_range.start)
    cores = sorted((e for e in spans if e.name == tprof.REL_POS_ATTENTION), key=lambda e: e.time_range.start)
    assert all(p.time_range.end <= c.time_range.start for p, c in zip(pools, cores))


def test_vitdet_request_opens_one_rel_pos_span_per_block():
    cfg, model = _fp32_model("vit/maskformer_2_vit_imagenet_bs16_90k.yaml", 4)
    spans = _profiled(lambda: tmf.maskformer_infer_rba(model, cfg, _frames(1)))
    counts = _counts(spans)
    assert counts[tprof.REL_POS_ATTENTION] == len(model.backbone.blocks) == 12
    assert tprof.QKV_POOL not in counts
    backbone = next(e for e in spans if e.name == "backbone")
    assert all(_within(e, backbone) for e in spans if e.name == tprof.REL_POS_ATTENTION)


@pytest.mark.parametrize("family", ["swin", "mit", "resnet"])
def test_other_backbones_open_no_rel_pos_or_pool_span(tiny, tiny_mit, family):
    if family == "mit":
        cfg, model, image = tiny_mit
    else:
        cfg, model, image = tiny
        if family == "resnet":
            torch.manual_seed(5)
            cfg = dataclasses.replace(cfg, backbone_name="resnet")
            model = tmf.build_model(cfg, device="cpu").eval()
    counts = _counts(_profiled(lambda: tmf.maskformer_infer_rba(model, cfg, image)))
    assert counts[tprof.REQUEST] == counts["backbone"] == 1
    assert tprof.REL_POS_ATTENTION not in counts and tprof.QKV_POOL not in counts


def test_mvit_spans_without_a_profiler_never_enter_record_function(mvit, monkeypatch):
    cfg, model = mvit

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(tprof, "record_function", refuse)
    out = tmf.maskformer_infer_rba(model, cfg, _frames(1))
    assert tuple(out.shape) == (1, *MVIT_HW) and bool(torch.isfinite(out).all())


def test_mvit_score_map_is_the_same_under_a_profiler(mvit):
    cfg, model = mvit
    plain = tmf.maskformer_infer_rba(model, cfg, _frames(2))
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = tmf.maskformer_infer_rba(model, cfg, _frames(2))
    assert torch.equal(plain, profiled)
