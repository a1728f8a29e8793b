"""``load_d2_config`` of the port against rba_tpu's: every field the port's config has,
with the value rba_tpu's loader gives it, on the repo's Cityscapes Swin configs and
on a Detectron2 ``_BASE_`` chain written here (the repo's configs repeat their keys
instead of chaining)."""
import dataclasses
from pathlib import Path

import pytest
import torch
import yaml

from rba_tpu import config as jconfig
from rba_tpu_torch import config as tconfig
from tests.torch_port_common import D2_TINY

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
SWIN_CONFIGS = sorted(
    [CONFIGS / "cityscapes" / n for n in ("swin_b_1dl.yaml", "swin_l_1dl.yaml", "swin_b_1dl_ood_coco.yaml")]
    + list((CONFIGS / "cityscapes" / "semantic-segmentation" / "swin" / "single_decoder_layer").glob("*.yaml")))


def _assert_fields_equal(got, want, where=""):
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(g):
            _assert_fields_equal(g, w, f"{where}{f.name}.")
        else:
            assert g == w and type(g) is type(w), (f"{where}{f.name}", g, w)


ALL_CONFIGS = sorted(CONFIGS.rglob("*.yaml"))
TRAINING_SECTIONS = ("input", "ood", "loss", "solver")


@pytest.mark.parametrize("path", ALL_CONFIGS, ids=lambda p: p.relative_to(CONFIGS).as_posix())
def test_training_fields_match_rba_tpu(path):
    """Every config in configs/ loads in the port (a backbone it does not run is refused
    later, by check_supported) with the training fields rba_tpu's loader gives it."""
    got, want = tconfig.load_d2_config(str(path)), jconfig.load_d2_config(str(path))
    for sect in TRAINING_SECTIONS:
        _assert_fields_equal(getattr(got, sect), getattr(want, sect), f"{sect}.")
    for name in ("datasets_train", "datasets_test", "unseen_label_set"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.test.eval_period == want.test.eval_period


@pytest.mark.parametrize("path", SWIN_CONFIGS, ids=lambda p: p.name)
def test_fields_match_rba_tpu(path):
    _assert_fields_equal(tconfig.load_d2_config(str(path)), jconfig.load_d2_config(str(path)))


def _write_chain(tmp_path, backbone):
    """A Detectron2 chain: a child over ``base/Base.yaml`` by a relative ``_BASE_``,
    with the ``!!python/object/apply:eval`` tag the reference's Base configs use."""
    (tmp_path / "base").mkdir()
    (tmp_path / "base" / "Base.yaml").write_text(
        "MODEL:\n  BACKBONE: {NAME: D2SwinTransformer}\n  SWIN: {EMBED_DIM: 96, DEPTHS: [2, 2, 6, 2]}\n"
        "  MASK_FORMER: {DEC_LAYERS: 10, NHEADS: 8}\n"
        "INPUT:\n  MIN_SIZE_TRAIN: !!python/object/apply:eval [\"[int(x * 0.1 * 1024) for x in range(5, 21)]\"]\n")
    child = tmp_path / "child.yaml"
    child.write_text(f"_BASE_: base/Base.yaml\nMODEL:\n  BACKBONE: {{NAME: {backbone}}}\n"
                     "  MASK_FORMER: {DEC_LAYERS: 2z}\n  SEM_SEG_HEAD: {NUM_CLASSES: 11}\n")
    return child


def test_base_chain_eval_tag_and_typo(tmp_path):
    child = _write_chain(tmp_path, "D2SwinTransformer")
    got = tconfig.load_d2_config(str(child))
    _assert_fields_equal(got, jconfig.load_d2_config(str(child)))
    # the child wins, the base fills in, and "2z" reads as 2 (1 live decoder layer)
    assert (got.swin.embed_dim, got.swin.depths, got.num_classes, got.decoder.dec_layers) == (96, (2, 2, 6, 2), 11, 1)
    tconfig.check_supported(got)


def test_tiny_config_and_overrides(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(D2_TINY))
    got = tconfig.load_d2_config(str(path), compute_dtype="float32")
    _assert_fields_equal(got, jconfig.load_d2_config(str(path), compute_dtype="float32"))
    tiny = tconfig.tiny_test_config()
    # the loader also keeps the raw DEC_LAYERS (3) and D2's TRANSFORMER_IN_FEATURE default, as rba_tpu's does
    decoder = dataclasses.replace(tiny.decoder, dec_layers_total=3, transformer_in_feature="res5")
    assert (got.swin, got.decoder, got.num_classes) == (tiny.swin, decoder, tiny.num_classes)


def test_r50_loads_and_is_refused(tmp_path):
    """The name is kept from when the port refused ResNet: a Detectron2 R50 YAML now loads
    to rba_tpu's fields, passes ``check_supported`` and builds."""
    from rba_tpu_torch.models.maskformer import RbAModel

    child = _write_chain(tmp_path, "build_resnet_backbone")
    cfg = tconfig.load_d2_config(str(child))
    _assert_fields_equal(cfg, jconfig.load_d2_config(str(child)))
    assert cfg.backbone_name == "resnet"
    tconfig.check_supported(cfg)
    with torch.device("meta"):
        assert set(RbAModel(cfg).backbone.out_channels) == {"res2", "res3", "res4", "res5"}
