"""The port's Detectron2 checkpoint loader against rba_tpu's on the CPU.

Synthetic Detectron2 state dicts (``tests/d2_synthetic.py``'s ``d2_state_dict``, seeded numpy,
with pre-rename keys) of ``tiny_test_config`` and of full-width ``swin_b_1dl``: the
conversion equals rba_tpu's leaf for leaf, bit for bit; the ``.pth`` and ``.pkl``
readers, the ``params.npz`` cache and the ``d2`` CLI equal rba_tpu's exactly; the
D2-loaded tiny model's RbA score equals rba_tpu's at fp32 within ``SCORE_TOL``.
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rba_tpu import config as jconfig
from rba_tpu.convert import checkpoint as jck
from rba_tpu.convert import d2_mapping as jd2
from rba_tpu.models import maskformer as jmf
from rba_tpu.tools import convert_checkpoint as jcli
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.convert import checkpoint as tck
from rba_tpu_torch.convert import d2_mapping as td2
from rba_tpu_torch.convert import jax_params_to_state, load_jax_params, load_params
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.tools import convert_checkpoint as tcli
from tests.torch_port_common import D2_TINY, assert_trees_equal, d2_state_dict, max_abs, t

# fp32 RbA score of the converted tiny model: rba_tpu's selfcheck bound is 1e-3; the
# port's fp32 forward agrees with rba_tpu's far inside it (tests/test_torch_maskformer.py)
SCORE_TOL = 1e-4


@pytest.fixture(scope="module")
def tiny_sd():
    return d2_state_dict(tconfig.tiny_test_config(), seed=0)


@pytest.mark.parametrize("preset", ["tiny_test_config", "swin_b_1dl"])
def test_convert_equals_rba_tpu_bit_for_bit(preset):
    sd = d2_state_dict(getattr(tconfig, preset)(), seed=1)
    assert "sem_seg_head.predictor.static_query.weight" in sd and "sem_seg_head.mask_features.weight" in sd
    got = td2.convert_d2_state_dict(sd, getattr(tconfig, preset)())
    assert_trees_equal(got, jd2.convert_d2_state_dict(sd, getattr(jconfig, preset)()))


def test_dense_hybrid_head_converts_as_rba_tpu():
    tcfg = tconfig.tiny_test_config()
    tcfg = dataclasses.replace(tcfg, decoder=dataclasses.replace(tcfg.decoder, ood_prediction=True))
    jcfg = jconfig.tiny_test_config()
    jcfg = dataclasses.replace(jcfg, decoder=dataclasses.replace(jcfg.decoder, ood_prediction=True))
    sd = d2_state_dict(tcfg, seed=2)
    got = td2.convert_d2_state_dict(sd, tcfg)
    assert sorted(got["sem_seg_head"]["predictor"]["ood_pred"]["bn"]) == ["bias", "mean", "scale", "var"]
    assert_trees_equal(got, jd2.convert_d2_state_dict(sd, jcfg))
    # and it loads into the port's model with the head
    load_jax_params(tmf.build_model(tcfg, device="cpu"), got)


def test_historical_renames_equal_rba_tpu():
    sd = {k: np.zeros(1) for k in (
        "sem_seg_head.predictor.static_query.weight", "sem_seg_head.adapter_1.weight",
        "sem_seg_head.mask_features.bias", "sem_seg_head.predictor.class_embed.weight",
        "sem_seg_head.pixel_decoder.layer_1.weight", "backbone.norm0.weight")}
    got = td2.apply_historical_renames(sd)
    assert list(got) == list(jd2.apply_historical_renames(sd))
    assert "sem_seg_head.predictor.query_feat.weight" in got
    assert "sem_seg_head.pixel_decoder.adapter_1.weight" in got


def _write(kind, path, sd):
    if kind == "pth":
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "iteration": 89999}, path)
    elif kind == "pth_numpy":  # numpy arrays and metadata in a .pth, as converted D2 files hold
        torch.save({"model": sd, "__author__": "synthetic", "matching_heuristics": True}, path)
    else:
        with open(path, "wb") as f:
            pickle.dump({"model": sd, "__author__": "synthetic"}, f)


@pytest.mark.parametrize("kind", ["pth", "pth_numpy", "pkl"])
def test_readers_round_trip_as_rba_tpu(tmp_path, tiny_sd, kind):
    path = str(tmp_path / ("model_final.pkl" if kind == "pkl" else "model_final.pth"))
    _write(kind, path, tiny_sd)
    got, want = tck.read_state_dict(path), jck.read_state_dict(path)
    assert sorted(got) == sorted(want) == sorted(tiny_sd)
    for k, v in tiny_sd.items():
        assert got[k].dtype == want[k].dtype == v.dtype and np.array_equal(got[k], v) and np.array_equal(want[k], v)


def _zoo(tmp_path, name, sd):
    d = tmp_path / name
    d.mkdir()
    _write("pth", str(d / "model_final.pth"), sd)
    return d


def test_model_final_only_loads_and_caches_as_rba_tpu(tmp_path, tiny_sd):
    port_dir, jax_dir = _zoo(tmp_path, "port", tiny_sd), _zoo(tmp_path, "jax", tiny_sd)
    model = tck.load_checkpoint_params(str(port_dir), tconfig.tiny_test_config(), device="cpu")
    jparams = jck.load_checkpoint_params(str(jax_dir), jconfig.tiny_test_config())
    # the caches hold the same arrays under the same keys
    with np.load(port_dir / "params.npz") as a, np.load(jax_dir / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # every parameter is its D2 array's conversion, bit for bit
    state = jax_params_to_state(jparams)
    for name, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), state[name]), name
    # each package reads the other's cache
    assert_trees_equal(jck.load_params(str(port_dir / "params.npz")), jparams)
    assert_trees_equal(load_params(str(jax_dir / "params.npz")), jparams)
    (port_dir / "model_final.pth").unlink()  # a second load reads the cache alone
    again = tck.load_checkpoint_params(str(port_dir), tconfig.tiny_test_config(), device="cpu")
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name


def test_unwritable_directory_loads_without_cache(tmp_path, tiny_sd, monkeypatch):
    d = _zoo(tmp_path, "ro", tiny_sd)

    def refuse(*a, **k):
        raise PermissionError("read-only")

    monkeypatch.setattr(tck, "save_params", refuse)
    tck.load_checkpoint_params(str(d), tconfig.tiny_test_config(), device="cpu")
    assert not (d / "params.npz").exists()


def test_cache_write_failing_part_way_leaves_no_params_npz(tmp_path, tiny_sd, monkeypatch):
    """A write that fails after some bytes (a full disk) leaves neither ``params.npz``
    nor its temporary file, so no later load takes a truncated cache."""
    import errno

    d = _zoo(tmp_path, "full", tiny_sd)

    def part_way(path, params):
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 part of a zip")
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(tck, "save_params", part_way)
    model = tck.load_checkpoint_params(str(d), tconfig.tiny_test_config(), device="cpu")
    assert sorted(x.name for x in d.iterdir()) == ["model_final.pth"]
    monkeypatch.undo()
    again = tck.load_checkpoint_params(str(d), tconfig.tiny_test_config(), device="cpu")
    assert sorted(x.name for x in d.iterdir()) == ["model_final.pth", "params.npz"]
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name


def test_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tck.load_checkpoint_params(str(tmp_path), tconfig.tiny_test_config(), device="cpu")


def test_d2_loaded_model_scores_as_rba_tpu(tmp_path, tiny_sd):
    d = _zoo(tmp_path, "tiny", tiny_sd)
    model = tck.load_checkpoint_params(str(d), tconfig.tiny_test_config(), device="cpu")
    params = jck.load_checkpoint_params(str(d), jconfig.tiny_test_config())
    img = (np.random.RandomState(3).rand(1, 50, 70, 3) * 255).astype(np.float32)
    # jitted: one compile of the whole forward instead of one per op (the same fp32 function)
    want = jax.jit(lambda p, x: jmf.maskformer_infer_rba(p, jconfig.tiny_test_config(), x))(params, jnp.asarray(img))
    got = tmf.maskformer_infer_rba(model, tconfig.tiny_test_config(), t(img))
    assert got.shape == (1, 50, 70) and bool(torch.isfinite(got).all())
    assert max_abs(got, want) < SCORE_TOL


def test_d2_cli_writes_rba_tpus_npz(tmp_path, tiny_sd, capsys):
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(D2_TINY))
    ckpt = str(tmp_path / "model_final.pth")
    _write("pth", ckpt, tiny_sd)
    common = ["d2", "--config", str(cfg_path), "--checkpoint", ckpt]
    tcli.main(common + ["--out", str(tmp_path / "port.npz")])
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    jcli.main(common + ["--out", str(tmp_path / "jax.npz")])
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_line.replace("port.npz", "X") == jax_line.replace("jax.npz", "X")
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("change", [
    dict(backbone_name="resnet"),
    dict(sem_seg_head_name="PerPixelBaselineHead"),
    dict(pixel_decoder=dataclasses.replace(tconfig.PixelDecoderConfig(), name="BasePixelDecoder")),
    dict(decoder=dataclasses.replace(tconfig.DecoderConfig(), name="StandardTransformerDecoder")),
])
def test_unported_families_raise(tiny_sd, change):
    with pytest.raises(NotImplementedError, match="A.6"):
        td2.convert_d2_state_dict(tiny_sd, dataclasses.replace(tconfig.tiny_test_config(), **change))
