"""``kernels.plain_versions()``, the one switch between the hand kernels and their plain
versions, on the CPU.

Each kernel's module decides with its ``takes`` whether a call runs the kernel.  Here
each rule is made to answer as it would on the card (it is handed a CUDA device in
place of the CPU tensors' own), so that only the switch keeps the calls on the plain
versions: under it every rule consulted along a path answers no, no launcher runs, and
each rule answers yes to the same call outside it.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from rba_tpu_torch.config import tiny_test_config
from rba_tpu_torch.evalx.seg_evaluators import OpenPanopticEvaluator
from rba_tpu_torch.kernels import _build, plain_versions
from rba_tpu_torch.kernels import fused_mlp, fused_rba, lsap, masked_softmax, ms_deform_attn, rel_pos_attention
from rba_tpu_torch.kernels import sr_attention
from rba_tpu_torch.kernels import window_attention
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.ops.point_sample import uniform_from
from rba_tpu_torch.train import matcher as tm

CUDA = torch.device("cuda")
ON_CARD = types.SimpleNamespace(device=CUDA)  # what a rule of A–E reads of its tensor
TENSOR_RULES = {"A": window_attention, "B": fused_rba, "C": masked_softmax, "D": fused_mlp, "E": lsap}
DEVICE_RULES = {"F": ms_deform_attn, "G": sr_attention, "H": rel_pos_attention}  # rules handed the device first


def _answers():
    """Each rule's answer for a call it takes on the card."""
    out = {k: mod.takes(ON_CARD) for k, mod in TENSOR_RULES.items()}
    out["F"] = ms_deform_attn.takes(CUDA, False, ("gather",), "float32", (1, 16, 1, 32), (1, 16, 1, 1, 4, 2))
    out["G"] = sr_attention.takes(CUDA, torch.bfloat16, False, 64)
    out["H"] = rel_pos_attention.takes(CUDA, torch.bfloat16, False, 96)
    return out


def test_switch_nests_and_restores():
    yes, no = dict.fromkeys("ABCDEFGH", True), dict.fromkeys("ABCDEFGH", False)
    assert _answers() == yes
    with plain_versions():
        assert _answers() == no
        with plain_versions():
            assert _answers() == no
        assert _answers() == no
    assert _answers() == yes
    with pytest.raises(KeyError), plain_versions():
        raise KeyError("raised inside the switch")
    assert _answers() == yes


def _on_card(monkeypatch):
    """Patch every rule to judge its call as on the card; returns the calls and answers."""
    seen = []

    def judged(name, real, card_args):
        def takes(*args):
            answer = real(*card_args(args))
            seen.append((name, takes, args, answer))
            return answer
        return takes

    for name, mod in TENSOR_RULES.items():
        monkeypatch.setattr(mod, "takes", judged(name, mod.takes, lambda args: (ON_CARD,)))
    for name, mod in DEVICE_RULES.items():
        monkeypatch.setattr(mod, "takes", judged(name, mod.takes, lambda args: (CUDA, *args[1:])))
    monkeypatch.setattr(_build.Launcher, "__call__", lambda *args: pytest.fail("a kernel launched"))
    return seen


def _check_only_the_switch_said_no(seen, want):
    assert {name for name, *_ in seen} == set(want)
    assert not any(answer for *_, answer in seen)
    assert all(takes(*args) for _, takes, args, _ in list(seen))  # outside the switch: the kernel


def _image(hw=(32, 48), seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, 256, (1, *hw, 3)).astype(np.uint8))


def _config(case):
    cfg = tiny_test_config()
    if case == "swin_fused_softmax":  # C wide enough for Kernel D (a multiple of 128)
        return dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, embed_dim=128, num_heads=(8, 16),
                                                                 mlp_impl="fused"))
    if case == "mit_b0":  # Kernel G takes bf16 alone
        return dataclasses.replace(cfg, backbone_name="mit_b0", compute_dtype="bfloat16")
    return cfg


@pytest.mark.parametrize("case,attention,want", [
    ("swin_fused", "fused", "ABF"),
    ("swin_fused_softmax", "fused_softmax", "BCDF"),
    ("mit_b0", "fused", "BFG"),
])
def test_switch_reaches_every_route_of_a_request(case, attention, want, monkeypatch):
    cfg = _config(case)
    torch.manual_seed(0)
    model = tmf.build_model(cfg, device="cpu").eval()
    seen = _on_card(monkeypatch)
    with plain_versions():
        rba = tmf.maskformer_infer_rba(model, cfg, _image(), attention=attention)
    assert rba.shape == (1, 32, 48)
    _check_only_the_switch_said_no(seen, want)


@pytest.mark.parametrize("path", ["open_panoptic", "matcher"])
def test_switch_reaches_the_evaluator_and_the_matcher(path, monkeypatch):
    """``OpenPanopticEvaluator.raw_outputs`` and ``rba_map`` (Kernels A, F and B) and the
    matcher's assignment (Kernel E), which take no argument for the choice."""
    cfg = tiny_test_config()
    torch.manual_seed(0)
    model = tmf.build_model(cfg, device="cpu").eval()
    seen = _on_card(monkeypatch)
    with plain_versions():
        if path == "open_panoptic":
            ev = OpenPanopticEvaluator(cfg, model, open_panoptic=True)
            image = _image()[0].numpy()
            mask_cls, low, mask_pred = ev.raw_outputs(image)
            assert ev.rba_map(mask_cls, low, image.shape[:2], mask_pred).shape == (32, 48)
        else:
            q, t = cfg.decoder.num_queries, 3
            gen = torch.Generator().manual_seed(0)
            got = tm.hungarian_match(uniform_from(gen), cfg.loss, torch.randn(2, q, cfg.num_classes + 1),
                                     torch.randn(2, q, 8, 12), torch.randint(0, cfg.num_classes, (2, t)),
                                     (torch.rand(2, t, 32, 48) > 0.5).float(), torch.ones(2, t))
            assert got.shape == (2, t)
    _check_only_the_switch_said_no(seen, "ABF" if path == "open_panoptic" else "E")
