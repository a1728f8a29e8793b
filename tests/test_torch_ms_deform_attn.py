"""Kernel F's dispatch and its wrapper's argument checks, on the CPU.

``kernels/ms_deform_attn.py`` ``takes`` decides from what a call can observe whether
``ops/deform_sampling.py`` ``ms_deform_attn_core`` runs Kernel F or the plain version;
the wrapper checks its arguments before it looks at the device, so CPU
tensors reach every check without a launch.  The kernel itself is held against the
plain gather on the card (tests/test_torch_kernels_cuda.py).
"""
import contextlib

import numpy as np
import pytest
import torch

from rba_tpu_torch.kernels import ms_deform_attn as kmd
from rba_tpu_torch.kernels import plain_versions
from rba_tpu_torch.ops import deform_sampling as tds

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
SHAPES = [(6, 8), (3, 4)]


R50_VALUE, R50_LOC = (1, 43008, 8, 32), (1, 43008, 8, 3, 4, 2)  # one encoder layer of a 1024x2048 frame


@pytest.mark.parametrize("device,needs_grad,methods,sampling_dtype,want", [
    (CUDA, False, ("gather", "gather", "gather"), "float32", True),
    (CUDA, False, ("onehot", "gather", "gather"), "float32", True),  # fp32 one-hot levels run the gather
    (CUDA, False, ("gather", "gather", "gather"), "bfloat16", True),  # every level above the one-hot cap
    (CUDA, False, ("gather", "gather", "onehot"), "bfloat16", False),  # fast_serving's bf16 one-hot level
    (CUDA, True, ("gather", "gather", "gather"), "float32", False),  # training: the gradient is the plain path's
    (CPU, False, ("gather", "gather", "gather"), "float32", False),
], ids=["cuda_gather", "cuda_fp32_onehot", "cuda_bf16_all_gather", "bf16_onehot", "grad", "cpu"])
def test_takes_kernel(device, needs_grad, methods, sampling_dtype, want):
    assert kmd.takes(device, needs_grad, methods, sampling_dtype, R50_VALUE, R50_LOC) is want


@pytest.mark.parametrize("value_shape,loc_shape,want", [
    ((2, 60, 4, 16), (2, 60, 4, 2, 3, 2), True),  # the tiny test config's D = 16
    ((1, 2048, 8, 32), (1, 2048, 8, 1, 4, 2), True),  # Swin-B's one level
    ((1, 2048, 8, 24), (1, 2048, 8, 1, 4, 2), False),  # conv_dim 192 over 8 heads
    ((1, 2048, 4, 64), (1, 2048, 4, 1, 4, 2), False),  # conv_dim 256 over 4 heads
    ((1, 2048, 8, 8), (1, 2048, 8, 1, 4, 2), False),
    ((1, 2560, 8, 32), (1, 2560, 8, 5, 4, 2), False),  # five levels
], ids=["d16", "d32", "d24", "d64", "d8", "five_levels"])
def test_takes_kernel_only_for_the_shapes_it_is_built_for(value_shape, loc_shape, want):
    """A CUDA, no-grad, all-gather call of a shape the kernel is not built for stays on
    the plain path, by rule; the wrapper's raise is left for real misuse."""
    methods = ("gather",) * loc_shape[3]
    assert kmd.takes(CUDA, False, methods, "float32", value_shape, loc_shape) is want
    assert kmd.supports(value_shape, loc_shape) is want


def _inputs(n=2, m=2, d=32, p=3, shapes=SHAPES, lq=5, seed=0):
    rs = np.random.default_rng(seed)
    s, nl = sum(h * w for h, w in shapes), len(shapes)
    value = torch.tensor(rs.standard_normal((n, s, m, d)), dtype=torch.float32)
    loc = torch.tensor(rs.uniform(-0.1, 1.1, (n, lq, m, nl, p, 2)), dtype=torch.float32)
    attn = torch.softmax(torch.tensor(rs.standard_normal((n, lq, m, nl * p)), dtype=torch.float32), -1)
    return value, loc, attn.reshape(n, lq, m, nl, p)


def _bad_dtype():
    value, loc, attn = _inputs()
    return value.double(), SHAPES, loc, attn


def _bad_shape():
    value, loc, attn = _inputs()
    return value, SHAPES, loc, attn[:, :, :, :, :2]


def _shapes_off():
    value, loc, attn = _inputs()
    return value, [(6, 8), (3, 5)], loc, attn  # 63 pixels for S = 60


def _too_many_levels():
    value, loc, attn = _inputs(shapes=[(2, 2)] * 5)
    return value, [(2, 2)] * 5, loc, attn


def _non_contiguous():
    value, loc, attn = _inputs()
    return value, SHAPES, loc.transpose(1, 2).contiguous().transpose(1, 2), attn


def _misaligned():
    value, loc, attn = _inputs()
    shifted = torch.empty(value.numel() + 1)[1:].view(value.shape)  # starts 4 bytes past the allocation
    shifted.copy_(value)
    return shifted, SHAPES, loc, attn


def _head_dim_48():
    value, loc, attn = _inputs(d=48)
    return value, SHAPES, loc, attn


def _cpu():
    value, loc, attn = _inputs()
    return value, SHAPES, loc, attn


@pytest.mark.parametrize("make,error,match", [
    (_bad_dtype, TypeError, "float32"),
    (_bad_shape, ValueError, "do not match"),
    (_shapes_off, ValueError, "do not tile"),
    (_too_many_levels, ValueError, "1 to 4 levels"),
    (_non_contiguous, ValueError, "contiguous"),
    (_misaligned, ValueError, "16-byte"),
    (_head_dim_48, ValueError, "D in"),
    (_cpu, ValueError, "cuda device"),
], ids=["dtype", "shape", "spatial_shapes", "levels", "contiguity", "alignment", "head_dim", "cpu"])
def test_wrapper_checks_raise_without_a_launch(make, error, match):
    before = kmd.ms_deform_attn.launches
    with pytest.raises(error, match=match):
        kmd.ms_deform_attn(*make())
    assert kmd.ms_deform_attn.launches == before


def test_core_hands_the_kernel_fp32_contiguous_aligned_inputs(monkeypatch):
    """Where ``takes`` says so, ``ms_deform_attn_core`` returns the wrapper's output,
    called once with fp32 contiguous tensors, the value on 16 bytes and the locations on 8
    (a view that starts elsewhere is copied), and the shapes."""
    value, loc, attn = _inputs()
    want = tds.ms_deform_attn_core(value, SHAPES, loc, attn)
    calls = []

    def fake(v, shapes, l, a):
        calls.append((v, shapes, l, a))
        return want.clone()

    monkeypatch.setattr(kmd, "takes", lambda *args: True)
    monkeypatch.setattr(kmd, "ms_deform_attn", fake)
    got = tds.ms_deform_attn_core(value.bfloat16(), SHAPES, loc.transpose(1, 2).contiguous().transpose(1, 2), attn)
    shifted_value, _, shifted_loc, _ = _misaligned()
    shifted_loc = torch.empty(loc.numel() + 1)[1:].view(loc.shape).copy_(loc)  # 4 bytes past the allocation
    tds.ms_deform_attn_core(shifted_value, SHAPES, shifted_loc, attn)
    assert len(calls) == 2 and torch.equal(got, want)
    v, shapes, l, a = calls[0]
    assert shapes == SHAPES and all(x.dtype == torch.float32 and x.is_contiguous() for x in (v, l, a))
    assert torch.equal(l, loc) and torch.equal(v, value.bfloat16().float())
    v, _, l, _ = calls[1]
    assert v.data_ptr() % 16 == 0 and l.data_ptr() % 8 == 0
    assert torch.equal(v, value) and torch.equal(l, loc)


def _rule_sees_a_card(monkeypatch):
    """``takes`` as it answers for these tensors on the card."""
    real = kmd.takes
    monkeypatch.setattr(kmd, "takes", lambda device, *args: real(CUDA, *args))


def test_core_plain_never_takes_the_kernel(monkeypatch):
    """``plain_versions()`` keeps the call on the plain version where the rule would take
    the kernel, and gives its output."""
    value, loc, attn = _inputs()
    _rule_sees_a_card(monkeypatch)
    assert kmd.takes(CPU, False, ("gather",) * len(SHAPES), "float32", value.shape, loc.shape)
    monkeypatch.setattr(kmd, "ms_deform_attn", lambda *args: pytest.fail("the kernel ran under plain_versions()"))
    with plain_versions():
        got = tds.ms_deform_attn_core(value, SHAPES, loc, attn)
    assert torch.equal(got, tds.ms_deform_attn_plain(value, SHAPES, loc, attn))


@pytest.mark.parametrize("plain", [False, True], ids=["kernels", "plain"])
def test_entry_plain_reaches_the_sampling(plain, monkeypatch):
    """``plain_versions()`` around ``maskformer_infer_rba`` reaches ``ms_deform_attn_core``:
    where the rule takes the kernel, a request launches it once per encoder layer, and a
    plain request never (the kernel stood in for by its plain version on the CPU)."""
    from rba_tpu_torch.config import tiny_test_config
    from rba_tpu_torch.models import maskformer as tmf

    torch.manual_seed(0)
    cfg = tiny_test_config()
    model = tmf.build_model(cfg, device="cpu").eval()
    image = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, 32, 48, 3)).astype(np.uint8))
    want = tmf.maskformer_infer_rba(model, cfg, image)
    calls = []

    def fake(v, shapes, l, a):
        calls.append(shapes)
        return tds.ms_deform_attn_plain(v, shapes, l, a)

    _rule_sees_a_card(monkeypatch)
    monkeypatch.setattr(kmd, "ms_deform_attn", fake)
    with plain_versions() if plain else contextlib.nullcontext():
        got = tmf.maskformer_infer_rba(model, cfg, image)
    assert len(calls) == (0 if plain else cfg.pixel_decoder.transformer_enc_layers)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
