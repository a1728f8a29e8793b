"""The fast serving slice on the card: the one-hot sampling and the ``"xla"`` branch
against the same functions on the CPU, and Kernels A and B at ``fast_serving`` against
their plain versions.

Marked ``cuda``: each test skips where no CUDA GPU is present (there
tests/test_torch_fast_serving.py holds the same functions against rba_tpu).  On a
machine with an H100: ``python -m pytest tests/test_torch_fast_serving_cuda.py -q
--noconftest``.
"""
import dataclasses

import pytest
import torch

from rba_tpu_torch import config as tconfig
from rba_tpu_torch.kernels import fused_rba as tfr
from rba_tpu_torch.kernels import plain_versions
from rba_tpu_torch.kernels import window_attention as twa
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.models import swin as tswin
from rba_tpu_torch.ops import deform_sampling as tds

pytestmark = pytest.mark.cuda

BF16_ULP = 2.0**-7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def ulp_share(got, want) -> float:
    d, w = (got.float() - want.float()).abs(), want.float().abs()
    return float((d <= BF16_ULP * w + 1e-6).float().mean())


def test_onehot_sampling_on_card_matches_cpu(cuda):
    """The fast cell's shape, one level of 32x64 (res5 of 1024x2048), 8 heads, 4 points:
    the bf16 one-hot form on the card equals it on the CPU within fp32 rounding."""
    gen = torch.Generator().manual_seed(0)
    n, m, d, p, (h, w) = 1, 8, 32, 4, (32, 64)
    lq = h * w
    value = torch.randn(n, h * w, m, d, generator=gen)
    loc = torch.rand(n, lq, m, 1, p, 2, generator=gen) * 1.2 - 0.1
    aw = torch.softmax(torch.randn(n, lq, m, 1 * p, generator=gen), -1).reshape(n, lq, m, 1, p)
    kw = dict(method="onehot", sampling_dtype="bfloat16")
    want = tds.ms_deform_attn_core(value, [(h, w)], loc, aw, **kw)
    got = tds.ms_deform_attn_core(value.to(cuda), [(h, w)], loc.to(cuda), aw.to(cuda), **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("fast_math", [False, True], ids=["factorized", "fast_math"])
@pytest.mark.parametrize("masked", [False, True])
def test_xla_attention_on_card_matches_cpu(cuda, fast_math, masked):
    """Stage 0 of Swin-B (window 12, 4 heads of 32) in bf16: within one bf16 ulp of the
    CPU's result for >= 99.9 % of the elements (exp and the sums differ in their last
    fp32 bits between the two)."""
    gen = torch.Generator().manual_seed(0)
    nh, hd, ws, hp, wp = 4, 32, 12, 48, 72
    n, nw = ws * ws, (hp // ws) * (wp // ws)
    qkv = torch.randn(2 * nw, n, 3 * nh * hd, generator=gen).to(torch.bfloat16)
    bias = torch.randn(nh, n, n, generator=gen)
    mask = torch.as_tensor(tswin.shifted_window_mask(hp, wp, ws, ws // 2)) if masked else None
    want = tswin.xla_attention(qkv, bias, mask, nh, hd**-0.5, fast_math=fast_math)
    got = tswin.xla_attention(qkv.to(cuda), bias.to(cuda), None if mask is None else mask.to(cuda), nh, hd**-0.5,
                              fast_math=fast_math)
    assert got.dtype == torch.bfloat16
    assert ulp_share(got.cpu(), want) >= 0.999


def test_fast_serving_kernels_match_plain_versions(cuda):
    """maskformer_infer_rba at fast_serving (attention="fused") on a small Swin: Kernel A
    in every block and Kernel B once, against the plain versions on the same weights.
    The backbone runs in fp32 here, so that the comparison is not one of bf16 flips:
    within 1e-3, the selfcheck bound, with the pixel decoder's bf16 inputs rounded from
    backbone outputs that differ by fp32 rounding."""
    cfg = dataclasses.replace(tconfig.fast_serving(tconfig.tiny_test_config()), compute_dtype="float32")
    model = tmf.build_model(cfg, device=cuda, seed=0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    img = torch.randint(0, 256, (1, 96, 128, 3), generator=gen, device=cuda, dtype=torch.uint8)
    before = twa.window_attention.launches, tfr.fused_rba_score.launches
    got = tmf.maskformer_infer_rba(model, cfg, img)
    torch.cuda.synchronize()
    after = twa.window_attention.launches, tfr.fused_rba_score.launches
    assert (after[0] - before[0], after[1] - before[1]) == (sum(cfg.swin.depths), 1)
    with plain_versions():
        want = tmf.maskformer_infer_rba(model, cfg, img)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
