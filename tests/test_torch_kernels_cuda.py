"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips where no CUDA GPU is present (there the wrappers
run the plain versions, which tests/test_torch_window_attention.py,
test_torch_fused_rba.py, test_torch_masked_softmax.py and test_torch_fused_mlp.py
hold against rba_tpu).  On a machine with an H100:
``python -m pytest tests/test_torch_kernels_cuda.py -q``.
"""
import contextlib

import pytest
import torch

from rba_tpu_torch.kernels import fused_mlp as tfm
from rba_tpu_torch.kernels import fused_rba as tfr
from rba_tpu_torch.kernels import lsap as tls
from rba_tpu_torch.kernels import masked_softmax as tms
from rba_tpu_torch.kernels import ms_deform_attn as tmd
from rba_tpu_torch.kernels import plain_versions
from rba_tpu_torch.kernels import rel_pos_attention as trp
from rba_tpu_torch.kernels import sr_attention as tsa
from rba_tpu_torch.kernels import window_attention as twa
from rba_tpu_torch.models import mix_transformer as tmit
from rba_tpu_torch.models import mvit as tmvit
from rba_tpu_torch.models import vit as tvit
from rba_tpu_torch.models.swin import shifted_window_mask
from rba_tpu_torch.ops import deform_sampling as tds
from rba_tpu_torch.ops.lsap import batched_linear_sum_assignment as lsap_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


BF16_ULP = 2.0**-7  # one bf16 ulp relative to the value, at most


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 2, 16, 8, 12), (12, 4, 32, 36, 48), (7, 2, 16, 14, 21), (7, 4, 32, 21, 28)],
                         ids=["N16", "N144", "N49_hd16", "N49_hd32"])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_kernel(cuda, dtype, shape, masked):
    """N = 49 (a 7x7 window) pads the keys and query rows to 64 in the bf16 kernel."""
    ws, nh, hd, hp, wp = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    n, nw = ws * ws, (hp // ws) * (wp // ws)
    qkv = torch.randn(2 * nw, n, 3 * nh * hd, generator=gen, device=cuda).to(dtype)
    bias = torch.randn(nh, n, n, generator=gen, device=cuda)
    mask = torch.as_tensor(shifted_window_mask(hp, wp, ws, ws // 2), device=cuda) if masked else None
    before = twa.window_attention.launches
    got = twa.window_attention(qkv, bias, mask, nh, hd**-0.5)
    torch.cuda.synchronize()
    assert twa.window_attention.launches == before + 1
    want = twa.window_attention_reference(qkv, bias, mask, nh, hd**-0.5)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:  # tests/test_torch_window_attention.py's per-element bound
        d, w = (got.float() - want.float()).abs(), want.float().abs()
        assert float((d <= BF16_ULP * w + 1e-6).float().mean()) >= 0.999


@pytest.mark.parametrize("n", [145, 150, 160])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_kernel_any_n(cuda, n, masked):
    """Windows of N > 144 keys (the mask read from L2), an N that is not a multiple of
    4 (4-byte copies) and an odd N (4-byte mask loads), with a random 0 / -100 mask."""
    nh, hd, nw = 2, 32, 3
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(2 * nw, n, 3 * nh * hd, generator=gen, device=cuda).bfloat16()
    bias = torch.randn(nh, n, n, generator=gen, device=cuda)
    mask = (torch.rand(nw, n, n, generator=gen, device=cuda) < 0.3).float() * -100 if masked else None
    got = twa.window_attention(qkv, bias, mask, nh, hd**-0.5)
    torch.cuda.synchronize()
    want = twa.window_attention_reference(qkv, bias, mask, nh, hd**-0.5)
    d, w = (got.float() - want.float()).abs(), want.float().abs()
    assert float(d.max()) <= BF16_ULP * float(w.max())
    assert float((d <= BF16_ULP * w + 1e-6).float().mean()) >= 0.999


@pytest.mark.parametrize("k", [7, 19, 40])
@pytest.mark.parametrize("layout", ["bqhw", "bhwq"])
def test_fused_rba_kernel(cuda, k, layout):
    gen = torch.Generator(device=cuda).manual_seed(0)
    mask_cls = torch.randn(2, 100, k + 1, generator=gen, device=cuda)
    mask_pred = torch.randn(2, 100, 13, 22, generator=gen, device=cuda) * 2
    m = mask_pred if layout == "bqhw" else mask_pred.permute(0, 2, 3, 1).contiguous()
    got = tfr.fused_rba_score(mask_cls, m, masks_layout=layout)
    torch.cuda.synchronize()
    want = tfr.fused_rba_score_reference(mask_cls, mask_pred)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bqk", [(1, 37, 19), (2, 37, 5), (2, 100, 19), (1, 8, 30)],
                         ids=["Q37", "Q37_B2", "Q100_B2", "Q8_K30"])
@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (9, 40)])
def test_fused_rba_kernel_edges(cuda, bqk, hw):
    """A Q that is not a multiple of 8 or of 4 (4-byte staging, padded queries), two
    batch elements with different cls, more than 24 classes (a second pass), masks of
    1 x 1 and 2 x 3 (every output pixel touches the clamped edge) and more than one
    32-patch tile per row (w = 40)."""
    b, q, k = bqk
    gen = torch.Generator(device=cuda).manual_seed(0)
    mask_cls = torch.randn(b, q, k + 1, generator=gen, device=cuda) * 2
    m = torch.randn(b, *hw, q, generator=gen, device=cuda) * 2  # bhwq
    before = tfr.fused_rba_score.launches
    got = tfr.fused_rba_score(mask_cls, m, masks_layout="bhwq")
    torch.cuda.synchronize()
    assert tfr.fused_rba_score.launches == before + 1
    want = tfr.fused_rba_score_reference(mask_cls, m, masks_layout="bhwq")
    assert got.shape == want.shape == (b, 4 * hw[0], 4 * hw[1])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [49, 145, 160])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_softmax_kernel_any_n(cuda, out_dtype, n, masked):
    """N = 49 and 145 (rows not 16-byte aligned: the scalar layout), N = 160 (the most
    keys; 40 groups of 4), 3 heads (a block with idle warps) and a batch of 2 nW
    windows with a random 0 / -100 mask."""
    nh, nw = 3, 5
    gen = torch.Generator(device=cuda).manual_seed(0)
    scores = torch.randn(2 * nw, nh, n, n, generator=gen, device=cuda) * 3
    bias = torch.randn(nh, n, n, generator=gen, device=cuda)
    mask = (torch.rand(nw, n, n, generator=gen, device=cuda) < 0.3).float() * -100 if masked else None
    got = tms.masked_softmax(scores, bias, mask, out_dtype)
    torch.cuda.synchronize()
    want = tms.masked_softmax_reference(scores, bias, mask, out_dtype)
    if out_dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-7, atol=2.0**-133)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_masked_softmax_kernel_unaligned_view(cuda):
    """Scores that start 4 bytes into an allocation take the scalar layout, not the
    16-byte loads."""
    n, nh, nw = 144, 2, 3
    gen = torch.Generator(device=cuda).manual_seed(0)
    scores = (torch.randn(nw * nh * n * n + 1, generator=gen, device=cuda) * 3)[1:].view(nw, nh, n, n)
    bias = torch.randn(nh, n, n, generator=gen, device=cuda)
    got = tms.masked_softmax(scores, bias, None, torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tms.masked_softmax_reference(scores, bias, None, torch.float32), rtol=0, atol=1e-6)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 2, 8, 12), (12, 4, 36, 48)], ids=["N16", "N144"])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_softmax_kernel(cuda, out_dtype, shape, masked):
    ws, nh, hp, wp = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    n, nw = ws * ws, (hp // ws) * (wp // ws)
    scores = torch.randn(2 * nw, nh, n, n, generator=gen, device=cuda) * 3
    bias = torch.randn(nh, n, n, generator=gen, device=cuda)
    mask = torch.as_tensor(shifted_window_mask(hp, wp, ws, ws // 2), device=cuda) if masked else None
    before = tms.masked_softmax.launches
    got = tms.masked_softmax(scores, bias, mask, out_dtype)
    torch.cuda.synchronize()
    assert tms.masked_softmax.launches == before + 1 and got.dtype == out_dtype
    want = tms.masked_softmax_reference(scores, bias, mask, out_dtype)
    if out_dtype == torch.bfloat16:  # one bf16 ulp, down to the subnormals' spacing
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-7, atol=2.0**-133)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_c", [(1000, 128), (4096, 256), (512, 384), (256, 512), (1000, 256), (1000, 384),
                                 (1000, 512)])
def test_fused_mlp_kernel(cuda, dtype, t_c):
    t, c = t_c
    gen = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=cuda) * scale + shift

    x = (randn(t, c) * 2).to(dtype)
    params = (randn(c, scale=0.2, shift=1.0), randn(c, scale=0.1), randn(4 * c, c, scale=0.05),
              randn(4 * c, scale=0.02), randn(c, 4 * c, scale=0.05), randn(c, scale=0.02))
    before = tfm.fused_mlp_residual.launches
    got = tfm.fused_mlp_residual(x, *params)
    torch.cuda.synchronize()
    assert tfm.fused_mlp_residual.launches == before + 1 and got.dtype == dtype
    want = tfm.fused_mlp_residual_reference(x, *params)
    d = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(d.max()) <= 1e-4
    else:  # tests/test_torch_fused_mlp.py's bf16 bound
        assert float((d <= 2e-2 + 2e-2 * want.float().abs()).float().mean()) >= 0.999
        assert float(d.max()) <= 2.0**-7 * float(want.float().abs().max())


def test_wrapper_raises_instead_of_falling_back(cuda):
    qkv = torch.zeros(4, 16, 3 * 2 * 64, device=cuda)  # hd 64: not taken by the kernel
    with pytest.raises(ValueError):
        twa.window_attention(qkv, torch.zeros(2, 16, 16, device=cuda), None, 2, 0.125)
    with pytest.raises(ValueError):  # N = 200 > 160 keys
        tms.masked_softmax(torch.zeros(1, 2, 200, 200, device=cuda), torch.zeros(2, 200, 200, device=cuda), None)
    with pytest.raises(ValueError):  # Q = 2000: the staged rows exceed a block's shared memory
        tfr.fused_rba_score(torch.zeros(1, 2000, 20, device=cuda), torch.zeros(1, 4, 4, 2000, device=cuda),
                            masks_layout="bhwq")
    with pytest.raises(ValueError):  # C = 192: not a multiple of 128
        c = 192
        tfm.fused_mlp_residual(torch.zeros(8, c, device=cuda), *(torch.zeros(*s, device=cuda) for s in
                               ((c,), (c,), (4 * c, c), (4 * c,), (c, 4 * c), (c,))))
    with pytest.raises(ValueError):  # head dim 48: not built
        tsa.sr_attention(torch.zeros(1, 16, 96, device=cuda, dtype=torch.bfloat16),
                         torch.zeros(1, 4, 192, device=cuda, dtype=torch.bfloat16), 2)


def test_wrappers_refuse_gradients_on_the_card(cuda):
    """Kernels A and C have no gradient: on CUDA tensors that require one, with grad mode
    on, the wrappers raise before any launch."""
    before = twa.window_attention.launches, tms.masked_softmax.launches
    qkv = torch.randn(4, 16, 3 * 2 * 16, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        twa.window_attention(qkv, torch.zeros(2, 16, 16, device=cuda), None, 2, 0.25)
    with pytest.raises(NotImplementedError, match="no gradient"):
        tms.masked_softmax(torch.randn(4, 2, 16, 16, device=cuda, requires_grad=True),
                           torch.zeros(2, 16, 16, device=cuda), None)
    assert (twa.window_attention.launches, tms.masked_softmax.launches) == before


@pytest.mark.parametrize("shape,kind", [((8, 32, 100), "rand"), ((3, 100, 100), "rand"), ((4, 32, 100), "int"),
                                        ((2, 40, 1024), "rand"), ((5, 7, 9), "padded")])
def test_lsap_kernel_equals_plain(cuda, shape, kind):
    """Kernel E's assignment equals the plain version's exactly (int equality)."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    if kind == "int":
        cost = torch.randint(0, 4, shape, generator=gen, device=cuda).float()
    else:
        cost = torch.rand(shape, generator=gen, device=cuda) * 10
    if kind == "padded":
        cost[:, -3:] = 1e6
    before = tls.batched_linear_sum_assignment.launches
    got = tls.batched_linear_sum_assignment(cost)
    torch.cuda.synchronize()
    assert tls.batched_linear_sum_assignment.launches == before + 1
    assert torch.equal(got.cpu(), lsap_plain(cost.cpu()))


def test_lsap_kernel_refuses_larger_shapes(cuda):
    with pytest.raises(ValueError):
        tls.batched_linear_sum_assignment(torch.zeros(1, 4, 1025, device=cuda))
    with pytest.raises(ValueError):
        tls.batched_linear_sum_assignment(torch.zeros(1, 5, 4, device=cuda))


R50_LEVELS = [(128, 256), (64, 128), (32, 64)]  # res3..res5 of a 1024x2048 frame: Lq = S = 43,008
SWIN_B_LEVELS = [(32, 64)]  # swin_b_1dl's one level: Lq = 2,048


def _sampling_inputs(gen, n, levels, m=8, d=32, p=4):
    """Encoder-shaped inputs (Lq = S), locations drawn over [-0.1, 1.1] so that about a
    third of the samples have a corner outside their map, and query 0 with every corner
    outside."""
    s, nl = sum(h * w for h, w in levels), len(levels)
    value = torch.randn(n, s, m, d, generator=gen, device=gen.device)
    loc = torch.rand(n, s, m, nl, p, 2, generator=gen, device=gen.device) * 1.2 - 0.1
    loc[:, 0, ..., 0], loc[:, 0, ..., 1] = -0.5, 1.7
    attn = torch.softmax(torch.randn(n, s, m, nl * p, generator=gen, device=gen.device), -1).reshape(n, s, m, nl, p)
    return value, loc, attn


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("levels", [R50_LEVELS, SWIN_B_LEVELS], ids=["r50", "swin_b"])
def test_ms_deform_attn_kernel(cuda, levels, n):
    """Kernel F against the plain gather: only the order of the fp32 sums differs."""
    gen = torch.Generator(device=cuda).manual_seed(n + len(levels))
    value, loc, attn = _sampling_inputs(gen, n, levels)
    before = tmd.ms_deform_attn.launches
    with torch.no_grad():
        got = tds.ms_deform_attn_core(value, levels, loc, attn)
    torch.cuda.synchronize()
    assert tmd.ms_deform_attn.launches == before + 1
    want = tds.ms_deform_attn_plain(value, levels, loc, attn)
    assert got.shape == want.shape == (n, value.shape[1], 8 * 32)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert bool((got[:, 0] == 0).all())


def test_ms_deform_attn_kernel_head_dim_16(cuda):
    """The kernel's other head width, the tests' tiny config's D = 16, at two levels, 4
    heads and 3 points."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    levels = [(16, 32), (8, 16)]
    value, loc, attn = _sampling_inputs(gen, 2, levels, m=4, d=16, p=3)
    before = tmd.ms_deform_attn.launches
    with torch.no_grad():
        got = tds.ms_deform_attn_core(value, levels, loc, attn)
    assert tmd.ms_deform_attn.launches == before + 1
    want = tds.ms_deform_attn_plain(value, levels, loc, attn)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert bool((got[:, 0] == 0).all())


@pytest.mark.parametrize("d,plain", [(24, False), (32, True)], ids=["d24", "plain"])
def test_ms_deform_attn_plain_path_on_the_card(cuda, d, plain):
    """A D the kernel is not built for, or ``plain_versions()``, runs the plain version on
    the card: no launch, no raise, the plain output."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    levels = [(16, 32), (8, 16)]
    value, loc, attn = _sampling_inputs(gen, 1, levels, d=d)
    before = tmd.ms_deform_attn.launches
    with torch.no_grad(), plain_versions() if plain else contextlib.nullcontext():
        got = tds.ms_deform_attn_core(value, levels, loc, attn)
    assert tmd.ms_deform_attn.launches == before
    assert torch.equal(got, tds.ms_deform_attn_plain(value, levels, loc, attn))


def test_ms_deform_attn_grad_takes_the_plain_path(cuda):
    """A call whose inputs require a gradient launches nothing and gives the plain
    path's output and gradient (held against the same call on the CPU)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    levels = [(16, 32), (8, 16)]
    value, loc, attn = _sampling_inputs(gen, 2, levels)
    cot = torch.randn(2, value.shape[1], 8 * 32, generator=gen, device=cuda)
    grads = {}
    for dev in ("cuda", "cpu"):
        xs = [x.detach().to(dev).requires_grad_() for x in (value, loc, attn)]
        before = tmd.ms_deform_attn.launches
        (tds.ms_deform_attn_core(xs[0], levels, xs[1], xs[2]) * cot.to(dev)).sum().backward()
        assert tmd.ms_deform_attn.launches == before
        grads[dev] = [x.grad.cpu() for x in xs]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# (batch, heads, N, M, head dim): MiT-B5's four stages on a 1024x2048 frame; batch 2; MiT-B0's
# head dim 32 (its first and third stages); a 720x1280 frame, padded to 736x1280, whose N and
# M are no multiples of the kernel's 128 query rows and 64 keys; M < 64; one key
SR_SHAPES = [(1, 1, 131072, 2048, 64), (1, 2, 32768, 2048, 64), (1, 5, 8192, 2048, 64), (1, 8, 2048, 2048, 64),
             (2, 5, 8192, 2048, 64), (1, 1, 131072, 2048, 32), (1, 5, 8192, 2048, 32),
             (1, 1, 58880, 920, 64), (1, 2, 14720, 920, 64), (1, 5, 3680, 920, 64), (1, 8, 920, 920, 64),
             (3, 2, 77, 37, 64), (2, 3, 50, 5, 32), (1, 1, 1, 1, 64)]


@pytest.mark.parametrize("shape", SR_SHAPES, ids=["b5_s1", "b5_s2", "b5_s3", "b5_s4", "b5_s3_B2", "b0_s1_hd32",
                                                  "b0_s3_hd32", "720_s1", "720_s2", "720_s3", "720_s4", "M37",
                                                  "M5_hd32", "M1"])
def test_sr_attention_kernel(cuda, shape):
    """Kernel G against ``sr_attention_plain``: only the order of the fp32 sums differs,
    which moves a bf16 rounding now and then.  At least 99 % of the outputs are
    bit-equal and none lies beyond 2 bf16 ulps of its row's largest |value|.  Measured
    on an H100 80GB HBM3 (these inputs): bit-equal 99.900-99.905 % at the four MiT-B5
    stage shapes, 99.894 % at batch 2, 99.898-99.899 % at head dim 32, 99.938-99.947 %
    at the 720x1280 shapes, 100 % at M = 37, 5 and 1; the worst gap 1 ulp throughout."""
    import chip_smoke

    b, heads, n, m, hd = shape
    gen = torch.Generator(device=cuda).manual_seed(n + m + hd)
    q = torch.randn(b, n, heads * hd, generator=gen, device=cuda).bfloat16()
    kv = torch.randn(b, m, 2 * heads * hd, generator=gen, device=cuda).bfloat16()
    before = tsa.sr_attention.launches
    with torch.no_grad():
        got = tsa.sr_attention(q, kv, heads)
    torch.cuda.synchronize()
    assert tsa.sr_attention.launches == before + 1 and got.shape == q.shape and got.dtype == torch.bfloat16
    share, ulps = chip_smoke.sr_attention_gap(got, tmit.sr_attention_plain(q, kv, heads))
    assert share >= chip_smoke.SR_BIT_EQUAL_SHARE and ulps <= chip_smoke.SR_MAX_ULPS, (share, ulps)
    if m == 1:  # one key: p = 1, the output is v
        assert torch.equal(got, kv[:, :, heads * hd:].expand(b, n, heads * hd))


def test_sr_attention_grad_takes_the_plain_path(cuda):
    """MiT-B0 on the card at bf16: under autograd every attention core takes the plain
    chain (no launch; the output equals ``plain_versions()``'s), without it one launch a block."""
    torch.manual_seed(0)
    model = tmit.MiT(tmit.MIT_VARIANTS["mit_b0"]).to(cuda)
    images = torch.randn(1, 64, 96, 3, device=cuda)
    before = tsa.sr_attention.launches
    got = tmit.mit_apply(model, images.requires_grad_())
    assert tsa.sr_attention.launches == before
    with plain_versions():
        want = tmit.mit_apply(model, images)
    assert all(torch.equal(got[k], want[k]) for k in want)
    got["res5"].float().sum().backward()
    assert images.grad is not None
    with torch.no_grad():
        tmit.mit_apply(model, images)
    assert tsa.sr_attention.launches == before + sum(tmit.MIT_VARIANTS["mit_b0"].depths)


# (calls, q_hw, kv_hw, head dim): every distinct MViTv2-B core of a 1024x2048 frame (calls =
# windows x heads; chip_smoke.MVIT_B_CORES); ViTDet-B's 14x14 windows and its 64x128 global
# call at head dim 64; a batch of 2 of MViTv2-B's stage-1 windows and of its block 4;
# ragged shapes whose query and key counts are no multiples of the kernel's 64 rows and 64
# keys, one with an odd kw and one with 3,600 keys
REL_SHAPES = [(50, (56, 56), (14, 14), 96), (100, (28, 28), (28, 28), 96), (100, (28, 28), (14, 14), 96),
              (2, (128, 256), (32, 64), 96), (200, (14, 14), (28, 28), 96), (200, (14, 14), (14, 14), 96),
              (4, (64, 128), (32, 64), 96), (400, (7, 7), (14, 14), 96), (400, (7, 7), (7, 7), 96),
              (8, (32, 64), (32, 64), 96),
              (600, (14, 14), (14, 14), 64), (12, (64, 128), (64, 128), 64),
              (100, (56, 56), (14, 14), 96), (4, (128, 256), (32, 64), 96),
              (3, (5, 9), (3, 7), 96), (5, (17, 3), (4, 16), 64), (2, (12, 300), (12, 300), 96),
              (7, (9, 11), (8, 16), 96)]
REL_IDS = ["mvit_s1", "mvit_s2_28", "mvit_s2_14", "mvit_b4", "mvit_s3_28", "mvit_s3_14", "mvit_b20", "mvit_s4_14",
           "mvit_s4_7", "mvit_b23", "vitdet_win", "vitdet_global", "mvit_s1_B2", "mvit_b4_B2", "kw7", "q51", "k3600",
           "q99"]


@pytest.mark.parametrize("shape", REL_SHAPES, ids=REL_IDS)
def test_rel_pos_attention_kernel(cuda, shape):
    """Kernel H, through ``vit.attention_core``'s route, against ``rel_pos_attention_plain``:
    only the order of the fp32 sums differs, which moves a bf16 rounding now and then.  At
    least 99 % of the outputs are bit-equal and none lies beyond 2 bf16 ulps of its row's
    largest |value|.  Measured on an H100 80GB HBM3: every case within the gate; at
    ``chip_smoke.rel_pos_attention_phase``'s inputs of the ten MViTv2-B shapes, bit-equal
    99.944-99.995 %, the worst gap 1 ulp."""
    import chip_smoke

    calls, q_hw, kv_hw, hd = shape
    gen = torch.Generator(device=cuda).manual_seed(calls + 7 * q_hw[1] + 13 * kv_hw[1] + hd)
    q, k, v, rel_h, rel_w = chip_smoke.rel_pos_inputs(gen, calls, q_hw, kv_hw, hd)
    before = trp.rel_pos_attention.launches
    with torch.no_grad():
        got = tvit.attention_core(q, k, v, q_hw, kv_hw, rel_h, rel_w)
        torch.cuda.synchronize()
        assert trp.rel_pos_attention.launches == before + 1 and got.shape == q.shape and got.dtype == torch.bfloat16
        want = tvit.rel_pos_attention_plain(q, k, v, q_hw, kv_hw, rel_h, rel_w)
    share, ulps = chip_smoke.sr_attention_gap(got, want)
    assert share >= chip_smoke.SR_BIT_EQUAL_SHARE and ulps <= chip_smoke.SR_MAX_ULPS, (share, ulps)


def test_rel_pos_attention_kernel_reads_strided_rows(cuda):
    """The kernel gives on views the result it gives on copies: q, k and v as views of one
    (calls, tokens, 3 hd) tensor, as a split qkv leaves them (rows read by strides);
    channel-major, as MViT's pooling leaves its global blocks' q, k and v (q read by its
    strides one value at a time, k and v copied for it); and q starting 2 bytes past a
    32-bit word."""
    import chip_smoke

    gen = torch.Generator(device=cuda).manual_seed(3)
    q_hw = kv_hw = (32, 64)
    qkv = torch.randn(8, 2048, 3 * 96, generator=gen, device=cuda).bfloat16()
    split = qkv.split(96, dim=-1)
    channel_major = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in split]
    shifted = [qkv[..., 1:97], *split[1:]]
    _, _, _, rel_h, rel_w = chip_smoke.rel_pos_inputs(gen, 1, q_hw, kv_hw, 96)
    for q, k, v in (split, channel_major, shifted):
        with torch.no_grad():
            got = tvit.attention_core(q, k, v, q_hw, kv_hw, rel_h, rel_w)
            want = tvit.attention_core(q.contiguous(), k.contiguous(), v.contiguous(), q_hw, kv_hw, rel_h, rel_w)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q,k,extra", [(56, 14, 0), (28, 28, 0), (14, 28, 0), (7, 7, 0), (128, 32, 0), (64, 128, 0),
                                       (14, 14, 4), (3, 5, 2)])
def test_rel_pos_tables_kernel_is_the_chains(cuda, q, k, extra, dtype):
    """The tables kernel, in one launch, gives ``rel_pos_resampled``'s tables cast to bf16
    bit for bit, from parameters in ``dtype``, resampled (``extra`` entries beyond the
    call's) or not."""
    q_hw, kv_hw = (q, k), (k, q)
    gen = torch.Generator(device=cuda).manual_seed(q + 3 * k + extra)
    rel_h, rel_w = (0.1 * torch.randn(2 * max(q, k) - 1 + extra, 96, generator=gen, device=cuda) for _ in range(2))
    rel_h, rel_w = rel_h.to(dtype), rel_w.to(dtype)
    before = trp.rel_pos_tables.launches
    with torch.no_grad():
        rh, rw, index = tvit.rel_pos_tables(rel_h, rel_w, q_hw, kv_hw)
    assert trp.rel_pos_tables.launches == before + 1
    assert torch.equal(rh, tvit.rel_pos_resampled(rel_h, q, k).to(torch.bfloat16))
    assert torch.equal(rw[index.long()], tvit.rel_pos_resampled(rel_w, k, q).to(torch.bfloat16))


def test_rel_pos_attention_grad_takes_the_plain_path(cuda):
    """MViTv2-B on the card at bf16: under autograd every attention core takes the plain
    chain (no launch; the output equals ``plain_versions()``'s), without it one launch a
    block; the wrapper itself refuses a gradient before any launch."""
    torch.manual_seed(0)
    model = tmvit.MViT(tmvit.MViTConfig()).to(cuda)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(std=0.02)
    images = torch.randn(1, 64, 96, 3, device=cuda)
    before = trp.rel_pos_attention.launches
    got = tmvit.mvit_apply(model, images.requires_grad_())
    assert trp.rel_pos_attention.launches == before
    with plain_versions():
        want = tmvit.mvit_apply(model, images)
    assert all(torch.equal(got[k], want[k]) for k in want)
    got["scale5"].float().sum().backward()
    assert images.grad is not None
    with torch.no_grad():
        tmvit.mvit_apply(model, images)
    assert trp.rel_pos_attention.launches == before + len(model.blocks)
    q_hw = kv_hw = (2, 3)
    q = torch.randn(2, 6, 96, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    rh, rw, index = tvit.rel_pos_tables(torch.zeros(3, 96, device=cuda), torch.zeros(5, 96, device=cuda), q_hw,
                                        kv_hw)
    with pytest.raises(NotImplementedError, match="no gradient"):
        trp.rel_pos_attention(q, q.detach(), q.detach(), rh, rw, index, q_hw, kv_hw)
    assert trp.rel_pos_attention.launches == before + len(model.blocks)
