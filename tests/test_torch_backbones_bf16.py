"""The convolutional backbones and Swin's ``ape`` at bf16 against rba_tpu on the CPU.

The same pairs as ``tests/test_torch_backbones.py`` (small sizes, one seeded Detectron2
dict, a seeded input), at ``compute_dtype`` bf16, against rba_tpu called op by op, its
contract (ROADMAP.md §C.3; jitted, even without excess precision, XLA rounds MiT's
chain in other places).  The transformer families are in
``tests/test_torch_backbones_bf16_mit.py`` and ``tests/test_torch_backbones_bf16_vit.py``
(three files, each within a minute on one worker: rba_tpu's op-by-op calls compile
every op).

- ``test_backbone_bf16_shares``: each output's share of elements equal to rba_tpu's and
  within one bf16 ulp of their own value, recorded as properties of the test case.
  ``ULP_RECORDED`` is each family's least share within one ulp as recorded when the
  port was written: a floor of that recording, not an accepted bound.
- ``test_resnet_stem_bf16_op_by_op``: where the shares part.  Each op, given rba_tpu's
  input to it, rounds as rba_tpu's does: the batch norm, ReLU and max pool are equal;
  the conv sums in fp32 in another order (oneDNN's against XLA's) and flips about one
  element in 1e4 by one ulp; and the fp32 ``rsqrt`` of the batch norm differs in its
  last bit (XLA's against torch's), which the bf16 rounding mostly hides.  A flip then
  spreads through every later layer (ROADMAP.md §C.1, §C.9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu.ops import nn as jnn
from tests.test_torch_backbones import _image, family_pair
from tests.torch_port_common import default_threads, equal_share, record, t, ulp_share  # noqa: F401

pytestmark = pytest.mark.usefixtures("default_threads")  # the shares' recorded floors

# the least share within one bf16 ulp over each family's outputs, as recorded
ULP_RECORDED = {"resnet": 0.657, "resnet_stride_in_1x1": 0.647, "wideresnet38": 0.657, "swin_ape": 1.0,
                "mit_b0": 1.0, "vit": 0.629, "vit_sfp": 0.486, "mvit": 0.402}


def _rba_eager(japply, params, x, dtype):
    p = jax.tree_util.tree_map(lambda a: a if np.ndim(a) == 0 else jnp.asarray(a), params)
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in japply(p, jnp.asarray(x), dtype).items()}


def _bf16_pair(family):
    _, params, model, japply, tapply, hw, _, _ = family_pair(family)
    x = _image(hw)
    return _rba_eager(japply, params, x, jnp.bfloat16), lambda: tapply(t(x), torch.bfloat16)


CONV_FAMILIES = ["resnet", "resnet_stride_in_1x1", "wideresnet38", "swin_ape"]


def bf16_shares_case(family, request):
    """Record each output's equal and one-ulp shares against rba_tpu op by op; hold the
    least one-ulp share at the family's recorded floor."""
    want, run = _bf16_pair(family)
    with torch.no_grad():
        got = run()
    least = 1.0
    for k in sorted(want):
        assert got[k].dtype == torch.bfloat16 and tuple(got[k].shape) == want[k].shape, k
        eq, ulp = equal_share(got[k], want[k]), ulp_share(got[k], want[k])
        record(request, **{f"{k}_equal": eq, f"{k}_ulp": ulp})
        least = min(least, ulp)
    assert least >= ULP_RECORDED[family], (family, least)


@pytest.mark.parametrize("family", CONV_FAMILIES)
def test_backbone_bf16_shares(family, request):
    bf16_shares_case(family, request)


def test_resnet_stem_bf16_op_by_op(request):
    import torch.nn.functional as F

    from rba_tpu.models import resnet as jresnet
    from rba_tpu_torch.ops.nn import apply_conv, frozen_batch_norm, max_pool_nhwc

    _, params, model, *_ = family_pair("resnet")
    p = jax.tree_util.tree_map(jnp.asarray, params)
    x = jnp.asarray(_image((64, 96))).astype(jnp.bfloat16)
    conv = jnn.conv2d(p["stem"]["conv1"], x, stride=2, padding=3)
    bn = jax.nn.relu(jresnet._bn(p["stem"]["norm1"], conv))
    pool = jax.lax.reduce_window(bn, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1), [(0, 0), (1, 1), (1, 1), (0, 0)])
    with torch.no_grad():
        got_conv = apply_conv(model.stem["conv1"], _t16(x), stride=2, padding=3)
        got_bn = F.relu(frozen_batch_norm(_t16(conv), model.stem["norm1"]))
        got_pool = max_pool_nhwc(_t16(bn), 3, 2, 1)
        var = model.stem["norm1"].var + 1e-5
    shares = dict(conv_equal=equal_share(got_conv, conv), conv_ulp=ulp_share(got_conv, conv),
                  bn_relu_equal=equal_share(got_bn, bn), maxpool_equal=equal_share(got_pool, pool),
                  rsqrt_fp32_equal=equal_share(torch.rsqrt(var), jax.lax.rsqrt(jnp.asarray(var.numpy()))))
    record(request, **shares)
    assert shares["conv_ulp"] == 1.0 and shares["conv_equal"] >= 0.999
    assert shares["bn_relu_equal"] == 1.0 and shares["maxpool_equal"] == 1.0


def _t16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16()
