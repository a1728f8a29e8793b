"""Small functional building blocks on NHWC tensors (counterpart of ``rba_tpu/ops/nn.py``).

Weights are in PyTorch layouts: a linear weight is (out, in), a conv weight is
OIHW.  Activations keep the JAX package's layout, channels last.  As there,
each op computes in the activation's dtype and casts the fp32 weights to it;
below fp32 a bias is added after the product is rounded, so the result is
rounded twice, as there.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return y if bias is None else y + bias.to(y.dtype)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    if x.dtype == torch.float32:
        return F.linear(x, weight.to(x.dtype), _cast(bias, x.dtype))
    return _add_bias(F.linear(x, weight.to(x.dtype)), bias)


def linear_weight(layer: nn.Module, dtype) -> torch.Tensor:
    """The layer's (out, in) weight in ``dtype``: of an int8 layer (``ops/quant.py``) the
    dequantized ``kernel_q.to(dtype) * kscale.to(dtype)``, rounded in ``dtype`` as
    ``rba_tpu``'s ``linear`` rounds it."""
    if hasattr(layer, "kernel_q"):
        return layer.kernel_q.to(dtype) * layer.kscale.to(dtype)[:, None]
    return layer.weight.to(dtype)


def apply_linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """The layer on ``x``: int8 weights dequantized (``linear_weight``), a tensor-parallel
    shard through its collectives (``parallel/tp.py``)."""
    tp = getattr(layer, "tp", None)
    if tp is not None:
        return tp.apply(layer, x)
    return linear(x, linear_weight(layer, x.dtype), layer.bias)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32 (biased variance), cast back to x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def apply_norm(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, norm.weight, norm.bias)


def group_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int = 32, eps: float = 1e-5
) -> torch.Tensor:
    """GroupNorm of (N, H, W, C) activations, torch semantics, statistics in fp32."""
    n, h, w, c = x.shape
    g = num_groups
    x32 = x.float()
    var, mean = torch.var_mean(x32.reshape(n, h * w, g, c // g), dim=(1, 3), unbiased=False)
    inv = torch.rsqrt(var + eps).repeat_interleave(c // g, dim=1)  # (n, c)
    mean_c = mean.repeat_interleave(c // g, dim=1)
    scale = weight.float()[None] * inv
    shift = bias.float()[None] - mean_c * scale
    return (x32 * scale[:, None, None, :] + shift[:, None, None, :]).to(x.dtype)


def apply_group_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return group_norm(x, norm.weight, norm.bias, norm.num_groups, norm.eps)


def _same_pads(size: int, k: int, stride: int, dilation: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: the odd pixel goes after."""
    total = max((-(-size // stride) - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: Union[str, int] = "SAME",
    groups: int = 1,
    dilation: int = 1,
    dot_1x1: bool = True,
) -> torch.Tensor:
    """Conv of (N, H, W, C) with an OIHW weight, as ``jax.lax.conv_general_dilated``
    computes it: ``padding`` "SAME" (odd kernels; XLA's split of a strided one), "VALID"
    or pixels on each side.  With
    ``dot_1x1`` a 1x1 stride-1 conv without padding or groups is a channel matmul, as the
    JAX package's ``conv2d`` takes it."""
    o, i, kh, kw = weight.shape
    h, w = x.shape[1], x.shape[2]
    if padding == "SAME":
        if kh % 2 == 0 or kw % 2 == 0:  # no caller needs XLA's uneven split of an even kernel
            raise ValueError(f"SAME padding is ported for odd kernels, got {kh}x{kw}")
        (top, bottom), (left, right) = _same_pads(h, kh, stride, dilation), _same_pads(w, kw, stride, dilation)
    elif padding == "VALID":
        top = bottom = left = right = 0
    else:
        top = bottom = left = right = int(padding)
    if dot_1x1 and kh == kw == 1 and stride == 1 and groups == 1 and not (top or bottom or left or right):
        return linear(x, weight.reshape(o, i), bias)
    xc = x.permute(0, 3, 1, 2)
    if (top, left) != (bottom, right):
        xc = F.pad(xc, (left, right, top, bottom))
        top = left = 0
    fused = x.dtype == torch.float32
    y = F.conv2d(xc, weight.to(x.dtype), _cast(bias, x.dtype) if fused else None, stride=stride,
                 padding=(top, left), dilation=dilation, groups=groups)
    y = y.permute(0, 2, 3, 1)
    return y if fused else _add_bias(y, bias)


def apply_conv(conv: nn.Conv2d, x: torch.Tensor, **kw) -> torch.Tensor:
    """``conv2d`` with the module's weight and bias; SAME padding unless ``padding`` is given."""
    return conv2d(x, conv.weight, conv.bias, **kw)


def centered_layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in fp32 with the variance as the mean of (x − mean)², cast back to x's
    dtype: the ``_ln`` of the JAX package's ViT, MViT and MiT (eps from the module)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + norm.eps) * norm.weight + norm.bias).to(x.dtype)


def frozen_batch_norm(x: torch.Tensor, bn: nn.Module, eps: float = 1e-5, relu: bool = False) -> torch.Tensor:
    """Inference batch norm of channels-last ``x`` with running statistics, in fp32 in
    the JAX package's order, (x − mean)·rsqrt(var + eps)·scale + bias, then ReLU where
    asked, cast back to x's dtype.  ``bn`` holds ``weight``, ``bias``, ``mean``, ``var``."""
    y = (x.float() - bn.mean) * torch.rsqrt(bn.var + eps) * bn.weight + bn.bias
    return (F.relu(y) if relu else y).to(x.dtype)


def max_pool_nhwc(x: torch.Tensor, k: int, stride: int, padding: int = 0) -> torch.Tensor:
    """Max pool of (N, H, W, C); padding counts as −inf, as ``lax.reduce_window``'s does."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, stride, padding).permute(0, 2, 3, 1)


def mlp_apply(layers: Sequence[nn.Linear], x: torch.Tensor, act=F.relu) -> torch.Tensor:
    """Linear layers with ``act`` between them and none after the last."""
    for i, layer in enumerate(layers):
        x = apply_linear(layer, x)
        if i < len(layers) - 1:
            x = act(x)
    return x
