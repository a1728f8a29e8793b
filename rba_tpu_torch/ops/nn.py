"""Small functional building blocks on NHWC tensors (counterpart of ``rba_tpu/ops/nn.py``).

Weights are in PyTorch layouts: a linear weight is (out, in), a conv weight is
OIHW.  Activations keep the JAX package's layout, channels last.  As there,
each op computes in the activation's dtype and casts the fp32 weights to it;
below fp32 a bias is added after the product is rounded, so the result is
rounded twice, as there.
"""
from __future__ import annotations

from typing import Optional, Sequence

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


def apply_linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return linear(x, layer.weight, layer.bias)


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


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1 SAME conv of (N, H, W, C) with an OIHW weight of odd size, the only
    convs of the pixel decoder and the decoder.  A 1x1 conv is a channel matmul."""
    o, i, kh, kw = weight.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"SAME padding is ported for odd kernels, got {kh}x{kw}")
    if kh == 1 and kw == 1:
        return linear(x, weight.reshape(o, i), bias)
    fused = x.dtype == torch.float32
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), _cast(bias, x.dtype) if fused else None,
                 padding=((kh - 1) // 2, (kw - 1) // 2))
    y = y.permute(0, 2, 3, 1)
    return y if fused else _add_bias(y, bias)


def apply_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv2d(x, conv.weight, conv.bias)


def mlp_apply(layers: Sequence[nn.Linear], x: torch.Tensor, act=F.relu) -> torch.Tensor:
    """Linear layers with ``act`` between them and none after the last."""
    for i, layer in enumerate(layers):
        x = apply_linear(layer, x)
        if i < len(layers) - 1:
            x = act(x)
    return x
