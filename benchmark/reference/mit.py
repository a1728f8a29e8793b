"""Plain PyTorch reference of SegFormer's Mix Transformer at MiT-B5, the backbone of
RbA's MiT-B5 configurations: a backbone file of the reference (contract:
``reference/__init__.py``).

Written from the published description (Xie et al., "SegFormer", NeurIPS 2021; NVlabs
SegFormer, ``mmseg/models/backbones/mix_transformer.py``, classes
``MixVisionTransformer`` and ``mit_b5``), in fp32, one image at a time.
Each of the four stages is an overlapping patch embed (a strided conv and a
LayerNorm), blocks of

    x += proj(softmax(q·kᵀ / sqrt(d))·v),  q = W_q·LN₁(x),  k, v = W_kv·LN_sr(conv_sr(LN₁(x)))
    x += fc2(GELU(dwconv₃ₓ₃(fc1(LN₂(x)))))

(no conv and no LN_sr where the reduction ratio is 1), and a LayerNorm; ``res2`` …
``res5`` at strides 4 … 32.  Its widths are its own table, ``VARIANTS``; it reads the
weights under the port's parameter names (``backbone.stages.{s}.blocks.{j}.attn.q``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .model import _conv, _linear

# SegFormer's mix_transformer.py class mit_b5: embed dims, heads (head dim 64), depths and
# spatial-reduction ratios of the four stages; MLP ratio 4 and qkv bias in every stage
VARIANTS = {"mit_b5": dict(embed_dims=(64, 128, 320, 512), num_heads=(1, 2, 5, 8), depths=(3, 6, 40, 3),
                           sr_ratios=(8, 4, 2, 1))}
MLP_RATIO = 4
PATCH = ((7, 4), (3, 2), (3, 2), (3, 2))  # OverlapPatchEmbed's (kernel, stride) per stage, padding kernel // 2

# LayerNorm eps as SegFormer's code sets them
BLOCK_EPS = 1e-6  # mit_b5: norm_layer=partial(nn.LayerNorm, eps=1e-6): each block's norm1, norm2, each stage's norm
PATCH_EPS = 1e-5  # OverlapPatchEmbed: self.norm = nn.LayerNorm(embed_dim), torch's default eps
SR_EPS = 1e-5  # Attention: self.norm = nn.LayerNorm(dim) after self.sr, torch's default eps


def _variant(model: dict) -> dict:
    name = model["backbone_name"]
    if name not in VARIANTS:
        raise NotImplementedError(f"backbone {name!r}: the MiT reference holds {sorted(VARIANTS)}")
    return VARIANTS[name]


def _ln(P, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], eps)


def _out(size: int, k: int, s: int, pad: int) -> int:
    return (size + 2 * pad - k) // s + 1


def _block(P, pre: str, x: torch.Tensor, h: int, w: int, heads: int, sr: int, q) -> torch.Tensor:
    """One block on (1, h·w, C) tokens."""
    b, n, c = x.shape
    d = c // heads
    y = _ln(P, pre + ".norm1", x, BLOCK_EPS)
    qh = _linear(P, pre + ".attn.q", y, q).view(b, n, heads, d).transpose(1, 2)
    kv = y
    if sr > 1:
        kv = _conv(P, pre + ".attn.sr", y.transpose(1, 2).reshape(b, c, h, w), stride=sr, q=q)
        kv = _ln(P, pre + ".attn.sr_norm", kv.flatten(2).transpose(1, 2), SR_EPS)
    kh, vh = _linear(P, pre + ".attn.kv", kv, q).view(b, -1, 2, heads, d).permute(2, 0, 3, 1, 4)
    s = q(qh) @ q(kh).transpose(-2, -1) * d**-0.5
    out = (q(s.softmax(-1)) @ q(vh)).transpose(1, 2).reshape(b, n, c)
    x = x + _linear(P, pre + ".attn.proj", out, q)
    y = _linear(P, pre + ".mlp.fc1", _ln(P, pre + ".norm2", x, BLOCK_EPS), q)
    hidden = y.shape[-1]
    y = F.conv2d(q(y.transpose(1, 2).reshape(b, hidden, h, w)), q(P[pre + ".mlp.dwconv.weight"]),
                 P[pre + ".mlp.dwconv.bias"], padding=1, groups=hidden)
    return x + _linear(P, pre + ".mlp.fc2", F.gelu(y.flatten(2).transpose(1, 2)), q)


def features(P, model: dict, x: torch.Tensor, q) -> Dict[str, torch.Tensor]:
    """(1, H, W, 3) normalised image → {res2..res5} NCHW fp32 maps."""
    v = _variant(model)
    x = x.permute(0, 3, 1, 2)
    outs = {}
    for s, depth in enumerate(v["depths"]):
        k, stride = PATCH[s]
        pre = f"backbone.stages.{s}"
        x = _conv(P, pre + ".patch_embed.proj", x, stride=stride, padding=k // 2, q=q)
        b, c, h, w = x.shape
        x = _ln(P, pre + ".patch_embed.norm", x.flatten(2).transpose(1, 2), PATCH_EPS)
        for j in range(depth):
            x = _block(P, f"{pre}.blocks.{j}", x, h, w, v["num_heads"][s], v["sr_ratios"][s], q)
        x = _ln(P, pre + ".norm", x, BLOCK_EPS).transpose(1, 2).reshape(b, c, h, w)
        outs[f"res{s + 2}"] = x
    return outs


def _stages(model: dict, h: int, w: int):
    """Per stage on an (h, w) image: (channels, query tokens, key tokens, blocks,
    reduction ratio, the patch embed's fan-in)."""
    v = _variant(model)
    out, c_in = [], 3
    for s, depth in enumerate(v["depths"]):
        k, stride = PATCH[s]
        h, w = _out(h, k, stride, k // 2), _out(w, k, stride, k // 2)
        sr = v["sr_ratios"][s]
        out.append((v["embed_dims"][s], h * w, (h // sr) * (w // sr), depth, sr, c_in * k * k))
        c_in = v["embed_dims"][s]
    return out


def flops(model: dict, h: int, w: int) -> Tuple[int, Dict[str, Tuple[int, int]]]:
    """Operations of the backbone on an (h, w) padded image, as ``FlopCounterMode``
    counts them on ``features``, and each map's (channels, hw)."""
    total, feats = 0, {}
    for s, (c, n, m, depth, sr, patch_fan_in) in enumerate(_stages(model, h, w)):
        hidden = MLP_RATIO * c
        total += 2 * n * c * patch_fan_in  # the patch embed
        per_block = (2 * n * c * c  # q
                     + (2 * m * c * c * sr * sr if sr > 1 else 0)  # the reduction conv
                     + 2 * m * c * 2 * c  # kv
                     + 4 * n * m * c  # q·kᵀ and p·v
                     + 2 * n * c * c  # proj
                     + 2 * n * c * hidden + 2 * n * hidden * 9 + 2 * n * hidden * c)  # fc1, dwconv, fc2
        total += depth * per_block
        feats[f"res{s + 2}"] = (c, n)
    return total, feats


def attention_work(model: dict, h: int, w: int, batch: int) -> Tuple[int, int]:
    """(operations, bytes) of every attention core (q·kᵀ, softmax, ·v) of one request of
    ``batch`` (h, w) padded images: q·kᵀ and p·v; q, k, v read and the output written
    once in bf16."""
    work = nbytes = 0
    for c, n, m, depth, _, _ in _stages(model, h, w):
        work += depth * 4 * n * m * c
        nbytes += depth * 2 * (2 * n * c + 2 * m * c)
    return batch * work, batch * nbytes
