"""Plain PyTorch reference of MViTv2-B, the backbone of RbA's MViT configurations: a
backbone file of the reference (contract: ``reference/__init__.py``).

Written from the published description (Li et al., "MViTv2: Improved Multiscale Vision
Transformers for Classification and Detection", CVPR 2022; Detectron2
``modeling/backbone/mvit.py``, classes ``MViT``, ``MultiScaleBlock`` and
``MultiScaleAttention``, with ``get_rel_pos`` and ``add_decomposed_rel_pos`` from
``modeling/backbone/utils.py``), in fp32, one image at a time.  A 7×7/4 patch embed,
then 24 blocks of

    q, k, v = LN_q(pool_q(W_q·LN₁(x))), LN_k(pool_k(W_k·LN₁(x))), LN_v(pool_v(W_v·LN₁(x)))
    attn = softmax((q·d^-½)·kᵀ + q·R_h[i_h, j_h] + q·R_w[i_w, j_w])     (inside windows, or global)
    x = maxpool(proj_skip(LN₁(x)) or x) + proj(attn·v + q)
    x += fc2(GELU(fc1(LN₂(x))))

with the pools 3×3 depthwise convs (q by the block's stride, k and v by the adaptive
stride), the windows zero-padded to whole windows and cropped after, and the position
tables resampled linearly to 2·max(q, k) − 1 entries; ``scale2`` … ``scale5`` at strides
4 … 32, each after its own LayerNorm.  Its widths and schedule are its own table,
``MVIT_B``, walked as Detectron2's ``MViT.__init__`` walks its stage loop; it reads the
weights under the port's parameter names (``backbone.blocks.{i}.attn.pool_q``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .model import _conv, _linear

# MViTv2-B as RbA's D2MViT builds it (Detectron2's MViTv2-B settings): embed 96 and 1 head,
# both doubling per stage (head dim 96), 24 blocks whose stages end at last_block_indexes,
# q/k/v pooled by 3x3 depthwise convs, k and v at the adaptive stride 4 and windows of the
# adaptive size 56, both halved per stage, residual pooling, decomposed relative positions
# and no absolute position, MLP ratio 4, qkv bias
MVIT_B = dict(embed_dim=96, num_heads=1, depth=24, last_block_indexes=(1, 4, 20, 23), pool_kernel=3,
              adaptive_kv_stride=4, adaptive_window_size=56, residual_pooling=True, mlp_ratio=4)
PATCH = (7, 4, 3)  # the patch embed's kernel, stride and padding
# Detectron2's MViTv2 configurations, which D2MViT follows, pass norm_layer=partial(nn.LayerNorm,
# eps=1e-6): every LayerNorm of the backbone (norm1, norm2, norm_q/k/v, scale{n}_norm) takes it
EPS = 1e-6


def _variant(model: dict) -> dict:
    if model["backbone_name"] != "mvit":
        raise NotImplementedError(f"backbone {model['backbone_name']!r}: the MViT reference holds MViTv2-B")
    return MVIT_B


def schedule(model: dict) -> List[dict]:
    """Each block's (dim, dim_out, heads, stride_q, stride_kv, window, residual), from
    Detectron2's ``MViT.__init__`` stage loop: the last block of stages 2 and 3 doubles its kv stride
    and, with the last of stage 4, attends globally; the first block of a stage pools q
    by 2; after the last block of a stage the width and heads double and the kv stride
    halves, and after the first block of a stage the window halves."""
    v = _variant(model)
    lbi = v["last_block_indexes"]
    dim = dim_out = v["embed_dim"]
    heads, stride_kv, window = v["num_heads"], v["adaptive_kv_stride"], v["adaptive_window_size"]
    blocks = []
    for i in range(v["depth"]):
        blocks.append(dict(dim=dim, dim_out=dim_out, heads=heads, stride_q=2 if i - 1 in lbi else 1,
                           stride_kv=stride_kv * 2 if i in (lbi[1], lbi[2]) else stride_kv,
                           window=0 if i in lbi[1:] else window, residual=v["residual_pooling"]))
        dim = dim_out
        if i in lbi:
            dim_out, heads, stride_kv = dim_out * 2, heads * 2, max(stride_kv // 2, 1)
        if i - 1 in lbi:
            window //= 2
    return blocks


def _ln(P, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], EPS)


def _pool(P, pre: str, t: str, x: torch.Tensor, stride: int, q) -> torch.Tensor:
    """(heads, H, W, d) through ``t``'s 3×3 depthwise conv (padding 1) and its LayerNorm."""
    y = F.conv2d(q(x.permute(0, 3, 1, 2)), q(P[f"{pre}.pool_{t}.weight"]), stride=stride, padding=1, groups=x.shape[-1])
    return _ln(P, f"{pre}.norm_{t}", y.permute(0, 2, 3, 1))


def _windows(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(n, H, W, d) zero-padded at the bottom and right to whole ws×ws windows →
    (n·windows, ws·ws, d)."""
    n, h, w, d = x.shape
    x = F.pad(x, (0, 0, 0, -w % ws, 0, -h % ws))
    hp, wp = x.shape[1:3]
    return x.view(n, hp // ws, ws, wp // ws, ws, d).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, d)


def _unwindow(x: torch.Tensor, ws: int, n: int, h: int, w: int) -> torch.Tensor:
    """Inverse of ``_windows``, cropped to (n, h, w, d)."""
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    x = x.view(n, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5).reshape(n, hp, wp, -1)
    return x[:, :h, :w]


def rel_pos(table: torch.Tensor, q_size: int, k_size: int) -> torch.Tensor:
    """Detectron2's ``get_rel_pos``: the (L, d) table resampled linearly to 2·max(q, k) − 1
    entries, gathered at the relative coordinates, the shorter side scaled → (q, k, d)."""
    length = 2 * max(q_size, k_size) - 1
    if table.shape[0] != length:
        table = F.interpolate(table.T[None], size=length, mode="linear", align_corners=False)[0].T
    q_coords = torch.arange(q_size, device=table.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=table.device)[None, :] * max(q_size / k_size, 1.0)
    return table[((q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)).long()]


def _attention(P, pre: str, x: torch.Tensor, b: dict, q) -> torch.Tensor:
    """Multi-scale attention of (1, H, W, dim) → (1, H', W', dim_out)."""
    _, h, w, _ = x.shape
    heads = b["heads"]
    d = b["dim_out"] // heads
    qkv = _linear(P, pre + ".qkv", x, q).view(h, w, 3, heads, d).permute(2, 3, 0, 1, 4)  # (3, heads, H, W, d)
    qh = _pool(P, pre, "q", qkv[0], b["stride_q"], q)
    kh = _pool(P, pre, "k", qkv[1], b["stride_kv"], q)
    vh = _pool(P, pre, "v", qkv[2], b["stride_kv"], q)
    (qy, qx), (ky, kx) = qh.shape[1:3], kh.shape[1:3]
    if b["window"]:
        q_ws, kv_ws = b["window"] // b["stride_q"], b["window"] // b["stride_kv"]
        qw, kw, vw = _windows(qh, q_ws), _windows(kh, kv_ws), _windows(vh, kv_ws)
        q_hw, kv_hw = (q_ws, q_ws), (kv_ws, kv_ws)
    else:
        qw, kw, vw = qh.flatten(1, 2), kh.flatten(1, 2), vh.flatten(1, 2)
        q_hw, kv_hw = (qy, qx), (ky, kx)
    s = q(qw * d**-0.5) @ q(kw).transpose(-2, -1)
    r_q = q(qw.reshape(-1, *q_hw, d))
    rel_h = torch.einsum("nhwc,hkc->nhwk", r_q, q(rel_pos(P[pre + ".rel_pos_h"], q_hw[0], kv_hw[0])))
    rel_w = torch.einsum("nhwc,wkc->nhwk", r_q, q(rel_pos(P[pre + ".rel_pos_w"], q_hw[1], kv_hw[1])))
    s = (s.view(-1, *q_hw, *kv_hw) + rel_h[..., None] + rel_w[..., None, :]).view(s.shape)
    out = q(s.softmax(-1)) @ q(vw)
    if b["window"]:
        out = _unwindow(out, q_hw[0], heads, qy, qx)
    out = out.reshape(heads, qy, qx, d)
    if b["residual"]:
        out = out + qh
    return _linear(P, pre + ".proj", out.permute(1, 2, 0, 3).reshape(1, qy, qx, heads * d), q)


def _block(P, pre: str, x: torch.Tensor, b: dict, q) -> torch.Tensor:
    y = _ln(P, pre + ".norm1", x)
    out = _attention(P, pre + ".attn", y, b, q)
    if b["dim"] != b["dim_out"]:
        x = _linear(P, pre + ".proj", y, q)
    if b["stride_q"] > 1:
        k = b["stride_q"] + 1
        x = F.max_pool2d(x.permute(0, 3, 1, 2), k, b["stride_q"], k // 2).permute(0, 2, 3, 1)
    x = x + out
    return x + _linear(P, pre + ".mlp.fc2", F.gelu(_linear(P, pre + ".mlp.fc1", _ln(P, pre + ".norm2", x), q)), q)


def features(P, model: dict, x: torch.Tensor, q) -> Dict[str, torch.Tensor]:
    """(1, H, W, 3) normalised image → {scale2..scale5} NCHW fp32 maps."""
    lbi = _variant(model)["last_block_indexes"]
    _, stride, pad = PATCH
    x = _conv(P, "backbone.patch_embed.proj", x.permute(0, 3, 1, 2), stride=stride, padding=pad, q=q)
    x = x.permute(0, 2, 3, 1)
    outs = {}
    for i, b in enumerate(schedule(model)):
        x = _block(P, f"backbone.blocks.{i}", x, b, q)
        if i in lbi:
            name = f"scale{lbi.index(i) + 2}"
            outs[name] = _ln(P, f"backbone.{name}_norm", x).permute(0, 3, 1, 2)
    return outs


def _out(size: int, k: int, s: int, pad: int) -> int:
    return (size + 2 * pad - k) // s + 1


def _shapes(model: dict, h: int, w: int):
    """Per block on an (h, w) image, with its schedule: the input map (H, W), the pooled q
    and kv maps, and the attention's (calls, q tokens, kv tokens, q_hw, kv_hw) with padded
    windows counted whole."""
    k, stride, pad = PATCH
    hh, ww = _out(h, k, stride, pad), _out(w, k, stride, pad)
    pk = _variant(model)["pool_kernel"]
    out = []
    for b in schedule(model):
        qy, qx = _out(hh, pk, b["stride_q"], pk // 2), _out(ww, pk, b["stride_q"], pk // 2)
        ky, kx = _out(hh, pk, b["stride_kv"], pk // 2), _out(ww, pk, b["stride_kv"], pk // 2)
        if b["window"]:
            q_ws, kv_ws = b["window"] // b["stride_q"], b["window"] // b["stride_kv"]
            windows = -(-qy // q_ws) * -(-qx // q_ws)
            q_hw, kv_hw = (q_ws, q_ws), (kv_ws, kv_ws)
        else:
            windows, q_hw, kv_hw = 1, (qy, qx), (ky, kx)
        calls = windows * b["heads"]
        out.append((b, (hh, ww), (qy, qx), (ky, kx), (calls, q_hw[0] * q_hw[1], kv_hw[0] * kv_hw[1], q_hw, kv_hw)))
        hh, ww = qy, qx
    return out


def _core_flops(calls: int, nq: int, nk: int, q_hw, kv_hw, d: int) -> int:
    """q·kᵀ and p·v, and the two relative-position products."""
    return 4 * calls * nq * nk * d + 2 * calls * nq * (kv_hw[0] + kv_hw[1]) * d


def flops(model: dict, h: int, w: int) -> Tuple[int, Dict[str, Tuple[int, int]]]:
    """Operations of the backbone on an (h, w) padded image, as ``FlopCounterMode``
    counts them on ``features``, and each map's (channels, hw)."""
    v = _variant(model)
    k, stride, pad = PATCH
    hh, ww = _out(h, k, stride, pad), _out(w, k, stride, pad)
    total = 2 * hh * ww * v["embed_dim"] * 3 * k * k
    feats, lbi = {}, v["last_block_indexes"]
    for i, (b, (ih, iw), (qy, qx), (ky, kx), (calls, nq, nk, q_hw, kv_hw)) in enumerate(_shapes(model, h, w)):
        n_in, n_q, n_k = ih * iw, qy * qx, ky * kx
        dim, dim_out = b["dim"], b["dim_out"]
        hidden = v["mlp_ratio"] * dim_out
        pk2 = v["pool_kernel"] ** 2
        total += (2 * n_in * dim * 3 * dim_out  # qkv
                  + 2 * pk2 * dim_out * (n_q + 2 * n_k)  # the depthwise pools of q, k and v
                  + _core_flops(calls, nq, nk, q_hw, kv_hw, dim_out // b["heads"])
                  + 2 * n_q * dim_out * dim_out  # proj
                  + (2 * n_in * dim * dim_out if dim != dim_out else 0)  # the skip's projection
                  + 4 * n_q * dim_out * hidden)  # fc1, fc2
        if i in lbi:
            feats[f"scale{lbi.index(i) + 2}"] = (dim_out, n_q)
    return total, feats


def attention_work(model: dict, h: int, w: int, batch: int) -> Tuple[int, int]:
    """(operations, bytes) of every attention core of one request of ``batch`` (h, w)
    padded images: q·kᵀ, p·v and the two relative-position products, with padded windows
    counted as computed; q, k, v read and the output written once in bf16."""
    work = nbytes = 0
    for b, _, _, _, (calls, nq, nk, q_hw, kv_hw) in _shapes(model, h, w):
        d = b["dim_out"] // b["heads"]
        work += _core_flops(calls, nq, nk, q_hw, kv_hw, d)
        nbytes += 2 * (2 * calls * nq * d + 2 * calls * nk * d)
    return batch * work, batch * nbytes
