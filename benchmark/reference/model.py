"""Plain PyTorch reference of the served models: Swin or ResNet-50, the MSDeformAttn
pixel decoder, the masked-attention decoder and the RbA score.

Written from the published descriptions (Swin Transformer, Deformable DETR's
multi-scale deformable attention through ``F.grid_sample``, Mask2Former's masked
decoder, RbA's -sum tanh score) with plain ``torch`` operations, in fp32, one image at
a time.  It reads the model's sizes from the configuration file's ``model`` object and
its weights from a dict of tensors keyed by parameter name; it imports nothing of the
program under test.

Departures from the published code, each exact in real arithmetic: the attention
masks of the decoder's layers are taken from the mask features resized to the
level's size and then multiplied by the mask embeddings (bilinear resizing is linear,
so it commutes with the product); a row whose mask blocks every key is unmasked, as
Mask2Former does.

``lowp=True`` is the control: the backbone's matmul and conv operands rounded to fp8
(e4m3, one scale per tensor), the step below its bf16, and every other fp32 matmul
allowed TF32, the step below fp32 with TF32 off.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 with one scale per tensor, returned in fp32."""
    scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


@contextlib.contextmanager
def _matmul_precision(tf32: bool):
    """TF32 on or off for every fp32 matmul and conv inside."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _linear(P: Weights, name: str, x: torch.Tensor, q=_same) -> torch.Tensor:
    return F.linear(q(x), q(P[name + ".weight"]), P.get(name + ".bias"))


def _ln(P: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], 1e-5)


def _gn(P: Weights, name: str, x: torch.Tensor) -> torch.Tensor:  # NCHW
    return F.group_norm(x, 32, P[name + ".weight"], P[name + ".bias"], 1e-5)


def _conv(P: Weights, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0, q=_same) -> torch.Tensor:
    return F.conv2d(q(x), q(P[name + ".weight"]), P.get(name + ".bias"), stride=stride, padding=padding)


def sine_position(h: int, w: int, num_pos_feats: int, device) -> torch.Tensor:
    """DETR's normalised sine embedding of an all-valid (h, w) map: (1, 2F, h, w)."""
    not_mask = torch.ones((1, h, w), device=device)
    y = not_mask.cumsum(1)
    x = not_mask.cumsum(2)
    y = y / (y[:, -1:, :] + 1e-6) * (2 * math.pi)
    x = x / (x[:, :, -1:] + 1e-6) * (2 * math.pi)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2 * (dim_t // 2) / num_pos_feats)
    px, py = x[..., None] / dim_t, y[..., None] / dim_t
    px = torch.stack((px[..., 0::2].sin(), px[..., 1::2].cos()), dim=4).flatten(3)
    py = torch.stack((py[..., 0::2].sin(), py[..., 1::2].cos()), dim=4).flatten(3)
    return torch.cat((py, px), dim=3).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Swin Transformer
# ---------------------------------------------------------------------------

def _relative_index(ws: int, device) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).to(device)


def _partition(x: torch.Tensor, ws: int) -> torch.Tensor:  # (B, H, W, C) -> (B·nW, ws², C)
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _reverse(x: torch.Tensor, ws: int, b: int, h: int, w: int) -> torch.Tensor:
    x = x.view(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def _shift_mask(hp: int, wp: int, ws: int, shift: int, device) -> torch.Tensor:
    """(nW, ws², ws²) additive mask (0 / -100) of the shifted windows."""
    img = torch.zeros((1, hp, wp, 1), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = _partition(img, ws).squeeze(-1)
    diff = mw[:, None, :] - mw[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def _swin_block(P: Weights, pre: str, x: torch.Tensor, nh: int, ws: int, shift: int, q) -> torch.Tensor:
    b, h, w, c = x.shape
    y = _ln(P, pre + ".norm1", x)
    pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
    y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = h + pad_b, w + pad_r
    if shift:
        y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
    win = _partition(y, ws)
    n = ws * ws
    qkv = _linear(P, pre + ".attn.qkv", win, q).reshape(-1, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
    qh, kh, vh = qkv[0], qkv[1], qkv[2]
    attn = q(qh * (c // nh) ** -0.5) @ q(kh).transpose(-2, -1)
    table = P[pre + ".attn.relative_position_bias_table"]
    attn = attn + table[_relative_index(ws, x.device).reshape(-1)].reshape(n, n, nh).permute(2, 0, 1)
    if shift:
        mask = _shift_mask(hp, wp, ws, shift, x.device)
        attn = (attn.view(b, mask.shape[0], nh, n, n) + mask[None, :, None]).view(-1, nh, n, n)
    out = (q(attn.softmax(dim=-1)) @ q(vh)).transpose(1, 2).reshape(-1, n, c)
    y = _reverse(_linear(P, pre + ".attn.proj", out, q), ws, b, hp, wp)
    if shift:
        y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
    x = x + y[:, :h, :w]
    mlp = F.gelu(_linear(P, pre + ".mlp.fc1", _ln(P, pre + ".norm2", x), q))
    return x + _linear(P, pre + ".mlp.fc2", mlp, q)


def swin(P: Weights, sw: dict, x: torch.Tensor, q=_same) -> Dict[str, torch.Tensor]:
    """(1, H, W, 3) normalised image → {res2..res5} NCHW fp32 maps."""
    if sw["ape"]:
        raise NotImplementedError("the reference has no absolute position table")
    p, ws = sw["patch_size"], sw["window_size"]
    x = F.pad(x, (0, 0, 0, (p - x.shape[2] % p) % p, 0, (p - x.shape[1] % p) % p))
    x = _conv(P, "backbone.patch_embed.proj", x.permute(0, 3, 1, 2), stride=p, q=q).permute(0, 2, 3, 1)
    if sw["patch_norm"]:
        x = _ln(P, "backbone.patch_embed.norm", x)
    outs = {}
    for i, depth in enumerate(sw["depths"]):
        for j in range(depth):
            x = _swin_block(P, f"backbone.layers.{i}.blocks.{j}", x, sw["num_heads"][i], ws,
                            0 if j % 2 == 0 else ws // 2, q)
        if f"res{i + 2}" in sw["out_features"]:
            outs[f"res{i + 2}"] = _ln(P, f"backbone.norm{i}", x).permute(0, 3, 1, 2)
        if i < len(sw["depths"]) - 1:
            x = F.pad(x, (0, 0, 0, x.shape[2] % 2, 0, x.shape[1] % 2))
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
            pre = f"backbone.layers.{i}.downsample"
            x = _linear(P, pre + ".reduction", _ln(P, pre + ".norm", x), q)
    return outs


# ---------------------------------------------------------------------------
# ResNet (Detectron2's bottleneck ResNet with frozen batch norms)
# ---------------------------------------------------------------------------

RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _frozen_bn(P: Weights, name: str, x: torch.Tensor) -> torch.Tensor:  # NCHW
    scale = P[name + ".weight"] * torch.rsqrt(P[name + ".var"] + 1e-5)
    shift = P[name + ".bias"] - P[name + ".mean"] * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def resnet(P: Weights, rn: dict, x: torch.Tensor, q=_same) -> Dict[str, torch.Tensor]:
    """(1, H, W, 3) normalised image → {res2..res5} NCHW fp32 maps."""
    x = _frozen_bn(P, "backbone.stem.norm1", _conv(P, "backbone.stem.conv1", x.permute(0, 3, 1, 2), 2, 3, q))
    x = F.max_pool2d(F.relu(x), 3, 2, 1)
    outs = {}
    for stage, n_blocks in enumerate(RESNET_BLOCKS[rn["depth"]]):
        name = f"res{stage + 2}"
        for b in range(n_blocks):
            pre = f"backbone.{name}.{b}"
            stride = 2 if stage > 0 and b == 0 else 1
            s1, s2 = (stride, 1) if rn["stride_in_1x1"] else (1, stride)
            short = x
            if b == 0:
                short = _frozen_bn(P, pre + ".shortcut_norm", _conv(P, pre + ".shortcut", x, stride, q=q))
            y = F.relu(_frozen_bn(P, pre + ".norm1", _conv(P, pre + ".conv1", x, s1, q=q)))
            y = F.relu(_frozen_bn(P, pre + ".norm2", _conv(P, pre + ".conv2", y, s2, 1, q=q)))
            x = F.relu(short + _frozen_bn(P, pre + ".norm3", _conv(P, pre + ".conv3", y, q=q)))
        if name in rn["out_features"]:
            outs[name] = x
    return outs


# ---------------------------------------------------------------------------
# MSDeformAttn pixel decoder (Deformable DETR encoder + FPN), NCHW
# ---------------------------------------------------------------------------

def deform_attn_core(value: torch.Tensor, shapes: List[Tuple[int, int]], loc: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """value (N, S, M, D); loc (N, Lq, M, L, P, 2) in [0, 1]; weights (N, Lq, M, L, P)
    → (N, Lq, M·D): bilinear samples with zero padding, weighted and summed."""
    n, _, m, d = value.shape
    _, lq, _, nl, p, _ = loc.shape
    grids = 2 * loc - 1
    samples = []
    for lid, v in enumerate(value.split([h * w for h, w in shapes], dim=1)):
        h, w = shapes[lid]
        v = v.flatten(2).transpose(1, 2).reshape(n * m, d, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)  # (N·M, Lq, P, 2)
        samples.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False))
    aw = weights.transpose(1, 2).reshape(n * m, 1, lq, nl * p)
    out = (torch.stack(samples, dim=-2).flatten(-2) * aw).sum(-1).view(n, m * d, lq)
    return out.transpose(1, 2)


def _encoder_layer(P: Weights, pre: str, src, pos, ref, shapes, heads: int, points: int) -> torch.Tensor:
    n, lq, c = src.shape
    nl = len(shapes)
    query = src + pos
    value = _linear(P, pre + ".self_attn.value_proj", src).view(n, lq, heads, c // heads)
    off = _linear(P, pre + ".self_attn.sampling_offsets", query).view(n, lq, heads, nl, points, 2)
    aw = _linear(P, pre + ".self_attn.attention_weights", query).view(n, lq, heads, nl * points)
    aw = aw.softmax(-1).view(n, lq, heads, nl, points)
    normalizer = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=src.device)
    loc = ref[:, :, None, :, None, :] + off / normalizer[None, None, None, :, None, :]
    attn = _linear(P, pre + ".self_attn.output_proj", deform_attn_core(value, shapes, loc, aw))
    src = _ln(P, pre + ".norm1", src + attn)
    ffn = _linear(P, pre + ".linear2", F.relu(_linear(P, pre + ".linear1", src)))
    return _ln(P, pre + ".norm2", src + ffn)


def pixel_decoder(P: Weights, pd: dict, feats: Dict[str, torch.Tensor]):
    """(mask features (1, C, H/4, W/4), the encoder's maps lowest resolution first)."""
    pre = "sem_seg_head.pixel_decoder"
    srcs, poss, shapes = [], [], []
    for i, f in enumerate(pd["transformer_in_features"][::-1]):
        y = _gn(P, f"{pre}.input_proj.{i}.gn", _conv(P, f"{pre}.input_proj.{i}.conv", feats[f]))
        h, w = y.shape[-2:]
        pos = sine_position(h, w, y.shape[1] // 2, y.device) + P[f"{pre}.transformer.level_embed"][i][None, :, None, None]
        srcs.append(y.flatten(2).transpose(1, 2))
        poss.append(pos.flatten(2).transpose(1, 2))
        shapes.append((h, w))
    src, pos = torch.cat(srcs, 1), torch.cat(poss, 1)
    refs = []
    for h, w in shapes:
        ys, xs = torch.meshgrid(torch.linspace(0.5, h - 0.5, h, device=src.device) / h,
                                torch.linspace(0.5, w - 0.5, w, device=src.device) / w, indexing="ij")
        refs.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1))
    ref = torch.cat(refs, 0)[None, :, None, :].expand(1, -1, len(shapes), -1)
    for k in range(pd["transformer_enc_layers"]):
        src = _encoder_layer(P, f"{pre}.transformer.encoder.layers.{k}", src, pos, ref, shapes,
                             pd["transformer_nheads"], pd["enc_n_points"])
    out, start = [], 0
    for h, w in shapes:
        out.append(src[:, start:start + h * w].transpose(1, 2).reshape(1, -1, h, w))
        start += h * w
    n_fpn = len(pd["in_features"]) - len(pd["transformer_in_features"])
    for j in reversed(range(n_fpn)):
        f = pd["in_features"][j]
        lat = _gn(P, f"{pre}.fpn.{j}.lateral.gn", _conv(P, f"{pre}.fpn.{j}.lateral.conv", feats[f]))
        y = lat + F.interpolate(out[-1], size=lat.shape[-2:], mode="bilinear", align_corners=False)
        out.append(F.relu(_gn(P, f"{pre}.fpn.{j}.output.gn", _conv(P, f"{pre}.fpn.{j}.output.conv", y, padding=1))))
    return _conv(P, f"{pre}.mask_features", out[-1]), out[: len(shapes)]


# ---------------------------------------------------------------------------
# Mask2Former's masked-attention decoder (inference) and the RbA score
# ---------------------------------------------------------------------------

def _attention(P: Weights, name: str, query, key, value, heads: int, mask=None) -> torch.Tensor:
    """nn.MultiheadAttention's function, batch first, with an additive mask."""
    c = query.shape[-1]
    w, b = P[name + ".in_proj.weight"], P[name + ".in_proj.bias"]
    qh = F.linear(query, w[:c], b[:c]).unflatten(-1, (heads, c // heads)).transpose(1, 2)
    kh = F.linear(key, w[c:2 * c], b[c:2 * c]).unflatten(-1, (heads, c // heads)).transpose(1, 2)
    vh = F.linear(value, w[2 * c:], b[2 * c:]).unflatten(-1, (heads, c // heads)).transpose(1, 2)
    s = (qh * (c // heads) ** -0.5) @ kh.transpose(-2, -1)
    if mask is not None:
        s = s + mask
    out = (s.softmax(-1) @ vh).transpose(1, 2).flatten(2)
    return _linear(P, name + ".out_proj", out)


def _mask_embed(P: Weights, pre: str, x: torch.Tensor) -> torch.Tensor:
    for i in range(3):
        x = _linear(P, f"{pre}.mask_embed.layers.{i}", x)
        x = F.relu(x) if i < 2 else x
    return x


def _attn_mask(P: Weights, pre: str, output, mf_small: torch.Tensor) -> torch.Tensor:
    me = _mask_embed(P, pre, _ln(P, pre + ".decoder_norm", output))
    blocked = (torch.einsum("bqc,bchw->bqhw", me, mf_small).sigmoid() < 0.5).flatten(2)
    blocked = blocked & ~blocked.all(-1, keepdim=True)
    return torch.zeros(blocked.shape, device=output.device).masked_fill(blocked, float("-inf"))[:, None]


def decoder(P: Weights, d: dict, feats: List[torch.Tensor], mask_features: torch.Tensor):
    """(class logits (1, Q, K+1), mask logits (1, Q, H/4, W/4))."""
    pre = "sem_seg_head.predictor"
    c, heads, nl = d["hidden_dim"], d["nheads"], d["num_feature_levels"]
    srcs, poss, sizes = [], [], []
    for i in range(nl):
        f = feats[i]
        if pre + f".input_proj.{i}.weight" in P:
            f = _conv(P, f"{pre}.input_proj.{i}", f)
        h, w = f.shape[-2:]
        sizes.append((h, w))
        poss.append(sine_position(h, w, c // 2, f.device).flatten(2).transpose(1, 2))
        srcs.append(f.flatten(2).transpose(1, 2) + P[pre + ".level_embed"][i])
    qe = P[pre + ".query_embed"][None]
    output = P[pre + ".query_feat"][None]

    def small(hw):
        return F.interpolate(mask_features, size=hw, mode="bilinear", align_corners=False)

    mask = _attn_mask(P, pre, output, small(sizes[0]))
    for i in range(d["dec_layers"]):
        lvl = i % nl
        y = _attention(P, f"{pre}.cross_layers.{i}.attn", output + qe, srcs[lvl] + poss[lvl], srcs[lvl], heads, mask)
        output = _ln(P, f"{pre}.cross_layers.{i}.norm", output + y)
        qk = output + qe
        output = _ln(P, f"{pre}.self_layers.{i}.norm", output + _attention(P, f"{pre}.self_layers.{i}.attn", qk, qk,
                                                                           output, heads))
        ffn = _linear(P, f"{pre}.ffn_layers.{i}.linear2", F.relu(_linear(P, f"{pre}.ffn_layers.{i}.linear1", output)))
        output = _ln(P, f"{pre}.ffn_layers.{i}.norm", output + ffn)
        if i < d["dec_layers"] - 1:
            mask = _attn_mask(P, pre, output, small(sizes[(i + 1) % nl]))
    dec = _ln(P, pre + ".decoder_norm", output)
    cls = _linear(P, pre + ".class_embed", dec)
    masks = torch.einsum("bqc,bchw->bqhw", _mask_embed(P, pre, dec), mask_features)
    return cls, masks


def rba_score(cls: torch.Tensor, masks: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """RbA: -sum_k tanh(sum_q softmax(cls)_qk · sigmoid(mask_q)) on the masks upsampled to
    the padded image and cropped to ``hw``: (1, h, w)."""
    up = F.interpolate(masks, size=(masks.shape[-2] * 4, masks.shape[-1] * 4), mode="bilinear", align_corners=False)
    up = up[..., : hw[0], : hw[1]]
    sem = torch.einsum("bqk,bqhw->bkhw", cls.softmax(-1)[..., :-1], up.sigmoid())
    return -torch.tanh(sem).sum(1)


def preprocess(model: dict, image: torch.Tensor) -> torch.Tensor:
    """(1, H, W, 3) uint8 → normalised fp32, zero-padded at the bottom and right."""
    inp = model["input"]
    x = (image.float() - torch.tensor(inp["pixel_mean"], device=image.device)) / torch.tensor(
        inp["pixel_std"], device=image.device)
    div = inp["size_divisibility"]
    if div > 0:
        x = F.pad(x, (0, 0, 0, (div - x.shape[2] % div) % div, 0, (div - x.shape[1] % div) % div))
    return x


@torch.no_grad()
def score_map(P: Weights, model: dict, image: torch.Tensor, lowp: bool = False, backbone=None) -> torch.Tensor:
    """The RbA score map (h, w) of one (h, w, 3) uint8 image, in fp32 with TF32 off (or,
    with ``lowp``, the control's precision).  The backbone is ``backbone``'s ``features``
    where a backbone file is given (``reference/__init__.py``), else Swin or ResNet."""
    if backbone is None and model["backbone_name"] not in ("swin", "resnet"):
        raise NotImplementedError(f"backbone {model['backbone_name']!r}: the configuration names no reference_backbone")
    q = _fp8 if lowp else _same
    with _matmul_precision(tf32=lowp):
        x = preprocess(model, image[None])
        if backbone is not None:
            feats = backbone.features(P, model, x, q)
        elif model["backbone_name"] == "swin":
            feats = swin(P, model["swin"], x, q)
        else:
            feats = resnet(P, model["resnet"], x, q)
        mask_features, ms = pixel_decoder(P, model["pixel_decoder"], feats)
        cls, masks = decoder(P, model["decoder"], ms[: model["decoder"]["num_feature_levels"]], mask_features)
        return rba_score(cls, masks, image.shape[:2])[0]
