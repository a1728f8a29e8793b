"""Work counts from the configuration's shapes: the operations of one image, and the
operations and bytes of the two hand kernels the roofline metrics time.

The count follows the architecture, not the program: every matmul, convolution and
attention product, two operations per multiply-add, as ``FlopCounterMode`` counts
them on the plain reference (``reference/model.py``).  Elementwise work, norms,
softmaxes, resizes and the deformable sampling's bilinear taps are not counted.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
# an fp32-accurate product on the tensor cores takes three TF32 products of split operands
PEAK_SPLIT_TF32_FLOPS = PEAK_TF32_FLOPS / 3

BYTES = {"bfloat16": 2, "float32": 4}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def padded_hw(model: dict, h: int, w: int) -> Tuple[int, int]:
    div = model["input"]["size_divisibility"]
    return (_ceil(h, div) * div, _ceil(w, div) * div) if div > 0 else (h, w)


def swin_stages(sw: dict, h: int, w: int) -> List[dict]:
    """Per stage: tokens (h, w), the windows' padded (hp, wp), channels C, heads."""
    out = []
    th, tw = _ceil(h, sw["patch_size"]), _ceil(w, sw["patch_size"])
    ws = sw["window_size"]
    for i, depth in enumerate(sw["depths"]):
        c = sw["embed_dim"] * 2**i
        out.append(dict(h=th, w=tw, hp=_ceil(th, ws) * ws, wp=_ceil(tw, ws) * ws, c=c, heads=sw["num_heads"][i],
                        depth=depth, hidden=int(c * sw["mlp_ratio"])))
        th, tw = _ceil(th, 2), _ceil(tw, 2)
    return out


def swin_flops(sw: dict, h: int, w: int) -> Tuple[int, Dict[str, Tuple[int, int]]]:
    """Operations of the Swin backbone on an (h, w) image, and each output's (channels, hw)."""
    p = sw["patch_size"]
    stages = swin_stages(sw, h, w)
    flops = 2 * sw["embed_dim"] * 3 * p * p * stages[0]["h"] * stages[0]["w"]
    feats = {}
    for i, s in enumerate(stages):
        t, tp, c, n = s["h"] * s["w"], s["hp"] * s["wp"], s["c"], sw["window_size"] ** 2
        per_block = (2 * tp * c * 3 * c  # qkv, on the padded windows
                     + 4 * tp * n * c  # q·kᵀ and p·v over every window and head
                     + 2 * tp * c * c  # proj
                     + 4 * t * c * s["hidden"])  # fc1, fc2
        flops += s["depth"] * per_block
        feats[f"res{i + 2}"] = (c, s["h"] * s["w"])
        if i < len(stages) - 1:
            flops += 2 * _ceil(s["h"], 2) * _ceil(s["w"], 2) * 4 * c * 2 * c  # patch merging
    return flops, feats


RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def resnet_flops(rn: dict, h: int, w: int) -> Tuple[int, Dict[str, Tuple[int, int]]]:
    def out(size, k, s, pad):
        return (size + 2 * pad - k) // s + 1

    stem = rn["stem_out_channels"]
    h1, w1 = out(h, 7, 2, 3), out(w, 7, 2, 3)
    flops = 2 * stem * 3 * 49 * h1 * w1
    hh, ww = out(h1, 3, 2, 1), out(w1, 3, 2, 1)
    c_in, feats = stem, {}
    for stage, n_blocks in enumerate(RESNET_BLOCKS[rn["depth"]]):
        mid, c_out = 64 * 2**stage, 256 * 2**stage
        for b in range(n_blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            h2, w2 = out(hh, 1, stride, 0), out(ww, 1, stride, 0)
            s1 = stride if rn["stride_in_1x1"] else 1
            h_mid, w_mid = out(hh, 1, s1, 0), out(ww, 1, s1, 0)
            flops += 2 * mid * c_in * h_mid * w_mid + 2 * mid * mid * 9 * h2 * w2 + 2 * c_out * mid * h2 * w2
            if b == 0:
                flops += 2 * c_out * c_in * h2 * w2
            c_in, hh, ww = c_out, h2, w2
        feats[f"res{stage + 2}"] = (c_out, hh * ww)
    return flops, feats


def pixel_decoder_flops(pd: dict, feats: Dict[str, Tuple[int, int]]) -> int:
    """Operations of the pixel decoder on the backbone's maps, each given as (channels, hw)."""
    c, tin = pd["conv_dim"], pd["transformer_in_features"]
    flops = sum(2 * feats[f][0] * c * feats[f][1] for f in tin)  # input projections
    lq = sum(feats[f][1] for f in tin)
    nl, heads, points = len(tin), pd["transformer_nheads"], pd["enc_n_points"]
    per_layer = 2 * lq * c * (c + heads * nl * points * 3 + c) + 4 * lq * c * pd["transformer_dim_feedforward"]
    flops += pd["transformer_enc_layers"] * per_layer
    for f in pd["in_features"][: len(pd["in_features"]) - len(tin)]:
        n = feats[f][1]
        flops += 2 * feats[f][0] * c * n + 2 * c * c * 9 * n  # lateral 1x1, output 3x3
    return flops + 2 * c * pd["mask_dim"] * feats[pd["in_features"][0]][1]  # mask features


def decoder_flops(d: dict, num_classes: int, level_hw: List[int], mask_hw: int) -> int:
    c, q, ff, md = d["hidden_dim"], d["num_queries"], d["dim_feedforward"], d["mask_dim"]
    head = 2 * q * c * (2 * c + md)  # the mask-embedding MLP
    flops = head + 2 * q * md * level_hw[0]  # the first attention mask
    for i in range(d["dec_layers"]):
        n = level_hw[i % len(level_hw)]
        flops += 2 * q * c * c * 2 + 2 * n * c * c * 2 + 4 * q * n * c  # cross: q, out; k, v; scores, p·v
        flops += 2 * q * c * c * 4 + 4 * q * q * c  # self: q, k, v, out; scores, p·v
        flops += 4 * q * c * ff
        if i < d["dec_layers"] - 1:
            flops += head + 2 * q * md * level_hw[(i + 1) % len(level_hw)]
    return flops + 2 * q * c * (num_classes + 1) + head + 2 * q * md * mask_hw


def image_flops(model: dict, h: int, w: int, backbone=None) -> int:
    """Operations of one (h, w) image through the model and the RbA score; the backbone's
    are ``backbone``'s ``flops`` where a backbone file is given (``reference/__init__.py``)."""
    hp, wp = padded_hw(model, h, w)
    if backbone is not None:
        flops, feats = backbone.flops(model, hp, wp)
    elif model["backbone_name"] == "swin":
        flops, feats = swin_flops(model["swin"], hp, wp)
    elif model["backbone_name"] == "resnet":
        flops, feats = resnet_flops(model["resnet"], hp, wp)
    else:
        raise NotImplementedError(model["backbone_name"])
    pd, d = model["pixel_decoder"], model["decoder"]
    flops += pixel_decoder_flops(pd, feats)
    levels = [feats[f][1] for f in pd["transformer_in_features"][::-1]][: d["num_feature_levels"]]
    mask_hw = feats[pd["in_features"][0]][1]
    flops += decoder_flops(d, model["num_classes"], levels, mask_hw)
    return flops + 2 * d["num_queries"] * model["num_classes"] * h * w  # the score's class contraction


def window_attention_work(model: dict, h: int, w: int, batch: int) -> Tuple[float, float]:
    """(operations, bytes) of every window-attention call of one request: q·kᵀ and p·v;
    qkv read and the output written once in the compute dtype, the fp32 bias table and,
    in a shifted block, the fp32 mask read once."""
    sw = model["swin"]
    el = BYTES[model["compute_dtype"]]
    n = sw["window_size"] ** 2
    hp, wp = padded_hw(model, h, w)
    flops = nbytes = 0.0
    for s in swin_stages(sw, hp, wp):
        windows = (s["hp"] // sw["window_size"]) * (s["wp"] // sw["window_size"])
        tokens = batch * s["hp"] * s["wp"]
        for j in range(s["depth"]):
            flops += 4 * tokens * n * s["c"]
            nbytes += el * tokens * 4 * s["c"] + 4 * s["heads"] * n * n + (4 * windows * n * n if j % 2 else 0)
    return flops, nbytes


def fused_rba_work(model: dict, h: int, w: int, batch: int) -> Tuple[float, float]:
    """(operations, bytes) of the RbA tail of one request: the class contraction at full
    resolution; the fp32 mask logits and class logits read once, the fp32 map written."""
    hp, wp = padded_hw(model, h, w)
    q, k = model["decoder"]["num_queries"], model["num_classes"]
    flops = 2.0 * batch * q * k * hp * wp
    nbytes = 4.0 * batch * (q * (hp // 4) * (wp // 4) + q * (k + 1) + hp * wp)
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the operations at the peak
    rate and the bytes at the HBM bandwidth."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)
