"""ViT and MViT at bf16 against rba_tpu called op by op on the CPU.

- ``test_backbone_bf16_shares``: each output's equal and one-ulp shares recorded, the
  least one-ulp share held at its recorded floor (``tests/test_torch_backbones_bf16.py``).
- ``test_vit_blocks_bf16_given_rba_tpus_input``: where the shares part.  Each op of a
  window block and of a global block with the residual bottleneck, and each whole
  block, given rba_tpu's input, equals rba_tpu's output bit for bit: LayerNorm, the
  qkv and MLP linears, the attention with its relative positions, GELU's steps.  Only
  the convs (the 16×16 patch embed, the bottleneck's 3×3) sum in another order and
  flip about one element in 1e3 by one ulp; with 24 tokens of 64 channels one flipped
  element moves every token through LayerNorm and attention, which is why the whole
  ViT is equal on only a third of its outputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rba_tpu.models import vit as jvit
from rba_tpu.ops import nn as jnn
from rba_tpu_torch.models import vit as tvit
from rba_tpu_torch.models.swin import gelu
from rba_tpu_torch.ops.nn import apply_conv, apply_linear, centered_layer_norm
from tests.test_torch_backbones import VIT_SMALL, _image, family_pair
from tests.test_torch_backbones_bf16 import _t16, bf16_shares_case
from tests.torch_port_common import default_threads, equal_share, record, ulp_share  # noqa: F401

pytestmark = pytest.mark.usefixtures("default_threads")  # the shares' recorded floors


@pytest.mark.parametrize("family", ["vit", "mvit"])
def test_backbone_bf16_shares(family, request):
    bf16_shares_case(family, request)


def test_vit_blocks_bf16_given_rba_tpus_input(request):
    _, params, model, *_ = family_pair("vit")
    p = jax.tree_util.tree_map(jnp.asarray, params)
    cfg = jvit.ViTConfig(**VIT_SMALL)
    x = jnp.asarray(_image((64, 96))).astype(jnp.bfloat16)
    patch = jnn.conv2d(p["patch_embed"]["proj"], x, stride=16, padding="VALID")
    shares = {}
    with torch.no_grad():
        got = apply_conv(model.patch_embed["proj"], _t16(x), stride=16, padding="VALID")
        shares["patch_embed_conv_equal"], shares["patch_embed_conv_ulp"] = equal_share(got, patch), ulp_share(got, patch)
        h = patch + jnp.asarray(np.asarray(tvit.abs_pos_embed(model.pos_embed, (4, 6), True).detach())).astype(
            jnp.bfloat16)
        for i, (jb, tb) in enumerate(zip(p["blocks"], model.blocks)):
            ws = cfg.window_size if i in cfg.window_block_indexes else 0
            ln = jvit._ln(jb["norm1"], h)
            ops = {"norm1": (centered_layer_norm(_t16(h), tb.norm1), ln),
                   "qkv": (apply_linear(tb.attn.qkv, _t16(ln)), jnn.linear(jb["attn"]["qkv"], ln)),
                   "attention": (tvit._attention(tb.attn, _t16(ln), cfg.num_heads),
                                 jvit._attention(jb["attn"], ln, cfg.num_heads, True))}
            fc1 = jnn.linear(jb["mlp"]["fc1"], ln)
            ops["fc1"] = (apply_linear(tb.mlp["fc1"], _t16(ln)), fc1)
            ops["gelu"] = (gelu(_t16(fc1)), jax.nn.gelu(fc1, approximate=False))
            out = jvit._block_apply(jb, h, cfg, ws)
            ops["block"] = (tvit._block_apply(tb, _t16(h), model.cfg, ws), out)
            for name, (a, b) in ops.items():
                shares[f"block{i}_{name}_equal"] = equal_share(a, b)
            h = out
    record(request, **shares)
    assert shares["patch_embed_conv_ulp"] == 1.0 and shares["patch_embed_conv_equal"] >= 0.999
    assert all(v == 1.0 for k, v in shares.items() if k.startswith("block")), shares
