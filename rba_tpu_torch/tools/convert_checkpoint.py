"""Checkpoint conversion CLI of the port (counterpart of ``rba_tpu/tools/convert_checkpoint.py``).

Writes the flat ``params.npz`` that both packages read, from:

- ``d2``: a released Detectron2 ``model_final.pth``/``.pkl``, the whole model;
- ``timm-swin``: a timm Swin ImageNet checkpoint, the backbone (the reference's
  ``tools/convert-pretrained-swin-model-to-d2.py``), to start training from;
- ``torchvision``: a torchvision ResNet ``.pth``, the backbone (the reference's
  ``tools/convert-torchvision-to-d2.py``, then the Detectron2 names).

Usage:
    python -m rba_tpu_torch.tools.convert_checkpoint d2 \\
        --config ckpts/swin_b_1dl/config.yaml \\
        --checkpoint ckpts/swin_b_1dl/model_final.pth --out ckpts/swin_b_1dl/params.npz
    python -m rba_tpu_torch.tools.convert_checkpoint timm-swin \\
        --config ckpts/swin_b_1dl/config.yaml \\
        --checkpoint swin_base_patch4_window12_384_22k.pth --out backbone.npz
    python -m rba_tpu_torch.tools.convert_checkpoint torchvision \\
        --config configs/cityscapes/semantic-segmentation/maskformer2_R101_bs16_90k_1dl_coco_mix.yaml \\
        --checkpoint resnet101-63fe2227.pth --out backbone.npz

``--config`` is a Detectron2 YAML or a native one (``config.load_config``).
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np


def convert_timm_swin(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """A timm Swin state dict (``layers.0.blocks.1.attn.qkv.weight``, …) → the backbone's
    parameter tree.  The classifier (``head.*``), the final ``norm.*`` and the buffers that
    the model regenerates are dropped.  timm has no per-output norms (``norm0``…); each one
    that the backbone has takes the port's init of a norm (``maskformer.init_norm_``: unit
    scale, zero bias), as Detectron2 leaves them at their init."""
    import torch
    from torch import nn

    from ..convert.d2_mapping import convert_swin_backbone
    from ..models.maskformer import init_norm_
    from ..models.swin import Swin

    prefixed = {}
    for k, v in sd.items():
        if k.startswith(("head.", "norm.")):
            continue
        if "attn_mask" in k or "relative_position_index" in k:
            continue
        prefixed["backbone." + k] = np.asarray(v)
    with torch.device("meta"):
        swin = Swin(cfg.swin)
    for i in range(cfg.swin.num_layers):
        if f"backbone.norm{i}.weight" not in prefixed and hasattr(swin, f"norm{i}"):
            norm = init_norm_(nn.LayerNorm(getattr(swin, f"norm{i}").normalized_shape, device="cpu"))
            prefixed[f"backbone.norm{i}.weight"] = norm.weight.detach().numpy()
            prefixed[f"backbone.norm{i}.bias"] = norm.bias.detach().numpy()
    return convert_swin_backbone(prefixed, cfg)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=["d2", "timm-swin", "torchvision"])
    p.add_argument("--config", required=True, help="the model's config YAML")
    p.add_argument("--checkpoint", required=True, help="model_final.pth or .pkl; the timm or torchvision .pth")
    p.add_argument("--out", required=True, help="the params.npz to write")
    args = p.parse_args(argv)

    from ..config import load_config
    from ..convert.checkpoint import convert_d2_checkpoint, read_state_dict
    from ..convert.params import jax_params_to_state, save_params

    cfg = load_config(args.config)
    if args.mode == "d2":
        params = convert_d2_checkpoint(args.checkpoint, cfg, out_path=args.out)
    else:
        sd = read_state_dict(args.checkpoint)
        if args.mode == "torchvision":
            from ..convert.d2_mapping import convert_resnet_backbone, torchvision_resnet_to_d2

            params = convert_resnet_backbone(torchvision_resnet_to_d2(sd), cfg)
        else:
            params = convert_timm_swin(sd, cfg)
        save_params(args.out, params)
    n = sum(int(np.prod(a.shape)) for a in jax_params_to_state(params).values())
    print(f"wrote {args.out}: {n / 1e6:.2f}M parameters")


if __name__ == "__main__":
    main()
