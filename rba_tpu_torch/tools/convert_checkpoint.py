"""Checkpoint conversion CLI of the port (the ``d2`` mode of ``rba_tpu.tools.convert_checkpoint``).

Converts a released Detectron2 ``model_final.pth``/``.pkl`` to the flat
``params.npz`` that both packages read:

    python -m rba_tpu_torch.tools.convert_checkpoint d2 \\
        --config ckpts/swin_b_1dl/config.yaml \\
        --checkpoint ckpts/swin_b_1dl/model_final.pth --out ckpts/swin_b_1dl/params.npz
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode", choices=["d2"])
    p.add_argument("--config", required=True, help="the checkpoint's Detectron2 config.yaml")
    p.add_argument("--checkpoint", required=True, help="model_final.pth or .pkl")
    p.add_argument("--out", required=True, help="the params.npz to write")
    args = p.parse_args(argv)

    from ..config import load_d2_config
    from ..convert.checkpoint import convert_d2_checkpoint
    from ..convert.params import jax_params_to_state

    params = convert_d2_checkpoint(args.checkpoint, load_d2_config(args.config), out_path=args.out)
    n = sum(int(np.prod(a.shape)) for a in jax_params_to_state(params).values())
    print(f"wrote {args.out}: {n / 1e6:.2f}M parameters")


if __name__ == "__main__":
    main()
