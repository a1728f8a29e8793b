"""Offline conversion: COCO panoptic annotations → semantic PNG maps (a copy of
``rba_tpu/tools/prepare_coco_semseg.py``, numpy and PIL only).

After the reference's ``datasets/prepare_coco_semantic_annos_from_panoptic_annos.py``: decode each panoptic
RGB id map (id = R + 256G + 256²B), map segment ids to contiguous category
ids via the JSON annotations, and write uint8 semantic PNGs (255 = unlabeled).

Usage:
    python -m rba_tpu_torch.tools.prepare_coco_semseg \
        --panoptic-json annotations/panoptic_train2017.json \
        --panoptic-root annotations/panoptic_train2017 \
        --out-dir annotations/panoptic_semseg_train2017
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def convert_one(pan_png_path: str, segments, id_map, out_path: str):
    from PIL import Image

    from ..data.ood_datasets import rgb2id

    pan = rgb2id(np.asarray(Image.open(pan_png_path).convert("RGB")))
    sem = np.full(pan.shape, 255, np.uint8)
    for seg in segments:
        sem[pan == seg["id"]] = id_map[seg["category_id"]]
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    Image.fromarray(sem).save(out_path)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--panoptic-json", required=True)
    p.add_argument("--panoptic-root", required=True)
    p.add_argument("--out-dir", required=True)
    args = p.parse_args(argv)

    with open(args.panoptic_json) as f:
        meta = json.load(f)
    id_map = {c["id"]: i for i, c in enumerate(meta["categories"])}
    for ann in meta["annotations"]:
        convert_one(
            os.path.join(args.panoptic_root, ann["file_name"]),
            ann["segments_info"],
            id_map,
            os.path.join(args.out_dir, ann["file_name"]),
        )
    print(f"converted {len(meta['annotations'])} maps -> {args.out_dir}")


if __name__ == "__main__":
    main()
