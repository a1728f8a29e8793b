"""The port's PQ (``rba_tpu_torch/evalx/panoptic.py``) and the PQ of semantic maps
(``rba_tpu_torch/tools/evaluate_pq_semseg.py``) against rba_tpu's, exactly: both are host
numpy.  Inputs: seeded panoptic id maps with void, crowd regions, segments listed but
absent from the map, stuff and things, and the open-world relabelling."""
import copy
import json

import numpy as np
import pytest
from PIL import Image

from rba_tpu.evalx import panoptic as jpq
from rba_tpu.tools import evaluate_pq_semseg as jsem
from rba_tpu_torch.evalx import panoptic as tpq
from rba_tpu_torch.tools import evaluate_pq_semseg as tsem

CATS = [(1, 1, "person"), (2, 1, "car"), (3, 1, "boat"), (7, 0, "road"), (8, 0, "sky")]
UNKNOWN_NAMES = ("boat",)


def _image(rs, h=40, w=56):
    """(gt id map, gt segments, pred id map, pred segments): the prediction is the ground
    truth with shifted boundaries, relabelled segments and spurious ones."""
    gt = np.zeros((h, w), np.int64)
    segs_gt, segs_pred = [], []
    pred = np.zeros((h, w), np.int64)
    n = rs.randint(4, 8)
    for i in range(n):
        cid, isthing, _ = CATS[rs.randint(len(CATS))]
        y, x = rs.randint(0, h - 8), rs.randint(0, w - 8)
        hh, ww = rs.randint(6, 20), rs.randint(6, 24)
        sid = 100 + i
        gt[y : y + hh, x : x + ww] = sid
        seg = {"id": sid, "category_id": cid, "isthing": isthing}
        if rs.rand() < 0.15:
            seg["iscrowd"] = 1
        segs_gt.append(seg)
        dy, dx = rs.randint(-2, 3), rs.randint(-2, 3)
        pid = 200 + i
        pred[max(y + dy, 0) : y + dy + hh, max(x + dx, 0) : x + dx + ww] = pid
        pcat = cid if rs.rand() < 0.8 else CATS[rs.randint(len(CATS))][0]
        segs_pred.append({"id": pid, "category_id": pcat})
    segs_gt.append({"id": 999, "category_id": 7, "isthing": 0})  # listed, absent from the map
    if rs.rand() < 0.5:
        segs_gt[0]["area"] = int((gt == segs_gt[0]["id"]).sum()) + 3  # the JSON's area wins
    gt[rs.rand(h, w) < 0.03] = 0  # void
    return gt, segs_gt, pred, segs_pred


@pytest.fixture(scope="module")
def images():
    rs = np.random.RandomState(0)
    return [_image(rs) for _ in range(6)]


def _pairs(images):
    return [(pred, sp, gt, sg) for gt, sg, pred, sp in images]


def test_pq_compute_equals_rba_tpu(images):
    isthing = {c: bool(t) for c, t, _ in CATS}
    isthing[255] = True
    got = tpq.pq_compute(copy.deepcopy(_pairs(images)), isthing=isthing)
    want = jpq.pq_compute(copy.deepcopy(_pairs(images)), isthing=isthing)
    assert got == want
    assert got["All"]["n"] > 0 and 0 < got["All"]["pq"] < 1


@pytest.mark.parametrize("strict", [False, True])
def test_pq_compute_single_and_stats_equal_rba_tpu(images, strict):
    cats = {c: {"id": c, "isthing": t, "name": n} for c, t, n in CATS}
    for gt, sg, pred, sp in images:
        got = tpq.pq_compute_single(pred, sp, gt, sg, categories=cats, strict=strict)
        want = jpq.pq_compute_single(pred, sp, gt, sg, categories=cats, strict=strict)
        assert {k: vars(v) for k, v in got.per_cat.items()} == {k: vars(v) for k, v in want.per_cat.items()}
    with pytest.raises(KeyError):  # a predicted id in the map with no segment
        tpq.pq_compute_single(pred, sp[1:], gt, sg, strict=True)


def test_relabel_and_pq_average_open_equal_rba_tpu(images):
    cats = {c: {"id": c, "isthing": t, "name": n, "supercategory": "s"} for c, t, n in CATS}
    anns_t = [{"segments_info": copy.deepcopy(sg)} for _, sg, _, _ in images]
    anns_j = copy.deepcopy(anns_t)
    got_cats = tpq.relabel_unknown_categories(copy.deepcopy(cats), anns_t, UNKNOWN_NAMES)
    want_cats = jpq.relabel_unknown_categories(copy.deepcopy(cats), anns_j, UNKNOWN_NAMES)
    assert got_cats == want_cats and anns_t == anns_j
    assert any(s.get("original_category_id") == -4 for a in anns_t for s in a["segments_info"])
    got, want = tpq.PQStat(), jpq.PQStat()
    for (gt, _, pred, sp), a in zip(images, anns_t):
        got += tpq.pq_compute_single(pred, sp, gt, a["segments_info"])
        want += jpq.pq_compute_single(pred, sp, gt, a["segments_info"])
    assert tpq.pq_average_open(got, got_cats) == jpq.pq_average_open(want, want_cats)


def test_rgb_encoding_round_trips():
    ids = np.random.RandomState(1).randint(0, 256**3, (9, 11))
    rgb = tpq.id2rgb(ids)
    assert np.array_equal(rgb, jpq.id2rgb(ids))
    assert np.array_equal(tpq.rgb2id(rgb), ids) and np.array_equal(tpq.rgb2id(rgb), jpq.rgb2id(rgb))


def _write_tree(root, images, which):
    """A panopticapi directory: ``<which>.json`` and a folder of RGB id-map PNGs."""
    folder = root / which
    folder.mkdir()
    anns = []
    for i, (gt, sg, pred, sp) in enumerate(images):
        idmap, segs = (gt, sg) if which == "gt" else (pred, sp)
        Image.fromarray(tpq.id2rgb(idmap)).save(folder / f"{i}.png")
        anns.append({"image_id": i, "file_name": f"{i}.png", "segments_info": segs})
    meta = {"annotations": anns,
            "categories": [{"id": c, "isthing": t, "name": n, "supercategory": "s"} for c, t, n in CATS]}
    (root / f"{which}.json").write_text(json.dumps(meta))
    return str(root / f"{which}.json")


@pytest.mark.parametrize("unknown", [None, UNKNOWN_NAMES])
def test_pq_compute_dirs_equals_rba_tpu(tmp_path, images, unknown):
    gt_json, pred_json = _write_tree(tmp_path, images, "gt"), _write_tree(tmp_path, images, "pred")
    got = tpq.pq_compute_dirs(gt_json, pred_json, unknown_label_list=unknown, strict=False)
    want = jpq.pq_compute_dirs(gt_json, pred_json, unknown_label_list=unknown, strict=False)
    assert got == want and got["All"]["n"] > 0


def test_evaluate_pq_semseg_equals_rba_tpu(tmp_path):
    rs = np.random.RandomState(2)
    gts = [np.repeat(np.repeat(rs.randint(0, 6, (5, 7)), 8, 0), 8, 1) for _ in range(3)]
    preds = [np.where(rs.rand(*g.shape) < 0.1, rs.randint(0, 6, g.shape), g) for g in gts]
    gts[0][:4] = 255
    assert tsem.evaluate(preds, gts) == jsem.evaluate(preds, gts)
    for name, maps in (("pred", preds), ("gt", gts)):
        (tmp_path / name).mkdir()
        for i, m in enumerate(maps):
            Image.fromarray(m.astype(np.uint8)).save(tmp_path / name / f"{i}.png")
    res = tsem.main(["--pred-dir", str(tmp_path / "pred"), "--gt-dir", str(tmp_path / "gt")])
    assert res == jsem.evaluate(preds, gts)
