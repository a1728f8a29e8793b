"""The closed-set evaluation on the card: the device confusion matrix against numpy,
Kernel B as the open-panoptic RbA map at the COCO shapes, and the panoptic map of the
card against the same function on the CPU.

Marked ``cuda``: each test skips where no CUDA GPU is present (there
tests/test_torch_seg_evaluators.py and tests/test_torch_inference.py hold the same
functions against rba_tpu).  On a machine with an H100: ``python -m pytest
tests/test_torch_eval_cuda.py -q --noconftest``.  TF32 is off.
"""
import numpy as np
import pytest
import torch

from rba_tpu_torch import config as tconfig
from rba_tpu_torch.evalx.seg_evaluators import confusion_counts
from rba_tpu_torch.kernels.fused_rba import fused_rba_score, fused_rba_score_reference
from rba_tpu_torch.models.inference import panoptic_inference

pytestmark = pytest.mark.cuda

RBA_TOL = 1e-3  # score-map bound of rba_tpu's selfcheck
MAP_SHARE = 0.9999  # least share of equal pixels of the panoptic map


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_confusion_counts_equal_numpy(cuda):
    """19 classes at 1024x2048, labels 255 and labels outside the classes not counted."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    k = 19
    pred = torch.randint(0, k, (1024, 2048), generator=gen, device=cuda)
    label = torch.randint(0, k + 3, (1024, 2048), generator=gen, device=cuda)
    label[:100] = 255
    got = confusion_counts(pred, label, k).cpu().numpy()
    p, lab = pred.cpu().numpy(), label.cpu().numpy()
    valid = lab < k
    want = np.bincount(lab[valid] * k + p[valid], minlength=k * k).reshape(k, k)
    assert np.array_equal(got, want)


def test_kernel_b_open_rba_map_at_coco_shapes(cuda):
    """Q = 100 queries, K = 117 classes, (200, 272) low-resolution logits (an 800x1067
    frame padded to 800x1088): Kernel B against its plain version, then the crop."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    mask_cls = torch.randn(1, 100, 118, generator=gen, device=cuda) * 3
    low = torch.randn(1, 100, 200, 272, generator=gen, device=cuda) * 4
    launches = fused_rba_score.launches
    got = fused_rba_score(mask_cls, low)[0, :800, :1067]
    assert fused_rba_score.launches == launches + 1
    want = fused_rba_score_reference(mask_cls, low)[0, :800, :1067]
    assert got.shape == (800, 1067)
    assert float((got - want).abs().max()) <= RBA_TOL


def test_panoptic_map_of_the_card_equals_the_cpu(cuda):
    """The same (Q, K+1) and (Q, H, W) logits through panoptic_inference on the card and
    on the CPU, with the open branch."""
    rs = np.random.RandomState(2)
    q, k, h, w = 100, 117, 200, 268
    mask_cls = (rs.randn(q, k + 1) * 0.5).astype(np.float32)
    mask_pred = np.full((q, h, w), -4.0, np.float32) + rs.randn(q, h, w).astype(np.float32) * 0.5
    for i in range(40):  # 40 confident queries, each on a block of its own
        mask_cls[i, rs.randint(k)] += 8.0
        r, c = divmod(i, 8)
        mask_pred[i, 40 * r : 40 * (r + 1), 33 * c : 33 * (c + 1)] += 8.0
    mask_pred[:, 160:, 200:] = -12.0  # unknown
    cfg = tconfig.RbAConfig()
    thing_ids = tuple(range(0, 117, 2))
    want_map, want_segs = panoptic_inference(cfg, mask_cls, mask_pred, thing_ids=thing_ids, open_panoptic=True)
    got_map, got_segs = panoptic_inference(cfg, torch.from_numpy(mask_cls).to(cuda),
                                           torch.from_numpy(mask_pred).to(cuda), thing_ids=thing_ids,
                                           open_panoptic=True)
    assert float((got_map == want_map).mean()) >= MAP_SHARE
    assert len(got_segs) == len(want_segs) >= 30
