"""The port's streaming OOD metrics on the card.

Marked ``cuda``: each test skips where no CUDA GPU is present (tests/test_torch_metrics.py
holds the same functions against rba_tpu on the CPU).  On a machine with a GPU:
``python -m pytest tests/test_torch_metrics_cuda.py -q --noconftest``.
"""
import numpy as np
import pytest
import torch

from rba_tpu_torch.evalx import metrics as tm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _scores_labels(n=1 << 20, seed=0):
    rng = np.random.RandomState(seed)
    s = (rng.randn(n) * rng.choice([1e-3, 1.0, 30.0, 1e5], n)).astype(np.float32)
    return s, rng.choice([0, 1, 255], n, p=[0.7, 0.2, 0.1]).astype(np.uint8)


@pytest.mark.parametrize("transform", ["linear", "asinh"])
def test_histograms_on_the_card_equal_the_cpus(cuda, transform):
    """Linear bins are equal count for count; asinh may differ by an ulp between the
    card's and the CPU's asinh, so a pixel moves by one bin at most, on at most 1 %."""
    s, lab = _scores_labels()
    got = tm.histogram_update(torch.from_numpy(s).to(cuda), torch.from_numpy(lab).to(cuda), transform=transform)
    want = tm.histogram_update(torch.from_numpy(s), torch.from_numpy(lab), transform=transform)
    assert got[0].is_cuda and got[0].dtype == torch.int64
    if transform == "linear":
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    bins = tm.ASINH_BINS if transform == "asinh" else tm.DEFAULT_BINS
    rng = tm.ASINH_RANGE if transform == "asinh" else tm.DEFAULT_RANGE
    moved = (tm._bin_index(torch.from_numpy(s).to(cuda), bins, rng, transform).cpu()
             - tm._bin_index(torch.from_numpy(s), bins, rng, transform))
    assert int(moved.abs().max()) <= (0 if transform == "linear" else 1)
    assert float((moved != 0).float().mean()) <= 0.01


def test_update_does_not_synchronise(cuda):
    """A streaming update queues device work only: scores on the card, labels from the
    host through pinned memory, no read-back."""
    s, lab = _scores_labels(1 << 16)
    scores = torch.from_numpy(s).to(cuda)
    m = tm.StreamingOODMetrics()
    assert m.counts.is_cuda
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            m.update(scores, lab)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    keep = lab != 255
    assert int(m.counts.sum()) == 3 * int(keep.sum())
    assert float(m.smin) == float(s[keep].min()) and float(m.smax) == float(s[keep].max())
