"""Seeded inputs: the same seed gives the same bytes, another seed others, for weights
and scenes; any whole number is a seed."""
from __future__ import annotations

import pytest
import torch

from benchmark import inputs, system

from .tiny import SCENE, tiny_model

SEEDS = [0, 7, 2**31 + 3, 2**40 + 1, -5]


def _scenes(seed):
    return [(img.clone(), lab.clone()) for img, lab in inputs.make_scenes(3, 48, 80, SCENE, seed, "cpu", chunk=2)]


def _weights(seed):
    model = tiny_model()
    return inputs.make_weights(system.parameter_shapes(model), model, seed, "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_bytes(seed):
    for (i1, l1), (i2, l2) in zip(_scenes(seed), _scenes(seed)):
        assert torch.equal(i1, i2) and torch.equal(l1, l2)
    w1, w2 = _weights(seed), _weights(seed)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)


@pytest.mark.parametrize("seed", SEEDS)
def test_other_seed_other_bytes(seed):
    a, b = _scenes(seed), _scenes(seed + 1)
    assert all(not torch.equal(x[0], y[0]) for x, y in zip(a, b))
    w1, w2 = _weights(seed), _weights(seed + 1)
    assert not torch.equal(w1["sem_seg_head.predictor.query_feat"], w2["sem_seg_head.predictor.query_feat"])


def test_scenes_hold_their_labels():
    for img, lab in _scenes(1):
        assert img.dtype == lab.dtype == torch.uint8
        assert set(torch.unique(lab).tolist()) == {0, 1, 255}
        assert bool((lab[:, :2] == 255).all())


def test_offset_bias_is_the_directional_grid():
    model = tiny_model()
    w = _weights(3)
    pd = model["pixel_decoder"]
    grid = inputs.offset_grid(pd["transformer_nheads"], len(pd["transformer_in_features"]), pd["enc_n_points"])
    bias = w["sem_seg_head.pixel_decoder.transformer.encoder.layers.0.self_attn.sampling_offsets.bias"]
    assert torch.equal(bias, grid)
    assert float(grid.abs().max()) == pd["enc_n_points"]
