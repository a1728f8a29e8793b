"""Tensor parallelism of the port on the CPU: two gloo ranks on a (data 1, model 2) mesh
(spawned once for the file, ``tests/torch_parallel_ranks.py``) against the replicated
model and the port's 1-rank step:

- the shards: the MLPs' fc1 / linear1 keep (C, H/2) of the (C, H) kernel (rba_tpu's
  layout; torch's (out, in) weight is its transpose) and fc2 / linear2 (H/2, C), the
  attention's qkv and everything else whole, as rba_tpu's ``tp_spec`` decides for each
  parameter's path;
- 2 training steps: the losses within 1e-5 (relative, floored at 1) and the first step's
  gradients, each rank's slice of them for a split layer, within 1e-5 of each leaf's
  largest element;
- inference through ``maskformer_infer_rba`` within 1e-5 of the replicated model's;
- the gathered weights that Kernel D reads equal the whole ones;
- the warning where a model axis > 1 splits nothing."""
import dataclasses

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from jax.tree_util import DictKey

from rba_tpu.parallel.tp import tp_spec
from rba_tpu_torch.convert.params import jax_path
from rba_tpu_torch.models.maskformer import build_model, maskformer_infer_rba
from rba_tpu_torch.parallel.mesh import Mesh
from rba_tpu_torch.parallel.tp import shard_params_tp
from tests.torch_parallel_ranks import run_ranks, tp_rank, train_batch, train_cfg, train_run

WORLD = 2
TOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = train_cfg()
    batches = [train_batch(0, 2), train_batch(1, 2)]
    image = (np.random.RandomState(5).rand(1, 32, 48, 3) * 255).astype(np.float32)
    ranks = run_ranks(tp_rank, WORLD, tmp_path_factory.mktemp("tp"), args=(cfg, batches, image))
    model = build_model(cfg, device="cpu", seed=0)
    with torch.no_grad():
        score = maskformer_infer_rba(model, cfg, torch.from_numpy(image), attention="xla").numpy()
    return cfg, ranks, train_run(cfg, batches, 1), model, score


def _slice(name, whole, shard, rank):
    """The rank's slice of a whole tensor of a split layer (torch layout)."""
    if shard.shape == whole.shape:
        return whole
    if shard.shape[0] != whole.shape[0]:  # column-parallel: rows of the (out, in) weight, the bias
        h = shard.shape[0]
        return whole[rank * h : (rank + 1) * h]
    h = shard.shape[1]
    return whole[:, rank * h : (rank + 1) * h]


def test_shards_follow_rba_tpu_tp_spec(runs):
    _, ranks, _, model, _ = runs
    whole = dict(model.named_parameters())
    for rank in ranks:
        shapes = rank["shapes"]
        for name, p in whole.items():
            path = jax_path(name, p.dim()).split("/")
            jshape = tuple(p.shape[::-1]) if p.dim() == 2 else tuple(p.shape)  # rba_tpu's (in, out) kernel
            spec = tp_spec([DictKey(k) for k in path], jshape, WORLD)
            got = shapes[name]
            if spec == P(None, "model"):
                assert got == (jshape[1] // 2, jshape[0]), name  # (C, H/2) in rba_tpu's layout
            elif spec == P("model", None):
                assert got == (jshape[1], jshape[0] // 2), name  # (H/2, C)
            elif spec == P("model"):
                assert got == (jshape[0] // 2,), name
            else:
                assert got == tuple(p.shape), name
        fc1 = "backbone.layers.0.blocks.0.mlp.fc1.weight"
        c = whole[fc1].shape[1]
        assert shapes[fc1] == (2 * c, c) and shapes[fc1.replace("fc1", "fc2")] == (c, 2 * c)  # H = 4C
        qkv = "backbone.layers.0.blocks.0.attn.qkv.weight"
        assert shapes[qkv] == tuple(whole[qkv].shape)


def test_tp_step_matches_one_rank(runs):
    _, ranks, (m1, g1, _), _, _ = runs
    for rank in ranks:
        m, g, _ = rank["steps"]
        for got, want in zip(m, m1):
            for k, v in want.items():
                assert abs(got[k] - v) <= TOL * max(1.0, abs(v)), (k, got[k], v)
        for n, w in g1.items():
            sl = _slice(n, w, g[n], rank["model_rank"])
            assert np.abs(g[n] - sl).max() <= TOL * max(np.abs(w).max(), 1e-30), n
        assert rank["counts"]["model"] > 0


def test_tp_inference_matches_replicated(runs):
    _, ranks, _, _, score = runs
    for rank in ranks:
        assert np.abs(rank["score"] - score).max() <= TOL


def test_kernel_d_reads_the_whole_weights(runs):
    _, ranks, _, model, _ = runs
    fc1 = model.backbone.layers[0].blocks[0].mlp["fc1"]
    for rank in ranks:
        w, b = rank["fc1_whole"]
        assert np.array_equal(w, fc1.weight.detach().numpy()) and np.array_equal(b, fc1.bias.detach().numpy())


def test_warns_when_nothing_divides():
    cfg = train_cfg()
    model = build_model(cfg, device="cpu", seed=0)
    before = {n: p.shape for n, p in model.named_parameters()}
    mesh = Mesh(data_size=1, model_size=7, data_rank=0, model_rank=0, data_group=None, model_group=None)
    with pytest.warns(UserWarning, match="no parameter matched the TP rules"):
        shard_params_tp(model, mesh)
    assert {n: p.shape for n, p in model.named_parameters()} == before
