"""The port's optimizer against ``rba_tpu.train.optimizer.build_optimizer`` (optax) on the
CPU at the tiny config: three updates within 1e-6 of the parameters, with the backbone
frozen, a warm-up and the poly schedule, and gradients far above the clip norm; the
no-decay and backbone predicates on the tree paths derived from the port's names."""
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.train.optimizer import build_optimizer as jbuild_optimizer
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.convert.params import jax_params_to_state, load_jax_params, model_to_jax_params
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.train import optimizer as topt
from tests.torch_port_common import d2_model_pair, tree_leaves

OPT_TOL = 1e-6  # parameters after three updates


def _cfgs(**solver):
    return [dataclasses.replace(c, solver=dataclasses.replace(c.solver, **solver))
            for c in (jconfig.tiny_test_config(), tconfig.tiny_test_config())]


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    params, model = d2_model_pair(jcfg, tcfg, seed=3)
    return jcfg, tcfg, params, model


def test_three_optimizer_updates_match_optax(pair):
    """Random gradients far above the clip norm, the backbone frozen, a warm-up and the
    poly schedule: rba_tpu's optax chain and the port's clip + AdamW groups."""
    jcfg, tcfg = _cfgs(freeze_backbone=True, warmup_iters=2, warmup_factor=0.5, max_iter=10, base_lr=1e-3)
    _, _, params, _ = pair
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    model = tmf.build_model(tcfg, device="cpu")
    load_jax_params(model, params)
    rs = np.random.RandomState(2)
    grads = [jax.tree_util.tree_map(lambda a: rs.randn(*np.shape(a)).astype(np.float32), params) for _ in range(3)]

    tx = jbuild_optimizer(jcfg, params)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    jp, state = params, tx.init(params)
    for g in grads:
        upd, state = update(g, state, jp)
        jp = optax.apply_updates(jp, upd)

    opt = topt.build_optimizer(tcfg, model)
    schedule = topt.poly_lr_schedule(tcfg.solver)
    tparams = dict(model.named_parameters())
    for step, g in enumerate(grads):
        for name, arr in jax_params_to_state(g).items():
            tparams[name].grad = torch.from_numpy(np.array(arr))  # a copy: the clip writes in place
        norm = topt.clip_grads_([p.grad for p in model.parameters()], tcfg.solver.clip_value)
        assert abs(float(norm) - float(optax.global_norm(g))) <= 1e-5 * float(norm)
        topt.set_lr(opt, schedule(step))
        opt.step()
    got = dict(tree_leaves(model_to_jax_params(model)))
    want = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, jp)))
    assert sorted(got, key=str) == sorted(want, key=str)
    moved = 0
    for path, w in want.items():
        assert np.abs(got[path] - w).max() <= OPT_TOL, path
        before = np.asarray(dict(tree_leaves(params))[path])
        if path[0] == "backbone":
            assert np.array_equal(got[path], before), path  # frozen
        else:
            moved += int(not np.array_equal(got[path], before))
    assert moved > 0


def test_predicates_read_rba_tpu_paths(pair):
    """Every port parameter's derived path is a leaf path of rba_tpu's tree, and the
    decay / backbone predicates agree with rba_tpu's on it."""
    from rba_tpu.train import optimizer as jopt
    from rba_tpu_torch.convert.params import jax_path

    _, _, params, model = pair
    paths = {"/".join(map(str, p)) for p, _ in tree_leaves(params)}
    for name, p in model.named_parameters():
        path = jax_path(name, p.dim())
        assert path in paths, name
        assert topt.is_no_decay(path) == jopt._is_no_decay(path)
        assert topt.is_backbone(path) == jopt._is_backbone(path)
