"""The optimizer's (lr multiplier, weight decay) partition of every backbone family against
rba_tpu's on the CPU.

For each shipped non-Swin recipe (the four RbA outlier fine-tunes, R50 and ViT at 90k) and
the ViT + SFP head, frozen and unfrozen: ``param_groups`` over the port's parameter names
(through ``convert.params.jax_path``) gives every leaf the multiplier and decay that
rba_tpu's optax chain gives the same leaf of its tree, read off one update of the chain.
rba_tpu's rules stand as they are: ResNet's ``norm*`` and ``shortcut_norm`` leaves take
no decay, WiderResNet-38's ``bn*`` leaves do (ROADMAP.md §C.12), ViT's ``pos_embed`` does
(only a Swin ``absolute_pos_embed`` is exempt), and a frozen leaf has multiplier 0 (its
gradient is still computed and counted in the clip, ``test_frozen_update_equals_rba_tpu``).
``make_train_step`` accepts every recipe.
"""
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch

from rba_tpu import config as jconfig
from rba_tpu.models.maskformer import maskformer_init
from rba_tpu.train import optimizer as jopt
from rba_tpu_torch import config as tconfig
from rba_tpu_torch.convert.params import jax_path
from rba_tpu_torch.models import maskformer as tmf
from rba_tpu_torch.train import optimizer as topt
from rba_tpu_torch.train import train_step as tts
from tests.torch_port_common import train_head_cfg, tree_leaves

CONFIGS = "configs/cityscapes/semantic-segmentation"
RECIPES = {  # each family's shipped recipes: the four RbA outlier fine-tunes and the 90k R50 and ViT
    "R101_1dl_coco_mix": "maskformer2_R101_bs16_90k_1dl_coco_mix.yaml",
    "mit_b5_1dl_coco_mix": "mix_transformer/maskformer_2_mit_b5_in21k_1dl_coco_mix.yaml",
    "mvit_in21k_1dl_coco_mix": "mvit/maskformer_2_mvit_in21k_bs16_90k_1dl_coco_mix.yaml",
    "wrn38_1dl_coco_mix": "wideresnet/maskformer_2_wideresnet38_imagenet_bs16_90k_1dl_coco_mix.yaml",
    "R50": "maskformer2_R50_bs16_90k.yaml",
    "vit": "vit/maskformer_2_vit_imagenet_bs16_90k.yaml",
}


def _recipe_cfgs(name, frozen):
    """Both packages' configs of a shipped recipe (or of the ViT + SFP head, which no
    shipped config uses), with the freeze flags set to ``frozen`` and no warm-up."""
    if name == "vit_sfp":
        cfgs = (train_head_cfg(jconfig, "vit_sfp"), train_head_cfg(tconfig, "vit_sfp"))
    else:
        cfgs = (jconfig.load_config(f"{CONFIGS}/{RECIPES[name]}"), tconfig.load_config(f"{CONFIGS}/{RECIPES[name]}"))
    return [dataclasses.replace(c, solver=dataclasses.replace(c.solver, freeze_backbone=frozen,
                                                              freeze_pixel_decoder=frozen, warmup_iters=0))
            for c in cfgs]


@functools.lru_cache(maxsize=None)
def _rba_tpu_tree(name):
    """The leaf structure of rba_tpu's parameter tree of the recipe ``name`` (shapes only)."""
    jcfg = _recipe_cfgs(name, False)[0]
    return jax.eval_shape(lambda: maskformer_init(jax.random.PRNGKey(0), jcfg))


@functools.lru_cache(maxsize=None)
def _rba_tpu_partition(name, frozen):
    """rba_tpu's (multiplier, decay) of every leaf of its tree for the recipe ``name``,
    read off one update of its optax chain with every leaf two elements: gradients of
    ones, and parameters 0 and 1.  The first element moves by -lr·multiplier·a (a: Adam's
    step on the clipped gradient), the second by -lr·multiplier·(a + weight_decay) where
    the leaf decays."""
    jcfg, shapes = _recipe_cfgs(name, frozen)[0], _rba_tpu_tree(name)
    leaves = list(tree_leaves(jax.tree_util.tree_map(lambda _: 0, shapes)))
    params = jax.tree_util.tree_map(lambda _: np.array([0.0, 1.0], np.float32), shapes)
    ones = jax.tree_util.tree_map(lambda _: np.ones(2, np.float32), shapes)
    solver = jcfg.solver
    tx = jopt.build_optimizer(jcfg, params)
    clip = min(1.0, solver.clip_value / math.sqrt(2 * len(leaves)))
    step = clip / (clip + 1e-8)
    lr = float(jopt.poly_lr_schedule(solver)(0))
    out = {}
    for (path, _), (_, u) in zip(leaves, tree_leaves(tx.update(ones, tx.init(params), params)[0])):
        mult = -float(u[0]) / (lr * step)
        decay = (-float(u[1]) / (lr * mult) - step) / solver.weight_decay if mult else None
        out["/".join(map(str, path))] = (mult, decay)
    return out


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
@pytest.mark.parametrize("name", [*RECIPES, "vit_sfp"])
def test_param_groups_partition_equals_rba_tpu(name, frozen):
    jcfg, tcfg = _recipe_cfgs(name, frozen)
    tts.make_train_step(tcfg)  # every backbone family trains; only per-pixel heads are refused
    with torch.device("meta"):
        model = tmf.RbAModel(tcfg)
    names = {id(p): (n, p.dim()) for n, p in model.named_parameters()}
    got = {}
    for group in topt.param_groups(tcfg, model):
        for p in group["params"]:
            n, dim = names[id(p)]
            got[jax_path(n, dim)] = (group["lr_mult"], group["weight_decay"] > 0)
    assert len(got) == len(names)
    want = _rba_tpu_partition(name, frozen)
    numbers = {f"backbone/sfp/stages/{i}/scale" for i in range(4)} if name == "vit_sfp" else set()
    assert set(want) - set(got) == numbers and set(got) <= set(want)
    # the decay of each leaf from the unfrozen chain, where no multiplier is 0
    decays = _rba_tpu_partition(name, False)
    for path, (mult, decay) in got.items():
        assert abs(want[path][0] - mult) <= 1e-5 * max(mult, 1.0), (path, want[path], mult)
        assert abs(decays[path][1] - decay) <= 1e-3, (path, decays[path][1], decay)
    if frozen:
        assert all(m == 0 for p, (m, _) in got.items() if p.startswith(("backbone/", "sem_seg_head/pixel_decoder/")))
    if name.startswith("wrn38"):  # rba_tpu decays WiderResNet-38's batch norms (§C.12)
        assert got["backbone/mod2/0/bn1/scale"][1] and got["backbone/bn_out/mean"][1]
    if name == "vit":  # ViT's pos_embed decays; only a Swin absolute_pos_embed is exempt
        assert got["backbone/pos_embed"][1]
    if name.startswith("R"):  # ResNet's norm* and shortcut_norm do not
        assert not got["backbone/res2/0/norm1/var"][1] and not got["backbone/res3/0/shortcut_norm/scale"][1]
