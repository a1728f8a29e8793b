"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py)."""
from __future__ import annotations

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.d2_synthetic import d2_state_dict  # noqa: F401  (re-exported for the tests)

# Under pytest-xdist every worker collects every module, and each would run torch's CPU
# ops on all the cores: the workers' threads then oversubscribe the machine, and torch's
# waiting threads slow every worker several times over.  Each worker takes its share.
_DEFAULT_THREADS = torch.get_num_threads()
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _WORKERS))


@pytest.fixture(scope="module")
def default_threads():
    """torch's default CPU threads for a module whose bf16 shares were recorded with them:
    oneDNN splits a bf16 conv's fp32 sums by the thread count, and so moves which
    elements flip by one ulp (ROADMAP.md §C.1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(_DEFAULT_THREADS)
    yield
    torch.set_num_threads(threads)

# the dict of tests/test_evaluator.py::test_sweep_cli_on_synthetic: tiny_test_config in D2 keys
D2_TINY = {
    "MODEL": {
        "BACKBONE": {"NAME": "D2SwinTransformer"},
        "SWIN": {"EMBED_DIM": 32, "DEPTHS": [2, 2], "NUM_HEADS": [2, 4], "WINDOW_SIZE": 4,
                 "OUT_FEATURES": ["res2", "res3"]},
        "SEM_SEG_HEAD": {"CONVS_DIM": 64, "MASK_DIM": 64, "NUM_CLASSES": 7,
                         "DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES": ["res3"],
                         "IN_FEATURES": ["res2", "res3"], "TRANSFORMER_ENC_LAYERS": 2},
        "MASK_FORMER": {"HIDDEN_DIM": 64, "NUM_OBJECT_QUERIES": 10, "NHEADS": 4, "DIM_FEEDFORWARD": 128,
                        "DEC_LAYERS": 3},
    }
}


def perturbed(params, seed: int, scale: float = 0.02):
    """The pytree as float32 numpy arrays plus seeded N(0, scale²) noise on every leaf,
    so that zero-initialised leaves (sampling offsets, attention weights) are exercised."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32) + scale * rs.randn(*np.shape(a))).astype(np.float32), params
    )


def model_pair(jcfg, tcfg, seed: int):
    """rba_tpu's seeded MaskFormer parameters, perturbed, and the port's model holding
    the same values (through ``load_jax_params``) on the CPU."""
    from rba_tpu.models.maskformer import maskformer_init
    from rba_tpu_torch.convert import load_jax_params
    from rba_tpu_torch.models.maskformer import build_model

    params = perturbed(maskformer_init(jax.random.PRNGKey(seed), jcfg), seed=seed + 100)
    model = build_model(tcfg, device="cpu", seed=seed)
    load_jax_params(model, params)
    return to_jax(params), model


def d2_model_pair(jcfg, tcfg, seed: int):
    """rba_tpu's parameters converted from a seeded Detectron2 state dict
    (``d2_state_dict``) and the port's model holding the same values, on the CPU.  Numpy
    only: unlike ``model_pair`` it compiles nothing of jax, so a file that needs one
    model starts in a fraction of a second."""
    from rba_tpu.convert.d2_mapping import convert_d2_state_dict
    from rba_tpu_torch.convert import load_jax_params
    from rba_tpu_torch.models.maskformer import build_model

    params = convert_d2_state_dict(d2_state_dict(tcfg, seed), jcfg)
    model = build_model(tcfg, device="cpu", seed=seed)
    load_jax_params(model, params)
    return to_jax(params), model


def jax_config(cfg):
    """The port's config as rba_tpu's, field for field."""
    from rba_tpu import config as jconfig

    def conv(v):
        if dataclasses.is_dataclass(v):
            return getattr(jconfig, type(v).__name__)(**{f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)})
        return v

    return conv(cfg)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def max_abs(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


BF16_ULP = 2.0**-7


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))  # a writable copy


def equal_share(got, want) -> float:
    """Share of the elements of ``got`` equal to ``want``."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((got == want).mean())


def ulp_share(got, want) -> float:
    """Share of the elements of ``got`` within one bf16 ulp of ``want`` (plus 1e-6)."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((np.abs(got - want) <= BF16_ULP * np.abs(want) + 1e-6).mean())


def record(request, **values) -> None:
    """Attach measured values to the running test; a ``--junitxml`` report lists them
    as the test case's properties."""
    request.node.user_properties += [(k, float(v)) for k, v in values.items()]


def tree_leaves(tree, path=()):
    """(path, leaf) of every leaf of a nested dict/list pytree, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))
    else:
        yield path, tree


def assert_trees_equal(got, want):
    """Same paths, and leaf for leaf the same dtype, shape and bits."""
    g, w = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert sorted(g, key=str) == sorted(w, key=str)
    for path, leaf in w.items():
        a, b = np.asarray(g[path]), np.asarray(leaf)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), path


def replay(draws):
    """A ``Uniform`` for the port (``rba_tpu_torch.ops.point_sample``) that hands out
    ``draws`` (rba_tpu's ``jax.random`` arrays) in order, checking each shape, so that
    the port draws what rba_tpu drew."""
    queue = [np.array(d, np.float32) for d in draws]

    def uniform(shape):
        assert queue, f"the port asked for a draw of {tuple(shape)} beyond rba_tpu's"
        d = queue.pop(0)
        assert d.shape == tuple(shape), (d.shape, tuple(shape))
        return torch.from_numpy(d)

    uniform.left = queue
    return uniform


def criterion_draws(rng, loss_cfg, b: int, t: int, n_layers: int, matcher: bool = True):
    """The ``jax.random.uniform`` draws of ``rba_tpu.train.criterion.criterion(cfg, rng, ...)``
    over ``n_layers`` supervised layers (final first, then the aux layers), in the order the
    port asks for them: the matcher's (B, P, 2) points, then ``uncertain_point_coords``'
    (B·T, P·oversample, 2) and (B·T, n_random, 2)."""
    p = loss_cfg.train_num_points
    n_unc = int(loss_cfg.importance_sample_ratio * p)
    keys = jax.random.split(rng, n_layers + 1)
    draws = []
    for key in keys[:n_layers]:
        r1, r2 = jax.random.split(key)
        if matcher:
            draws.append(jax.random.uniform(r1, (b, p, 2)))
        k1, k2 = jax.random.split(r2)
        draws.append(jax.random.uniform(k1, (b * t, int(p * loss_cfg.oversample_ratio), 2)))
        if p - n_unc > 0:
            draws.append(jax.random.uniform(k2, (b * t, p - n_unc, 2)))
    return draws


@contextlib.contextmanager
def catalogs_restored():
    """Both packages' dataset catalogs as they were, afterwards: a test that registers the
    standard names under its tmp_path must not leave them pointing there."""
    from rba_tpu.data import catalog as jcatalog
    from rba_tpu_torch.data import catalog as tcatalog

    saved = [(c, dict(c._REGISTRY), dict(c._METADATA), set(c._STANDARD_OWNED), c._STANDARD_ROOT)
             for c in (jcatalog, tcatalog)]
    try:
        yield
    finally:
        for c, registry, meta, owned, root in saved:
            c._REGISTRY.clear()
            c._REGISTRY.update(registry)
            c._METADATA.clear()
            c._METADATA.update(meta)
            c._STANDARD_OWNED.clear()
            c._STANDARD_OWNED.update(owned)
            c._STANDARD_ROOT = root


# Detectron2 names of the non-Swin backbones, from the port's parameter names: (pattern,
# replacement) in order, per family; a batch norm's mean and var are running statistics.
_D2_NAMES = {
    "resnet": [(r"^stem\.norm1\.", "stem.conv1.norm."), (r"\.norm(\d)\.", r".conv\1.norm."),
               (r"\.shortcut_norm\.", ".shortcut.norm.")],
    "mit": [(r"^stages\.(\d)\.patch_embed\.", lambda m: f"patch_embed{int(m[1]) + 1}."),
            (r"^stages\.(\d)\.blocks\.", lambda m: f"block{int(m[1]) + 1}."),
            (r"^stages\.(\d)\.norm\.", lambda m: f"norm{int(m[1]) + 1}."),
            (r"\.attn\.sr_norm\.", ".attn.norm."), (r"\.mlp\.dwconv\.", ".mlp.dwconv.dwconv.")],
    "wideresnet38": [(r"^mod1\.weight$", "mod1.conv1.weight"), (r"^mod(\d)\.(\d+)\.", lambda m: f"mod{m[1]}.block{int(m[2]) + 1}."),
                     (r"(\.block\d+)\.(conv\d|bn[23])\.", r"\1.convs.\2.")],
    "vit": [],
    "mvit": [],
    "vit_sfp": [(r"^vit\.", "net."), (r"^sfp\.stages\.(\d)\.", lambda m: f"simfp_{int(m[1]) + 2}.")],
}
# the Sequential index of each part of a SimpleFeaturePyramid stage, by the stage's scale
_SFP_INDEX = {4.0: dict(up1="0", up1_norm="1", up2="3", lateral="4", output="5"),
              2.0: dict(up1="0", lateral="1", output="2"), 1.0: dict(lateral="0", output="1"),
              0.5: dict(lateral="1", output="2")}


def d2_backbone_state_dict(cfg, seed: int, model=None):
    """A seeded Detectron2 state dict of the backbone of ``cfg`` (the port's config), any
    family but Swin: the released checkpoints' ``backbone.*`` names and torch layouts
    (a transposed conv's weight (in, out, 2, 2)), in numpy.  Convs and linears
    ~ N(0, 1/fan_in), norm scales 1 + N(0, 0.01²), biases, running means and position
    tables ~ N(0, 0.02²) (means 0.1), running variances 1 + |N(0, 0.1²)|.  ``model``: the
    port's backbone module to take the names and shapes from (a smaller one than the
    family's fixed config); by default ``build_backbone(cfg)``'s."""
    import re

    from rba_tpu_torch.models.backbones import build_backbone

    if model is None:
        with torch.device("meta"):
            model = build_backbone(cfg)
    family = "mit" if cfg.backbone_name.startswith("mit") or cfg.backbone_name == "mix_transformer" else cfg.backbone_name
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in model.named_parameters():
        shape, leaf = tuple(p.shape), name.rpartition(".")[2]
        if leaf == "weight" and len(shape) in (2, 4):
            w = rng.standard_normal(shape, dtype=np.float32) / np.float32(np.sqrt(np.prod(shape[1:])))
        elif leaf == "weight":
            w = 1 + 0.01 * rng.standard_normal(shape, dtype=np.float32)
        elif leaf == "var":
            w = 1 + np.abs(0.1 * rng.standard_normal(shape, dtype=np.float32))
        else:
            w = (0.1 if leaf == "mean" else 0.02) * rng.standard_normal(shape, dtype=np.float32)
        d2 = name
        if family == "vit_sfp" and name.startswith("sfp."):
            _, _, i, part, *rest = name.split(".")
            if part in ("up1", "up2") and leaf == "weight":
                w = np.ascontiguousarray(w.transpose(1, 0, 2, 3))
            idx = _SFP_INDEX[model.sfp.stages[int(i)].scale][part]
            d2 = f"sfp.stages.{i}.{idx}." + ("norm." + leaf if rest[0] == "norm" else leaf)
        for pat, rep in _D2_NAMES[family]:
            d2 = re.sub(pat, rep, d2)
        d2 = re.sub(r"\.mean$", ".running_mean", re.sub(r"\.var$", ".running_var", d2))
        sd["backbone." + d2] = w.astype(np.float32)
    return sd


def d2_full_state_dict(cfg, seed: int):
    """``d2_state_dict`` of the heads of ``cfg`` over ``d2_backbone_state_dict``'s backbone:
    a seeded Detectron2 state dict of a whole non-Swin model."""
    import types

    from rba_tpu_torch.models.backbones import build_backbone

    with torch.device("meta"):
        channels = build_backbone(cfg).out_channels
    swin = types.SimpleNamespace(embed_dim=8, patch_size=4, window_size=1, num_layers=0, out_features=(),
                                 out_channels=channels, depths=(), num_heads=(), mlp_ratio=4.0)
    heads = d2_state_dict(types.SimpleNamespace(swin=swin, pixel_decoder=cfg.pixel_decoder, decoder=cfg.decoder,
                                                num_classes=cfg.num_classes, sem_seg_head_name=cfg.sem_seg_head_name),
                          seed)
    sd = {k: v for k, v in heads.items() if not k.startswith("backbone.")}
    sd.update(d2_backbone_state_dict(cfg, seed + 1))
    return sd



# ---------------------------------------------------------------------------
# Training parity on every backbone family (tests/test_torch_train_backbones*.py)
# ---------------------------------------------------------------------------

# the pixel decoder's inputs and deformable levels of each family's small training head:
# the shipped recipes' features (ResNet at R50's three levels)
TRAIN_HEAD_FEATURES = {
    "resnet": (("res2", "res3", "res4", "res5"), ("res3", "res4", "res5")),
    "mit_b0": (("res2", "res3", "res4", "res5"), ("res5",)),
    "mvit": (("scale2", "scale3", "scale4", "scale5"), ("scale5",)),
    "vit": (("last_feat",), ("last_feat",)),
    "vit_sfp": (("res2", "res3", "res4", "res5"), ("res5",)),
    "wideresnet38": (("res4", "res5", "res6", "res7", "res7_bn"), ("res7_bn",)),
}
TRAIN_OOD = dict(outlier_supervision=True, outlier_loss_target="nls", score_norm="tanh",
                 outlier_loss_func="squared_hinge")
TRAIN_B, TRAIN_HW, TRAIN_T = 2, (64, 96), 3


def train_head_cfg(pkg, backbone: str, **solver):
    """``tiny_test_config``'s narrow head (one decoder layer, 48 points) over the full
    ``backbone`` at fp32, with the outlier loss of the coco-mix recipes, from ``pkg``
    (``rba_tpu.config`` or the port's)."""
    base = pkg.tiny_test_config()
    in_features, levels = TRAIN_HEAD_FEATURES[backbone]
    return dataclasses.replace(
        base, backbone_name=backbone, compute_dtype="float32",
        pixel_decoder=dataclasses.replace(base.pixel_decoder, in_features=in_features, transformer_in_features=levels),
        decoder=dataclasses.replace(base.decoder, num_feature_levels=len(levels), dec_layers=1),
        ood=dataclasses.replace(base.ood, **TRAIN_OOD), loss=dataclasses.replace(base.loss, train_num_points=48),
        solver=dataclasses.replace(base.solver, **solver))


def train_batch(seed: int, b: int = TRAIN_B, hw=TRAIN_HW, t: int = TRAIN_T) -> dict:
    """A seeded training batch in numpy: raw images, ``t`` class targets from a label map
    with a pasted outlier block (254), one invalid target."""
    rs = np.random.RandomState(seed)
    h, w = hw
    sem = rs.randint(0, 4, (b, h, w)).astype(np.int32)
    sem[:, h // 4 : h // 2, w // 6 : w // 2] = 254
    batch = dict(images=(rs.rand(b, h, w, 3) * 255).astype(np.float32),
                 gt_labels=np.tile(np.arange(t, dtype=np.int32), (b, 1)),
                 gt_masks=np.stack([[sem[i] == c for c in range(t)] for i in range(b)]).astype(np.float32),
                 gt_valid=np.ones((b, t), np.float32), sem_seg=sem, outlier_masks=(sem == 254).astype(np.int32))
    batch["gt_valid"][-1, -1] = 0.0
    return batch


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in batch.items()}


def _split_numbers(tree):
    """(the tree with its Python-number leaves set to None, a function that puts them
    back): the SFP tree keeps its scale factors as numbers, which ``jax.jit`` would trace."""
    numbers = [(p, v) for p, v in tree_leaves(tree) if isinstance(v, (int, float))]

    def put(t, path, value):
        t = list(t) if isinstance(t, (list, tuple)) else dict(t)
        t[path[0]] = value if len(path) == 1 else put(t[path[0]], path[1:], value)
        return t

    stripped = tree
    for path, _ in numbers:
        stripped = put(stripped, path, None)

    def restore(t):
        for path, value in numbers:
            t = put(t, path, value)
        return t

    return stripped, restore


def train_pair(backbone: str, seed: int = 0, **solver):
    """(jcfg, tcfg, rba_tpu's tree, the port's model on the CPU) of ``train_head_cfg``,
    both converted from one seeded Detectron2 dict (``d2_full_state_dict``)."""
    from rba_tpu import config as jconfig
    from rba_tpu.convert.d2_mapping import convert_d2_state_dict
    from rba_tpu_torch import config as tconfig
    from rba_tpu_torch.convert import load_jax_params
    from rba_tpu_torch.models.maskformer import build_model

    jcfg, tcfg = train_head_cfg(jconfig, backbone, **solver), train_head_cfg(tconfig, backbone, **solver)
    params = convert_d2_state_dict(d2_full_state_dict(tcfg, seed), jcfg)
    model = build_model(tcfg, device="cpu", seed=seed)
    load_jax_params(model, params)
    return jcfg, tcfg, params, model


def rba_tpu_loss_and_grads(jcfg, params, batch: dict, key):
    """The body of rba_tpu's ``make_train_step`` ``loss_fn`` under ``jax.value_and_grad``,
    jitted: (the weighted losses with ``total``, the gradients by the port's parameter
    names, the gradient tree)."""
    from rba_tpu.models import maskformer as jmf
    from rba_tpu.train import criterion as jcrit
    from rba_tpu_torch.convert.params import jax_params_to_state

    arrays, restore = _split_numbers(params)

    def loss_fn(p, b):
        outputs = jmf.maskformer_forward(restore(p), jcfg, jmf.preprocess(jcfg, b["images"]))
        losses = jcrit.criterion(jcfg, key, outputs, {k: v for k, v in b.items() if k != "images"})
        return losses["total"], losses

    (total, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        to_jax(arrays), {k: jnp.asarray(v) for k, v in batch.items()})
    grads = jax.tree_util.tree_map(np.asarray, grads)
    assert float(total) == float(losses["total"])
    # the numbers' None leaves drop out of the named gradients
    return {k: float(v) for k, v in losses.items()}, jax_params_to_state(grads), grads


class TrainStepPair:
    """One training step of ``train_head_cfg(backbone)`` in both packages on
    ``train_batch(1)`` with the criterion's draws of one key: ``want`` / ``got`` the
    weighted losses, ``want_grads`` / ``got_grads`` the gradients by parameter name."""

    def __init__(self, backbone: str, seed: int = 0):
        self.jcfg, self.tcfg, self.params, self.model = train_pair(backbone, seed)
        self.batch, self.key = train_batch(1), jax.random.PRNGKey(5)
        self.want, self.want_grads, self.want_tree = rba_tpu_loss_and_grads(self.jcfg, self.params, self.batch,
                                                                            self.key)
        self.got, self.got_grads = port_loss_and_grads(self.tcfg, self.model, self.batch, self.key)


LOSS_TOL = 1e-4  # each weighted loss, relative to max(1, |loss|)
GRAD_TOL = 1e-4  # each gradient, relative to its leaf's largest magnitude


def assert_losses_match(pair: TrainStepPair) -> float:
    assert sorted(pair.got) == sorted(pair.want)
    assert "outlier_loss" in pair.got and "outlier_loss_0" in pair.got
    errs = {k: abs(pair.got[k] - w) / max(1.0, abs(w)) for k, w in pair.want.items()}
    assert max(errs.values()) <= LOSS_TOL, errs
    return max(errs.values())


def port_loss_and_grads(tcfg, model, batch: dict, key):
    """The port's forward (``need_aux=True``, ``attention="xla"``), criterion on rba_tpu's
    draws of ``key`` replayed, and backward: (the weighted losses, the gradients by name)."""
    from rba_tpu_torch.models import maskformer as tmf
    from rba_tpu_torch.train import criterion as tcrit

    b, t = batch["gt_labels"].shape
    uniform = replay(criterion_draws(key, tcfg.loss, b, t, 1 + tcfg.decoder.dec_layers))
    tb = torch_batch(batch)
    model.zero_grad(set_to_none=True)
    outputs = tmf.maskformer_forward(model, tcfg, tmf.preprocess(tcfg, tb["images"]), need_aux=True,
                                     attention="xla")
    losses = tcrit.criterion(tcfg, uniform, outputs, {k: v for k, v in tb.items() if k != "images"})
    assert not uniform.left
    losses["total"].backward()
    # a parameter outside the graph has a zero gradient, as in jax.grad
    grads = {n: p.grad.numpy().copy() if p.grad is not None else np.zeros(tuple(p.shape), np.float32)
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def grad_errors(got: dict, want: dict) -> dict:
    """Per parameter, max |got − want| relative to the leaf's largest |want|."""
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    return {n: float(np.abs(got[n] - w).max() / max(np.abs(w).max(), 1e-30)) for n, w in want.items()}


def assert_gradients_match(pair: TrainStepPair, request) -> dict:
    """Every gradient of ``pair`` within ``GRAD_TOL`` of rba_tpu's, relative to its leaf's
    largest magnitude; the largest error is recorded.  Returns the port's gradients."""
    errs = grad_errors(pair.got_grads, pair.want_grads)
    worst = max(errs, key=errs.get)
    record(request, grad_rel_err=errs[worst], leaves=len(errs))
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    return pair.got_grads

