"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py)."""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.d2_synthetic import d2_state_dict  # noqa: F401  (re-exported for the tests)

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
