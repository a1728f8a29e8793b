"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

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
