"""Weights for the port's model: the JAX package's ``params.npz`` and pytree
(``params``), and the released Detectron2 checkpoints (``d2_mapping``, ``checkpoint``)."""
from .checkpoint import convert_d2_checkpoint, load_checkpoint_params, read_state_dict
from .params import jax_params_to_state, load_jax_params, load_params, save_params

__all__ = ["convert_d2_checkpoint", "jax_params_to_state", "load_checkpoint_params", "load_jax_params",
           "load_params", "read_state_dict", "save_params"]
