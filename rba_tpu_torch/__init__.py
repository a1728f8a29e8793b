"""PyTorch and CUDA port of rba_tpu for NVIDIA Hopper (H100).

Imports torch, numpy and the standard library only; never jax and nothing of
``rba_tpu``.  Entry points: ``rba_tpu_torch.models.maskformer.build_model``,
``maskformer_infer_rba`` and ``maskformer_infer``; the sweep
(``python -m rba_tpu_torch.evalx.sweep``) and the trainer
(``python -m rba_tpu_torch.train.train_net``).
"""
