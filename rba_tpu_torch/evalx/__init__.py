"""OOD evaluation of the port: histogram metrics, ``OODEvaluator`` and the sweep CLI
(``python -m rba_tpu_torch.evalx.sweep``)."""
