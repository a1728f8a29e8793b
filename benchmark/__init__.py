"""The benchmark of rba_tpu_torch, the PyTorch/CUDA port: see run.py and BENCHMARK.json."""
