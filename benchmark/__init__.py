"""The benchmark of the PyTorch and CUDA port (``tpu_stencil_torch``):
``python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1``."""
