"""Stencil ops: plans and torch-ops steps (``lowering``, ``stencil``) and
the hand-written CUDA kernels (``cuda_stencil``, sources in ``csrc/``)."""
