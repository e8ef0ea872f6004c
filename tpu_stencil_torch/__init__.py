"""tpu_stencil_torch — iterated image convolution in PyTorch with
hand-written CUDA kernels for an NVIDIA H100.

The port of the JAX package ``tpu_stencil`` (which stays the reference it
is held against, byte for byte). It imports ``torch`` and numpy and nothing
of JAX or of the JAX package.

Entry points: ``python -m tpu_stencil_torch IMG W H REPS {grey,rgb}``
(:mod:`tpu_stencil_torch.cli`), :func:`tpu_stencil_torch.driver.run_job`,
and the model :class:`tpu_stencil_torch.models.blur.IteratedConv2D`. They
run on the GPU unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
