"""ffs_tpu_torch — the fast-feedback spotfinder and integrator on PyTorch
and CUDA.

A port of :mod:`ffs_tpu` (JAX on a TPU) to PyTorch on an NVIDIA GPU, laid
out module for module like the JAX package.  Plain tensor code is eager
PyTorch; every TPU (Pallas) kernel on the ported paths is a hand-written
CUDA kernel for Hopper (``csrc/``, built by ``utils/cuda_build``) with a
plain PyTorch version beside it.  The package stands alone: it never
imports JAX or ``ffs_tpu``, and keeps its own copies of the framework-free
modules it needs (readers, models, host CC, the 3D merge, the CLI helpers,
the host C++ under ``csrc/host/``) at the same relative paths.
"""

__version__ = "0.1.0"
