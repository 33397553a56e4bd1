"""ffs_tpu_torch — the fast-feedback spotfinder on PyTorch and CUDA.

A port of :mod:`ffs_tpu` (JAX on a TPU) to PyTorch on an NVIDIA GPU, laid
out module for module like the JAX package.  Plain tensor code is eager
PyTorch; every TPU (Pallas) kernel on the ported path is a hand-written
CUDA kernel for Hopper (``csrc/``, built by ``utils/cuda_build``) with a
plain PyTorch version beside it.  Framework-free code (readers, models,
host CC, the 3D merge, the CLI helpers) is imported from ``ffs_tpu``.
This package never imports JAX.
"""

__version__ = "0.1.0"
