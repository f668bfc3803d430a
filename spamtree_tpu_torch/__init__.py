"""spamtree_tpu_torch: the SpamTree sampler in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of ``spamtree_tpu`` (the JAX package beside this one, which stays
the reference).  Module layout and function names mirror the JAX package:
``tree/`` (NumPy partitioner and padded schedule), ``ops/`` (covariance,
masked linear algebra, the batched inverse-Cholesky kernel, the fused
thin-level kernels), ``model/``
(sweeps, Gibbs, MCMC) and ``api.py``.  This package imports neither jax nor
``spamtree_tpu``.
"""

import torch as _torch

# Full-precision f32 products: the treed-GP Schur complements
# (Kcc - M'M with strongly correlated parents) cancel catastrophically at
# TF32 and fail Cholesky.  Same pin as the JAX package's matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from spamtree_tpu_torch.api import spamtree  # noqa: E402

__all__ = ["spamtree"]
__version__ = "0.1.0"
