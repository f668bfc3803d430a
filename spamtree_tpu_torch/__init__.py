"""spamtree_tpu_torch: the SpamTree sampler in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of ``spamtree_tpu`` (the JAX package beside this one, which stays
the reference).  Module layout and function names mirror the JAX package:
``tree/`` (NumPy partitioner and padded schedule), ``ops/`` (covariance,
masked linear algebra, the batched inverse-Cholesky kernel, the fused
thin-level kernels), ``model/``
(sweeps, Gibbs, MCMC), ``utils/`` (checkpoints, fit files, summaries) and
``api.py``.  This package imports neither jax nor
``spamtree_tpu``.
"""

import torch as _torch

# Full-precision f32 products: the treed-GP Schur complements
# (Kcc - M'M with strongly correlated parents) cancel catastrophically at
# TF32 and fail Cholesky.  Same pin as the JAX package's matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from spamtree_tpu_torch.api import spamtree, spamtree_predict  # noqa: E402
from spamtree_tpu_torch.model.transforms import (  # noqa: E402
    transf_back as par_huvtransf_back,
    transf_fwd as par_huvtransf_fwd,
)
from spamtree_tpu_torch.ops.covariance import (  # noqa: E402
    cross_covariance_ag10 as CrossCovarianceAG10,
    vec_to_symmat,
)
from spamtree_tpu_torch.tree.partition import (  # noqa: E402
    axis_bins,
    kthresholds,
    make_tree,
)
from spamtree_tpu_torch.utils.fitio import load_fit, save_fit  # noqa: E402
from spamtree_tpu_torch.utils.summaries import (  # noqa: E402
    ess,
    find_nan,
    find_not_nan,
    list_cubes_mean,
    list_mean,
    list_qtile,
    rhat,
    summarize_fit,
)

__all__ = [
    "spamtree", "spamtree_predict", "CrossCovarianceAG10", "list_mean",
    "list_qtile", "list_cubes_mean", "find_nan", "find_not_nan",
    "vec_to_symmat", "par_huvtransf_fwd", "par_huvtransf_back",
    "kthresholds", "axis_bins", "make_tree", "rhat", "ess", "save_fit",
    "load_fit", "summarize_fit",
]
__version__ = "0.1.0"
