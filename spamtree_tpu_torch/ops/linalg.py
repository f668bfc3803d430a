"""Batched masked linear algebra helpers (identity-padding semantics).

Port of ``spamtree_tpu/ops/linalg.py``.  Padded rows/cols of a level's
block batch carry an identity block, so factorisations and solves are
well-defined and contribute nothing to log-determinants or quadratic forms.

Cholesky failure never raises: a failed block comes back NaN and its ok
flag false (``torch.linalg.cholesky`` would raise, and ``cholesky_ex``
leaves finite garbage, so both are wrapped).
"""

from __future__ import annotations

import torch

from spamtree_tpu_torch.ops import kernel_counts
from spamtree_tpu_torch.ops.chol import inv_chol, max_s


def identity_pad(mat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Replace padded rows/cols of a batched (..., B, S, S) matrix with
    identity; ``mask`` is (B, S) validity."""
    m2 = mask[..., :, None] & mask[..., None, :]
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
    return torch.where(m2, mat, eye)


def _diag_ok(T: torch.Tensor) -> torch.Tensor:
    d = torch.diagonal(T, dim1=-2, dim2=-1)
    return torch.all(torch.isfinite(d) & (d > 0), dim=-1)


def chol_nan(m: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky factor with failed blocks set to NaN (what
    ``jnp.linalg.cholesky`` returns there)."""
    L, info = torch.linalg.cholesky_ex(m)
    return torch.where((info != 0)[..., None, None], float("nan"), L)


def chol_masked(mat: torch.Tensor, mask: torch.Tensor):
    """Cholesky of the identity-padded batch; returns (L, ok) per block."""
    L = chol_nan(identity_pad(mat, mask))
    kernel_counts.add("plain_blocks", L.shape[:-2].numel())
    return L, _diag_ok(L)


def tri_solve(L: torch.Tensor, b: torch.Tensor, trans: bool = False):
    """Solve L x = b (or L' x = b) for batched lower-triangular L."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, b, upper=True)
    return torch.linalg.solve_triangular(L, b, upper=False)


def tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a batched lower-triangular factor."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return tri_solve(L, eye.expand_as(L))


def chol_inv_masked(mat: torch.Tensor, mask: torch.Tensor,
                    use_kernel: bool = False):
    """Cholesky + triangular inverse of an identity-padded batch.

    Returns (L, Linv, ok).  With ``use_kernel`` (S <= ``chol.max_s``: 96
    in float32, 64 in float64) it goes through kernel K1
    (``ops.chol.inv_chol``), which never writes L, so **L comes back None
    on that path** and ok derives from diag(Linv) = 1/diag(L).
    Otherwise L is ``cholesky_ex``'s factor with failed blocks set to NaN.
    The callers choose the route by shape (``core.py`` passes
    ``use_kernel and S <= max_s(dtype)``; the JAX package's Pallas kernel
    stops at 64), not as a fallback on error.

    ``mat`` may carry leading dimensions before the block axis (a chain
    axis: (C, B, S, S)); the kernel takes them folded into one (C*B, S, S)
    batch, a view of the contiguous padded matrices, so one launch serves
    every chain; ok comes back (C, B).  Its blocks count under K1's route
    where the kernel runs (a CUDA tensor), under the plain one otherwise
    (``ops.kernel_counts``: ``k1_blocks``, ``plain_blocks``)."""
    m = identity_pad(mat, mask)
    if use_kernel:
        S = m.shape[-1]
        if S > max_s(m.dtype):
            raise ValueError(f"chol_inv_masked: S={S} > {max_s(m.dtype)}")
        L, a = None, m.contiguous()
        Linv = (inv_chol(a) if a.dim() == 3
                else inv_chol(a.reshape(-1, S, S)).reshape(a.shape))
    else:
        L = chol_nan(m)
        Linv = tri_inv(L)
    kernel_counts.add("k1_blocks" if use_kernel and m.device.type == "cuda"
                      else "plain_blocks", m.shape[:-2].numel())
    return L, Linv, _diag_ok(Linv if L is None else L)
