"""Robust Adaptive Metropolis (Vihola 2012), in PyTorch.

Port of ``spamtree_tpu/model/ram.py`` (reference: ``RAMAdapt``,
src/mh_adapt.h:40-135): rank-1 update of the proposal Cholesky factor
targeting acceptance 0.234, with an optional g0-iteration warmup.  The
proposal factors are tensors on the model's device.  For one chain the
counters are host values, since its sampler resolves each accept decision
on the host; batched chains carry a leading chain axis on the factors and
(C,) counters on the device.  The warmup flag is a host value either way
(it depends on the iteration alone).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

ALPHA_STAR = 0.234
GAMMA = 0.5 + 1e-6
G0 = 50  # warmup iterations (reference: mh_adapt.h:83)


class RAMState(NamedTuple):
    paramsd: torch.Tensor  # (p, p) lower-triangular proposal factor
    prodparam: torch.Tensor  # (p, p) warmup accumulator
    started: bool
    propos_count: object  # float, or a (C,) tensor for batched chains
    accept_count: object


def ram_init(metropolis_sd: torch.Tensor) -> RAMState:
    """metropolis_sd is the initial proposal covariance S (reference: mh_adapt.h:84-87)."""
    paramsd = torch.linalg.cholesky(metropolis_sd)
    return RAMState(paramsd=paramsd, prodparam=paramsd / (G0 + 1.0),
                    started=False, propos_count=0.0, accept_count=0.0)


def ram_set_proposal(ram: RAMState, cov) -> RAMState:
    """Replace the proposal covariance of a not-yet-started RAM state
    (numpy Cholesky of ``cov``: a matrix, a per-dimension variance vector,
    or a scalar)."""
    cov = np.asarray(cov, dtype=np.float64)
    p = ram.paramsd.shape[-1]
    if cov.ndim == 1:
        cov = np.diag(cov)
    elif cov.ndim == 0:
        cov = np.eye(p) * float(cov)
    pa = torch.as_tensor(np.linalg.cholesky(cov), dtype=ram.paramsd.dtype,
                         device=ram.paramsd.device)
    return ram._replace(paramsd=pa, prodparam=pa / (G0 + 1.0))


def ram_adapt(state: RAMState, U: torch.Tensor, alpha: torch.Tensor, mc: int,
              reference_warmup: bool = False) -> RAMState:
    """One adaptation step at iteration ``mc``.

    Default: plain Vihola (2012) rank-1 coercion of the proposal factor from
    iteration 0.  ``reference_warmup=True`` reproduces the reference's
    variant (mh_adapt.h:117-135): accumulate sum U U' / (mc+1) for g0=50
    iterations and replace the proposal factor with it at switch-on.

    ``U`` (p,) and ``alpha`` () for one chain, or (C, p) and (C,) with the
    state's factors (C, p, p): each chain adapts its own factor."""
    p = U.shape[-1]
    outer = U[..., :, None] * U[..., None, :]
    # per-chain scalars against the (p, p) matrices
    mat = (lambda x: x) if U.dim() == 1 else (lambda x: x[..., None, None])

    def rank1(paramsd, i):
        eta = min(1.0, p * (i + 1.0) ** (-GAMMA))
        a = torch.clamp(alpha, max=1.0)
        Sigma = (torch.eye(p, dtype=U.dtype, device=U.device)
                 + eta * mat(a - ALPHA_STAR) * outer
                 / mat(torch.sum(U * U, dim=-1)))
        new_sd, info = torch.linalg.cholesky_ex(paramsd @ Sigma @ paramsd.mT)
        ok = (info == 0) & torch.isfinite(new_sd).flatten(-2).all(-1)
        return torch.where(mat(ok), new_sd, paramsd)

    if not reference_warmup:
        return state._replace(paramsd=rank1(state.paramsd, mc))
    if mc < G0:
        return state._replace(
            prodparam=state.prodparam + outer / (mc + 1.0))
    paramsd = state.paramsd if state.started else state.prodparam
    return state._replace(paramsd=rank1(paramsd, mc - G0), started=True)
