"""Covariance kernels for SpamTree GPs, in PyTorch (batched).

Port of ``spamtree_tpu/ops/covariance.py``; the same covariance families as
the reference package (reference: src/covariance_functions.cpp):

* model 0 — Apanasovich & Genton (2010) multivariate spatial cross-covariance
  on a 2-d domain, with the univariate exponential fast path when q == 1.
* model 1 — nonspatial univariate anisotropic exponential over many inputs.
* model 2 — AG10 with elevation as a third coordinate.

Every function broadcasts over leading batch dimensions, so a whole tree
level of blocks is one call (the JAX package vmaps instead); parameters
unpacked from a (C, n_theta) theta carry a chain axis, which leads the
result.  Per-row
parameter lookups are plain gathers by margin id; the JAX package writes
them as one-hot contractions, which give exactly the same values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CovModel(NamedTuple):
    """Static covariance-model spec (reference: covariance_functions.cpp:6-32).

    ``npars`` counts the non-latent-distance parameters: 3q + n_cbase
    (+1 for elevation); the full theta vector has ``npars + k`` entries where
    ``k = q(q-1)/2`` are the latent cross-distances packed into Dmat.
    """

    model: int  # 0 = AG10 spatial 2d, 1 = nonspatial univariate, 2 = AG10 + elevation
    q: int
    dd: int
    n_cbase: int
    npars: int
    k: int


def make_cov_model(dd: int, q: int, covariance_model: int = -1) -> CovModel:
    """Choose and size the covariance model (reference: covariance_functions.cpp:10-32)."""
    model = covariance_model
    if model == -1:
        if dd == 2:
            model = 0
        else:
            if q > 1:
                raise NotImplementedError(
                    "Multivariate on many inputs not implemented (matches reference)."
                )
            model = 1
    k = q * (q - 1) // 2
    if model == 0:
        n_cbase = 3 if q > 2 else 1
        npars = 3 * q + n_cbase
    elif model == 2:
        n_cbase = 3 if q > 2 else 1
        npars = 3 * q + n_cbase + 1
    elif model == 1:
        # sigmasq + one kernel weight per input column
        n_cbase = 0
        npars = 1 + dd
        k = 0
    else:
        raise ValueError(f"Unknown covariance model {model}")
    return CovModel(model=model, q=q, dd=dd, n_cbase=n_cbase, npars=npars, k=k)


class CovParams(NamedTuple):
    """Covariance parameters as tensors (one group may be unused per model)."""

    ai1: torch.Tensor  # (q,)
    ai2: torch.Tensor  # (q,)
    phi_i: torch.Tensor  # (q,)
    thetamv: torch.Tensor  # (n_cbase,)
    Dmat: torch.Tensor  # (q, q) latent cross-distances, 0 diagonal
    d_elevation: torch.Tensor  # scalar (model 2)
    sigmasq: torch.Tensor  # scalar (model 1)
    kweights: torch.Tensor  # (dd,) (model 1)


def vec_to_symmat(x: torch.Tensor, q: int) -> torch.Tensor:
    """Unpack q(q-1)/2 strictly-lower-triangular entries (column-major order)
    into a symmetric (q, q) matrix with zero diagonal
    (reference: covariance_functions.cpp:77-92); leading dimensions of
    ``x`` (a chain axis) lead the result."""
    rows, cols = [], []
    for j in range(q):
        for i in range(j + 1, q):
            rows.append(i)
            cols.append(j)
    res = torch.zeros(x.shape[:-1] + (q, q), dtype=x.dtype, device=x.device)
    if rows:
        res[..., rows, cols] = x
    return res + res.mT


def unpack_theta(theta: torch.Tensor, spec: CovModel) -> CovParams:
    """theta vector -> covariance components (reference: covariance_functions.cpp:34-75).

    ``theta`` (n_theta,) or (C, n_theta) with a chain axis, which then
    leads every component."""
    q = spec.q
    lead = theta.shape[:-1]
    z = theta.new_zeros(lead)
    zq = theta.new_zeros(lead + (q,))
    if spec.model in (0, 2):
        ai1 = theta[..., 0:q]
        ai2 = theta[..., q : 2 * q]
        phi_i = theta[..., 2 * q : 3 * q]
        thetamv = theta[..., 3 * q : 3 * q + spec.n_cbase]
        d_elev = theta[..., 3 * q + spec.n_cbase] if spec.model == 2 else z
        if spec.k > 0:
            Dmat = vec_to_symmat(theta[..., spec.npars : spec.npars + spec.k],
                                 q)
        else:
            Dmat = theta.new_zeros(lead + (1, 1))
        return CovParams(ai1, ai2, phi_i, thetamv, Dmat, d_elev, z, zq)
    elif spec.model == 1:
        return CovParams(zq, zq, zq, z[..., None],
                         theta.new_zeros(lead + (1, 1)), z, theta[..., 0],
                         theta[..., 1:])
    raise ValueError(f"Unknown covariance model {spec.model}")


def _per_chain(x, nd: int):
    """A per-chain scalar (C,) as (C, 1, ..., 1) against ``nd`` more
    dimensions; a 0-d scalar (one chain) passes through."""
    return x if x.dim() == 0 else x.reshape(x.shape + (1,) * nd)


def _c_base(h, v, thetamv, q):
    """Gneiting-style base covariance C(h, v) (reference: covariance_functions.cpp:113-135).

    ``v`` is the latent cross-distance (0 for same-margin); time is always 0
    in the live reference path, so it is dropped.  ``thetamv`` (n_cbase,)
    or (C, n_cbase); ``h`` has no chain axis."""
    th = lambda i: _per_chain(thetamv[..., i], h.dim())
    if q > 2:
        a_psi1, beta_psi1, c_phi1 = th(0), th(1), th(2)
        psi1_sqrt = torch.exp(0.5 * beta_psi1 * torch.log1p(a_psi1 * v))
        return torch.exp(-c_phi1 * h / psi1_sqrt) / (psi1_sqrt * psi1_sqrt)
    elif q == 2:
        c_phi1 = th(0)
        return torch.exp(-c_phi1 * h / torch.sqrt(v + 1.0)) / (v + 1.0)
    return torch.exp(-th(0) * h)


def pairwise_cov(cx1, mv1, cx2, mv2, params: CovParams, spec: CovModel):
    """Dense (..., n1, n2) cross-covariance between two location/margin sets
    (reference ``Covariancef``, covariance_functions.cpp:416-436).

    cx* are (..., n*, dd) coordinates and mv* (..., n*) 0-based margin ids;
    leading dimensions broadcast (a level's block batch).  Parameters with
    a chain axis (``unpack_theta`` of (C, n_theta)) put C first:
    (C, ..., n1, n2)."""
    delta = cx1[..., :, None, :] - cx2[..., None, :, :]
    if spec.model == 1:
        if params.kweights.dim() == 1:
            wsq = torch.einsum("...ijk,k->...ij", delta * delta,
                               params.kweights)
        else:
            wsq = torch.einsum("...ijk,ck->c...ij", delta * delta,
                               params.kweights)
        sig = _per_chain(params.sigmasq, wsq.dim() - 1)
        return sig * torch.exp(-wsq) + (wsq == 0).to(wsq.dtype) * 1e-3

    nsp = 2 if spec.model == 0 else 3  # model 2: h over (x, y, elevation)
    d2 = torch.sum(delta[..., :nsp] * delta[..., :nsp], dim=-1)
    h = torch.sqrt(torch.clamp(d2, min=0.0))

    if spec.model == 0 and spec.q == 1:
        # univariate fast path: sigmasq = ai1[0], phi = thetamv[0]
        # (reference: covariance_functions.cpp:220-221 -> cexpcov 95-111)
        return (_per_chain(params.ai1[..., 0], h.dim())
                * torch.exp(-_per_chain(params.thetamv[..., 0], h.dim()) * h))

    # One C_base(h, v) evaluation covers same- and cross-margin pairs
    # (C_base(h, 0) is the same-margin base); only the margin's nugget term
    # needs the v == 0 select (reference: covariance_functions.cpp:250-255).
    # With a chain axis every per-margin gather is (C, ..., n*).
    v = params.Dmat[..., mv1[..., :, None], mv2[..., None, :]]
    ai1_i = params.ai1[..., mv1][..., :, None]
    ai1_j = params.ai1[..., mv2][..., None, :]
    ai2_i = params.ai2[..., mv1][..., :, None]
    phi_ii = params.phi_i[..., mv1][..., :, None]
    same = v == 0
    coef = torch.where(same, ai1_i * ai1_i, ai1_i * ai1_j)
    nugget = torch.where(same, ai2_i * ai2_i * torch.exp(-phi_ii * h), 0.0)
    return coef * _c_base(h, v, params.thetamv, spec.q) + nugget


def pairwise_cov_diag(cx, mv, params: CovParams, spec: CovModel):
    """Variance at each row: the diagonal of pairwise_cov(cx, cx) without
    the n^2 cost (per-location thin / prediction paths)."""
    zero = cx.new_zeros(cx.shape[:-1])
    if spec.model == 1:
        return zero + _per_chain(params.sigmasq + 1e-3, zero.dim())
    if spec.model == 0 and spec.q == 1:
        return zero + _per_chain(params.ai1[..., 0], zero.dim())
    ai1 = params.ai1[..., mv]
    ai2 = params.ai2[..., mv]
    return ai1 * ai1 * _c_base(zero, zero, params.thetamv, spec.q) + ai2 * ai2


def cross_covariance_ag10(coords1, mv1, coords2, mv2, ai1, ai2, phi_i,
                          thetamv, Dmat, device="cuda",
                          dtype=torch.float64) -> torch.Tensor:
    """Public AG10 cross-covariance builder for data generation (reference
    ``CrossCovarianceAG10``, covariance_functions.cpp:301-355).  ``mv*``
    are 1-based margin ids, as in the reference's user-facing API.  Runs
    on ``device`` (pass "cpu" where there is no card)."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    coords1, coords2, Dmat = t(coords1), t(coords2), t(Dmat)
    q = Dmat.shape[0]
    if q < 2:
        raise ValueError("Invalid Dmat for multivariate data")
    dd = coords1.shape[1]
    spec = CovModel(model=0, q=q, dd=dd, n_cbase=(3 if q > 2 else 1),
                    npars=0, k=0)
    zero = t(0.0)
    params = CovParams(t(ai1), t(ai2), t(phi_i), t(thetamv), Dmat,
                       zero, zero, t([0.0] * dd))
    m1 = torch.as_tensor(mv1, dtype=torch.long, device=device) - 1
    m2 = torch.as_tensor(mv2, dtype=torch.long, device=device) - 1
    return pairwise_cov(coords1, m1, coords2, m2, params, spec)
