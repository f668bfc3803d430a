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

``cov_block`` is what the model's sweeps call: a level's covariance blocks
with the caller's mask applied (or identity-padded).  On a CUDA tensor of
model 0, every q, in float32 or float64, it launches kernel K6
(``csrc/ag10_cov.cu``), which writes each masked block once where the
plain version runs ~20 elementwise passes over it; anything it does not
take there raises.  ``cov_block_plain`` -- ``pairwise_cov`` and the mask --
is the same function in plain PyTorch: it serves CPU tensors, and models 1
and 2 on either device (no benchmark cell runs them), and the tests and
``chip_smoke.py`` hold the kernel against it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from spamtree_tpu_torch.ops import kernel_counts
from spamtree_tpu_torch.ops.linalg import identity_pad
from spamtree_tpu_torch.utils.cost import counted


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
    # stacked entry by entry: an index list would cross to the device as a
    # host copy on every call, which a CUDA graph cannot capture
    zero = x.new_zeros(x.shape[:-1])
    low, k = {}, 0
    for j in range(q):
        for i in range(j + 1, q):
            low[(i, j)] = x[..., k]
            k += 1
    res = torch.stack([torch.stack([low.get((i, j), zero) for j in range(q)],
                                   dim=-1) for i in range(q)], dim=-2)
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


MAX_Q = 16  # K6 keeps a chain's q^2 margin-pair constants in shared memory

_FNS = {torch.float32: "st_ag10_cov_f32", torch.float64: "st_ag10_cov_f64"}
_bound: dict = {}


class _CovArgs(ctypes.Structure):
    """K6's arguments (``CovArgs`` in ``csrc/ag10_cov.cu``, field by field):
    pointers, strides in elements, sizes."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "cx1", "cx2", "mv1", "mv2", "m1", "m2", "out",
        "ai1", "ai2", "phi", "tmv", "dmat")]
                + [(n, ctypes.c_longlong * 2) for n in (
                    "s_ai1", "s_ai2", "s_phi", "s_tmv")]
                + [("s_dmat", ctypes.c_longlong * 3)]
                + [(n, ctypes.c_longlong) for n in ("C", "B", "n1", "n2")]
                + [(n, ctypes.c_int) for n in ("dd", "q", "eye")])


def _kernel(dtype):
    """The ctypes entry point of K6 for ``dtype``; builds the library at
    first use."""
    if dtype not in _bound:
        from spamtree_tpu_torch.ops import _build

        fn = getattr(_build.load("ag10_cov"), _FNS[dtype])
        fn.argtypes = [ctypes.POINTER(_CovArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[dtype] = fn
    return _bound[dtype]


def cov_block_plain(cx1, mv1, cx2, mv2, params: CovParams, spec: CovModel,
                    m1, m2=None, eye: bool = False, cov=pairwise_cov):
    """``cov`` (``pairwise_cov``) with the caller's mask: ``K * (m1[:,
    None] & m2[None, :])``, or with ``eye`` ``identity_pad(K, m1)``
    (padded rows and columns set to the identity's; n1 == n2, no
    ``m2``)."""
    K = cov(cx1, mv1, cx2, mv2, params, spec)
    if eye:
        return identity_pad(K, m1)
    return K * (m1[..., :, None] & m2[..., None, :])


def cov_block_cost(C: int, B: int, n1: int, n2: int, q: int, dd: int,
                   masks: int, dtype) -> tuple:
    """(flops, bytes) of one K6 call writing C x B blocks of (n1, n2):
    the rows' and columns' coordinates (dd each) and int64 ids read once,
    ``masks`` bool masks of n1 and n2 entries (2; the identity pad reads
    one mask for both: 1), the block written once.  Operations an
    entry: the two differences, their squares and sum, the square root,
    the distance's product and quotient, an exp, the base's quotient, the
    coefficient's product, the nugget's product, exp and sum, and the
    mask's product: 15 (q = 1: no quotients, no nugget: 10)."""
    it = dtype.itemsize
    per_entry = 10 if q == 1 else 15
    rows = B * (n1 + n2)
    return (C * B * n1 * n2 * per_entry,
            rows * (dd * it + 8) + masks * rows + C * B * n1 * n2 * it)


def _cost(cx1, mv1, cx2, mv2, params, spec, m1, m2, eye, cov):
    """``cov_block_cost`` of a ``cov_block`` call."""
    return cov_block_cost(params.ai1.shape[:-1].numel(),
                          cx1.shape[:-2].numel(), cx1.shape[-2],
                          cx2.shape[-2], spec.q, cx1.shape[-1],
                          1 if eye else 2, cx1.dtype)


def _strides(x: torch.Tensor, nd: int):
    """(chain stride, then the last ``nd`` dims' strides) of a parameter
    with or without a chain axis; 0 for the chain without one."""
    st = x.stride()
    return ((st[0] if x.dim() > nd else 0),) + tuple(st[-nd:])


@counted(_cost)
def cov_block(cx1, mv1, cx2, mv2, params: CovParams, spec: CovModel,
              m1, m2=None, eye: bool = False, cov=pairwise_cov):
    """A level's masked covariance blocks: what ``cov_block_plain``
    returns, (C, B, n1, n2) with a chain axis in ``params`` (C leads) or
    (B, n1, n2), contiguous.  cx* (B, n*, dd), mv* (B, n*) int64, m* (B,
    n*) bool; ``eye`` identity-pads with ``m1`` (n1 == n2) and takes no
    ``m2``, which every other call needs.

    A CUDA tensor of model 0 launches kernel K6 (one launch for every
    chain and block, counted as ``cov_launches``) or raises; any other
    call runs ``cov_block_plain`` (``cov_plain_calls``).  The route
    follows the device, the model and the dtype alone.  K6 computes
    ``pairwise_cov``'s formula; a caller that hands another function as
    ``cov`` (the benchmark's ``margins_swapped`` control rebinds the one
    ``model.core`` hands) gets it on the plain route, on any device."""
    if eye == (m2 is not None):
        raise ValueError("cov_block: an m2 mask with eye=False and none "
                         "with eye=True")
    if cx1.device.type != "cuda" or spec.model != 0 or cov is not pairwise_cov:
        kernel_counts.add("cov_plain_calls")
        return cov_block_plain(cx1, mv1, cx2, mv2, params, spec, m1, m2, eye,
                               cov)
    dtype = cx1.dtype
    if dtype not in _FNS:
        raise TypeError(f"cov_block: dtype {dtype} not in (float32, float64)")
    if not 1 <= spec.q <= MAX_Q:
        raise ValueError(f"cov_block: q={spec.q} outside 1..{MAX_Q}")
    lead, n1, n2, dd = cx1.shape[:-2], cx1.shape[-2], cx2.shape[-2], \
        cx1.shape[-1]
    if eye and n1 != n2:
        raise ValueError("cov_block: eye needs n1 == n2")
    masks = {"m1": m1} if eye else {"m1": m1, "m2": m2}
    want = {"cx2": (cx2, lead + (n2, dd)), "mv1": (mv1, lead + (n1,)),
            "mv2": (mv2, lead + (n2,))}
    want.update({k: (v, lead + ((n1,) if k == "m1" else (n2,)))
                 for k, v in masks.items()})
    for name, (x, shape) in want.items():
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"cov_block: {name} {tuple(x.shape)}, expected "
                             f"{tuple(shape)}")
    if dd < 2 or mv1.dtype != torch.int64 or mv2.dtype != torch.int64 or any(
            v.dtype != torch.bool for v in masks.values()):
        raise TypeError("cov_block: coordinates need dd >= 2, margin ids "
                        "int64 and masks bool")
    tensors = [cx1, cx2, mv1, mv2, *params[:5], *masks.values()]
    if any(t.device != cx1.device for t in tensors) or any(
            p.dtype != dtype for p in params[:5]):
        raise ValueError("cov_block: every tensor on one device, the "
                         "parameters in the coordinates' dtype")
    chains = params.ai1.shape[:-1]  # (C,), or () without a chain axis
    out = torch.empty(chains + lead + (n1, n2), dtype=dtype,
                      device=cx1.device)
    if out.numel() == 0:
        return out
    cx1, cx2, mv1, mv2 = (t.contiguous() for t in (cx1, cx2, mv1, mv2))
    m1 = m1.contiguous()
    m2 = None if eye else m2.contiguous()
    p = params
    a = _CovArgs(
        cx1=cx1.data_ptr(), cx2=cx2.data_ptr(), mv1=mv1.data_ptr(),
        mv2=mv2.data_ptr(), m1=m1.data_ptr(),
        m2=None if eye else m2.data_ptr(), out=out.data_ptr(),
        ai1=p.ai1.data_ptr(), ai2=p.ai2.data_ptr(), phi=p.phi_i.data_ptr(),
        tmv=p.thetamv.data_ptr(), dmat=p.Dmat.data_ptr(),
        s_ai1=_strides(p.ai1, 1), s_ai2=_strides(p.ai2, 1),
        s_phi=_strides(p.phi_i, 1), s_tmv=_strides(p.thetamv, 1),
        s_dmat=_strides(p.Dmat, 2), C=chains.numel(), B=lead.numel(), n1=n1,
        n2=n2, dd=dd, q=spec.q, eye=int(eye))
    fn = _kernel(dtype)
    with torch.cuda.device(cx1.device):
        stream = torch.cuda.current_stream(cx1.device).cuda_stream
        err = fn(ctypes.byref(a), stream)
    if err != 0:
        raise RuntimeError(f"cov_block kernel launch failed: CUDA error {err}")
    kernel_counts.add("cov_launches")
    return out


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
