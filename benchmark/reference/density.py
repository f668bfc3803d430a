"""The benchmark's plain reference of the SpamTree model: the AG10
cross-covariance and, for every block of a tree, its conditional given its
reference ancestors, in float64 with plain PyTorch linear algebra.

It follows the dense NumPy oracle of the repository's tests
(``tests/_oracle_numpy.py``: ``DenseOracle._cov``, ``_factor_cache``,
``_loglik_w``, ``predict``), block by block instead of from the dense n x n
covariance, so that it fits at n = 1e6: blocks of one level are padded to
their level's widest block (padding rows get identity covariance and no
cross-covariance, which leaves every real block's numbers unchanged) and
solved in batches.  It imports nothing of the program: the tree is the
benchmark's frozen copy (``benchmark/reference/partition.py``).
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def tf32_round(x):
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest: the
    precision of a product's inputs on the tensor cores."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, tf32: bool):
    """a @ b, its inputs rounded to TF32 where ``tf32``."""
    return tf32_round(a) @ tf32_round(b) if tf32 else a @ b


def ag10(theta, q: int, c1, m1, c2, m2):
    """(..., a, b) AG10 cross-covariance between rows (c1 (..., a, dd), m1
    (..., a) 0-based margins) and (c2, m2), with the reference's theta
    layout: ai1 (q), ai2 (q), phi_i (q), the base's (c) or (a, b, c) for
    q > 2, then the latent margin distances D (lower triangle).  q = 1 is
    the exponential sigma2 exp(-phi h) with theta = (sigma2, ., ., phi)."""
    h = torch.cdist(c1, c2) if c1.shape[-2] and c2.shape[-2] else \
        c1.new_zeros(c1.shape[:-1] + (c2.shape[-2],))
    if q == 1:
        return theta[0] * torch.exp(-theta[3] * h)
    n_cbase = 3 if q > 2 else 1
    ai1, ai2, phi = theta[0:q], theta[q:2 * q], theta[2 * q:3 * q]
    Dm = theta.new_zeros(q, q)
    ix = 3 * q + n_cbase
    for j in range(q):
        for i in range(j + 1, q):
            Dm[i, j] = Dm[j, i] = theta[ix]
            ix += 1
    a1, a2 = m1[..., :, None], m2[..., None, :]
    v = Dm[a1, a2]
    if q > 2:
        a, b, c = theta[3 * q], theta[3 * q + 1], theta[3 * q + 2]
        psi = torch.exp(0.5 * b * torch.log1p(a * v))
        base = torch.exp(-c * h / psi) / psi ** 2
    else:
        c = theta[3 * q]
        base = torch.exp(-c * h / torch.sqrt(v + 1.0)) / (v + 1.0)
    cross = ai1[a1] * ai1[a2] * base
    own = ai2[a1] ** 2 * torch.exp(-phi[a1] * h)
    return torch.where(v == 0, cross + own, cross)


def prior_var(theta, q: int, m):
    """The AG10 variance at a row of margin ``m`` (the covariance at h = 0,
    same margin)."""
    if q == 1:
        return theta[0].expand(m.shape)
    return theta[0:q][m] ** 2 + theta[q:2 * q][m] ** 2


class Blocks:
    """The tree's blocks as padded index batches, one group per level and
    kind: ``groups`` is a list of dict(is_ref, pred, rows (B, S), anc (B,
    P)) with -1 padding; rows index the (sorted) data rows."""

    def __init__(self, tree):
        lv = np.asarray(tree.block_level)
        levels = sorted(set(int(v) for v in lv))
        is_ref = {res: bool(tree.res_is_ref[i] == 1)
                  for i, res in enumerate(levels)}
        self.groups = []
        for res in levels:
            ids = np.flatnonzero(lv == res)
            obs = np.asarray(tree.block_ct_obs)[ids] > 0
            for pred in (False, True):
                sel = ids[~obs] if pred else ids[obs]
                if not len(sel):
                    continue
                rows = [np.asarray(tree.block_rows[u], dtype=np.int64)
                        for u in sel]
                anc = [np.concatenate([np.asarray(tree.block_rows[p],
                                                  dtype=np.int64)
                                       for p in tree.parents[u]])
                       if len(tree.parents[u]) else np.zeros(0, np.int64)
                       for u in sel]
                self.groups.append(dict(
                    res=res, is_ref=is_ref[res] and not pred, pred=pred,
                    rows=_pad(rows), anc=_pad(anc)))


def _pad(arrs):
    width = max(len(a) for a in arrs)
    out = np.full((len(arrs), width), -1, dtype=np.int64)
    for i, a in enumerate(arrs):
        out[i, :len(a)] = a
    return out


def _conditionals(theta, q, coords, mv, rows, anc, tf32=False):
    """(H (B, S, P), R (B, S, S), rmask, amask) of a padded batch, in the
    dtype of ``coords`` (``tf32``: the products' inputs in TF32)."""
    rmask, amask = rows >= 0, anc >= 0
    r, a = rows.clamp(min=0), anc.clamp(min=0)
    cr, mr, ca, ma = coords[r], mv[r], coords[a], mv[a]
    eye = lambda k: torch.eye(k, dtype=coords.dtype, device=coords.device)
    Kcc = ag10(theta, q, cr, mr, cr, mr)
    both_r = rmask[:, :, None] & rmask[:, None, :]
    Kcc = torch.where(both_r, Kcc, eye(rows.shape[1]))
    if anc.shape[1] == 0:
        H = Kcc.new_zeros(rows.shape + (0,))
        return H, Kcc, rmask, amask
    Kaa = ag10(theta, q, ca, ma, ca, ma)
    Kaa = torch.where(amask[:, :, None] & amask[:, None, :], Kaa,
                      eye(anc.shape[1]))
    Kac = ag10(theta, q, ca, ma, cr, mr)
    Kac = torch.where(amask[:, :, None] & rmask[:, None, :], Kac, 0.0)
    La = torch.linalg.cholesky(Kaa)
    M = torch.linalg.solve_triangular(La, Kac, upper=False)
    R = Kcc - _mm(M.transpose(-1, -2), M, tf32)
    H = torch.linalg.solve_triangular(La.transpose(-1, -2), M,
                                      upper=True).transpose(-1, -2)
    return H, R, rmask, amask


def _batches(g, max_bytes=2.5e8):
    B, S = g["rows"].shape
    P = g["anc"].shape[1]
    step = max(1, int(max_bytes // (8 * max(P * P + 2 * P * S + S * S, 1))))
    for lo in range(0, B, step):
        yield slice(lo, min(B, lo + step))


def loglik_parts(blocks: Blocks, theta, q, coords, mv, w, tf32=False):
    """(logdetCi, quad) of w under the tree's conditionals at theta, float64:
    -0.5 sum_u log det R_u and -0.5 sum_u e_u' R_u^-1 e_u, e_u = w_u - H_u
    w_anc(u), over the observed blocks (reference levels with their full R,
    thin levels with its diagonal).  ``w`` (n,) on the device.  The
    blocks are computed in the dtype of ``coords`` (float64 for the
    reference) and summed in float64; ``tf32`` rounds the products' inputs
    to TF32 (the control)."""
    dt = coords.dtype
    theta = theta.to(dt)
    logdet = torch.zeros((), dtype=F64, device=coords.device)
    quad = torch.zeros((), dtype=F64, device=coords.device)
    wpad = torch.cat([w.to(dt), w.new_zeros(1, dtype=dt)])
    n = w.shape[0]
    for g in blocks.groups:
        if g["pred"]:
            continue
        rows_all = torch.as_tensor(g["rows"], device=coords.device)
        anc_all = torch.as_tensor(g["anc"], device=coords.device)
        for sl in _batches(g):
            rows, anc = rows_all[sl], anc_all[sl]
            H, R, rmask, amask = _conditionals(theta, q, coords, mv, rows,
                                               anc, tf32)
            wr = wpad[torch.where(rmask, rows, n)]
            wa = wpad[torch.where(amask, anc, n)]
            e = (wr - _mm(H, wa[..., None], tf32)[..., 0] if anc.shape[1]
                 else wr)
            if g["is_ref"]:
                L = torch.linalg.cholesky(R)
                logdet = logdet + 2.0 * torch.log(
                    torch.diagonal(L, dim1=-2, dim2=-1)).to(F64).sum()
                v = torch.linalg.solve_triangular(L, e[..., None],
                                                  upper=False)[..., 0]
                quad = quad + (v * v).to(F64).sum()
            else:
                r = torch.where(rmask, torch.diagonal(R, dim1=-2, dim2=-1),
                                1.0)
                if bool((r <= 0).any()):
                    raise np.linalg.LinAlgError("non-positive thin variance")
                logdet = logdet + torch.log(r).to(F64).sum()
                quad = quad + torch.where(rmask, e * e / r, 0.0).to(F64).sum()
    return float(-0.5 * logdet), float(-0.5 * quad)


def predictive(blocks: Blocks, theta, q, coords, mv, w, only_rows=None,
               tf32=False):
    """(rows, mean, var, prior var) of the prediction blocks' rows: w at each
    row given its block's reference ancestors, N(H w_anc, diag R), as the
    oracle's ``predict``, in the dtype of ``coords``.  ``only_rows`` (bool
    (n,) numpy) keeps the blocks that hold any of those rows."""
    out = [], [], [], []
    n = w.shape[0]
    dt = coords.dtype
    theta = theta.to(dt)
    wpad = torch.cat([w.to(dt), w.new_zeros(1, dtype=dt)])
    for g in blocks.groups:
        if not g["pred"]:
            continue
        rows_np, anc_np = g["rows"], g["anc"]
        if only_rows is not None:
            keep = (np.where(rows_np >= 0, only_rows[rows_np.clip(0)], False)
                    ).any(axis=1)
            rows_np, anc_np = rows_np[keep], anc_np[keep]
            if not len(rows_np):
                continue
        g2 = dict(rows=rows_np, anc=anc_np)
        rows_all = torch.as_tensor(rows_np, device=coords.device)
        anc_all = torch.as_tensor(anc_np, device=coords.device)
        for sl in _batches(g2):
            rows, anc = rows_all[sl], anc_all[sl]
            H, R, rmask, amask = _conditionals(theta, q, coords, mv, rows,
                                               anc, tf32)
            wa = wpad[torch.where(amask, anc, n)]
            mean = _mm(H, wa[..., None], tf32)[..., 0] if anc.shape[1] else \
                torch.zeros(rows.shape, dtype=dt, device=coords.device)
            var = torch.diagonal(R, dim1=-2, dim2=-1)
            prior = prior_var(theta, q, mv[rows.clamp(min=0)])
            out[0].append(rows[rmask])
            out[1].append(mean[rmask])
            out[2].append(var[rmask])
            out[3].append(prior[rmask])
    return tuple(torch.cat(x) for x in out)
