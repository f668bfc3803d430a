"""Covariance port parity: pairwise_cov, pairwise_cov_diag, unpack_theta and
cross_covariance_ag10 equal the JAX functions in float64 on the same
numpy-made inputs.  rtol 1e-12: the same elementwise formulas, so only
libm rounding of exp/sqrt/log1p separates the two."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spamtree_tpu.ops import covariance as cj
from spamtree_tpu_torch.ops import covariance as ct

RTOL = 1e-12

# (model, q, dd): AG10 q=1 fast path / q=2 closed form / q=3 Gneiting base,
# nonspatial univariate, AG10 with elevation
CASES = [(0, 1, 2), (0, 2, 2), (0, 3, 2), (1, 1, 3), (2, 2, 3)]


def _inputs(model, q, dd, seed=0):
    rng = np.random.default_rng(seed)
    spec_j = cj.make_cov_model(dd, q, model)
    nt = spec_j.npars + spec_j.k
    theta = rng.uniform(0.3, 2.0, size=nt)
    if model in (0, 2) and q > 2:
        theta[3 * q + 1] = 0.4  # beta_psi1 in (0, 1)
    c1, c2 = rng.uniform(size=(3, 7, dd)), rng.uniform(size=(3, 5, dd))
    m1, m2 = rng.integers(0, q, size=(3, 7)), rng.integers(0, q, size=(3, 5))
    c2[0, 0] = c1[0, 0]  # a zero-distance pair (model 1's nugget term)
    return spec_j, theta, c1, m1, c2, m2


@pytest.mark.parametrize("model,q,dd", CASES,
                         ids=[f"model{m}_q{q}" for m, q, _ in CASES])
def test_covariance_matches_jax(model, q, dd):
    spec_j, theta, c1, m1, c2, m2 = _inputs(model, q, dd)
    spec_t = ct.make_cov_model(dd, q, model)
    assert tuple(spec_t) == tuple(spec_j)
    pj = cj.unpack_theta(jnp.asarray(theta), spec_j)
    pt = ct.unpack_theta(torch.as_tensor(theta), spec_t)
    for a, b in zip(pj, pt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL)

    # batched port vs per-block JAX calls
    kt = ct.pairwise_cov(torch.as_tensor(c1), torch.as_tensor(m1),
                         torch.as_tensor(c2), torch.as_tensor(m2), pt, spec_t)
    dt = ct.pairwise_cov_diag(torch.as_tensor(c1), torch.as_tensor(m1), pt,
                              spec_t)
    for b in range(c1.shape[0]):
        kj = cj.pairwise_cov(jnp.asarray(c1[b]), jnp.asarray(m1[b]),
                             jnp.asarray(c2[b]), jnp.asarray(m2[b]), pj, spec_j)
        np.testing.assert_allclose(kt[b].numpy(), np.asarray(kj), rtol=RTOL)
        dj = cj.pairwise_cov_diag(jnp.asarray(c1[b]), jnp.asarray(m1[b]), pj,
                                  spec_j)
        np.testing.assert_allclose(dt[b].numpy(), np.asarray(dj), rtol=RTOL)
        kself = ct.pairwise_cov(torch.as_tensor(c1[b]), torch.as_tensor(m1[b]),
                                torch.as_tensor(c1[b]), torch.as_tensor(m1[b]),
                                pt, spec_t)
        np.testing.assert_allclose(torch.diagonal(kself).numpy(),
                                   dt[b].numpy(), rtol=RTOL)

    if model == 0 and q >= 2:
        ai1, ai2, phi = theta[:q], theta[q:2 * q], theta[2 * q:3 * q]
        tmv = theta[3 * q:3 * q + spec_j.n_cbase]
        D = np.array(pj.Dmat)
        args = (c1[0], m1[0] + 1, c2[0], m2[0] + 1, ai1, ai2, phi, tmv, D)
        np.testing.assert_allclose(ct.cross_covariance_ag10(
                                       *args, device="cpu").numpy(),
                                   np.asarray(cj.cross_covariance_ag10(*args)),
                                   rtol=RTOL)
