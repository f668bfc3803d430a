"""Chain-level parity of the port against the dense NumPy oracle of the
reference sampler (``tests/_oracle_numpy.py``), on the port alone in
float64: the data, trees, priors, starts and thresholds of
tests/test_reference_oracle.py, run through ``spamtree_tpu_torch.spamtree``
with its ``prior=``, ``starting=``, ``settings=`` and ``debug=`` knobs.
The oracle shares no code with the port but the tree.  The aligned n=2500
case is in test_torch_oracle_aligned.py (its own test worker).

``univariate_parity`` is also the oracle phase of ``chip_smoke.py``, which
runs the port's chain on the card (``device="cuda"``)."""

import numpy as np
import pytest
import torch

import spamtree_tpu_torch
from spamtree_tpu_torch.tree.partition import make_tree

from _oracle_numpy import DenseOracle

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    # several test workers share the cores; the eager chain's small ops
    # gain nothing from intra-op threads
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch_se(x, lag=60):
    """Batch-means standard error of the mean for an autocorrelated chain."""
    x = np.asarray(x, dtype=np.float64)
    nb = len(x) // lag
    bm = x[: nb * lag].reshape(nb, lag).mean(axis=1)
    return float(bm.std(ddof=1) / np.sqrt(nb))


def _gp_data(seed, n, n_miss):
    """Univariate exponential-GP data (sigma2 1.5, phi 5, tausq 0.1) on
    sorted coordinates, n_miss rows held out."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2))
    # pre-sorted, so the port's internal lexsort is the identity
    coords = coords[np.lexsort((np.arange(n), coords[:, 1], coords[:, 0]))]
    D = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
    CC = 1.5 * np.exp(-5.0 * D)
    w_true = np.linalg.cholesky(CC + 1e-10 * np.eye(n)) @ rng.normal(size=n)
    X = rng.normal(size=(n, 2))
    y_full = X @ np.array([1.0, -0.5]) + w_true + np.sqrt(0.1) * rng.normal(size=n)
    y = y_full.copy()
    miss = np.zeros(n, dtype=bool)
    miss[rng.choice(n, size=n_miss, replace=False)] = True
    y[miss] = np.nan
    return coords, X, y, y_full, miss


def check_parity(out, oc, miss, y_full, q, sd_frac=None, theta_dims=()):
    """tests/test_reference_oracle.py's assertions: beta and tausq means
    within 5 combined batch-mean SEs per margin; the latent field's
    posterior means pointwise within MC error (mean z < 0.35, correlation
    > 0.99); ``theta_dims`` within max(5 SE, 25 %); held-out RMSPE within
    10 % of the oracle's, and with ``sd_frac`` both below sd_frac sd(y).
    Returns the numbers compared."""
    n = len(y_full)
    assert np.array_equal(out["order"], np.arange(n))
    for j in range(q):
        for k in range(out["beta_mcmc"].shape[0]):
            a, b = out["beta_mcmc"][k, :, j], oc["beta"][:, k, j]
            se = np.hypot(_batch_se(a), _batch_se(b))
            assert abs(a.mean() - b.mean()) < 5 * se, (
                f"beta[{k},{j}]: {a.mean():.4f} vs {b.mean():.4f}, se={se:.4f}")
        a, b = out["tausq_mcmc"][j], oc["tausq"][:, j]
        se = np.hypot(_batch_se(a), _batch_se(b))
        assert abs(a.mean() - b.mean()) < 5 * se, (j, a.mean(), b.mean(), se)

    w_a, w_b = out["w_mcmc"].mean(axis=0), oc["w"].mean(axis=0)
    z = np.abs(w_a - w_b) / np.maximum(oc["w"].std(axis=0), 1e-3)
    assert z.mean() < 0.35, z.mean()
    corr = float(np.corrcoef(w_a, w_b)[0, 1])
    assert corr > 0.99, corr

    for j in theta_dims:
        a, b = out["theta_mcmc"][j], oc["theta"][:, j]
        se = np.hypot(_batch_se(a, lag=100), _batch_se(b, lag=100))
        diff = abs(a.mean() - b.mean())
        assert diff < max(5 * se, 0.25 * b.mean()), (
            f"theta[{j}]: {a.mean():.3f} vs {b.mean():.3f}, se={se:.3f}")

    def rmspe(yhat):
        return float(np.sqrt(np.mean((yhat.mean(axis=0)[miss]
                                      - y_full[miss]) ** 2)))

    rmspe_a, rmspe_b = rmspe(out["yhat_mcmc"]), rmspe(oc["yhat"])
    assert abs(rmspe_a - rmspe_b) / rmspe_b < 0.10, (rmspe_a, rmspe_b)
    sd_y = float(np.std(y_full[miss]))
    if sd_frac is not None:
        assert rmspe_a < sd_frac * sd_y and rmspe_b < sd_frac * sd_y
    return dict(rmspe=rmspe_a, rmspe_oracle=rmspe_b, sd_y=sd_y,
                w_mean_z=float(z.mean()), w_corr=corr,
                accept=float(out["accept_ratio"]))


def univariate_parity(device="cpu"):
    """test_posterior_parity_vs_dense_oracle on the port: n=250, theta
    sampled (RAM-MH from a set start, curvature-tuned proposal), prior box
    toplim=30, keep 1500 after 700 burn; the port's chain runs on
    ``device`` in float64, the oracle on the host.  Returns the numbers
    compared."""
    n = 250
    coords, X, y, y_full, miss = _gp_data(42, n, 25)
    seed, keep, burn = 3, 1500, 700
    th0 = np.array([1.0, 1.0, 1.0, 4.0])
    toplim, tausq_ab, beta_Vi = 30.0, (2.01, 1.0), 0.01
    tree = make_tree(coords, np.isfinite(y), np.zeros(n, dtype=np.int64),
                     axis_cell_size=int(round(25 ** 0.5)), K=2,
                     rng=np.random.default_rng(seed))
    bounds = np.zeros((4, 2))
    bounds[:, 0], bounds[:, 1] = 1e-3, toplim
    oracle = DenseOracle(tree, coords, y, X, bounds, th0, start_tausq=0.1,
                         beta_Vi=beta_Vi, tausq_ab=tausq_ab, mcmcsd=0.05,
                         seed=seed)
    oc = oracle.run(keep=keep, burn=burn)
    acc_oracle = oracle.accept_count / oracle.propos_count
    assert 0.05 < acc_oracle < 0.7

    out = spamtree_tpu_torch.spamtree(
        y, X, coords, cell_size=25, mcmc=dict(keep=keep, burn=burn, thin=1),
        prior=dict(toplim=toplim, tausq=tausq_ab, beta=beta_Vi),
        starting=dict(theta=th0, tausq=0.1), dtype=F64, seed=seed,
        device=device)
    assert 0.05 < out["accept_ratio"] < 0.7
    res = check_parity(out, oc, miss, y_full, q=1, sd_frac=0.7,
                       theta_dims=(0, 3))
    return res | dict(accept_oracle=acc_oracle, n=n, iters=keep + burn,
                      mcmc_time=out["mcmc_time"])


def test_posterior_parity_vs_dense_oracle():
    univariate_parity()


def test_posterior_parity_vs_dense_oracle_bivariate():
    """Misaligned bivariate AG10 data, 8-dim theta through RAM-MH with a
    fixed isotropic proposal (settings mcmcsd=0.02, curvature_sd=False)."""
    from test_covariance import np_ag10

    rng = np.random.default_rng(11)
    n0, n1 = 130, 110
    coords = np.vstack([rng.uniform(size=(n0, 2)), rng.uniform(size=(n1, 2))])
    mv = np.concatenate([np.zeros(n0, np.int64), np.ones(n1, np.int64)])
    n = n0 + n1
    order = np.lexsort((np.arange(n), coords[:, 1], coords[:, 0]))
    coords, mv = coords[order], mv[order]
    ai1, ai2 = np.array([1.2, 0.9]), np.array([0.4, 0.5])
    phi_i, c, d = np.array([4.0, 6.0]), 5.0, 1.0
    Dmat = np.array([[0.0, d], [d, 0.0]])
    CC = np_ag10(coords, mv, coords, mv, ai1, ai2, phi_i, np.array([c]), Dmat)
    w_true = np.linalg.cholesky(CC + 1e-9 * np.eye(n)) @ rng.normal(size=n)
    beta_true = np.array([[1.0, -0.4], [-0.5, 0.8]])
    X = rng.normal(size=(n, 2))
    tausq = np.array([0.09, 0.16])
    y_full = (np.sum(X * beta_true[:, mv].T, axis=1) + w_true
              + np.sqrt(tausq[mv]) * rng.normal(size=n))
    y = y_full.copy()
    miss = np.zeros(n, dtype=bool)
    miss[rng.choice(n, size=24, replace=False)] = True
    y[miss] = np.nan

    seed, keep, burn = 5, 1200, 600
    btmlim, toplim = 1e-3, 30.0
    bounds = np.zeros((8, 2))
    bounds[:, 0], bounds[:, 1] = btmlim, toplim
    bounds[1, 0] = -toplim
    bounds[7, 1] = toplim - btmlim
    th0 = np.clip(np.ones(8), bounds[:, 0] + 1e-6, bounds[:, 1] - 1e-6)
    tree = make_tree(coords, np.isfinite(y), mv,
                     axis_cell_size=int(round(25 ** 0.5)), K=2,
                     rng=np.random.default_rng(seed))
    oracle = DenseOracle(tree, coords, y, X, bounds, th0, start_tausq=0.1,
                         beta_Vi=0.01, tausq_ab=(2.01, 1.0), mcmcsd=0.02,
                         seed=seed, mv_id=mv, q=2)
    oc = oracle.run(keep=keep, burn=burn)
    assert 0.05 < oracle.accept_count / oracle.propos_count < 0.7

    out = spamtree_tpu_torch.spamtree(
        y, X, coords, mv_id=mv, cell_size=25,
        mcmc=dict(keep=keep, burn=burn, thin=1),
        prior=dict(btmlim=btmlim, toplim=toplim, tausq=(2.01, 1.0),
                   beta=0.01),
        starting=dict(theta=th0, tausq=0.1),
        settings=dict(mcmcsd=0.02, curvature_sd=False),
        dtype=F64, seed=seed, device="cpu")
    np.testing.assert_allclose(out["theta_bounds"], bounds)
    assert 0.05 < out["accept_ratio"] < 0.7
    check_parity(out, oc, miss, y_full, q=2, sd_frac=0.8)


def test_posterior_parity_q3_fixed_theta():
    """q = 3 (the psi-scaled Gneiting base) with theta fixed at the truth
    (debug sample_theta=False, the box given by prior set_unif_bounds)."""
    from test_covariance import np_ag10

    rng = np.random.default_rng(7)
    counts = (110, 80, 60)
    coords = np.vstack([rng.uniform(size=(c, 2)) for c in counts])
    mv = np.concatenate([np.full(c, j, np.int64) for j, c in enumerate(counts)])
    n = len(mv)
    order = np.lexsort((np.arange(n), coords[:, 1], coords[:, 0]))
    coords, mv = coords[order], mv[order]
    q = 3
    ai1, ai2 = np.array([1.1, 0.9, 1.3]), np.array([0.4, 0.3, 0.5])
    phi_i = np.array([4.0, 6.0, 5.0])
    thetamv = np.array([0.8, 0.6, 5.0])
    dvec = np.array([0.8, 1.2, 0.6])
    th_true = np.concatenate([ai1, ai2, phi_i, thetamv, dvec])
    Dmat = np.zeros((q, q))
    Dmat[1, 0] = Dmat[0, 1] = dvec[0]
    Dmat[2, 0] = Dmat[0, 2] = dvec[1]
    Dmat[2, 1] = Dmat[1, 2] = dvec[2]
    CC = np_ag10(coords, mv, coords, mv, ai1, ai2, phi_i, thetamv, Dmat)
    w_true = np.linalg.cholesky(CC + 1e-9 * np.eye(n)) @ rng.normal(size=n)
    beta_true = np.array([[1.0, -0.4, 0.6], [-0.5, 0.8, -0.2]])
    X = rng.normal(size=(n, 2))
    tausq = np.array([0.09, 0.16, 0.04])
    y_full = (np.sum(X * beta_true[:, mv].T, axis=1) + w_true
              + np.sqrt(tausq[mv]) * rng.normal(size=n))
    y = y_full.copy()
    miss = np.zeros(n, dtype=bool)
    miss[rng.choice(n, size=25, replace=False)] = True
    y[miss] = np.nan

    seed, keep, burn = 9, 1000, 400
    bounds = np.zeros((15, 2))
    bounds[:, 0], bounds[:, 1] = 1e-3, 30.0
    bounds[1:q, 0] = -30.0
    bounds[10, :] = (1e-3, 1.0 - 1e-3)
    tree = make_tree(coords, np.isfinite(y), mv,
                     axis_cell_size=int(round(25 ** 0.5)), K=2,
                     rng=np.random.default_rng(seed))
    oracle = DenseOracle(tree, coords, y, X, bounds, th_true, start_tausq=0.1,
                         beta_Vi=0.01, tausq_ab=(2.01, 1.0), mcmcsd=0.02,
                         seed=seed, mv_id=mv, q=q)
    oc = oracle.run(keep=keep, burn=burn, sample_theta=False)

    out = spamtree_tpu_torch.spamtree(
        y, X, coords, mv_id=mv, cell_size=25,
        mcmc=dict(keep=keep, burn=burn, thin=1),
        prior=dict(set_unif_bounds=bounds, tausq=(2.01, 1.0), beta=0.01),
        starting=dict(theta=th_true, tausq=0.1),
        debug=dict(sample_theta=False), dtype=F64, seed=seed, device="cpu")
    # theta fixed: every draw is the start, and the proposal is the
    # isotropic fallback (no curvature is taken without a theta step)
    assert np.array_equal(out["theta_mcmc"],
                          np.repeat(th_true[:, None], keep, axis=1))
    nt = len(th_true)
    np.testing.assert_allclose(
        out["paramsd"], np.sqrt(min(0.01, 1 / (nt * np.sqrt((~miss).sum()))))
        * np.eye(nt))
    check_parity(out, oc, miss, y_full, q=q)


def test_posterior_parity_limited_tree():
    """limited_tree=True: the oracle reads tree.parents (one parent each)."""
    n = 240
    coords, X, y, y_full, miss = _gp_data(21, n, 24)
    seed, keep, burn = 13, 1200, 600
    th0 = np.array([1.0, 1.0, 1.0, 4.0])
    bounds = np.zeros((4, 2))
    bounds[:, 0], bounds[:, 1] = 1e-3, 30.0
    tree = make_tree(coords, np.isfinite(y), np.zeros(n, dtype=np.int64),
                     axis_cell_size=int(round(25 ** 0.5)), K=2,
                     rng=np.random.default_rng(seed), limited_tree=True)
    assert all(len(p) <= 1 for p in tree.parents)
    oracle = DenseOracle(tree, coords, y, X, bounds, th0, start_tausq=0.1,
                         beta_Vi=0.01, tausq_ab=(2.01, 1.0), mcmcsd=0.05,
                         seed=seed)
    oc = oracle.run(keep=keep, burn=burn)
    assert 0.05 < oracle.accept_count / oracle.propos_count < 0.7

    out = spamtree_tpu_torch.spamtree(
        y, X, coords, cell_size=25, limited_tree=True,
        mcmc=dict(keep=keep, burn=burn, thin=1),
        prior=dict(toplim=30.0, tausq=(2.01, 1.0), beta=0.01),
        starting=dict(theta=th0, tausq=0.1), dtype=F64, seed=seed,
        device="cpu")
    assert 0.05 < out["accept_ratio"] < 0.7
    check_parity(out, oc, miss, y_full, q=1)
