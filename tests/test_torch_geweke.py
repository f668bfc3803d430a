"""Geweke (2004) joint-distribution tests of the port's transition kernel,
on the port alone (float64, CPU), with the thresholds of
tests/test_geweke.py.

With theta fixed (first test) or drawn from a proper prior (the other two),
moments of p(theta, w, beta, tausq, y) are compared under two samplers:
iid forward draws (marginal-conditional) and the port's Gibbs / Metropolis
cycle alternated with re-simulation of y (successive-conditional).  If the
kernel targets the right posterior both sample the same joint, so the
moment z-scores must be small."""

import numpy as np
import pytest
import torch

from spamtree_tpu_torch.model.core import (
    ModelStatic,
    gibbs_beta,
    gibbs_tausq,
    gibbs_w,
    prior_sample_w,
    sweep,
    tausq_shape,
)
from spamtree_tpu_torch.model.mcmc import (
    MCMCConfig,
    draw_step,
    init_state,
    make_step,
)
from spamtree_tpu_torch.model.params import make_theta_spec
from spamtree_tpu_torch.model.ram import ram_init
from spamtree_tpu_torch.tree.partition import make_tree
from spamtree_tpu_torch.tree.schedule import build_schedule

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    # several test workers share the cores; tiny eager ops gain nothing
    # from intra-op threads
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zscore(a, b, lag):
    """(mean a - mean b) / SE, the successive chain's SE by batch means."""
    nb = len(b) // lag
    bm = b[: nb * lag].reshape(nb, lag).mean(axis=1)
    se = np.sqrt(a.var() / len(a) + bm.var() / nb)
    return (a.mean() - b.mean()) / se


def _model(rng, n, p, q, mv=None):
    coords = rng.uniform(size=(n, 2))
    if mv is None:
        mv = np.zeros(n, dtype=np.int64)
    order = np.lexsort((np.arange(n), coords[:, 1], coords[:, 0]))
    coords, mv = coords[order], mv[order]
    X = rng.normal(size=(n, p))
    tree = make_tree(coords, np.ones(n, bool), mv, axis_cell_size=4, K=2,
                     rng=rng)
    ms = ModelStatic(build_schedule(tree), coords, mv, np.zeros(n), X,
                     make_theta_spec(2, q).spec, dtype=F64, device="cpu")
    return ms, torch.as_tensor(X), mv


def test_geweke_gibbs_cycle():
    """theta fixed: the w / tausq / beta Gibbs cycle (gibbs_w, gibbs_tausq,
    gibbs_beta with y=) against forward draws through prior_sample_w.

    Batches of 200 cycles: beta's integrated autocorrelation time in this
    cycle is ~150 cycles (measured over 20000 cycles of the port's chain;
    the JAX package's chain mixes alike), so the JAX test's batches of 20
    understate the successive chain's SE about 2.7-fold, and whether its
    z stays under 4.5 depends on the key (it fails for some keys)."""
    rng = np.random.default_rng(0)
    n, p = 64, 2
    ms, X, _ = _model(rng, n, p, 1)
    theta = torch.tensor([2.0, 1.0, 1.0, 5.0], dtype=F64)
    a_t, b_t = 2.01, 1.0
    Vi, Vim = torch.eye(p, dtype=F64), torch.zeros(p, dtype=F64)
    leveldata, _pd, _logdet, ok = sweep(ms, theta, torch.zeros(n + 1, dtype=F64))
    assert bool(ok)
    shape = tausq_shape(ms, (a_t, b_t))
    gen = torch.Generator().manual_seed(1)
    kw = dict(generator=gen, dtype=F64)

    def forward():
        beta = torch.randn(p, **kw)  # Vi = I
        tinv = torch._standard_gamma(torch.tensor(a_t, dtype=F64),
                                     generator=gen) / b_t
        w = prior_sample_w(ms, leveldata, torch.randn(n + 1, **kw))[:n]
        y = X @ beta + w + torch.randn(n, **kw) / torch.sqrt(tinv)
        return beta, tinv, w, y

    def cycle(beta, tinv, w_full, y):
        yl = torch.cat([y, y.new_zeros(1)])
        XB = torch.cat([X @ beta, y.new_zeros(1)])
        w_full = gibbs_w(ms, leveldata, w_full, tinv[None], XB,
                         torch.randn(n + 1, **kw), y=yl)
        tinv = gibbs_tausq(ms, w_full, XB,
                           torch._standard_gamma(shape, generator=gen),
                           (a_t, b_t), y=yl)[0]
        beta2, _ = gibbs_beta(ms, w_full, tinv[None],
                              torch.randn(p, 1, **kw), Vi, Vim, y=yl)
        beta = beta2[:, 0]
        y = X @ beta + w_full[:n] + torch.randn(n, **kw) / torch.sqrt(tinv)
        return beta, tinv, w_full, y

    N, burn = 4000, 500
    fw = np.array([(b[0].item(), b[1].item(), ti.item(),
                    torch.mean(w * w).item())
                   for b, ti, w, _ in (forward() for _ in range(N))])
    b0, t0, w0, y0 = forward()
    carry = (b0, t0, torch.cat([w0, w0.new_zeros(1)]), y0)
    sc = np.zeros((N, 4))
    for i in range(N + burn):
        carry = cycle(*carry)
        if i >= burn:
            b, ti, w, _ = carry
            sc[i - burn] = (b[0].item(), b[1].item(), ti.item(),
                            torch.mean(w[:n] ** 2).item())
    zs = [_zscore(fw[:, j], sc[:, j], lag=200) for j in range(4)]
    assert np.max(np.abs(zs)) < 4.5, zs


def test_geweke_full_cycle_with_theta_mh():
    """The whole make_step transition -- w-Gibbs, theta Metropolis (logit
    transforms, jacobian, Cholesky auto-reject, accept swap of the factors),
    the conjugate tail -- with adaptation off and a proper box-truncated
    gamma prior on theta, so theta's marginal under the joint is known."""
    rng = np.random.default_rng(7)
    n, p = 48, 2
    ms, X, _ = _model(rng, n, p, 1)
    nt = 4
    bounds = np.array([[0.25, 6.0]] * nt)
    g_shape, g_rate = 8.0, 4.0
    a_t, b_t = 2.5, 1.0
    gen = torch.Generator().manual_seed(10)
    kw = dict(generator=gen, dtype=F64)

    def draw_theta():
        while True:
            th = rng.gamma(g_shape, 1.0 / g_rate, size=nt)
            if np.all((th > bounds[:, 0]) & (th < bounds[:, 1])):
                return th

    def fwd_given_theta(theta):
        ld, _pd, _logdet, ok = sweep(ms, torch.as_tensor(theta),
                                     torch.zeros(n + 1, dtype=F64),
                                     build_pred=False)
        w = prior_sample_w(ms, ld, torch.randn(n + 1, **kw))[:n]
        beta = torch.randn(p, **kw)  # Vi = I
        tinv = torch._standard_gamma(torch.tensor(a_t, dtype=F64),
                                     generator=gen) / b_t
        y = X @ beta + w + torch.randn(n, **kw) / torch.sqrt(tinv)
        return w, beta, tinv, y, ok

    cfg = MCMCConfig(adapting=False, mcmcsd=0.09, tausq_ab=(a_t, b_t),
                     beta_Vi=1.0, sample_predicts=False,
                     theta_prior=[("gamma", g_shape, g_rate)] * nt)

    N, burn = 3000, 500
    fw = np.zeros((N, nt + 3))
    for i in range(N):
        th = draw_theta()
        w, b, ti, _y, ok = fwd_given_theta(th)
        assert bool(ok)
        fw[i] = (*th, b[0].item(), ti.item(), torch.mean(w * w).item())

    th0 = draw_theta()
    w0, b0, t0, y0, ok0 = fwd_given_theta(th0)
    assert bool(ok0)
    ms.y = torch.cat([y0, y0.new_zeros(1)])
    state = init_state(ms, bounds, th0, start_beta=b0.numpy(),
                       start_tausq=1.0 / t0.item(), start_w=w0.numpy(),
                       cfg=cfg)
    step = make_step(ms, bounds, cfg)
    shape = tausq_shape(ms, cfg.tausq_ab)
    sc = np.zeros((N, nt + 3))
    for i in range(N + burn):
        state = step(state, draw_step(ms, gen, nt, shape), False)
        tau_sd = torch.sqrt(1.0 / state.tausq_inv)[ms.mv[:n]]
        y = state.XB[:n] + state.w[:n] + tau_sd * torch.randn(n, **kw)
        ms.y = torch.cat([y, y.new_zeros(1)])
        if i >= burn:
            sc[i - burn] = (*state.theta.tolist(), state.beta[0, 0].item(),
                            state.tausq_inv[0].item(),
                            torch.mean(state.w[:n] ** 2).item())

    acc = state.ram.accept_count / state.ram.propos_count
    assert 0.05 < acc < 0.95, acc
    zs = {f"theta{d}": _zscore(fw[:, d], sc[:, d], 50) for d in range(nt)}
    zs["theta0_sq"] = _zscore(fw[:, 0] ** 2, sc[:, 0] ** 2, 50)
    zs["beta0"] = _zscore(fw[:, 4], sc[:, 4], 50)
    zs["tinv"] = _zscore(fw[:, 5], sc[:, 5], 50)
    zs["w2"] = _zscore(fw[:, 6], sc[:, 6], 50)
    # couples theta's marginal to the field: a stale-factor swap that
    # leaves both marginals intact shows here
    zs["th0_x_w2"] = _zscore(fw[:, 0] * fw[:, 6], sc[:, 0] * sc[:, 6], 50)
    worst = max(abs(v) for v in zs.values())
    assert worst < 4.5, zs


def test_geweke_full_cycle_multivariate_q2():
    """The q = 2 AG10 path: 8-dim theta (ai1[2], ai2[2], phi[2], thetamv,
    latent D) through the Metropolis accept swap with misaligned margins.
    gamma(8, rate 4) priors, flat over [-2, 3] on ai1_2; the forward
    sampler also rejects theta on the sweep's Cholesky flag, as the kernel's
    auto-reject does.  The proposal covariance is learned in a discarded
    adaptive phase and then frozen, so the recorded chain is Markov; it
    runs the accept-aware step (the JAX test runs its default step there)."""
    rng = np.random.default_rng(21)
    n, p, q = 64, 2, 2
    ms, X, mv = _model(rng, n, p, q, mv=rng.integers(0, q, size=n))
    nt = 8
    bounds = np.array([[0.25, 6.0]] * nt)
    bounds[1] = (-2.0, 3.0)  # ai1_2: the sign of the cross-covariance
    g_shape, g_rate = 8.0, 4.0
    a_t, b_t = 2.5, 1.0
    m0 = torch.as_tensor(mv == 0)
    gen = torch.Generator().manual_seed(30)
    kw = dict(generator=gen, dtype=F64)
    zero_w = torch.zeros(n + 1, dtype=F64)

    def theta_ok(th):
        return bool(sweep(ms, torch.as_tensor(th), zero_w, build_pred=False)[3])

    def draw_theta():
        while True:
            th = rng.gamma(g_shape, 1.0 / g_rate, size=nt)
            th[1] = rng.uniform(-2.0, 3.0)
            if (np.all((th > bounds[:, 0]) & (th < bounds[:, 1]))
                    and theta_ok(th)):
                return th

    def fwd_given_theta(theta):
        ld, _pd, _logdet, ok = sweep(ms, torch.as_tensor(theta), zero_w,
                                     build_pred=False)
        w = prior_sample_w(ms, ld, torch.randn(n + 1, **kw))[:n]
        beta = torch.randn(p, q, **kw)  # Vi = I per margin
        tinv = torch._standard_gamma(torch.full((q,), a_t, dtype=F64),
                                     generator=gen) / b_t
        sd = torch.sqrt(1.0 / tinv)[ms.mv[:n]]
        y = (torch.sum((X @ beta) * ms.mv_onehot, dim=1) + w
             + sd * torch.randn(n, **kw))
        return w, beta, tinv, y, ok

    def w2(w):
        return (torch.mean(w[m0] ** 2).item(), torch.mean(w[~m0] ** 2).item())

    prior_spec = [("gamma", g_shape, g_rate)] * nt
    prior_spec[1] = None  # flat over the box
    cfg = MCMCConfig(adapting=False, mcmcsd=0.065, tausq_ab=(a_t, b_t),
                     beta_Vi=1.0, sample_predicts=False,
                     theta_prior=prior_spec, accept_aware=True)
    shape = tausq_shape(ms, cfg.tausq_ab)

    def run(state, cfg_run, T, record):
        step = make_step(ms, bounds, cfg_run)
        stats = []
        for _ in range(T):
            state = step(state, draw_step(ms, gen, nt, shape), False)
            tau_sd = torch.sqrt(1.0 / state.tausq_inv)[ms.mv[:n]]
            y = state.XB[:n] + state.w[:n] + tau_sd * torch.randn(n, **kw)
            ms.y = torch.cat([y, y.new_zeros(1)])
            if record:
                stats.append((*state.theta.tolist(), *state.beta[0].tolist(),
                              *state.tausq_inv.tolist(), *w2(state.w[:n])))
        return state, np.array(stats)

    N = 3000
    fw = np.zeros((N, nt + 6))
    for i in range(N):
        th = draw_theta()
        w, b, ti, _y, ok = fwd_given_theta(th)
        assert bool(ok)
        fw[i] = (*th, *b[0].tolist(), *ti.tolist(), *w2(w))

    th0 = draw_theta()
    w0, b0, t0, y0, ok0 = fwd_given_theta(th0)
    assert bool(ok0)
    ms.y = torch.cat([y0, y0.new_zeros(1)])
    state = init_state(ms, bounds, th0, start_beta=b0[:, 0].numpy(),
                       start_tausq=1.0 / t0[0].item(), start_w=w0.numpy(),
                       cfg=cfg)
    # adaptive pre-phase (discarded), then the proposal frozen
    state, _ = run(state, cfg._replace(adapting=True), 2500, False)
    S = state.ram.paramsd
    state = state._replace(ram=ram_init(S @ S.T))
    state, _ = run(state, cfg, 1000, False)
    state, sc = run(state, cfg, 12000, True)

    acc = state.ram.accept_count / state.ram.propos_count
    assert 0.1 < acc < 0.6, acc
    lag = 300
    zs = {f"theta{d}": _zscore(fw[:, d], sc[:, d], lag) for d in range(nt)}
    zs["theta1_sq"] = _zscore(fw[:, 1] ** 2, sc[:, 1] ** 2, lag)
    zs["theta7_sq"] = _zscore(fw[:, 7] ** 2, sc[:, 7] ** 2, lag)
    for j in (0, 1):
        zs[f"beta_m{j}"] = _zscore(fw[:, nt + j], sc[:, nt + j], lag)
        zs[f"tinv_m{j}"] = _zscore(fw[:, nt + 2 + j], sc[:, nt + 2 + j], lag)
        zs[f"w2_m{j}"] = _zscore(fw[:, nt + 4 + j], sc[:, nt + 4 + j], lag)
    # couples the latent-D marginal to the field
    zs["th7_x_w2"] = _zscore(fw[:, 7] * fw[:, nt + 4], sc[:, 7] * sc[:, nt + 4],
                             lag)
    worst = max(abs(v) for v in zs.values())
    assert worst < 4.5, zs
