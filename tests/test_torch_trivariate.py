"""Trivariate AG10 (q = 3, three outcomes at each site) in the port, held
against the benchmark's plain float64 reference (``benchmark/reference/
density.py``) on the CPU, at a size whose reference blocks hold 67-72 rows
(250 sites x 3 outcomes, cell_size 25): past K1's former limit of 64.

* ``pairwise_cov`` against the reference's ``ag10`` (the q > 2 branch).
* The sweep's log-determinant and quadratic form, and the prediction
  blocks' conditionals, against ``density.loglik_parts`` and
  ``density.predictive`` at a seeded theta and w.
* A short ``spamtree`` chain: a 15-parameter theta, finite outputs, and
  the factorised-block counters of its record (every block on the plain
  route on the CPU, as many as the levels factorise).
* On a card: the graphed chain's K1 blocks scale with its replays as the
  eager chain's do, and no reference block takes the plain route.
"""

import numpy as np
import pytest
import torch

from benchmark import data
from benchmark.reference import density
from spamtree_tpu_torch import api
from spamtree_tpu_torch.model import core
from spamtree_tpu_torch.model import mcmc as mt
from spamtree_tpu_torch.ops import chol
from spamtree_tpu_torch.ops import covariance as ct
from spamtree_tpu_torch.utils import trace

F64 = torch.float64
Q = 3
SITES = 250


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=11, sites=SITES):
    conf = {"data": {"maker": "multivariate", "n_per_q": sites, "q": Q,
                     "imbalance": None, "miss": 0.1, "layout_seed": 7}}
    return data.make(conf, seed, "cpu")


def _fit(inp, dtype=F64, device="cpu", **mcmc):
    y = inp["y"] - np.nanmean(inp["y"])
    return api.prepare_fit(y, inp["X"], inp["coords"], mv_id=inp["mv"],
                           cell_size=25, K=2, seed=1, dtype=dtype,
                           device=device,
                           mcmc=dict(dict(keep=3, burn=4, thin=2), **mcmc))


@pytest.fixture(scope="module")
def fitted():
    """The f64 model, a seeded theta near the start and a seeded w, the
    sorted rows' coordinates and 0-based margins, and the reference's
    blocks over the program's own tree."""
    inp = _inputs()
    fit = _fit(inp)
    rng = np.random.default_rng(5)
    theta = fit.state.theta * torch.as_tensor(
        rng.uniform(0.8, 1.2, size=fit.state.theta.shape))
    w = torch.as_tensor(rng.normal(size=fit.ms.n + 1))
    w[-1] = 0.0
    mv = np.searchsorted(np.unique(inp["mv"]), inp["mv"])[fit.order]
    return dict(fit=fit, theta=theta, w=w,
                n_miss=int(np.isnan(inp["y"]).sum()),
                coords=torch.as_tensor(inp["coords"][fit.order]),
                mv=torch.as_tensor(mv), blocks=density.Blocks(fit.tree))


def test_reference_blocks_pass_64_rows(fitted):
    """The size these tests run at: every reference level holds more than
    64 rows and at most K1's float32 limit, and theta has the q > 2
    branch's 15 parameters (3q + 3 base + 3 distances)."""
    ms = fitted["fit"].ms
    ref_s = [lvl.rows.shape[1] for t, lvl in enumerate(ms.levels)
             if ms.level_is_ref[t]]
    assert min(ref_s) > 64 and max(ref_s) <= chol.MAX_S
    assert fitted["theta"].shape == (15,)


def test_pairwise_cov_matches_reference_ag10():
    """rtol 1e-12 of the largest entry: the same elementwise formulas; sets
    of at most 25 rows, where ``torch.cdist`` in the reference computes
    distances directly (past 25 it takes a matrix-product route that loses
    ~1e-8 of a distance)."""
    rng = np.random.default_rng(3)
    spec = ct.make_cov_model(2, Q, 0)
    for _ in range(5):
        th = rng.uniform(0.3, 2.0, size=spec.npars + spec.k)
        th[3 * Q + 1] = rng.uniform(0.1, 0.9)  # the base's b in (0, 1)
        c1 = torch.as_tensor(rng.uniform(size=(4, 20, 2)))
        c2 = torch.as_tensor(rng.uniform(size=(4, 24, 2)))
        c2[:, :5] = c1[:, :5]  # zero distances: the same-margin nugget
        m1 = torch.as_tensor(rng.integers(0, Q, size=(4, 20)))
        m2 = torch.as_tensor(rng.integers(0, Q, size=(4, 24)))
        got = ct.pairwise_cov(c1, m1, c2, m2,
                              ct.unpack_theta(torch.as_tensor(th), spec),
                              spec)
        want = density.ag10(torch.as_tensor(th), Q, c1, m1, c2, m2)
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())


def test_sweep_matches_reference_loglik(fitted):
    """The sweep's log-determinant term and the quadratic form of w under
    its factors against the reference's, rtol 1e-6: the reference's
    ``torch.cdist`` over the 139-row ancestor sets takes its
    matrix-product route (~1e-10 on a covariance entry), which the
    factorisations' conditioning lifts to ~1e-7 (the port reads 9e-8 and
    5e-8 here); a wrong branch of the q > 2 base reads O(1)."""
    ms = fitted["fit"].ms
    ld_ref, q_ref = density.loglik_parts(
        fitted["blocks"], fitted["theta"], Q, fitted["coords"],
        fitted["mv"], fitted["w"][:-1])
    leveldata, _, logdet, ok = core.sweep(ms, fitted["theta"], fitted["w"])
    quad = core.quad_loglik(ms, leveldata, fitted["w"])
    assert bool(ok)
    assert abs(float(logdet) - ld_ref) <= 1e-6 * abs(ld_ref)
    assert abs(float(quad) - q_ref) <= 1e-6 * abs(q_ref)


def test_prediction_conditionals_match_reference(fitted):
    """Mean (z = 0) and sd (z = 1 less the mean) of the port's draw at
    every held-out row, from the carried operators and from
    ``predict_recompute``, against the reference's conditional given the
    same w at the ancestors: atol 1e-5 of the prior sd (the port reads
    7e-7 on the mean, 1e-7 on the sd; the reference's distances as
    above)."""
    ms, th, w = fitted["fit"].ms, fitted["theta"], fitted["w"]
    rows, mean, var, prior = density.predictive(
        fitted["blocks"], th, Q, fitted["coords"], fitted["mv"], w[:-1])
    assert rows.numel() == fitted["n_miss"] > 0
    _, pred_data, _, _ = core.sweep(ms, th, w)
    zero = torch.zeros_like(w)
    one = torch.ones_like(w)
    m_carry = core.predict(ms, pred_data, w, zero)[rows]
    m_again = core.predict_recompute(ms, th, w, zero)[rows]
    sd = core.predict(ms, pred_data, w, one)[rows] - m_carry
    tol = 1e-5 * prior.sqrt()
    assert bool(((m_carry - mean).abs() <= tol).all())
    assert bool(((m_again - mean).abs() <= tol).all())
    assert bool(((sd - var.sqrt()).abs() <= tol).all())


def test_chain_runs_and_counts_plain_blocks():
    """A short ``spamtree`` chain at q = 3 on the CPU: 15 parameters a
    draw, finite outputs; its run_mcmc record counts every factorised
    block on the plain route (no kernel on the CPU), as many as the levels
    factorise: each iteration factors every reference block twice (the
    proposal's sweep and w's Gibbs update), whatever it accepts."""
    inp = _inputs(seed=12, sites=160)
    y = inp["y"] - np.nanmean(inp["y"])
    res = api.spamtree(y, inp["X"], inp["coords"], mv_id=inp["mv"],
                       cell_size=25, K=2, seed=2, device="cpu",
                       mcmc=dict(keep=6, burn=6, thin=1),
                       settings=dict(chunk=3))
    assert res["theta_mcmc"].shape == (15, 6)
    for k in ("theta_mcmc", "beta_mcmc", "tausq_mcmc", "w_mcmc",
              "yhat_mcmc"):
        assert np.isfinite(res[k]).all(), k
    rec = [r for r in trace.history() if r.name == "run_mcmc"][-1]
    sched = res["schedule"]
    per_it = 2 * sum(lvl.B for lvl in sched.levels if lvl.is_ref)
    assert max(lvl.S for lvl in sched.levels if lvl.is_ref) > 64
    assert rec.counter("ops.chol.k1_blocks") == 0
    assert rec.counter("ops.chol.plain_blocks") == (
        rec.counter("mcmc.iterations") * per_it)


@pytest.mark.cuda
def test_graphed_k1_blocks_scale_with_replays():
    """On a card, at q = 3 in float32: the graphed chain's K1 blocks, its
    parts' captured counts times their replays, equal the eager chain's
    over the same iterations, and no block takes the plain route: every
    reference block has at most 96 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    fit = _fit(_inputs(), dtype=torch.float32, device="cuda", keep=6,
               burn=6, thin=2)
    ms = fit.ms
    ref_b = sum(lvl.rows.shape[0] for t, lvl in enumerate(ms.levels)
                if ms.level_is_ref[t])
    counts = {}
    for graphs in (False, True):
        res = mt.run_mcmc(ms, fit.bounds, fit.cfg, fit.state, fit.gen,
                          graphs=graphs)
        rec = trace.history()[-1]
        assert rec.name == "run_mcmc"
        assert (res["graph_replays"] > 0) == graphs
        counts[graphs] = (rec.counter("ops.chol.k1_blocks"),
                          rec.counter("ops.chol.plain_blocks"),
                          rec.counter("mcmc.iterations"))
    for k1, plain, iters in counts.values():
        assert plain == 0
        assert k1 == iters * 2 * ref_b
    assert counts[True] == counts[False]
