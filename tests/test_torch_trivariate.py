"""Co-located AG10 with q > 2 (q = 3 and q = 5 outcomes at each site) in
the port, held against the benchmark's plain float64 reference
(``benchmark/reference/density.py``) on the CPU, at 250 sites x q outcomes
(cell_size 25): q = 3's reference blocks hold 67-72 rows, past K1's
64-row forms; q = 5's hold 117, 108 and 51, two of them past 96, where
K1 takes its 128-thread form on a card.

* ``pairwise_cov`` against the reference's ``ag10`` (the q > 2 branch).
* The sweep's log-determinant and quadratic form, and the prediction
  blocks' conditionals, against ``density.loglik_parts`` and
  ``density.predictive`` at a seeded theta and w.
* A short ``spamtree`` chain: a theta of 3q + 3 + q(q - 1) / 2 parameters
  (15 at q = 3, 28 at q = 5), finite outputs, and the factorised-block
  counters of its record (every block on the plain route on the CPU, as
  many as the levels factorise, none on K1's 128-thread form).
* On a card: the graphed chain's K1 blocks scale with its replays as the
  eager chain's do, no reference block takes the plain route, and the
  128-thread form counts every reference block at q = 5 (3000 sites, each
  reference level past 96 rows) and none at q = 2 or q = 3.
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
QS = (3, 5)
SITES = 250


def _npars(q):
    """theta's length at q > 2: 3q margin parameters (sill, range,
    nugget), 3 of the base, q(q - 1) / 2 latent margin distances."""
    return 3 * q + 3 + q * (q - 1) // 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(q, seed=11, sites=SITES):
    conf = {"data": {"maker": "multivariate", "n_per_q": sites, "q": q,
                     "imbalance": None, "miss": 0.1, "layout_seed": 7}}
    return data.make(conf, seed, "cpu")


def _fit(inp, dtype=F64, device="cpu", **mcmc):
    y = inp["y"] - np.nanmean(inp["y"])
    return api.prepare_fit(y, inp["X"], inp["coords"], mv_id=inp["mv"],
                           cell_size=25, K=2, seed=1, dtype=dtype,
                           device=device,
                           mcmc=dict(dict(keep=3, burn=4, thin=2), **mcmc))


@pytest.fixture(scope="module", params=QS, ids=lambda q: f"q{q}")
def fitted(request):
    """At q = ``request.param``: the f64 model, a seeded theta near the
    start and a seeded w, the sorted rows' coordinates and 0-based margins,
    and the reference's blocks over the program's own tree."""
    q = request.param
    inp = _inputs(q)
    fit = _fit(inp)
    rng = np.random.default_rng(5)
    theta = fit.state.theta * torch.as_tensor(
        rng.uniform(0.8, 1.2, size=fit.state.theta.shape))
    w = torch.as_tensor(rng.normal(size=fit.ms.n + 1))
    w[-1] = 0.0
    mv = np.searchsorted(np.unique(inp["mv"]), inp["mv"])[fit.order]
    return dict(q=q, fit=fit, theta=theta, w=w,
                n_miss=int(np.isnan(inp["y"]).sum()),
                coords=torch.as_tensor(inp["coords"][fit.order]),
                mv=torch.as_tensor(mv), blocks=density.Blocks(fit.tree))


def test_reference_blocks_pass_64_rows(fitted):
    """The size these tests run at: at q = 3 every reference level holds
    more than 64 rows and at most 96 (K1's 96-thread form); at q = 5 two
    hold more than 96 and at most K1's float32 limit of 128.  theta has
    the q > 2 branch's 3q + 3 + q(q - 1) / 2 parameters."""
    q, ms = fitted["q"], fitted["fit"].ms
    ref_s = [lvl.rows.shape[1] for t, lvl in enumerate(ms.levels)
             if ms.level_is_ref[t]]
    if q == 3:
        assert min(ref_s) > 64 and max(ref_s) <= chol.WIDE_S
    else:
        assert sum(s > chol.WIDE_S for s in ref_s) == 2
        assert max(ref_s) <= chol.MAX_S
    assert fitted["theta"].shape == (_npars(q),)


@pytest.mark.parametrize("q", QS)
def test_pairwise_cov_matches_reference_ag10(q):
    """rtol 1e-12 of the largest entry: the same elementwise formulas; sets
    of at most 25 rows, where ``torch.cdist`` in the reference computes
    distances directly (past 25 it takes a matrix-product route that loses
    ~1e-8 of a distance)."""
    rng = np.random.default_rng(3)
    spec = ct.make_cov_model(2, q, 0)
    for _ in range(5):
        th = rng.uniform(0.3, 2.0, size=spec.npars + spec.k)
        th[3 * q + 1] = rng.uniform(0.1, 0.9)  # the base's b in (0, 1)
        c1 = torch.as_tensor(rng.uniform(size=(4, 20, 2)))
        c2 = torch.as_tensor(rng.uniform(size=(4, 24, 2)))
        c2[:, :5] = c1[:, :5]  # zero distances: the same-margin nugget
        m1 = torch.as_tensor(rng.integers(0, q, size=(4, 20)))
        m2 = torch.as_tensor(rng.integers(0, q, size=(4, 24)))
        got = ct.pairwise_cov(c1, m1, c2, m2,
                              ct.unpack_theta(torch.as_tensor(th), spec),
                              spec)
        want = density.ag10(torch.as_tensor(th), q, c1, m1, c2, m2)
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())


def test_sweep_matches_reference_loglik(fitted):
    """The sweep's log-determinant term and the quadratic form of w under
    its factors against the reference's, rtol 1e-6: the reference's
    ``torch.cdist`` over the ancestor sets (139 rows at q = 3, 276 at
    q = 5) takes its matrix-product route (~1e-10 on a covariance entry),
    which the factorisations' conditioning lifts to ~1e-7 (the port reads
    3e-8 and 7e-8 at q = 3, 5e-8 and 1.4e-7 at q = 5); a wrong branch of
    the q > 2 base reads O(1)."""
    ms = fitted["fit"].ms
    ld_ref, q_ref = density.loglik_parts(
        fitted["blocks"], fitted["theta"], fitted["q"], fitted["coords"],
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
    4.1e-7 on the mean, 7e-8 on the sd at q = 3, 4.5e-7 and 1.0e-7 at
    q = 5; the reference's distances as above)."""
    ms, th, w = fitted["fit"].ms, fitted["theta"], fitted["w"]
    rows, mean, var, prior = density.predictive(
        fitted["blocks"], th, fitted["q"], fitted["coords"], fitted["mv"],
        w[:-1])
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


@pytest.mark.parametrize("q", QS)
def test_chain_runs_and_counts_plain_blocks(q):
    """A short ``spamtree`` chain on the CPU: 3q + 3 + q(q - 1) / 2
    parameters a draw, finite outputs; its run_mcmc record counts every
    factorised block on the plain route (no kernel on the CPU, so none on
    K1's 128-thread form either, though q = 5 has blocks past 96 rows), as
    many as the levels factorise: each iteration factors every reference
    block twice (the proposal's sweep and w's Gibbs update), whatever it
    accepts."""
    inp = _inputs(q, seed=12, sites=160)
    y = inp["y"] - np.nanmean(inp["y"])
    res = api.spamtree(y, inp["X"], inp["coords"], mv_id=inp["mv"],
                       cell_size=25, K=2, seed=2, device="cpu",
                       mcmc=dict(keep=6, burn=6, thin=1),
                       settings=dict(chunk=3))
    assert res["theta_mcmc"].shape == (_npars(q), 6)
    for k in ("theta_mcmc", "beta_mcmc", "tausq_mcmc", "w_mcmc",
              "yhat_mcmc"):
        assert np.isfinite(res[k]).all(), k
    rec = [r for r in trace.history() if r.name == "run_mcmc"][-1]
    sched = res["schedule"]
    per_it = 2 * sum(lvl.B for lvl in sched.levels if lvl.is_ref)
    ref_s = max(lvl.S for lvl in sched.levels if lvl.is_ref)
    assert ref_s > 64 and (ref_s > chol.WIDE_S) == (q == 5)
    assert rec.counter("ops.chol.k1_blocks") == 0
    assert rec.counter("ops.chol.k1_wide_blocks") == 0
    assert rec.counter("ops.chol.plain_blocks") == (
        rec.counter("mcmc.iterations") * per_it)


@pytest.mark.cuda
@pytest.mark.parametrize("q", (2, 3, 5))
def test_graphed_k1_blocks_scale_with_replays(q):
    """On a card, in float32 at 3000 sites x q outcomes: the graphed
    chain's K1 blocks, its parts' captured counts times their replays,
    equal the eager chain's over the same iterations, and no block takes
    the plain route.  At q = 5 every reference level holds 105-122 rows,
    so the 128-thread form counts every K1 block; at q = 2 (48-50 rows)
    and q = 3 (68-72) it counts none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    fit = _fit(_inputs(q, sites=3000), dtype=torch.float32, device="cuda",
               keep=6, burn=6, thin=2)
    ms = fit.ms
    ref = [lvl.rows.shape for t, lvl in enumerate(ms.levels)
           if ms.level_is_ref[t]]
    ref_b = sum(B for B, _ in ref)
    assert all((S > chol.WIDE_S) == (q == 5) for _, S in ref)
    counts = {}
    for graphs in (False, True):
        res = mt.run_mcmc(ms, fit.bounds, fit.cfg, fit.state, fit.gen,
                          graphs=graphs)
        rec = trace.history()[-1]
        assert rec.name == "run_mcmc"
        assert (res["graph_replays"] > 0) == graphs
        counts[graphs] = (rec.counter("ops.chol.k1_blocks"),
                          rec.counter("ops.chol.k1_wide_blocks"),
                          rec.counter("ops.chol.plain_blocks"),
                          rec.counter("mcmc.iterations"))
    for k1, wide, plain, iters in counts.values():
        assert plain == 0
        assert k1 == iters * 2 * ref_b
        assert wide == (k1 if q == 5 else 0)
    assert counts[True] == counts[False]
