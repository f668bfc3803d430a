"""The fit's work counts (``spamtree_tpu_torch.utils.cost``): the counter
against ``torch.utils.flop_counter``, the hand-written kernels' own
counts, and ``spamtree(precompile=True)``'s flops and bytes per kept
draw against the JAX package's XLA count of the same fit."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench as bench_jax
import spamtree_tpu_torch
from spamtree_tpu import spamtree as spamtree_jax
from spamtree_tpu_torch.api import prepare_fit
from spamtree_tpu_torch.model import mcmc
from spamtree_tpu_torch.ops import chol, kernel_counts, level
from spamtree_tpu_torch.ops import covariance as cv
from spamtree_tpu_torch.utils import cost


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fit(n_per_q=150, **kw):
    y, _, _, X, coords, mv = bench_jax.make_multivariate(n_per_q, 2)
    return prepare_fit(y - np.nanmean(y), X, coords, mv_id=mv, cell_size=25,
                       mcmc=dict(keep=10, burn=10, thin=1), device="cpu",
                       **kw)


def test_counter_counts_elementwise_reductions_and_bytes():
    """One op of each kind: operations and bytes from the shapes."""
    a = torch.ones(6, 5)
    b = torch.ones(5, 4)
    with cost.Counter() as c:
        p = a @ b  # mm: 2*6*5*4
        s = p + 1.0  # elementwise: 24 outputs
        r = s.sum(dim=0)  # reduction: 24 inputs
        v = s.t()  # a view: nothing
        v.clone()  # a copy of the view's 24 elements: bytes only
        torch.broadcast_to(r, (6, 4)) * 2.0  # the broadcast holds 4
    f = lambda k: tuple(c.by_kind[k])
    assert f("matmul") == (240, 4 * (30 + 20 + 24))
    assert f("elementwise") == (24 + 24, 4 * (24 + 24) + 4 * (4 + 24))
    assert f("reduction") == (24, 4 * (24 + 4))
    assert f("movement") == (0, 4 * 48)
    assert c.work == cost.Work(240 + 48 + 24, sum(
        v[1] for v in c.by_kind.values()))


def test_matmul_flops_equal_flop_counter_on_a_part():
    """The counter's matrix-product operations on part A of a small fit's
    iteration equal ``FlopCounterMode``'s on the same call."""
    fit = _fit()
    r = mcmc.StepRunner(fit.ms, fit.bounds, fit.cfg, fit.state, None,
                        n_iters=2, capture=False)
    for t in r.d:
        t.fill_(1.0)
    with cost.Counter() as c:
        r._part_A(commit=False)
    with FlopCounterMode(display=False) as f:
        r._part_A(commit=False)
    assert c.by_kind["matmul"][0] == f.get_total_flops() > 0
    assert c.by_kind["kernel"][0] > 0  # K1 on the CPU's plain path


# config 3's reference levels (B, S) and its thin level (B, S, P)
CONFIG3_REF = [(1, 50), (4, 49), (16, 50), (64, 50), (256, 50), (1024, 47)]
CONFIG3_THIN = (1024, 68, 293)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_cost_functions_at_config3_shapes(dtype):
    """Each kernel's cost function is its stated formula at config 3's
    shapes (the bound chip_smoke.py reckons from the same functions)."""
    it = dtype.itemsize
    for B, S in CONFIG3_REF:
        for write_l in (False, True):
            assert chol.inv_chol_cost(B, S, write_l, dtype) == (
                B * 2 * S ** 3 / 3, (3 if write_l else 2) * B * S * S * it)
    B, S, P = CONFIG3_THIN
    assert level.thin_gibbs_cost(B, S, P, dtype) == (
        4 * B * S * P, it * (B * S * P + 6 * B * S + 2 * B * P))
    assert level.thin_decision_cost(B, S, P, dtype) == (
        2 * P * P * (S + 1) * B + 6 * P * S * B,
        it * (2 * B * P * S + B * P * P + B * P + 4 * B * S + 4 * B))
    assert level.thin_decision_cost(B, S, P, dtype, slabs=7,
                                    aligned=False)[1] == it * (
        2 * B * P * S + 7 * P * P + B * P + 4 * B * S + 4 * B) + 8 * B
    # K6 at the thin level's Kxc (P x S, both masks) and four chains
    assert cv.cov_block_cost(4, B, P, S, 2, 2, 2, dtype) == (
        15 * 4 * B * P * S,
        B * (P + S) * (2 * it + 8) + 2 * B * (P + S) + 4 * B * P * S * it)


def _level_args(C=None, B=5, S=6, P=4, Bp=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    lead = () if C is None else (C,)
    r = lambda *s: torch.randn(lead + s, generator=g, dtype=torch.float64)
    joint = torch.linalg.cholesky(
        torch.eye(P, dtype=torch.float64) * P
        + (lambda m: m @ m.mT)(r(Bp, P, P)) * 0.1)
    return dict(Kxc=r(B, P, S) * 0.1, joint=joint,
                lp_pos=torch.randint(0, Bp, (B,), generator=g),
                wpar=r(B, P), w_r=r(B, S), prevH=r(B, S, P),
                prevprec=r(B, S).abs() + 1, kdiag=r(B, S).abs() + 10,
                rmask_f=torch.ones(B, S, dtype=torch.float64))


@pytest.mark.parametrize("case", ["k1", "k1_write_l", "k3", "k4_partials",
                                  "k4_level", "k4_level_aligned",
                                  "k4_chains", "k6", "k6_eye",
                                  "k6_chains_q1"])
def test_kernel_wrappers_count_their_own_work_alone(case, monkeypatch):
    """Under a counter each kernel wrapper on the CPU's plain path records
    its cost function's work as "kernel" work and nothing else: the plain
    version's ops (and K4's reduction and chain fold, K6's mask or identity
    pad) count nothing, so
    the CPU counts what the kernel would record on the card.  The level
    kernels' gate does not change what they count."""
    monkeypatch.setenv("SPAMTREE_LEVEL_KERNELS", "1")
    f64 = torch.float64
    if case.startswith("k1"):
        a = torch.eye(7, dtype=f64).expand(9, 7, 7).contiguous()
        wl = case == "k1_write_l"
        call = lambda: chol.inv_chol(a, write_l=wl)
        want = chol.inv_chol_cost(9, 7, wl, f64)
    elif case == "k3":
        g = torch.Generator().manual_seed(1)
        B, S, P = 5, 6, 4
        H = torch.randn(B, S, P, generator=g, dtype=f64)
        vs = [torch.rand(B, S, generator=g, dtype=f64) + 0.5
              for _ in range(4)] + [torch.ones(B, S, dtype=f64)]
        wpar = torch.randn(B, P, generator=g, dtype=f64)
        call = lambda: level.thin_gibbs_level(H, vs[0], wpar, *vs[1:])
        want = level.thin_gibbs_cost(B, S, P, f64)
    elif case.startswith("k6"):
        g = torch.Generator().manual_seed(2)
        q, C = (1, 3) if case == "k6_chains_q1" else (2, None)
        spec = cv.make_cov_model(2, q)
        nt = spec.npars + spec.k
        theta = torch.rand((nt,) if C is None else (C, nt), generator=g,
                           dtype=f64) + 0.5
        params = cv.unpack_theta(theta, spec)
        B, n1, n2 = 5, 7, 7 if case == "k6_eye" else 4
        c1, c2 = (torch.rand(B, n, 2, generator=g, dtype=f64)
                  for n in (n1, n2))
        m1, m2 = (torch.randint(0, q, (B, n), generator=g) for n in (n1, n2))
        k1, k2 = (torch.rand(B, n, generator=g) < 0.7 for n in (n1, n2))
        if case == "k6_eye":
            call = lambda: cv.cov_block(c1, m1, c1, m1, params, spec, k1,
                                        eye=True)
            want = cv.cov_block_cost(1, B, n1, n1, q, 2, 1, f64)
        else:
            call = lambda: cv.cov_block(c1, m1, c2, m2, params, spec, k1, k2)
            want = cv.cov_block_cost(C or 1, B, n1, n2, q, 2, 2, f64)
    elif case == "k4_chains":
        d = _level_args(C=2)  # lp_pos (B,) and rmask_f (B, S) shared
        call = lambda: level.thin_decision_chains(**d)
        want = level.thin_decision_cost(10, 6, 4, f64, slabs=2 * 3,
                                        aligned=False)
    else:
        aligned = case == "k4_level_aligned"
        d = _level_args(Bp=5 if aligned else 3)
        fn = (level.thin_decision_partials if case == "k4_partials"
              else level.thin_decision_level)
        call = lambda: fn(**d, aligned=aligned)
        want = level.thin_decision_cost(5, 6, 4, f64,
                                         slabs=5 if aligned else 3,
                                         aligned=aligned)
    with cost.Counter() as c:
        call()
    assert tuple(c.by_kind["kernel"]) == tuple(map(float, want))
    assert all(v == [0.0, 0.0] for k, v in c.by_kind.items()
               if k != "kernel"), c.by_kind


def test_part_work_leaves_the_state_and_launches_alone():
    """``mcmc.part_work`` counts every part once from a copy: the state's
    values and the launch counters are as they were, and the same model
    counts the same work twice."""
    fit = _fit()
    before = [t.clone() for t in (fit.state.w, fit.state.theta)]
    counts0 = kernel_counts.snapshot()
    w1 = mcmc.part_work(fit.ms, fit.bounds, fit.cfg, fit.state)
    w2 = mcmc.part_work(fit.ms, fit.bounds, fit.cfg, fit.state)
    assert list(w1) == ["A", "I", "T0", "T1"]
    assert {k: v.work for k, v in w1.items()} == {
        k: v.work for k, v in w2.items()}
    assert all(v.work.flops > 0 and v.work.bytes > 0 for v in w1.values())
    assert kernel_counts.snapshot() == counts0
    assert all(torch.equal(a, b) for a, b in zip(
        before, (fit.state.w, fit.state.theta)))


# the JAX package's measured case: bench.make_multivariate(300, 2),
# cell_size=25, keep 20, burn 10, chunk 10, f32
CASE = dict(cell_size=25, settings=dict(chunk=10))


@pytest.fixture(scope="module")
def counts():
    """Per-kept-draw (flops, bytes) of both packages at thin 1 and 2."""
    y, _, _, X, coords, mv = bench_jax.make_multivariate(300, 2)
    y = y - np.nanmean(y)
    out = {}
    for thin in (1, 2):
        mc = dict(keep=20, burn=10, thin=thin)
        j = spamtree_jax(y, X, coords, mv_id=mv, mcmc=mc, precompile=True,
                         **CASE)
        t = spamtree_tpu_torch.spamtree(y, X, coords, mv_id=mv, mcmc=mc,
                                        precompile=True, device="cpu",
                                        dtype=torch.float32, **CASE)
        out[thin] = dict(
            jax=(j["flops_per_kept_sample"], j["bytes_per_kept_sample"]),
            torch=(t["flops_per_kept_sample"], t["bytes_per_kept_sample"]),
            parts=t["part_work"])
    return out


@pytest.mark.parametrize("thin", [1, 2])
def test_count_against_xla(counts, thin):
    """The port's flops per kept draw within 4x of XLA's count of the
    same work, its bytes within 8x (XLA leaves the LAPACK custom calls at
    zero and counts a fusion's bytes once).  XLA's cost analysis counts
    the keep chunk's scan body -- one kept draw's ``thin`` iterations --
    once, not over its trip count: the JAX package's per-kept figure is
    that count over the chunk's 10 kept draws, so XLA's count of one kept
    draw is 10 times it."""
    mc = CASE["settings"]["chunk"]
    (fj, bj), (ft, bt) = counts[thin]["jax"], counts[thin]["torch"]
    fx, bx = fj * mc, bj * mc
    assert 1 / 4 < ft / fx < 4, (ft, fx)
    assert 1 / 8 < bt / bx < 8, (bt, bx)
    parts = counts[thin]["parts"]
    assert parts["A"]["calls"] == 20 * thin
    assert parts["T1"]["calls"] == 20
    assert parts["T0"]["calls"] == 20 * (thin - 1)


def test_count_scales_with_thin_as_xla(counts):
    """thin 2 doubles the work behind a kept draw, in both packages."""
    j = counts[2]["jax"][0] / counts[1]["jax"][0]
    t = counts[2]["torch"][0] / counts[1]["torch"][0]
    tb = counts[2]["torch"][1] / counts[1]["torch"][1]
    assert abs(j - 2) < 0.2 and abs(t - 2) < 0.2 and abs(tb - 2) < 0.2, (
        j, t, tb)


def test_no_count_without_precompile():
    y, _, _, X, coords, mv = bench_jax.make_multivariate(60, 2)
    out = spamtree_tpu_torch.spamtree(
        y - np.nanmean(y), X, coords, mv_id=mv, cell_size=25,
        mcmc=dict(keep=4, burn=4, thin=1), device="cpu")
    assert out["flops_per_kept_sample"] is None
    assert out["bytes_per_kept_sample"] is None
    assert out["part_work"] is None
    assert "work_count_s" not in out["setup_breakdown"]


def test_chains_count_every_chain():
    """Batched chains count the C0/C1 parts over all chains: at C = 2
    about twice one chain's work per kept draw."""
    y, _, _, X, coords, mv = bench_jax.make_multivariate(60, 2)
    kw = dict(mv_id=mv, cell_size=25, mcmc=dict(keep=4, burn=4, thin=1),
              device="cpu", precompile=True)
    y = y - np.nanmean(y)
    one = spamtree_tpu_torch.spamtree(y, X, coords, **kw)
    two = spamtree_tpu_torch.spamtree(y, X, coords, n_chains=2, **kw)
    assert set(two["part_work"]) == {"C0", "C1"}
    assert two["part_work"]["C1"]["calls"] == 4
    r = two["flops_per_kept_sample"] / one["flops_per_kept_sample"]
    assert 1.5 < r < 3, r
