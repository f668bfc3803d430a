"""Batched chains in the port (``mcmc.run_mcmc_chains``,
``spamtree(n_chains=)``) on the CPU in float64, one intra-op thread.

* Each chain of a batched run at C = 3, always-emit or accept-aware, is
  the single-chain run whose generator is seeded like that chain's, to
  rtol 1e-8: the batched step
  runs the same algebra with a chain axis, but its products sum the chains'
  blocks in batched GEMMs, and the chains form their Gram blocks in place
  where a single chain carries them, so the draws agree to rounding.
* Every core function with a chain axis gives, chain by chain, the single
  chain's result (rtol 1e-9, as tests/test_torch_core.py), also at a chain
  axis of 1; one chain's failed Cholesky rejects that chain alone, in
  the decision-only sweep too; the step, always-emit or accept-aware,
  reads nothing from the device; K1 runs once per reference level for all
  chains.
* ``spamtree(n_chains=2)`` returns the JAX package's keys and shapes, and
  the JAX package's chain tests run on the port: resume with chains
  (tests/test_e2e.py), sinks with chains, prediction from a multi-chain fit
  (tests/test_predict_new.py), summary collection with chains
  (tests/test_collect_wire.py) and the n_chains=2 rows of
  tests/test_api_fuzz.py."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import spamtree_tpu
from spamtree_tpu_torch import (
    load_fit,
    save_fit,
    spamtree,
    spamtree_predict,
    summarize_fit,
)
from spamtree_tpu_torch.api import prepare_fit
from spamtree_tpu_torch.model import core as ct
from spamtree_tpu_torch.model import mcmc as mt
from spamtree_tpu_torch.model.params import make_theta_spec
from spamtree_tpu_torch.ops import linalg
from spamtree_tpu_torch.tree.partition import make_tree
from spamtree_tpu_torch.tree.schedule import build_schedule
from spamtree_tpu_torch.utils.native import read_sink
from test_api_fuzz import GRID, _data as _fuzz_data
from test_collect_wire import _data as _wire_data
from test_e2e import _sim_univariate
from test_predict_new import _sim
from test_torch_core import CASES, TAUSQ_AB, _close, _models, _theta

F64 = dict(dtype=torch.float64, device="cpu")
DRAWS = ("w_mcmc", "yhat_mcmc", "beta_mcmc", "tausq_mcmc", "theta_mcmc")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prepared(q, collect="all", thin=2, n_chains=1, **kw):
    """A prepared fit on a tree with reference and thin levels."""
    y, _, _, X, coords, mv = bench.make_multivariate(300 if q == 1 else 120,
                                                     q)
    return prepare_fit(y, X, coords, mv_id=mv, cell_size=16,
                       mcmc=dict(keep=12, burn=8, thin=thin),
                       settings=dict(chunk=5, collect=collect), seed=5,
                       n_chains=n_chains, **F64, **kw)


@pytest.mark.parametrize("q,collect,accept_aware", [
    pytest.param(1, "all", False, id="1-all"),
    pytest.param(1, "summary", False, id="1-summary"),
    pytest.param(2, "all", False, id="2-all"),
    pytest.param(2, "summary", False, id="2-summary"),
    pytest.param(1, "all", True, id="1-all-accept_aware"),
    pytest.param(2, "all", True, id="2-all-accept_aware")])
def test_each_chain_is_its_single_chain_run(q, collect, accept_aware):
    """C = 3 chains from one prepared state, generators seeded 100 + c:
    chain c's draws and accept count are run_mcmc's with that generator
    (thin = 2; w draws, or w's posterior moments in summary mode), on the
    always-emit step and on the accept-aware step (the batched one runs
    the rebuild for every chain and installs it where the chain
    accepted)."""
    fit = _prepared(q, collect)
    ms = fit.ms
    cfg = fit.cfg._replace(accept_aware=accept_aware)
    assert {True, False} <= set(ms.level_is_ref)
    states, gens = mt.stack_chain_states(fit.state, 100 + np.arange(3))
    rc = mt.run_mcmc_chains(ms, fit.bounds, cfg, states, gens)
    keys = ("beta", "tausq", "theta") + (("w",) if collect == "all"
                                         else ("w_mean", "w_var"))
    for c in range(3):
        gen = torch.Generator().manual_seed(100 + c)
        r1 = mt.run_mcmc(ms, fit.bounds, cfg, fit.state, gen)
        for k in keys:
            got = rc[k][c] if k.startswith("w_") else rc[k][:, c]
            _close(got, r1[k], f"chain {c} {k}", rtol=1e-8)
        assert float(rc["state"].ram.accept_count[c]) \
            == r1["state"].ram.accept_count
        assert rc["accept_by_chain"][c] == r1["accept_ratio"]
    assert rc["theta"].shape == (12, 3, fit.state.theta.shape[0])


def _port_model(case):
    """A univariate model on the limited tree (children condition on their
    parent block's rows alone), or at n=2500, cell_size 49, where the
    parent-aligned thin and prediction layouts activate."""
    rng = np.random.default_rng(3)
    limited = case == "limited"
    n = 300 if limited else 2500
    coords = rng.uniform(size=(n, 2))
    order = np.lexsort((np.arange(n), coords[:, 1], coords[:, 0]))
    coords = coords[order]
    mv = np.zeros(n, dtype=np.int64)
    na = rng.uniform(size=n) > 0.15
    y = np.where(na, rng.normal(size=n), np.nan)
    X = np.column_stack([np.ones(n), rng.normal(size=n)])
    tree = make_tree(coords, na, mv, axis_cell_size=3 if limited else 7, K=2,
                     limited_tree=limited, rng=np.random.default_rng(0))
    ms = ct.ModelStatic(build_schedule(tree, limited_tree=limited), coords,
                        mv, y, X, make_theta_spec(2, 1).spec, **F64)
    assert limited or (any(ms.level_aligned) and any(ms.pred_aligned))
    return ms, rng


def _per_chain(batched, singles, what, rtol=1e-9):
    """``batched`` (nested tuples of (C, ...) tensors) equals the list of
    single-chain results chain by chain."""
    if isinstance(batched, tuple):
        for i, b in enumerate(batched):
            _per_chain(b, [s[i] for s in singles], f"{what}[{i}]", rtol)
        return
    assert batched is not None, what
    for c, s in enumerate(singles):
        _close(batched[c], s, f"{what} chain {c}", rtol)


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("case", CASES + ["limited", "aligned"])
def test_batched_functions_are_per_chain(case, C):
    """sweep (alone, and fused with both quadratic forms and the raw
    prediction joint), gibbs_w, pred_operators_from_joint, predict,
    predict_recompute, quad_loglik and the conjugate tail: with a chain
    axis each chain gets its single-chain result (chunked levels, parent-
    major groups and elevation through tests/test_torch_core.py's models,
    the limited tree, the aligned layouts; K1's plain version takes the
    folded (C*B, S, S) batches)."""
    if case in ("limited", "aligned"):
        ms, rng = _port_model(case)
        th = lambda: _theta("univariate", 1, rng)
    else:
        _, ms, rng = _models(case)
        th = lambda: _theta(case, ms.q, rng)
    n, p, q = ms.n, ms.p, ms.q
    t = lambda a: torch.as_tensor(np.asarray(a))
    th0 = t(np.stack([th() for _ in range(C)]))
    th1 = t(np.stack([th() for _ in range(C)]))
    w = rng.normal(size=(C, n + 1))
    w[:, -1] = 0.0
    w, XB = t(w), t(np.concatenate(
        [0.3 * rng.normal(size=(C, n)), np.zeros((C, 1))], axis=1))
    tinv = t(rng.uniform(2.0, 8.0, size=(C, q)))
    z = t(rng.normal(size=(C, n + 1)))
    g = t(rng.gamma(30.0, size=(C, q)))
    zb = t(rng.normal(size=(C, p, q)))
    Vi = 0.01 * torch.eye(p, dtype=torch.float64)
    Vim = torch.zeros(p, dtype=torch.float64)

    def run(th0, th1, w, tinv, XB, z, g, zb):
        ld0, pd0, lg0, ok0 = ct.sweep(ms, th0, w)
        fused = ct.sweep(ms, th1, w, quad_prev=ld0, emit_pred_joint=True)
        wg = ct.gibbs_w(ms, ld0, w, tinv, XB, z)
        po = (ct.pred_operators_from_joint(ms, th1, fused[1])
              if fused[1] is not None else ())
        wp = ct.predict(ms, pd0, wg, z)
        ts = ct.gibbs_tausq(ms, wp, XB, g, TAUSQ_AB)
        return (ld0, lg0, ok0.to(torch.float64), fused[0], fused[2:4],
                fused[4:], wg, po, wp, ct.predict_recompute(ms, th0, wg, z),
                ct.quad_loglik(ms, ld0, w),
                ct.gibbs_beta_tausq(ms, wp, XB, g, zb, TAUSQ_AB, Vi, Vim),
                ts, ct.gibbs_beta(ms, wp, ts, zb, Vi, Vim))

    args = (th0, th1, w, tinv, XB, z, g, zb)
    singles = [run(*(a[c] for a in args)) for c in range(C)]
    assert all(float(s[2]) == 1.0 for s in singles)
    _per_chain(run(*args), singles, case)


def test_failed_cholesky_rejects_its_chain_alone(monkeypatch):
    """theta of shape (2, nt) whose first row fails Cholesky (a negative
    variance): ok == [False, True], and the good row's logdet and
    quadratic forms equal its single-chain sweep's, in the full sweep and
    in the decision-only sweep (with the level-kernel gate off and on: the
    plain K4 on the fold of both chains)."""
    _, ms, rng = _models("univariate")
    good = _theta("univariate", 1, rng)
    bad = good.copy()
    bad[0] = -1.0
    th = torch.as_tensor(np.stack([bad, good]))
    w = torch.as_tensor(np.append(rng.normal(size=ms.n), 0.0))
    prev = ct.sweep(ms, th[1], w)[0]
    one = ct.sweep(ms, th[1], w, quad_prev=prev)
    assert not bool(ct.sweep(ms, th[0], w)[3])
    prev2 = tuple(ct.LevelData(*(torch.stack([a, a]) for a in d))
                  for d in prev)
    both = ct.sweep(ms, th, torch.stack([w, w]), quad_prev=prev2)
    assert both[3].tolist() == [False, True]
    for i in (2, 4, 5):
        _close(both[i][1], one[i], f"output {i}", rtol=1e-12)
    for kernels in ("0", "1"):
        monkeypatch.setenv("SPAMTREE_LEVEL_KERNELS", kernels)
        dec1 = ct.sweep(ms, th[1], w, quad_prev=prev, decision_only=True)
        dec = ct.sweep(ms, th, torch.stack([w, w]), quad_prev=prev2,
                       decision_only=True)
        assert dec[1].tolist() == [False, True]
        for i in (0, 2, 3):
            _close(dec[i][1], dec1[i], f"decision output {i}", rtol=1e-12)


def _chain_step_setup(accept_aware=None):
    fit = _prepared(2, n_chains=2)
    ms = fit.ms
    step = mt.make_step(ms, fit.bounds,
                        fit.cfg._replace(accept_aware=accept_aware),
                        coords_cache=ct.level_coords(ms), chains=True)
    draw = lambda: mt.draw_chains(ms, fit.gen, fit.state.theta.shape[1],
                                  ct.tausq_shape(ms, fit.cfg.tausq_ab))
    return fit, step, draw


def test_chain_step_reads_nothing_from_the_device(monkeypatch):
    """Two iterations of the batched step (predicting and not), always-emit
    and accept-aware (with the level kernels on, K4's fold included), with
    every tensor-to-host conversion made to raise."""
    for accept_aware in (None, True):
        fit, step, draw = _chain_step_setup(accept_aware)
        draws = [draw(), draw()]

        def read(*a, **k):
            raise AssertionError("the chain step read a tensor on the host")

        monkeypatch.setenv("SPAMTREE_LEVEL_KERNELS",
                           "1" if accept_aware else "0")
        for name in ("item", "tolist", "numpy", "cpu", "__bool__",
                     "__float__", "__int__", "__index__"):
            monkeypatch.setattr(torch.Tensor, name, read)
        st = step(fit.state, draws[0], True)
        st = step(st, draws[1], False)
        monkeypatch.undo()
        assert st.theta.shape == fit.state.theta.shape
        assert torch.isfinite(st.w).all()


def test_k1_once_per_level_for_all_chains(monkeypatch):
    """K1 (through chol_inv_masked) is called as often per iteration at
    C = 1 and C = 3 as by the single-chain step, on (C*B, S, S) batches."""
    calls = []
    real = linalg.inv_chol
    monkeypatch.setattr(linalg, "inv_chol",
                        lambda a, *k: calls.append(a.shape[0]) or real(a, *k))
    fit = _prepared(1)
    ms = fit.ms
    cc = ct.level_coords(ms)
    nt = fit.state.theta.shape[0]
    shape = ct.tausq_shape(ms, fit.cfg.tausq_ab)
    single = mt.make_step(ms, fit.bounds, fit.cfg, coords_cache=cc)
    calls.clear()
    single(fit.state, mt.draw_step(ms, torch.Generator().manual_seed(0), nt,
                                   shape), True)
    want = list(calls)
    assert want
    batched = mt.make_step(ms, fit.bounds, fit.cfg, coords_cache=cc,
                           chains=True)
    for C in (1, 3):
        states, gens = mt.stack_chain_states(fit.state, np.arange(C))
        calls.clear()
        batched(states, mt.draw_chains(ms, gens, nt, shape), True)
        assert calls == [C * b for b in want], (C, calls, want)


@pytest.mark.parametrize("collect", ["all", "summary"])
def test_output_layout_matches_jax(collect):
    """spamtree(n_chains=2) on the same inputs: every JAX output key (but
    XLA's cost counts, which an eager run has not) with the same shape."""
    y, X, coords, mv = _fuzz_data(100, 2, 0.15)
    kw = dict(mv_id=mv, cell_size=9, K=2, mcmc=dict(keep=6, burn=4),
              settings=dict(chunk=4, collect=collect, summary_draws=3),
              n_chains=2, seed=7)
    ref = spamtree_tpu.spamtree(y, X, coords, dtype=jnp.float64, **kw)
    got = spamtree(y, X, coords, **kw, **F64)
    assert set(ref) - set(got) <= {"flops_per_kept_sample",
                                   "bytes_per_kept_sample"}
    for k, v in ref.items():
        if isinstance(v, np.ndarray) or k in ("n_chains", "summary_count"):
            assert np.shape(got[k]) == np.shape(v), (k, np.shape(got[k]),
                                                     np.shape(v))
    assert got["n_chains"] == ref["n_chains"] == 2


@pytest.mark.parametrize("written,asked", [(1, 2), (2, 1), (2, 3)])
def test_resume_chain_count_mismatch(tmp_path, written, asked):
    """A checkpoint's chain count must match n_chains, caught before any
    sampling (tests/test_e2e.py:236-240)."""
    coords, X, y, *_ = _sim_univariate(SS=9)
    ck = str(tmp_path / "ck.npz")
    kw = dict(settings=dict(chunk=10), seed=17, **F64)
    spamtree(y, X, coords, mcmc=dict(keep=10, burn=10), n_chains=written,
             checkpoint_path=ck, **kw)
    with pytest.raises(ValueError, match="chain"):
        spamtree(y, X, coords, mcmc=dict(keep=20, burn=10), n_chains=asked,
                 resume_from=ck, **kw)


@pytest.mark.parametrize("when", ["keep", "burn"])
def test_resume_with_chains_is_bit_identical(tmp_path, when):
    """Two chains resumed after half the keeps (tests/test_e2e.py:276-288),
    or mid-burn, reproduce the uninterrupted run's draws bit for bit."""
    coords, X, y, *_ = _sim_univariate(SS=9)
    kw2 = dict(seed=23, settings=dict(chunk=10), n_chains=2, **F64)
    ck2 = str(tmp_path / "ck_chains.npz")
    full2 = spamtree(y, X, coords, mcmc=dict(keep=20, burn=20), **kw2)
    first = dict(keep=10, burn=20) if when == "keep" else dict(keep=0,
                                                               burn=10)
    spamtree(y, X, coords, mcmc=first, checkpoint_path=ck2, **kw2)
    res2 = spamtree(y, X, coords, mcmc=dict(keep=20, burn=20),
                    resume_from=ck2, **kw2)
    kept = first["keep"]
    assert res2["resumed_kept_already"] == kept
    assert res2["w_mcmc"].shape == (20 - kept, 2, len(y))
    for k in DRAWS:
        assert np.array_equal(res2[k], full2[k][kept:]), k


def test_chains_sink_roundtrip(tmp_path):
    """Multi-chain draws stream to sinks with the chain axis intact:
    read_sink(n_chains=2) reproduces the in-RAM run's draws
    (tests/test_e2e.py:560-574; sink files are float32)."""
    coords, X, y, *_ = _sim_univariate(SS=9)
    n = len(y)
    kw = dict(seed=31, n_chains=2, settings=dict(chunk=5, wire_dtype="none"),
              mcmc=dict(keep=10, burn=5), **F64)
    ram = spamtree(y, X, coords, **kw)
    sd = str(tmp_path / "sink")
    spamtree(y, X, coords, sink_dir=sd, **kw)
    draws = read_sink(os.path.join(sd, "w_mcmc.f32"), n, n_chains=2)
    assert draws.shape == (10, 2, n)
    np.testing.assert_allclose(np.asarray(draws), ram["w_mcmc"], rtol=1e-6,
                               atol=1e-6)


def test_predict_new_multichain_flatten():
    """A multi-chain fit's (keep, C, ...) draws fold into keep*C replay
    draws; outputs stay finite and shaped (S, m)
    (tests/test_predict_new.py:131)."""
    coords, X, y_full, held = _sim(n=240, seed=12)
    obs = ~held
    kw = dict(cell_size=16, K=2, seed=9, **F64)
    fit = spamtree(y_full[obs], X[obs], coords[obs], n_chains=2,
                   mcmc=dict(keep=15, burn=15, thin=1), **kw)
    p = spamtree_predict(fit, y_full[obs], X[obs], coords[obs],
                         coords_new=coords[held], x_new=X[held], n_draws=12,
                         chunk=5, device="cpu")
    assert p["w_pred"].shape == (12, int(held.sum()))
    assert np.isfinite(p["yhat_pred"]).all()
    rm = np.sqrt(np.mean((p["yhat_pred"].mean(0) - y_full[held]) ** 2))
    assert rm < 0.7 * y_full.std()


def test_chain_fit_file_and_summary(tmp_path):
    """A two-chain fit through save_fit/load_fit: summarize_fit's table
    with split-Rhat, and spamtree_predict on the loaded fit equals it on
    the fit in memory."""
    coords, X, y, *_ = _sim_univariate(SS=9)
    fit = spamtree(y, X, coords, mcmc=dict(keep=8, burn=6), n_chains=2,
                   seed=3, **F64)
    path = str(tmp_path / "fit.npz")
    save_fit(path, fit)
    back = load_fit(path)
    assert back["n_chains"] == 2 and back["fit_config"]["n_chains"] == 2
    for k in DRAWS:
        np.testing.assert_array_equal(back[k], fit[k])
    table = summarize_fit(back)
    assert table["n_chains"] == 2
    new = dict(coords_new=coords[:5] + 1e-3, x_new=X[:5], n_draws=6,
               device="cpu")
    a = spamtree_predict(fit, y, X, coords, **new)
    b = spamtree_predict(back, y, X, coords, **new)
    np.testing.assert_array_equal(a["w_pred"], b["w_pred"])


WIRE_KW = dict(cell_size=16, K=2, seed=7, verbose=False)


def test_summary_mode_chains():
    """Summary accumulators carry a chain axis (tests/test_collect_wire.py:
    69): moments (C, n), the quantile subsample (keep', C, n), and the
    theta convergence diagnostics."""
    r = spamtree(*_wire_data(n=200), mcmc=dict(keep=9, burn=4, thin=1),
                 n_chains=2, settings=dict(collect="summary", chunk=5,
                                           summary_draws=4),
                 **WIRE_KW, **F64)
    n = 200
    assert r["summary_count"] == 9
    assert r["w_mean"].shape == (2, n)
    assert r["w_mcmc"].shape == (4, 2, n)
    assert np.isfinite(r["yhat_mcmc"]).all()
    nt = r["theta_mcmc"].shape[-1]
    assert r["theta_rhat"].shape == (nt,)
    assert r["theta_ess"].shape == (nt,)
    assert r["yhat_var"].shape == (2, n)
    assert np.isfinite(r["w_mean"]).all() and (r["w_var"] >= 0).all()
    assert not np.allclose(r["w_mean"][0], r["w_mean"][1])


@pytest.mark.parametrize("n_chains", [1, 2])
def test_summary_resume_continues_moments(tmp_path, n_chains):
    """A collect="summary" run resumed from its checkpoint ends with the
    uninterrupted run's moments exactly (tests/test_collect_wire.py:
    175-196), for one chain and for two."""
    sset = dict(wire_dtype="none", collect="summary", chunk=4)
    kw = dict(n_chains=n_chains, settings=sset, **WIRE_KW, **F64)
    full = spamtree(*_wire_data(), mcmc=dict(keep=12, burn=4, thin=1), **kw)
    ck = str(tmp_path / f"ck{n_chains}.npz")
    half = spamtree(*_wire_data(), mcmc=dict(keep=8, burn=4, thin=1),
                    checkpoint_path=ck, **kw)
    res = spamtree(*_wire_data(), mcmc=dict(keep=12, burn=4, thin=1),
                   resume_from=ck, **kw)
    assert res["resumed_kept_already"] == 8
    assert res["summary_count"] == 12
    for k in ("w_mean", "w_var", "yhat_mean"):
        np.testing.assert_array_equal(res[k], full[k])
    assert half["summary_count"] == 8


@pytest.mark.parametrize("q,miss,limited,thin,n_chains,collect,wire,extra",
                         [g for g in GRID if g[4] == 2])
def test_knob_combination_chains(q, miss, limited, thin, n_chains, collect,
                                 wire, extra):
    """tests/test_api_fuzz.py's n_chains=2 rows on the port, with its
    structural checks."""
    y, X, coords, mv = _fuzz_data(72 if q == 3 else 100, q, miss)
    n = len(coords)
    keep, burn = 6, 4
    settings = dict(chunk=4, collect=collect)
    if wire is not None:
        settings["wire_dtype"] = wire
    settings.update({k: v for k, v in extra.items() if k == "summary_draws"})
    dtype = torch.float32 if wire == "float16" else torch.float64
    out = spamtree(y, X, coords, mv_id=mv, cell_size=9, K=2,
                   limited_tree=limited,
                   mcmc=dict(keep=keep, burn=burn, thin=thin),
                   settings=settings, n_chains=n_chains, seed=7, dtype=dtype,
                   device="cpu")
    assert sorted(out["order"].tolist()) == list(range(n))
    nt = out["theta_mcmc"].shape[-1]
    assert nt == 3 * q + (3 if q > 2 else 1) + q * (q - 1) // 2
    assert out["theta_mcmc"].shape == (keep, n_chains, nt)
    assert out["tausq_mcmc"].shape == (keep, n_chains, q)
    assert out["beta_mcmc"].shape == (keep, n_chains, 2, q)
    assert np.isfinite(out["theta_mcmc"]).all()
    assert np.isfinite(out["beta_mcmc"]).all()
    assert (np.asarray(out["tausq_mcmc"]) > 0).all()
    if collect == "all":
        assert out["w_mcmc"].shape == (keep, n_chains, n)
        assert np.isfinite(out["w_mcmc"]).all()
        assert np.isfinite(out["yhat_mcmc"]).all()
    else:
        assert out["w_mean"].shape == (n_chains, n)
        assert np.isfinite(out["w_mean"]).all()
        assert (out["w_var"] >= 0).all()
        if extra.get("summary_draws", 0):
            assert out["w_mcmc"].shape[0] > 0
            assert np.isfinite(out["w_mcmc"]).all()
    assert 0.0 <= out["accept_ratio"] <= 1.0
    assert out["accept_by_chain"].shape == (n_chains,)
    assert out["mcmc_time"] > 0
