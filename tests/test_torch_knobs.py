"""The port's ``spamtree`` knobs on the CPU in float64: the JAX package's
defaults of ``settings``, ``prior``, ``starting`` and ``debug`` pass
through, bench.py's own call runs, a setting the port does not run raises
naming itself, an unknown key of any knob dict raises ValueError; the
tree-shape knobs, elevation and the debug switches end to end (the port's
versions of tests/test_e2e.py's); and ``spamtree_predict`` after a fit
with elevation and non-default tree knobs."""

import numpy as np
import pytest
import torch

import bench
from spamtree_tpu_torch import spamtree, spamtree_predict
from spamtree_tpu_torch.api import prepare_fit
from spamtree_tpu_torch.model.mcmc import run_mcmc_chains
from test_e2e import _sim_univariate

F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
# spamtree_tpu.spamtree's knobs at their defaults
SETTINGS = dict(adapting=True, mcmcsd=None, curvature_sd=True,
                ram_reference_warmup=False, const_model=None, collect="all",
                wire_dtype=None, summary_draws=0, factor_dtype=None,
                lazy_init=None, chunk=50, tuner_overlap=None)
PRIOR = dict(set_unif_bounds=None, btmlim=None, toplim=None, vlim=None,
             beta=None, tausq=None, theta=None)
STARTING = dict(beta=None, tausq=None, theta=None, w=None)
DEBUG = dict(sample_beta=True, sample_tausq=True, sample_theta=True,
             sample_w=True, sample_predicts=True)
KNOBS = dict(elevation=False, start_level=0, tree_depth=np.inf,
             last_not_reference=True, cherrypick_same_margin=True,
             cherrypick_group_locations=True, mvbias=0.0, precompile=True,
             n_chains=1, devices=None, mesh=None)
DRAWS = ("w_mcmc", "yhat_mcmc", "beta_mcmc", "tausq_mcmc", "theta_mcmc")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reference_defaults_pass_through():
    """Every knob given at the JAX package's default (precompile=True
    included) gives the run without them bit for bit; the other spellings
    of the defaults (factor_dtype False / "none" / "off", lazy_init False)
    run."""
    coords, X, y, *_ = _sim_univariate(SS=9)
    mcmc = dict(keep=10, burn=10)
    base = spamtree(y, X, coords, mcmc=mcmc, seed=4, **CPU)
    full = spamtree(y, X, coords, mcmc=mcmc, seed=4, settings=SETTINGS,
                    prior=PRIOR, starting=STARTING, debug=DEBUG, **KNOBS,
                    **CPU)
    for k in DRAWS:
        assert np.array_equal(base[k], full[k]), k
    for s in (dict(factor_dtype=False), dict(factor_dtype="none"),
              dict(factor_dtype="off"), dict(lazy_init=False)):
        out = spamtree(y, X, coords, mcmc=mcmc, seed=4, settings=s, **CPU)
        assert np.isfinite(out["w_mcmc"]).all(), s


def test_bench_call_runs():
    """bench.py's run_config call -- settings collect/chunk/const_model=None,
    precompile=True, n_chains=1 -- with config 4's mvbias=1.0 on config
    4's three imbalanced margins, at a small size."""
    y, y_full, miss, X, coords, mv = bench.make_multivariate(
        60, 3, imbalance=(0.55, 0.3, 0.15))
    out = spamtree(
        y - np.nanmean(y), X, coords, mv_id=mv, cell_size=25,
        mcmc=dict(keep=20, burn=20, thin=2),
        settings=dict(collect="all", chunk=200, const_model=None),
        verbose=False, precompile=True, n_chains=1,
        **bench.CONFIGS[4]["kwargs"], **CPU)
    assert out["fit_config"]["mvbias"] == 1.0
    assert out["theta_mcmc"].shape == (15, 20)
    assert np.isfinite(out["yhat_mcmc"]).all()


@pytest.mark.parametrize("key,value", [
    ("const_model", True), ("const_model", "hybrid"),
    ("factor_dtype", "bfloat16"), ("lazy_init", True),
    ("tuner_overlap", False)])
def test_other_setting_raises_naming_itself(key, value):
    coords, X, y, *_ = _sim_univariate(SS=5)
    with pytest.raises(NotImplementedError, match=key):
        spamtree(y, X, coords, settings={key: value}, **CPU)


@pytest.mark.parametrize("kw", [dict(n_chains=2, accept_aware=True),
                                dict(devices=["cuda:7"]),
                                dict(mesh=object())],
                         ids=["n_chains", "devices", "mesh"])
def test_multi_chain_and_device_knobs_raise(kw):
    """n_chains > 1 runs with the accept-aware step too: two chains
    complete with finite draws (tests/test_torch_chains_accept_aware.py
    holds them to the JAX package's vmapped step); devices= naming a device
    the host does not have raises naming the knob (no worker falls back to
    another device), and so does a mesh= that is not a parallel.mesh.Mesh
    (tests/test_torch_sharding.py runs both knobs)."""
    if "accept_aware" in kw:
        coords, X, y, *_ = _sim_univariate(SS=9)
        fit = prepare_fit(y, X, coords, n_chains=2,
                          mcmc=dict(keep=2, burn=0), **CPU)
        cfg = fit.cfg._replace(accept_aware=True)
        res = run_mcmc_chains(fit.ms, fit.bounds, cfg, fit.state, fit.gen)
        assert res["w"].shape == (2, 2, len(y))
        for k in ("w", "beta", "tausq", "theta"):
            assert np.isfinite(res[k]).all(), k
        return
    coords, X, y, *_ = _sim_univariate(SS=5)
    with pytest.raises((RuntimeError, TypeError), match=next(iter(kw))):
        spamtree(y, X, coords, **kw, **CPU)


@pytest.mark.parametrize("knob", ["mcmc", "settings", "prior", "starting",
                                  "debug"])
def test_unknown_key_raises(knob):
    coords, X, y, *_ = _sim_univariate(SS=5)
    with pytest.raises(ValueError, match=knob):
        spamtree(y, X, coords, **{knob: dict(bogus=1)}, **CPU)


@pytest.mark.parametrize("kw", [
    dict(K=3),
    dict(start_level=1, tree_depth=3),
    dict(tree_depth=2, last_not_reference=False),
    dict(limited_tree=True),
    dict(cherrypick_same_margin=False, cherrypick_group_locations=False),
], ids=["K3", "start_level", "shallow_all_ref", "limited", "no_cherrypick"])
def test_tree_knob_configs(kw):
    """tests/test_e2e.py::test_tree_knob_configs on the port: each runs end
    to end and beats the trivial predictor on the held-out rows."""
    coords, X, y, y_full, w, miss, B = _sim_univariate(SS=11)
    out = spamtree(y, X, coords, cell_size=9, mcmc=dict(keep=30, burn=30),
                   seed=3, **kw, **CPU)
    order = out["order"]
    assert out["yhat_mcmc"].shape == (30, len(y))
    assert np.isfinite(out["yhat_mcmc"]).all()
    yp = out["yhat_mcmc"].mean(axis=0)
    mo = miss[order]
    rmspe = np.sqrt(np.mean((yp[mo] - y_full[order][mo]) ** 2))
    assert rmspe < np.nanstd(y_full), (kw, rmspe)
    fc = out["fit_config"]
    assert all(fc[k] == v for k, v in kw.items()), fc


def _elevation_data(n=320, seed=7):
    """tests/test_e2e.py::test_elevation_through_front_end's data."""
    rng = np.random.default_rng(seed)
    coords = np.column_stack([rng.uniform(size=(n, 2)),
                              0.3 * rng.uniform(size=n)])
    D2 = np.linalg.norm(coords[:, None, :2] - coords[None, :, :2], axis=-1)
    De = np.abs(coords[:, None, 2] - coords[None, :, 2])
    CC = 1.8 * np.exp(-5.0 * D2 - 2.0 * De)
    w = np.linalg.cholesky(CC + 1e-8 * np.eye(n)) @ rng.normal(size=n)
    X = rng.normal(size=(n, 2))
    y_full = X @ np.array([1.0, -0.5]) + w + np.sqrt(0.05) * rng.normal(size=n)
    miss = rng.binomial(1, 0.12, n).astype(bool)
    return coords, X, y_full, miss


def test_elevation_through_front_end():
    """elevation=True reaches covariance model 2 (5-dim theta at q = 1) and
    recovers the held-out rows; without three coordinate columns it
    raises."""
    coords, X, y_full, miss = _elevation_data()
    y = np.where(miss, np.nan, y_full)
    out = spamtree(y, X, coords, elevation=True, cell_size=16,
                   mcmc=dict(keep=120, burn=120), seed=3, **CPU)
    assert out["theta_mcmc"].shape[0] == 5
    assert out["fit_config"]["elevation"] is True
    order = out["order"]
    mo = miss[order]
    rmspe = np.sqrt(np.mean(
        (out["yhat_mcmc"].mean(axis=0)[mo] - y_full[order][mo]) ** 2))
    assert rmspe < 0.75 * np.nanstd(y_full), rmspe
    with pytest.raises(ValueError, match="elevation"):
        spamtree(y, X, coords[:, :2], elevation=True,
                 mcmc=dict(keep=2, burn=0), **CPU)


def test_debug_flags_fix_samplers():
    """tests/test_e2e.py::test_debug_flags_fix_samplers on the port: a
    switched-off sampler keeps its starting value; with theta off too the
    proposal is the isotropic fallback and theta never moves."""
    coords, X, y, *_ = _sim_univariate(SS=9)
    out = spamtree(
        y, X, coords, mcmc=dict(keep=10, burn=5),
        starting=dict(beta=np.array([1.0, 2.0, 3.0]), tausq=0.25),
        debug=dict(sample_beta=False, sample_tausq=False, sample_theta=True,
                   sample_w=True, sample_predicts=True), **CPU)
    assert np.allclose(out["beta_mcmc"][:, :, 0], [[1.0], [2.0], [3.0]])
    assert np.allclose(out["tausq_mcmc"], 0.25)
    th0 = np.array([1.0, 0.5, 5.0, 3.0])
    w0 = np.linspace(-1.0, 1.0, len(y))
    out = spamtree(y, X, coords, mcmc=dict(keep=4, burn=0),
                   starting=dict(theta=th0, w=w0),
                   debug=dict(sample_theta=False, sample_w=False), **CPU)
    assert np.array_equal(out["theta_mcmc"], np.repeat(th0[:, None], 4, 1))
    # w is returned in sorted-row order and never sampled
    assert np.array_equal(out["w_mcmc"][0], w0[out["order"]])
    nt = len(th0)
    n_obs = int(np.isfinite(y).sum())
    np.testing.assert_allclose(
        out["paramsd"], np.sqrt(min(0.01, 1 / (nt * np.sqrt(n_obs))))
        * np.eye(nt))


def test_predict_after_knobbed_fit():
    """spamtree_predict after an elevation fit on a K=3, no-cherrypick tree
    rebuilds the fit's partition (fit_config carries every knob given, and
    elevation, which the JAX package's fit_config lacks) and agrees with the
    in-fit prediction at the held rows within tests/test_predict_new.py's
    envelope."""
    coords, X, y_full, held = _elevation_data()
    kw = dict(elevation=True, cell_size=16, K=3, cherrypick_same_margin=False,
              cherrypick_group_locations=False,
              mcmc=dict(keep=200, burn=150), seed=5, **CPU)
    fit_a = spamtree(np.where(held, np.nan, y_full), X, coords, **kw)
    obs = ~held
    fit_b = spamtree(y_full[obs], X[obs], coords[obs], **kw)
    pos_a = np.flatnonzero(held[fit_a["order"]])
    ya = fit_a["yhat_mcmc"][:, pos_a][:, np.argsort(fit_a["order"][pos_a])]
    pred = spamtree_predict(fit_b, y_full[obs], X[obs], coords[obs],
                            coords_new=coords[held], x_new=X[held], seed=3,
                            device="cpu")
    yb = pred["yhat_pred"]
    assert yb.shape == (200, int(held.sum())) and np.isfinite(yb).all()
    sd = np.sqrt(ya.var(0) / 40 + yb.var(0) / 40) + 0.05
    assert np.mean(np.abs(ya.mean(0) - yb.mean(0)) > 4 * sd) < 0.08
    truth = y_full[np.sort(np.flatnonzero(held))]
    rm_b = np.sqrt(np.mean((yb.mean(0) - truth) ** 2))
    assert rm_b < 0.75 * y_full.std(), rm_b
