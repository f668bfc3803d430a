"""The port's prediction without carried operators and after a fit:
``predict_recompute`` against the JAX package's (float64, the same z,
rtol 1e-8) and against the port's ``predict``; ``make_step`` with
``pred_in_carry`` False against the JAX step; ``spamtree_predict``
against the port's in-fit prediction (the envelope of
tests/test_predict_new.py), its input checks and its augmented-row
mapping against the JAX function's; the fit's tree extended by the new
rows against the tree rebuilt; fit files and summaries across the two
packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spamtree_tpu
from spamtree_tpu.model import core as cj
from spamtree_tpu.model import mcmc as mj
from spamtree_tpu.model.params import make_theta_spec
from spamtree_tpu.tree.partition import make_tree as make_tree_jax
from spamtree_tpu.tree.schedule import build_schedule as build_schedule_jax
from spamtree_tpu.utils import fitio as fitio_jax
from spamtree_tpu.utils import summaries as summaries_jax
import spamtree_tpu_torch
from spamtree_tpu_torch.model import core as ct
from spamtree_tpu_torch.model import mcmc as mt
from spamtree_tpu_torch.tree.partition import make_tree
from spamtree_tpu_torch.tree.schedule import build_schedule
from spamtree_tpu_torch.utils import trace
from spamtree_tpu_torch.utils.convert import (
    model_state_from_numpy,
    model_state_to_numpy,
)
from test_predict_new import _sim
from test_torch_accept_aware import _data
from test_torch_mcmc import _close_tree

THETA = np.array([1.0, 0.8, 0.3, 0.3, 4.0, 4.0, 4.0, 1.0])
KW = dict(cell_size=16, K=2, seed=9, dtype=torch.float64, device="cpu")


# the models here are small: one intra-op thread runs them as fast, and
# keeps test files run in parallel processes from oversubscribing the cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(limited, chunk_bytes=512e6):
    coords, mv, y, X = _data()
    kw = dict(axis_cell_size=4, K=2, limited_tree=limited)
    spec = make_theta_spec(2, 2).spec
    tree = lambda mk: mk(coords, np.isfinite(y), mv,
                         rng=np.random.default_rng(0), **kw)
    ms_j = cj.ModelStatic(
        build_schedule_jax(tree(make_tree_jax), limited_tree=limited),
        coords, mv, y, X, spec, dtype=jnp.float64, chunk_bytes=chunk_bytes)
    ms_t = ct.ModelStatic(
        build_schedule(tree(make_tree), limited_tree=limited),
        coords, mv, y, X, spec, dtype=torch.float64, device="cpu",
        chunk_bytes=chunk_bytes)
    return ms_j, ms_t


@pytest.mark.parametrize("limited,chunk_bytes", [
    (False, 512e6), (True, 512e6), (False, 2e4)],
    ids=["full", "limited", "full_chunked"])
def test_predict_recompute_matches_jax_and_predict(limited, chunk_bytes):
    """Same theta, w and z (drawn from the JAX key as JAX's
    predict_recompute draws it): the port's predict_recompute equals the
    JAX package's (rtol 1e-8) and the port's predict with the operators
    of its own sweep (rtol 1e-12)."""
    ms_j, ms_t = _models(limited, chunk_bytes)
    assert ms_t.pred_arrays is not None
    if chunk_bytes < 1e6:
        assert max(ms_t.pred_chunks) > 1 or max(ms_t.level_chunks) > 1
    rng = np.random.default_rng(4)
    w = rng.normal(size=ms_t.n + 1)
    w[ms_t.n] = 0.0
    key = jax.random.PRNGKey(11)
    z = np.array(jax.random.normal(key, (ms_t.n + 1,), dtype=jnp.float64))
    want = np.asarray(cj.predict_recompute(
        ms_j, jnp.asarray(THETA), jnp.asarray(w), key))
    th, wt, zt = (torch.as_tensor(a) for a in (THETA, w, z))
    got = ct.predict_recompute(ms_t, th, wt, zt, ct.level_coords(ms_t))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())
    assert float(got[ms_t.n]) == 0.0
    _, pd, _, ok = ct.sweep(ms_t, th, wt)
    assert bool(ok)
    np.testing.assert_allclose(got.numpy(), ct.predict(ms_t, pd, wt, zt).numpy(),
                               rtol=1e-12, atol=1e-12)
    # rows outside the prediction blocks are left as they were
    pred_rows = torch.cat([lv.rows.reshape(-1) for lv in ms_t.pred_arrays])
    keep = torch.ones(ms_t.n + 1, dtype=torch.bool)
    keep[pred_rows] = False
    assert torch.equal(got[keep], wt[keep])


def test_steps_without_carried_operators_match_jax():
    """pred_in_carry set False on both packages' models: no prediction
    operators in the state, prediction through predict_recompute; five
    port steps equal five JAX steps given the same draws (rtol 1e-8)."""
    ms_j, ms_t = _models(False)
    ms_j.pred_in_carry = ms_t.pred_in_carry = False
    tspec = make_theta_spec(2, 2, start_theta=THETA)
    sd = np.diag([3e-4, 3e-9] + [3e-4] * 6)
    cfg_j, cfg_t = mj.MCMCConfig(mcmcsd=sd), mt.MCMCConfig(mcmcsd=sd)
    st_j = mj.init_state(ms_j, tspec.bounds, tspec.start, cfg=cfg_j, seed=0)
    assert st_j.pred_data is None
    st_t = model_state_from_numpy(ms_t, model_state_to_numpy(st_j))
    step_j = jax.jit(mj.make_step(ms_j, tspec.bounds, cfg_j),
                     static_argnums=2)
    step_t = mt.make_step(ms_t, tspec.bounds, cfg_t,
                          coords_cache=ct.level_coords(ms_t))
    shape = ct.tausq_shape(ms_t, cfg_t.tausq_ab).numpy()
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(3), 5)):
        kw_, kt, ku, kp, kq, kb = jax.random.split(key, 6)
        f64 = jnp.float64
        draws = mt.StepDraws(*(torch.as_tensor(np.array(a)) for a in (
            jax.random.normal(kw_, (ms_t.n + 1,), dtype=f64),
            jax.random.normal(kt, (tspec.n_theta,), dtype=f64),
            jax.random.uniform(ku, dtype=f64),
            jax.random.normal(kp, (ms_t.n + 1,), dtype=f64),
            jax.random.gamma(kq, jnp.asarray(shape), dtype=f64),
            jax.random.normal(kb, (ms_t.p, ms_t.q), dtype=f64))))
        st_j = step_j(st_j, key, True)
        st_t = step_t(st_t, draws, True)
        assert st_t.pred_data is None
        _close_tree(model_state_to_numpy(st_t), model_state_to_numpy(st_j),
                    f"step {i}", rtol=1e-8)
    # the port's init_state builds no operators either
    assert mt.init_state(ms_t, tspec.bounds, tspec.start,
                         cfg=cfg_t).pred_data is None


@pytest.fixture(scope="module")
def fits():
    """tests/test_predict_new.py's data: an in-fit run with the held rows
    as NA, and a run that never sees them (keep=300, burn=200)."""
    coords, X, y_full, held = _sim()
    mcmc = dict(keep=300, burn=200, thin=1)
    fit_a = spamtree_tpu_torch.spamtree(np.where(held, np.nan, y_full), X,
                                        coords, mcmc=mcmc, **KW)
    obs = ~held
    fit_b = spamtree_tpu_torch.spamtree(y_full[obs], X[obs], coords[obs],
                                        mcmc=mcmc, **KW)
    return coords, X, y_full, held, fit_a, fit_b


def test_predict_new_matches_in_fit_prediction(fits):
    """The post-fit prediction at the held rows agrees with the in-fit one
    within test_predict_new.py's Monte-Carlo envelope, in mean and spread,
    and both beat the data scale."""
    coords, X, y_full, held, fit_a, fit_b = fits
    obs = ~held
    pos_a = np.flatnonzero(held[fit_a["order"]])
    orig = np.argsort(fit_a["order"][pos_a])
    ya, wa = fit_a["yhat_mcmc"][:, pos_a][:, orig], fit_a["w_mcmc"][:, pos_a][:, orig]
    pred = spamtree_tpu_torch.spamtree_predict(
        fit_b, y_full[obs], X[obs], coords[obs], coords_new=coords[held],
        x_new=X[held], seed=3, device="cpu")
    yb, wb = pred["yhat_pred"], pred["w_pred"]
    assert wb.shape == (300, int(held.sum()))
    sd = np.sqrt(ya.var(0) / 40 + yb.var(0) / 40) + 0.05
    assert np.mean(np.abs(ya.mean(0) - yb.mean(0)) > 4 * sd) < 0.08
    sdw = np.sqrt(wa.var(0) / 40 + wb.var(0) / 40) + 0.05
    assert np.mean(np.abs(wa.mean(0) - wb.mean(0)) > 4 * sdw) < 0.08
    r = np.median(yb.std(0) / np.maximum(ya.std(0), 1e-6))
    assert 0.6 < r < 1.6, r
    truth = y_full[np.sort(np.flatnonzero(held))]
    rm_a = np.sqrt(np.mean((ya.mean(0) - truth) ** 2))
    rm_b = np.sqrt(np.mean((yb.mean(0) - truth) ** 2))
    sd_y = y_full.std()
    assert rm_a < 0.6 * sd_y and rm_b < 0.6 * sd_y
    assert abs(rm_a - rm_b) < 0.25 * sd_y
    # subsampled and re-batched: the same draws whatever the chunk
    kw = dict(coords_new=coords[held], x_new=X[held], n_draws=9, seed=2,
              device="cpu")
    p1 = spamtree_tpu_torch.spamtree_predict(fit_b, y_full[obs], X[obs],
                                             coords[obs], chunk=4, **kw)
    p2 = spamtree_tpu_torch.spamtree_predict(fit_b, y_full[obs], X[obs],
                                             coords[obs], chunk=32, **kw)
    assert np.array_equal(p1["w_pred"], p2["w_pred"])
    assert np.array_equal(p1["draw_indices"], np.linspace(0, 299, 9).round())


def test_predict_new_input_validation(fits):
    coords, X, y_full, held, _, fit_b = fits
    obs = ~held
    args = (fit_b, y_full[obs], X[obs], coords[obs])
    kw = dict(coords_new=coords[held], x_new=X[held], device="cpu")
    for bad, match in ((dict(x_new=X[held][:, :1]), "x_new"),
                       (dict(coords_new=coords[held][:, :1]), "columns"),
                       (dict(mv_id_new=np.full(int(held.sum()), 7)),
                        "labels")):
        with pytest.raises(ValueError, match=match):
            spamtree_tpu_torch.spamtree_predict(*args, **(kw | bad))
    with pytest.raises(ValueError, match="SAME data"):
        spamtree_tpu_torch.spamtree_predict(fit_b, y_full, X, coords, **kw)
    summ = dict(fit_b, w_mcmc=np.zeros((0, int(obs.sum()))))
    with pytest.raises(ValueError, match="draw"):
        spamtree_tpu_torch.spamtree_predict(summ, *args[1:], **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            spamtree_tpu_torch.spamtree_predict(*args, **(kw | dict(
                device="cuda")))


def _tree_reused():
    return trace.history()[-1].counter("predict.tree_reused", None)


@pytest.mark.parametrize("which", ["heldout_in_fit", "all_observed"])
def test_fit_tree_extended_as_rebuilt(fits, which):
    """A fit that carries its tree predicts through that tree extended by
    the new rows (counter ``predict.tree_reused`` 1); the same fit without
    it through make_tree over the augmented rows (0): the same draws, bit
    for bit, with held-out rows in the fit or none."""
    coords, X, y_full, held, fit_a, fit_b = fits
    obs = ~held
    fit, args = ((fit_a, (np.where(held, np.nan, y_full), X, coords))
                 if which == "heldout_in_fit"
                 else (fit_b, (y_full[obs], X[obs], coords[obs])))
    rng = np.random.default_rng(4)
    kw = dict(coords_new=rng.uniform(size=(40, 2)),
              x_new=rng.normal(size=(40, 2)), n_draws=7, seed=5,
              device="cpu")
    kept = spamtree_tpu_torch.spamtree_predict(fit, *args, **kw)
    assert _tree_reused() == 1
    dropped = spamtree_tpu_torch.spamtree_predict(
        {k: v for k, v in fit.items() if k != "tree"}, *args, **kw)
    assert _tree_reused() == 0
    for k in ("w_pred", "yhat_pred", "draw_indices"):
        assert np.array_equal(kept[k], dropped[k]), k


def test_predict_new_other_coordinates_raise(fits):
    """Coordinates other than the fit's, in the same row order, leave the
    fit's tree aside, and the rebuilt partition's observed rows leave the
    fit's blocks: an error, as before the fit's tree was extended."""
    coords, X, y_full, held, _, fit_b = fits
    obs = ~held
    other = coords[obs].copy()
    other[:, 1] = 1.0 - other[:, 1]  # x alone sets the sort: same order
    with pytest.raises(RuntimeError, match="diverged"):
        spamtree_tpu_torch.spamtree_predict(
            fit_b, y_full[obs], X[obs], other, coords_new=coords[held],
            x_new=X[held], n_draws=2, device="cpu")


def test_augmented_mapping_matches_jax(fits, monkeypatch):
    """The fit's draws land on the same augmented rows, and the new rows
    are read back from the same positions, as in the JAX package: with
    predict_recompute replaced in both by (a) a weighted checksum of the
    whole w vector and (b) the row index, both functions return the same
    numbers."""
    coords, X, y_full, held, _, fit_b = fits
    obs = ~held
    fit_j = dict(fit_b, fit_config=dict(fit_b["fit_config"],
                                        dtype=np.float64))
    args = (y_full[obs], X[obs], coords[obs])
    kw = dict(coords_new=coords[held], x_new=X[held], n_draws=5, chunk=5)
    probes = dict(
        checksum=(lambda w: torch.full_like(w, float(torch.sum(
                      w * (torch.arange(w.shape[0]) + 1.0)))),
                  lambda w: jnp.full_like(w, jnp.sum(
                      w * (jnp.arange(w.shape[0]) + 1.0)))),
        rows=(lambda w: torch.arange(w.shape[0], dtype=w.dtype),
              lambda w: jnp.arange(w.shape[0], dtype=w.dtype)))
    for name, (pt, pj) in probes.items():
        monkeypatch.setattr(ct, "predict_recompute",
                            lambda ms, th, w, z, cc=None, f=pt: f(w))
        monkeypatch.setattr(cj, "predict_recompute",
                            lambda ms, th, w, k, cc=None, f=pj: f(w))
        got = spamtree_tpu_torch.spamtree_predict(fit_b, *args, device="cpu",
                                                  **kw)["w_pred"]
        want = spamtree_tpu.spamtree_predict(fit_j, *args, **kw)["w_pred"]
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=name)
    assert len(np.unique(got)) == int(held.sum())  # the rows probe


def test_fit_files_and_summaries_cross_packages(fits, tmp_path):
    """A port fit saved with the port's save_fit loads with the JAX
    load_fit (dtype node included) and summarizes with the JAX
    summarize_fit exactly as with the port's copy; loaded back by the port
    it predicts the same draws as the fit in memory."""
    coords, X, y_full, held, _, fit_b = fits
    p = str(tmp_path / "fit.npz")
    spamtree_tpu_torch.save_fit(p, fit_b)
    fj = fitio_jax.load_fit(p)
    assert fj["fit_config"]["dtype"] == np.dtype("float64")
    assert sorted(fj["skipped_on_save"]) == ["schedule", "tree"]
    for k in ("w_mcmc", "theta_mcmc", "beta_mcmc", "order", "coords"):
        assert np.array_equal(fj[k], fit_b[k]), k
    sj = summaries_jax.summarize_fit(fj)
    st = spamtree_tpu_torch.summarize_fit(spamtree_tpu_torch.load_fit(p))
    assert sj["n_draws"] == st["n_draws"] == 300

    def eq(a, b, what):
        if isinstance(a, dict):
            assert set(a) == set(b), what
            for k in a:
                eq(a[k], b[k], f"{what}.{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=what)

    eq(st, sj, "summary")
    obs = ~held
    kw = dict(coords_new=coords[held][:5], x_new=X[held][:5], n_draws=4,
              seed=1, device="cpu")
    a = spamtree_tpu_torch.spamtree_predict(
        spamtree_tpu_torch.load_fit(p), y_full[obs], X[obs], coords[obs], **kw)
    assert _tree_reused() == 0  # load_fit drops the tree: rebuilt
    b = spamtree_tpu_torch.spamtree_predict(fit_b, y_full[obs], X[obs],
                                            coords[obs], **kw)
    assert _tree_reused() == 1
    assert np.array_equal(a["w_pred"], b["w_pred"])


def test_public_names_match_jax_package():
    """The port exports the JAX package's public names."""
    assert spamtree_tpu_torch.__all__ == spamtree_tpu.__all__
    for name in spamtree_tpu_torch.__all__:
        assert callable(getattr(spamtree_tpu_torch, name)), name
