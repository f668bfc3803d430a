"""The port's slice as a whole: MCMC steps against the JAX package's given
the same state and draws, the public ``spamtree`` on the README
configuration, and the package's independence from jax."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import jax
import pytest
import jax.numpy as jnp
import torch

from spamtree_tpu.model import core as cj
from spamtree_tpu.model import mcmc as mj
from spamtree_tpu.model.params import make_theta_spec
from spamtree_tpu.tree.partition import make_tree as make_tree_jax
from spamtree_tpu.tree.schedule import build_schedule as build_schedule_jax
import spamtree_tpu_torch
from spamtree_tpu_torch.model import core as ct
from spamtree_tpu_torch.model import mcmc as mt
from spamtree_tpu_torch.tree.partition import make_tree
from spamtree_tpu_torch.tree.schedule import build_schedule
from spamtree_tpu_torch.utils.convert import (
    model_state_from_numpy,
    model_state_to_numpy,
)
from test_e2e import _sim_univariate

REPO = pathlib.Path(__file__).resolve().parents[1]


# small eager models: one intra-op thread runs them as fast, and keeps the
# test workers from oversubscribing the cores
@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_tree(got, ref, what, rtol):
    if isinstance(ref, dict):
        for k in ref:
            _close_tree(got[k], ref[k], f"{what}.{k}", rtol)
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), what
        for i, (a, b) in enumerate(zip(got, ref)):
            _close_tree(a, b, f"{what}[{i}]", rtol)
    elif ref is None:
        assert got is None, what
    else:
        ref = np.asarray(ref, dtype=np.float64)
        atol = rtol * max(float(np.abs(ref).max()), 1.0) if ref.size else 0.0
        np.testing.assert_allclose(np.asarray(got, dtype=np.float64), ref,
                                   rtol=rtol, atol=atol, err_msg=what)


# debug= / settings= switches of make_step, each off in turn
STEP_FLAGS = [dict(), dict(adapting=False), dict(sample_theta=False),
              dict(sample_w=False), dict(sample_beta=False),
              dict(sample_tausq=False)]


@pytest.mark.parametrize("flags", STEP_FLAGS, ids=[
    "defaults", "adapting_off", "sample_theta_off", "sample_w_off",
    "sample_beta_off", "sample_tausq_off"])
def test_steps_match_jax_across_accept_and_reject(flags):
    """JAX init_state (from a given beta and w) -> convert -> five port
    steps, with each step's draws taken from the JAX key exactly as the
    JAX step splits it, against five JAX steps, with one sampler (or RAM
    adaptation) switched off in both; the port's own init_state from the
    same start equals the JAX package's.  rtol 1e-8 (atol 1e-8 x max|x|) in
    float64: per-step differences are summation-order rounding (~1e-12),
    compounded over five steps of Gibbs + Metropolis."""
    rng = np.random.default_rng(12)
    n = 320
    coords = np.repeat(rng.uniform(size=(n // 2, 2)), 2, axis=0)
    mv = np.tile(np.arange(2), n // 2)
    order = np.lexsort((np.arange(n), coords[:, 1], coords[:, 0]))
    coords, mv = coords[order], mv[order]
    na = rng.uniform(size=n) > 0.15
    X = np.column_stack([np.ones(n), rng.normal(size=n)])
    y = X @ np.array([0.5, -1.0]) + np.sin(4 * coords[:, 0]) * (1 + mv) \
        + 0.3 * rng.normal(size=n)
    y[~na] = np.nan
    kw = dict(axis_cell_size=3, K=2)
    tspec = make_theta_spec(2, 2, start_theta=np.array(
        [1.0, 0.8, 0.3, 0.3, 4.0, 4.0, 4.0, 1.0]))
    ms_j = cj.ModelStatic(
        build_schedule_jax(make_tree_jax(coords, na, mv,
                                         rng=np.random.default_rng(0), **kw)),
        coords, mv, y, X, tspec.spec, dtype=jnp.float64)
    ms_t = ct.ModelStatic(
        build_schedule(make_tree(coords, na, mv,
                                 rng=np.random.default_rng(0), **kw)),
        coords, mv, y, X, tspec.spec, dtype=torch.float64, device="cpu")

    # per-dimension proposal: ai1[1]'s support is (-1e3, 1e3), so its
    # logit-scale step must be far smaller for proposals to be accepted
    sd = np.diag([3e-4, 3e-9] + [3e-4] * 6)
    cfg_j = mj.MCMCConfig(mcmcsd=sd, **flags)
    cfg_t = mt.MCMCConfig(mcmcsd=sd, **flags)
    start = dict(start_beta=np.array([0.4, -0.8]), start_tausq=0.2,
                 start_w=0.3 * rng.normal(size=n))
    st_j = mj.init_state(ms_j, tspec.bounds, tspec.start, cfg=cfg_j, seed=0,
                         **start)
    _close_tree(model_state_to_numpy(mt.init_state(
        ms_t, tspec.bounds, tspec.start, cfg=cfg_t, **start)),
        model_state_to_numpy(st_j), "init_state", rtol=1e-9)
    st_t = model_state_from_numpy(ms_t, model_state_to_numpy(st_j))
    step_j = jax.jit(mj.make_step(ms_j, tspec.bounds, cfg_j),
                     static_argnums=2)
    step_t = mt.make_step(ms_t, tspec.bounds, cfg_t,
                          coords_cache=ct.level_coords(ms_t))
    shape = ct.tausq_shape(ms_t, cfg_t.tausq_ab).numpy()
    accepted = []
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
        before = st_t.ram.accept_count
        st_j = step_j(st_j, key, True)
        st_t = step_t(st_t, draws, True)
        accepted.append(st_t.ram.accept_count > before)
        _close_tree(model_state_to_numpy(st_t), model_state_to_numpy(st_j),
                    f"step {i}", rtol=1e-8)
        assert st_t.w[ms_t.n] == 0.0
    if flags.get("sample_theta", True):
        assert True in accepted and False in accepted, accepted
    else:
        assert st_t.ram.propos_count == 0
        assert torch.equal(st_t.theta, torch.as_tensor(tspec.start))


def test_spamtree_readme_config_recovers():
    """spamtree(device="cpu") on the README configuration passes the
    thresholds of test_e2e.py::test_readme_config_recovers."""
    coords, X, y, y_full, w, miss, B = _sim_univariate()
    ybar = np.nanmean(y)
    out = spamtree_tpu_torch.spamtree(
        y - ybar, X, coords, cell_size=25,
        mcmc=dict(keep=150, burn=150, thin=1), dtype=torch.float64, seed=1,
        device="cpu")
    order = out["order"]
    beta_hat = out["beta_mcmc"][:, :, 0].mean(axis=1)
    assert np.abs(beta_hat - B).max() < 0.35, beta_hat
    y_post = out["yhat_mcmc"].mean(axis=0) + ybar
    mo = miss[order]
    rmspe = np.sqrt(np.mean((y_post[mo] - y_full[order][mo]) ** 2))
    assert rmspe < 0.75 * np.nanstd(y_full), rmspe
    cc = np.corrcoef(out["w_mcmc"].mean(axis=0), w[order])[0, 1]
    assert cc > 0.85, cc
    assert 0.01 < out["tausq_mcmc"].mean() < 1.0
    assert out["burn_actual"] >= 150 and out["w_mcmc"].shape == (150, len(y))


def test_package_imports_no_jax():
    """No module of spamtree_tpu_torch (nor chip_smoke.py) imports jax or
    the JAX package, by source scan and in a fresh interpreter."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|spamtree_tpu)(\.|\s|$)", re.M)
    files = sorted((REPO / "spamtree_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f
    mods = [str(f.relative_to(REPO).with_suffix("")).replace("/", ".")
            for f in files if f.parent.name != "" and f.name != "chip_smoke.py"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'spamtree_tpu' or m.startswith('spamtree_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
