"""The port's accept-aware theta step (``MCMCConfig(accept_aware=True)``):
the decision-only sweep against the full sweep, five steps with the fused
thin-level kernels on against five JAX accept-aware steps given the same
draws, and 30 accept-aware steps against 30 always-emit steps of the port.

Tolerances, float64: the decision sweep's H-free forms are algebraic
identities of the full sweep's (rtol 1e-10, as tests/test_accept_aware.py);
five whole steps against JAX compound summation-order rounding over Gibbs +
Metropolis (rtol 1e-8, as tests/test_torch_mcmc.py); the two port steps
differ only in where the same factors are summed (rtol 1e-9)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spamtree_tpu.model import core as cj
from spamtree_tpu.model import mcmc as mj
from spamtree_tpu.model.params import make_theta_spec
from spamtree_tpu.tree.partition import make_tree as make_tree_jax
from spamtree_tpu.tree.schedule import build_schedule as build_schedule_jax
from spamtree_tpu_torch.model import core as ct
from spamtree_tpu_torch.model import mcmc as mt
from spamtree_tpu_torch.ops import level
from spamtree_tpu_torch.tree.partition import make_tree
from spamtree_tpu_torch.tree.schedule import build_schedule
from spamtree_tpu_torch.utils.convert import (
    model_state_from_numpy,
    model_state_to_numpy,
)
from test_torch_mcmc import _close_tree


# small eager models: one intra-op thread runs them as fast, and keeps the
# test workers from oversubscribing the cores
@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(q=2, n_per_q=300, seed=0):
    """tests/test_accept_aware.py's dataset (n = 600, 12% missing)."""
    rng = np.random.default_rng(seed)
    n = q * n_per_q
    coords = rng.uniform(size=(n, 2))
    mv = np.repeat(np.arange(q), n_per_q)
    order = np.lexsort((np.arange(n), coords[:, 1], coords[:, 0]))
    coords, mv = coords[order], mv[order]
    y = rng.normal(size=n)
    y[rng.random(n) < 0.12] = np.nan
    X = rng.normal(size=(n, 2))
    return coords, mv, y, X


def _models(limited, jax_too=True):
    coords, mv, y, X = _data()
    kw = dict(axis_cell_size=4, K=2, limited_tree=limited)
    tspec = make_theta_spec(2, 2)
    ms_t = ct.ModelStatic(
        build_schedule(make_tree(coords, np.isfinite(y), mv,
                                 rng=np.random.default_rng(0), **kw),
                       limited_tree=limited),
        coords, mv, y, X, tspec.spec, dtype=torch.float64, device="cpu")
    ms_j = cj.ModelStatic(
        build_schedule_jax(make_tree_jax(coords, np.isfinite(y), mv,
                                         rng=np.random.default_rng(0), **kw),
                           limited_tree=limited),
        coords, mv, y, X, tspec.spec, dtype=jnp.float64) if jax_too else None
    return ms_j, ms_t, tspec


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("limited", [False, True], ids=["full", "limited"])
def test_decision_sweep_matches_full(limited):
    """decision_only returns the full sweep's (logdet, ok, q_new, q_cur) at
    a nonzero w (mirrors tests/test_accept_aware.py)."""
    _, ms, tspec = _models(limited, jax_too=False)
    st = mt.init_state(ms, tspec.bounds, tspec.start)
    w = torch.as_tensor(np.random.default_rng(3).normal(size=ms.n + 1))
    w[ms.n] = 0.0
    th2 = st.theta * 1.05
    full = ct.sweep(ms, th2, w, quad_prev=st.leveldata)
    dec = ct.sweep(ms, th2, w, quad_prev=st.leveldata, decision_only=True)
    assert bool(full[3]) and bool(dec[1])
    for i, j in ((0, 2), (2, 4), (3, 5)):
        np.testing.assert_allclose(float(dec[i]), float(full[j]), rtol=1e-10)
    assert float(dec[2]) != 0.0 and float(dec[3]) != 0.0


def _spy_level(monkeypatch):
    """Count the ops.level wrappers' calls made through the model core."""
    calls = {"thin_gibbs_level": 0, "thin_decision_level": 0}
    for name in calls:
        fn = getattr(level, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(level, name, spy)
    return calls


@pytest.mark.parametrize("limited", [False, True], ids=["full", "limited"])
def test_accept_aware_steps_match_jax(monkeypatch, limited):
    """JAX init_state -> convert -> five port accept-aware steps with the
    level kernels on (their plain versions here, the Pallas kernels in
    interpret mode on the JAX side), each step's draws taken from the JAX
    key as the JAX step splits it, against five JAX accept-aware steps; the
    steps cross an accept and a reject."""
    monkeypatch.setenv("SPAMTREE_LEVEL_KERNELS", "1")
    ms_j, ms_t, tspec = _models(limited)
    sd = 0.02 * np.eye(tspec.n_theta)
    cfg_j = mj.MCMCConfig(mcmcsd=sd, accept_aware=True)
    cfg_t = mt.MCMCConfig(mcmcsd=sd, accept_aware=True)
    st_j = mj.init_state(ms_j, tspec.bounds, tspec.start, cfg=cfg_j, seed=0)
    st_t = model_state_from_numpy(ms_t, model_state_to_numpy(st_j))
    step_j = jax.jit(mj.make_step(ms_j, tspec.bounds, cfg_j),
                     static_argnums=2)
    step_t = mt.make_step(ms_t, tspec.bounds, cfg_t,
                          coords_cache=ct.level_coords(ms_t))
    calls = _spy_level(monkeypatch)
    shape = ct.tausq_shape(ms_t, cfg_t.tausq_ab).numpy()
    accepted = []
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(5), 5)):
        kw_, kt, ku, kp, kq, kb = jax.random.split(key, 6)
        f64 = jnp.float64
        draws = mt.StepDraws(*(_t(a) for a in (
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
    assert True in accepted and False in accepted, accepted
    # both fused thin-level paths ran: K3 in every w-Gibbs, K4 in every
    # decision sweep (the thin level's parent is an assembled joint here)
    assert calls == {"thin_gibbs_level": 5, "thin_decision_level": 5}, calls


@pytest.mark.parametrize("limited", [False, True], ids=["full", "limited"])
def test_accept_aware_chain_matches_always_emit(limited):
    """30 port transitions from one generator seed: the accept-aware step
    and the always-emit step give the same chain and the same acceptance
    count, with both accepted and rejected proposals along the way."""
    _, ms, tspec = _models(limited, jax_too=False)
    cfg = mt.MCMCConfig()
    st0 = mt.init_state(ms, tspec.bounds, tspec.start, cfg=cfg)
    shape = ct.tausq_shape(ms, cfg.tausq_ab)
    cc = ct.level_coords(ms)
    outs = {}
    for aa in (True, False):
        step = mt.make_step(ms, tspec.bounds, cfg._replace(accept_aware=aa),
                            coords_cache=cc)
        gen = torch.Generator().manual_seed(7)
        s = st0
        for _ in range(30):
            s = step(s, mt.draw_step(ms, gen, tspec.n_theta, shape), True)
        outs[aa] = s
    a, b = outs[True], outs[False]
    acc = a.ram.accept_count
    assert 0 < acc < 30, acc
    assert b.ram.accept_count == acc
    _close_tree(model_state_to_numpy(a), model_state_to_numpy(b), "chain",
                rtol=1e-9)
