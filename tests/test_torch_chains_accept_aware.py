"""The accept-aware theta step under a chain axis in the port
(``run_mcmc_chains`` with ``MCMCConfig(accept_aware=True)``), on the CPU in
float64, one intra-op thread.

* The batched decision-only sweep gives each chain its single-chain
  ``sweep(decision_only=True)`` (rtol 1e-12: the same algebra with a chain
  axis; only batched sums may round in another order), over
  tests/test_torch_core.py's models, the limited tree and the aligned
  layout (whose reference level hands its grouped thin child factor parts),
  with composed parts and the level-kernel gate on and off (the plain K4
  on the CPU, one fold for all chains); the rebuild sweep likewise.
* It equals ``jax.vmap`` over the JAX package's decision sweep (Pallas in
  interpret mode with the gate on) at rtol 1e-10, and five batched
  accept-aware steps equal five vmapped JAX accept-aware steps given the
  same draws (rtol 1e-8, as tests/test_torch_accept_aware.py).
* K4 runs once per thin level per iteration at every chain count, and K1
  as often per iteration as an accepted single-chain accept-aware step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spamtree_tpu.model import core as cj
from spamtree_tpu.model import mcmc as mj
from spamtree_tpu.model.params import make_theta_spec
from spamtree_tpu.tree.partition import make_tree as make_tree_jax
from spamtree_tpu.tree.schedule import build_schedule as build_schedule_jax
from spamtree_tpu_torch.model import core as ct
from spamtree_tpu_torch.model import mcmc as mt
from spamtree_tpu_torch.ops import level, linalg
from spamtree_tpu_torch.tree.partition import make_tree
from spamtree_tpu_torch.tree.schedule import build_schedule
from spamtree_tpu_torch.utils.convert import (
    model_state_from_numpy,
    model_state_to_numpy,
)
from test_torch_accept_aware import _models as _aa_models
from test_torch_chains import _per_chain, _port_model, _prepared
from test_torch_core import CASES, _close, _models, _theta

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model(case):
    """(port model, theta kind) of a case, built once per worker."""
    if case in ("limited", "aligned"):
        return _port_model(case)[0], "univariate"
    return _models(case)[1], case


def _gates(monkeypatch, composed, kernels):
    monkeypatch.setenv("SPAMTREE_COMPOSED_FACTORS", "1" if composed else "0")
    monkeypatch.setenv("SPAMTREE_LEVEL_KERNELS", "1" if kernels else "0")


def _spy_k4(monkeypatch):
    """Record the batch of every plain-K4 call (one per K4 launch on the
    card: the CPU runs the plain version of the same fold)."""
    calls = []
    real = level.thin_decision_partials_plain
    monkeypatch.setattr(level, "thin_decision_partials_plain",
                        lambda K, *a, **k: calls.append(K.shape[0])
                        or real(K, *a, **k))
    return calls


@pytest.mark.parametrize("kernels", [False, True], ids=["torch", "k4"])
@pytest.mark.parametrize("composed", [False, True],
                         ids=["joint", "composed"])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("case", CASES + ["limited", "aligned"])
def test_batched_decision_sweep_is_per_chain(monkeypatch, case, C, composed,
                                             kernels):
    """Each chain of the batched decision-only sweep (logdet, ok, q_new,
    q_cur) is its single-chain decision sweep at rtol 1e-12, the current
    factors being each chain's own; K4 (its plain version) takes one fold
    of all chains per thin level, as often as one chain's sweep calls it;
    and the factor-emitting rebuild (leveldata, the raw prediction joint,
    logdet, ok) is per chain too."""
    ms, kind = _model(case)
    _gates(monkeypatch, composed, kernels)
    calls = _spy_k4(monkeypatch)
    rng = np.random.default_rng(C + 10 * composed + 100 * kernels)
    t = lambda a: torch.as_tensor(np.asarray(a))
    th0 = t(np.stack([_theta(kind, ms.q, rng) for _ in range(C)]))
    th1 = t(np.stack([_theta(kind, ms.q, rng) for _ in range(C)]))
    w = rng.normal(size=(C, ms.n + 1))
    w[:, -1] = 0.0
    w = t(w)
    prev = [ct.sweep(ms, th0[c], w[c])[0] for c in range(C)]
    calls.clear()
    singles = [ct.sweep(ms, th1[c], w[c], quad_prev=prev[c],
                        decision_only=True) for c in range(C)]
    want = list(calls)
    assert all(bool(s[1]) for s in singles)
    prev_b = tuple(ct.LevelData(*(torch.stack(x) for x in zip(*lv)))
                   for lv in zip(*prev))
    calls.clear()
    got = ct.sweep(ms, th1, w, quad_prev=prev_b, decision_only=True)
    assert all(g.shape == (C,) for g in got)
    _per_chain(tuple(got), [tuple(s) for s in singles], case, rtol=1e-12)
    assert calls == [C * b for b in want[:len(want) // C]], (calls, want)
    # K4 serves every unchunked thin level whose parent hands it a joint:
    # not the chunked case's, nor the aligned case's with composed parts
    assert bool(calls) == (kernels and case != "bivariate_chunked"
                           and not (composed and case == "aligned")), calls
    if composed and not kernels:
        # the rebuild is a full sweep, which no gate touches
        rebuild = lambda *a: ct.sweep(ms, *a, emit_pred_joint=True)
        _per_chain(rebuild(th1, w),
                   [rebuild(th1[c], w[c]) for c in range(C)], case,
                   rtol=1e-12)


def test_parts_with_a_chain_axis():
    """_apply_parts_thin with a leading chain axis is chain by chain its
    single-chain result, grouped parents (gc_p > 1) and the root parent
    (no LAi) included."""
    rng = np.random.default_rng(2)
    C, B, Pp, Sp, S = 3, 8, 7, 5, 6
    r = lambda *s: torch.as_tensor(rng.normal(size=s))
    for gc_p, root in ((1, False), (4, False), (1, True)):
        P = Sp + (0 if root else Pp)
        LAi = None if root else r(C, B // gc_p, Pp, Pp)
        H, Rinv = r(C, B, Sp, Pp), r(C, B, Sp, Sp)
        Kxc, wpar = r(C, B, P, S), r(C, B, P)
        got = ct._apply_parts_thin((LAi, H, Rinv, gc_p), Kxc, wpar)
        for c in range(C):
            one = ct._apply_parts_thin(
                (None if root else LAi[c], H[c], Rinv[c], gc_p), Kxc[c],
                wpar[c])
            for a, b in zip(got, one):
                _close(a[c], b, f"gc_p={gc_p} root={root}", rtol=1e-12)


# -- against the JAX package ------------------------------------------------


def _composed_models():
    """tests/test_composed_sweep.py's model (n = 800, q = 2, parent
    alignment forced at test scale) in both packages: a reference level
    composes its aligned thin child."""
    rng = np.random.default_rng(11)
    base = rng.uniform(size=(400, 2))
    coords = np.repeat(base, 2, axis=0)
    mv = np.tile(np.arange(2), 400)
    n = len(coords)
    order = np.lexsort((np.arange(n), coords[:, 1], coords[:, 0]))
    coords, mv = coords[order], mv[order]
    na = rng.uniform(size=n) > 0.1
    y = rng.normal(size=n)
    y[~na] = np.nan
    X = rng.normal(size=(n, 2))
    tspec = make_theta_spec(2, 2)
    kw = dict(axis_cell_size=4, K=2)
    state = rng.bit_generator.state
    ms_j = cj.ModelStatic(
        build_schedule_jax(make_tree_jax(coords, na, mv, rng=rng, **kw),
                           align_min_p=1),
        coords, mv, y, X, tspec.spec, dtype=jnp.float64)
    rng.bit_generator.state = state
    ms_t = ct.ModelStatic(
        build_schedule(make_tree(coords, na, mv, rng=rng, **kw),
                       align_min_p=1),
        coords, mv, y, X, tspec.spec, dtype=F64, device="cpu")
    assert any(ms_t.level_is_ref[t] and ct._compose_children(ms_t, t)
               for t in range(len(ms_t.levels)))
    return ms_j, ms_t, tspec, rng


@pytest.mark.parametrize("composed", [False, True], ids=["joint", "composed"])
def test_batched_decision_sweep_matches_jax_vmap(monkeypatch, composed):
    """Two chains: the port's batched decision sweep equals jax.vmap over
    the JAX package's sweep(decision_only=True) on the same inputs, with
    the level kernels on (the JAX side's Pallas K4 in interpret mode, the
    port's plain K4 on the fold) and composed parts on or off."""
    _gates(monkeypatch, composed, True)
    ms_j, ms_t, tspec, rng = _composed_models()
    C = 2
    start = np.asarray(tspec.start)
    th0 = np.stack([start * rng.uniform(0.95, 1.05, start.shape)
                    for _ in range(C)])
    th1 = th0 * rng.uniform(0.97, 1.03, th0.shape)
    w = np.concatenate([0.4 * rng.normal(size=(C, ms_t.n)),
                        np.zeros((C, 1))], axis=1)

    def run(th0, th1, w):
        ld0 = cj.sweep(ms_j, th0, w)[0]
        return ld0, cj.sweep(ms_j, th1, w, quad_prev=ld0, decision_only=True)

    ld0, ref = jax.jit(jax.vmap(run))(*(jnp.asarray(a) for a in
                                        (th0, th1, w)))
    T = lambda a: torch.as_tensor(np.asarray(a))
    prev = tuple(ct.LevelData(T(d.H), T(d.prec)) for d in ld0)
    calls = _spy_k4(monkeypatch)
    got = ct.sweep(ms_t, T(th1), T(w), quad_prev=prev, decision_only=True)
    assert np.asarray(ref[1]).all() and got[1].all()
    for i in (0, 2, 3):
        _close(got[i], ref[i], f"output {i}", rtol=1e-10)
    assert len(calls) == (0 if composed else 1) and (
        composed or calls[0] == C * ms_t.levels[-1].rows.shape[0]), calls


def _stack_draws(keys, ms, n_theta, shape):
    """Each chain's draws from its key, split as the JAX step splits it."""
    per = []
    for key in keys:
        kw_, kt, ku, kp, kq, kb = jax.random.split(key, 6)
        f64 = jnp.float64
        per.append((jax.random.normal(kw_, (ms.n + 1,), dtype=f64),
                    jax.random.normal(kt, (n_theta,), dtype=f64),
                    jax.random.uniform(ku, dtype=f64),
                    jax.random.normal(kp, (ms.n + 1,), dtype=f64),
                    jax.random.gamma(kq, jnp.asarray(shape), dtype=f64),
                    jax.random.normal(kb, (ms.p, ms.q), dtype=f64)))
    return mt.StepDraws(*(torch.as_tensor(np.stack([np.asarray(a) for a in f]))
                          for f in zip(*per)))


def test_accept_aware_chain_steps_match_jax(monkeypatch):
    """C = 2: five batched accept-aware steps of the port against five
    steps of jax.vmap over the JAX package's make_step(accept_aware=True)
    from the same start (chains carry no Gram blocks in either), each
    chain's draws taken from its JAX key as the JAX step splits it; the
    level kernels on (plain K4 here, Pallas K4 in interpret mode there).
    Accepted and rejected proposals both occur."""
    monkeypatch.setenv("SPAMTREE_LEVEL_KERNELS", "1")
    ms_j, ms_t, tspec = _aa_models(False)
    C = 2
    sd = 0.02 * np.eye(tspec.n_theta)
    cfg_j = mj.MCMCConfig(mcmcsd=sd, accept_aware=True)
    cfg_t = mt.MCMCConfig(mcmcsd=sd, accept_aware=True)
    st_j = mj.init_state(ms_j, tspec.bounds, tspec.start, cfg=cfg_j, seed=0)
    st_t = mt.stack_chain_states(
        model_state_from_numpy(ms_t, model_state_to_numpy(st_j)),
        np.arange(C))[0]
    st_j = mj.stack_chain_states(st_j, np.arange(C))
    step_j = jax.jit(jax.vmap(mj.make_step(ms_j, tspec.bounds, cfg_j),
                              in_axes=(0, 0, None)), static_argnums=2)
    step_t = mt.make_step(ms_t, tspec.bounds, cfg_t,
                          coords_cache=ct.level_coords(ms_t), chains=True)
    shape = ct.tausq_shape(ms_t, cfg_t.tausq_ab).numpy()
    installed = []
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(5), 5)):
        keys = jax.random.split(key, C)
        before = st_t.theta
        st_j = step_j(st_j, keys, True)
        st_t = step_t(st_t, _stack_draws(keys, ms_t, tspec.n_theta, shape),
                      True)
        installed += (st_t.theta != before).any(-1).tolist()
        for f in ("w", "theta", "logdetCi", "beta", "tausq_inv", "XB"):
            _close(getattr(st_t, f), getattr(st_j, f), f"step {i} {f}",
                   rtol=1e-8)
        _close(st_t.ram.accept_count, st_j.ram.accept_count, "accepts",
               rtol=0)
        _close(st_t.ram.paramsd, st_j.ram.paramsd, f"step {i} paramsd",
               rtol=1e-8)
        for name in ("leveldata", "pred_data"):
            for t_, (a, b) in enumerate(zip(getattr(st_t, name),
                                            getattr(st_j, name))):
                _close(a.H, b.H, f"step {i} {name}[{t_}].H", rtol=1e-8)
                _close(a.prec, b.prec, f"step {i} {name}[{t_}].prec",
                       rtol=1e-8)
    assert True in installed and False in installed, installed


# -- launches --------------------------------------------------------------


def test_k4_once_per_thin_level_for_all_chains(monkeypatch):
    """With the level kernels on and no composed parts, an accept-aware
    batched step calls K4 once per thin level at C = 1 and C = 3 (one fold
    of all chains), as an accepted single-chain accept-aware step does;
    K1 is called as often, each on the (C*B, S, S) fold."""
    _gates(monkeypatch, False, True)
    k4 = _spy_k4(monkeypatch)
    k1 = []
    real = linalg.inv_chol
    monkeypatch.setattr(linalg, "inv_chol",
                        lambda a, *k: k1.append(a.shape[0]) or real(a, *k))
    fit = _prepared(1)
    ms = fit.ms
    cc = ct.level_coords(ms)
    nt = fit.state.theta.shape[0]
    shape = ct.tausq_shape(ms, fit.cfg.tausq_ab)
    cfg = fit.cfg._replace(accept_aware=True)
    single = mt.make_step(ms, fit.bounds, cfg, coords_cache=cc)
    d = mt.draw_step(ms, torch.Generator().manual_seed(0), nt, shape)
    k1.clear(), k4.clear()
    st = single(fit.state, d._replace(u=torch.zeros((), dtype=F64)), True)
    assert st.ram.accept_count == 1.0, "the single step must accept"
    want1, want4 = list(k1), list(k4)
    n_thin = sum(1 for t in range(len(ms.levels)) if not ms.level_is_ref[t]
                 and ms.levels[t].prows.shape[1] > 0)
    assert n_thin and len(want4) == n_thin, (want4, n_thin)
    batched = mt.make_step(ms, fit.bounds, cfg, coords_cache=cc, chains=True)
    for C in (1, 3):
        states, gens = mt.stack_chain_states(fit.state, np.arange(C))
        k1.clear(), k4.clear()
        batched(states, mt.draw_chains(ms, gens, nt, shape), True)
        assert k4 == [C * b for b in want4], (C, k4, want4)
        assert k1 == [C * b for b in want1], (C, k1, want1)
