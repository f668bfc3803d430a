"""The capture-ready iteration of the port (``mcmc.StepRunner``), on the CPU.

CUDA graphs run only on the card, so these tests hold what a graph
captures: the step restructured into parts that read and write static
buffers, with a device table for the RAM step size and the draws filled
outside.

* Run through ``run_mcmc``/``run_mcmc_chains(graphs=True)`` -- on the CPU
  the parts are plain calls -- it gives the eager step's chain
  (``graphs=False``) bit for bit over 20 iterations, f64 and f32: one
  chain on both theta steps, the level kernels' plain versions on, the
  limited tree, no carried prediction operators, summary collection,
  two batched chains on both steps, and the reference warmup across its
  switch-on at iteration 50.
* The same with the capture emulated (``_EmulatedGraph``): the warm-up
  iteration, a dry run of every other part, a capture that leaves the
  state as it was, then replays whose outputs land in the captured
  tensors -- and every capture runs under a guard that raises on any read
  of a device value by the host or any host-to-device copy.
* Five steps of the runner equal five of the JAX package's steps given
  the same draws, at rtol 1e-10 in f64.
* A replay adds to the kernels' launch counters what an eager call adds
  (a stub graph); a failed capture raises naming its part; a mesh is
  refused.
"""

import contextlib

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
from spamtree_tpu_torch.api import prepare_fit
from spamtree_tpu_torch.model import core as ct
from spamtree_tpu_torch.model import mcmc as mt
from spamtree_tpu_torch.model.ram import G0
from spamtree_tpu_torch.ops import chol, level
from spamtree_tpu_torch.tree.partition import make_tree
from spamtree_tpu_torch.tree.schedule import build_schedule
from spamtree_tpu_torch.utils.convert import (
    model_state_from_numpy,
    model_state_to_numpy,
)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=300, q=2, seed=11):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2))
    X = rng.normal(size=(n, 2))
    w = np.sin(coords @ np.array([6.0, 4.0]))
    y = X @ np.array([1.0, -0.5]) + w + 0.1 * rng.normal(size=n)
    y[rng.uniform(size=n) < 0.1] = np.nan
    mv = rng.integers(0, q, size=n) + 1
    return y, X, coords, mv


# (keep, burn, thin): 20 iterations; the warmup case runs past G0
DEPTH = dict(keep=8, burn=4, thin=2)
CASES = {
    "always_emit": {},
    "accept_aware": dict(accept_aware=True),
    "level_kernels": dict(env=dict(SPAMTREE_LEVEL_KERNELS="1")),
    "level_kernels_accept_aware": dict(
        accept_aware=True, env=dict(SPAMTREE_LEVEL_KERNELS="1",
                                    SPAMTREE_COMPOSED_FACTORS="0")),
    "limited_tree": dict(limited=True, accept_aware=True),
    "no_carried_operators": dict(no_carry=True),
    "summary": dict(collect="summary"),
    "chains2": dict(chains=2),
    "chains2_accept_aware": dict(chains=2, accept_aware=True),
    "reference_warmup": dict(warmup=True, depth=dict(keep=4, burn=48,
                                                     thin=2)),
}


def _fit(case, dtype):
    c = CASES[case]
    y, X, coords, mv = _data()
    depth = c.get("depth", DEPTH)
    fit = prepare_fit(y, X, coords, mv_id=mv, cell_size=16, K=2, seed=7,
                      device="cpu", dtype=dtype, mcmc=depth,
                      limited_tree=c.get("limited", False),
                      settings=dict(chunk=4, wire_dtype="none",
                                    collect=c.get("collect", "all"),
                                    ram_reference_warmup=c.get("warmup",
                                                               False)))
    cfg = fit.cfg._replace(accept_aware=c.get("accept_aware", False))
    state = fit.state
    if c.get("no_carry"):
        fit.ms.pred_in_carry = False
        state = state._replace(pred_data=None)
    return fit, cfg, state


def _run(fit, cfg, state, case, graphs):
    """One run of ``case``: run_mcmc, or run_mcmc_chains at its C."""
    C = CASES[case].get("chains", 0)
    if C:
        states, gens = mt.stack_chain_states(state, 5 + np.arange(C))
        return mt.run_mcmc_chains(fit.ms, fit.bounds, cfg, states, gens,
                                  yhat_seed=3, graphs=graphs)
    gen = torch.Generator().manual_seed(5)
    return mt.run_mcmc(fit.ms, fit.bounds, cfg, state, gen, yhat_seed=3,
                       graphs=graphs)


def _leaves(x):
    """Every tensor of a (nested) state, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for y in x for t in _leaves(y)]
    return []


def _same_bits(a, b, case):
    keys = [k for k in ("w", "yhat", "beta", "tausq", "theta", "w_mean",
                        "w_var", "yhat_mean", "yhat_var") if k in a]
    for k in keys:
        assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), \
            f"{case}: {k} differs"
    assert a["accept_ratio"] == b["accept_ratio"], case
    sa, sb = a["state"], b["state"]
    assert sa.it == sb.it and sa.ram.started == sb.ram.started, case
    la, lb = _leaves(sa), _leaves(sb)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"{case}: state leaf {i} differs"
    assert float(torch.as_tensor(sa.ram.propos_count).sum()) == \
        float(torch.as_tensor(sb.ram.propos_count).sum())


@contextlib.contextmanager
def _env(kv):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in kv.items():
            mp.setenv(k, v)
        yield


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_capture_ready_step_equals_eager(case, dtype):
    """graphs=True (the parts as plain calls on the CPU) against the eager
    step: every draw, the acceptance and the final state, bit for bit;
    the chain both accepts and rejects."""
    with _env(CASES[case].get("env", {})):
        fit, cfg, state = _fit(case, dtype)
        eager = _run(fit, cfg, state, case, False)
        ready = _run(fit, cfg, state, case, True)
    _same_bits(eager, ready, case)
    acc = np.asarray(eager.get("accept_by_chain", eager["accept_ratio"]))
    assert (acc > 0).all() and (acc < 1).all(), (case, acc)
    assert ready["compile_time_s"] == 0.0 and ready["graph_replays"] == 0
    if case == "reference_warmup":
        assert eager["state"].it > G0 + 1 and eager["state"].ram.started


# -- the capture, emulated on the CPU ---------------------------------------


@contextlib.contextmanager
def _host_read_guard():
    """Raise on what a CUDA graph cannot capture: a read of a device value
    by the host (item, bool, cpu, numpy, tolist, float, int, index) and a
    host-to-device copy (as_tensor or tensor of host data, an index given
    as a Python list, a Python number assigned into a tensor)."""

    def boom(what):
        def f(*a, **k):
            raise AssertionError(f"{what} inside a captured part")
        return f

    as_tensor, getitem, setitem = (torch.as_tensor, torch.Tensor.__getitem__,
                                   torch.Tensor.__setitem__)

    def guarded_as_tensor(data, *a, **k):
        if not isinstance(data, torch.Tensor):
            raise AssertionError("torch.as_tensor of host data inside a "
                                 "captured part")
        return as_tensor(data, *a, **k)

    def no_lists(idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        if any(isinstance(i, list) for i in idx):
            raise AssertionError("an index list inside a captured part")

    def guarded_getitem(self, idx):
        no_lists(idx)
        return getitem(self, idx)

    def guarded_setitem(self, idx, v):
        no_lists(idx)
        if not isinstance(v, torch.Tensor):
            raise AssertionError("a host value assigned into a tensor inside "
                                 "a captured part")
        return setitem(self, idx, v)

    with pytest.MonkeyPatch.context() as mp:
        for name in ("item", "__bool__", "cpu", "numpy", "tolist",
                     "__float__", "__int__", "__index__"):
            mp.setattr(torch.Tensor, name, boom(f"Tensor.{name}"))
        mp.setattr(torch.Tensor, "__getitem__", guarded_getitem)
        mp.setattr(torch.Tensor, "__setitem__", guarded_setitem)
        mp.setattr(torch, "as_tensor", guarded_as_tensor)
        mp.setattr(torch, "tensor", boom("torch.tensor"))
        yield


def _copy_out(dst, src):
    """Overwrite a part's captured outputs with a replay's."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_out(dst[k], src[k])
    elif isinstance(dst, tuple):
        for a, b in zip(dst, src):
            _copy_out(a, b)


class _EmulatedGraph:
    """Stands in for ``mcmc._Graph`` on the CPU.  The capture runs the part
    once under ``_host_read_guard`` and then puts every buffer of the
    runner back as it was (a capture computes nothing); a replay runs the
    part again and copies its outputs into the captured ones, as a graph's
    replay overwrites its own memory.  ``captured`` lists the parts."""

    runner = None
    captured: list = []

    def __init__(self, name, fn, pool, stream):
        r = _EmulatedGraph.runner
        bufs = _leaves(r.state) + [r.it_dev]
        snap = [b.clone() for b in bufs]
        counts = mt._launch_counts()
        with _host_read_guard():
            self.out = fn()
        for b, s in zip(bufs, snap):
            b.copy_(s)
        mt._set_launch_counts(counts)
        self.fn = fn
        _EmulatedGraph.captured.append(name)

    def replay(self):
        _copy_out(self.out, self.fn())


class _NoStream:
    def wait_stream(self, other):
        pass


def _counting(fn, name, attr):
    """``fn`` (a kernel wrapper's plain version on the CPU) that counts its
    calls in ``name.attr``, as the wrapper counts its launches."""

    def f(*a, **k):
        setattr(name, attr, getattr(name, attr) + 1)
        return fn(*a, **k)

    return f


@pytest.fixture
def emulated_capture(monkeypatch):
    """StepRunner on the CPU that captures, with ``_EmulatedGraph`` and
    no-op streams; the kernel wrappers count their (plain) calls."""
    from spamtree_tpu_torch.ops import linalg

    monkeypatch.setattr(linalg, "inv_chol",
                        _counting(linalg.inv_chol, chol, "LAUNCHES"))
    monkeypatch.setattr(level, "thin_gibbs_level", _counting(
        level.thin_gibbs_level, level, "LAUNCHES_GIBBS"))
    for f in ("thin_decision_level", "thin_decision_chains"):
        monkeypatch.setattr(level, f, _counting(
            getattr(level, f), level, "LAUNCHES_DECISION"))

    class Runner(mt.StepRunner):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.capture = True
            _EmulatedGraph.runner = self

    _EmulatedGraph.captured = []
    monkeypatch.setattr(mt, "StepRunner", Runner)
    monkeypatch.setattr(mt, "_Graph", _EmulatedGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _NoStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: _NoStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return _EmulatedGraph


@pytest.mark.parametrize("case", ["always_emit", "accept_aware",
                                  "level_kernels_accept_aware",
                                  "no_carried_operators", "chains2",
                                  "chains2_accept_aware", "reference_warmup"])
def test_emulated_capture_equals_eager(case, emulated_capture):
    """Warm-up iteration, dry runs, capture, replays (``_EmulatedGraph``)
    against the eager step, bit for bit, f64; every part was captured
    once, with no host read inside, and replayed 2-4 times an iteration
    (one chain) or once (chains); the kernel wrappers were called as often
    on both paths (the dry runs before the capture are not counted)."""
    with _env(CASES[case].get("env", {})):
        fit, cfg, state = _fit(case, torch.float64)
        runs, counts = [], []
        for graphs in (False, True):
            mt._set_launch_counts((0, 0, 0))
            runs.append(_run(fit, cfg, state, case, graphs))
            counts.append(mt._launch_counts())
        mt._set_launch_counts((0, 0, 0))
    eager, graphed = runs
    _same_bits(eager, graphed, case)
    assert counts[0] == counts[1] and counts[0][0] > 0, counts
    if "level_kernels" in case:
        assert counts[0][1] > 0 and counts[0][2] > 0, counts
    C = CASES[case].get("chains", 0)
    want = (["C0", "C1"] if C else
            ["A"] + (["R"] if CASES[case].get("accept_aware") else [])
            + ["I", "T0", "T1"])
    assert emulated_capture.captured == want, emulated_capture.captured
    it = graphed["state"].it
    replayed_its = it - 1 - (G0 + 1 if case == "reference_warmup" else 0)
    reps = graphed["graph_replays"] / replayed_its
    assert (reps == 1.0) if C else (2.0 <= reps <= 4.0), reps


# -- against the JAX package -------------------------------------------------


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


@pytest.mark.parametrize("accept_aware", [False, True],
                         ids=["always_emit", "accept_aware"])
def test_runner_steps_match_jax(accept_aware):
    """tests/test_torch_mcmc.py's model and start: five StepRunner
    iterations, their draws taken from the JAX key as the JAX step splits
    it and filled into the runner's buffers, against five JAX steps;
    rtol 1e-10 in f64 (the state after each step)."""
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
    sd = np.diag([3e-4, 3e-9] + [3e-4] * 6)
    cfg_j = mj.MCMCConfig(mcmcsd=sd, accept_aware=accept_aware)
    cfg_t = mt.MCMCConfig(mcmcsd=sd, accept_aware=accept_aware)
    st_j = mj.init_state(ms_j, tspec.bounds, tspec.start, cfg=cfg_j, seed=0,
                         start_beta=np.array([0.4, -0.8]), start_tausq=0.2,
                         start_w=0.3 * rng.normal(size=n))
    step_j = jax.jit(mj.make_step(ms_j, tspec.bounds, cfg_j),
                     static_argnums=2)
    shape = ct.tausq_shape(ms_t, cfg_t.tausq_ab).numpy()
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    f64 = jnp.float64

    def jax_draws(key):
        kw_, kt, ku, kp, kq, kb = jax.random.split(key, 6)
        return [np.array(a) for a in (
            jax.random.normal(kw_, (ms_t.n + 1,), dtype=f64),
            jax.random.normal(kt, (tspec.n_theta,), dtype=f64),
            jax.random.uniform(ku, dtype=f64),
            jax.random.normal(kp, (ms_t.n + 1,), dtype=f64),
            jax.random.gamma(kq, jnp.asarray(shape), dtype=f64),
            jax.random.normal(kb, (ms_t.p, ms_t.q), dtype=f64))]

    feed = iter([jax_draws(k) for k in keys])

    def draw(out):
        for o, a in zip(out, next(feed)):
            o.copy_(torch.as_tensor(a))

    runner = mt.StepRunner(
        ms_t, tspec.bounds, cfg_t,
        model_state_from_numpy(ms_t, model_state_to_numpy(st_j)), draw,
        n_iters=5)
    accepted = []
    for i, key in enumerate(keys):
        before = runner.state.ram.accept_count
        st_j = step_j(st_j, key, True)
        st_t = runner.step(True)
        accepted.append(st_t.ram.accept_count > before)
        _close_tree(model_state_to_numpy(st_t), model_state_to_numpy(st_j),
                    f"step {i}", rtol=1e-10)
    assert True in accepted and False in accepted, accepted


# -- launch counters, failures, the mesh -------------------------------------


class _StubCUDAGraph:
    def replay(self):
        pass


def _stub_cuda_graph(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubCUDAGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, pool=None, stream=None:
                        contextlib.nullcontext())


def test_replays_count_launches_as_eager_calls(monkeypatch):
    """A part whose eager call launches K1 three times, K3 once and K4
    twice: five eager calls and five replays of its capture (a stub graph)
    leave the counters alike; the capture itself adds nothing."""
    _stub_cuda_graph(monkeypatch)

    def part():
        chol.LAUNCHES += 3
        level.LAUNCHES_GIBBS += 1
        level.LAUNCHES_DECISION += 2
        return "out"

    mt._set_launch_counts((0, 0, 0))
    for _ in range(5):
        part()
    eager = mt._launch_counts()
    mt._set_launch_counts((0, 0, 0))
    g = mt._Graph("X", part, None, None)
    assert g.out == "out" and g.launches == (3, 1, 2)
    assert mt._launch_counts() == (0, 0, 0)
    for _ in range(5):
        g.replay()
    assert mt._launch_counts() == eager == (15, 5, 10)
    mt._set_launch_counts((0, 0, 0))


def test_failed_capture_raises_naming_the_part(monkeypatch):
    """No fallback: the error names the part and keeps the operation's
    own message; the counters are left as they were."""
    _stub_cuda_graph(monkeypatch)

    def part():
        chol.LAUNCHES += 1
        raise RuntimeError("operation not permitted when stream is capturing")

    mt._set_launch_counts((4, 0, 0))
    with pytest.raises(RuntimeError, match="part A .*not permitted"):
        mt._Graph("A", part, None, None)
    assert mt._launch_counts() == (4, 0, 0)
    mt._set_launch_counts((0, 0, 0))


def test_graphs_refused_on_a_mesh():
    """graphs=True with a mesh raises; graphs=None resolves to graphs on a
    CUDA model alone: eager on the CPU, on a mesh and under deterministic
    algorithms."""
    fit, cfg, state = _fit("always_emit", torch.float64)
    assert not mt._graphed(fit.ms, None)
    dev = fit.ms.device
    fit.ms.device = torch.device("cuda")  # resolution only: nothing runs
    try:
        assert mt._graphed(fit.ms, None)
        torch.use_deterministic_algorithms(True, warn_only=True)
        assert not mt._graphed(fit.ms, None)
    finally:
        torch.use_deterministic_algorithms(False)
        fit.ms.device = dev
    fit.ms.mesh = object()
    try:
        with pytest.raises(ValueError, match="mesh"):
            mt.run_mcmc(fit.ms, fit.bounds, cfg, state,
                        torch.Generator().manual_seed(1), graphs=True)
        assert not mt._graphed(fit.ms, None)
    finally:
        fit.ms.mesh = None
