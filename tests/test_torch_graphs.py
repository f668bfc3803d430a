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
* A replay adds to every one of the kernels' counts what an eager call adds
  (a stub graph); a failed capture raises naming its part; a gloo mesh
  on CUDA tensors is refused.
* Under deterministic algorithms the emulated capture gives the same
  bits, and graphs stay the default on a CUDA model; ``put_rows``, the
  row write that replaced ``index_put_``, gives its bits on every level.
* A capture inside the keep loop (the reference warmup past a short
  burn) keeps the pipelined drain, with the sequential drain's bits; a
  donated state is the run's carry, with the copied state's bits.
"""

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _graph_capture import (  # noqa: F401  (emulated_capture: a fixture)
    _leaves,
    emulated_capture,
)
from spamtree_tpu.model import core as cj
from spamtree_tpu.model import mcmc as mj
from spamtree_tpu.model.params import make_theta_spec
from spamtree_tpu.tree.partition import make_tree as make_tree_jax
from spamtree_tpu.tree.schedule import build_schedule as build_schedule_jax
from spamtree_tpu_torch.api import prepare_fit
from spamtree_tpu_torch.model import core as ct
from spamtree_tpu_torch.model import graph
from spamtree_tpu_torch.model import mcmc as mt
from spamtree_tpu_torch.model.ram import G0
from spamtree_tpu_torch.ops import kernel_counts
from spamtree_tpu_torch.tree.partition import make_tree
from spamtree_tpu_torch.tree.schedule import build_schedule
from spamtree_tpu_torch.utils import trace
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
    _emulated_vs_eager(case, emulated_capture)


@contextlib.contextmanager
def _deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("case", ["always_emit", "accept_aware",
                                  "level_kernels_accept_aware", "chains2",
                                  "chains2_accept_aware"])
def test_emulated_capture_equals_eager_deterministic(case,
                                                     emulated_capture):
    """test_emulated_capture_equals_eager with
    ``torch.use_deterministic_algorithms(True)``: the graphed runs, their
    row writes through ``put_rows`` included, capture with no host read
    and give the eager bits."""
    with _deterministic():
        _emulated_vs_eager(case, emulated_capture)


def _emulated_vs_eager(case, emulated_capture):
    with _env(CASES[case].get("env", {})):
        fit, cfg, state = _fit(case, torch.float64)
        runs, counted = [], []
        for graphs in (False, True):
            before = kernel_counts.snapshot()
            runs.append(_run(fit, cfg, state, case, graphs))
            counted.append(kernel_counts.diff(before))
    eager, graphed = runs
    _same_bits(eager, graphed, case)
    assert counted[0] == counted[1] and counted[0]["k1_launches"] > 0, counted
    if "level_kernels" in case:
        assert (counted[0]["k3_launches"] > 0
                and counted[0]["k4_launches"] > 0), counted
    C = CASES[case].get("chains", 0)
    want = (["C0", "C1"] if C else
            ["A"] + (["R"] if CASES[case].get("accept_aware") else [])
            + ["I", "T0", "T1"])
    assert emulated_capture.captured == want, emulated_capture.captured
    it = graphed["state"].it
    replayed_its = it - 1 - (G0 + 1 if case == "reference_warmup" else 0)
    reps = graphed["graph_replays"] / replayed_its
    assert (reps == 1.0) if C else (2.0 <= reps <= 4.0), reps


@pytest.mark.parametrize("limited", [False, True], ids=["full", "limited"])
@pytest.mark.parametrize("C", [0, 2], ids=["one_chain", "chains2"])
def test_put_rows_equals_index_put(limited, C):
    """put_rows (a gather through a RowTable) against ``w[..., rows] =
    vals`` (index_put_), bit for bit: every level alone through its own
    table, all levels through ModelStatic's table, all prediction buckets
    through its other; the values masked to 0 on padded slots, as every
    caller's are, the sentinel row among those written."""
    fit, _, _ = _fit("limited_tree" if limited else "always_emit",
                     torch.float64)
    ms = fit.ms
    rng = np.random.default_rng(3)
    lead = (C,) if C else ()
    w = torch.as_tensor(rng.normal(size=lead + (ms.n + 1,)))
    groups = [(ms.levels, ms.level_rows), (ms.pred_arrays, ms.pred_rows)]
    assert ms.pred_arrays and any(bool((~lv.rmask).any())
                                  for lv in ms.levels)
    for lvls, table in groups:
        vals = [torch.where(lv.rmask, torch.as_tensor(rng.normal(
            size=lead + tuple(lv.rows.shape))), 0.0) for lv in lvls]
        want = w.clone()
        for lv, v in zip(lvls, vals):
            want[..., lv.rows] = v
            one = w.clone()
            one[..., lv.rows] = v
            assert torch.equal(ct.put_rows(ms, w, [v], ct.row_table(
                lv.rows.numpy(), ms.n, "cpu")), one)
        assert torch.equal(ct.put_rows(ms, w, vals, table), want)
    with pytest.raises(AssertionError, match="twice"):
        ct.row_table(np.array([0, 1, 0]), ms.n, "cpu")


def test_late_capture_keeps_pipelined_drain(emulated_capture, monkeypatch,
                                            tmp_path):
    """burn = 20 with the reference warmup: the capture comes at iteration
    G0 + 1, inside the keep loop, while the drain thread works on earlier
    chunks; the keep loop still drains pipelined, with the bits of the
    sequential drain (a checkpointed run) and of the eager step."""
    y, X, coords, mv = _data()
    fit = prepare_fit(y, X, coords, mv_id=mv, cell_size=16, K=2, seed=7,
                      device="cpu", dtype=torch.float64,
                      mcmc=dict(keep=40, burn=20, thin=1),
                      settings=dict(chunk=4, wire_dtype="none",
                                    ram_reference_warmup=True))
    seen = []
    drain_loop = mt._drain_loop

    def spy(n, dispatch, drain, pipeline):
        seen.append(pipeline)
        return drain_loop(n, dispatch, drain, pipeline)

    monkeypatch.setattr(mt, "_drain_loop", spy)
    runs = [mt.run_mcmc(fit.ms, fit.bounds, fit.cfg, fit.state,
                        torch.Generator().manual_seed(5), yhat_seed=3,
                        graphs=g, checkpoint_path=ck)
            for g, ck in ((True, None),
                          (True, str(tmp_path / "ck.pt")), (False, None))]
    assert seen == [True, False, True], seen
    assert emulated_capture.captured[:1] == ["A"]
    assert runs[0]["burn_actual"] == 20 and runs[0]["state"].it > G0 + 1
    assert runs[0]["graph_replays"] > 0
    _same_bits(runs[1], runs[0], "pipelined vs sequential")
    _same_bits(runs[2], runs[0], "graphed vs eager")


@pytest.mark.parametrize("case", ["always_emit", "chains2"])
def test_donated_state_is_the_carry(case):
    """donate=True: the run keeps its carry in the given state's tensors
    (the final state is them) and gives the bits of donate=False, which
    leaves its state as it was."""
    fit, cfg, state = _fit(case, torch.float64)
    C = CASES[case].get("chains", 0)
    if C:
        state, _ = mt.stack_chain_states(state, 5 + np.arange(C))
    before = [x.clone() for x in _leaves(state)]
    runs = []
    for donate in (False, True):
        given = ct._tree_map(lambda x: x.clone() if isinstance(
            x, torch.Tensor) else x, state) if donate else state
        if C:
            gens = [torch.Generator().manual_seed(int(5 + c))
                    for c in range(C)]
            res = mt.run_mcmc_chains(fit.ms, fit.bounds, cfg, given, gens,
                                     yhat_seed=3, graphs=True, donate=donate)
        else:
            res = mt.run_mcmc(fit.ms, fit.bounds, cfg, given,
                              torch.Generator().manual_seed(5), yhat_seed=3,
                              graphs=True, donate=donate)
        runs.append(res)
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(state)))
    fin = runs[1]["state"]
    for x, y in zip(_leaves((given.w, given.theta, given.leveldata,
                             given.pred_data)),
                    _leaves((fin.w, fin.theta, fin.leveldata,
                             fin.pred_data))):
        assert x.data_ptr() == y.data_ptr()
    assert not torch.equal(given.w, state.w)
    _same_bits(runs[0], runs[1], case)


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


# -- kernel counts, failures, the mesh ---------------------------------------


class _StubCUDAGraph:
    def replay(self):
        pass


def _stub_cuda_graph(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubCUDAGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, pool=None, stream=None, **k:
                        contextlib.nullcontext())


def test_replays_count_launches_as_eager_calls(monkeypatch):
    """A part that adds its own amount to every name of the kernels'
    counts (``ops.kernel_counts``, whatever names it lists): five replays
    of its capture (a stub graph) add what five eager calls add, name by
    name; the capture itself adds nothing."""
    _stub_cuda_graph(monkeypatch)
    names = list(kernel_counts.snapshot())
    assert {"k1_launches", "k3_launches", "k4_launches", "k1_blocks",
            "k1_wide_blocks", "plain_blocks"} <= set(names), names
    once = {name: i + 1 for i, name in enumerate(names)}

    def part():
        for name, n in once.items():
            kernel_counts.add(name, n)
        return "out"

    before = kernel_counts.snapshot()
    for _ in range(5):
        part()
    eager = kernel_counts.diff(before)
    assert eager == {name: 5 * n for name, n in once.items()}
    before = kernel_counts.snapshot()
    g = graph.Graph("X", part, None, None)
    assert g.out == "out" and g.counted == once
    assert kernel_counts.snapshot() == before
    for _ in range(5):
        g.replay()
    assert kernel_counts.diff(before) == eager


def test_replays_count_factorised_blocks_as_eager_calls(monkeypatch):
    """A part that factorises six blocks on K1's route, four of them on its
    128-thread form, and two on the plain one: five replays of its capture
    (a stub graph) add to the block counts what five eager calls would,
    the capture itself nothing, and the call's trace record holds them
    (``ops.kernel_counts.trace_blocks``)."""
    _stub_cuda_graph(monkeypatch)

    def part():
        kernel_counts.add("k1_blocks", 6)
        kernel_counts.add("k1_wide_blocks", 4)
        kernel_counts.add("plain_blocks", 2)
        return "out"

    blocks = {"k1_blocks": 6, "k1_wide_blocks": 4, "plain_blocks": 2}
    with trace.call("blocks") as rec, kernel_counts.trace_blocks():
        before = kernel_counts.snapshot()
        g = graph.Graph("X", part, None, None)
        assert g.counted == dict.fromkeys(before, 0) | blocks
        assert kernel_counts.snapshot() == before
        for _ in range(5):
            g.replay()
    assert kernel_counts.diff(before) == dict.fromkeys(before, 0) | {
        k: 5 * n for k, n in blocks.items()}
    assert rec.counter("ops.chol.k1_blocks") == 30
    assert rec.counter("ops.chol.k1_wide_blocks") == 20
    assert rec.counter("ops.chol.plain_blocks") == 10


def test_failed_capture_raises_naming_the_part(monkeypatch):
    """No fallback: the error names the part and keeps the operation's
    own message; the counts are left as they were."""
    _stub_cuda_graph(monkeypatch)

    def part():
        kernel_counts.add("k1_launches")
        raise RuntimeError("operation not permitted when stream is capturing")

    before = kernel_counts.snapshot()
    with pytest.raises(RuntimeError, match="part A .*not permitted"):
        graph.Graph("A", part, None, None)
    assert kernel_counts.snapshot() == before


def test_graphs_refused_on_a_mesh():
    """graphs=True on a gloo mesh with CUDA tensors raises, naming gloo's
    host staging; graphs=None resolves to graphs on a CUDA model alone or
    on an NCCL mesh, under deterministic algorithms too: eager on the CPU
    and on a gloo mesh."""
    fit, cfg, state = _fit("always_emit", torch.float64)
    assert not mt._graphed(fit.ms, None)
    dev = fit.ms.device
    fit.ms.device = torch.device("cuda")  # resolution only: nothing runs
    try:
        assert mt._graphed(fit.ms, None)
        torch.use_deterministic_algorithms(True, warn_only=True)
        assert mt._graphed(fit.ms, None)
        fit.ms.mesh = SimpleNamespace(backend="nccl")
        assert mt._graphed(fit.ms, None)
        fit.ms.mesh = SimpleNamespace(backend="gloo")
        assert not mt._graphed(fit.ms, None)
        with pytest.raises(ValueError, match="gloo stages CUDA tensors "
                           "through host memory"):
            mt.StepRunner(fit.ms, fit.bounds, cfg, state, None)
    finally:
        torch.use_deterministic_algorithms(False)
        fit.ms.device = dev
        fit.ms.mesh = None
