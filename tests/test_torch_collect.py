"""The port's chain runner: summary collection, the quantile subsample, the
f16 wire, the pipelined drain and its host ring, against the port's own
collect-all draws and the JAX package's chunk arithmetic.

Unlike the JAX package, a summary run and a collect-all run of the port
draw the same chain bit for bit (summary yhat noise comes from a second
generator), so the moments are held to the draws' own moments."""

import itertools
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import spamtree_tpu_torch
from spamtree_tpu_torch.model import mcmc as mt

# jax and the JAX package are imported inside the test that compares with
# them, so that the card test runs where there is no jax


def _data(n=260, seed=11):
    """tests/test_collect_wire.py's data."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2))
    X = rng.normal(size=(n, 2))
    w = np.sin(coords @ np.array([6.0, 4.0]))
    y = X @ np.array([1.0, -0.5]) + w + 0.1 * rng.normal(size=n)
    y[rng.uniform(size=n) < 0.1] = np.nan
    return y, X, coords


KW = dict(cell_size=16, K=2, seed=7, device="cpu")
F64 = dict(KW, dtype=torch.float64)


# the models here are small: one intra-op thread runs them as fast, and
# keeps test files run in parallel processes from oversubscribing the cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(mcmc, settings, **kw):
    return spamtree_tpu_torch.spamtree(*_data(), mcmc=mcmc, settings=settings,
                                       **(F64 | kw))


def test_summary_moments_match_draws():
    """keep=23 at chunk=10 balances to mc=8 and a truncated last chunk of
    7: summary_count, w_mean (rtol 1e-9) and w_var (rtol 1e-7) equal the
    collect-all run's draws' own; theta is the same chain bit for bit;
    yhat_mean agrees within the noise of the mean (other noise draws)."""
    mcmc = dict(keep=23, burn=8, thin=1)
    ra = _run(mcmc, dict(wire_dtype="none", chunk=10))
    rs = _run(mcmc, dict(wire_dtype="none", collect="summary", chunk=10))
    assert rs["w_mcmc"].shape[0] == 0
    assert rs["summary_count"] == 23 == ra["w_mcmc"].shape[0]
    np.testing.assert_allclose(rs["w_mean"], ra["w_mcmc"].mean(0),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(rs["w_var"], ra["w_mcmc"].var(0),
                               rtol=1e-7, atol=1e-11)
    assert np.array_equal(rs["theta_mcmc"], ra["theta_mcmc"])
    tau = float(np.mean(ra["tausq_mcmc"]))
    tol = 6.0 * np.sqrt(tau / 23)
    np.testing.assert_allclose(rs["yhat_mean"], ra["yhat_mcmc"].mean(0),
                               atol=tol)
    assert (rs["yhat_var"] >= 0).all() and np.isfinite(rs["yhat_var"]).all()


@pytest.mark.parametrize("chunk,summary_draws,idx", [
    # mc=8 (3 exact chunks), stride ceil(24/8)=3 inside each chunk
    (10, 8, [ci * 8 + j for ci in range(3) for j in range(0, 8, 3)]),
    # stride 12 > mc=5: local stride 5 (row 0) of every round(12/5)=2nd
    # chunk -> chunks 0, 2, 4
    (5, 2, [0, 10, 20]),
], ids=["stride_in_chunk", "stride_exceeds_chunk"])
def test_summary_draws_strides(chunk, summary_draws, idx):
    """The quantile subsample keeps the collect-all run's draws at the
    index sets of tests/test_collect_wire.py, bit for bit, and the moments
    still cover all 24 draws."""
    mcmc = dict(keep=24, burn=8, thin=1)
    ra = _run(mcmc, dict(wire_dtype="none", chunk=chunk))
    rs = _run(mcmc, dict(wire_dtype="none", collect="summary", chunk=chunk,
                         summary_draws=summary_draws))
    assert np.array_equal(rs["w_mcmc"], ra["w_mcmc"][idx])
    assert rs["yhat_mcmc"].shape == rs["w_mcmc"].shape
    assert np.isfinite(rs["yhat_mcmc"]).all()
    assert rs["summary_count"] == 24
    np.testing.assert_allclose(rs["w_mean"], ra["w_mcmc"].mean(0),
                               rtol=1e-9, atol=1e-11)


def test_wire_f16_within_precision():
    """A float32 run ships w as float16 by default: the same chain's draws
    agree with the full-precision wire within f16 rounding (2e-3)."""
    mcmc = dict(keep=10, burn=4, thin=1)
    rf = _run(mcmc, dict(wire_dtype="none"), dtype=torch.float32)
    rh = _run(mcmc, {}, dtype=torch.float32)
    scale = np.abs(rf["w_mcmc"]).max()
    np.testing.assert_allclose(rh["w_mcmc"], rf["w_mcmc"],
                               atol=2e-3 * scale, rtol=2e-3)
    assert rh["w_mcmc"].dtype == np.float32
    assert np.array_equal(rh["theta_mcmc"], rf["theta_mcmc"])


def test_pipelined_equals_sequential_drain(tmp_path):
    """The pipelined drain (default) and the sequential one (engaged by
    checkpoint_path) give the same draws bit for bit, yhat included."""
    mcmc = dict(keep=23, burn=10, thin=2)
    a = _run(mcmc, dict(chunk=5))
    b = _run(mcmc, dict(chunk=5), checkpoint_path=str(tmp_path / "ck.npz"))
    for k in ("w_mcmc", "yhat_mcmc", "beta_mcmc", "tausq_mcmc", "theta_mcmc"):
        assert np.array_equal(a[k], b[k]), k
    assert a["w_mcmc"].shape == (23, 260)


@pytest.mark.parametrize("mc_fixed", [0, 3, 4])
def test_chunk_arithmetic_matches_jax(mc_fixed):
    """chunk_sizes and _subsample_plan equal the JAX functions over a grid
    of (keep, chunk, thin, burn, summary_draws)."""
    from spamtree_tpu.model import mcmc as mj

    grid = itertools.product((0, 1, 7, 24, 100, 501), (1, 5, 10, 50, 200),
                             (1, 2, 3), (0, 9, 100), (0, 2, 8, 40))
    for keep, chunk, thin, burn, sd in grid:
        kw = dict(keep=keep, chunk=chunk, thin=thin, burn=burn,
                  summary_draws=sd, mc_fixed=mc_fixed, collect="summary")
        cj, ct = mj.MCMCConfig(**kw), mt.MCMCConfig(**kw)
        got = mt.chunk_sizes(ct)
        assert got == mj.chunk_sizes(cj), kw
        for summary in (False, True):
            assert (mt._subsample_plan(ct, got[0], summary)
                    == mj._subsample_plan(cj, got[0], summary)), kw
            assert (mt._out_keys(summary, sd)
                    == mj._out_keys(summary, sd)), kw


def test_host_ring_reuses_slots():
    """The host ring allocates each slot's buffers once, later chunks
    reuse released slots' buffers, and a shorter chunk is a view of them;
    on the CPU it pins nothing and records no event."""
    ring = mt.HostRing(2, torch.device("cpu"), rows=5)
    seen = []
    for k in range(5):
        rows = 5 if k < 4 else 3
        t = {"w": torch.full((rows, 7), float(k)),
             "theta": torch.full((rows, 2), -float(k))}
        slot, host, event = ring.copy(t)
        assert event is None and not host["w"].is_pinned()
        assert torch.equal(host["w"], t["w"]) and host["w"].shape[0] == rows
        seen.append(host["w"].untyped_storage().data_ptr())
        ring.release(slot)
    assert ring.allocations == 4  # two slots in turn, w and theta each
    assert len(set(seen)) == 2


_DOUBLE_INTERRUPT = r"""
import signal, threading, time
from spamtree_tpu_torch.model.mcmc import _drain_loop

first = threading.Event()
main = threading.main_thread().ident
drained = []

def dispatch(ki):
    if ki == 3:
        first.set()
        raise KeyboardInterrupt  # the first Ctrl-C, with chunks 0-2 run
    return (ki,)

def drain(ki):
    if ki == 1:
        # a second Ctrl-C while the main thread flushes the queue
        assert first.wait(10)
        time.sleep(0.2)
        signal.pthread_kill(main, signal.SIGINT)
        time.sleep(0.2)
    drained.append(ki)

_drain_loop(6, dispatch, drain, pipeline=True)
assert drained == [0, 1, 2], drained
print("drained", drained)
"""


def test_drain_flushes_under_second_interrupt():
    """A second KeyboardInterrupt while the pipelined drain flushes its
    queue does not drop the queued chunks (the JAX package's
    _drain_loop, mcmc.py:845, abandons them); run in a fresh interpreter,
    whose main thread takes SIGINT."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", _DOUBLE_INTERRUPT], cwd=repo,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert "drained [0, 1, 2]" in p.stdout
    assert "interrupted again" in p.stdout


def test_drain_error_surfaces_after_join():
    """A drain's error stops the worker and is raised by the main thread,
    the pipelined loop stops dispatching, and no thread is left behind."""
    dispatched = []

    def dispatch(ki):
        dispatched.append(ki)
        return (ki,)

    def drain(ki):
        if ki == 1:
            raise FloatingPointError("non-finite theta")

    before = threading.active_count()
    with pytest.raises(FloatingPointError):
        mt._drain_loop(50, dispatch, drain, pipeline=True)
    assert threading.active_count() == before
    assert len(dispatched) < 50


def test_prepare_fit_cuda_without_card_raises(monkeypatch):
    """The entry points run on the card by default; where CUDA is absent
    they raise instead of falling back to the CPU."""
    from spamtree_tpu_torch.api import prepare_fit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prepare_fit(*_data(), mcmc=dict(keep=1, burn=0), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prepare_fit(*_data(), mcmc=dict(keep=1, burn=0))


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: pinned memory and events")
def test_pinned_ring_on_card():
    """The pipelined drain's pinned ring at a small size: every chunk's
    host copy equals its device tensors once its event has completed,
    while later chunks are copied into the other slots; the slots' buffers
    are allocated once and reused."""
    ring = mt.HostRing(mt._QUEUE_DEPTH + 1, torch.device("cuda"), rows=8)
    g = torch.Generator(device="cuda").manual_seed(0)
    pending = []
    for k in range(12):
        rows = 8 if k < 11 else 5
        dev = {"w": torch.randn(rows, 100_000, generator=g, device="cuda"
                                ).to(torch.float16),
               "theta": torch.randn(rows, 8, generator=g, device="cuda",
                                    dtype=torch.float64)}
        slot, host, event = ring.copy(dev)
        assert host["w"].is_pinned() and event is not None
        pending.append((slot, host, event, dev))
        if len(pending) == mt._QUEUE_DEPTH + 1:
            slot, host, event, dev = pending.pop(0)
            event.synchronize()
            for name in dev:
                assert torch.equal(host[name], dev[name].cpu()), (k, name)
            ring.release(slot)
    for slot, host, event, dev in pending:
        event.synchronize()
        for name in dev:
            assert torch.equal(host[name], dev[name].cpu())
        ring.release(slot)
    assert ring.allocations == 2 * (mt._QUEUE_DEPTH + 1)
