"""The port's spans and counters (``spamtree_tpu_torch.utils.trace``), on
the CPU.

* A span adds its host seconds and a count to the current call's record,
  and its seconds to its parent's children; outside a call it measures
  alone.  The history is bounded, newest last.
* The drain thread of ``run_mcmc`` writes its spans into its call's
  record; the record takes concurrent updates without losing one.
* An inactive call opens no profiler range; under
  ``torch.profiler`` (host activities) a small ``run_mcmc`` and
  ``spamtree_predict`` show their ``mcmc.*`` and ``predict.*`` spans.
* The schedule's span sits inside the tree's: ``setup.schedule`` in
  ``setup.tree``, ``predict.schedule`` in ``predict.tree``.
* The results' timings and counters are the record's: ``mcmc.chunks`` the
  keep chunks, ``graph_replays`` the replay counters' sum (the capture
  emulated), ``iter_s``, ``save_s`` and ``drain_work_s`` their spans;
  the top-level spans cover the loop and the prediction call.
* Device spans wait for no event inside the loop and hold at most
  ``MAX_PENDING`` pairs.
* Each of the benchmark's readers of these records picks the right one
  from a synthetic history or context.
"""

import collections
import importlib.util
import os
import sys
import threading

import numpy as np
import pytest
import torch

from _graph_capture import emulated_capture  # noqa: F401  (a fixture)
from spamtree_tpu_torch import api
from spamtree_tpu_torch.model import mcmc as mt
from spamtree_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=300, seed=5):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2))
    X = np.column_stack([np.ones(n), rng.normal(size=n)])
    mv = rng.integers(0, 2, size=n) + 1
    y = X @ np.array([0.5, -1.0]) + np.sin(5 * coords[:, 0]) \
        + 0.2 * rng.normal(size=n)
    y[rng.uniform(size=n) < 0.1] = np.nan
    return y, X, coords, mv


def _fit(keep=12, burn=6, chunk=4, thin=1):
    y, X, coords, mv = _data()
    return api.prepare_fit(y, X, coords, mv_id=mv, cell_size=16, K=2, seed=3,
                           dtype=torch.float64, device="cpu",
                           mcmc=dict(keep=keep, burn=burn, thin=thin),
                           settings=dict(chunk=chunk))


def _run(fit, **kw):
    return mt.run_mcmc(fit.ms, fit.bounds, fit.cfg, fit.state, fit.gen,
                       yhat_seed=2, **kw)


def _newest(name):
    return [r for r in trace.history() if r.name == name][-1]


# -- the module --------------------------------------------------------------


def test_span_totals_counts_and_nesting():
    with trace.call("outer") as rec:
        for _ in range(3):
            with trace.span("a") as a:
                with trace.span("a.b"):
                    pass
                with trace.span("a.b"):
                    pass
        with trace.span("c"):
            trace.count("n", 2)
            trace.count("n")
    assert trace.history()[-1] is rec and rec.name == "outer"
    assert not rec.active and rec.wall_s > 0
    assert (rec.calls("a"), rec.calls("a.b"), rec.calls("c")) == (3, 6, 1)
    assert rec.counter("n") == 3 and rec.counter("missing") == 0
    assert a.seconds > 0 and rec.seconds("a") >= a.seconds
    # a's children are its b spans; the call's top-level spans are a and c
    assert rec.children_s("a") == pytest.approx(rec.seconds("a.b"))
    assert rec.children_s(None) == pytest.approx(
        rec.seconds("a") + rec.seconds("c"))
    assert rec.seconds("a.b") <= rec.seconds("a") <= rec.wall_s


def test_span_outside_a_call_measures_alone():
    before = trace.history()
    assert trace.current() is None
    with trace.span("alone") as sp:
        sum(range(1000))
    trace.count("alone")
    assert sp.seconds > 0 and trace.history() == before


def test_history_is_bounded_newest_last():
    for i in range(trace.HISTORY + 5):
        with trace.call(f"c{i}"):
            pass
    names = [r.name for r in trace.history()]
    assert len(names) == trace.HISTORY
    assert names == [f"c{i}" for i in range(5, trace.HISTORY + 5)]


def test_nested_call_has_its_own_record():
    with trace.call("outer") as outer:
        with trace.span("x"):
            with trace.call("inner") as inner:
                with trace.span("y"):
                    pass
        assert trace.current() is outer
    assert outer.calls("y") == 0 and inner.calls("y") == 1
    assert outer.calls("x") == 1 and inner.children_s(None) > 0
    assert [r.name for r in trace.history()[-2:]] == ["inner", "outer"]


def test_record_takes_concurrent_updates():
    """More threads than cores, a short switch interval: no span or count
    is lost, and only the opening thread's top-level spans count as the
    call's."""
    n_threads, n_each = 2 * (os.cpu_count() or 1) + 2, 400
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.call("stress") as rec:
            def work():
                with trace.adopt(rec):
                    for _ in range(n_each):
                        with trace.span("s"):
                            trace.count("k")

            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert rec.counter("k") == n_threads * n_each
    assert rec.calls("s") == n_threads * n_each
    assert rec.children_s(None) == 0.0


class _FakeEvent:
    """A CUDA event's host side: complete once ``done`` is set."""

    made = 0

    def __init__(self):
        _FakeEvent.made += 1
        self.done = False
        self.synced = 0

    def record(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.synced += 1
        self.done = True

    def elapsed_time(self, other):
        return 2.0


def test_device_spans_wait_for_nothing_and_stay_bounded(monkeypatch):
    monkeypatch.setattr(trace, "_event", _FakeEvent)
    monkeypatch.setattr(trace, "MAX_PENDING", 4)
    _FakeEvent.made = 0
    with trace.call("dev") as rec:
        rec.active = True
        for _ in range(6):  # nothing completes: 4 pairs wait, 2 skipped
            with rec.device_span("p"):
                pass
        assert len(rec._pending) == 4
        assert rec.counter("trace.device_spans_skipped") == 2
        for _, a, b in rec._pending:
            b.done = True
        with rec.device_span("p"):  # reads the 4 finished pairs first
            pass
        assert rec.device_ms("p") == 8.0 and len(rec._pending) == 1
        assert _FakeEvent.made == 8  # the new pair reused read events
        assert not any(e.synced for e in rec._spare)
    # the call's end waits for the last pair
    assert rec.device_ms("p") == 10.0 and rec.device["p"][1] == 5
    assert not rec._pending


# -- the program's calls -----------------------------------------------------


@pytest.mark.parametrize("checkpoint", [False, True],
                         ids=["pipelined", "checkpointed"])
def test_run_readings_are_the_records(checkpoint, tmp_path):
    fit = _fit()
    kw = dict(checkpoint_path=str(tmp_path / "ck")) if checkpoint else {}
    res = _run(fit, **kw)
    rec = _newest("run_mcmc")
    mc, ipc, n_keep, n_burn = mt.chunk_sizes(fit.cfg)
    assert rec.counter("mcmc.chunks") == n_keep == 3
    assert rec.counter("mcmc.iterations") == n_burn * ipc + 12
    assert rec.calls("mcmc.drain") == n_keep
    assert res["mcmc_time"] == rec.seconds("mcmc.run")
    assert res["iter_s"] == rec.seconds("mcmc.iterate")
    assert res["save_s"] == rec.seconds("mcmc.save")
    assert (res["save_s"] > 0) == checkpoint
    assert res["drain_work_s"] == (rec.seconds("mcmc.drain")
                                   - rec.seconds("mcmc.drain.copy_wait"))
    assert res["drain_work_s"] > 0
    assert res["graph_replays"] == 0 and res["compile_time_s"] == 0.0
    # the loop's top-level spans cover it
    assert rec.children_s("mcmc.run") / rec.seconds("mcmc.run") > 0.9
    # pipelined, the drains ran on the worker: not the loop's children
    drains = rec.children_s("mcmc.drain")
    assert drains == pytest.approx(rec.seconds("mcmc.drain.copy_wait")
                                   + rec.seconds("mcmc.drain.store"))
    # every kept draw's yhat was built on the device, none on the host
    assert rec.counter("mcmc.yhat_device") == fit.cfg.keep == 12
    assert rec.calls("mcmc.drain.yhat") == 0
    if not checkpoint:
        assert rec.calls("mcmc.drain_flush") == 1


def test_setup_breakdown_is_the_records():
    fit = _fit()
    rec = _newest("prepare_fit")
    for key, name in (("tree_s", "setup.tree"), ("stage_s", "setup.model"),
                      ("init_s", "setup.init")):
        assert fit.setup_breakdown[key] == round(rec.seconds(name), 2)
        assert rec.calls(name) == 1


def test_replays_are_the_records(emulated_capture):
    fit = _fit()
    res = _run(fit, graphs=True)
    runner = emulated_capture.runner
    rec = _newest("run_mcmc")
    parts = {k[len("mcmc.replays."):]: v for k, v in rec.counters.items()
             if k.startswith("mcmc.replays.")}
    assert parts == dict(runner.part_replays) and parts["A"] > 0
    assert res["graph_replays"] == runner.replays == sum(parts.values())
    assert res["compile_time_s"] == rec.seconds("mcmc.capture") > 0
    assert rec.calls("mcmc.capture") == 1


class _CountingRange:
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _CountingRange.entered += 1
        return self

    def __exit__(self, *exc):
        return False


def _predict(res, y, X, coords, mv):
    rng = np.random.default_rng(1)
    m = 20
    return api.spamtree_predict(
        res, y, X, coords, rng.uniform(size=(m, 2)),
        np.column_stack([np.ones(m), rng.normal(size=m)]), mv_id=mv,
        mv_id_new=rng.integers(0, 2, size=m) + 1, seed=3, chunk=4,
        device="cpu")


def test_inactive_call_opens_no_profiler_range(monkeypatch):
    monkeypatch.setattr(trace, "_range", _CountingRange)
    _CountingRange.entered = 0
    y, X, coords, mv = _data()
    res = api.spamtree(y, X, coords, mv_id=mv, cell_size=16, K=2, seed=3,
                       device="cpu", mcmc=dict(keep=8, burn=4),
                       settings=dict(chunk=4))
    _predict(res, y, X, coords, mv)
    assert _CountingRange.entered == 0
    assert not any(r.active for r in trace.history()[-3:])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _predict(res, y, X, coords, mv)
    assert _newest("spamtree_predict").active
    assert _CountingRange.entered > 0


def test_profiler_shows_the_program_spans():
    y, X, coords, mv = _data()
    fit = _fit(keep=8, burn=4)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = _run(fit, graphs=True)  # StepRunner's parts as plain calls
    fitd = {"w_mcmc": res["w"], "theta_mcmc": res["theta"].T,
            "beta_mcmc": np.moveaxis(res["beta"], 0, 1),
            "tausq_mcmc": res["tausq"].T, "fit_config": fit.fit_config,
            "order": fit.order, "tree": fit.tree}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof2:
        out = _predict(fitd, y, X, coords, mv)
    names = {e.name for e in list(prof.events()) + list(prof2.events())}
    for want in ("mcmc.run", "mcmc.iterate", "mcmc.stage", "mcmc.accept_read",
                 "mcmc.drain_wait", "mcmc.drain_flush", "mcmc.result",
                 "predict.stage", "predict.tree", "predict.model",
                 "predict.draws", "predict.upload", "predict.readback",
                 "predict.yhat"):
        assert want in names, want
    rec = _newest("spamtree_predict")
    assert rec.active and rec.calls("predict.upload") == 2
    assert rec.children_s(None) / rec.wall_s > 0.9
    assert rec.children_s("predict.stage") == pytest.approx(
        rec.seconds("predict.tree") + rec.seconds("predict.model"))
    tb = out["predict_breakdown"]
    for key, name in (("draws_s", "draws"), ("upload_s", "upload"),
                      ("yhat_s", "yhat"), ("capture_s", "capture")):
        assert tb[key] == round(rec.seconds(f"predict.{name}"), 3)
    assert set(tb) == {"tree_s", "stage_s", "draws_s", "capture_s",
                       "upload_s", "yhat_s"}



def test_schedule_spans_sit_inside_the_tree_spans():
    """``build_schedule``'s seconds are a span of their own, the only child
    of the tree's span: ``setup.schedule`` in ``setup.tree`` of a
    ``prepare_fit`` call, ``predict.schedule`` in ``predict.tree`` of a
    ``spamtree_predict`` call (also as the profiler's host ranges)."""
    y, X, coords, mv = _data()
    res = api.spamtree(y, X, coords, mv_id=mv, cell_size=16, K=2, seed=3,
                       device="cpu", mcmc=dict(keep=8, burn=4),
                       settings=dict(chunk=4))
    rec = _newest("prepare_fit")
    assert rec.calls("setup.schedule") == 1
    assert 0 < rec.seconds("setup.schedule") <= rec.seconds("setup.tree")
    assert rec.children_s("setup.tree") == pytest.approx(
        rec.seconds("setup.schedule"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _predict(res, y, X, coords, mv)
    rec = _newest("spamtree_predict")
    assert rec.calls("predict.schedule") == 1
    assert 0 < rec.seconds("predict.schedule") <= rec.seconds("predict.tree")
    assert rec.children_s("predict.tree") == pytest.approx(
        rec.seconds("predict.schedule"))
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name in ("predict.tree", "predict.schedule")}
    assert set(ranges) == {"predict.tree", "predict.schedule"}
    assert (ranges["predict.tree"].start <= ranges["predict.schedule"].start
            and ranges["predict.schedule"].end <= ranges["predict.tree"].end)

# -- the benchmark's readers -------------------------------------------------


def _reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "trace_test_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(name, active, iters=0, chunks=0, spans=(), device=()):
    r = trace.Record(name, active)
    r.counters.update({"mcmc.iterations": iters, "mcmc.chunks": chunks})
    for k, s in spans:
        r.spans[k] = [int(round(s * 1e9)), 1]
    for k, ms in device:
        r.device[k] = [ms, 1]
    return r


@pytest.fixture
def fit_history(monkeypatch):
    """What a traced fit cell leaves: set-up, warm-up, the window, the
    profiled call."""
    recs = [
        _record("prepare_fit", False),
        _record("run_mcmc", False, 3, 1, [("mcmc.drain_wait", 5.0)]),
        _record("run_mcmc", True, 100, 2,
                device=[("mcmc.part.I", 90.0)]),
        _record("run_mcmc", False, 720, 9,
                [("mcmc.drain_wait", 9.0), ("mcmc.drain", 30.0),
                 ("mcmc.drain.copy_wait", 3.0)]),
        _record("run_mcmc", True, 150, 3,
                [("mcmc.drain_wait", 100.0)],
                [("mcmc.part.I", 60.0), ("mcmc.part.A", 900.0)]),
        _record("spamtree_predict", True),
    ]
    monkeypatch.setattr(trace, "_history",
                        collections.deque(recs, maxlen=trace.HISTORY))
    return recs


@pytest.mark.parametrize("name,ctx,want", [
    ("drain_wait_ms_per_chunk", dict(iters=720), 1000.0),
    ("drain_ms_per_chunk", dict(iters=720), 3000.0),
    ("install_ms_per_it", dict(profile={"busy_s": 1.0}), 0.4),
    ("predict_upload_ms_per_draw",
     dict(draws=400, predict_breakdowns=[dict(upload_s=0.5),
                                         dict(upload_s=0.7)]), 3.0),
])
def test_reader_picks_its_record(fit_history, name, ctx, want):
    mod = _reader(name)
    assert mod.read(ctx) == pytest.approx(want)
    assert mod.read(dict(config=None, traffic=None)) is None


@pytest.mark.parametrize("launches,plain,want", [
    (24, 0, 100.0), (0, 30, 0.0), (6, 18, 25.0), (0, 0, None),
    (None, None, None)])
def test_cov_kernel_share_reads_the_chain_record(monkeypatch, launches,
                                                 plain, want):
    """``cov_kernel_share`` reads the newest chain record's K6 launches
    over all covariance-block calls, in %; nothing where the counters are
    missing (a program without them) or zero, or outside a traced run."""
    old = _record("run_mcmc", True, 5, 1)
    old.counters.update({"ops.cov.launches": 1, "ops.cov.plain_calls": 1})
    new = _record("run_mcmc_chains", True, 5, 1)
    if launches is not None:
        new.counters.update({"ops.cov.launches": launches,
                             "ops.cov.plain_calls": plain})
    monkeypatch.setattr(trace, "_history", collections.deque(
        [old, new, _record("spamtree_predict", True)],
        maxlen=trace.HISTORY))
    mod = _reader("cov_kernel_share")
    got = mod.read(dict(profile={"busy_s": 1.0}))
    assert got == (None if want is None else pytest.approx(want))
    assert mod.read(dict(profile=None)) is None
    assert (mod.SOURCE, mod.LAYER, mod.MOVES) == (
        "program_counter", "model.core", "chain_iters_per_s")


def test_readers_read_nothing_without_records(monkeypatch):
    monkeypatch.setattr(trace, "_history",
                        collections.deque(maxlen=trace.HISTORY))
    for name in ("drain_wait_ms_per_chunk", "drain_ms_per_chunk"):
        assert _reader(name).read(dict(iters=720)) is None
    assert _reader("install_ms_per_it").read(dict(profile={})) is None
    assert _reader("predict_upload_ms_per_draw").read(dict(
        draws=10, predict_breakdowns=[dict(draws_s=1.0)])) is None
