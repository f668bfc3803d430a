"""The emulated CUDA-graph capture of the port's tests, on the CPU.

CUDA graphs run only on the card.  These helpers stand in for them so
that a CPU test holds what a capture needs: ``_host_read_guard`` raises on
any read of a device value by the host and any host-to-device copy on
the capturing thread, ``_EmulatedGraph`` captures a part once under that
guard and replays it by running it again into the captured outputs
(``_EmulatedCounts``: the kernels' counts as a graph keeps them), and
``emulate_capture`` installs both in place of ``model.graph.Graph``.
Shared by tests/test_torch_graphs.py, tests/test_torch_predict_graphs.py
and the mesh rank jobs of tests/_mesh_graph_jobs.py; imports no jax, as
the mesh's worker processes must not.
"""

import contextlib
import threading

import pytest
import torch

from spamtree_tpu_torch.model import graph
from spamtree_tpu_torch.model import mcmc as mt
from spamtree_tpu_torch.ops import kernel_counts, level, linalg


def _leaves(x):
    """Every tensor of a (nested) state, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for y in x for t in _leaves(y)]
    return []


@contextlib.contextmanager
def _host_read_guard():
    """Raise on what a CUDA graph cannot capture: a read of a device value
    by the host (item, bool, cpu, numpy, tolist, float, int, index) and a
    host-to-device copy (as_tensor or tensor of host data, an index given
    as a Python list, a Python number assigned into a tensor) -- on the
    capturing thread only, as a capture in ``thread_local`` mode bars
    them (the drain thread may run meanwhile)."""
    capturing = threading.get_ident()

    def boom(what, orig=None):
        def f(*a, **k):
            if threading.get_ident() != capturing:
                return orig(*a, **k)
            raise AssertionError(f"{what} inside a captured part")
        return f

    as_tensor, getitem, setitem = (torch.as_tensor, torch.Tensor.__getitem__,
                                   torch.Tensor.__setitem__)

    def guarded_as_tensor(data, *a, **k):
        if threading.get_ident() != capturing:
            return as_tensor(data, *a, **k)
        if not isinstance(data, torch.Tensor):
            raise AssertionError("torch.as_tensor of host data inside a "
                                 "captured part")
        return as_tensor(data, *a, **k)

    def no_lists(idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        if any(isinstance(i, list) for i in idx):
            raise AssertionError("an index list inside a captured part")

    def guarded_getitem(self, idx):
        if threading.get_ident() == capturing:
            no_lists(idx)
        return getitem(self, idx)

    def guarded_setitem(self, idx, v):
        if threading.get_ident() != capturing:
            return setitem(self, idx, v)
        no_lists(idx)
        if not isinstance(v, torch.Tensor):
            raise AssertionError("a host value assigned into a tensor inside "
                                 "a captured part")
        return setitem(self, idx, v)

    with pytest.MonkeyPatch.context() as mp:
        for name in ("item", "__bool__", "cpu", "numpy", "tolist",
                     "__float__", "__int__", "__index__"):
            mp.setattr(torch.Tensor, name, boom(f"Tensor.{name}",
                                                getattr(torch.Tensor, name)))
        mp.setattr(torch.Tensor, "__getitem__", guarded_getitem)
        mp.setattr(torch.Tensor, "__setitem__", guarded_setitem)
        mp.setattr(torch, "as_tensor", guarded_as_tensor)
        mp.setattr(torch, "tensor", boom("torch.tensor", torch.tensor))
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


class _EmulatedCounts:
    """What ``graph.Graph`` does with the kernels' counts
    (``ops.kernel_counts``): the capture keeps its calls' difference
    (``counted``) and leaves the counts as they were; a replay adds that
    difference, whatever the part counts when it runs again."""

    def _capture(self, fn):
        before = kernel_counts.snapshot()
        with _host_read_guard():
            self.out = fn()
        self.counted = kernel_counts.diff(before)
        kernel_counts.restore(before)
        self.fn = fn

    def replay(self):
        before = kernel_counts.snapshot()
        _copy_out(self.out, self.fn())
        kernel_counts.restore(before)
        for name, n in self.counted.items():
            kernel_counts.add(name, n)


class _EmulatedGraph(_EmulatedCounts):
    """Stands in for ``graph.Graph`` on the CPU.  The capture runs the part
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
        self._capture(fn)
        for b, s in zip(bufs, snap):
            b.copy_(s)
        _EmulatedGraph.captured.append(name)


class _NoStream:
    def wait_stream(self, other):
        pass


def _counting(fn, name):
    """``fn`` (a kernel wrapper's plain version on the CPU) that counts its
    calls as ``ops.kernel_counts``'s ``name``, as the wrapper counts its
    launches."""

    def f(*a, **k):
        kernel_counts.add(name)
        return fn(*a, **k)

    return f


def emulate_capture(monkeypatch):
    """StepRunner on the CPU that captures, with ``_EmulatedGraph`` and
    no-op streams; the kernel wrappers count their (plain) calls.  Patches
    through ``monkeypatch`` (a ``pytest.MonkeyPatch``); returns
    ``_EmulatedGraph``."""
    monkeypatch.setattr(linalg, "inv_chol",
                        _counting(linalg.inv_chol, "k1_launches"))
    monkeypatch.setattr(level, "thin_gibbs_level", _counting(
        level.thin_gibbs_level, "k3_launches"))
    for f in ("thin_decision_level", "thin_decision_chains"):
        monkeypatch.setattr(level, f, _counting(
            getattr(level, f), "k4_launches"))

    class Runner(mt.StepRunner):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.capture = True
            _EmulatedGraph.runner = self

    _EmulatedGraph.captured = []
    monkeypatch.setattr(mt, "StepRunner", Runner)
    monkeypatch.setattr(graph, "Graph", _EmulatedGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _NoStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: _NoStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return _EmulatedGraph


@pytest.fixture
def emulated_capture(monkeypatch):
    """``emulate_capture`` for one test."""
    return emulate_capture(monkeypatch)
