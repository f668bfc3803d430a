"""The port's spans and counters: one record per call of an entry point.

``entry(name)`` wraps an entry point (``prepare_fit``, ``run_mcmc``,
``run_mcmc_chains``, ``spamtree_predict``) so that each call opens a
``Record``; once the call returns, the record joins a bounded history in
the process (``history()``, newest last, at most ``HISTORY`` records).
A call made inside another opens a record of its own.  Inside a call:

- ``span(name)`` adds the host seconds of its with-block
  (``time.perf_counter_ns``) and a count to the record; while the record
  is *active* it also opens a host range ``name`` in the profiler
  (``_range``), so that the span shows in the profiler's trace beside the
  device's events, on the profiler's clock.  The span's ``seconds`` hold
  its own reading after the block, inside a call or not;
- ``count(name, n)`` adds to a counter of the record;
- ``Record.device_span(name)`` (active records only) puts a pair of CUDA
  events on the current stream around a with-block that launches work,
  such as a graph replay, never inside a capture; a pair is read once both
  events have completed, without a sync, and at most ``MAX_PENDING``
  pairs wait at a time (past that the block runs untimed and the counter
  ``trace.device_spans_skipped`` says how often).

Active means that a ``torch.profiler`` was recording on the calling
thread when the call opened; it is read once per call.  An inactive call
pays, per span, a few microseconds, and per active-only site one bool
test.  A thread that works for a call (the drain thread of ``run_mcmc``)
writes into the call's record through ``adopt(record)``; the record is
safe to update from both.  The profiler records the ranges of the thread
that started it alone, so such a thread's spans reach the record but not
the trace.

Each record keeps, per span name, its seconds and count
(``seconds(name)``, ``calls(name)``), the seconds that its direct child
spans took on the thread that opened the call (``children_s(name)``;
``children_s(None)``: the call's top-level spans), its counters and the
device milliseconds of its device spans (``device_ms(name)``), and the
call's wall seconds (``wall_s``, once it has returned).
"""

from __future__ import annotations

import collections
import functools
import threading
import time

import torch

HISTORY = 16  # records kept, newest last
MAX_PENDING = 1024  # device spans waiting for their events at a time

_history: collections.deque = collections.deque(maxlen=HISTORY)
_history_lock = threading.Lock()


class _Local(threading.local):
    def __init__(self):
        self.rec = None  # the record this thread writes into
        self.open = []  # names of the spans open on this thread, in it


_tls = _Local()


def _profiling() -> bool:
    """Whether a profiler records on this thread."""
    return bool(torch._C._autograd._profiler_enabled())


def _event():
    return torch.cuda.Event(enable_timing=True)


def _range(name: str):
    """A host-only range of the profiler: ``torch.profiler.record_function``
    would also lay a GPU annotation over the device work launched inside
    it, which a trace's reader counts as device activity."""
    return torch._C._profiler._RecordFunctionFast(name)


class Record:
    """What one call measured (see the module's docstring)."""

    def __init__(self, name: str, active: bool):
        self.name = name
        self.active = active
        self.wall_s = None
        self.spans: dict = {}  # name -> [ns, count]
        self.children: dict = {}  # parent span name (None: top) -> ns
        self.counters: dict = {}
        self.device: dict = {}  # name -> [ms, count]
        self._owner = threading.get_ident()
        self._lock = threading.Lock()
        self._pending: collections.deque = collections.deque()
        self._spare: list = []  # events whose pair has been read
        self._t0 = time.perf_counter_ns()

    def _add(self, name, ns, parent):
        with self._lock:
            s = self.spans.get(name)
            if s is None:
                self.spans[name] = [ns, 1]
            else:
                s[0] += ns
                s[1] += 1
            if parent is not None or threading.get_ident() == self._owner:
                self.children[parent] = self.children.get(parent, 0) + ns

    def count(self, name: str, n=1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def seconds(self, name: str) -> float:
        return self.spans.get(name, (0, 0))[0] * 1e-9

    def calls(self, name: str) -> int:
        return self.spans.get(name, (0, 0))[1]

    def children_s(self, name) -> float:
        return self.children.get(name, 0) * 1e-9

    def counter(self, name: str, default=0):
        return self.counters.get(name, default)

    def device_ms(self, name: str) -> float:
        return self.device.get(name, (0.0, 0))[0]

    def device_span(self, name: str):
        return _DeviceSpan(self, name)

    def _read(self, wait: bool):
        """Add the device time of the pairs whose end has completed, oldest
        first (every pair with ``wait``, which syncs on each)."""
        q = self._pending
        while q:
            name, a, b = q[0]
            if wait:
                b.synchronize()
            elif not b.query():
                return
            q.popleft()
            d = self.device.setdefault(name, [0.0, 0])
            d[0] += a.elapsed_time(b)
            d[1] += 1
            self._spare += (a, b)

    def _close(self):
        self._read(wait=True)
        self._spare = []
        self.wall_s = (time.perf_counter_ns() - self._t0) * 1e-9


class _DeviceSpan:
    __slots__ = ("rec", "name", "pair")

    def __init__(self, rec: Record, name: str):
        self.rec, self.name, self.pair = rec, name, None

    def __enter__(self):
        rec = self.rec
        rec._read(wait=False)
        if len(rec._pending) >= MAX_PENDING:
            rec.count("trace.device_spans_skipped")
            return self
        spare = rec._spare
        a = spare.pop() if spare else _event()
        b = spare.pop() if spare else _event()
        a.record()
        self.pair = (a, b)
        return self

    def __exit__(self, *exc):
        if self.pair is not None:
            a, b = self.pair
            b.record()
            self.rec._pending.append((self.name, a, b))
        return False


class span:
    """A with-block's host seconds under ``name`` in the current record
    (see the module's docstring); ``seconds`` holds them afterwards."""

    __slots__ = ("name", "seconds", "_rec", "_parent", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self):
        rec = self._rec = _tls.rec
        if rec is not None:
            opened = _tls.open
            self._parent = opened[-1] if opened else None
            opened.append(self.name)
            self._range = None
            if rec.active:
                self._range = _range(self.name)
                self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        self.seconds = ns * 1e-9
        rec = self._rec
        if rec is not None:
            if self._range is not None:
                self._range.__exit__(*exc)
            _tls.open.pop()
            rec._add(self.name, ns, self._parent)
        return False


def current() -> Record | None:
    """The record this thread writes into (None outside any call)."""
    return _tls.rec


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` of the current record."""
    rec = _tls.rec
    if rec is not None:
        rec.count(name, n)


class adopt:
    """Let this thread write into ``rec`` (None: into no record) for the
    with-block: a thread that works for another thread's call."""

    def __init__(self, rec: Record | None):
        self.rec = rec

    def __enter__(self):
        self.saved = (_tls.rec, _tls.open)
        _tls.rec, _tls.open = self.rec, []
        return self.rec

    def __exit__(self, *exc):
        _tls.rec, _tls.open = self.saved
        return False


class call(adopt):
    """A new record ``name`` for the with-block, active if a profiler
    records on this thread; it joins the history at the block's end."""

    def __init__(self, name: str):
        super().__init__(Record(name, _profiling()))

    def __exit__(self, *exc):
        try:
            self.rec._close()
        finally:
            with _history_lock:
                _history.append(self.rec)
            super().__exit__(*exc)
        return False


def entry(name: str):
    """Decorate an entry point: each call runs inside ``call(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with call(name):
                return fn(*args, **kwargs)

        return run

    return wrap


def history() -> list:
    """The records of the calls that returned, oldest first."""
    with _history_lock:
        return list(_history)
