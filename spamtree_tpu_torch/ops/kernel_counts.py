"""The hand-written kernels' counts, by name: the one list of them.

``k1_launches``, ``k3_launches`` and ``k4_launches`` count the launches of
kernels K1 (``chol.inv_chol``), K3 (``level.thin_gibbs_level``) and K4
(``level.thin_decision_partials``); their plain versions count none.
``k1_blocks`` and ``plain_blocks`` count the blocks factorised through
``ops.linalg`` by route: K1 on a CUDA tensor, else the plain route
(``cholesky_ex``, and every CPU tensor); ``k1_wide_blocks`` counts those of
K1's blocks that its 128-thread form factorised (96 < S <= 128), which
``k1_blocks`` counts too.

A wrapper adds to its own names where it launches (``add``).  A reader
takes a ``snapshot`` and later the ``diff`` since it.  A captured CUDA
graph (``model.graph.Graph``) restores the snapshot taken before its
capture and adds the capture's diff on each replay, whatever names there
are, so graphed and eager runs count alike.  ``trace_blocks`` puts the
block counts of its with-block into the current trace record.

The counts are the process's own: callers read differences.
"""

from __future__ import annotations

import contextlib

from spamtree_tpu_torch.utils import trace

_counts = dict.fromkeys(("k1_launches", "k3_launches", "k4_launches",
                         "k1_blocks", "k1_wide_blocks", "plain_blocks"), 0)
# the names ``trace_blocks`` adds to the trace record, under these names
# (``benchmark/metrics/k1_block_share.py`` reads two of them)
_TRACED = {"k1_blocks": "ops.chol.k1_blocks",
           "k1_wide_blocks": "ops.chol.k1_wide_blocks",
           "plain_blocks": "ops.chol.plain_blocks"}


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to the count ``name`` (a KeyError for a name not listed)."""
    _counts[name] += n


def snapshot() -> dict:
    """{name: count} of every name, now."""
    return dict(_counts)


def restore(snap: dict) -> None:
    """Set every count to its value in ``snap``."""
    _counts.update(snap)


def diff(before: dict) -> dict:
    """{name: count now - its value in the snapshot ``before``}."""
    return {k: v - before[k] for k, v in _counts.items()}


@contextlib.contextmanager
def trace_blocks():
    """Add the blocks factorised inside the with-block to the current trace
    record, by route: ``ops.chol.k1_blocks`` (of which
    ``ops.chol.k1_wide_blocks``) and ``ops.chol.plain_blocks`` (zero
    included)."""
    before = snapshot()
    try:
        yield
    finally:
        d = diff(before)
        for name, key in _TRACED.items():
            trace.count(key, d[name])
