"""``spamtree_predict``'s draws through ``model.predict.DrawRunner``, on the
CPU.

CUDA graphs run only on the card, so these tests hold what the graph
captures: one ``predict_recompute`` over static theta, w and z buffers,
z filled outside in draw order.

* With graphs on (plain calls on the CPU) the runner gives the eager
  loop's ``w_pred`` bit for bit, f64 and f32, on a full and a limited
  tree, for a chunk of 1, 3 and every draw; ``spamtree_predict`` gives the
  same draws.
* The same with the capture emulated: the first draw eager, the capture
  under the host-read guard of ``tests/_graph_capture.py``, then
  replays whose outputs land in the captured tensor; K1 is called as often
  per draw as on the eager loop.
* Given the z that the JAX package's compiled chunk draws for each draw
  (``jax.random.fold_in`` of the root key by the draw's index), the
  runner's draws equal a jitted ``lax.scan`` of the JAX package's
  ``predict_recompute`` at rtol 1e-8 in f64.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spamtree_tpu_torch
from _graph_capture import _counting, _EmulatedCounts, _NoStream
from spamtree_tpu.model import core as cj
from spamtree_tpu_torch import api
from spamtree_tpu_torch.model import graph
from spamtree_tpu_torch.model import predict as pr
from spamtree_tpu_torch.ops import kernel_counts
from test_torch_predict import THETA, _models


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=400, seed=21):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2))
    X = np.column_stack([np.ones(n), rng.normal(size=n)])
    mv = rng.integers(0, 2, size=n) + 1
    y = X @ np.array([0.5, -1.0]) + np.sin(5 * coords[:, 0]) * mv \
        + 0.2 * rng.normal(size=n)
    held = rng.uniform(size=n) < 0.15
    return coords, X, mv, y, held


_FITS = {}


def _stage(limited, dtype, n_draws=7):
    """A small fit (keep=8) on the observed rows and the prediction staged
    at the held rows."""
    coords, X, mv, y, held = _data()
    obs = ~held
    args = (y[obs], X[obs], coords[obs])
    key = (limited, dtype)
    if key not in _FITS:
        _FITS[key] = spamtree_tpu_torch.spamtree(
            *args, mv_id=mv[obs], cell_size=16, K=2, seed=4, dtype=dtype,
            device="cpu", limited_tree=limited,
            mcmc=dict(keep=8, burn=4, thin=1))
    kw = dict(coords_new=coords[held], x_new=X[held], mv_id=mv[obs],
              mv_id_new=mv[held], n_draws=n_draws)
    return (_FITS[key], args, kw,
            api.stage_predict(_FITS[key], *args, device="cpu", **kw))


def _runner(st, graphs):
    return pr.DrawRunner(st.ms, st.theta_draws.shape[1], st.new_pos, st.cc,
                         graphs=graphs)


TREES = [(False, torch.float64), (True, torch.float64),
         (False, torch.float32), (True, torch.float32)]
TREE_IDS = ["full_f64", "limited_f64", "full_f32", "limited_f32"]


@pytest.mark.parametrize("limited,dtype", TREES, ids=TREE_IDS)
def test_graphed_draws_equal_eager_loop(limited, dtype):
    """The runner with graphs on (its static buffers, plain calls on the
    CPU) against the eager loop, bit for bit, whatever the chunk (1, 3,
    all 7 draws); spamtree_predict draws the same."""
    fit, args, kw, st = _stage(limited, dtype)
    assert st.ms.pred_arrays is not None and st.ms.dtype == dtype
    eager = api.predict_draws(st, _runner(st, False), seed=2, chunk=32)
    assert eager.shape == (7, len(st.new_pos)) and np.isfinite(eager).all()
    for chunk in (1, 3, 7):
        got = api.predict_draws(st, _runner(st, True), seed=2, chunk=chunk)
        assert np.array_equal(got, eager), chunk
    pred = spamtree_tpu_torch.spamtree_predict(fit, *args, seed=2, chunk=3,
                                               device="cpu", **kw)
    assert np.array_equal(pred["w_pred"], eager)
    assert pred["predict_breakdown"]["capture_s"] == 0.0


class _EmulatedDrawGraph(_EmulatedCounts):
    """Stands in for ``graph.Graph`` in ``model.predict``: the capture
    runs the draw under ``_host_read_guard`` with the kernels' counts
    left as they were; a replay runs it again, copies its output into
    the captured one and adds what the capture counted."""

    captured = 0

    def __init__(self, name, fn, pool, stream, what=""):
        self._capture(fn)
        _EmulatedDrawGraph.captured += 1


@pytest.fixture
def emulated_draw_capture(monkeypatch):
    from spamtree_tpu_torch.ops import linalg

    monkeypatch.setattr(linalg, "inv_chol",
                        _counting(linalg.inv_chol, "k1_launches"))
    monkeypatch.setattr(graph, "Graph", _EmulatedDrawGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _NoStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: _NoStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _EmulatedDrawGraph.captured = 0
    return _EmulatedDrawGraph


@pytest.mark.parametrize("limited", [False, True], ids=["full", "limited"])
def test_emulated_capture_equals_eager_loop(limited, emulated_draw_capture):
    """First draw eager, one capture with no host read inside, replays
    (``_EmulatedDrawGraph``) against the eager loop, bit for bit, f64; K1
    called as often on both (on a full tree several reference levels a
    draw, every level up to the prediction parent)."""
    _, _, _, st = _stage(limited, torch.float64)
    out, k1, runners = [], [], []
    for graphs in (False, True):
        r = _runner(st, graphs)
        r.capture = graphs
        before = kernel_counts.snapshot()
        out.append(api.predict_draws(st, r, seed=2, chunk=4))
        k1.append(kernel_counts.diff(before)["k1_launches"])
        runners.append(r)
    assert np.array_equal(out[0], out[1])
    assert emulated_draw_capture.captured == 1
    assert runners[1].replays == 6 and runners[1].graph is not None
    levels = 1 if limited else st.ms.pred_lp + 1
    assert k1[0] == k1[1] == 7 * levels, k1
    assert limited or levels > 1


@pytest.mark.parametrize("limited", [False, True], ids=["full", "limited"])
def test_runner_draws_match_jax_chunk(limited):
    """Four draws through the runner (graphs on), z from the keys that the
    JAX package's chunk gives draws 0-3 (``fold_in(PRNGKey(5), i)``, drawn
    as its ``predict_recompute`` draws them), against a jitted
    ``lax.scan`` of the JAX ``predict_recompute`` over the same theta, w
    and keys: rtol 1e-8, f64."""
    ms_j, ms_t = _models(limited)
    rng = np.random.default_rng(8)
    S, n = 4, ms_t.n
    thetas = THETA * np.exp(0.05 * rng.normal(size=(S, len(THETA))))
    ws = rng.normal(size=(S, n + 1))
    ws[:, n] = 0.0
    root = jax.random.PRNGKey(5)
    keys = jax.vmap(lambda i: jax.random.fold_in(root, i))(jnp.arange(S))

    @jax.jit
    def chunk(thetas, ws, keys):
        def body(_, a):
            th, w0, k = a
            return None, cj.predict_recompute(ms_j, th, w0, k)
        return jax.lax.scan(body, None, (thetas, ws, keys))[1]

    want = np.asarray(chunk(jnp.asarray(thetas), jnp.asarray(ws), keys))
    r = pr.DrawRunner(ms_t, len(THETA), np.arange(n + 1), graphs=True)
    for i in range(S):
        z = torch.as_tensor(np.array(jax.random.normal(
            keys[i], (n + 1,), dtype=jnp.float64)))
        got = r.draw(torch.as_tensor(thetas[i]), torch.as_tensor(ws[i]),
                     lambda buf: buf.copy_(z)).numpy()
        np.testing.assert_allclose(got, want[i], rtol=1e-8,
                                   atol=1e-8 * np.abs(want[i]).max())
        assert not np.array_equal(got, ws[i])
