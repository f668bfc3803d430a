"""The port's diagnostics: ``core.quad_loglik`` against the JAX package's
on the same model, factors and w (float64, rtol 1e-10: the same sums of
the same products), and ``utils.diagnostics`` on the CPU -- every row of
the JAX package's phase table from ``time_phases``, for one chain and for
a chain-batched state, and a Chrome trace from ``trace_profile``."""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spamtree_tpu.model import core as cj
from spamtree_tpu.utils import diagnostics as diagnostics_jax
from spamtree_tpu_torch.api import prepare_fit
from spamtree_tpu_torch.model import core as ct
from spamtree_tpu_torch.utils.diagnostics import time_phases, trace_profile
from test_e2e import _sim_univariate
from test_torch_core import CASES, _models, _theta

ROWS = ("sweep(theta-loglik)", "sweep_fused(+quad x2)", "quad_loglik",
        "gibbs_w", "predict", "gibbs_tausq", "gibbs_beta", "total_per_iter")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CASES)
def test_quad_loglik_matches_jax(case):
    """The JAX sweep's factors at one theta, and one w: both packages'
    quad_loglik of them agree, and so does the port's of its own sweep
    (rtol 1e-9 there: the factorisations differ in rounding)."""
    ms_j, ms_t, rng = _models(case)
    th = _theta(case, ms_t.q, rng)
    w = np.append(rng.normal(size=ms_t.n), 0.0)

    def run(m, th, w):
        ld = cj.sweep(m, th, w)[0]
        return ld, cj.quad_loglik(m, ld, w)

    ms_j.materialize_device()
    ld_j, q_j = jax.tree.map(np.asarray, jax.jit(run)(
        ms_j, jnp.asarray(th), jnp.asarray(w)))
    ld_t = tuple(ct.LevelData(torch.tensor(d.H), torch.tensor(d.prec))
                 for d in ld_j)
    w_t = torch.as_tensor(w)
    got = float(ct.quad_loglik(ms_t, ld_t, w_t))
    np.testing.assert_allclose(got, float(q_j), rtol=1e-10)
    own = ct.sweep(ms_t, torch.as_tensor(th), w_t)[0]
    np.testing.assert_allclose(float(ct.quad_loglik(ms_t, own, w_t)),
                               float(q_j), rtol=1e-9)


@pytest.mark.parametrize("n_chains", [1, 2])
def test_time_phases_gives_the_jax_table(n_chains):
    """Every row of the JAX package's table, each a positive time, for a
    prepared state of one chain or of two."""
    src = inspect.getsource(diagnostics_jax.time_phases)
    assert all(f'"{r}"' in src for r in ROWS)
    coords, X, y, *_ = _sim_univariate(SS=9)
    fit = prepare_fit(y, X, coords, mcmc=dict(keep=1, burn=0),
                      n_chains=n_chains, dtype=torch.float64, device="cpu")
    out = time_phases(fit.ms, fit.state, iters=2)
    assert set(out) == set(ROWS)
    assert all(np.isfinite(v) and v > 0 for v in out.values())


def test_trace_profile_writes_a_chrome_trace(tmp_path):
    coords, X, y, *_ = _sim_univariate(SS=9)
    fit = prepare_fit(y, X, coords, mcmc=dict(keep=1, burn=0),
                      dtype=torch.float64, device="cpu")
    logdir = str(tmp_path / "trace")
    (_, _, logdet, ok), prof = trace_profile(
        ct.sweep, (fit.ms, fit.state.theta, fit.state.w), logdir)
    assert bool(ok) and torch.isfinite(logdet)
    assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0
    assert any("einsum" in e.key for e in prof.key_averages())
