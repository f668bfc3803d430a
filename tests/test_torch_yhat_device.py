"""Each kept draw's yhat is built on the device (``mcmc._make_yhat_host``
over the run's device yhat generator) and streamed with w into the pinned
host ring, on the CPU.

* A collect-all run's yhat is X beta + w + tau z with z redrawn from
  ``make_yhat_rngs(ms, yhat_seed)[1]`` in draw order: one chain, two
  batched chains, thin 2.
* yhat is formed from the model dtype's w, never from the f16 wire.
* The call's record counts ``mcmc.yhat_device`` = keep x chains and has
  no host yhat span, in collect-all and subsampled summary runs.
* The benchmark's ``yhat_no_noise`` fault still takes the noise out.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from spamtree_tpu_torch import api
from spamtree_tpu_torch.model import mcmc as mt
from spamtree_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YSEED = 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=240, seed=9):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2))
    X = np.column_stack([np.ones(n), rng.normal(size=n)])
    mv = rng.integers(0, 2, size=n) + 1
    y = X @ np.array([0.5, -1.0]) + np.sin(5 * coords[:, 0]) \
        + 0.3 * rng.normal(size=n)
    y[rng.uniform(size=n) < 0.1] = np.nan
    return y, X, coords, mv


def _fit(keep=7, thin=1, dtype=torch.float64, **settings):
    y, X, coords, mv = _data()
    return api.prepare_fit(y, X, coords, mv_id=mv, cell_size=16, K=2, seed=3,
                           dtype=dtype, device="cpu",
                           mcmc=dict(keep=keep, burn=4, thin=thin),
                           settings=dict(chunk=3, **settings))


def _run(fit, chains=0, cfg=None):
    cfg = fit.cfg if cfg is None else cfg
    if not chains:
        return mt.run_mcmc(fit.ms, fit.bounds, cfg, fit.state, fit.gen,
                           yhat_seed=YSEED)
    states, gens = mt.stack_chain_states(fit.state, 50 + np.arange(chains))
    return mt.run_mcmc_chains(fit.ms, fit.bounds, cfg, states, gens,
                              yhat_seed=YSEED)


@pytest.mark.parametrize("chains,thin", [(0, 1), (2, 1), (0, 2)],
                         ids=["one_chain", "two_chains", "thin2"])
def test_yhat_is_xb_plus_w_plus_device_noise(chains, thin):
    fit = _fit(thin=thin, wire_dtype="none")
    res = _run(fit, chains)
    ms = fit.ms
    n = ms.n
    X = ms.X.cpu().numpy()
    mv = ms.mv[:n].cpu().numpy()
    gen = mt.make_yhat_rngs(ms, YSEED)[1]
    keep = fit.cfg.keep
    assert res["yhat"].shape == res["w"].shape == (
        (keep,) + ((chains,) if chains else ()) + (n,))
    for k in range(keep):
        z = torch.randn(((chains,) if chains else ()) + (n,), generator=gen,
                        dtype=ms.dtype).numpy()
        beta = res["beta"][k]  # (p, q), (C, p, q)
        xb = np.einsum("ip,...pi->...i", X, beta[..., mv])
        sd = np.sqrt(res["tausq"][k][..., mv])
        np.testing.assert_allclose(res["yhat"][k], xb + res["w"][k] + sd * z,
                                   rtol=1e-11, atol=1e-12)


def test_yhat_is_not_on_the_wire():
    """A float32 run ships w as f16, but its yhat is formed on the device
    from the float32 w: the same bits as the full-precision wire's run."""
    rf = _run(_fit(dtype=torch.float32, wire_dtype="none"))
    rh = _run(_fit(dtype=torch.float32))
    assert rh["yhat"].dtype == np.float32
    assert np.array_equal(rh["yhat"], rf["yhat"])
    assert not np.array_equal(rh["w"], rf["w"])  # the wire rounded w


@pytest.mark.parametrize("chains,collect", [
    (0, "all"), (2, "all"), (0, "summary"), (2, "summary")])
def test_record_counts_device_yhat(chains, collect):
    fit = _fit()
    cfg = fit.cfg._replace(collect=collect, summary_draws=3)
    res = _run(fit, chains, cfg)
    rec = [r for r in trace.history()
           if r.name == ("run_mcmc_chains" if chains else "run_mcmc")][-1]
    assert rec.counter("mcmc.yhat_device") == cfg.keep * max(chains, 1)
    assert rec.calls("mcmc.drain.yhat") == 0
    assert rec.calls("mcmc.drain") == rec.counter("mcmc.chunks") == 3
    assert np.isfinite(res["yhat"]).all() and res["yhat"].shape[0] > 0


def test_planted_yhat_no_noise_zeroes_the_noise(monkeypatch):
    """The benchmark's ``yhat_no_noise`` fault rebinds ``_make_yhat_host``
    with an rng of numpy zeros: yhat - X beta - w reads 0."""
    monkeypatch.setattr(mt, "_make_yhat_host", mt._make_yhat_host)
    monkeypatch.setattr(api, "spamtree_predict", api.spamtree_predict)
    spec = importlib.util.spec_from_file_location(
        "bench_control", os.path.join(ROOT, "benchmark", "control.py"))
    control = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(control)
    control.plant("yhat_no_noise")
    fit = _fit(wire_dtype="none")
    res = _run(fit)
    X = fit.ms.X.cpu().numpy()
    mv = fit.ms.mv[:fit.ms.n].cpu().numpy()
    xb = np.einsum("ip,kpi->ki", X, res["beta"][..., mv])
    np.testing.assert_allclose(res["yhat"] - xb - res["w"], 0.0, atol=1e-12)
