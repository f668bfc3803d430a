"""Checkpoint and resume of the port (``utils/checkpoint.py``,
``spamtree(checkpoint_path=, resume_from=, sink_dir=)``), mirroring
tests/test_e2e.py's resume tests on the port's own geometry: the last
chunk runs only the kept samples still missing, so the iteration counts
are the port's, not the JAX package's.  Every generator is checkpointed,
so a resumed chain -- yhat included -- equals the uninterrupted one bit
for bit."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import spamtree_tpu_torch
from spamtree_tpu.utils.checkpoint import save_state as save_state_jax
from spamtree_tpu_torch.model import mcmc as mt
from spamtree_tpu_torch.utils import checkpoint
from spamtree_tpu_torch.utils.native import read_sink
from test_collect_wire import _data
from test_e2e import _sim_univariate

KEYS = ("w_mcmc", "yhat_mcmc", "beta_mcmc", "tausq_mcmc", "theta_mcmc")


# the models here are small: one intra-op thread runs them as fast, and
# keeps test files run in parallel processes from oversubscribing the cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fit(mcmc, **kw):
    coords, X, y = _sim_univariate(SS=9)[:3]
    kw = dict(dtype=torch.float64, seed=13, settings=dict(chunk=10),
              device="cpu") | kw
    return spamtree_tpu_torch.spamtree(y, X, coords, mcmc=mcmc, **kw)


def _fit_model():
    """The model of ``_fit``'s runs (prepare_fit's, without the chain)."""
    from spamtree_tpu_torch.api import prepare_fit

    coords, X, y = _sim_univariate(SS=9)[:3]
    return prepare_fit(y, X, coords, mcmc=dict(keep=1, burn=0),
                       dtype=torch.float64, seed=13, device="cpu").ms


def _same(a, b, sl=slice(None)):
    """a's draws equal b's draws ``sl``, bit for bit, in each output's
    layout: w/yhat (keep, n), beta (p, keep, q), tausq/theta (k, keep)."""
    for k in KEYS:
        want = b[k][sl] if k in ("w_mcmc", "yhat_mcmc") else b[k][:, sl]
        assert np.array_equal(a[k], want), k


def test_resume_after_keep_is_bit_identical(tmp_path):
    """Run A keeps 30 of 60 with checkpoints, run B resumes with the same
    knobs and returns the other 30: A + B equal an uninterrupted run."""
    full = _fit(dict(keep=60, burn=20))
    ck = str(tmp_path / "ck.npz")
    part = _fit(dict(keep=30, burn=20), checkpoint_path=ck)
    res = _fit(dict(keep=60, burn=20), resume_from=ck)
    assert res["resumed_at_iteration"] == 20 + 30
    assert res["resumed_kept_already"] == 30
    assert res["burn_actual"] == 0 and res["w_mcmc"].shape[0] == 30
    _same(part, full, slice(0, 30))
    _same(res, full, slice(30, 60))


def test_resume_mid_burn_is_bit_identical(tmp_path):
    """A keep=0 run that did 10 of 30 burn iterations resumes into the
    remaining 20 and the keeps; a keep=0 resume extends the burn."""
    full = _fit(dict(keep=20, burn=30))
    ck = str(tmp_path / "ck_burn.npz")
    _fit(dict(keep=0, burn=10), checkpoint_path=ck)
    res = _fit(dict(keep=20, burn=30), resume_from=ck)
    assert res["resumed_at_iteration"] == 10
    assert res["resumed_kept_already"] == 0 and res["burn_actual"] == 20
    _same(res, full)
    r0 = _fit(dict(keep=0, burn=20), resume_from=ck, checkpoint_path=ck)
    assert r0["resumed_at_iteration"] == 10 and r0["burn_actual"] == 10
    with np.load(ck) as z:
        assert int(z["it"]) == 20
        assert tuple(z["geom_counts"]) == (10, 20, 0, 1)


def test_resume_repins_original_chunk_size(tmp_path):
    """keep=10 at chunk=4 is mc=4 (chunks 4, 4, 2) and burn 10 rounds to
    12; a resume after 4 keeps pins mc=4 (the 6 left alone would balance
    to 3), and a resume that raises keep runs on the writing run's grid."""
    kw = dict(seed=31, settings=dict(chunk=4))
    full = _fit(dict(keep=10, burn=10), **kw)
    assert full["burn_actual"] == 12
    ck = str(tmp_path / "ck.npz")
    _fit(dict(keep=4, burn=10), checkpoint_path=ck, **kw)
    res = _fit(dict(keep=10, burn=10), resume_from=ck, **kw)
    assert res["resumed_kept_already"] == 4
    _same(res, full, slice(4, 10))
    # keep=6/chunk=4 -> mc=3, burn 6; keep=12 resumes on the mc=3 grid,
    # as an uninterrupted run at chunk=3 (at chunk=4 its burn would be 8)
    ck2 = str(tmp_path / "ck2.npz")
    _fit(dict(keep=6, burn=6), checkpoint_path=ck2, seed=37,
         settings=dict(chunk=4))
    res2 = _fit(dict(keep=12, burn=6), resume_from=ck2, seed=37,
                settings=dict(chunk=4))
    full2 = _fit(dict(keep=12, burn=6), seed=37, settings=dict(chunk=3))
    assert res2["resumed_kept_already"] == 6 and res2["w_mcmc"].shape[0] == 6
    _same(res2, full2, slice(6, 12))


def test_chained_resume_counts_survive(tmp_path):
    """A burn-extension resume asking for fewer keeps than taken keeps the
    true kept_done and the writing run's mc; the next resume counts from
    them (tests/test_e2e.py::test_resume_chained_counts_survive)."""
    kw = dict(seed=43)
    ck = str(tmp_path / "ck.npz")
    _fit(dict(keep=10, burn=4), settings=dict(chunk=5), checkpoint_path=ck,
         **kw)
    assert checkpoint.load_counts(ck) == (5, 5, 10, 1)
    r1 = _fit(dict(keep=6, burn=15), settings=dict(chunk=3), resume_from=ck,
              checkpoint_path=ck, **kw)
    assert r1["burn_actual"] == 10 and r1["w_mcmc"].shape[0] == 0
    assert checkpoint.load_counts(ck) == (5, 15, 10, 1)
    r2 = _fit(dict(keep=12, burn=15), settings=dict(chunk=3), resume_from=ck,
              **kw)
    assert r2["resumed_kept_already"] == 10 and r2["burn_actual"] == 0
    assert r2["w_mcmc"].shape[0] == 2 and np.isfinite(r2["w_mcmc"]).all()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """A collect-all checkpoint after 30 of 60 kept draws, and a JAX
    package's checkpoint of the same state."""
    d = tmp_path_factory.mktemp("ck")
    ck = str(d / "ck.npz")
    _fit(dict(keep=30, burn=20), checkpoint_path=ck)
    # the JAX package's save_state on a state with its field names: a
    # JAX checkpoint's layout (an RNG key, no generator state)
    st = checkpoint.load_state(ck, _fit_model())
    ckj = str(d / "ck_jax.npz")
    save_state_jax(ckj, SimpleNamespace(key=np.zeros(2, np.uint32),
                                        **st._asdict()))
    return ck, ckj


@pytest.mark.parametrize("case", ["nothing_to_resume", "thin", "summary",
                                  "jax_checkpoint"])
def test_resume_errors(written, case):
    """The resume path refuses what it cannot continue exactly: every
    requested draw already taken, another thin, a summary continuation of
    draws whose moments were never saved, and a JAX checkpoint (its key
    cannot seed torch generators)."""
    ck, ckj = written
    s10 = dict(chunk=10)
    mcmc, settings, path, match = dict(
        nothing_to_resume=(dict(keep=30, burn=20), s10, ck,
                           "nothing to resume"),
        thin=(dict(keep=60, burn=20, thin=2), s10, ck, "thin"),
        summary=(dict(keep=60, burn=20), s10 | dict(collect="summary"), ck,
                 "no moment accumulators"),
        jax_checkpoint=(dict(keep=60, burn=20), s10, ckj, "JAX package"),
    )[case]
    with pytest.raises(ValueError, match=match):
        _fit(mcmc, resume_from=path, settings=settings)


def test_resume_sink_append(tmp_path):
    """A resumed run with the same sink_dir appends: the sink files end up
    those of an uninterrupted run, bit for bit, and read back whole."""
    n = 81
    ck, sd, sf = (str(tmp_path / x) for x in ("ck.npz", "sink", "sink_full"))
    full = _fit(dict(keep=20, burn=10), sink_dir=sf)
    assert full["w_mcmc"].size == 0  # the draws went to the sink
    _fit(dict(keep=10, burn=10), checkpoint_path=ck, sink_dir=sd)
    _fit(dict(keep=20, burn=10), resume_from=ck, sink_dir=sd)
    for name in ("w_mcmc.f32", "yhat_mcmc.f32"):
        got = np.fromfile(os.path.join(sd, name), dtype=np.float32)
        want = np.fromfile(os.path.join(sf, name), dtype=np.float32)
        assert got.size == 20 * n and np.array_equal(got, want), name
    assert read_sink(os.path.join(sd, "w_mcmc.f32"), n).shape == (20, n)


def test_summary_resume_continues_moments(tmp_path):
    """An interrupted collect="summary" run resumes its saved partial sums:
    the final moments equal the uninterrupted run's exactly; a mid-burn
    checkpoint of a collect-all run may continue as a summary run."""
    sset = dict(wire_dtype="none", collect="summary", chunk=4)
    kw = dict(cell_size=16, K=2, seed=7, device="cpu", dtype=torch.float64,
              settings=sset)
    run = lambda mcmc, **k: spamtree_tpu_torch.spamtree(
        *_data(), mcmc=mcmc, **(kw | k))
    full = run(dict(keep=12, burn=4))
    ck = str(tmp_path / "ck.npz")
    half = run(dict(keep=8, burn=4), checkpoint_path=ck)
    res = run(dict(keep=12, burn=4), resume_from=ck)
    assert half["summary_count"] == 8 and res["resumed_kept_already"] == 8
    assert res["summary_count"] == 12
    for k in ("w_mean", "w_var", "yhat_mean", "yhat_var"):
        np.testing.assert_array_equal(res[k], full[k], err_msg=k)
    ck2 = str(tmp_path / "ck2.npz")
    run(dict(keep=0, burn=4), checkpoint_path=ck2,
        settings=dict(wire_dtype="none", chunk=4))
    r = run(dict(keep=4, burn=4), resume_from=ck2)
    assert r["summary_count"] == 4


def test_load_state_rebuilds_the_carried_state(tmp_path):
    """save_state then load_state: the sweep on load rebuilds the factors,
    prediction operators and Gram blocks the chain carried, bit for bit,
    and the generators continue where they stood."""
    from spamtree_tpu_torch.api import prepare_fit
    from spamtree_tpu_torch.utils.convert import model_state_to_numpy

    coords, X, y = _sim_univariate(SS=9)[:3]
    fit = prepare_fit(y, X, coords, mcmc=dict(keep=8, burn=6), seed=3,
                      dtype=torch.float64, device="cpu",
                      settings=dict(chunk=4))
    res = mt.run_mcmc(fit.ms, fit.bounds, fit.cfg, fit.state, fit.gen)
    st = res["state"]
    rngs = mt.make_yhat_rngs(fit.ms, 5)
    p = str(tmp_path / "ck")  # .npz is appended, as np.savez does
    checkpoint.save_state(p, st, fit.gen, rngs, counts=(4, 8, 8, 1))
    st2 = checkpoint.load_state(p + ".npz", fit.ms)
    gen2, (host2, dev2) = checkpoint.load_rngs(p + ".npz", "cpu")
    a, b = model_state_to_numpy(st), model_state_to_numpy(st2)

    def eq(x, y, what):
        if isinstance(x, dict):
            for k in x:
                eq(x[k], y[k], f"{what}.{k}")
        elif isinstance(x, (list, tuple)):
            assert len(x) == len(y), what
            for i, (u, v) in enumerate(zip(x, y)):
                eq(u, v, f"{what}[{i}]")
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), what

    eq(a, b, "state")
    assert torch.equal(torch.randn(5, generator=fit.gen),
                       torch.randn(5, generator=gen2))
    assert torch.equal(torch.randn(5, generator=rngs[1]),
                       torch.randn(5, generator=dev2))
    assert np.array_equal(rngs[0].standard_normal(5),
                          host2.standard_normal(5))
