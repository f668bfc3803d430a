"""Multi-device sampling of the PyTorch package over torch.distributed.

The port's counterpart of tests/test_sharding.py, one case for each of
its eight, at its sizes (n = 240, q = 2, float64, axis_cell_size = 4), on
gloo ranks on the CPU: at most four per group (the JAX tests use eight
virtual devices), each a worker process of ``parallel.launch`` running a
job of tests/_sharding_jobs.py.  They pin (a) whole dummy blocks added for
a blocks axis leave every output as it was, and as the JAX package's
padded model gives; (b) the sharded step is the unsharded step -- full
and limited tree, always-emit and accept-aware (the plain K3/K4 versions
per shard), and two chains' batched accept-aware steps on a (1, 2)
mesh -- at the JAX package's rtol 1e-10; (c) chains over ranks are
the unsharded batched chains, (d) the public ``spamtree(devices=...)``
equals the unsharded call at rtol 1e-9, resumes bit for bit and sums the
same moments; (e) a failing worker raises in the caller, never hangs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _sharding_jobs as J
from spamtree_tpu.model import core as cj
from spamtree_tpu.model.params import make_theta_spec
from spamtree_tpu.tree.partition import make_tree as make_tree_jax
from spamtree_tpu.tree.schedule import build_schedule as build_schedule_jax
from spamtree_tpu_torch.api import spamtree
from spamtree_tpu_torch.model import core as ct
from spamtree_tpu_torch.model.mcmc import MCMCConfig, init_state
from spamtree_tpu_torch.parallel.launch import launch

HERE = os.path.dirname(os.path.abspath(__file__))
F64 = torch.float64
TIMEOUT = 120.0  # seconds any one launch may take before it is killed


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread here and in every worker: several groups of
    workers may share the machine with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


def _launch(job, mesh=(1, 4), **kwargs):
    value, _ = launch(f"_sharding_jobs:{job}", kwargs,
                      ["cpu"] * (mesh[0] * mesh[1]), n_chains=mesh[0],
                      timeout=TIMEOUT, path=[HERE])
    return value


def _close(got, ref, rtol=1e-10, atol=1e-12, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


def _same_step(got, ref):
    _close(got["w"], ref["w"], what="w")
    _close(got["theta"], ref["theta"], atol=0, what="theta")
    _close(got["logdetCi"], ref["logdetCi"], atol=0, what="logdetCi")
    _close(got["beta"], ref["beta"], what="beta")
    assert got["accept"] == ref["accept"]
    assert len(got["leveldata"]) == len(ref["leveldata"])
    for t, (a, b) in enumerate(zip(got["leveldata"], ref["leveldata"])):
        _close(a[0], b[0], what=f"H[{t}]")
        _close(a[1], b[1], what=f"prec[{t}]")


# -- (a) padding, no processes ---------------------------------------------


def test_block_multiple_padding_parity():
    """Whole dummy blocks added for even sharding change no sampler output
    (identity padding and masks make them inert): three steps, the first
    two accepted, at block_multiple 4 against 1."""
    ms1, tspec = J.model(block_multiple=1)
    ms4, _ = J.model(block_multiple=4)
    assert any(a.rows.shape[0] != b.rows.shape[0]
               for a, b in zip(ms1.levels, ms4.levels))
    out1, out4 = J.steps(ms1, tspec), J.steps(ms4, tspec)
    assert float(out1.ram.accept_count) > 0
    _close(out4.w, out1.w, what="w")
    _close(out4.theta, out1.theta, atol=0, what="theta")
    _close(out4.logdetCi, out1.logdetCi, atol=0, what="logdetCi")


def test_gibbs_w_padding_parity():
    """gibbs_w alone (the message-routing hot path) under block padding,
    with the Gram blocks carried and formed in place."""
    ms1, tspec = J.model(block_multiple=1)
    ms4, _ = J.model(block_multiple=4)
    s1 = init_state(ms1, tspec.bounds, tspec.start)
    s4 = init_state(ms4, tspec.bounds, tspec.start)
    z = torch.randn(ms1.n + 1, generator=torch.Generator().manual_seed(11),
                    dtype=F64)
    for gram in (True, False):
        kw = lambda s: (dict(gram=s.gram[0], routed=s.gram[1]) if gram
                        else {})
        w1 = ct.gibbs_w(ms1, s1.leveldata, s1.w, s1.tausq_inv, s1.XB, z,
                        **kw(s1))
        w4 = ct.gibbs_w(ms4, s4.leveldata, s4.w, s4.tausq_inv, s4.XB, z,
                        **kw(s4))
        _close(w4, w1, what=f"gibbs_w gram={gram}")


def test_padded_sweep_and_gibbs_w_match_jax():
    """The port's sweep (quadratic forms, every level's factors, the
    prediction joint) and gibbs_w at block_multiple=4 equal the JAX
    package's at block_multiple=4 on the same inputs and the same z."""
    coords, na, mv, y, X, rng = J.data()
    tree = make_tree_jax(coords, na, mv, axis_cell_size=4, K=2, rng=rng)
    spec = make_theta_spec(2, 2)
    ms_j = cj.ModelStatic(build_schedule_jax(tree), coords, mv, y, X,
                          spec.spec, dtype=jnp.float64, block_multiple=4)
    ms_t, _ = J.model(block_multiple=4)
    for a, b in zip(ms_t.levels + ms_t.pred_arrays,
                    ms_j.levels + ms_j.pred_arrays):
        for x, x_j in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(x_j))
    th0 = np.asarray(spec.start)
    th1 = th0 * np.random.default_rng(1).uniform(0.95, 1.05, th0.shape)
    r = np.random.default_rng(2)
    w = np.append(r.normal(size=ms_t.n), 0.0)
    tinv = r.uniform(2.0, 8.0, size=2)
    XB = np.append(0.3 * r.normal(size=ms_t.n), 0.0)
    key = jax.random.PRNGKey(7)

    def run(m, th0, th1, w, tinv, XB):
        ld0, _, _, _ = cj.sweep(m, th0, w)
        ld1, pj1, lg1, ok1, qn1, qc1 = cj.sweep(
            m, th1, w, quad_prev=ld0, emit_pred_joint=True)
        return dict(ld0=ld0, ld1=ld1, pj1=pj1, lg1=lg1, ok1=ok1, qn1=qn1,
                    qc1=qc1, w=cj.gibbs_w(m, ld0, w, tinv, XB, key),
                    z=jax.random.normal(key, w.shape, dtype=w.dtype))

    ms_j.materialize_device()
    ref = jax.tree.map(np.asarray, jax.jit(run)(
        ms_j, *(jnp.asarray(a) for a in (th0, th1, w, tinv, XB))))
    assert bool(ref["ok1"])
    T = lambda a: torch.as_tensor(np.asarray(a))
    ld0 = tuple(ct.LevelData(T(d.H), T(d.prec)) for d in ref["ld0"])
    ld1, pj1, lg1, ok1, qn1, qc1 = ct.sweep(
        ms_t, T(th1), T(w), quad_prev=ld0, emit_pred_joint=True)
    assert bool(ok1)
    for got, key_ in ((lg1, "lg1"), (qn1, "qn1"), (qc1, "qc1"),
                      (pj1, "pj1")):
        _close(got, ref[key_], atol=1e-10, what=key_)
    for t, (a, b) in enumerate(zip(ld1, ref["ld1"])):
        _close(a.H, b.H, atol=1e-10, what=f"H[{t}]")
        _close(a.prec, b.prec, atol=1e-10, what=f"prec[{t}]")
    w_t = ct.gibbs_w(ms_t, ld0, T(w), T(tinv), T(XB), T(ref["z"]))
    _close(w_t, ref["w"], atol=1e-10, what="gibbs_w")


# -- (b) the sharded step ---------------------------------------------------


@pytest.fixture(scope="module")
def sharded_steps():
    """Every step case on one (1, 4) mesh, in one launch."""
    return _launch("step_jobs")


@pytest.mark.parametrize("accept_aware", [False, True],
                         ids=["always_emit", "accept_aware"])
@pytest.mark.parametrize("tree", ["full", "limited", "aligned"])
def test_sharded_step_matches_unsharded(sharded_steps, tree, accept_aware):
    """Three transitions (w-Gibbs, theta MH, prediction, tausq/beta; the
    first two accepted) with the block batches sharded over a (1, 4) mesh
    equal the unsharded model's at the same padding: w, theta, logdetCi,
    beta and every level's H and prec.  The accept-aware step runs the
    level-kernel path (SPAMTREE_LEVEL_KERNELS=1; the plain K3/K4 per
    shard on the CPU).  The trees take every cross-rank path: parents read
    on the rank and gathered whole, messages summed on the rank and over
    the ranks, and ("aligned") aligned levels."""
    with J.level_kernels(accept_aware):
        ms, tspec = J.model(tree, 4)
        ref = J.step_result(ms, tspec, accept_aware)
    assert ref["accept"] > 0
    got = sharded_steps[(tree, accept_aware)]
    _same_step(got, ref)
    assert not all(got["level_local"]) and not all(got["msg_local"])
    assert any(got["msg_local"]) and any(got["aligned"]) == (tree ==
                                                              "aligned")


@pytest.fixture(scope="module")
def sharded_chain_steps():
    """Every blocks-mesh chain case on one (1, 2) mesh, in one launch."""
    return _launch("chain_step_jobs", mesh=(1, 2))


@pytest.mark.parametrize("tree,composed", J.CHAIN_STEP_CASES,
                         ids=[f"{t}-{'composed' if c else 'joint'}"
                              for t, c in J.CHAIN_STEP_CASES])
def test_sharded_chain_step_matches_unsharded(sharded_chain_steps, tree,
                                              composed):
    """Two chains on a (1, 2) blocks mesh: three batched accept-aware steps
    (the level kernels on: K4's fold of both chains per shard, or the
    composed factor parts) equal the unsharded batched steps at the same
    padding at rtol 1e-10: each chain's w, theta, logdetCi, beta, accepts
    and every level's H and prec."""
    with J.level_kernels(True, composed):
        ms, tspec = J.model(tree, 2)
        st = J.chain_steps(ms, tspec)
    ref = J.chain_step_result(st, st.leveldata)
    assert min(ref["accept"]) > 0
    got = sharded_chain_steps[(tree, composed)]
    assert got["accept"] == ref["accept"]
    _same_step(got | dict(accept=0), ref | dict(accept=0))


# -- (c) chains ---------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_chains():
    """Two chains on a (2, 2) mesh, seeds 0 and 100, in one launch."""
    return _launch("chains_jobs", mesh=(2, 2), n_chains=2, seeds=(0, 100))


def test_run_mcmc_chains_mesh(mesh_chains):
    """Two chains on a (2, 2) mesh: finite draws in the (keep, C, n)
    layout, chain-distinct streams, and the seed changes the samples."""
    res = mesh_chains[0]
    assert res["w"].shape == (6, 2, 240)
    assert res["theta"].shape[:2] == (6, 2)
    assert np.isfinite(res["w"]).all() and np.isfinite(res["theta"]).all()
    assert not np.allclose(res["w"][:, 0], res["w"][:, 1])
    assert res["accept_by_chain"].shape == (2,)
    assert not np.allclose(mesh_chains[100]["w"], res["w"])


def test_run_mcmc_chains_unsharded_matches_mesh(mesh_chains):
    """Chain c of the (2, 2) mesh is chain c of the unsharded batched run
    over both chains."""
    ms, tspec = J.model(block_multiple=2)
    ref = J.chains(ms, tspec, np.arange(2))
    got = mesh_chains[0]
    _close(got["w"], ref["w"], what="w")
    _close(got["theta"], ref["theta"], atol=0, what="theta")
    _close(got["accept_by_chain"], ref["accept_by_chain"], atol=0)


# -- (d) the public knob ------------------------------------------------------


def _public_kw(**kw):
    coords, na, mv, y, X, _ = J.data()
    return dict(y=np.where(na, y, np.nan), x=X, coords=coords, mv_id=mv,
                cell_size=16, K=2, dtype=F64, device="cpu") | kw


DEVICES = ["cpu"] * 4


def test_spamtree_devices_matches_unsharded():
    """spamtree(devices=["cpu"] * 4) engages the blocks axis and gives the
    unsharded call's samples; with n_chains=2 the (2, 2) mesh gives
    finite, chain-distinct draws in the (keep, C, n) layout."""
    kw = _public_kw(mcmc=dict(keep=6, burn=2, thin=1),
                    settings=dict(wire_dtype="none"), seed=5)
    ref = spamtree(**kw)
    got = spamtree(devices=DEVICES, **kw)
    assert got["setup_breakdown"]["workers_start_s"] > 0
    assert got["mesh"] == dict(devices=DEVICES, chains=1, blocks=4)
    for k in ("w_mcmc", "theta_mcmc", "beta_mcmc"):
        _close(got[k], ref[k], rtol=1e-9, atol=1e-11, what=k)
    got2 = spamtree(n_chains=2, devices=DEVICES, **kw)
    assert got2["w_mcmc"].shape == (6, 2, 240)
    assert np.isfinite(got2["w_mcmc"]).all()
    assert not np.allclose(got2["w_mcmc"][:, 0], got2["w_mcmc"][:, 1])
    ref2 = spamtree(n_chains=2, **kw)
    for k in ("w_mcmc", "theta_mcmc", "beta_mcmc"):
        _close(got2[k], ref2[k], rtol=1e-9, atol=1e-11, what=f"chains {k}")


def test_resume_with_devices_mesh(tmp_path):
    """resume_from= under the devices= mesh: a sharded run checkpointed
    halfway resumes to the uninterrupted sharded run's draws bit for bit
    (the loaded state re-sweeps on the sharded model)."""
    kw = _public_kw(settings=dict(wire_dtype="none", chunk=3), seed=9,
                    devices=DEVICES)
    full = spamtree(mcmc=dict(keep=6, burn=3), **kw)
    ck = str(tmp_path / "ck.npz")
    spamtree(mcmc=dict(keep=3, burn=3), checkpoint_path=ck, **kw)
    res = spamtree(mcmc=dict(keep=6, burn=3), resume_from=ck, **kw)
    assert res["resumed_kept_already"] == 3
    for k in ("w_mcmc", "beta_mcmc"):
        assert np.array_equal(res[k], full[k][3:] if k == "w_mcmc"
                              else full[k][:, 3:]), k
    assert np.array_equal(res["theta_mcmc"], full["theta_mcmc"][:, 3:])


def test_summary_collect_with_devices_mesh():
    """collect="summary" under the devices= mesh: one chain's moments equal
    the unsharded run's draws' moments; the (2, 2) factorization gives
    per-chain moments and the quantile subsample's rows."""
    kw = _public_kw(mcmc=dict(keep=6, burn=2, thin=1), seed=5)
    ref = spamtree(settings=dict(wire_dtype="none"), **kw)
    for n_chains in (1, 2):
        got = spamtree(devices=DEVICES, n_chains=n_chains,
                       settings=dict(wire_dtype="none", collect="summary",
                                     summary_draws=3), **kw)
        assert got["summary_count"] == 6
        if n_chains == 1:
            _close(got["w_mean"], ref["w_mcmc"].mean(0), rtol=1e-9,
                   atol=1e-11)
            _close(got["w_var"], ref["w_mcmc"].var(0), rtol=1e-8,
                   atol=1e-11)
        else:
            assert got["w_mean"].shape == (2, 240)
            assert np.isfinite(got["w_mean"]).all()
            assert (got["w_var"] >= -1e-12).all()
            assert not np.allclose(got["w_mean"][0], got["w_mean"][1])
        assert got["w_mcmc"].shape[0] >= 2
        assert got["w_mcmc"].shape[-1] == 240
        assert np.isfinite(got["w_mcmc"]).all()


# -- (e) failures ---------------------------------------------------------------


def test_failing_worker_raises_in_the_caller():
    """A rank that raises while the others wait in a collective: the
    launcher kills them and raises its exception; and an error inside
    spamtree's workers (an unknown mcmc key, which prepare_fit rejects)
    comes back as the same exception from spamtree(devices=...)."""
    with pytest.raises(ValueError, match="rank 1 fails on purpose"):
        _launch("fail_job")
    kw = _public_kw(mcmc=dict(keep=2, burn=0, bogus=1))
    with pytest.raises(ValueError, match="unknown mcmc key"):
        spamtree(devices=["cpu"] * 2, **kw)


def test_make_mesh_defaults_to_the_card():
    """make_mesh() with no device never places a rank on the CPU: under
    gloo it takes the current CUDA device, and without CUDA it raises
    (CPU ranks pass device="cpu")."""
    got = _launch("default_device_job", mesh=(1, 2))
    if torch.cuda.is_available():
        assert got.startswith("cuda")
    else:
        assert got.startswith("RuntimeError") and "device='cpu'" in got


def test_devices_arguments_checked_before_launch():
    """No worker starts for an argument that cannot reach it: a callable
    prior that does not pickle raises naming the argument; "all" with no
    CUDA raises rather than run on the CPU."""
    kw = _public_kw(mcmc=dict(keep=2, burn=0))
    with pytest.raises(TypeError, match="prior"):
        spamtree(devices=DEVICES, prior=dict(theta=lambda th: 0.0), **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="all"):
            spamtree(devices="all", **kw)
