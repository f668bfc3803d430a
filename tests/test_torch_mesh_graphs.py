"""The sharded samplers' iteration as replayed CUDA graphs, on the CPU.

On an NCCL mesh ``mcmc.StepRunner`` captures every rank's parts with
their collectives, the counterpart of the JAX package's compiled sharded
chunk.  CUDA graphs and NCCL run only on the card, so these tests hold
what the capture needs on gloo ranks on the CPU, in f64, at the sizes of
tests/test_torch_sharding.py (n = 240 on the full and the limited tree,
the n = 1600 "aligned" model), each rank a worker of ``parallel.launch``
running a job of tests/_mesh_graph_jobs.py:

* On every rank, ``run_mcmc``/``run_mcmc_chains`` with the capture
  emulated (``tests/_graph_capture.py``: warm-up iteration, dry runs,
  captures under the host-read guard, replays) give the eager mesh run's
  bits -- the kept draws, the acceptance and the rank's final state --
  with the same kernel-wrapper calls, every rank capturing the same
  parts: a (1, 2) blocks mesh on both theta steps (the accept-aware step
  with the level kernels' plain versions), a (2, 1) chains mesh and a
  (1, 4) blocks mesh, always-emit.
* Four steps of the (1, 2) mesh's runner, fed the draws the JAX package's
  step takes from its key, equal four steps of the unsharded JAX step at
  rtol 1e-10, on both theta steps.
* The gathered parts of one all-gather laid out as ``torch.cat`` of the
  parts along any dim, empty parts included.
* The graph gate for every (device, mesh backend) pair: graphs by default
  on CUDA alone or on an NCCL mesh, eager on the CPU and on a gloo mesh,
  and ``graphs=True`` on a gloo mesh with CUDA tensors raises, naming
  gloo's host staging.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _sharding_jobs as J
from _mesh_graph_jobs import CFG
from spamtree_tpu.model import core as cj
from spamtree_tpu.model import mcmc as mj
from spamtree_tpu.model.params import make_theta_spec
from spamtree_tpu.tree.partition import make_tree as make_tree_jax
from spamtree_tpu.tree.schedule import build_schedule as build_schedule_jax
from spamtree_tpu_torch.model import core as ct
from spamtree_tpu_torch.model import graph
from spamtree_tpu_torch.model import mcmc as mt
from spamtree_tpu_torch.parallel.launch import launch
from spamtree_tpu_torch.parallel.mesh import _join
from spamtree_tpu_torch.utils.convert import model_state_to_numpy
from test_torch_graphs import _close_tree

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 180.0  # seconds any one launch may take before it is killed
TREES = ("full", "limited", "aligned")
BLOCKS_CASES = [(t, aa) for t in TREES for aa in (False, True)]
FOUR_RANK_CASES = [("full", False), ("limited", False)]
CHAIN_CASES = [("full", False), ("full", True)]
N_CHAINS = 4  # two on each chains rank of the (2, 1) mesh
STEPS = 4
SD = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread here and in every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


def _launch(job, mesh, **kwargs):
    value, _ = launch(f"_mesh_graph_jobs:{job}", kwargs,
                      ["cpu"] * (mesh[0] * mesh[1]), n_chains=mesh[0],
                      timeout=TIMEOUT, path=[HERE])
    return value


def _case_id(case):
    return f"{case[0]}-{'accept_aware' if case[1] else 'always_emit'}"


def _check_pair(reports, case, chains=0):
    """Every rank's report of one case: the eager bits, the same kernel
    calls on both paths, the same parts captured on every rank, 2-4
    replays an iteration (one chain) or one (chains), and a chain that
    both accepted and refused."""
    tree, accept_aware = case
    want = (["C0", "C1"] if chains else
            ["A"] + (["R"] if accept_aware else []) + ["I", "T0", "T1"])
    for r, rep in enumerate(reports):
        what = f"{_case_id(case)}, rank {r}"
        assert rep["differs"] == [], (what, rep["differs"])
        eager, graphed = rep["counts"]
        assert eager == graphed and eager["k1_launches"] > 0, (
            what, rep["counts"])
        if accept_aware and not chains:
            assert eager["k3_launches"] > 0 and eager["k4_launches"] > 0, (
                what, rep["counts"])
        assert rep["captured"] == want, (what, rep["captured"])
        reps = rep["replays_per_iter"]
        assert (reps == 1.0) if chains else (2.0 <= reps <= 4.0), (what, reps)
        assert rep["accept"] == reports[0]["accept"], what
    acc = np.asarray(reports[0]["accept"])
    assert (acc > 0).all() and (acc < 1).all(), (_case_id(case), acc)


# -- the emulated capture against the eager mesh run --------------------------


@pytest.fixture(scope="module")
def blocks_pairs():
    """Every (1, 2) blocks-mesh case, in one launch."""
    return _launch("pair_jobs", (1, 2), cases=BLOCKS_CASES)


@pytest.mark.parametrize("case", BLOCKS_CASES, ids=map(_case_id,
                                                       BLOCKS_CASES))
def test_blocks_mesh_capture_equals_eager(blocks_pairs, case):
    """(1, 2) blocks mesh, 12 iterations of run_mcmc: the emulated capture
    on each rank gives that rank's eager bits."""
    _check_pair(blocks_pairs[case], case)


@pytest.fixture(scope="module")
def chains_pairs():
    """The (2, 1) chains-mesh cases, two chains a rank, in one launch."""
    return _launch("pair_jobs", (2, 1), cases=CHAIN_CASES,
                   chains=N_CHAINS // 2)


@pytest.mark.parametrize("case", CHAIN_CASES, ids=map(_case_id, CHAIN_CASES))
def test_chains_mesh_capture_equals_eager(chains_pairs, case):
    """(2, 1) chains mesh, run_mcmc_chains over four chains: each rank's
    emulated capture gives its eager bits, and the gathered draws hold
    every rank's chains."""
    reports = chains_pairs[case]
    _check_pair(reports, case, chains=N_CHAINS // 2)
    assert reports[0]["w_shape"] == (CFG.keep, N_CHAINS, 240)


@pytest.fixture(scope="module")
def four_rank_pairs():
    """The (1, 4) blocks-mesh cases, in one launch."""
    return _launch("pair_jobs", (1, 4), cases=FOUR_RANK_CASES)


@pytest.mark.parametrize("case", FOUR_RANK_CASES,
                         ids=map(_case_id, FOUR_RANK_CASES))
def test_four_rank_mesh_capture_equals_eager(four_rank_pairs, case):
    """(1, 4) blocks mesh, always-emit: the emulated capture on each of the
    four ranks gives its eager bits."""
    _check_pair(four_rank_pairs[case], case)


# -- against the JAX package -------------------------------------------------


@pytest.mark.parametrize("accept_aware", [False, True],
                         ids=["always_emit", "accept_aware"])
def test_graphed_mesh_steps_match_jax(accept_aware):
    """Four steps of StepRunner on a (1, 2) blocks mesh, the capture
    emulated on each rank and the draws taken from the JAX key as the JAX
    step splits it, against four steps of the unsharded JAX step at the
    same padding from the same start: w, theta, logdetCi, beta, tausq,
    the accepts and every level's H and prec at rtol 1e-10 in f64."""
    coords, na, mv, y, X, rng = J.data()
    tree = make_tree_jax(coords, na, mv, axis_cell_size=4, K=2, rng=rng)
    spec = make_theta_spec(2, 2)
    ms_j = cj.ModelStatic(build_schedule_jax(tree), coords, mv, y, X,
                          spec.spec, dtype=jnp.float64, block_multiple=2)
    n = len(y)
    r = np.random.default_rng(4)
    start = dict(start_beta=np.array([0.4, -0.8]), start_tausq=0.2,
                 start_w=0.3 * r.normal(size=n))
    sd = SD * np.eye(spec.n_theta)
    cfg_j = mj.MCMCConfig(mcmcsd=sd, accept_aware=accept_aware)
    st_j = mj.init_state(ms_j, spec.bounds, spec.start, cfg=cfg_j, seed=0,
                         **start)
    step_j = jax.jit(mj.make_step(ms_j, spec.bounds, cfg_j),
                     static_argnums=2)
    ms_t, _ = J.model("full", 2)
    shape = ct.tausq_shape(ms_t, mt.MCMCConfig().tausq_ab).numpy()
    f64 = jnp.float64
    draws, ref = [], []
    for key in jax.random.split(jax.random.PRNGKey(3), STEPS):
        kw_, kt, ku, kp, kq, kb = jax.random.split(key, 6)
        draws.append([np.array(a) for a in (
            jax.random.normal(kw_, (n + 1,), dtype=f64),
            jax.random.normal(kt, (spec.n_theta,), dtype=f64),
            jax.random.uniform(ku, dtype=f64),
            jax.random.normal(kp, (n + 1,), dtype=f64),
            jax.random.gamma(kq, jnp.asarray(shape), dtype=f64),
            jax.random.normal(kb, (ms_t.p, ms_t.q), dtype=f64))])
        st_j = step_j(st_j, key, True)
        d = model_state_to_numpy(st_j)
        ref.append(dict({k: d[k] for k in ("w", "theta", "logdetCi", "beta",
                                           "tausq_inv")},
                        accept=d["ram"]["accept_count"],
                        leveldata=d["leveldata"]))
    got = _launch("jax_parity_job", (1, 2), accept_aware=accept_aware,
                  draws=draws, start=start, sd=sd)
    assert got["captured"] > 0 and got["replays"] >= 2 * (STEPS - 1)
    for i, (g, e) in enumerate(zip(got["steps"], ref)):
        _close_tree(g, e, f"step {i}", rtol=1e-10)
    accepts = [e["accept"] for e in ref]
    assert accepts[-1] > 0, accepts


# -- the gate ---------------------------------------------------------------


@pytest.mark.parametrize("backend", [None, "nccl", "gloo"],
                         ids=["alone", "nccl", "gloo"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_graph_resolution(device, backend):
    """graphs=None resolves to graphs on CUDA alone or on an NCCL mesh and
    to the eager step on the CPU and on a gloo mesh; graphs=True is
    refused on a gloo mesh with CUDA tensors (gloo's host staging), and
    allowed everywhere else (on the CPU the parts run as plain calls)."""
    want = device == "cuda" and backend != "gloo"
    assert graph.graphs_default(device, backend) is want
    ms = SimpleNamespace(device=torch.device(device), mesh=None
                         if backend is None else SimpleNamespace(
                             backend=backend))
    assert mt._graphed(ms, None) is want
    assert mt._graphed(ms, True) and not mt._graphed(ms, False)
    if device == "cuda" and backend == "gloo":
        with pytest.raises(ValueError, match="gloo stages CUDA tensors "
                           "through host memory"):
            graph.check_capturable(device, backend)
        # the runner refuses before it touches the device
        with pytest.raises(ValueError, match="gloo"):
            mt.StepRunner(ms, None, mt.MCMCConfig(), None, None)
    else:
        graph.check_capturable(device, backend)


# -- the collectives' layout ------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 4, 5), (3, 0, 5), (6,)],
                         ids=["3d", "empty", "1d"])
def test_join_lays_out_as_cat(shape):
    """``mesh._join`` of a (size, *shape) all-gather output along each dim
    (negative dims too) is ``torch.cat`` of its parts, bit for bit."""
    parts = torch.randn((4,) + shape, generator=torch.Generator()
                        .manual_seed(2), dtype=torch.float64)
    for dim in range(-len(shape), len(shape)):
        assert torch.equal(_join(parts, dim), torch.cat(list(parts), dim))
