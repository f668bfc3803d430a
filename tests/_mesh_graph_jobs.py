"""Per-rank jobs of tests/test_torch_mesh_graphs.py, run by
``spamtree_tpu_torch.parallel.launch`` on gloo ranks on the CPU (this
module imports no jax, as the workers must not).  Each runs a sharded
chain twice on its rank -- eagerly (``graphs=False``) and through
``mcmc.StepRunner`` with the capture emulated (``tests/_graph_capture.py``:
the warm-up iteration, dry runs, captures under the host-read guard,
replays) -- on the models of tests/_sharding_jobs.py, and reports what
differs between the two on every rank."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _sharding_jobs as J
from _graph_capture import _leaves, emulate_capture
from spamtree_tpu_torch.model import mcmc as mt
from spamtree_tpu_torch.model.core import LevelData
from spamtree_tpu_torch.ops import kernel_counts

# 12 iterations: a burn chunk of 4, then 4 kept draws at thin 2
CFG = mt.MCMCConfig(keep=4, burn=4, thin=2, chunk=2, wire_dtype="none")
RES_KEYS = ("w", "yhat", "beta", "tausq", "theta")


def _diff(a: dict, b: dict) -> list:
    """What differs between two runs' results: the kept draws, the
    acceptance and every leaf of the final state, bit for bit."""
    out = [k for k in RES_KEYS
           if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k])]
    if not np.array_equal(np.asarray(a["accept_ratio"]),
                          np.asarray(b["accept_ratio"])):
        out.append("accept_ratio")
    sa, sb = a["state"], b["state"]
    if sa.it != sb.it:
        out.append("it")
    la, lb = _leaves(sa), _leaves(sb)
    if len(la) != len(lb):
        out.append("state leaves")
    out += [f"state leaf {i}" for i, (x, y) in enumerate(zip(la, lb))
            if not torch.equal(x, y)]
    return out


def _pair(mesh, tree, accept_aware, chains):
    """One case on this rank: eager, then the emulated capture, from one
    start and the same seeds; the rank's report."""
    with J.level_kernels(accept_aware, composed=False):
        ms, tspec = J.model(tree, mesh.n_blocks, mesh)
        cfg = CFG._replace(accept_aware=accept_aware)
        state = mt.init_state(ms, tspec.bounds, tspec.start, cfg=cfg)
        runs, counted = [], []
        with pytest.MonkeyPatch.context() as mp:
            graph = emulate_capture(mp)
            for graphs in (False, True):
                before = kernel_counts.snapshot()
                if chains:
                    c0 = mesh.chain_rank * chains
                    states, gens = mt.stack_chain_states(
                        state, 5 + c0 + np.arange(chains))
                    res = mt.run_mcmc_chains(ms, tspec.bounds, cfg, states,
                                             gens, yhat_seed=3, graphs=graphs)
                else:
                    res = mt.run_mcmc(ms, tspec.bounds, cfg, state,
                                      torch.Generator().manual_seed(5),
                                      yhat_seed=3, graphs=graphs)
                runs.append(res)
                counted.append(kernel_counts.diff(before))
            captured = list(graph.captured)
    eager, graphed = runs
    it = graphed["state"].it
    return dict(
        differs=_diff(eager, graphed), counts=counted, captured=captured,
        replays_per_iter=graphed["graph_replays"] / (it - 1),
        accept=np.asarray(eager.get("accept_by_chain",
                                    eager["accept_ratio"])).tolist(),
        w_shape=graphed["w"].shape)


def _every_rank(report):
    """Every rank's report, in rank order (on every rank)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, report)
    return out


def pair_jobs(mesh, cases, chains=0):
    """For each (tree, accept_aware) of ``cases``: ``_pair`` on this rank,
    every rank's report."""
    return {case: _every_rank(_pair(mesh, *case, chains)) for case in cases}


def jax_parity_job(mesh, accept_aware, draws, start, sd):
    """StepRunner on this rank's shards of the full tree, the capture
    emulated, from init_state at ``start`` with proposal covariance
    ``sd``, its draws filled from ``draws`` (one list of arrays per step,
    in StepDraws order): after each step the replicated state and every
    level's H and prec gathered whole (rank 0's)."""
    with pytest.MonkeyPatch.context() as mp:
        emulate_capture(mp)
        ms, tspec = J.model("full", mesh.n_blocks, mesh)
        cfg = mt.MCMCConfig(mcmcsd=sd, accept_aware=accept_aware)
        state = mt.init_state(ms, tspec.bounds, tspec.start, cfg=cfg,
                              **start)
        feed = iter(draws)

        def draw(out):
            for o, a in zip(out, next(feed)):
                o.copy_(torch.as_tensor(a))

        runner = mt.StepRunner(ms, tspec.bounds, cfg, state, draw,
                               n_iters=len(draws))
        steps = []
        for _ in draws:
            st = runner.step(True)
            ld = [LevelData(mesh.cat_blocks(d.H), mesh.cat_blocks(d.prec))
                  for d in st.leveldata]
            steps.append(dict(
                w=st.w.numpy().copy(), theta=st.theta.numpy().copy(),
                logdetCi=st.logdetCi.numpy().copy(),
                beta=st.beta.numpy().copy(),
                tausq_inv=st.tausq_inv.numpy().copy(),
                accept=float(st.ram.accept_count),
                leveldata=[(d.H.numpy(), d.prec.numpy()) for d in ld]))
        return dict(steps=steps, replays=runner.replays,
                    captured=len(runner.graphs))
