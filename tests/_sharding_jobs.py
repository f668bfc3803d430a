"""Per-rank jobs of tests/test_torch_sharding.py, run by
``spamtree_tpu_torch.parallel.launch`` in worker processes (this module
imports no jax, as the workers must not), and the models both sides build:
n = 240, q = 2, float64, axis_cell_size = 4, as tests/test_sharding.py, on
the full and the limited tree; and bench config 3's kind of data at n =
1600 ("aligned": an aligned thin level and prediction bucket, which read
their parents on their own rank, and a level whose messages stay there)."""

import contextlib
import os

import numpy as np
import torch

from spamtree_tpu_torch.model.core import (
    LevelData,
    ModelStatic,
    level_coords,
    tausq_shape,
)
from spamtree_tpu_torch.model.mcmc import (
    MCMCConfig,
    draw_chains,
    draw_step,
    init_state,
    make_step,
    run_mcmc_chains,
    stack_chain_states,
)
from spamtree_tpu_torch.model.params import make_theta_spec
from spamtree_tpu_torch.parallel.sharding import shard_model
from spamtree_tpu_torch.tree.partition import make_tree
from spamtree_tpu_torch.tree.schedule import build_schedule

STEPS = 3  # transitions per step check: the second and third carry gram


def data(n=240, q=2, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.uniform(size=(n // q, 2))
    coords = np.repeat(base, q, axis=0)
    mv = np.tile(np.arange(q), n // q)
    n = len(coords)
    order = np.lexsort((np.arange(n), coords[:, 1], coords[:, 0]))
    coords, mv = coords[order], mv[order]
    na = rng.uniform(size=n) > 0.1
    y = rng.normal(size=n)
    y[~na] = np.nan
    X = rng.normal(size=(n, 2))
    return coords, na, mv, y, X, rng


def model(tree="full", block_multiple=1, mesh=None):
    """(ModelStatic, theta spec) of ``tree`` ("full", "limited" or
    "aligned"); cut to this rank's shards on a mesh."""
    limited = tree == "limited"
    if tree == "aligned":
        import bench

        y, _, _, X, coords, mv = bench.make_multivariate(800, 2)
        order = np.lexsort((np.arange(len(y)), coords[:, 1], coords[:, 0]))
        y, X, coords = y[order], X[order], coords[order]
        mv = np.searchsorted(np.unique(mv), mv[order])  # 0-based margins
        na, rng, cell = np.isfinite(y), np.random.default_rng(1), 5
    else:
        coords, na, mv, y, X, rng = data()
        cell = 4
    tree = make_tree(coords, na, mv, axis_cell_size=cell, K=2, rng=rng,
                     limited_tree=limited)
    sched = build_schedule(tree, limited_tree=limited)
    tspec = make_theta_spec(2, 2)
    ms = ModelStatic(sched, coords, mv, y, X, tspec.spec,
                     dtype=torch.float64, device="cpu",
                     block_multiple=block_multiple)
    return (ms if mesh is None else shard_model(ms, mesh)), tspec


def steps(ms, tspec, accept_aware=False, n=STEPS):
    """``n`` transitions from init_state, the draws from generator 7."""
    # a narrow proposal: the first transitions accept, so the rebuild on
    # accept and the carried Gram blocks run too
    cfg = MCMCConfig(keep=2, burn=1, accept_aware=accept_aware, mcmcsd=1e-4)
    state = init_state(ms, tspec.bounds, tspec.start, cfg=cfg)
    step = make_step(ms, tspec.bounds, cfg, coords_cache=level_coords(ms))
    gen = torch.Generator().manual_seed(7)
    shape = tausq_shape(ms, cfg.tausq_ab)
    for _ in range(n):
        state = step(state, draw_step(ms, gen, tspec.n_theta, shape), True)
    return state


def _result(state, ld):
    return dict(w=state.w.numpy(), theta=state.theta.numpy(),
                logdetCi=state.logdetCi.numpy(), beta=state.beta.numpy(),
                accept=float(state.ram.accept_count),
                leveldata=[(d.H.numpy(), d.prec.numpy()) for d in ld])


def step_result(ms, tspec, accept_aware=False):
    """The unsharded side of ``step_job``."""
    st = steps(ms, tspec, accept_aware)
    return _result(st, st.leveldata)


def step_jobs(mesh):
    """``steps`` on this rank's shards for each tree, always-emit and
    accept-aware; the leveldata gathered whole, and which levels read
    their parents (and receive their messages) on their own rank."""
    out = {}
    for tree in ("full", "limited", "aligned"):
        for accept_aware in (False, True):
            with level_kernels(accept_aware):
                ms, tspec = model(tree, mesh.n_blocks, mesh)
                st = steps(ms, tspec, accept_aware)
            ld = [LevelData(mesh.cat_blocks(d.H), mesh.cat_blocks(d.prec))
                  for d in st.leveldata]
            out[(tree, accept_aware)] = _result(st, ld) | dict(
                aligned=ms.level_aligned, level_local=ms.level_local,
                msg_local=ms.msg_local)
    return out


@contextlib.contextmanager
def level_kernels(on, composed=True):
    """SPAMTREE_LEVEL_KERNELS=1 for a block when ``on``, and
    SPAMTREE_COMPOSED_FACTORS=0 unless ``composed``."""
    gates = dict(SPAMTREE_LEVEL_KERNELS="1" if on else None,
                 SPAMTREE_COMPOSED_FACTORS=None if composed else "0")
    old = {k: os.environ.get(k) for k in gates}
    os.environ.update({k: v for k, v in gates.items() if v is not None})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# the blocks-mesh chain cases: (tree, composed factor parts); the level
# kernels on in each (the plain K4 on each rank's fold of both chains)
CHAIN_STEP_CASES = (("full", True), ("aligned", True), ("aligned", False))


def chain_steps(ms, tspec, C=2, n=STEPS):
    """``n`` accept-aware batched steps of C chains from init_state, chain
    c's draws from generator 7 + c."""
    cfg = MCMCConfig(keep=2, burn=1, accept_aware=True, mcmcsd=1e-4)
    state = init_state(ms, tspec.bounds, tspec.start, cfg=cfg)
    states, gens = stack_chain_states(state, 7 + np.arange(C))
    step = make_step(ms, tspec.bounds, cfg, coords_cache=level_coords(ms),
                     chains=True)
    shape = tausq_shape(ms, cfg.tausq_ab)
    for _ in range(n):
        states = step(states, draw_chains(ms, gens, tspec.n_theta, shape),
                      True)
    return states


def chain_step_result(st, ld):
    """``_result`` of a batched state (per-chain accept counts)."""
    return dict(w=st.w.numpy(), theta=st.theta.numpy(),
                logdetCi=st.logdetCi.numpy(), beta=st.beta.numpy(),
                accept=st.ram.accept_count.tolist(),
                leveldata=[(d.H.numpy(), d.prec.numpy()) for d in ld])


def chain_step_jobs(mesh):
    """``chain_steps`` on this rank's shards for each of CHAIN_STEP_CASES,
    the leveldata gathered whole."""
    out = {}
    for tree, composed in CHAIN_STEP_CASES:
        with level_kernels(True, composed):
            ms, tspec = model(tree, mesh.n_blocks, mesh)
            st = chain_steps(ms, tspec)
        ld = [LevelData(mesh.cat_blocks(d.H, 1), mesh.cat_blocks(d.prec, 1))
              for d in st.leveldata]
        out[(tree, composed)] = chain_step_result(st, ld)
    return out


CHAIN_CFG = MCMCConfig(keep=6, burn=4, thin=1, chunk=3)


def chains(ms, tspec, seeds, cfg=CHAIN_CFG):
    """run_mcmc_chains from init_state, chain c's generator seeded
    ``seeds[c]``."""
    state = init_state(ms, tspec.bounds, tspec.start, cfg=cfg)
    states, gens = stack_chain_states(state, seeds)
    return run_mcmc_chains(ms, tspec.bounds, cfg, states, gens)


def chains_jobs(mesh, n_chains, seeds):
    """For each of ``seeds``: this rank's chains of ``n_chains`` (chain c
    seeded seed + c), blocks sharded; run_mcmc_chains gathers every
    chain's draws."""
    ms, tspec = model("full", mesh.n_blocks, mesh)
    per = n_chains // mesh.n_chains
    c0 = mesh.chain_rank * per
    out = {}
    for seed in seeds:
        res = chains(ms, tspec, seed + np.arange(c0, c0 + per))
        out[seed] = {k: res[k] for k in ("w", "theta", "accept_by_chain")}
    return out


def fail_job(mesh):
    """Rank 1 raises while every other rank waits in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.barrier()



def default_device_job(mesh):
    """make_mesh with no device, on gloo ranks: the rank's current CUDA
    device where CUDA is present, whatever the backend; else the error
    it raises."""
    from spamtree_tpu_torch.parallel.mesh import make_mesh

    try:
        return str(make_mesh(1, mesh.n_blocks).device)
    except RuntimeError as e:
        return f"RuntimeError: {e}"
