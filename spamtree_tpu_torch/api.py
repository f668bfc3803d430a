"""User-facing API: ``spamtree()`` fit + predict in one MCMC run, and
``spamtree_predict()`` at new locations after a fit.

Port of ``spamtree_tpu/api.py`` (reference front-end R/spamtree_fit.R):
one chain or C chains in one batched step on a full or limited tree,
every kept draw collected or the posterior moments summed on the device,
prediction at the NaN rows, checkpoints, resume and sample sinks, with the
JAX package's prior, starting, debug, settings, tree-shape and elevation
knobs, on one device or on a chains x blocks mesh of devices
(``devices=`` starts one worker process per device; ``mesh=`` runs in
ranks the caller started, see ``parallel/``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spamtree_tpu_torch.model.core import ModelStatic, level_coords
from spamtree_tpu_torch.model.mcmc import (
    MCMCConfig,
    chunk_sizes,
    init_state,
    run_mcmc,
    run_mcmc_chains,
    stack_chain_states,
)
from spamtree_tpu_torch.model.params import auto_start_theta, make_theta_spec
from spamtree_tpu_torch.model.predict import DrawRunner
from spamtree_tpu_torch.model.tuning import (
    curvature_sd_from_lls,
    prepare_chain,
    subsample_curvature_sd,
)
from spamtree_tpu_torch.parallel.mesh import Mesh
from spamtree_tpu_torch.tree.partition import make_tree
from spamtree_tpu_torch.tree.schedule import build_schedule
from spamtree_tpu_torch.utils import trace

# spamtree_tpu.spamtree's knob dicts over their defaults
_MCMC = dict(keep=1000, burn=0, thin=1)
_SETTINGS = dict(
    adapting=True, mcmcsd=None, curvature_sd=True, ram_reference_warmup=False,
    const_model=None, collect="all", wire_dtype=None, summary_draws=0,
    factor_dtype=None, lazy_init=None, chunk=50, tuner_overlap=None)
_PRIOR = dict(set_unif_bounds=None, btmlim=None, toplim=None, vlim=None,
              beta=None, tausq=None, theta=None)
_STARTING = dict(beta=None, tausq=None, theta=None, w=None)
_DEBUG = dict(sample_beta=True, sample_tausq=True, sample_theta=True,
              sample_w=True, sample_predicts=True)
# settings that choose how the JAX package compiles or stores its programs:
# the values this port runs (the reference's defaults; eager, nothing to
# compile).  Any other value raises naming itself.
_SETTINGS_FIXED = dict(const_model=(None,),
                       factor_dtype=(None, False, "none", "off"),
                       lazy_init=(None, False), tuner_overlap=(None,))


def _merge(name: str, defaults: dict, given) -> dict:
    """``given`` over ``defaults``; an unknown key raises ValueError (a
    typo'd knob must not run silently with the defaults)."""
    unknown = set(given or {}) - set(defaults)
    if unknown:
        raise ValueError(f"unknown {name} key(s) {sorted(unknown)}; "
                         f"valid: {sorted(defaults)}")
    return defaults | dict(given or {})


def _check_settings(settings) -> dict:
    """``settings`` over their defaults, each JAX-only setting at a value
    this port runs."""
    settings = _merge("settings", _SETTINGS, settings)
    for k, ok in _SETTINGS_FIXED.items():
        v = settings[k]
        if not any(v is d or (isinstance(v, str) and v == d) for d in ok):
            raise NotImplementedError(
                f"spamtree settings[{k!r}]={v!r} is not ported; this "
                f"package runs {' or '.join(map(repr, ok))}")
    if settings["collect"] not in ("all", "summary"):
        raise ValueError(f"settings['collect']={settings['collect']!r}: "
                         f"'all' or 'summary'")
    return settings


class Resume(NamedTuple):
    """What a ``resume_from`` checkpoint hands the continuation."""

    yhat_rngs: tuple  # (host numpy generator, device torch generator)
    init_moments: object  # mcmc.Moments, or None
    base_counts: tuple  # (burn_done, kept_done) of the runs before
    at_iteration: int
    kept_already: int  # of this call's keep


class Fit(NamedTuple):
    """Everything a run needs before its first iteration (``prepare_fit``)."""

    ms: ModelStatic
    bounds: np.ndarray
    cfg: MCMCConfig
    state: object  # model.mcmc.MCMCState, with a chain axis for n_chains > 1
    gen: object  # torch.Generator, or one per chain for n_chains > 1
    order: np.ndarray
    tree: object
    sched: object
    setup_breakdown: dict
    fit_config: dict  # what spamtree_predict needs (spamtree's "fit_config")
    resume: Resume | None = None
    mesh: object = None  # parallel.mesh.Mesh of a sharded run (ms is sharded)


def _build_mesh(devices, n_chains: int):
    """(device list, chains axis) of ``devices=``: the JAX package's grid
    (spamtree_tpu/api.py:37-53), the analog of the reference's one-knob
    parallelism (``num_threads``, spamtree_fit.cpp:57-59): chains shard as
    pure data parallelism when they divide the device count, the rest of
    the devices shard every level's block batch."""
    from spamtree_tpu_torch.parallel.launch import resolve_devices

    devices = resolve_devices(devices)
    n_dev = len(devices)
    chains_ax = n_chains if (n_chains > 1 and n_dev % n_chains == 0) else 1
    return devices, chains_ax


def _resume_plan(path: str, cfg: MCMCConfig, ms: ModelStatic, it: int,
                 chains=None):
    """The continuation of the run that wrote checkpoint ``path``: (cfg
    with the remaining burn and keep and the writing run's chunk size
    pinned, init_moments, base_counts, kept_already).  Counts come from the
    checkpoint (the writing run's balanced mc can differ from this call's),
    so burn already run is skipped exactly and kept draws are not
    recounted."""
    from spamtree_tpu_torch.utils.checkpoint import load_counts, load_moments

    counts = load_counts(path)
    if counts is None:
        raise ValueError(f"{path} records no chunk geometry (geom_counts): "
                         f"it was not written by run_mcmc")
    mc, burn_done, kept_done, thin = counts
    if thin != cfg.thin:
        # iterations per chunk are mc * thin: another thin would shift
        # burn_actual and mis-count kept draws
        raise ValueError(
            f"checkpoint was written with thin={thin}; resuming with "
            f"thin={cfg.thin} would silently shift the chunk boundaries and "
            f"mis-count kept draws -- resume with the original thin")
    _, ipc, _, nb = chunk_sizes(cfg._replace(mc_fixed=mc))
    rem_burn = max(nb * ipc - burn_done, 0)
    kept_already = min(kept_done, cfg.keep)
    if kept_already >= cfg.keep and rem_burn == 0:
        raise ValueError(
            f"checkpoint at iteration {it} already holds all {cfg.keep} kept "
            f"draws for this mcmc config; nothing to resume")
    moments = None
    if cfg.collect == "summary":
        moments = load_moments(path, ms, chains)
        if kept_already > 0 and moments is None:
            raise ValueError(
                f"checkpoint at iteration {it} holds {kept_already} kept "
                f"draws but no moment accumulators (it was written by a "
                f"collect='all' run); an exact collect='summary' "
                f"continuation is impossible -- resume with collect='all'")
    cfg = cfg._replace(burn=rem_burn, keep=cfg.keep - kept_already,
                       mc_fixed=mc)
    # the true kept_done, not the clipped kept_already: a burn extension
    # asking for fewer keeps must not shrink the counter
    return cfg, moments, (burn_done, kept_done), kept_already


@trace.entry("prepare_fit")
def prepare_fit(y, x, coords, mv_id=None, cell_size=25, K=2, mcmc=None,
                settings=None, seed=1, dtype=torch.float32, verbose=False,
                device="cuda", limited_tree=False, resume_from=None,
                elevation=False, start_level=0, tree_depth=np.inf,
                last_not_reference=True, cherrypick_same_margin=True,
                cherrypick_group_locations=True, mvbias=0.0, prior=None,
                starting=None, debug=None, precompile=False, n_chains=1,
                mesh=None) -> Fit:
    """Tree, schedule, model, tuned proposal and initial state of a
    ``spamtree`` run (same arguments), without running the chain; with
    ``resume_from`` the state and generators of that checkpoint instead of
    the tuner and the initial sweep.  ``precompile`` is ``spamtree``'s
    (the work count, which runs with the chain); the port captures its
    CUDA graphs at the chain's first iteration (``mcmc.StepRunner``).
    ``n_chains > 1``: the
    tuner runs once and every chain starts from its state and proposal
    (``mcmc.stack_chain_states``), chain c's generator seeded ``seed +
    c``.

    ``mesh`` (``parallel.mesh.make_mesh``, called by every rank with the
    same arguments): the model runs on the rank's device, padded for the
    blocks axis and cut to the rank's shards (``parallel.sharding``); the
    tuner and the initial sweep run sharded; a chains rank's state and
    generators are its own chains' (n_chains must divide over the chains
    axis)."""
    del precompile
    settings = _check_settings(settings)
    n_chains = int(n_chains)
    if n_chains < 1:
        raise ValueError(f"n_chains must be >= 1, got {n_chains}")
    # this rank's chains: c_own of them from chain c0
    c0, c_own = 0, n_chains
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh={mesh!r} is not a parallel.mesh.Mesh "
                            f"(make_mesh)")
        if n_chains % mesh.n_chains:
            raise ValueError(f"n_chains={n_chains} does not split over the "
                             f"mesh's {mesh.n_chains} chains ranks")
        c_own = n_chains // mesh.n_chains
        c0 = mesh.chain_rank * c_own
        device = mesh.device
        verbose = verbose if mesh.rank == 0 else False
    mcmc = _merge("mcmc", _MCMC, mcmc)
    prior = _merge("prior", _PRIOR, prior)
    starting = _merge("starting", _STARTING, starting)
    debug = _merge("debug", _DEBUG, debug)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not available")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                         f"got {dtype}")

    y = np.asarray(y, dtype=np.float64).reshape(-1)
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    coords = np.asarray(coords, dtype=np.float64)
    n, dd = coords.shape
    if elevation and dd != 3:
        raise ValueError(f"elevation=True needs 3 coordinate columns (x, y, "
                         f"elevation); got dd={dd}")
    if mv_id is None:
        mv_id = np.ones(n, dtype=np.int64)
    mv_id = np.asarray(mv_id, dtype=np.int64)
    uniq = np.unique(mv_id)
    q = len(uniq)
    mv0 = np.searchsorted(uniq, mv_id)  # 0-based margin ids

    # sort rows by coordinates then original index (reference: spamtree_fit.R:214)
    order = np.lexsort(
        tuple([np.arange(n)] + [coords[:, j] for j in range(dd - 1, -1, -1)]))
    ys, xs, cs, mvs = y[order], x[order], coords[order], mv0[order]
    axis_size = (int(round(cell_size ** (1.0 / dd))) if np.isscalar(cell_size)
                 else np.asarray(cell_size))
    # what spamtree_predict needs to rebuild the same partition and theta
    # packing at new locations (the JAX package's keys, and elevation)
    fit_config = dict(
        cell_size=cell_size, K=K, start_level=start_level,
        tree_depth=tree_depth, last_not_reference=last_not_reference,
        limited_tree=limited_tree,
        cherrypick_same_margin=cherrypick_same_margin,
        cherrypick_group_locations=cherrypick_group_locations,
        mvbias=mvbias, seed=seed, dtype=dtype, mv_labels=uniq,
        btmlim=prior["btmlim"], toplim=prior["toplim"], vlim=prior["vlim"],
        set_unif_bounds=prior["set_unif_bounds"], elevation=bool(elevation),
        n_chains=n_chains)

    # setup breakdown: seconds per pre-MCMC phase, the call's spans setup.*
    rec = trace.current()
    tb = {}
    with trace.span("setup.tree"):
        tree = make_tree(cs, np.isfinite(ys), mvs, axis_cell_size=axis_size,
                         K=K, start_level=start_level, tree_depth=tree_depth,
                         last_not_reference=last_not_reference,
                         limited_tree=limited_tree,
                         cherrypick_same_margin=cherrypick_same_margin,
                         cherrypick_group_locations=cherrypick_group_locations,
                         mvbias=mvbias, rng=np.random.default_rng(seed),
                         verbose=verbose)
        sched = build_schedule(tree, limited_tree=limited_tree)
    tb["tree_s"] = round(rec.seconds("setup.tree"), 2)
    start_theta = starting["theta"]
    if start_theta is None:
        start_theta = auto_start_theta(dd, q, cs, ys, mvs,
                                       elevation=bool(elevation))
    tspec = make_theta_spec(
        dd, q, btmlim=1e-3 if prior["btmlim"] is None else prior["btmlim"],
        toplim=1e3 if prior["toplim"] is None else prior["toplim"],
        vlim=prior["vlim"], elevation=bool(elevation),
        set_unif_bounds=prior["set_unif_bounds"], start_theta=start_theta)
    with trace.span("setup.model"):
        ms = ModelStatic(sched, cs, mvs, ys, xs, tspec.spec, dtype=dtype,
                         device=device,
                         block_multiple=1 if mesh is None else mesh.n_blocks)
        if mesh is not None:
            from spamtree_tpu_torch.parallel.sharding import shard_model

            ms = shard_model(ms, mesh)
    tb["stage_s"] = round(rec.seconds("setup.model"), 2)
    cfg = MCMCConfig(
        keep=mcmc["keep"], burn=mcmc["burn"], thin=mcmc["thin"],
        adapting=settings["adapting"],
        tausq_ab=((2.01, 1.0) if prior["tausq"] is None
                  else tuple(prior["tausq"])),
        beta_Vi=0.01 if prior["beta"] is None else prior["beta"],
        sample_beta=debug["sample_beta"], sample_tausq=debug["sample_tausq"],
        sample_theta=debug["sample_theta"], sample_w=debug["sample_w"],
        sample_predicts=debug["sample_predicts"],
        ram_reference_warmup=settings["ram_reference_warmup"],
        theta_prior=prior["theta"], chunk=int(settings["chunk"]),
        collect=settings["collect"],
        summary_draws=int(settings["summary_draws"]),
        wire_dtype=settings["wire_dtype"])

    if resume_from is not None:
        # the checkpoint carries the adapted proposal and the generators:
        # no tuner, no initial sweep (load_state rebuilds the factors)
        from spamtree_tpu_torch.utils.checkpoint import (
            load_chains,
            load_rngs,
            load_state,
        )

        ck_chains = load_chains(resume_from)
        if ck_chains != n_chains:
            raise ValueError(f"checkpoint holds {ck_chains} chain(s); "
                             f"n_chains={n_chains} was requested")
        with trace.span("setup.resume_load"):
            own = (c0, c_own) if n_chains > 1 and mesh is not None else None
            state = load_state(resume_from, ms, chains=own)
            gen, yhat_rngs = load_rngs(resume_from, ms.device, chains=own)
            cfg, moments, base, kept_already = _resume_plan(
                resume_from, cfg, ms, state.it, own)
        tb["resume_load_s"] = round(rec.seconds("setup.resume_load"), 2)
        if verbose:
            print(f"[resume] iteration {state.it}: {kept_already} kept draws "
                  f"already taken, {cfg.burn} burn + {cfg.keep} keep "
                  f"remaining")
        return Fit(ms, tspec.bounds, cfg, state, gen, order, tree, sched, tb,
                   fit_config,
                   Resume(yhat_rngs, moments, base, state.it, kept_already),
                   mesh)

    # the initial proposal covariance (see model/tuning.py), as the JAX
    # package picks it: settings["mcmcsd"] if given; else, with
    # curvature_sd and theta sampled, the curvature-scaled diagonal -- from
    # a subsampled model where the JAX package initializes lazily (burn and
    # theta sampled), else from the full model together with the initial
    # sweep; else the isotropic scale-aware fallback
    mcmcsd = settings["mcmcsd"]
    do_curv = bool(mcmcsd is None and settings["curvature_sd"]
                   and debug["sample_theta"])
    start_tausq = 0.1 if starting["tausq"] is None else float(starting["tausq"])
    lazy = settings["lazy_init"]
    if lazy is None:
        lazy = mcmc["burn"] > 0 and debug["sample_theta"]
    gen = torch.Generator(device=ms.device).manual_seed(seed)
    with trace.span("setup.init"):
        precomputed = None
        if lazy and do_curv:
            mcmcsd = subsample_curvature_sd(
                cs, mvs, ys, xs, tspec.spec, tspec.bounds, tspec.start,
                axis_cell_size=axis_size, K=K, device=ms.device,
                start_tausq=start_tausq, seed=seed, timings=tb)
        elif not lazy:
            precomputed, lls = prepare_chain(
                ms, tspec.bounds, tspec.start, gen, do_curvature=do_curv,
                start_tausq=start_tausq)
            if do_curv:
                mcmcsd = curvature_sd_from_lls(lls, tspec.n_theta)
        if mcmcsd is None:
            # the theta posterior contracts like 1/sqrt(n): the reference's
            # fixed 0.01 logit-scale proposal is far too wide at large n
            n_obs = max(np.isfinite(ys).sum(), 1)
            mcmcsd = min(0.01, 1.0 / (tspec.n_theta * np.sqrt(n_obs)))
        elif do_curv and verbose:
            print(f"[tune] curvature proposal sd: "
                  f"{np.array2string(np.sqrt(np.diag(mcmcsd)), precision=4)}")
        cfg = cfg._replace(mcmcsd=mcmcsd)
        start_w = starting["w"]
        if start_w is not None:
            start_w = np.asarray(start_w, dtype=np.float64).reshape(-1)[order]
        state = init_state(ms, tspec.bounds, tspec.start,
                           start_beta=starting["beta"],
                           start_tausq=start_tausq, start_w=start_w, cfg=cfg,
                           precomputed=precomputed)
        if n_chains > 1:
            state, gen = stack_chain_states(state,
                                            seed + c0 + np.arange(c_own))
    tb["init_s"] = round(rec.seconds("setup.init"), 2)
    return Fit(ms, tspec.bounds, cfg, state, gen, order, tree, sched, tb,
               fit_config, mesh=mesh)


def spamtree(y, x, coords, mv_id=None, cell_size=25, K=2, mcmc=None,
             settings=None, seed=1, dtype=torch.float32, verbose=False,
             device="cuda", limited_tree=False, checkpoint_path=None,
             resume_from=None, sink_dir=None, n_chains=1, devices=None,
             mesh=None, **knobs):
    """Fit a SpamTree model: fit + prediction in one MCMC run.

    y : (n,) response; NaN rows are predicted.
    x : (n, p) covariates.
    coords : (n, dd) coordinates.
    mv_id : (n,) outcome/margin labels (any label set); None = univariate.
    cell_size, K : target locations per tree block; branching per axis.
    mcmc : dict(keep=1000, burn=0, thin=1).
    settings : dict(chunk=50 kept samples per host transfer, collect="all"
        or "summary" (posterior mean/variance summed on the device, for
        large n), summary_draws=0 (summary mode: also keep ~this many
        strided w/yhat draws), wire_dtype=None (device->host type of the w
        draws: float16 for float32 models; "none" for none), adapting=True
        (RAM adapts the theta proposal), mcmcsd=None (initial proposal
        covariance, scalar s -> s*I or a matrix; None = tuned),
        curvature_sd=True (None mcmcsd: curvature-scaled diagonal; False:
        the isotropic min(0.01, 1/(n_theta sqrt(n_obs)))),
        ram_reference_warmup=False).  The JAX package's const_model,
        factor_dtype, lazy_init and tuner_overlap are taken at their
        defaults (lazy_init=False also: the tuner then runs on the full
        model); another value raises.
    elevation : with dd = 3 coordinates, the third column is elevation and
        the covariance is AG10 with elevation (model 2).
    start_level, tree_depth, last_not_reference, cherrypick_same_margin,
        cherrypick_group_locations, mvbias : the tree-shape and knot
        selection knobs of the reference's make_tree.R.
    prior : dict(btmlim=, toplim=, vlim=, set_unif_bounds=, beta=, tausq=,
        theta=): theta's uniform box, beta's Normal prior precision (scalar
        s -> s*I or a (p, p) matrix; 0.01), tausq's inverse-Gamma (a, b)
        ((2.01, 1)), an informative theta prior (model/priors.py; None =
        flat).
    starting : dict(beta=, tausq=, theta=, w=) starting values (w in the
        caller's row order).
    debug : dict(sample_beta=, sample_tausq=, sample_theta=, sample_w=,
        sample_predicts=) switch each sampler off.
    precompile : count the work of the iteration before the timed loop,
        as the JAX package's XLA cost analysis of its compiled keep chunk
        does: flops_per_kept_sample and bytes_per_kept_sample are the
        operations and bytes accessed of the ``thin`` iterations behind one
        kept draw (``utils.cost``: each part of the iteration counted once
        from shapes, the hand-written kernels by their own defined work,
        weighted by the part's calls in the keep loop; every chain's work
        with n_chains > 1; rank 0's shard on a mesh, the collectives as
        copies), the count's seconds setup_breakdown["work_count_s"] and
        each part's work "part_work"; without it all three are None.  It
        compiles nothing: on a CUDA device, alone or on an NCCL mesh,
        every iteration runs as replayed CUDA graphs, captured at the
        chain's first iteration (``mcmc.StepRunner``: the eager step's
        chain, bit for bit), whose seconds are
        setup_breakdown["keep_compile_s"] (each rank's own on a mesh) and
        the replays "graph_replays".  The CPU and gloo meshes run the
        eager step.
    seed : seeds the tree and the device generators (the yhat noise's
        among them).
    dtype : torch.float32 or torch.float64.
    device : where the model runs; "cuda" raises when CUDA is absent.
    limited_tree : each block conditions on its parent block's rows alone
        (reference make_tree.R), instead of on all its ancestors.
    checkpoint_path : the full sampler state and every generator are saved
        there after each chunk (the drain is then sequential).
    resume_from : a checkpoint of an earlier run with the SAME data and
        knobs: its state is loaded, no tuning runs, burn already run is
        skipped and only the remaining kept draws are sampled and returned;
        the w/beta/tausq/theta draws continue the uninterrupted run's
        exactly (same chunk size pinned).  ``keep`` may be raised to extend
        a finished run.
    sink_dir : w/yhat draws stream to ``w_mcmc.f32``/``yhat_mcmc.f32``
        there instead of host RAM (``utils.native.read_sink``); a resumed
        run appends.
    n_chains : C > 1 runs C chains as one batched step from the same tuned
        start, chain c's generator seeded ``seed + c``; the outputs carry
        the chain axis after the sample axis, as the JAX package's: w_mcmc,
        yhat_mcmc (keep, C, n), beta_mcmc (keep, C, p, q), tausq_mcmc
        (keep, C, q), theta_mcmc (keep, C, n_theta), with theta_rhat and
        theta_ess (from 4 kept draws) and accept_by_chain; summary moments
        are (C, n).
    devices, mesh : multi-device execution (the JAX package's knobs,
        spamtree_tpu/api.py:177-183; the analog of the reference's
        ``num_threads``, spamtree_fit.cpp:57-59).  ``devices="all"`` (every
        CUDA device) or a list such as ["cuda:0", "cuda:1"] or ["cpu"] * 4
        starts one worker process per device (NCCL for CUDA, gloo for CPU),
        on a chains x blocks mesh: chains shard over the devices when
        n_chains divides their count, the rest of the devices shard every
        level's block batch; the call returns rank 0's result, with the
        workers' start time in setup_breakdown["workers_start_s"] and
        "mesh": dict(devices, chains, blocks).  Every
        argument must pickle (a callable prior must be importable), and a
        device that is not there raises.  ``mesh=`` (parallel.mesh.
        make_mesh): every rank of a process group the caller started
        (torchrun style) calls spamtree with the same arguments and gets
        the same result; ``device`` is then the mesh rank's.  The sharded
        math equals the unsharded run's to float rounding
        (tests/test_torch_sharding.py).  An NCCL mesh (CUDA devices) runs
        graphed, its collectives captured in each rank's graphs
        (tests/test_torch_mesh_graphs.py); a gloo mesh (CPU devices, or
        CUDA ranks the caller started over gloo) runs eager.

    Returns a dict with w_mcmc, yhat_mcmc (keep, n), beta_mcmc (p, keep, q),
    tausq_mcmc (q, keep), theta_mcmc (n_theta, keep), order (outputs are in
    sorted-row order; order[i] is the original row), coords, mv_id,
    coordsinfo, accept_ratio, graph_replays, mcmc_time (iter_s of it in
    the iterations alone, save_s in the checkpoint saves, the rest in the
    drains; drain_work_s is the drains' own work, which overlaps the
    iterations when pipelined), burn_actual, paramsd,
    flops_per_kept_sample, bytes_per_kept_sample and part_work (None
    without precompile), resumed_at_iteration, resumed_kept_already,
    setup_breakdown, tree, schedule, theta_bounds, fit_config (what spamtree_predict needs) and,
    with collect="summary", w_mean, w_var, yhat_mean, yhat_var and
    summary_count.
    """
    if devices is not None:
        if mesh is not None:
            raise ValueError("pass devices= or mesh=, not both")
        from spamtree_tpu_torch.parallel.launch import launch, picklable

        devs, chains_ax = _build_mesh(devices, int(n_chains))
        kw = dict(y=y, x=x, coords=coords, mv_id=mv_id, cell_size=cell_size,
                  K=K, mcmc=mcmc, settings=settings, seed=seed, dtype=dtype,
                  verbose=verbose, device=device, limited_tree=limited_tree,
                  checkpoint_path=checkpoint_path, resume_from=resume_from,
                  sink_dir=sink_dir, n_chains=n_chains, **knobs)
        picklable(kw)
        out, info = launch("spamtree_tpu_torch.api:spamtree", kw, devs,
                           n_chains=chains_ax)
        out["setup_breakdown"]["workers_start_s"] = round(info["start_s"], 2)
        out["mesh"] = dict(devices=devs, chains=chains_ax,
                           blocks=len(devs) // chains_ax)
        return out
    fit = prepare_fit(y, x, coords, mv_id=mv_id, cell_size=cell_size, K=K,
                      mcmc=mcmc, settings=settings, seed=seed, dtype=dtype,
                      verbose=verbose, device=device,
                      limited_tree=limited_tree, resume_from=resume_from,
                      n_chains=n_chains, mesh=mesh, **knobs)
    r = fit.resume
    chains = fit.fit_config["n_chains"] > 1
    if mesh is not None and mesh.rank != 0:
        verbose = False
    res = (run_mcmc_chains if chains else run_mcmc)(
        fit.ms, fit.bounds, fit.cfg, fit.state, fit.gen, verbose=verbose,
        yhat_seed=seed, checkpoint_path=checkpoint_path, sink_dir=sink_dir,
        sink_append=r is not None,
        init_moments=r.init_moments if r else None,
        base_counts=r.base_counts if r else (0, 0),
        yhat_rngs=r.yhat_rngs if r else None, donate=True,
        count_work=bool(knobs.get("precompile", False)))
    # the JAX package's key for the keep program's compile
    fit.setup_breakdown["keep_compile_s"] = round(res["compile_time_s"], 2)
    if res["work_count_s"] is not None:
        fit.setup_breakdown["work_count_s"] = round(res["work_count_s"], 2)
    mv_id = (np.ones(len(fit.order), dtype=np.int64) if mv_id is None
             else np.asarray(mv_id, dtype=np.int64))
    tree = fit.tree
    cs = np.asarray(coords, dtype=np.float64)[fit.order]
    out = {
        "coords": cs,
        "mv_id": mv_id[fit.order],
        "order": fit.order,
        "coordsinfo": {"coords": cs, "block": tree.block_of_row,
                       "res": tree.res_of_row},
        # one chain: the reference's layouts; chains: (keep, C, ...)
        "w_mcmc": res["w"],
        "yhat_mcmc": res["yhat"],
        "beta_mcmc": (np.moveaxis(res["beta"], 0, 1)
                      if not chains and res["beta"].ndim >= 2
                      else res["beta"]),
        "tausq_mcmc": res["tausq"] if chains else res["tausq"].T,
        "theta_mcmc": res["theta"] if chains else res["theta"].T,
        "n_chains": fit.fit_config["n_chains"],
        "paramsd": res["paramsd"],
        "accept_ratio": res["accept_ratio"],
        "graph_replays": res["graph_replays"],
        "mcmc_time": res["mcmc_time"],
        "iter_s": res["iter_s"],
        "save_s": res["save_s"],
        "drain_work_s": res["drain_work_s"],
        "burn_actual": res["burn_actual"],
        "flops_per_kept_sample": res["flops_per_kept_sample"],
        "bytes_per_kept_sample": res["bytes_per_kept_sample"],
        "part_work": res["part_work"],
        "resumed_at_iteration": r.at_iteration if r else None,
        "resumed_kept_already": r.kept_already if r else None,
        "setup_breakdown": fit.setup_breakdown,
        "block_ct_obs": tree.block_ct_obs,
        "tree": tree,
        "schedule": fit.sched,
        "theta_bounds": fit.bounds,
        "fit_config": fit.fit_config,
    }
    if fit.cfg.collect == "summary":
        for k in ("w_mean", "w_var", "yhat_mean", "yhat_var",
                  "summary_count"):
            out[k] = res[k]
    if chains:
        out["accept_by_chain"] = res["accept_by_chain"]
        if res["theta"].ndim == 3 and res["theta"].shape[0] >= 4:
            # split-Rhat and bulk ESS of the (keep, C, n_theta) draws
            from spamtree_tpu_torch.utils.summaries import ess, rhat

            out["theta_rhat"] = rhat(res["theta"])
            out["theta_ess"] = ess(res["theta"])
    return out


def _torch_dtype(d) -> torch.dtype:
    """A fit's dtype (a torch dtype, or a numpy one from ``load_fit``)."""
    return d if isinstance(d, torch.dtype) else getattr(torch, np.dtype(d).name)


@trace.entry("spamtree_predict")
def spamtree_predict(fit, y, x, coords, coords_new, x_new, mv_id=None,
                     mv_id_new=None, n_draws=None, seed=1, chunk=32,
                     verbose=False, device="cuda"):
    """Posterior-predictive draws at NEW locations after a fit, no refit.

    The reference predicts only at NA rows of the original call
    (spamtree_model.cpp:1229-1358).  This rebuilds the fit's partition over
    the augmented data -- the tree depends on the OBSERVED rows alone, so
    every observed block is unchanged and the new locations attach to the
    prediction level by the same 1-NN rule -- then replays the fit's kept
    draws through ``predict_recompute``: for each kept (theta_s, w_s) the
    latent at the new locations is drawn from its treed-DAG conditional,
    and yhat adds X_new beta_s and observation noise.

    ``fit`` is a draw-collecting ``spamtree`` result (collect="all"),
    possibly through ``save_fit``/``load_fit``; ``y, x, coords, mv_id`` are
    the fit's inputs; ``coords_new (m, dd)``, ``x_new (m, p)``,
    ``mv_id_new`` the new locations.  ``n_draws`` subsamples the kept draws
    evenly (default all); ``chunk`` draws cross to the device per batch.
    The conditional-normal draws come from a device generator seeded with
    ``seed``, one (n + m + 1,) vector per draw in draw order, so the draws
    do not depend on ``chunk``; the observation noise from a numpy
    generator seeded with ``seed``.  On a CUDA device each draw replays a
    CUDA graph of one ``predict_recompute`` (``model.predict.DrawRunner``),
    the eager loop's draws bit for bit.

    Returns dict(w_pred (S, m), yhat_pred (S, m), draw_indices,
    predict_breakdown) in the row order of ``coords_new``;
    ``predict_breakdown`` holds the seconds of the call's spans (its trace
    record, ``utils.trace``): tree_s (``predict.tree``) and stage_s
    (``predict.model``) of ``predict.stage``; draws_s (``predict.draws``:
    the draw runner's set-up and the draws), of which capture_s
    (``predict.capture``) and upload_s (``predict.upload``: the fit's draws
    indexed on the host, copied and laid out on the device, chunk by
    chunk); and yhat_s (``predict.yhat``)."""
    rec = trace.current()
    with trace.span("predict.stage"):
        st = stage_predict(fit, y, x, coords, coords_new, x_new,
                           mv_id=mv_id, mv_id_new=mv_id_new, n_draws=n_draws,
                           device=device)
    with trace.span("predict.draws"):
        runner = DrawRunner(st.ms, st.theta_draws.shape[1], st.new_pos,
                            st.cc)
        w_pred = predict_draws(st, runner, seed, chunk, verbose)
        trace.count("predict.replays", runner.replays)
        runner.release()

    with trace.span("predict.yhat"):
        # yhat = X_new beta_s (own margin) + w_new + tausq noise, on the
        # host as the fit's yhat is
        sel, m = st.sel, len(st.new_pos)
        rng = np.random.default_rng(seed)
        mvn0 = np.searchsorted(st.uniq, st.mv_id_new)
        xb = np.einsum("np,spq->snq", st.x_new,
                       st.beta_draws[sel])[:, np.arange(m), mvn0]
        noise_sd = np.sqrt(st.tausq_draws[sel][:, mvn0])
        yhat_pred = xb + w_pred + noise_sd * rng.standard_normal(
            w_pred.shape)
    tb = dict(st.breakdown, **{k: round(rec.seconds(f"predict.{s}"), 3)
                               for k, s in (("draws_s", "draws"),
                                            ("capture_s", "capture"),
                                            ("upload_s", "upload"),
                                            ("yhat_s", "yhat"))})
    return {"w_pred": w_pred, "yhat_pred": yhat_pred, "draw_indices": sel,
            "predict_breakdown": tb}


class PredictStage(NamedTuple):
    """``spamtree_predict``'s model over the augmented data and the fit's
    draws mapped onto it (``stage_predict``)."""

    ms: ModelStatic
    cc: tuple  # level_coords(ms)
    sel: np.ndarray  # the kept draws predicted from
    w_draws: np.ndarray  # (S_all, n) the fit's, sorted rows, its dtype
    theta_draws: np.ndarray  # (S_all, n_theta)
    beta_draws: np.ndarray  # (S_all, p, q)
    tausq_draws: np.ndarray  # (S_all, q)
    w_src: torch.Tensor  # (n + m + 1,) each augmented row's fit row, or n
    new_pos: np.ndarray  # the new rows' augmented positions, caller's order
    x_new: np.ndarray
    mv_id_new: np.ndarray
    uniq: np.ndarray  # the fit's margin labels
    breakdown: dict  # tree_s, stage_s: spans predict.tree, predict.model


def stage_predict(fit, y, x, coords, coords_new, x_new, mv_id=None,
                  mv_id_new=None, n_draws=None,
                  device="cuda") -> PredictStage:
    """``spamtree_predict``'s checks, tree and model over the fit's data
    with the new rows appended, and the fit's draws mapped onto it; the
    tree and the model are the spans ``predict.tree``
    (``breakdown["tree_s"]``) and ``predict.model``
    (``breakdown["stage_s"]``)."""
    fc = fit.get("fit_config")
    if fc is None:
        raise ValueError("fit has no 'fit_config'; re-run spamtree() to use "
                         "spamtree_predict")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not available")
    w_draws = np.asarray(fit["w_mcmc"])
    theta_draws = np.asarray(fit["theta_mcmc"], dtype=np.float64)
    beta_draws = np.asarray(fit["beta_mcmc"], dtype=np.float64)
    tausq_draws = np.asarray(fit["tausq_mcmc"], dtype=np.float64)
    if fit.get("n_chains", 1) > 1:
        # every chain targets the posterior: (keep, C, ...) folds into
        # keep * C draws, as in the JAX package
        w_draws = w_draws.reshape(-1, w_draws.shape[-1])
        theta_draws = theta_draws.reshape(-1, theta_draws.shape[-1])
        beta_draws = beta_draws.reshape(-1, *beta_draws.shape[2:])
        tausq_draws = tausq_draws.reshape(-1, tausq_draws.shape[-1])
    else:
        # single chain: theta (n_theta, keep), beta (p, keep, q), tausq
        # (q, keep)
        theta_draws = theta_draws.T
        beta_draws = np.moveaxis(beta_draws, 1, 0)
        tausq_draws = tausq_draws.T
    S_all = w_draws.shape[0]
    if S_all == 0 or w_draws.shape[0] != theta_draws.shape[0]:
        raise ValueError("fit holds no full w draws (collect='summary'?); "
                         "spamtree_predict needs a draw-collecting fit")

    # normalize the original inputs exactly as spamtree() does
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    coords = np.asarray(coords, dtype=np.float64)
    n, dd = coords.shape
    if mv_id is None:
        mv_id = np.ones(n, dtype=np.int64)
    mv_id = np.asarray(mv_id, dtype=np.int64)
    if w_draws.shape[-1] != n:
        raise ValueError(f"fit draws cover {w_draws.shape[-1]} rows but "
                         f"y/coords have {n}; pass the SAME data the fit used")
    coords_new = np.asarray(coords_new, dtype=np.float64)
    if coords_new.ndim == 1:
        coords_new = coords_new[:, None]
    m = coords_new.shape[0]
    if coords_new.shape[1] != dd:
        raise ValueError(f"coords_new has {coords_new.shape[1]} columns, "
                         f"fit used {dd}")
    x_new = np.asarray(x_new, dtype=np.float64)
    if x_new.ndim == 1:
        x_new = x_new[:, None]
    if x_new.shape != (m, x.shape[1]):
        raise ValueError(f"x_new must be ({m}, {x.shape[1]})")
    if mv_id_new is None:
        mv_id_new = np.ones(m, dtype=np.int64)
    mv_id_new = np.asarray(mv_id_new, dtype=np.int64)
    uniq = np.asarray(fc["mv_labels"])
    if not np.isin(mv_id_new, uniq).all():
        raise ValueError("mv_id_new contains labels the fit never saw")
    q = len(uniq)

    # augmented dataset: the new rows are NA responses appended at the end
    y_aug = np.concatenate([y, np.full(m, np.nan)])
    x_aug = np.vstack([x, x_new])
    coords_aug = np.vstack([coords, coords_new])
    mv0_aug = np.searchsorted(uniq, np.concatenate([mv_id, mv_id_new]))
    n_aug = n + m
    order = np.lexsort(tuple(
        [np.arange(n_aug)] + [coords_aug[:, j] for j in range(dd - 1, -1, -1)]))
    ys, xs, cs, mvs = (y_aug[order], x_aug[order], coords_aug[order],
                       mv0_aug[order])
    na_which = np.isfinite(ys)

    tb = {}
    with trace.span("predict.tree") as sp:
        axis_size = (int(round(fc["cell_size"] ** (1.0 / dd)))
                     if np.isscalar(fc["cell_size"])
                     else np.asarray(fc["cell_size"]))
        tree = make_tree(
            cs, na_which, mvs, axis_cell_size=axis_size, K=fc["K"],
            start_level=fc["start_level"], tree_depth=fc["tree_depth"],
            last_not_reference=fc["last_not_reference"],
            limited_tree=fc["limited_tree"],
            cherrypick_same_margin=fc["cherrypick_same_margin"],
            cherrypick_group_locations=fc["cherrypick_group_locations"],
            mvbias=fc["mvbias"], rng=np.random.default_rng(fc["seed"]),
            verbose=False)
        # the observed rows, which alone drive the partition, landed in the
        # same blocks as in the fit
        fit_tree = fit.get("tree")
        if fit_tree is not None:
            obs_fit = np.isfinite(y[fit["order"]])
            if not np.array_equal(tree.block_of_row[na_which],
                                  np.asarray(fit_tree.block_of_row)[obs_fit]):
                raise RuntimeError("augmented partition diverged from the "
                                   "fit's on observed rows")
        sched = build_schedule(tree, limited_tree=fc["limited_tree"])
    tb["tree_s"] = round(sp.seconds, 2)
    tspec = make_theta_spec(
        dd, q, btmlim=fc["btmlim"] if fc["btmlim"] is not None else 1e-3,
        toplim=fc["toplim"] if fc["toplim"] is not None else 1e3,
        vlim=fc["vlim"], set_unif_bounds=fc["set_unif_bounds"],
        elevation=bool(fc.get("elevation", False)))
    with trace.span("predict.model") as sp:
        dt = _torch_dtype(fc["dtype"])
        ms = ModelStatic(sched, cs, mvs, ys, xs, tspec.spec, dtype=dt,
                         device=device)
        cc = level_coords(ms)
    tb["stage_s"] = round(sp.seconds, 2)

    # the fit's sorted-row w draws -> augmented sorted positions (old rows
    # only; every prediction row is redrawn by predict_recompute)
    inv_fit_order = np.empty(n, dtype=np.int64)
    inv_fit_order[fit["order"]] = np.arange(n)
    old_rows = order < n  # augmented sorted rows that the fit had
    src = inv_fit_order[order[old_rows]]
    new_pos_sorted = np.flatnonzero(~old_rows)
    new_pos = new_pos_sorted[np.argsort(order[~old_rows] - n)]  # caller's order
    # augmented sorted row r takes the fit's sorted row w_src[r]; the new
    # rows and the sentinel take a zero appended at n
    w_src = np.full(n_aug + 1, n, dtype=np.int64)
    w_src[:n_aug][old_rows] = src

    sel = (np.linspace(0, S_all - 1, int(n_draws)).round().astype(int)
           if n_draws is not None and n_draws < S_all else np.arange(S_all))
    return PredictStage(ms, cc, sel, w_draws, theta_draws, beta_draws,
                        tausq_draws, torch.as_tensor(w_src, device=ms.device),
                        new_pos, x_new, mv_id_new, uniq, tb)


def predict_draws(st: PredictStage, runner: DrawRunner, seed: int,
                  chunk: int = 32, verbose: bool = False) -> np.ndarray:
    """The (S, m) new-row draws of the kept draws ``st.sel`` through
    ``runner`` (a ``DrawRunner`` of ``st.ms``),
    ``chunk`` of them crossing to the device at a time and laid out on the
    augmented rows there; z from a device generator seeded ``seed``, one
    vector per draw in draw order.  Spans, per chunk: ``predict.upload``
    (the fit's draws indexed on the host, copied and laid out on the
    device) and ``predict.readback``."""
    ms, sel = st.ms, st.sel
    S, m, n_aug = len(sel), len(st.new_pos), ms.n
    gen = torch.Generator(device=ms.device).manual_seed(seed)
    fill_z = lambda z: torch.randn(n_aug + 1, generator=gen, dtype=ms.dtype,
                                   device=ms.device, out=z)
    w_pred = np.empty((S, m), dtype=np.float64)
    for lo in range(0, S, chunk):
        idx = sel[lo: lo + chunk]
        with trace.span("predict.upload"):
            w_fit = torch.as_tensor(st.w_draws[idx], device=ms.device).to(
                ms.dtype)
            wb_t = torch.cat([w_fit, w_fit.new_zeros(len(idx), 1)],
                             dim=1).index_select(1, st.w_src)
            th_t = torch.as_tensor(st.theta_draws[idx], dtype=ms.dtype,
                                   device=ms.device)
        out = torch.empty((len(idx), m), dtype=ms.dtype, device=ms.device)
        for i in range(len(idx)):
            out[i].copy_(runner.draw(th_t[i], wb_t[i], fill_z))
        with trace.span("predict.readback"):
            w_pred[lo: lo + len(idx)] = out.cpu().numpy()
        if verbose:
            print(f"[predict] draws {lo + len(idx)}/{S}")
    return w_pred
