"""User-facing API: ``spamtree()`` fit + predict in one MCMC run.

Port of the main path of ``spamtree_tpu/api.py`` (reference front-end
R/spamtree_fit.R): one chain on a full or limited tree, every kept draw
collected, prediction at the NaN rows.  The remaining knobs of the JAX
package raise NotImplementedError naming the knob.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from spamtree_tpu_torch.model.core import ModelStatic
from spamtree_tpu_torch.model.mcmc import MCMCConfig, init_state, run_mcmc
from spamtree_tpu_torch.model.params import auto_start_theta, make_theta_spec
from spamtree_tpu_torch.model.tuning import (
    curvature_sd_from_lls,
    prepare_chain,
    subsample_curvature_sd,
)
from spamtree_tpu_torch.tree.partition import make_tree
from spamtree_tpu_torch.tree.schedule import build_schedule

# knobs of spamtree_tpu.spamtree that this port does not run yet, with the
# default value it does run
_NOT_PORTED = dict(
    elevation=False, start_level=0, tree_depth=np.inf,
    last_not_reference=True, cherrypick_same_margin=True,
    cherrypick_group_locations=True, mvbias=0.0, prior=None, starting=None,
    debug=None, precompile=False, n_chains=1, checkpoint_path=None,
    resume_from=None, sink_dir=None, devices=None, mesh=None,
)


def _check_knobs(knobs: dict, settings: dict):
    for k, v in knobs.items():
        if k not in _NOT_PORTED:
            raise TypeError(f"spamtree() got an unexpected keyword {k!r}")
        d = _NOT_PORTED[k]
        if not (v is d or (np.isscalar(v) and np.isscalar(d) and v == d)):
            raise NotImplementedError(f"spamtree knob {k}={v!r} is not ported")
    for k in settings:
        if k not in ("chunk", "collect"):
            raise NotImplementedError(f"spamtree settings[{k!r}] is not ported")
    if settings.get("collect", "all") != "all":
        raise NotImplementedError(
            f"spamtree settings['collect']={settings['collect']!r} is not "
            "ported (only 'all')")


class Fit(NamedTuple):
    """Everything a run needs before its first iteration (``prepare_fit``)."""

    ms: ModelStatic
    bounds: np.ndarray
    cfg: MCMCConfig
    state: object  # model.mcmc.MCMCState
    gen: torch.Generator
    order: np.ndarray
    tree: object
    sched: object
    setup_breakdown: dict


def prepare_fit(y, x, coords, mv_id=None, cell_size=25, K=2, mcmc=None,
                settings=None, seed=1, dtype=torch.float32, verbose=False,
                device="cuda", limited_tree=False, **knobs) -> Fit:
    """Tree, schedule, model, tuned proposal and initial state of a
    ``spamtree`` run (same arguments), without running the chain."""
    settings = dict(settings or {})
    _check_knobs(knobs, settings)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not available")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                         f"got {dtype}")
    unknown = set(mcmc or {}) - {"keep", "burn", "thin"}
    if unknown:
        raise ValueError(f"unknown mcmc key(s) {sorted(unknown)}")
    mcmc = dict(keep=1000, burn=0, thin=1) | (mcmc or {})

    y = np.asarray(y, dtype=np.float64).reshape(-1)
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    coords = np.asarray(coords, dtype=np.float64)
    n, dd = coords.shape
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

    tb = {}  # setup breakdown: seconds per pre-MCMC phase
    t_ = time.time()
    tree = make_tree(cs, np.isfinite(ys), mvs, axis_cell_size=axis_size, K=K,
                     limited_tree=limited_tree,
                     rng=np.random.default_rng(seed), verbose=verbose)
    sched = build_schedule(tree, limited_tree=limited_tree)
    tb["tree_s"] = round(time.time() - t_, 2)
    tspec = make_theta_spec(dd, q, start_theta=auto_start_theta(
        dd, q, cs, ys, mvs))
    t_ = time.time()
    ms = ModelStatic(sched, cs, mvs, ys, xs, tspec.spec, dtype=dtype,
                     device=device)
    tb["stage_s"] = round(time.time() - t_, 2)

    # curvature-scaled initial proposal covariance (see model/tuning.py):
    # with burn, from a subsampled model, like the JAX package's default
    # path; without, from the full model together with the initial sweep
    gen = torch.Generator(device=ms.device).manual_seed(seed)
    t_ = time.time()
    if mcmc["burn"] > 0:
        precomputed = None
        mcmcsd = subsample_curvature_sd(
            cs, mvs, ys, xs, tspec.spec, tspec.bounds, tspec.start,
            axis_cell_size=axis_size, K=K, device=ms.device, seed=seed,
            timings=tb)
    else:
        precomputed, lls = prepare_chain(ms, tspec.bounds, tspec.start, gen)
        mcmcsd = curvature_sd_from_lls(lls, tspec.n_theta)
    if verbose:
        print(f"[tune] curvature proposal sd: "
              f"{np.array2string(np.sqrt(np.diag(mcmcsd)), precision=4)}")
    cfg = MCMCConfig(keep=mcmc["keep"], burn=mcmc["burn"], thin=mcmc["thin"],
                     mcmcsd=mcmcsd, chunk=int(settings.get("chunk", 50)))
    state = init_state(ms, tspec.bounds, tspec.start, cfg=cfg,
                       precomputed=precomputed)
    tb["init_s"] = round(time.time() - t_, 2)
    return Fit(ms, tspec.bounds, cfg, state, gen, order, tree, sched, tb)


def spamtree(y, x, coords, mv_id=None, cell_size=25, K=2, mcmc=None,
             settings=None, seed=1, dtype=torch.float32, verbose=False,
             device="cuda", limited_tree=False, **knobs):
    """Fit a SpamTree model: fit + prediction in one MCMC run.

    y : (n,) response; NaN rows are predicted.
    x : (n, p) covariates.
    coords : (n, dd) coordinates.
    mv_id : (n,) outcome/margin labels (any label set); None = univariate.
    cell_size, K : target locations per tree block; branching per axis.
    mcmc : dict(keep=1000, burn=0, thin=1).
    settings : dict(chunk=50 kept samples per host transfer, collect="all").
    seed : seeds the tree, the device generator and the host yhat noise.
    dtype : torch.float32 or torch.float64.
    device : where the model runs; "cuda" raises when CUDA is absent.
    limited_tree : each block conditions on its parent block's rows alone
        (reference make_tree.R), instead of on all its ancestors.

    Returns a dict with w_mcmc, yhat_mcmc (keep, n), beta_mcmc (p, keep, q),
    tausq_mcmc (q, keep), theta_mcmc (n_theta, keep), order (outputs are in
    sorted-row order; order[i] is the original row), accept_ratio,
    mcmc_time, burn_actual, paramsd, setup_breakdown, tree and schedule.
    """
    fit = prepare_fit(y, x, coords, mv_id=mv_id, cell_size=cell_size, K=K,
                      mcmc=mcmc, settings=settings, seed=seed, dtype=dtype,
                      verbose=verbose, device=device,
                      limited_tree=limited_tree, **knobs)
    res = run_mcmc(fit.ms, fit.bounds, fit.cfg, fit.state, fit.gen,
                   verbose=verbose, yhat_seed=seed)
    return {
        "w_mcmc": res["w"],
        "yhat_mcmc": res["yhat"],
        "beta_mcmc": (np.moveaxis(res["beta"], 0, 1) if res["beta"].ndim >= 2
                      else res["beta"]),
        "tausq_mcmc": res["tausq"].T,
        "theta_mcmc": res["theta"].T,
        "order": fit.order,
        "accept_ratio": res["accept_ratio"],
        "mcmc_time": res["mcmc_time"],
        "burn_actual": res["burn_actual"],
        "paramsd": res["paramsd"],
        "setup_breakdown": fit.setup_breakdown,
        "tree": fit.tree,
        "schedule": fit.sched,
    }
