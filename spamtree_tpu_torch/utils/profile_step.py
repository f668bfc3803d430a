"""Where one MCMC iteration's time goes, on one CUDA card.

    python -m spamtree_tpu_torch.utils.profile_step [--config 3] [--iters 20]
        [--ab k1|step|drain] [--chains 1,2,4]

Run from the repository root (it takes its data and the configuration's
own keywords, such as config 5's ``limited_tree=True``, from ``bench.py``).
Sets the chain up as ``spamtree`` does, runs warm-up iterations,
then times runs of ``--iters`` iterations on the host clock (synchronised)
with the variants of ``--ab`` in turns on the same chain:

* ``k1`` (default): the always-emit step with kernel K1 and with its plain
  version, five rounds of (K1, plain, plain, K1);
* ``step``: the always-emit theta step, the accept-aware step
  (``MCMCConfig(accept_aware=True)``) and the accept-aware step with the
  fused level kernels K3/K4 on (``SPAMTREE_LEVEL_KERNELS=1``), five rounds
  of (always-emit, accept-aware, accept-aware + kernels, and back).

* ``drain``: whole ``run_mcmc`` runs at the configuration's own keep,
  burn, thin and chunk instead of single iterations, all from one prepared
  chain and the same generator seed (so the same chain): collect="all"
  with the pipelined drain, the same with ``checkpoint_path`` (the
  sequential drain and a save after every chunk), and collect="summary";
  in turns (pipelined, sequential, summary, and back).  Each run
  prints a JSON line with mcmc_time and its split (iter_s, save_s, the
  drains' share and the drains' own work), then the medians; no trace.

``--chains 1,2,4`` (instead of ``--ab``): the batched step of
``run_mcmc_chains`` at each chain count C, always-emit ("C<C>") and
accept-aware ("C<C>_aa", ``MCMCConfig(accept_aware=True)`` with the gates
as the environment sets them), every C's chains stacked from the same
prepared state (``stack_chain_states``), beside the single-chain
always-emit step ("single"), timed in turns (three rounds forward and
back), then each traced once.  One JSON line per variant: ms per iteration
(untraced median), aggregate chain-iterations per second (C x 1000 / ms),
device-busy ms per iteration, idle share, kernels and K1 and K4 launches
per iteration, K1's device ms per iteration and the peak device memory;
then one line with the medians.

Otherwise it traces ``--iters`` iterations of each variant with
``torch.profiler`` and prints JSON lines: median ms per iteration of each
variant (untraced) and every run's, and per variant the device-busy ms per
iteration summed over the traced kernels, the device idle share (1 - busy /
untraced ms per iteration), the kernels per iteration, the hand-written
kernels' ms per iteration (K1 ``inv_chol_kernel``, K3 ``thin_gibbs_*_kernel``,
K4 ``thin_decision_kernel``) and the host time spent in the accept
decision's ``.item()`` (under the trace); the top-level keys repeat those of
the first variant (``k1``) or of the accept-aware step with the kernels
(``step``), whose top kernels by device time follow.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

KERNELS = {"k1": "inv_chol_kernel", "k3": "thin_gibbs_",
           "k4": "thin_decision_kernel"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--ab", choices=("k1", "step", "drain"), default="k1")
    ap.add_argument("--chains", default="",
                    help="comma-separated chain counts, e.g. 1,2,4")
    args = ap.parse_args()
    if args.chains:
        return chains_ab(args)
    if args.ab == "drain":
        return drain_ab(args.config)

    import bench
    from spamtree_tpu_torch.api import prepare_fit
    from spamtree_tpu_torch.model.core import level_coords, tausq_shape
    from spamtree_tpu_torch.model.mcmc import draw_step, make_step

    cfg = bench.CONFIGS[args.config]
    y, _, _, X, coords, mv = cfg["maker"]()
    fit = prepare_fit(y - np.nanmean(y), X, coords, mv_id=mv,
                      mcmc=dict(keep=1, burn=1, thin=1), device="cuda",
                      **cfg["kwargs"])
    ms, state = fit.ms, fit.state
    cc = level_coords(ms)
    shape = tausq_shape(ms, fit.cfg.tausq_ab)
    nt = state.theta.shape[0]
    always_emit = make_step(ms, fit.bounds, fit.cfg, coords_cache=cc)
    accept_aware = make_step(ms, fit.bounds,
                             fit.cfg._replace(accept_aware=True),
                             coords_cache=cc)
    # name -> (step, K1 on, SPAMTREE_LEVEL_KERNELS)
    variants = {
        "k1": {"k1": (always_emit, True, "0"),
               "plain_chol": (always_emit, False, "0")},
        "step": {"always_emit": (always_emit, True, "0"),
                 "accept_aware": (accept_aware, True, "0"),
                 "accept_aware_kernels": (accept_aware, True, "1")},
    }[args.ab]
    names = list(variants)
    order = (names + names[::-1]) * 5

    def run(s, k, name):
        step, ms.use_kernel, gate = variants[name]
        os.environ["SPAMTREE_LEVEL_KERNELS"] = gate
        for i in range(k):
            s = step(s, draw_step(ms, fit.gen, nt, shape), i % 2 == 1)
        torch.cuda.synchronize()
        return s

    state = run(state, args.warmup, names[-1])
    ab = {k: [] for k in names}
    for name in order:
        t0 = time.time()
        state = run(state, args.iters, name)
        ab[name].append(1e3 * (time.time() - t0) / args.iters)
    traced = names[0] if args.ab == "k1" else names[-1]

    def trace(name):
        """Device time, kernel count and accept-sync time per iteration of
        ``--iters`` traced iterations of variant ``name``."""
        nonlocal state
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        t0 = time.time()
        with torch.profiler.profile(activities=acts) as prof:
            state = run(state, args.iters, name)
        wall = time.time() - t0
        rows, sync_us = [], 0.0
        for e in prof.key_averages():
            if e.key == "aten::_local_scalar_dense":  # the accept's .item()
                sync_us += e.cpu_time_total
            if e.device_type == torch.autograd.DeviceType.CUDA:  # kernels
                rows.append((e.key, e.self_device_time_total, e.count))
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows) / 1e3 / args.iters
        med = float(np.median(ab[name]))
        return rows, dict(
            ms_per_iter=med, device_busy_ms_per_iter=busy,
            device_idle_share=1.0 - busy / med,
            **{f"{k}_ms_per_iter": sum(r[1] for r in rows if v in r[0])
               / 1e3 / args.iters for k, v in KERNELS.items()},
            sync_wait_ms_per_iter_traced=sync_us / 1e3 / args.iters,
            kernels_per_iter=sum(r[2] for r in rows) / args.iters,
            traced_ms_per_iter=1e3 * wall / args.iters)

    per_variant = {}
    for name in names:
        r, per_variant[name] = trace(name)
        if name == traced:
            rows = r
    out = dict(config=args.config, n=ms.n, limited_tree=ms.limited_tree,
               iters=args.iters, ab=args.ab,
               traced=traced, **per_variant[traced])
    for name in names:
        out[f"ms_per_iter_{name}"] = float(np.median(ab[name]))
        out[f"ab_runs_{name}"] = ab[name]
    out["per_variant"] = per_variant
    out["accept"] = state.ram.accept_count / max(state.ram.propos_count, 1.0)
    print(json.dumps(out))
    for name, us, count in rows[: args.top]:
        print(json.dumps(dict(kernel=name[:90], ms_per_iter=us / 1e3 / args.iters,
                              calls_per_iter=count / args.iters)))


def _trace(run, iters):
    """Device-busy ms, kernels and K1 device ms per iteration of
    ``run(iters)`` under ``torch.profiler``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(iters)
    busy = k1 = count = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.self_device_time_total
            count += e.count
            if KERNELS["k1"] in e.key:
                k1 += e.self_device_time_total
    return busy / 1e3 / iters, count / iters, k1 / 1e3 / iters


def chains_ab(args):
    """``--chains`` (see the module docstring)."""
    import bench
    from spamtree_tpu_torch.api import prepare_fit
    from spamtree_tpu_torch.model.core import level_coords, tausq_shape
    from spamtree_tpu_torch.model.mcmc import (
        draw_chains,
        draw_step,
        make_step,
        stack_chain_states,
    )
    from spamtree_tpu_torch.ops import chol, level

    c = bench.CONFIGS[args.config]
    y, _, _, X, coords, mv = c["maker"]()
    fit = prepare_fit(y - np.nanmean(y), X, coords, mv_id=mv,
                      mcmc=dict(keep=1, burn=1, thin=1), device="cuda",
                      **c.get("kwargs", {}))
    ms = fit.ms
    cc = level_coords(ms)
    shape = tausq_shape(ms, fit.cfg.tausq_ab)
    nt = fit.state.theta.shape[0]
    single = make_step(ms, fit.bounds, fit.cfg, coords_cache=cc)
    batched = make_step(ms, fit.bounds, fit.cfg, coords_cache=cc, chains=True)
    batched_aa = make_step(ms, fit.bounds, fit.cfg._replace(accept_aware=True),
                           coords_cache=cc, chains=True)
    variants = {"single": (1, single, fit.state, fit.gen)}
    for C in (int(x) for x in args.chains.split(",")):
        for tag, step in (("", batched), ("_aa", batched_aa)):
            states, gens = stack_chain_states(fit.state, 1 + np.arange(C))
            variants[f"C{C}{tag}"] = (C, step, states, gens)
    live = {k: v[2] for k, v in variants.items()}
    peak = {}

    def run(name, k):
        C, step, _, gens = variants[name]
        s = live[name]
        for i in range(k):
            d = (draw_step(ms, gens, nt, shape) if name == "single"
                 else draw_chains(ms, gens, nt, shape))
            s = step(s, d, i % 2 == 1)
        torch.cuda.synchronize()
        live[name] = s

    names = list(variants)
    for name in names:  # warm-up, and each variant's peak memory
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run(name, args.warmup)
        peak[name] = torch.cuda.max_memory_allocated() / 1e9
    ab = {k: [] for k in names}
    for name in (names + names[::-1]) * 3:
        t0 = time.time()
        run(name, args.iters)
        ab[name].append(1e3 * (time.time() - t0) / args.iters)
    rows = {}
    for name in names:
        C = variants[name][0]
        chol.LAUNCHES = level.LAUNCHES_DECISION = 0
        run(name, args.iters)
        k1_launches = chol.LAUNCHES / args.iters
        k4_launches = level.LAUNCHES_DECISION / args.iters
        busy, kernels, k1_ms = _trace(lambda k: run(name, k), args.iters)
        med = float(np.median(ab[name]))
        rows[name] = dict(
            variant=name, chains=C, ms_per_iter=med,
            chain_it_per_s=C * 1e3 / med, device_busy_ms_per_iter=busy,
            device_idle_share=1.0 - busy / med, kernels_per_iter=kernels,
            k1_launches_per_iter=k1_launches,
            k4_launches_per_iter=k4_launches, k1_ms_per_iter=k1_ms,
            peak_gb=peak[name], ab_runs=ab[name])
        print(json.dumps(rows[name]), flush=True)
    print(json.dumps(dict(config=args.config, n=ms.n, iters=args.iters,
                          ab="chains", **{
                              f"{k}_{name}": rows[name][k] for name in names
                              for k in ("ms_per_iter", "chain_it_per_s",
                                        "device_idle_share")})))


def drain_ab(config: int):
    """``--ab drain`` (see the module docstring)."""
    import tempfile

    import bench
    from spamtree_tpu_torch.api import prepare_fit
    from spamtree_tpu_torch.model.mcmc import run_mcmc

    c = bench.CONFIGS[config]
    y, _, _, X, coords, mv = c["maker"]()
    fit = prepare_fit(y - np.nanmean(y), X, coords, mv_id=mv,
                      mcmc=dict(keep=c["keep"], burn=c["burn"],
                                thin=c["thin"]),
                      settings=dict(chunk=c.get("chunk", 50)), device="cuda",
                      **c.get("kwargs", {}))
    names = ["pipelined", "sequential", "summary"]
    runs = {k: [] for k in names}
    with tempfile.TemporaryDirectory() as d:
        for name in names + names[::-1]:
            cfg = fit.cfg._replace(
                collect="summary" if name == "summary" else "all")
            gen = torch.Generator(device=fit.ms.device).manual_seed(1)
            ck = os.path.join(d, "ck.npz") if name == "sequential" else None
            r = run_mcmc(fit.ms, fit.bounds, cfg, fit.state, gen,
                         checkpoint_path=ck)
            rec = dict(mode=name, mcmc_time=r["mcmc_time"],
                       iter_s=r["iter_s"], save_s=r["save_s"],
                       drain_s=r["mcmc_time"] - r["iter_s"] - r["save_s"],
                       drain_work_s=r["drain_work_s"],
                       accept=r["accept_ratio"])
            runs[name].append(rec)
            print(json.dumps(rec), flush=True)
            del r
    print(json.dumps(dict(
        config=config, n=fit.ms.n, ab="drain", keep=c["keep"], burn=c["burn"],
        chunk=c.get("chunk", 50),
        **{f"{k}_{name}": float(np.median([r[k] for r in runs[name]]))
           for name in names
           for k in ("mcmc_time", "iter_s", "save_s", "drain_s",
                     "drain_work_s")})))


if __name__ == "__main__":
    main()
