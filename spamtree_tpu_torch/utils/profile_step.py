"""Where one MCMC iteration's time goes, on one CUDA card.

    python -m spamtree_tpu_torch.utils.profile_step [--config 3] [--iters 20]
        [--ab k1|step|drain] [--chains 1,2,4] [--eager]

It takes its data and the configuration's own keywords, such as config
5's ``limited_tree=True``, from ``spamtree_tpu_torch.bench`` (bench.py's).
Sets the chain up as ``spamtree`` does, runs warm-up iterations,
then times runs of ``--iters`` iterations on the host clock (synchronised)
with the variants of ``--ab`` in turns, each on its own chain from the
same start.  Every variant runs its iterations as ``run_mcmc`` does on the
card: replayed CUDA graphs (``mcmc.StepRunner``, captured at the first
iteration after the warm-up's first; ``--eager``: each variant also runs
as the eager step, ``<variant>_eager``, in the same turns).  The profiler
attributes the kernels of a replayed graph as it does eager launches (one
device event per kernel node); each variant's line also carries its graph
replays per iteration and its capture seconds:

* ``k1`` (default): the always-emit step with kernel K1 and with its plain
  version, five rounds of (K1, plain, plain, K1);
* ``step``: the always-emit theta step, the accept-aware step
  (``MCMCConfig(accept_aware=True)``) and the accept-aware step with the
  fused level kernels K3/K4 on (``SPAMTREE_LEVEL_KERNELS=1``), five rounds
  of (always-emit, accept-aware, accept-aware + kernels, and back).

* ``drain``: whole ``run_mcmc`` runs (graphed; eager with ``--eager``)
  at the configuration's own keep,
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
    ap.add_argument("--eager", action="store_true",
                    help="also run every variant as the eager step")
    args = ap.parse_args()
    if args.chains:
        return chains_ab(args)
    if args.ab == "drain":
        return drain_ab(args.config, args.eager)

    from spamtree_tpu_torch import bench
    from spamtree_tpu_torch.api import prepare_fit

    cfg = bench.CONFIGS[args.config]
    y, _, _, X, coords, mv = cfg["maker"]()
    fit = prepare_fit(y - np.nanmean(y), X, coords, mv_id=mv,
                      mcmc=dict(keep=1, burn=1, thin=1), device="cuda",
                      **cfg["kwargs"])
    ms = fit.ms
    aa = fit.cfg._replace(accept_aware=True)
    # name -> (config, K1 on, SPAMTREE_LEVEL_KERNELS)
    variants = {
        "k1": {"k1": (fit.cfg, True, "0"),
               "plain_chol": (fit.cfg, False, "0")},
        "step": {"always_emit": (fit.cfg, True, "0"),
                 "accept_aware": (aa, True, "0"),
                 "accept_aware_kernels": (aa, True, "1")},
    }[args.ab]
    if args.eager:
        variants |= {f"{k}_eager": v for k, v in variants.items()}
    names = list(variants)
    order = (names + names[::-1]) * 5
    # each variant's own chain from the same start: graphs are captured
    # with the variant's switches, at its first iteration past the first
    chains = {k: Iterations(fit, v[0], graphs=not k.endswith("_eager"))
              for k, v in variants.items()}

    def run(k, name):
        _, ms.use_kernel, gate = variants[name]
        os.environ["SPAMTREE_LEVEL_KERNELS"] = gate
        chains[name](k)

    for name in names:
        run(args.warmup, name)
    ab = {k: [] for k in names}
    for name in order:
        t0 = time.time()
        run(args.iters, name)
        ab[name].append(1e3 * (time.time() - t0) / args.iters)
    graphed = [n for n in names if not n.endswith("_eager")]
    traced = graphed[0] if args.ab == "k1" else graphed[-1]

    def trace(name):
        """Device time, kernel count and accept-sync time per iteration of
        ``--iters`` traced iterations of variant ``name``."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        reps = chains[name].replays
        t0 = time.time()
        with torch.profiler.profile(activities=acts) as prof:
            run(args.iters, name)
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
            traced_ms_per_iter=1e3 * wall / args.iters,
            graph_replays_per_iter=(chains[name].replays - reps) / args.iters,
            capture_s=chains[name].capture_s)

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
    st = chains[traced].state
    out["accept"] = st.ram.accept_count / max(st.ram.propos_count, 1.0)
    print(json.dumps(out))
    for name, us, count in rows[: args.top]:
        print(json.dumps(dict(kernel=name[:90], ms_per_iter=us / 1e3 / args.iters,
                              calls_per_iter=count / args.iters)))


class Iterations:
    """``it(k)``: k more iterations of one chain (predicting every other
    one, as thin=2 keeps), synchronised at the end -- replayed CUDA graphs
    (``mcmc.StepRunner``) with ``graphs``, else the eager step.  ``fit``
    from ``api.prepare_fit``; ``chains`` C > 0: C chains stacked from its
    state, generators seeded 1..C (one chain: ``fit.gen``).  ``replays``
    and ``capture_s``: the runner's (0 eager); ``state``: the live state."""

    def __init__(self, fit, cfg, chains: int = 0, graphs: bool = True,
                 n_iters: int = 100_000):
        from spamtree_tpu_torch.model.core import level_coords, tausq_shape
        from spamtree_tpu_torch.model.mcmc import (
            StepRunner,
            draw_chains,
            draw_step,
            make_step,
            stack_chain_states,
        )

        ms = fit.ms
        shape = tausq_shape(ms, cfg.tausq_ab)
        nt = fit.state.theta.shape[-1]
        state, gens = fit.state, fit.gen
        if chains:
            state, gens = stack_chain_states(fit.state, 1 + np.arange(chains))
        draw = ((lambda out=None: draw_chains(ms, gens, nt, shape, out=out))
                if chains else
                (lambda out=None: draw_step(ms, gens, nt, shape, out=out)))
        self.runner = self.step = None
        if graphs:
            self.runner = StepRunner(ms, fit.bounds, cfg, state, draw,
                                     chains=chains, n_iters=n_iters)
        else:
            self.step = make_step(ms, fit.bounds, cfg,
                                  coords_cache=level_coords(ms),
                                  chains=bool(chains))
            self._state, self.draw = state, draw

    def __call__(self, k: int):
        for i in range(k):
            if self.runner is not None:
                self.runner.step(i % 2 == 1)
            else:
                self._state = self.step(self._state, self.draw(), i % 2 == 1)
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    @property
    def state(self):
        return self.runner.state if self.runner is not None else self._state

    @property
    def replays(self):
        return self.runner.replays if self.runner is not None else 0

    @property
    def capture_s(self):
        return self.runner.capture_s if self.runner is not None else 0.0


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
    from spamtree_tpu_torch import bench
    from spamtree_tpu_torch.api import prepare_fit
    from spamtree_tpu_torch.ops import chol, level

    c = bench.CONFIGS[args.config]
    y, _, _, X, coords, mv = c["maker"]()
    fit = prepare_fit(y - np.nanmean(y), X, coords, mv_id=mv,
                      mcmc=dict(keep=1, burn=1, thin=1), device="cuda",
                      **c.get("kwargs", {}))
    ms = fit.ms
    aa = fit.cfg._replace(accept_aware=True)
    # name -> (C, config); C = 0: the single chain's step
    variants = {"single": (0, fit.cfg)}
    for C in (int(x) for x in args.chains.split(",")):
        variants |= {f"C{C}": (C, fit.cfg), f"C{C}_aa": (C, aa)}
    if args.eager:
        variants |= {f"{k}_eager": v for k, v in variants.items()}
    live = {k: Iterations(fit, cfg, chains=C,
                          graphs=not k.endswith("_eager"))
            for k, (C, cfg) in variants.items()}
    peak = {}

    def run(name, k):
        live[name](k)

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
        C = max(variants[name][0], 1)
        chol.LAUNCHES = level.LAUNCHES_DECISION = 0
        reps = live[name].replays
        run(name, args.iters)
        k1_launches = chol.LAUNCHES / args.iters
        k4_launches = level.LAUNCHES_DECISION / args.iters
        replays = (live[name].replays - reps) / args.iters
        busy, kernels, k1_ms = _trace(lambda k: run(name, k), args.iters)
        med = float(np.median(ab[name]))
        rows[name] = dict(
            variant=name, chains=C, ms_per_iter=med,
            chain_it_per_s=C * 1e3 / med, device_busy_ms_per_iter=busy,
            device_idle_share=1.0 - busy / med, kernels_per_iter=kernels,
            k1_launches_per_iter=k1_launches,
            k4_launches_per_iter=k4_launches, k1_ms_per_iter=k1_ms,
            graph_replays_per_iter=replays, capture_s=live[name].capture_s,
            peak_gb=peak[name], ab_runs=ab[name])
        print(json.dumps(rows[name]), flush=True)
    print(json.dumps(dict(config=args.config, n=ms.n, iters=args.iters,
                          ab="chains", **{
                              f"{k}_{name}": rows[name][k] for name in names
                              for k in ("ms_per_iter", "chain_it_per_s",
                                        "device_idle_share")})))


def drain_ab(config: int, eager: bool = False):
    """``--ab drain`` (see the module docstring); graphed, or eager with
    ``eager``."""
    import tempfile

    from spamtree_tpu_torch import bench
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
                         checkpoint_path=ck, graphs=not eager)
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
