"""The benchmark of ``spamtree_tpu_torch`` on NVIDIA cards.

    python3 -m benchmark.run --workload c3_biv1e5_single --seed 12345 \\
        --seconds 30 --trace 0

Runs one cell of ``BENCHMARK.json`` (a configuration under a traffic mix)
from the root of a checkout: makes the configuration's data from
``--seed``, sets the program up and warms it up, runs the window (a fixed
amount of work planned from ``--seconds``), checks what the window produced
against the benchmark's plain reference, and prints one JSON line last on
standard output.  ``--trace 1`` also profiles a stretch after the window
and reports the cell's per-layer metrics instead of its end-to-end ones.

Everything that belongs to one configuration, traffic mix, metric or cell
is a file found by its name: ``configs/<config>.json`` (sizes),
``traffic/<traffic>.json`` (the mix's parameters), ``metrics/<metric>.py``
(a reader ``read(ctx)`` of one metric, with an optional ``measure(ctx)``
that runs in the traced run) and ``limits/<cell>.json`` (the limit of each
number that decides ``correct``).  A new cell is new files and entries.

The run needs a CUDA card: without one, or with fewer cards than the cell
asks for, it exits 2 and prints no result.  It exits 3 if the process has
loaded JAX, flax or the JAX package (``spamtree_tpu``) once the window has
closed.
"""

import time

T_START = time.time()  # setup_s counts from here: the process's start

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "spamtree_tpu")
RAM_TARGET = 0.234  # the acceptance the adaptive theta proposal steers to


def _cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its CUDA libraries into its own ``build/``)."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: str, workload: str) -> dict:
    """The cell ``workload`` of ``root``'s BENCHMARK.json with its
    configuration, traffic, limits and the metrics it reports."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    bdir = os.path.join(root, "benchmark")
    return dict(
        cell=cell, config=_json(os.path.join(root, conf["file"])),
        traffic=_json(os.path.join(bdir, "traffic",
                                   cell["traffic"] + ".json")),
        limits=_json(os.path.join(bdir, "limits", workload + ".json")),
        end_to_end=e2e, per_layer=per_layer, root=root)


def metric_module(root: str, name: str):
    """``benchmark/metrics/<name>.py`` as a module."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub_seed(seed: int, *k: int) -> int:
    """A 32-bit seed derived from the run's ``seed`` and the tags ``k``."""
    import numpy as np

    return int(np.random.SeedSequence([int(seed), *k]).generate_state(1)[0])


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak(device) -> int:
    import torch

    return (int(torch.cuda.max_memory_allocated())
            if torch.device(device).type == "cuda" else 0)


def _free(device) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _prepare(spec: dict, seed: int, device: str, chains: int, chain: dict):
    """The data and ``api.prepare_fit`` of the cell, timed."""
    import numpy as np

    from benchmark import data
    from spamtree_tpu_torch import api

    conf = spec["config"]
    t0 = time.time()
    inputs = data.make(conf, seed, device)
    inputs["data_s"] = time.time() - t0
    y, X, coords, mv = (inputs[k] for k in ("y", "X", "coords", "mv"))
    ybar = float(np.nanmean(y))
    mod = conf["model"]
    # the tree's knots and the tuner from the configuration's seed, so that
    # every run of a cell has the same blocks; the chain from --seed
    fit_seed = int(mod["fit_seed"])
    t0 = time.time()
    fit = api.prepare_fit(
        y - ybar, X, coords, mv_id=mv, cell_size=mod["cell_size"],
        K=mod["K"], mcmc=dict(keep=chain["keep"], burn=chain["burn"],
                              thin=chain["thin"]),
        settings=dict(collect=chain["collect"], chunk=chain["chunk"]),
        seed=fit_seed, device=device, limited_tree=mod["limited_tree"],
        mvbias=mod["mvbias"], n_chains=chains)
    gens = fit.gen if chains > 1 else [fit.gen]
    for c, g in enumerate(gens):
        g.manual_seed(sub_seed(seed, 1, c))
    _sync(device)
    inputs.update(ybar=ybar, fit_seed=fit_seed)
    return fit, inputs, time.time() - t0


def _runner(chains: int):
    from spamtree_tpu_torch.model import mcmc

    return mcmc.run_mcmc if chains == 1 else mcmc.run_mcmc_chains


def _state_numbers(fit, state) -> dict:
    """What the reference judges in the chain's last state: theta, w, the
    log-determinant term it carries, and the quadratic form of w under the
    factors it carries, read in float64 (one entry per chain)."""
    import torch

    ms = fit.ms
    f64 = torch.float64
    w = state.w.to(f64)
    quad = torch.zeros(w.shape[:-1], dtype=f64, device=w.device)
    for t, lvl in enumerate(ms.levels):
        ld = state.leveldata[t]
        wx = w[..., lvl.rows]
        if lvl.prows.shape[1] > 0:
            wx = wx - torch.einsum("...bsp,...bp->...bs", ld.H.to(f64),
                                   w[..., lvl.prows])
        if ms.level_is_ref[t]:
            quad = quad - 0.5 * torch.einsum("...bs,...bst,...bt->...", wx,
                                             ld.prec.to(f64), wx)
        else:
            quad = quad - 0.5 * (ld.prec.to(f64) * wx * wx).sum((-1, -2))
    lead = state.theta.shape[:-1]
    return dict(theta=state.theta.to(f64).reshape(-1, state.theta.shape[-1]
                                                  ).cpu().numpy(),
                w=w[..., :ms.n].reshape(-1, ms.n).cpu().numpy(),
                logdet=state.logdetCi.to(f64).reshape(-1).cpu().numpy(),
                quad=quad.reshape(-1).cpu().numpy(), chains=int(
                    math.prod(lead)) if lead else 1)


def _draw_numbers(res: dict, chains: int, held) -> dict:
    """What the check needs of the window's kept draws: the last one (per
    chain); the share of consecutive draws whose w repeats, per chain,
    worst chain; and the posterior means of beta and, at the held-out rows
    ``held``, of w (per chain)."""
    import numpy as np

    def per_chain(x):
        return x if chains > 1 else x[:, None]

    w = per_chain(res["w"])[..., :4096]
    same = np.array([[np.array_equal(w[k, c], w[k + 1, c])
                      for c in range(w.shape[1])]
                     for k in range(len(w) - 1)])
    return dict(w_repeat_share=float(same.mean(0).max()) if len(same)
                else 0.0,
                beta_mean=per_chain(res["beta"]).mean(0, dtype=np.float64),
                heldout_w_mean=per_chain(res["w"])[..., held].mean(
                    0, dtype=np.float64),
                **{k: per_chain(res[k])[-1]
                   for k in ("w", "yhat", "beta", "tausq", "theta")})


def _reference_tree(spec: dict, inputs: dict, coords, mv, y):
    """The benchmark's own tree and schedule over sorted rows (frozen copy)."""
    import numpy as np

    from benchmark.reference import partition, schedule

    mod = spec["config"]["model"]
    dd = coords.shape[1]
    tree = partition.make_tree(
        coords, np.isfinite(y), mv,
        axis_cell_size=int(round(mod["cell_size"] ** (1.0 / dd))),
        K=mod["K"], limited_tree=mod["limited_tree"], mvbias=mod["mvbias"],
        rng=np.random.default_rng(inputs["fit_seed"]))
    return tree, schedule.build_schedule(tree,
                                         limited_tree=mod["limited_tree"])


def _sorted(inputs: dict):
    """(order, coords, 0-based margins, y) sorted as the program sorts
    rows: by coordinates, then by original index."""
    import numpy as np

    coords = inputs["coords"]
    n, dd = coords.shape
    order = np.lexsort(tuple([np.arange(n)]
                             + [coords[:, j] for j in range(dd - 1, -1, -1)]))
    mv = inputs["mv"]
    mv = np.zeros(n, np.int64) if mv is None else mv
    mv0 = np.searchsorted(np.unique(mv), mv)
    return order, coords[order], mv0[order], inputs["y"][order]


def tree_diff(tree, sched, prog_tree, prog_sched) -> int:
    """Entries in which the program's tree and schedule differ from the
    frozen copy's: row assignments, levels, parents and every level
    plan's arrays (a differing shape counts all its entries)."""
    import numpy as np

    def diff(a, b):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            return max(a.size, b.size, 1)
        return int((a != b).sum())

    d = diff(tree.block_of_row, prog_tree.block_of_row)
    d += diff(tree.res_of_row, prog_tree.res_of_row)
    d += diff(tree.block_level, prog_tree.block_level)
    d += abs(len(tree.parents) - len(prog_tree.parents))
    d += sum(diff(a, b) for a, b in zip(tree.parents, prog_tree.parents))
    plans = list(sched.levels) + ([sched.pred] if sched.pred else [])
    pplans = list(prog_sched.levels) + (
        [prog_sched.pred] if prog_sched.pred else [])
    d += abs(len(plans) - len(pplans))
    for a, b in zip(plans, pplans):
        for k in ("rows", "prows", "lp_pos", "block_ids"):
            d += diff(getattr(a, k), getattr(b, k))
    return d


def check_fit(spec, inputs, st, dr, tree, sched, prog_tree, prog_sched,
              device) -> dict:
    """The numbers that decide ``correct`` in a fit cell (see PERF.md):

    - ``tree_diff``: the program's tree and schedule against the frozen
      copy's, entry by entry;
    - ``quad_gap``: the largest relative gap, over chains, between the
      quadratic form of w under the factors that the chain's last state
      carries and the reference's at the same theta and w (every observed
      block's covariance, factor and conditional); ``logdet_gap``, the same
      for the log-determinant term, is computed but has no limit (PERF.md:
      sound float32 runs and the faults overlap);
    - ``heldout_z2_gap``: | mean z^2 - 1 | over the held-out rows of the last
      kept draw, z = (w - mean) / sd under the reference's conditional
      given that draw's theta and w at the reference rows, worst chain;
    - ``yhat_z2_gap``: | mean z^2 - 1 |, z = (yhat - X beta - w) / tau, over
      every row of the last kept draw, worst chain;
    - ``heldout_err``: the fit against the data: the mean over the held-out
      rows of (X beta + w - mu)^2 / tau^2, worst chain, with beta and w the
      means of the window's kept draws, mu the data's noise-free mean
      X B + w and tau^2 its noise variance;
    - ``w_repeat_share``: the share of consecutive kept draws whose w is
      the same (on its first 4096 rows), worst chain: the Gibbs sweep moves
      w at every iteration;
    - ``accept_log_gap``: | log(acceptance / 0.234) |, worst chain: the
      theta step's acceptance over the chain against the target that its
      adaptive proposal steers to (a step whose proposals all fail reads
      infinity)."""
    import numpy as np
    import torch

    from benchmark.reference import density

    f64 = torch.float64
    dev = torch.device(device)
    order, cs, mvs, ys = _sorted(inputs)
    q = int(mvs.max()) + 1
    coords_t = torch.as_tensor(cs, dtype=f64, device=dev)
    mv_t = torch.as_tensor(mvs, device=dev)
    blocks = density.Blocks(tree)
    out = dict(tree_diff=tree_diff(tree, sched, prog_tree, prog_sched))
    ld_gap = quad_gap = 0.0
    for c in range(st["chains"]):
        th = torch.as_tensor(st["theta"][c], dtype=f64, device=dev)
        w = torch.as_tensor(st["w"][c], dtype=f64, device=dev)
        try:
            ld, qd = density.loglik_parts(blocks, th, q, coords_t, mv_t, w)
        except (RuntimeError, np.linalg.LinAlgError):
            ld = qd = float("nan")
        ld_gap = _worst(ld_gap, _rel(st["logdet"][c], ld))
        quad_gap = _worst(quad_gap, _rel(st["quad"][c], qd))
        print(f"state of chain {c}: theta {st['theta'][c].tolist()} logdet "
              f"{st['logdet'][c]!r} / {ld!r} quad {st['quad'][c]!r} / "
              f"{qd!r} (program / reference)", file=sys.stderr)
    out["logdet_gap"], out["quad_gap"] = ld_gap, quad_gap
    miss = ~np.isfinite(ys)
    X = inputs["X"][order]
    z2_pred = z2_y = 0.0
    for c in range(dr["w"].shape[0]):
        th = torch.as_tensor(dr["theta"][c], dtype=f64, device=dev)
        w = torch.as_tensor(dr["w"][c], dtype=f64, device=dev)
        rows, mean, var, _ = density.predictive(blocks, th, q, coords_t,
                                                mv_t, w)
        z = (w[rows] - mean) / torch.sqrt(var.clamp(min=1e-300))
        ok = int(rows.numel()) == int(miss.sum())
        z2_pred = _worst(z2_pred, abs(float((z * z).mean()) - 1.0) if ok
                         else float("inf"))
        xb = np.einsum("ip,ip->i", X, dr["beta"][c][:, mvs].T)
        e = ((dr["yhat"][c] - xb - dr["w"][c])
             / np.sqrt(dr["tausq"][c][mvs]))
        z2_y = _worst(z2_y, abs(float(np.mean(e * e)) - 1.0))
    out["heldout_z2_gap"], out["yhat_z2_gap"] = z2_pred, z2_y
    mu, tau2 = (inputs[k][order][miss] for k in ("mu", "noise_var"))
    fit = (np.einsum("ip,cpi->ci", X[miss], dr["beta_mean"][..., mvs[miss]])
           + dr["heldout_w_mean"] + inputs["ybar"])
    out["heldout_err"] = float(((fit - mu) ** 2 / tau2).mean(-1).max())
    # what the same number reads for a fit without w (least squares per
    # margin over the observed rows): how strong this seed's field is
    obs, ls = ~miss, np.zeros(miss.sum())
    for j in range(q):
        o, m = obs & (mvs == j), miss[mvs == j]
        b = np.linalg.lstsq(X[o], ys[o] - inputs["ybar"], rcond=None)[0]
        ls[mvs[miss] == j] = X[mvs == j][m] @ b + inputs["ybar"]
    print(f"heldout_err {out['heldout_err']!r}; without w "
          f"{float(((ls - mu) ** 2 / tau2).mean())!r}", file=sys.stderr)
    out["w_repeat_share"] = dr["w_repeat_share"]
    acc = np.atleast_1d(np.asarray(dr["accept"], dtype=np.float64))
    with np.errstate(divide="ignore"):
        out["accept_log_gap"] = float(np.max(np.abs(np.log(
            acc / RAM_TARGET))))
    return out


def _worst(a: float, b: float) -> float:
    """The larger of two gaps; a gap that is not a number is infinite."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return float("inf")
    return max(a, b)


def _rel(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)) or b == 0:
        return float("inf")
    return abs(a - b) / abs(b)


def run_fit(spec, seed, seconds, trace, device, ctx) -> dict:
    """A fit cell: prepare_fit and a short warm-up in set-up, then one
    chain call (``run_mcmc`` or ``run_mcmc_chains``, graphed on the card)
    that carries the burn and keeps a number of draws planned from
    ``seconds``, continuing the warmed-up chain in memory."""
    import numpy as np
    import torch

    traffic, conf = spec["traffic"], spec["config"]
    C = int(traffic["chains"])
    chain = dict(conf["chain"], collect=traffic["collect"],
                 chunk=traffic["chunk"])
    chain["burn"] = int(traffic.get("burn", chain["burn"]))
    fit, inputs, ctx["prepare_fit_s"] = _prepare(spec, seed, device, C,
                                                 chain)
    run = _runner(C)
    yseed = sub_seed(seed, 2)
    t0 = time.time()
    # warm-up: both iteration variants (predicting or not), a capture and
    # a drain, on the live chain
    res = run(fit.ms, fit.bounds, fit.cfg._replace(burn=1, keep=2, chunk=2),
              fit.state, fit.gen, yhat_seed=yseed, donate=True)
    state = res["state"]
    del res
    _sync(device)
    ctx["setup_s"] = time.time() - T_START
    ctx["setup_parts"] = dict(data_s=inputs["data_s"],
                              prepare_fit_s=ctx["prepare_fit_s"],
                              warm_up_s=time.time() - t0)

    thin, burn = chain["thin"], chain["burn"]
    planned = seconds * float(traffic["planned_iters_per_s"])
    keep = max(int(traffic["min_keep"]),
               int(math.ceil((planned - burn) / thin)))
    cfg = fit.cfg._replace(burn=burn, keep=keep, thin=thin,
                           chunk=chain["chunk"], collect=chain["collect"])
    t0 = time.time()
    res = run(fit.ms, fit.bounds, cfg, state, fit.gen, yhat_seed=yseed,
              donate=True)
    ctx["window_s"] = time.time() - t0
    ctx["peak_bytes"] = _peak(device)
    iters = res["burn_actual"] + keep * thin
    ctx.update(iters=iters, chain_iters=iters * C, chains=C,
               replays=res["graph_replays"], attempted=iters * C, failed=0,
               thin=thin, n=fit.ms.n, tree=None)
    state = res["state"]
    order, cs, mvs, ys = _sorted(inputs)
    dr = _draw_numbers(res, C, ~np.isfinite(ys))
    dr["accept"] = res.get("accept_by_chain", res["accept_ratio"])
    del res
    if trace:
        pk = int(traffic["profile_keep"])
        pcfg = cfg._replace(burn=0, keep=pk)
        res, prof, wall = _trace_mod().profiled(
            lambda: run(fit.ms, fit.bounds, pcfg, state, fit.gen,
                        yhat_seed=yseed, donate=True))
        state = res["state"]
        # from the first replay after the captures on; its iterations are
        # its graph launches over the window's launches per iteration
        on_card = torch.device(device).type == "cuda"
        p = _trace_mod().reduce(prof, wall, after="cudaGraphLaunch"
                                if on_card else None)
        per_it = ctx["replays"] / ctx["iters"] if ctx["replays"] else 0
        ctx["profile"] = dict(p, iters=(p["launches"] / per_it
                                        if p["launches"] and per_it
                                        else pk * thin))
        del res, prof
    st = _state_numbers(fit, state)
    prog_tree, prog_sched = fit.tree, fit.sched
    del state, fit
    _free(device)
    tree, sched = _reference_tree(spec, inputs, cs, mvs, ys)
    ctx.update(tree=tree, sched=sched)
    if trace:
        _measure(spec, ctx)
    return check_fit(spec, inputs, st, dr, tree, sched, prog_tree,
                     prog_sched, device)


def _trace_mod():
    from benchmark import trace

    return trace


def _measure(spec, ctx) -> None:
    """The traced run's own measurements of the cell's per-layer metrics
    (``measure(ctx)`` of a metric's reader, where it has one)."""
    for m in spec["per_layer"]:
        mod = metric_module(spec["root"], m["name"])
        if hasattr(mod, "measure"):
            mod.measure(ctx)


def _new_sites(traffic, seed: int, k: int, p: int, labels):
    """Call ``k``'s new locations: uniform on the unit square, the margins
    in ``margin_share`` (exact counts), covariates standard normal."""
    import numpy as np

    rng = np.random.default_rng(sub_seed(seed, 3, k))
    m = int(traffic["m_new"])
    coords = rng.uniform(size=(m, 2))
    counts = [int(m * s) for s in traffic["margin_share"]]
    counts[0] += m - sum(counts)
    mv = np.concatenate([np.full(c, lab) for c, lab in zip(counts, labels)])
    rng.shuffle(mv)
    return coords, rng.normal(size=(m, p)), mv


def run_predict(spec, seed, seconds, trace, device, ctx) -> dict:
    """The predict cell: the set-up fits the configuration as ``spamtree``
    does (``prepare_fit`` and ``run_mcmc`` at the traffic's ``fit``); the
    window makes whole ``api.spamtree_predict`` calls, each at fresh new
    locations, over every kept draw."""
    import numpy as np

    from spamtree_tpu_torch import api

    traffic = spec["traffic"]
    chain = dict(traffic["fit"])
    fit, inputs, ctx["prepare_fit_s"] = _prepare(spec, seed, device, 1,
                                                 chain)
    t0 = time.time()
    res = _runner(1)(fit.ms, fit.bounds, fit.cfg, fit.state, fit.gen,
                     yhat_seed=sub_seed(seed, 2), donate=True)
    fitd = {"w_mcmc": res["w"], "theta_mcmc": res["theta"].T,
            "beta_mcmc": np.moveaxis(res["beta"], 0, 1),
            "tausq_mcmc": res["tausq"].T, "fit_config": fit.fit_config,
            "order": fit.order, "tree": fit.tree, "n_chains": 1}
    prog_tree, prog_sched = fit.tree, fit.sched
    del res, fit
    _sync(device)
    ctx["setup_s"] = time.time() - T_START
    ctx["setup_parts"] = dict(data_s=inputs["data_s"],
                              prepare_fit_s=ctx["prepare_fit_s"],
                              fit_s=time.time() - t0)

    y, X, coords, mv = (inputs["y"] - inputs["ybar"], inputs["X"],
                        inputs["coords"], inputs["mv"])
    labels = np.unique(mv)
    calls = max(1, int(round(seconds * float(traffic["planned_calls_per_s"]))))
    outs, sites, seeds = [], [], []
    t0 = time.time()
    for k in range(calls):
        cn, xn, mn = _new_sites(traffic, seed, k, X.shape[1], labels)
        s_k = sub_seed(seed, 4, k)
        outs.append(api.spamtree_predict(
            fitd, y, X, coords, cn, xn, mv_id=mv, mv_id_new=mn, seed=s_k,
            chunk=int(traffic["predict_chunk"]), device=device))
        sites.append((cn, xn, mn))
        seeds.append(s_k)
    ctx["window_s"] = time.time() - t0
    ctx["peak_bytes"] = _peak(device)
    S = fitd["w_mcmc"].shape[0]
    ctx.update(calls=calls, draws=sum(o["w_pred"].shape[0] for o in outs),
               attempted=calls * S, chains=1, n=len(y), tree=None,
               predict_breakdowns=[o["predict_breakdown"] for o in outs])
    ctx["failed"] = ctx["attempted"] - ctx["draws"]
    if trace:
        cn, xn, mn = _new_sites(traffic, seed, calls, X.shape[1], labels)
        _, prof, wall = _trace_mod().profiled(lambda: api.spamtree_predict(
            fitd, y, X, coords, cn, xn, mv_id=mv, mv_id_new=mn,
            seed=sub_seed(seed, 4, calls),
            chunk=int(traffic["predict_chunk"]), device=device))
        ctx["profile"] = dict(_trace_mod().reduce(prof, wall), draws=S)
        del prof
    _free(device)
    order, cs, mvs, ys = _sorted(inputs)
    tree, sched = _reference_tree(spec, inputs, cs, mvs, ys)
    ctx.update(tree=tree, sched=sched)
    if trace:
        _measure(spec, ctx)
    out = dict(tree_diff=tree_diff(tree, sched, prog_tree, prog_sched))
    out.update(check_predict(spec, inputs, fitd, outs, sites, seeds, seed,
                             device))
    return out


def check_predict(spec, inputs, fitd, outs, sites, seeds, seed,
                  device, stand_in=None) -> dict:
    """The numbers that decide ``correct`` in the predict cell (see
    PERF.md):

    - ``new_w_gap``: the largest gap, over a sample of the last call's
      draws drawn from the seed (its last draw among them) and over its new
      locations, between the program's draw of w and the reference's: the
      conditional mean given the fit draw's w at the reference ancestors
      plus the conditional sd times the same standard normal (the call's
      generator, one (n + m + 1,) vector per draw in draw order, at the
      row's position among the augmented sorted rows), over the prior sd;
    - ``new_yhat_z2_gap``: | mean z^2 - 1 | over every call's draws and new
      locations, z = (yhat - x beta - w) / tau.

    ``stand_in`` (the control): the reference in float32 with its products'
    inputs in TF32 stands in for the program's draws."""
    import numpy as np
    import torch

    from benchmark.reference import density, partition

    f64 = torch.float64
    dev = torch.device(device)
    conf = spec["config"]["model"]
    traffic = spec["traffic"]
    y, X, coords, mv = (inputs["y"], inputs["X"], inputs["coords"],
                        inputs["mv"])
    labels = np.unique(mv)
    th_all = np.asarray(fitd["theta_mcmc"]).T
    beta_all = np.moveaxis(np.asarray(fitd["beta_mcmc"]), 1, 0)
    tau_all = np.asarray(fitd["tausq_mcmc"]).T
    z2 = 0.0
    for o, (cn, xn, mn) in zip(outs, sites):
        m0 = np.searchsorted(labels, mn)
        xb = np.einsum("np,spq->snq", xn, beta_all)
        xb = xb[:, np.arange(len(mn)), m0]
        e = (o["yhat_pred"] - xb - o["w_pred"]) / np.sqrt(tau_all[:, m0])
        z2 = _worst(z2, abs(float(np.mean(e * e)) - 1.0))

    # the last call, rebuilt by the reference over the augmented rows
    (cn, xn, mn), out, s_k = sites[-1], outs[-1], seeds[-1]
    n, m = len(y), len(cn)
    c_aug = np.vstack([coords, cn])
    y_aug = np.concatenate([y, np.full(m, np.nan)])
    mv_aug = np.searchsorted(labels, np.concatenate([mv, mn]))
    dd = c_aug.shape[1]
    order = np.lexsort(tuple([np.arange(n + m)]
                             + [c_aug[:, j] for j in range(dd - 1, -1, -1)]))
    cs, ys, mvs = c_aug[order], y_aug[order], mv_aug[order]
    tree = partition.make_tree(
        cs, np.isfinite(ys), mvs,
        axis_cell_size=int(round(conf["cell_size"] ** (1.0 / dd))),
        K=conf["K"], limited_tree=conf["limited_tree"],
        mvbias=conf["mvbias"], rng=np.random.default_rng(inputs["fit_seed"]))
    blocks = density.Blocks(tree)
    new_sorted = order >= n
    new_pos_sorted = np.flatnonzero(new_sorted)
    new_pos = new_pos_sorted[np.argsort(order[new_sorted] - n)]
    inv_fit = np.empty(n, dtype=np.int64)
    inv_fit[np.asarray(fitd["order"])] = np.arange(n)
    old = ~new_sorted
    src = inv_fit[order[old]]
    q = len(labels)
    coords_t = torch.as_tensor(cs, dtype=f64, device=dev)
    mv_t = torch.as_tensor(mvs, device=dev)
    S = out["w_pred"].shape[0]
    rng = np.random.default_rng(sub_seed(seed, 5))
    k_chk = int(traffic["check_draws"])
    picks = sorted(set(rng.choice(S, size=min(k_chk, S) - 1,
                                  replace=False).tolist()) | {S - 1})
    sel = out["draw_indices"]
    gen = torch.Generator(device=dev).manual_seed(s_k)
    gap = 0.0
    w_draws = np.asarray(fitd["w_mcmc"])
    for i in range(S):
        z = torch.randn(n + m + 1, generator=gen, dtype=torch.float32,
                        device=dev)
        if i not in picks:
            continue
        s = sel[i]
        w_aug = np.zeros(n + m)
        w_aug[old] = w_draws[s][src]
        idx = torch.as_tensor(new_pos, device=dev)

        def draw(dt):
            rows, mean, var, prior = density.predictive(
                blocks, torch.as_tensor(th_all[s], dtype=dt, device=dev), q,
                coords_t.to(dt), mv_t,
                torch.as_tensor(w_aug, dtype=dt, device=dev),
                only_rows=new_sorted, tf32=dt == torch.float32)
            ref = torch.zeros(n + m, dtype=f64, device=dev)
            sd0 = torch.ones(n + m, dtype=f64, device=dev)
            r = torch.where(torch.isfinite(var) & (var > 0), var, 0.0)
            ref[rows] = (mean + torch.sqrt(r) * z[rows].to(dt)).to(f64)
            sd0[rows] = torch.sqrt(prior).to(f64)
            return ref[idx], sd0[idx]

        ref, sd0 = draw(f64)
        prog = (draw(stand_in)[0] if stand_in is not None else
                torch.as_tensor(out["w_pred"][i], dtype=f64, device=dev))
        g = ((prog - ref).abs() / sd0).max()
        gap = _worst(gap, float(g))
    return dict(new_w_gap=gap, new_yhat_z2_gap=z2)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """Run the cell ``spec`` (``load_spec``) once; returns the result line's
    object, with the numbers compared under ``checks``."""
    import torch

    import spamtree_tpu_torch  # noqa: F401  (pins full-precision f32)

    t_import = time.time() - T_START

    ctx = dict(spec=spec, seed=seed, seconds=seconds, device=device,
               config=spec["config"], traffic=spec["traffic"])
    entry = {"fit": run_fit, "predict": run_predict}[
        spec["traffic"]["entry"]]
    numbers = entry(spec, seed, seconds, trace, device, ctx)
    limits = spec["limits"]
    checks = {k: dict(value=numbers[k], limit=limits[k]) for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        v = metric_module(spec["root"], m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    cuda = torch.device(device).type == "cuda"
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=int(spec["cell"]["chips"]),
               memory_peak_bytes=ctx.get("peak_bytes", 0))
    out = dict(correct=bool(correct), attempted=int(ctx["attempted"]),
               failed=int(ctx["failed"]), metrics=metrics, device=dev)
    if trace and "profile" in ctx:
        dev["busy_s"] = ctx["profile"]["busy_s"]
        dev["window_s"] = ctx["profile"]["window_s"]
        out["breakdown"] = ctx["profile"]["breakdown"]
    # not read by the check: where set-up's seconds went
    out["setup_parts"] = dict(imports_s=t_import, **ctx["setup_parts"])
    out["checks"] = checks
    return out


def _plain(v):
    """A compared number as strict JSON holds it: a float, or the string
    "inf" or "nan"."""
    v = float(v)
    return v if math.isfinite(v) else ("nan" if v != v else "inf")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's."""
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs(ROOT)
    spec = load_spec(ROOT, args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {bad}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        c["value"] = _plain(c["value"])
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
