"""Posterior summary helpers (copy of ``spamtree_tpu/utils/summaries.py``,
which imports no jax either; held equal by tests/test_torch_predict.py).

Equivalents of the exported user-side utilities ``list_mean``,
``list_cubes_mean`` and ``list_qtile`` (reference: src/list_mean.cpp:10-137),
which average / quantile elementwise across a list (or stacked array) of MCMC
sample matrices.
"""

from __future__ import annotations

import numpy as np


def _stack(x):
    if isinstance(x, (list, tuple)):
        return np.stack([np.asarray(v) for v in x], axis=0)
    return np.asarray(x)


def list_mean(x):
    """Elementwise mean across samples (axis 0 of the stacked array)."""
    return _stack(x).mean(axis=0)


def list_qtile(x, q):
    """Elementwise quantile across samples (linear interpolation)."""
    return np.quantile(_stack(x), q, axis=0)


def list_cubes_mean(x, cslice):
    """Mean of slice ``cslice`` across a list of 3-d arrays."""
    arr = _stack(x)
    if cslice >= arr.shape[-1]:
        raise ValueError("Selected resolution does not exist.")
    return arr[..., cslice].mean(axis=0)


def rhat(x):
    """Split-R-hat (Gelman-Rubin potential scale reduction) per parameter.

    ``x`` has shape (draws, chains, ...) -- the layout multi-chain
    ``spamtree(..., n_chains=C)`` returns.  Chains are split in half so the
    diagnostic also detects within-chain drift.  The reference has no
    multi-chain machinery at all (single-chain sampler, spamtree_fit.cpp:
    167-391); this supports the chains x blocks mesh runs.
    """
    x = np.asarray(x, dtype=np.float64)
    if x.ndim < 2:
        raise ValueError("rhat needs (draws, chains, ...) samples")
    m = (x.shape[0] // 2) * 2
    # split each chain into halves -> 2C pseudo-chains of length m/2
    halves = np.concatenate([x[: m // 2], x[m // 2 : m]], axis=1)
    nn = halves.shape[0]
    cmean = halves.mean(axis=0)
    cvar = halves.var(axis=0, ddof=1)
    W = cvar.mean(axis=0)
    B = nn * cmean.var(axis=0, ddof=1)
    var_post = (nn - 1) / nn * W + B / nn
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_post / W)


def ess(x):
    """Bulk effective sample size via Geyer initial-positive-sequence
    autocorrelation truncation, summed over chains.  ``x``: (draws, chains, ...)."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 2:
        x = x[..., None]
        squeeze = True
    else:
        squeeze = False
    n, c = x.shape[0], x.shape[1]
    flat = x.reshape(n, c, -1)
    out = np.empty(flat.shape[2])
    for j in range(flat.shape[2]):
        rho_sum = 0.0
        for ch in range(c):
            v = flat[:, ch, j] - flat[:, ch, j].mean()
            if v.std() == 0:
                continue
            ac = np.correlate(v, v, mode="full")[n - 1 :] / (v @ v)
            # Geyer: sum consecutive lag pairs while positive
            s = 0.0
            for t in range(1, n - 2, 2):
                pair = ac[t] + ac[t + 1]
                if pair <= 0:
                    break
                s += pair
            rho_sum += s
        denom = 1.0 + 2.0 * rho_sum / c
        out[j] = n * c / max(denom, 1e-12)
    out = out.reshape(x.shape[2:])
    return float(out[0]) if squeeze else out


def _draws_first(fit, key, n_chains):
    """Normalize a fit's sample array to (draws[, chains], ...param dims)."""
    x = np.asarray(fit[key], dtype=np.float64)
    if n_chains > 1 or x.ndim == 0:
        return x  # multi-chain layouts are already (keep, C, ...)
    if key == "beta_mcmc":  # (p, keep, q) -> (keep, p, q)
        return np.moveaxis(x, 1, 0) if x.ndim == 3 else x
    if key in ("tausq_mcmc", "theta_mcmc"):  # (k, keep) -> (keep, k)
        return x.T if x.ndim == 2 else x
    return x  # w/yhat are (keep, n) already


def _moment_table(x, probs, n_chains):
    """mean/sd/quantiles over all draws; rhat/ess when chains allow."""
    flat = x.reshape(-1, *x.shape[2:]) if n_chains > 1 else x
    out = {
        "mean": flat.mean(axis=0),
        "sd": flat.std(axis=0, ddof=1) if flat.shape[0] > 1
        else np.zeros(flat.shape[1:]),
        "q": {float(p): np.quantile(flat, p, axis=0) for p in probs},
    }
    if n_chains > 1 and x.shape[0] >= 4:
        out["rhat"] = rhat(x)
        out["ess"] = ess(x)
    return out


def summarize_fit(fit, probs=(0.05, 0.5, 0.95)):
    """Posterior summary tables for a :func:`spamtree` fit.

    The reference leaves this to the user (its exported list_mean/list_qtile
    are the raw ingredients, src/list_mean.cpp); this assembles the standard
    report in one call, handling every fit layout: single-chain, multi-chain
    (folding chains into draws, plus split-Rhat/bulk-ESS per parameter when
    >= 2 chains), and ``collect="summary"`` runs (moment accumulators stand
    in for the absent w/yhat draws).

    Returns a dict with per-target tables ``beta`` (p, q), ``tausq`` (q,),
    ``theta`` (n_theta,), ``w``/``yhat`` (n,) -- each holding ``mean``,
    ``sd``, ``q`` {prob: array} (and ``rhat``/``ess`` for theta-like targets
    on multi-chain fits) -- plus ``n_draws``, ``n_chains``, ``accept_ratio``.
    Row order of w/yhat follows the fit's sorted coords; ``fit["order"]``
    maps back to input rows.
    """
    C = int(fit.get("n_chains", 1))
    out = {"n_chains": C, "accept_ratio": fit.get("accept_ratio")}
    for name, key in (("beta", "beta_mcmc"), ("tausq", "tausq_mcmc"),
                      ("theta", "theta_mcmc")):
        x = _draws_first(fit, key, C)
        if x.size:
            out[name] = _moment_table(x, probs, C)
    kept = 0
    for name, key in (("w", "w_mcmc"), ("yhat", "yhat_mcmc")):
        x = _draws_first(fit, key, C)
        if x.size:
            out[name] = _moment_table(x, probs, C)
            kept = max(kept, x.shape[0] * (C if C > 1 else 1))
        elif f"{name}_mean" in fit:
            # summary-collection run: device-accumulated moments (no draws,
            # hence no quantiles unless settings["summary_draws"] kept some)
            out[name] = {
                "mean": np.asarray(fit[f"{name}_mean"], dtype=np.float64),
                "sd": np.sqrt(np.maximum(
                    np.asarray(fit[f"{name}_var"], dtype=np.float64), 0.0)),
            }
            kept = max(kept, int(np.max(fit.get("summary_count", 0))))
    th = _draws_first(fit, "theta_mcmc", C)
    if th.size:
        kept = max(kept, th.shape[0] * (C if C > 1 else 1))
    out["n_draws"] = kept
    return out


def find_nan(x):
    """Row indices with any non-finite entry (reference: src/find_nan.cpp)."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    return np.flatnonzero(~np.isfinite(x).all(axis=1))


def find_not_nan(x):
    """Row indices with all entries finite (reference: src/find_nan.cpp)."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    return np.flatnonzero(np.isfinite(x).all(axis=1))
