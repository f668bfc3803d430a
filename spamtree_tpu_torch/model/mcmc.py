"""The SpamTree MCMC loop in PyTorch (main path).

Port of ``spamtree_tpu/model/mcmc.py`` (reference driver
``spamtree_mv_mcmc``, src/spamtree_fit.cpp:5-429).  One iteration, in the
reference order: w-Gibbs -> RAM-adaptive Metropolis on theta through the
likelihood sweep (with both quadratic forms fused into it; a failed
Cholesky rejects) -> on accept, the message Gram blocks and prediction
operators -> prediction on kept iterations -> tausq/beta Gibbs.

With ``MCMCConfig(accept_aware=True)`` the theta proposal runs the
decision-only sweep, and only an accepted proposal pays a second, factor-
emitting sweep that rebuilds the state it installs.

Randomness enters as an explicit ``StepDraws`` argument; ``draw_step``
makes one from a ``torch.Generator`` on the model's device.  The accept
decision is read on the host (one device sync per iteration; the
accept-aware step reads the rebuild's ok flag too, on accepted iterations
only).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from spamtree_tpu_torch.model.core import (
    ModelStatic,
    gibbs_beta_tausq,
    gibbs_w,
    gram_full,
    level_coords,
    pred_operators_from_joint,
    predict,
    sweep,
    tausq_shape,
)
from spamtree_tpu_torch.model.priors import make_theta_prior
from spamtree_tpu_torch.model.ram import RAMState, ram_adapt, ram_init
from spamtree_tpu_torch.model.transforms import (
    calc_jacobian,
    clamp_bounds,
    transf_back,
    transf_fwd,
)


class MCMCState(NamedTuple):
    w: torch.Tensor  # (n+1,)
    beta: torch.Tensor  # (p, q)
    tausq_inv: torch.Tensor  # (q,)
    XB: torch.Tensor  # (n+1,)
    theta: torch.Tensor
    leveldata: tuple
    pred_data: object  # tuple of LevelData prediction operators, or None
    logdetCi: torch.Tensor
    ram: RAMState
    it: int  # iterations done (RAM adaptation schedule)
    gram: tuple  # (core.msg_gram, core.route_gram), refreshed on accept


class MCMCConfig(NamedTuple):
    keep: int = 1000
    burn: int = 100
    thin: int = 1
    mcmcsd: object = 0.01  # initial proposal covariance: scalar s (s*I) or matrix
    tausq_ab: tuple = (2.01, 1.0)
    beta_Vi: object = 0.01  # prior precision for beta: scalar s (Vi = s*I) or (p,p)
    chunk: int = 50  # kept samples per device->host transfer
    theta_prior: object = None  # see model/priors.py; None = flat
    ram_reference_warmup: bool = False
    # accept-aware theta step: the proposal runs a decision-only sweep and
    # the factor-emitting rebuild runs on accept only; None resolves to
    # False, as in the JAX package
    accept_aware: object = None


class StepDraws(NamedTuple):
    """The random numbers of one iteration."""

    z_w: torch.Tensor  # (n+1,) normal: gibbs_w
    U: torch.Tensor  # (n_theta,) normal: theta proposal
    u: torch.Tensor  # () uniform: MH decision
    z_pred: torch.Tensor  # (n+1,) normal: predict
    g: torch.Tensor  # (q,) standard gamma with shape tausq_shape: tausq
    z_beta: torch.Tensor  # (p, q) normal: beta


def draw_step(ms: ModelStatic, gen: torch.Generator, n_theta: int,
              gamma_shape: torch.Tensor) -> StepDraws:
    """One iteration's draws from ``gen`` (a generator on ms.device)."""
    kw = dict(generator=gen, dtype=ms.dtype, device=ms.device)
    return StepDraws(
        z_w=torch.randn(ms.n + 1, **kw),
        U=torch.randn(n_theta, **kw),
        u=torch.rand((), **kw),
        z_pred=torch.randn(ms.n + 1, **kw),
        g=torch._standard_gamma(gamma_shape, generator=gen),
        z_beta=torch.randn(ms.p, ms.q, **kw),
    )


def _as_matrix(v, k: int) -> np.ndarray:
    """Scalar s -> s*I(k); a matrix passes through."""
    v = np.asarray(v, dtype=np.float64)
    return float(v) * np.eye(k) if v.ndim < 2 else v


def init_state(ms: ModelStatic, bounds: np.ndarray, start_theta: np.ndarray,
               start_tausq: float = 0.1, cfg: MCMCConfig = MCMCConfig(),
               precomputed: tuple | None = None) -> MCMCState:
    """The initial sampler state -- w = 0, beta = 0 -- with the initial
    likelihood sweep run eagerly (or taken from ``precomputed`` =
    tuning.prepare_chain's (leveldata, pred_data, logdet, ok, gram))."""
    n, p, q = ms.n, ms.p, ms.q
    b = np.asarray(bounds, dtype=np.float64)
    st = np.asarray(start_theta, dtype=np.float64)
    if np.any(st <= b[:, 0]) or np.any(st >= b[:, 1]):
        raise ValueError(
            f"starting theta outside its bounds: theta={st}, bounds={b.tolist()}")
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=ms.dtype,
                                  device=ms.device)
    beta = t(np.zeros((p, q)))
    w = t(np.zeros(n + 1))
    theta = t(st)
    XB = torch.cat([torch.sum((ms.X @ beta) * ms.mv_onehot, dim=1),
                    w.new_zeros(1)])
    if precomputed is None:
        ld, pd, logdet, ok = sweep(ms, theta, w)
        gram = gram_full(ms, ld)
    else:
        ld, pd, logdet, ok, gram = precomputed
    if not bool(ok):
        raise RuntimeError(
            "starting theta fails Cholesky in the initial likelihood sweep; "
            "choose a different starting value or widen the bounds")
    return MCMCState(
        w=w, beta=beta, tausq_inv=t(np.full(q, 1.0 / start_tausq)), XB=XB,
        theta=theta, leveldata=ld, pred_data=pd, logdetCi=logdet,
        ram=ram_init(t(_as_matrix(cfg.mcmcsd, len(st)))), it=0, gram=gram)


def make_step(ms: ModelStatic, bounds: np.ndarray, cfg: MCMCConfig,
              coords_cache=None):
    """The single-iteration transition ``step(state, draws, predicting)``:
    the JAX package's always-emit theta step, or its accept-aware step with
    ``cfg.accept_aware``.  ``coords_cache`` is core.level_coords(ms), built
    once per run."""
    bnds = torch.as_tensor(np.asarray(bounds), dtype=ms.dtype, device=ms.device)
    Vi = torch.as_tensor(_as_matrix(cfg.beta_Vi, ms.p), dtype=ms.dtype,
                         device=ms.device)
    Vim = torch.zeros(ms.p, dtype=ms.dtype, device=ms.device)
    prior_fn = make_theta_prior(cfg.theta_prior)
    accept_aware = bool(cfg.accept_aware)  # None -> False

    def step(state: MCMCState, draws: StepDraws, predicting: bool) -> MCMCState:
        theta, logdetCi, leveldata = state.theta, state.logdetCi, state.leveldata
        gram, pred_data, ram = state.gram, state.pred_data, state.ram
        w = gibbs_w(ms, leveldata, state.w, state.tausq_inv, state.XB,
                    draws.z_w, gram=gram[0], routed=gram[1])

        U = draws.U
        prop = transf_back(transf_fwd(theta, bnds) + ram.paramsd @ U, bnds)
        prop, _ = clamp_bounds(prop, bnds)
        # both quadratic forms (proposal and current factors) ride the
        # proposal sweep's level loop
        if accept_aware:
            new_logdet, ok, q_new, q_cur = sweep(
                ms, prop, w, quad_prev=leveldata, decision_only=True,
                coords_cache=coords_cache)
        else:
            new_ld, new_pj, new_logdet, ok, q_new, q_cur = sweep(
                ms, prop, w, quad_prev=leveldata, emit_pred_joint=True,
                coords_cache=coords_cache)
        logaccept = (new_logdet + q_new) - (logdetCi + q_cur) \
            + calc_jacobian(prop, theta, bnds)
        if prior_fn is not None:
            logaccept = logaccept + prior_fn(prop) - prior_fn(theta)
        finite = torch.isfinite(logaccept)
        acceptp = torch.where(finite, torch.exp(torch.clamp(logaccept, max=0.0)),
                              0.0)
        accepted = bool(((draws.u < acceptp) & ok).item())  # host sync
        install = accepted
        if accepted and accept_aware:
            # the factor-emitting rebuild; it installs only if its own
            # Cholesky flag holds (it can differ from the decision's only at
            # a borderline block), else the old state is kept
            new_ld, new_pj, new_logdet, ok2 = sweep(
                ms, prop, w, build_pred=pred_data is not None,
                emit_pred_joint=True, coords_cache=coords_cache)
            install = bool(ok2.item())
        if install:
            # the factor swap and the state derived from the factors
            theta, logdetCi, leveldata = prop, new_logdet, new_ld
            gram = gram_full(ms, new_ld)
            if pred_data is not None:
                pred_data = pred_operators_from_joint(ms, prop, new_pj,
                                                      coords_cache)
        alpha = torch.where(ok & finite,
                            torch.clamp(torch.exp(logaccept), max=1.0), 0.0)
        ram = ram_adapt(ram, U, alpha, state.it,
                        reference_warmup=cfg.ram_reference_warmup)
        ram = ram._replace(propos_count=ram.propos_count + 1.0,
                           accept_count=ram.accept_count + float(accepted))

        if predicting:
            w = predict(ms, pred_data, w, draws.z_pred)
        tausq_inv, beta, XB = gibbs_beta_tausq(
            ms, w, state.XB, draws.g, draws.z_beta, cfg.tausq_ab, Vi, Vim)
        return MCMCState(w=w, beta=beta, tausq_inv=tausq_inv, XB=XB,
                         theta=theta, leveldata=leveldata, pred_data=pred_data,
                         logdetCi=logdetCi, ram=ram, it=state.it + 1, gram=gram)

    return step


def chunk_sizes(cfg: MCMCConfig):
    """The balanced chunk geometry (mc, ipc, n_keep_chunks, n_burn_chunks):
    mc kept samples (mc * thin iterations) per chunk, burn rounded up to
    whole chunks, as in the JAX package."""
    if cfg.keep > 0:
        n_keep_chunks = -(-cfg.keep // min(cfg.chunk, cfg.keep))
        mc = -(-cfg.keep // n_keep_chunks)
    else:
        n_keep_chunks = 0
        mc = cfg.chunk
    ipc = mc * cfg.thin
    n_burn_chunks = int(np.ceil(cfg.burn / ipc)) if cfg.burn > 0 else 0
    return mc, ipc, n_keep_chunks, n_burn_chunks


def _make_yhat_host(ms: ModelStatic, rng: np.random.Generator):
    """Host posterior-predictive reconstruction yhat = X beta + w + tau z
    (reference: spamtree_fit.cpp:384) from the (m, n) w draws, (m, p, q)
    beta and (m, q) tausq draws, with host RNG for z."""
    X_h = ms.X.cpu().numpy()
    mv_h = ms.mv[: ms.n].cpu().numpy()

    def _yhat_host(w_s, beta_s, tausq_s):
        XB = np.zeros(w_s.shape, dtype=w_s.dtype)
        for j in range(X_h.shape[1]):
            XB += beta_s[..., j, :][..., mv_h] * X_h[:, j]
        sd = np.sqrt(tausq_s[..., mv_h])  # per-row margin noise sd
        zdt = np.float64 if w_s.dtype == np.float64 else np.float32
        return XB + w_s + sd * rng.standard_normal(w_s.shape, dtype=zdt)

    return _yhat_host


def run_mcmc(ms: ModelStatic, bounds: np.ndarray, cfg: MCMCConfig,
             state: MCMCState, gen: torch.Generator, verbose: bool = False,
             yhat_seed: int = 0) -> dict:
    """Burn, then keep in chunks; returns host-side sample arrays.

    Burn runs ``n_burn_chunks * mc * thin`` iterations (``burn_actual``)
    without prediction.  Each kept sample is the last of ``thin`` iterations
    and the only one that predicts.  A chunk's draws cross to the host in
    one transfer, where yhat is rebuilt."""
    n = ms.n
    mc, ipc, n_keep_chunks, n_burn_chunks = chunk_sizes(cfg)
    burn_actual = n_burn_chunks * ipc
    step = make_step(ms, bounds, cfg, coords_cache=level_coords(ms))
    nt = state.theta.shape[0]
    shape = tausq_shape(ms, cfg.tausq_ab)
    yhat_host = _make_yhat_host(ms, np.random.default_rng(yhat_seed))

    def one(s, predicting):
        return step(s, draw_step(ms, gen, nt, shape), predicting)

    def report(phase, done, total, s):
        if verbose:
            print(f"[{phase}] {done}/{total}, {time.time() - t0:.2f}s, "
                  f"accept {s.ram.accept_count / max(s.ram.propos_count, 1):.2%}")

    if ms.device.type == "cuda":
        torch.cuda.synchronize(ms.device)
    t0 = time.time()
    for bi in range(n_burn_chunks):
        for _ in range(ipc):
            state = one(state, False)
        report("burn", (bi + 1) * ipc, burn_actual, state)

    outs = {k: [] for k in ("w", "yhat", "beta", "tausq", "theta")}
    kept = 0
    for ki in range(n_keep_chunks):
        draws = []
        for _ in range(min(mc, cfg.keep - ki * mc)):
            for i in range(cfg.thin):
                state = one(state, i == cfg.thin - 1)
            draws.append((state.w[:n], state.beta, 1.0 / state.tausq_inv,
                          state.theta))
        w_s, beta_s, tausq_s, theta_s = (
            torch.stack(d).cpu().numpy() for d in zip(*draws))
        if not np.isfinite(theta_s).all():
            raise FloatingPointError(
                "non-finite theta in chain; aborting (NaN loglik guard)")
        outs["w"].append(w_s)
        outs["yhat"].append(yhat_host(w_s, beta_s, tausq_s))
        outs["beta"].append(beta_s)
        outs["tausq"].append(tausq_s)
        outs["theta"].append(theta_s)
        kept += len(draws)
        report("keep", kept, cfg.keep, state)
    if ms.device.type == "cuda":
        torch.cuda.synchronize(ms.device)
    res = {k: (np.concatenate(v) if v else np.zeros((0,)))
           for k, v in outs.items()}
    res["burn_actual"] = burn_actual
    res["mcmc_time"] = time.time() - t0
    res["paramsd"] = state.ram.paramsd.cpu().numpy()
    res["accept_ratio"] = state.ram.accept_count / max(state.ram.propos_count, 1)
    res["state"] = state
    return res
