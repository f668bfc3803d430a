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

``run_mcmc`` keeps draws in chunks.  Each kept draw's yhat is built on the
device, its noise from a second device generator, so every collection mode
follows the same chain.  ``collect="all"`` streams each kept draw's w (f16
on the wire for f32 models) and yhat into a pinned host buffer as it is
drawn, and drains the chunk -- f16 decode, sinks -- on a worker thread up
to two chunks behind the sampling loop; ``collect="summary"`` accumulates
posterior moments on the device instead.  With ``checkpoint_path``
the drain is sequential and the sampler state, every generator and the
moments are saved after each chunk (``utils.checkpoint``).

``run_mcmc_chains`` runs C chains as one batched step (the JAX package
vmaps its step), always-emit or accept-aware: every state leaf has a
leading chain axis (``stack_chain_states``), each chain draws from its own
generator, and each chain's accept decision is resolved on the device --
the step installs proposals with ``torch.where`` on a per-chain mask and
reads nothing back.  Chain c is the single-chain run whose generator is
seeded like chain c's.  Outputs carry the chain axis after the sample
axis.

On a CUDA device both run each iteration as CUDA graphs captured once per
run and replayed (``StepRunner``, the counterpart of the JAX package's
jitted ``lax.scan`` chunk), alone or on an NCCL mesh, whose collectives
the graphs hold: the carried state lives in static buffers, draws are
filled outside the graphs, and the chain is the eager step's
(``make_step``) bit for bit, under deterministic algorithms too.
``graphs=False`` runs the eager step; the CPU and a gloo mesh run it by
default.  ``donate=True`` lets the run take the caller's state tensors as
its buffers instead of copies (the JAX package donates its carry).

On a mesh (a model from ``parallel.sharding.shard_model``) every rank runs
this loop: a blocks group's ranks hold the same state and draw the same
numbers, the step's sweeps shard the levels; a chains rank runs its own
chains, and each chunk's draws, the summary moments, a checkpoint's state
and generators and the final counters are gathered over the chains ranks
into the unsharded layouts, so every rank returns the same result.  Rank 0
alone writes the sinks and checkpoints.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from spamtree_tpu_torch.model import graph
from spamtree_tpu_torch.model.core import (
    ModelStatic,
    _tree_map,
    gibbs_beta,
    gibbs_beta_tausq,
    gibbs_tausq,
    gibbs_w,
    gram_full,
    level_coords,
    pred_operators_from_joint,
    predict,
    predict_recompute,
    sweep,
    tausq_shape,
)
from spamtree_tpu_torch.model.priors import make_theta_prior
from spamtree_tpu_torch.model.ram import (
    G0,
    RAMState,
    ram_adapt,
    ram_eta_table,
    ram_init,
)
from spamtree_tpu_torch.model.transforms import (
    calc_jacobian,
    clamp_bounds,
    transf_back,
    transf_fwd,
)
from spamtree_tpu_torch.ops import kernel_counts
from spamtree_tpu_torch.utils import cost, trace


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
    adapting: bool = True  # RAM adapts the theta proposal
    mcmcsd: object = 0.01  # initial proposal covariance: scalar s (s*I) or matrix
    tausq_ab: tuple = (2.01, 1.0)
    beta_Vi: object = 0.01  # prior precision for beta: scalar s (Vi = s*I) or (p,p)
    # per-sampler switches (api's debug=); a sampler switched off leaves its
    # field as it is.  Prediction needs sample_w too.
    sample_beta: bool = True
    sample_tausq: bool = True
    sample_theta: bool = True
    sample_w: bool = True
    sample_predicts: bool = True
    chunk: int = 50  # kept samples per device->host transfer
    theta_prior: object = None  # see model/priors.py; None = flat
    ram_reference_warmup: bool = False
    # accept-aware theta step: the proposal runs a decision-only sweep and
    # the factor-emitting rebuild runs on accept only; None resolves to
    # False, as in the JAX package
    accept_aware: object = None
    # "all" keeps every kept draw of w/yhat; "summary" accumulates running
    # mean/variance sums on the device and ships only O(n) totals at the
    # end (beta/tausq/theta draws are always kept)
    collect: str = "all"
    # summary mode only: also keep ~this many strided w/yhat draws, for
    # quantiles (see _subsample_plan); 0 = moments only
    summary_draws: int = 0
    # device->host type of the w draws: None = float16 for float32 models,
    # no cast otherwise; "none" disables the cast; or a dtype (name)
    wire_dtype: object = None
    # resume only: pin the chunk size to the writing run's mc, so burn
    # rounding and the summary subsample land where the uninterrupted run
    # puts them; 0 = balanced from keep and chunk
    mc_fixed: int = 0


class StepDraws(NamedTuple):
    """The random numbers of one iteration (every field, whichever samplers
    are switched on, so one seed gives one stream of draws)."""

    z_w: torch.Tensor  # (n+1,) normal: gibbs_w
    U: torch.Tensor  # (n_theta,) normal: theta proposal
    u: torch.Tensor  # () uniform: MH decision
    z_pred: torch.Tensor  # (n+1,) normal: predict
    g: torch.Tensor  # (q,) standard gamma with shape tausq_shape: tausq
    z_beta: torch.Tensor  # (p, q) normal: beta


def draw_step(ms: ModelStatic, gen: torch.Generator, n_theta: int,
              gamma_shape: torch.Tensor, out: StepDraws | None = None
              ) -> StepDraws:
    """One iteration's draws from ``gen`` (a generator on ms.device);
    ``out``: fill these tensors in place instead (the same numbers)."""
    kw = dict(generator=gen, dtype=ms.dtype, device=ms.device)
    if out is None:
        return StepDraws(
            z_w=torch.randn(ms.n + 1, **kw),
            U=torch.randn(n_theta, **kw),
            u=torch.rand((), **kw),
            z_pred=torch.randn(ms.n + 1, **kw),
            g=torch._standard_gamma(gamma_shape, generator=gen),
            z_beta=torch.randn(ms.p, ms.q, **kw),
        )
    torch.randn(ms.n + 1, generator=gen, out=out.z_w)
    torch.randn(n_theta, generator=gen, out=out.U)
    torch.rand((), generator=gen, out=out.u)
    torch.randn(ms.n + 1, generator=gen, out=out.z_pred)
    out.g.copy_(torch._standard_gamma(gamma_shape, generator=gen))
    torch.randn(ms.p, ms.q, generator=gen, out=out.z_beta)
    return out


def draw_chains(ms: ModelStatic, gens, n_theta: int,
                gamma_shape: torch.Tensor, out: StepDraws | None = None
                ) -> StepDraws:
    """One iteration's draws for C chains, (C, ...) each: chain c's from
    ``gens[c]`` in ``draw_step``'s order, so chain c draws what a single
    chain with that generator would; ``out``: fill these in place."""
    if out is None:
        ds = [draw_step(ms, g, n_theta, gamma_shape) for g in gens]
        return StepDraws(*(torch.stack(f) for f in zip(*ds)))
    for c, g in enumerate(gens):
        draw_step(ms, g, n_theta, gamma_shape,
                  out=StepDraws(*(f[c] for f in out)))
    return out


def _draws_like(ms: ModelStatic, n_theta: int, chains: int) -> StepDraws:
    """Empty draw buffers of one iteration (``chains`` > 0: (C, ...))."""
    lead = (chains,) if chains else ()
    e = lambda *shape: torch.empty(lead + shape, dtype=ms.dtype,
                                   device=ms.device)
    return StepDraws(z_w=e(ms.n + 1), U=e(n_theta), u=e(), z_pred=e(ms.n + 1),
                     g=e(ms.q), z_beta=e(ms.p, ms.q))


def stack_chain_states(state: MCMCState, seeds):
    """Broadcast one chain's state to C = len(seeds) chains, each leaf
    copied to a contiguous (C, ...) tensor, with the RAM counters as (C,)
    device tensors and no carried gram (the batched step forms the Gram
    blocks in place, as the JAX package's vmapped chains do).  Returns
    (states, generators): one ``torch.Generator`` per chain on the state's
    device, seeded ``seeds[c]`` (the JAX package seeds chain keys with
    ``seed + arange(C)``)."""
    C = len(seeds)
    rep = lambda a: a.unsqueeze(0).repeat((C,) + (1,) * a.dim())
    ram = state.ram
    cnt = lambda v: torch.full((C,), float(v), dtype=state.w.dtype,
                               device=state.w.device)
    states = state._replace(
        w=rep(state.w), beta=rep(state.beta), tausq_inv=rep(state.tausq_inv),
        XB=rep(state.XB), theta=rep(state.theta),
        leveldata=_tree_map(rep, state.leveldata),
        pred_data=_tree_map(rep, state.pred_data),
        logdetCi=rep(state.logdetCi),
        ram=RAMState(paramsd=rep(ram.paramsd), prodparam=rep(ram.prodparam),
                     started=ram.started, propos_count=cnt(ram.propos_count),
                     accept_count=cnt(ram.accept_count)),
        gram=())
    gens = [torch.Generator(device=state.w.device).manual_seed(int(s))
            for s in seeds]
    return states, gens


def _as_matrix(v, k: int) -> np.ndarray:
    """Scalar s -> s*I(k); a matrix passes through."""
    v = np.asarray(v, dtype=np.float64)
    return float(v) * np.eye(k) if v.ndim < 2 else v


def init_state(ms: ModelStatic, bounds: np.ndarray, start_theta: np.ndarray,
               start_beta: np.ndarray | None = None, start_tausq: float = 0.1,
               start_w: np.ndarray | None = None,
               cfg: MCMCConfig = MCMCConfig(),
               precomputed: tuple | None = None) -> MCMCState:
    """The initial sampler state -- ``start_beta`` (p,) for every margin
    (default 0), ``start_w`` (n,) in sorted-row order (default 0) -- with
    the initial likelihood sweep run eagerly (or taken from ``precomputed``
    = tuning.prepare_chain's (leveldata, pred_data, logdet, ok, gram))."""
    n, p, q = ms.n, ms.p, ms.q
    b = np.asarray(bounds, dtype=np.float64)
    st = np.asarray(start_theta, dtype=np.float64)
    if np.any(st <= b[:, 0]) or np.any(st >= b[:, 1]):
        raise ValueError(
            f"starting theta outside its bounds: theta={st}, bounds={b.tolist()}")
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=ms.dtype,
                                  device=ms.device)
    beta0 = np.zeros(p) if start_beta is None else np.asarray(start_beta)
    beta = t(np.repeat(beta0.reshape(p, 1), q, axis=1))
    w = t(np.zeros(n + 1) if start_w is None
          else np.append(np.asarray(start_w, dtype=np.float64), 0.0))
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


class _Parts:
    """The pieces of one iteration, shared by the eager step
    (``make_step``) and the capture-ready one (``StepRunner``), so that
    both compute the same operations on the same values."""

    def __init__(self, ms: ModelStatic, bounds: np.ndarray, cfg: MCMCConfig,
                 coords_cache=None, chains: bool = False):
        self.ms, self.cfg, self.cc, self.chains = ms, cfg, coords_cache, chains
        self.bnds = torch.as_tensor(np.asarray(bounds), dtype=ms.dtype,
                                    device=ms.device)
        self.Vi = torch.as_tensor(_as_matrix(cfg.beta_Vi, ms.p),
                                  dtype=ms.dtype, device=ms.device)
        self.Vim = torch.zeros(ms.p, dtype=ms.dtype, device=ms.device)
        self.prior_fn = make_theta_prior(cfg.theta_prior)
        self.accept_aware = bool(cfg.accept_aware)  # None -> False

    def gibbs(self, state: MCMCState, draws: StepDraws):
        """w after its Gibbs update (``state.w`` itself with sample_w off)."""
        if not self.cfg.sample_w:
            return state.w
        # chains carry no gram: gibbs_w forms the Gram blocks in place
        gram, routed = state.gram if state.gram else (None, None)
        return gibbs_w(self.ms, state.leveldata, state.w, state.tausq_inv,
                       state.XB, draws.z_w, gram=gram, routed=routed)

    def propose(self, state: MCMCState, U):
        """The RAM proposal in the box (one per chain for (C, nt) U)."""
        paramsd, bnds = state.ram.paramsd, self.bnds
        step = (paramsd @ U if U.dim() == 1
                else (paramsd @ U[..., None])[..., 0])
        return clamp_bounds(
            transf_back(transf_fwd(state.theta, bnds) + step, bnds), bnds)[0]

    def log_accept(self, state: MCMCState, prop, new_logdet, q_new, q_cur):
        """(log MH ratio, its finiteness, the accept probability)."""
        logaccept = (new_logdet + q_new) - (state.logdetCi + q_cur) \
            + calc_jacobian(prop, state.theta, self.bnds)
        if self.prior_fn is not None:
            logaccept = logaccept + self.prior_fn(prop) \
                - self.prior_fn(state.theta)
        finite = torch.isfinite(logaccept)
        acceptp = torch.where(finite, torch.exp(torch.clamp(logaccept, max=0.0)),
                              0.0)
        return logaccept, finite, acceptp

    def adapt(self, state: MCMCState, U, logaccept, ok, finite,
              eta=None) -> RAMState:
        ram = state.ram
        if self.cfg.adapting:
            alpha = torch.where(ok & finite,
                                torch.clamp(torch.exp(logaccept), max=1.0), 0.0)
            ram = ram_adapt(ram, U, alpha, state.it,
                            reference_warmup=self.cfg.ram_reference_warmup,
                            eta=eta)
        return ram

    def decide(self, state: MCMCState, w, draws: StepDraws, eta=None):
        """The proposal, its sweep (both quadratic forms, for the proposal
        and the current factors, ride its level loop; decision-only on the
        accept-aware step), the MH decision on the device and the RAM
        adaptation: (prop, (new_ld, new_pj, new_logdet) or None on the
        accept-aware step, accepted (device bool), ram)."""
        ms, cc = self.ms, self.cc
        prop = self.propose(state, draws.U)
        if self.accept_aware:
            new_logdet, ok, q_new, q_cur = sweep(
                ms, prop, w, quad_prev=state.leveldata, decision_only=True,
                coords_cache=cc)
            emitted = None
        else:
            new_ld, new_pj, new_logdet, ok, q_new, q_cur = sweep(
                ms, prop, w, quad_prev=state.leveldata, emit_pred_joint=True,
                coords_cache=cc)
            emitted = (new_ld, new_pj, new_logdet)
        logaccept, finite, acceptp = self.log_accept(state, prop, new_logdet,
                                                     q_new, q_cur)
        accepted = (draws.u < acceptp) & ok
        ram = self.adapt(state, draws.U, logaccept, ok, finite, eta)
        return prop, emitted, accepted, ram

    def rebuild(self, state: MCMCState, prop, w):
        """The accept-aware step's factor-emitting sweep: ((new_ld, new_pj,
        new_logdet), its own Cholesky flag ok2)."""
        new_ld, new_pj, new_logdet, ok2 = sweep(
            self.ms, prop, w, build_pred=state.pred_data is not None,
            emit_pred_joint=True, coords_cache=self.cc)
        return (new_ld, new_pj, new_logdet), ok2

    def derived(self, prop, new_ld, new_pj, pred_data):
        """The state derived from installed factors: (gram, pred_data) --
        one chain's Gram blocks (chains carry none), and the prediction
        operators where the state carries them."""
        gram = () if self.chains else gram_full(self.ms, new_ld)
        if pred_data is not None:
            pred_data = pred_operators_from_joint(self.ms, prop, new_pj,
                                                  self.cc)
        return gram, pred_data

    def theta_chains(self, state: MCMCState, w, draws: StepDraws, eta=None,
                     inplace: bool = False):
        """The batched theta step: every chain's proposal sweep in one, and
        each chain's accept resolved on the device and installed leaf by
        leaf with ``torch.where`` -- no host read.  Accept-aware, it runs
        both branches of the JAX package's vmapped accept-cond: the
        decision-only sweep, then the factor-emitting rebuild for every
        chain, installed where the chain accepted and the rebuild's own
        Cholesky flag holds.  ``inplace``: the selections write into the
        state's own theta, logdetCi, leveldata and pred_data.  Returns
        (theta, logdetCi, leveldata, pred_data, ram)."""
        prop, emitted, accepted, ram = self.decide(state, w, draws, eta)
        install = accepted
        if self.accept_aware:
            emitted, ok2 = self.rebuild(state, prop, w)
            install = accepted & ok2
        new_ld, new_pj, new_logdet = emitted

        def sel(new, old):
            m = install.reshape((-1,) + (1,) * (old.dim() - 1))
            return (torch.where(m, new, old, out=old) if inplace
                    else torch.where(m, new, old))

        theta, logdetCi = sel(prop, state.theta), sel(new_logdet,
                                                      state.logdetCi)
        leveldata = _tree_map(sel, new_ld, state.leveldata)
        pred_data = state.pred_data
        if pred_data is not None:
            # built every iteration and selected per chain, as the JAX
            # package's vmapped accept-cond runs both branches
            pred_data = _tree_map(sel, self.derived(
                prop, new_ld, new_pj, pred_data)[1], pred_data)
        ram = ram._replace(propos_count=ram.propos_count + 1.0,
                           accept_count=ram.accept_count
                           + accepted.to(ram.accept_count.dtype))
        return theta, logdetCi, leveldata, pred_data, ram

    def tail(self, state: MCMCState, w, theta, pred_data, draws: StepDraws,
             predicting: bool):
        """Prediction on a kept iteration, then the conjugate tail:
        (w, tausq_inv, beta, XB)."""
        ms, cfg = self.ms, self.cfg
        if predicting and cfg.sample_predicts and cfg.sample_w:
            # above 256 MB of prediction operators (pred_in_carry False)
            # they are rebuilt for the current theta at each kept iteration
            w = (predict(ms, pred_data, w, draws.z_pred) if ms.pred_in_carry
                 else predict_recompute(ms, theta, w, draws.z_pred, self.cc))
        tausq_inv, beta, XB = state.tausq_inv, state.beta, state.XB
        if cfg.sample_tausq and cfg.sample_beta:
            tausq_inv, beta, XB = gibbs_beta_tausq(
                ms, w, state.XB, draws.g, draws.z_beta, cfg.tausq_ab, self.Vi,
                self.Vim)
        else:
            if cfg.sample_tausq:
                tausq_inv = gibbs_tausq(ms, w, state.XB, draws.g,
                                        cfg.tausq_ab)
            if cfg.sample_beta:
                beta, XB = gibbs_beta(ms, w, tausq_inv, draws.z_beta, self.Vi,
                                      self.Vim)
        return w, tausq_inv, beta, XB


def make_step(ms: ModelStatic, bounds: np.ndarray, cfg: MCMCConfig,
              coords_cache=None, chains: bool = False):
    """The single-iteration transition ``step(state, draws, predicting)``:
    the JAX package's always-emit theta step, or its accept-aware step with
    ``cfg.accept_aware``.  ``coords_cache`` is core.level_coords(ms), built
    once per run.  Eager and functional: a new state, the input untouched.

    ``chains=True``: the batched step of ``run_mcmc_chains`` over states
    with a leading chain axis (``stack_chain_states``) and draws from
    ``draw_chains``; always-emit unless ``cfg.accept_aware`` is True (None
    resolves to off, as in the JAX package's vmapped chains).

    ``step(..., ran=)``: the names of the ``StepRunner`` parts the
    iteration ran go into the set ``ran``, as the runner names them."""
    parts = _Parts(ms, bounds, cfg, coords_cache, chains)

    def theta_step(state: MCMCState, w, draws: StepDraws, ran: set):
        """The theta Metropolis step: (theta, logdetCi, leveldata, gram,
        pred_data, ram)."""
        theta, logdetCi, leveldata = state.theta, state.logdetCi, state.leveldata
        gram, pred_data = state.gram, state.pred_data
        prop, emitted, accepted, ram = parts.decide(state, w, draws)
        accepted = bool(accepted.item())  # host sync
        install = accepted
        if accepted and parts.accept_aware:
            # the factor-emitting rebuild; it installs only if its own
            # Cholesky flag holds (it can differ from the decision's only at
            # a borderline block), else the old state is kept
            emitted, ok2 = parts.rebuild(state, prop, w)
            install = bool(ok2.item())
            ran.add("R")
        if install:
            # the factor swap and the state derived from the factors
            new_ld, new_pj, new_logdet = emitted
            theta, logdetCi, leveldata = prop, new_logdet, new_ld
            gram, pred_data = parts.derived(prop, new_ld, new_pj, pred_data)
            ran.add("I")
        ram = ram._replace(propos_count=ram.propos_count + 1.0,
                           accept_count=ram.accept_count + float(accepted))
        return theta, logdetCi, leveldata, gram, pred_data, ram

    def step(state: MCMCState, draws: StepDraws, predicting: bool,
             ran: set | None = None) -> MCMCState:
        ran = set() if ran is None else ran
        ran.add(f"C{int(predicting)}" if chains else "A")
        w = parts.gibbs(state, draws)
        theta, logdetCi, leveldata = (state.theta, state.logdetCi,
                                      state.leveldata)
        gram, pred_data, ram = state.gram, state.pred_data, state.ram
        if cfg.sample_theta:
            if chains:
                theta, logdetCi, leveldata, pred_data, ram = \
                    parts.theta_chains(state, w, draws)
            else:
                theta, logdetCi, leveldata, gram, pred_data, ram = \
                    theta_step(state, w, draws, ran)
        w, tausq_inv, beta, XB = parts.tail(state, w, theta, pred_data, draws,
                                            predicting)
        if not chains:
            ran.add(f"T{int(predicting)}")
        return MCMCState(w=w, beta=beta, tausq_inv=tausq_inv, XB=XB,
                         theta=theta, leveldata=leveldata, pred_data=pred_data,
                         logdetCi=logdetCi, ram=ram, it=state.it + 1, gram=gram)

    return step


def _copy_tree(dst, src):
    """Copy every tensor leaf of ``src`` into the matching leaf of ``dst``
    (nested tuples, None leaves skipped)."""
    _tree_map(lambda d, s_: d.copy_(s_), dst, src)


class StepRunner:
    """The iteration of ``run_mcmc`` (``chains=0``) or ``run_mcmc_chains``
    (``chains=C``) as the JAX package compiles it -- its carry donated,
    its accept install and prediction behind ``lax.cond`` -- here as CUDA
    graphs captured once and replayed, with no per-op host dispatch.

    The carried state lives in static buffers (``state``: a copy of the
    given one, or with ``donate`` the given tensors themselves, which the
    run then overwrites) that the graphs read and write in place; ``it``,
    the single chain's accept counters and the warmup flag stay host
    values.
    ``draw(out)`` fills the static draw buffers (``draw_step``/
    ``draw_chains`` with ``out=``) before each iteration, outside the
    graphs, so the graphed chain draws what the eager one draws.  The RAM
    step size comes from a table indexed by a device iteration counter
    (``ram_eta_table``, ``n_iters`` iterations from the state's).

    One chain: the parts mirror the JAX package's ``lax.cond`` -- only the
    branch taken runs.  A: gibbs_w, the proposal, its sweep (decision-only
    on the accept-aware step), the MH decision on the device and the RAM
    adaptation; the host reads the decision; R (accept-aware, on accept):
    the factor-emitting rebuild, its ok flag read; I (on install): the
    factor swap, the Gram blocks and the prediction operators; T: the
    prediction (two variants: predicting or not) and the conjugate tail.
    The install copies the proposal's factors (graph A's or R's output)
    into the carried ones.  Chains: one graph per predicting variant for
    the whole step, which reads nothing back; their selections write in
    place into the carried buffers.

    On a CUDA device the first graph-eligible iteration runs eagerly on a
    side stream (the chain's own first iteration, with its own draws),
    every other part is run once more there without writing the state,
    and then every part is captured (``capture_s`` seconds, the span
    ``mcmc.capture``; one shared memory pool); later iterations replay
    (``part_replays`` counts them per part, ``replays`` in all).  While
    the call's trace record is active, each replay runs inside the device
    span ``mcmc.part.<part>`` and each host read of a decision inside the
    span ``mcmc.accept_read``.  With ``ram_reference_warmup``
    the iterations up to the warmup's switch-on (``it`` <= G0) run eagerly,
    as its branches follow the host's iteration count, and the capture
    comes after them.  On the CPU, where there are no graphs, every part
    runs as a plain call on the same buffers -- the capture-ready step,
    run eagerly.

    On an NCCL mesh every rank captures its parts, collectives included,
    in the same order and replays them in the same order: which parts run
    follows the accept read, which every rank reads as the same bits (the
    decision reads replicated state and rank-ordered sums).  The eager
    first iteration brings up each group's communicator before any
    capture.  A gloo mesh on CUDA tensors is refused: gloo stages them
    through host memory, which a capture cannot hold."""

    def __init__(self, ms: ModelStatic, bounds: np.ndarray, cfg: MCMCConfig,
                 state: MCMCState, draw, chains: int = 0, n_iters: int = 0,
                 donate: bool = False, capture: bool = True):
        if capture:
            graph.check_capturable(ms.device.type, None if ms.mesh is None
                                   else ms.mesh.backend)
        self.ms, self.cfg, self.C, self.draw = ms, cfg, chains, draw
        self.P = _Parts(ms, bounds, cfg, level_coords(ms), bool(chains))
        self.capture = capture and ms.device.type == "cuda"
        c = (lambda x: x) if donate else (lambda x: _tree_map(torch.clone, x))
        ram = state.ram
        counts = ({} if not chains else dict(
            propos_count=c(ram.propos_count), accept_count=c(ram.accept_count)))
        self.state = state._replace(
            w=c(state.w), beta=c(state.beta), tausq_inv=c(state.tausq_inv),
            XB=c(state.XB), theta=c(state.theta), leveldata=c(state.leveldata),
            pred_data=c(state.pred_data), logdetCi=c(state.logdetCi),
            gram=c(state.gram), ram=ram._replace(
                paramsd=c(ram.paramsd), prodparam=c(ram.prodparam), **counts))
        nt = state.theta.shape[-1]
        self.d = _draws_like(ms, nt, chains)
        n_tab = state.it + n_iters
        self.eta = torch.as_tensor(
            ram_eta_table(nt, n_tab, cfg.ram_reference_warmup),
            device=ms.device).to(ms.dtype)
        self.it_dev = torch.full((1,), state.it, dtype=torch.long,
                                 device=ms.device)
        self.out = {}  # each part's outputs (graph memory once captured)
        self.graphs = None
        self.capture_s = 0.0
        self.part_replays = Counter()
        # the call's trace record where it is active (None: the active-only
        # spans are off), and where replays run on the card
        rec = trace.current()
        self.rec = rec if rec is not None and rec.active else None
        self.timed = self.rec if ms.device.type == "cuda" else None

    @property
    def replays(self) -> int:
        return sum(self.part_replays.values())

    # -- the parts: each reads the static buffers, and with ``commit``
    # writes its results into them --------------------------------------

    def _eta(self, warm: bool):
        # the step size at the device counter; None where the reference
        # warmup's host branches still run (eager iterations only)
        return None if warm else self.eta.index_select(
            0, self.it_dev).reshape(())

    def _commit_ram(self, ram):
        s = self.state.ram
        s.paramsd.copy_(ram.paramsd)
        s.prodparam.copy_(ram.prodparam)
        self.it_dev.add_(1)
        return ram.started

    def _part_A(self, commit=True, warm=False):
        s, P = self.state, self.P
        w = P.gibbs(s, self.d)
        out = {}
        if self.cfg.sample_theta:
            prop, emitted, accepted, ram = P.decide(s, w, self.d,
                                                    self._eta(warm))
            out = dict(prop=prop, emitted=emitted, accepted=accepted)
        if commit:
            s.w.copy_(w)
            if self.cfg.sample_theta:
                out["started"] = self._commit_ram(ram)
        return out

    def _part_R(self, commit=True):
        emitted, ok2 = self.P.rebuild(self.state, self.out["A"]["prop"],
                                      self.state.w)
        return dict(emitted=emitted, ok2=ok2)

    def _part_I(self, commit=True):
        s = self.state
        src = self.out["R" if self.P.accept_aware else "A"]["emitted"]
        prop = self.out["A"]["prop"]
        new_ld, new_pj, new_logdet = src
        gram, pred_data = self.P.derived(prop, new_ld, new_pj, s.pred_data)
        if commit:
            s.theta.copy_(prop)
            s.logdetCi.copy_(new_logdet)
            _copy_tree(s.leveldata, new_ld)
            _copy_tree(s.gram, gram)
            _copy_tree(s.pred_data, pred_data)
        return {}

    def _part_T(self, predicting, commit=True):
        s = self.state
        w, tausq_inv, beta, XB = self.P.tail(s, s.w, s.theta, s.pred_data,
                                             self.d, predicting)
        if commit:
            s.w.copy_(w)
            s.tausq_inv.copy_(tausq_inv)
            s.beta.copy_(beta)
            s.XB.copy_(XB)
        return {}

    def _part_C(self, predicting, commit=True, warm=False):
        """The batched chains' whole step."""
        s, P = self.state, self.P
        w = P.gibbs(s, self.d)
        theta, pred_data = s.theta, s.pred_data
        out = {}
        if self.cfg.sample_theta:
            theta, _, _, pred_data, ram = P.theta_chains(
                s, w, self.d, self._eta(warm), inplace=commit)
        w, tausq_inv, beta, XB = P.tail(s, w, theta, pred_data, self.d,
                                        predicting)
        if commit:
            if self.cfg.sample_theta:
                out["started"] = self._commit_ram(ram)
                s.ram.propos_count.copy_(ram.propos_count)
                s.ram.accept_count.copy_(ram.accept_count)
            s.w.copy_(w)
            s.tausq_inv.copy_(tausq_inv)
            s.beta.copy_(beta)
            s.XB.copy_(XB)
        return out

    def _parts(self):
        """{name: part function} of every part a graph is captured for."""
        if self.C:
            return {f"C{int(p)}": (lambda p=p, **k: self._part_C(p, **k))
                    for p in (False, True)}
        parts = {"A": self._part_A}
        if self.cfg.sample_theta:
            if self.P.accept_aware:
                parts["R"] = self._part_R
            parts["I"] = self._part_I
        parts.update({f"T{int(p)}": (lambda p=p, **k: self._part_T(p, **k))
                      for p in (False, True)})
        return parts

    def _run(self, name: str, fn, **kw):
        if self.graphs is None:
            self.out[name] = fn(**kw)
        else:
            if self.timed is None:
                self.graphs[name].replay()
            else:
                with self.timed.device_span(f"mcmc.part.{name}"):
                    self.graphs[name].replay()
            self.part_replays[name] += 1
        return self.out[name]

    def _read(self, flag) -> bool:
        """A decision the device made, read on the host (a sync)."""
        if self.rec is None:
            return bool(flag.item())
        with trace.span("mcmc.accept_read"):
            return bool(flag.item())

    # -- the iteration -----------------------------------------------------

    def _iterate(self, predicting: bool, warm: bool = False, ran=None):
        """One iteration through the parts (replayed once captured); the
        names of the parts run go into ``ran``."""
        ran = set() if ran is None else ran
        s, cfg = self.state, self.cfg
        if self.C:
            name = f"C{int(predicting)}"
            out = self._run(name, lambda: self._part_C(predicting, warm=warm))
            ran.add(name)
        else:
            out = self._run("A", lambda: self._part_A(warm=warm))
            ran.add("A")
            if cfg.sample_theta:
                accepted = self._read(out["accepted"])
                install = accepted
                if accepted and self.P.accept_aware:
                    install = self._read(self._run("R", self._part_R)["ok2"])
                    ran.add("R")
                if install:
                    self._run("I", self._part_I)
                    ran.add("I")
                ram = s.ram
                s = s._replace(ram=ram._replace(
                    propos_count=ram.propos_count + 1.0,
                    accept_count=ram.accept_count + float(accepted)))
            name = f"T{int(predicting)}"
            self._run(name, lambda: self._part_T(predicting))
            ran.add(name)
        if cfg.sample_theta and cfg.adapting and cfg.ram_reference_warmup:
            # the warmup's flag, from the eager iterations (True once
            # captured: capture comes after the switch-on)
            s = s._replace(ram=s.ram._replace(
                started=self.graphs is not None or out["started"]))
        self.state = s._replace(it=s.it + 1)

    def step(self, predicting: bool, ran: set | None = None) -> MCMCState:
        """One iteration; returns the state (the static buffers, which the
        next iteration overwrites).  The names of the parts it ran go into
        ``ran``."""
        if self.state.it >= self.eta.shape[0]:
            raise ValueError(f"StepRunner: iteration {self.state.it} is past "
                             f"the {self.eta.shape[0]} it was built for")
        self.draw(self.d)
        warm = (self.cfg.ram_reference_warmup and self.cfg.adapting
                and self.cfg.sample_theta and self.state.it <= G0)
        if not self.capture or self.graphs is not None or warm:
            self._iterate(predicting, warm=warm, ran=ran)
        else:
            self._warm_up_and_capture(predicting, ran)
        return self.state

    def _warm_up_and_capture(self, predicting: bool, ran: set | None):
        side = torch.cuda.Stream(self.ms.device)
        side.wait_stream(torch.cuda.current_stream(self.ms.device))
        parts = self._parts()
        with torch.cuda.stream(side):
            ran = set() if ran is None else ran
            self._iterate(predicting, ran=ran)
        with trace.span("mcmc.capture") as sp:
            with torch.cuda.stream(side):
                # every part once on this stream before its capture,
                # without writing the state and uncounted (not the chain's
                # work); A ran first, so R and I have its output
                before = kernel_counts.snapshot()
                for name in [n for n in parts if n not in ran]:
                    self.out[name] = parts[name](commit=False)
                kernel_counts.restore(before)
            torch.cuda.current_stream(self.ms.device).wait_stream(side)
            pool = torch.cuda.graph_pool_handle()
            graphs = {}
            for name, fn in parts.items():
                graphs[name] = graph.Graph(name, fn, pool, side)
                self.out[name] = graphs[name].out
            self.graphs = graphs
            torch.cuda.synchronize(self.ms.device)
        self.capture_s = sp.seconds

    def release(self):
        """Drop the graphs and their memory (the state stays)."""
        self.graphs, self.out = None, {}


def chunk_sizes(cfg: MCMCConfig):
    """The balanced chunk geometry (mc, ipc, n_keep_chunks, n_burn_chunks):
    mc kept samples (mc * thin iterations) per chunk, burn rounded up to
    whole chunks, as in the JAX package.  ``cfg.mc_fixed`` pins mc (resumed
    runs, burn-only continuations included)."""
    if cfg.keep > 0:
        if cfg.mc_fixed:
            mc = int(cfg.mc_fixed)
            n_keep_chunks = -(-cfg.keep // mc)
        else:
            n_keep_chunks = -(-cfg.keep // min(cfg.chunk, cfg.keep))
            mc = -(-cfg.keep // n_keep_chunks)
    else:
        n_keep_chunks = 0
        mc = int(cfg.mc_fixed) if cfg.mc_fixed else cfg.chunk
    ipc = mc * cfg.thin
    n_burn_chunks = int(np.ceil(cfg.burn / ipc)) if cfg.burn > 0 else 0
    return mc, ipc, n_keep_chunks, n_burn_chunks


class Moments(NamedTuple):
    """Device-side running sums of summary collection: O(n) output
    whatever keep is.  ``count`` (kept draws summed) is a host number."""

    count: float
    w_sum: torch.Tensor  # (n,)
    w_sq: torch.Tensor
    yh_sum: torch.Tensor
    yh_sq: torch.Tensor


def _resolve_wire(cfg: MCMCConfig, ms: ModelStatic):
    """Device->host dtype of the w draws (None = ship at the model dtype)."""
    wd = cfg.wire_dtype
    if wd is None:  # auto: half the bytes for f32 models
        return torch.float16 if ms.dtype == torch.float32 else None
    if wd in (False, "none", "off"):
        return None
    d = getattr(torch, wd) if isinstance(wd, str) else wd
    if not isinstance(d, torch.dtype):
        raise ValueError(f"wire_dtype {wd!r} is not a torch dtype")
    return None if d == ms.dtype else d


def _moments_zero(ms: ModelStatic, lead=()) -> Moments:
    z = lambda: torch.zeros(lead + (ms.n,), dtype=ms.dtype, device=ms.device)
    return Moments(0.0, z(), z(), z(), z())


def _moments_add(acc: Moments, w_k: torch.Tensor,
                 yh: torch.Tensor) -> Moments:
    """Add one kept draw's (n,) w and yhat ((C, n) for chains) to the five
    sums."""
    acc.w_sum.add_(w_k)
    acc.w_sq.addcmul_(w_k, w_k)
    acc.yh_sum.add_(yh)
    acc.yh_sq.addcmul_(yh, yh)
    return acc._replace(count=acc.count + 1.0)


def make_yhat_rngs(ms: ModelStatic, seed: int):
    """The yhat noise streams of a run: a numpy generator, which nothing
    draws from any more but checkpoints still carry, and the device
    generator of every kept draw's yhat noise.  Neither is the chain's
    generator, so every collection mode draws the same chain."""
    dev_seed = int(np.random.SeedSequence([seed, 1]).generate_state(1)[0])
    return (np.random.default_rng(seed),
            torch.Generator(device=ms.device).manual_seed(dev_seed))


class _DeviceNormal:
    """A numpy-like ``standard_normal(shape, dtype)`` that draws from the
    device generator ``gen`` and returns a tensor on its device."""

    def __init__(self, gen: torch.Generator, device: torch.device):
        self.gen, self.device = gen, device

    def standard_normal(self, shape, dtype=np.float64):
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=getattr(torch, np.dtype(dtype).name))


def _subsample_plan(cfg: MCMCConfig, mc: int, summary: bool):
    """Summary-mode quantile subsample (``summary_draws``): every
    ``sub_stride``-th kept draw of a chunk (local indices 0, s, 2s, ...) of
    every ``chunk_stride``-th chunk is kept, so ~summary_draws draws are
    kept for any chunk geometry (a chunk-local stride alone cannot keep
    fewer than one draw per chunk).  Returns (sub_stride, chunk_stride);
    sub_stride 0 = subsample off."""
    if not (summary and cfg.summary_draws > 0 and cfg.keep > 0):
        return 0, 1
    g = max(1, int(np.ceil(cfg.keep / cfg.summary_draws)))  # global stride
    if g <= mc:
        return g, 1
    return mc, max(1, int(round(g / mc)))


def _out_keys(summary: bool, sub_stride: int):
    """Host-side collection keys."""
    if not summary:
        return ("w", "yhat", "beta", "tausq", "theta")
    return ("beta", "tausq", "theta") + (("w", "yhat") if sub_stride else ())


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _Reporter:
    """Rolling-window and cumulative acceptance reports (reference:
    RAMAdapt::print/print_summary, mh_adapt.h:137-148, printed from
    spamtree_fit.cpp:334-372); theta and tausq too with verbose >= 2.
    ``chains=C`` reports the aggregate over the chains, and with verbose
    >= 2 the acceptance of each chain."""

    def __init__(self, t0, verbose, chains=0):
        self.t0, self.verbose, self.C = t0, int(verbose), chains
        self.prev = dict(acc=0.0, prop=0.0, t=t0, it=0)

    def snap(self, st):
        """The report's fields of ``st``: host values for one chain; for
        chains, copies on the device, read when the report prints (the
        batched step never reads the device)."""
        parts = (st.ram.accept_count, st.ram.propos_count)
        if self.verbose >= 2:
            parts += (st.theta, 1.0 / st.tausq_inv)
        if self.C:
            return tuple(a.clone() for a in parts)
        return parts[:2] + tuple(_host(a) for a in parts[2:])

    def report(self, phase, done, total, snap, iters_done):
        p = self.prev
        acc_c, prop_c = _host(snap[0]), _host(snap[1])
        acc, prop = float(acc_c.sum()), float(prop_c.sum())
        now = time.time()
        roll = (acc - p["acc"]) / max(prop - p["prop"], 1.0)
        ms_it = 1e3 * (now - p["t"]) / max(iters_done - p["it"], 1)
        hdr = f"{done}/{total}" + (f" x {self.C} chains" if self.C else "")
        print(f"[{phase}] {hdr}, {now - self.t0:.2f}s, "
              f"{ms_it:.1f}ms/iter, accept {roll:.2%} (window) "
              f"{acc / max(prop, 1.0):.2%} (cumulative)")
        if self.verbose >= 2 and len(snap) > 2:
            if self.C:
                by = acc_c / np.maximum(prop_c, 1.0)
                print(f"  accept by chain: {np.array2string(by, precision=3)}")
            print(f"  theta = {np.array2string(_host(snap[2]), precision=4)}")
            print(f"  tausq = {np.array2string(_host(snap[3]), precision=5)}")
        self.prev = dict(acc=acc, prop=prop, t=now, it=iters_done)

    def printall(self, theta_s, tausq_s, base):
        """verbose == 3: every kept iteration's theta and tausq, printed at
        drain time (the reference's printall, spamtree_fit.cpp:344-350)."""
        if self.verbose == 3:
            for i in range(theta_s.shape[0]):
                print(f"    it {base + i + 1}: theta="
                      f"{np.array2string(theta_s[i], precision=4)} tausq="
                      f"{np.array2string(tausq_s[i], precision=5)}")


def _make_yhat_host(ms: ModelStatic, rng):
    """The kept draws' posterior predictive yhat = X beta + w + tau z
    (reference: spamtree_fit.cpp:384), built on the device at each kept
    draw: ``yhat(state, n_all=0, c0=0)`` gives the (n,) yhat of a chain's
    state, or the (C, n) yhat of chains c0 .. c0 + C - 1 of a run of n_all
    chains (every chain's noise is drawn and this rank's kept, so a chain's
    noise does not depend on the mesh).  ``rng.standard_normal(shape,
    dtype=<numpy dtype>)`` gives z, and whatever it returns is moved onto
    the model's device: ``_drive`` passes ``_DeviceNormal`` over the run's
    device yhat generator.  The name is from when yhat was built on the
    host; it is kept, with its signature, as the seam where the benchmark's
    ``yhat_no_noise`` fault hands in an ``rng`` that returns numpy zeros."""
    n = ms.n
    mv = ms.mv[:n]
    zdt = np.float64 if ms.dtype == torch.float64 else np.float32

    def _yhat(state: MCMCState, n_all: int = 0, c0: int = 0):
        w = state.w[..., :n]
        shape = ((n_all,) if w.dim() > 1 else ()) + (n,)
        z = torch.as_tensor(rng.standard_normal(shape, dtype=zdt),
                            device=ms.device)
        if w.dim() > 1:
            z = z.narrow(0, c0, w.shape[0])
        return (state.XB[..., :n] + w
                + torch.sqrt(1.0 / state.tausq_inv)[..., mv] * z)

    return _yhat


_QUEUE_DEPTH = 2  # chunks queued for the drain thread
_STAGED = 2  # device staging rows of the draws streamed to the host


class HostRing:
    """Host buffers for the keep chunks' draws, reused: pinned when the
    model runs on CUDA, where allocating a pinned buffer per chunk would
    cost more than the copies.

    ``take()`` hands out the free slot released last (blocking while
    every slot is in use, in the span ``mcmc.drain_wait``), so a drain
    that keeps up cycles through two slots and never pins the others.
    ``put(slot, j, tensors)`` streams one kept draw into row j of the
    slot's buffers as it is drawn:
    on CUDA each tensor is copied into a device staging row (``_STAGED``
    deep, each reused once the side stream's copy out of it has run, which
    the current stream waits for on the device), and the side stream
    copies it, non-blocking, into the pinned row; on the CPU the row is
    copied at once.  ``copy(tensors, slot)`` copies a chunk's whole
    tensors into the slot (taking one when none is given) behind every
    row put into it, and returns (slot, {name: host view}, event or None):
    the event follows all of the slot's copies.  The tensors given to
    ``copy`` must stay referenced until the event has completed.
    ``release(slot)`` hands the slot back once its reader is done with
    it.  A slot's buffers are sized at first use to ``rows`` draws, or to
    the tensor when that is longer."""

    def __init__(self, n_slots: int, device: torch.device, rows: int):
        self.pinned = device.type == "cuda"
        self.device = device
        self.rows = rows
        self.free: queue.LifoQueue = queue.LifoQueue()
        for _ in range(n_slots):
            self.free.put({})
        self.allocations = 0
        self._side = torch.cuda.Stream(device) if self.pinned else None
        self._staged: list = []  # [({name: device row}, ready, done)]
        self._puts = 0

    def take(self) -> dict:
        with trace.span("mcmc.drain_wait"):
            return self.free.get()

    def _buffer(self, slot: dict, k: str, rows: int, row_shape, dtype):
        buf = slot.get(k)
        if (buf is None or buf.dtype != dtype
                or tuple(buf.shape[1:]) != tuple(row_shape)
                or buf.shape[0] < rows):
            buf = slot[k] = torch.empty(
                (max(self.rows, rows),) + tuple(row_shape), dtype=dtype,
                pin_memory=self.pinned)
            self.allocations += 1
        return buf

    def put(self, slot: dict, j: int, tensors: dict):
        rows = {k: self._buffer(slot, k, j + 1, t.shape, t.dtype)[j]
                for k, t in tensors.items()}
        if not self.pinned:
            for k, t in tensors.items():
                rows[k].copy_(t)
            return
        if len(self._staged) < _STAGED:
            self._staged.append(({}, torch.cuda.Event(), torch.cuda.Event()))
        stage, ready, done = self._staged[self._puts % _STAGED]
        self._puts += 1
        main = torch.cuda.current_stream(self.device)
        main.wait_event(done)  # its last copy out has run
        for k, t in tensors.items():
            buf = stage.get(k)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = stage[k] = torch.empty_like(t)
            buf.copy_(t)
        ready.record(main)
        self._side.wait_event(ready)
        with torch.cuda.stream(self._side):
            for k in tensors:
                rows[k].copy_(stage[k], non_blocking=True)
            done.record(self._side)

    def copy(self, tensors: dict, slot: dict | None = None):
        if slot is None:
            slot = self.take()
        views, side = {}, self._side
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(self.device))
        with (torch.cuda.stream(side) if side is not None
              else contextlib.nullcontext()):
            for k, t in tensors.items():
                buf = self._buffer(slot, k, t.shape[0], t.shape[1:], t.dtype)
                views[k] = buf[: t.shape[0]]
                views[k].copy_(t, non_blocking=self.pinned)
            event = None
            if self.pinned:
                event = torch.cuda.Event()
                event.record(side)
        return slot, views, event

    def release(self, slot):
        self.free.put(slot)


class _Draws:
    """The row-indexed draws (w or yhat) of a run kept in RAM: one array
    of every kept row, allocated once, whose pages fill as the drains
    write into it, so the result needs no concatenation.  ``append``
    copies a chunk's host rows in, decoding the wire type."""

    def __init__(self, rows: int, shape, dtype):
        self.a = np.empty((rows,) + tuple(shape), dtype=dtype)
        self.n = 0

    def append(self, x: torch.Tensor):
        torch.from_numpy(self.a[self.n:self.n + x.shape[0]]).copy_(x)
        self.n += x.shape[0]

    def result(self) -> np.ndarray:
        return self.a[: self.n] if self.n else np.zeros((0,))


def _drain_samples(host, m_take, *, summary, sinks, outs):
    """Store one chunk's host copies (``host``: torch tensors in pinned or
    host buffers that are reused, so everything kept is copied out): w
    and yhat to the sinks (float32) or into the run's ``_Draws``, the
    small parameters kept.  Raises on a non-finite theta draw (reference
    aborts on a NaN loglik, spamtree_fit.cpp:234-237).  Returns (theta_s,
    tausq_s)."""
    with trace.span("mcmc.drain.store"):
        beta_s, tausq_s, theta_s = (host[k][:m_take].numpy().copy()
                                    for k in ("beta", "tausq", "theta"))
        for k in () if summary else ("w", "yhat"):
            if sinks is not None:
                sinks[k].push(host[k][:m_take].to(torch.float32).numpy())
            else:
                outs[k].append(host[k][:m_take])
        outs["beta"].append(beta_s)
        outs["tausq"].append(tausq_s)
        outs["theta"].append(theta_s)
    if not np.isfinite(theta_s).all():
        raise FloatingPointError(
            "non-finite theta in chain; aborting (NaN loglik guard)")
    return theta_s, tausq_s


def _drain_subsample(host, m_take, stride, *, outs):
    """Summary-mode quantile subsample: store the chunk's strided w and
    yhat draws (only these were copied)."""
    with trace.span("mcmc.drain.store"):
        sub_take = -(-m_take // stride)  # kept draws at local 0, s, ..
        for k in ("w", "yhat"):
            outs[k].append(host[k][:sub_take])


class _SkipSink:
    """Where a mesh rank other than 0 sends the draws rank 0 writes."""

    def __init__(self, path):
        self.path = path

    def push(self, _):
        pass

    def close(self):
        pass


def _make_sinks(sink_dir, summary, sink_append, write=True):
    """Sample sinks for the row-indexed draws (w, yhat): stream them to disk
    on the native writer thread instead of holding them in host RAM (n ~
    1e6).  ``sink_append`` continues existing files (resumed runs);
    ``write=False`` names the same files and writes nothing."""
    if sink_dir is None or summary:
        return None
    import os

    path = lambda k: os.path.join(sink_dir, f"{k}_mcmc.f32")
    if not write:
        return {k: _SkipSink(path(k)) for k in ("w", "yhat")}
    from spamtree_tpu_torch.utils.native import SampleSink

    os.makedirs(sink_dir, exist_ok=True)
    return {k: SampleSink(path(k), append=sink_append)
            for k in ("w", "yhat")}


def _drain_loop(n_keep_chunks, dispatch, drain, pipeline):
    """The chunked keep loop.  ``dispatch(ki)`` runs chunk ki and returns
    the drain payload (host copies in flight); ``drain(*payload)`` waits for
    them and stores the samples.

    Pipelined, the drains run on a worker thread at most ``_QUEUE_DEPTH``
    chunks behind, so the host's drain work overlaps the next chunks'
    iterations.  Not when checkpointing: a saved state must never run ahead
    of the drained samples.

    KeyboardInterrupt keeps partial results, as the reference's
    checkInterrupt polling does (spamtree_fit.cpp:336,355-360); chunks
    already run are drained, and a further interrupt while they flush does
    not drop them.  A drain's error -- the non-finite-theta guard included
    -- is raised after the worker has stopped: up to two chunks late when
    pipelined.

    The main thread's waits on the worker are spans of the call's trace
    record: ``mcmc.drain_wait`` while the queue is full, ``mcmc.drain_flush``
    for the last chunks; the worker writes its spans into the same record."""
    if not pipeline:
        try:
            for ki in range(n_keep_chunks):
                drain(*dispatch(ki))
        except KeyboardInterrupt:
            print("MCMC interrupted; returning partial results.")
        return

    q: queue.Queue = queue.Queue(maxsize=_QUEUE_DEPTH)
    fail: list = []
    done = threading.Event()
    rec = trace.current()

    def _worker():
        try:
            with trace.adopt(rec):
                while True:
                    item = q.get()
                    if item is None:
                        return
                    drain(*item)
        except BaseException as e:  # raised by the main thread after join
            fail.append(e)
        finally:
            done.set()

    def _put(item) -> bool:
        # never block forever on a dead worker (a failed drain stops it)
        while not fail:
            try:
                q.put(item, timeout=1.0)
                return True
            except queue.Full:
                continue
        return False

    t = threading.Thread(target=_worker, name="spamtree-drain", daemon=True)
    t.start()
    interrupted = False
    try:
        for ki in range(n_keep_chunks):
            if fail:
                break
            item = dispatch(ki)
            with trace.span("mcmc.drain_wait"):
                if not _put(item):
                    break
    except KeyboardInterrupt:
        interrupted = True
    finally:
        # flush what is queued even under further interrupts: each queued
        # chunk's iterations already ran and its draws exist nowhere else.
        # (An interrupted Thread.join marks a live thread as stopped, so
        # the wait is on an event the worker sets as it ends.)
        with trace.span("mcmc.drain_flush"):
            sent = False
            while True:
                try:
                    sent = sent or _put(None)
                    done.wait()
                    break
                except KeyboardInterrupt:
                    interrupted = True
                    print("MCMC interrupted again; still draining the "
                          "chunks already run.")
            t.join()
    if interrupted:
        print("MCMC interrupted; returning partial results.")
    if fail:
        raise fail[0]


def _summary_result(res, acc: Moments, empty_shape):
    """Summary collection's outputs: the running sums as posterior
    mean/variance fields; the draw arrays stay empty unless the quantile
    subsample (summary_draws) filled them."""
    cnt = max(acc.count, 1.0)
    h = lambda a: a.cpu().numpy()
    w_mean = h(acc.w_sum) / cnt
    yh_mean = h(acc.yh_sum) / cnt
    res["w_mean"] = w_mean
    res["w_var"] = np.maximum(h(acc.w_sq) / cnt - w_mean**2, 0.0)
    res["yhat_mean"] = yh_mean
    res["yhat_var"] = np.maximum(h(acc.yh_sq) / cnt - yh_mean**2, 0.0)
    res["summary_count"] = cnt
    if "w" not in res or res["w"].size == 0:
        res["w"] = np.zeros(empty_shape)
        res["yhat"] = np.zeros(empty_shape)


def _graphed(ms: ModelStatic, graphs) -> bool:
    """Resolve run_mcmc's ``graphs`` (``graphs_default`` for None)."""
    if graphs is None:
        return graph.graphs_default(ms.device.type, None if ms.mesh is None
                                    else ms.mesh.backend)
    return bool(graphs)


def _runner(ms, bounds, cfg, state, draw, chains, donate):
    """(StepRunner, its ``one(state, predicting)`` for ``_drive``).  The
    drain may stay pipelined when the capture falls inside the keep loop (a
    reference warmup longer than the burn): a capture bars host syncs on
    its own thread only (``graph.Graph``)."""
    _, ipc, _, n_burn_chunks = chunk_sizes(cfg)
    r = StepRunner(ms, bounds, cfg, state, draw, chains=chains,
                   n_iters=n_burn_chunks * ipc + cfg.keep * cfg.thin,
                   donate=donate)
    return r, (lambda s, predicting, ran=None: r.step(predicting, ran))


def part_work(ms: ModelStatic, bounds: np.ndarray, cfg: MCMCConfig,
              state: MCMCState, chains: int = 0) -> dict:
    """{part name: utils.cost.Counter}: the work of one call of each part
    of the iteration as ``StepRunner`` splits it (``StepRunner._parts``:
    A, R, I, T0, T1 for one chain, C0, C1 for ``chains`` batched ones),
    counted from shapes on a copy of ``state`` with every draw 1.0, as
    plain calls on either device -- so the CPU and the card count the
    same work.  ``state`` is not touched and no kernel launch or
    factorised block is counted.
    On a mesh every rank calls it (the parts hold the mesh's collectives,
    which count as copies), and each counts its own shard."""
    r = StepRunner(ms, bounds, cfg, state, None, chains=chains, n_iters=2,
                   capture=False)
    for t in r.d:
        t.fill_(1.0)
    before, work = kernel_counts.snapshot(), {}
    try:
        for name, fn in r._parts().items():  # A first: R and I read its out
            with cost.Counter() as c:
                r.out[name] = fn()
            work[name] = c
    finally:
        kernel_counts.restore(before)
    return work


def _count_work(ms, bounds, cfg, state, chains, count_work):
    """(``part_work``, its seconds) when ``count_work``, else None."""
    if not count_work:
        return None
    with trace.span("mcmc.count_work") as sp:
        work = part_work(ms, bounds, cfg, state, chains)
        if ms.device.type == "cuda":
            torch.cuda.synchronize(ms.device)
    return work, sp.seconds


def _work_result(res: dict, counted):
    """From ``_count_work``'s (work, seconds): res["part_work"] ({part:
    dict(flops, bytes, calls, by_kind)}, calls being the part's calls in
    the keep loop), ``work_count_s``, and the keep loop's flops and bytes
    per kept draw, ``flops_per_kept_sample`` and
    ``bytes_per_kept_sample``: each part's work times its calls, summed,
    over the kept draws.  All None without a count."""
    for k in ("part_work", "work_count_s", "flops_per_kept_sample",
              "bytes_per_kept_sample"):
        res[k] = None
    if counted is None:
        return
    work, res["work_count_s"] = counted
    calls, kept = res["part_calls"], res["theta"].shape[0]
    res["part_work"] = {
        k: dict(flops=c.work.flops, bytes=c.work.bytes, calls=calls[k],
                by_kind={kind: tuple(v) for kind, v in c.by_kind.items()})
        for k, c in work.items()}
    if kept:
        for i, key in enumerate(("flops", "bytes")):
            res[f"{key}_per_kept_sample"] = sum(
                c.work[i] * calls[k] for k, c in work.items()) / kept


def _graph_result(res: dict, runner):
    """The capture's seconds (under the JAX package's key for its compile)
    and the graph replays, read from the call's trace record, into which
    the runner's replays per part go as ``mcmc.replays.<part>``."""
    rec = trace.current()
    if runner is not None:
        for name, n in runner.part_replays.items():
            rec.count(f"mcmc.replays.{name}", n)
        runner.release()
    res["compile_time_s"] = rec.seconds("mcmc.capture")
    res["graph_replays"] = sum(v for k, v in rec.counters.items()
                               if k.startswith("mcmc.replays."))


def _sample(ms, bounds, cfg, state, gens, chains, draw, graphs, donate,
            count_work, drive_args) -> dict:
    """The body of ``run_mcmc`` (``chains=0``, ``gens`` its generator,
    ``draw`` = ``draw_step``) and ``run_mcmc_chains`` (``chains=C``,
    ``draw_chains``): the work count, the graphed or eager iteration and
    ``_drive``'s loop, with ``drive_args`` = (verbose, yhat_seed,
    checkpoint_path, sink_dir, sink_append, init_moments, base_counts,
    yhat_rngs)."""
    nt = state.theta.shape[-1]
    shape = tausq_shape(ms, cfg.tausq_ab)
    counted = _count_work(ms, bounds, cfg, state, chains, count_work)
    runner = None
    if _graphed(ms, graphs):
        runner, one = _runner(
            ms, bounds, cfg, state,
            lambda out: draw(ms, gens, nt, shape, out=out), chains, donate)
    else:
        step = make_step(ms, bounds, cfg, coords_cache=level_coords(ms),
                         chains=bool(chains))

        def one(s, predicting, ran=None):
            return step(s, draw(ms, gens, nt, shape), predicting, ran)

    with kernel_counts.trace_blocks():
        res = _drive(ms, cfg, state, one, gens, chains, *drive_args)
    _graph_result(res, runner)
    _work_result(res, counted)
    return res


@trace.entry("run_mcmc")
def run_mcmc(ms: ModelStatic, bounds: np.ndarray, cfg: MCMCConfig,
             state: MCMCState, gen: torch.Generator, verbose: bool = False,
             yhat_seed: int = 0, checkpoint_path: str | None = None,
             sink_dir: str | None = None, sink_append: bool = False,
             init_moments: Moments | None = None, base_counts=(0, 0),
             yhat_rngs=None, graphs=None, donate: bool = False,
             count_work: bool = False) -> dict:
    """Burn, then keep in chunks; returns host-side sample arrays.

    Burn runs ``n_burn_chunks * mc * thin`` iterations (``burn_actual``)
    without prediction.  Each kept sample is the last of ``thin`` iterations
    and the only one that predicts; the last chunk runs only the kept
    samples still missing.  ``gen`` is the chain's generator;
    ``yhat_rngs`` (default ``make_yhat_rngs(ms, yhat_seed)``) the yhat
    noise streams.

    ``checkpoint_path``: the sampler state, the generators, the moments and
    (mc, burn_done, kept_done, thin) are saved there after every chunk;
    ``base_counts`` = (burn_done, kept_done) of the runs this one continues
    and ``init_moments`` their moments (``api.spamtree``'s resume).
    ``sink_dir``: w/yhat draws stream to files there instead of RAM
    (``sink_append`` continues them).

    ``graphs`` (default None: on for a CUDA model alone or on an NCCL
    mesh, with or without ``torch.use_deterministic_algorithms``): each
    iteration runs as replayed CUDA graphs (``StepRunner``), the same
    chain bit for bit, on every rank of a mesh; ``res["compile_time_s"]``
    holds the capture's seconds and ``res["graph_replays"]`` the replays.
    False runs the eager step (``make_step``), the default on the CPU and
    on a gloo mesh.  True on the CPU runs the capture-ready step's parts
    as plain calls; on a gloo mesh with CUDA tensors it raises a
    ``ValueError`` (gloo's host staging).  ``state`` is not modified,
    unless ``donate=True``: the graphed run then keeps its carry in the
    state's own tensors, with no copy, and overwrites them.

    ``count_work`` (the JAX package's ``precompile``): before the timed
    loop, each part of the iteration's work is counted (``part_work``;
    ``res["work_count_s"]`` seconds), and weighted by the part's calls in
    the keep loop into ``res["flops_per_kept_sample"]`` and
    ``res["bytes_per_kept_sample"]``: the work of the ``thin`` iterations
    behind a kept draw, as the JAX package's XLA count of its keep chunk;
    without it they are None.  On a mesh they are this rank's: its shard
    of every level, the collectives as copies."""
    res = _sample(ms, bounds, cfg, state, gen, 0, draw_step, graphs, donate,
                  count_work, (verbose, yhat_seed, checkpoint_path, sink_dir,
                               sink_append, init_moments, base_counts,
                               yhat_rngs))
    ram = res["state"].ram
    res["accept_ratio"] = ram.accept_count / max(ram.propos_count, 1)
    return res


@trace.entry("run_mcmc_chains")
def run_mcmc_chains(ms: ModelStatic, bounds: np.ndarray, cfg: MCMCConfig,
                    states: MCMCState, gens, verbose: bool = False,
                    yhat_seed: int = 0, checkpoint_path: str | None = None,
                    sink_dir: str | None = None, sink_append: bool = False,
                    init_moments: Moments | None = None, base_counts=(0, 0),
                    yhat_rngs=None, graphs=None, donate: bool = False,
                    count_work: bool = False) -> dict:
    """``run_mcmc`` for C chains in one batched step: ``states`` with a
    leading chain axis and ``gens`` their C generators
    (``stack_chain_states``).  The same chunk geometry, burn rounding,
    pipelined drain, sinks, summary collection (moments (C, n), yhat noise
    (C, n) from the device generator), checkpoints and reports.  Nothing
    is read from the device inside an iteration; the non-finite-theta
    guard reads theta once per burn chunk, and the drain checks the kept
    theta draws of every keep chunk.

    Outputs carry the chain axis after the sample axis: w/yhat (keep, C,
    n), beta (keep, C, p, q), tausq (keep, C, q), theta (keep, C, nt);
    ``accept_ratio`` over all chains and ``accept_by_chain`` (C,).  On a
    mesh with a chains axis, ``states`` and ``gens`` are this rank's
    chains, contiguous in rank order, and the outputs hold every rank's.
    ``graphs`` and ``donate`` as in ``run_mcmc``: one graph per iteration
    variant (predicting or not) on CUDA alone or on an NCCL mesh; the
    draws, moments and checkpoints are gathered over the chains ranks
    outside the graphs.  ``count_work`` as in ``run_mcmc``: the count
    covers every chain's work (one batched step), on a chains mesh this
    rank's chains."""
    C = states.theta.shape[0]
    if len(gens) != C:
        raise ValueError(f"{len(gens)} generators for {C} chains")
    res = _sample(ms, bounds, cfg, states, gens, C, draw_chains, graphs,
                  donate, count_work, (verbose, yhat_seed, checkpoint_path,
                                       sink_dir, sink_append, init_moments,
                                       base_counts, yhat_rngs))
    gather = _chain_gather(ms, C)
    acc = _host(gather(res["state"].ram.accept_count, 0))
    prop = _host(gather(res["state"].ram.propos_count, 0))
    res["accept_ratio"] = float(acc.sum()) / max(float(prop.sum()), 1.0)
    res["accept_by_chain"] = acc / np.maximum(prop, 1.0)
    return res


def _chain_gather(ms: ModelStatic, chains: int):
    """``gather(x, dim)``: every chains rank's chains of ``x`` along
    ``dim`` on a mesh with a chains axis; ``x`` itself otherwise."""
    mesh = ms.mesh
    if not chains or mesh is None or mesh.n_chains == 1:
        return lambda x, dim: x
    return mesh.cat_chains


def _check_theta(state: MCMCState):
    """The non-finite-theta guard on the live state (one device read)."""
    if not bool(torch.isfinite(state.theta).all()):
        raise FloatingPointError(
            "non-finite theta in chain; aborting (NaN loglik guard)")


def _drive(ms, cfg, state, one, gens, chains, verbose, yhat_seed,
           checkpoint_path, sink_dir, sink_append, init_moments, base_counts,
           yhat_rngs) -> dict:
    """The chunked burn/keep loop of ``run_mcmc`` (``chains=0``) and
    ``run_mcmc_chains`` (``chains=C``): ``one(state, predicting, ran)``
    runs one iteration and adds the names of the parts it ran to the set
    ``ran``; ``res["part_calls"]`` counts them over the keep loop.
    ``gens`` (the generator, or the chains' list) is what a checkpoint
    saves.

    Its timings are spans of the call's trace record (``utils.trace``):
    ``mcmc.run`` the loop (``mcmc_time``), and inside it ``mcmc.iterate``
    (``iter_s``), ``mcmc.save`` (``save_s``), ``mcmc.stage`` (each kept
    draw's yhat, moments and row copies, and a keep chunk's small
    parameters), the drain's spans (``_drain_loop``, ``HostRing.take``;
    ``mcmc.drain`` less its ``mcmc.drain.copy_wait`` is ``drain_work_s``)
    and ``mcmc.result``; the counters ``mcmc.iterations``, ``mcmc.chunks``
    (keep chunks) and ``mcmc.yhat_device`` (kept draws times this rank's
    chains, each draw's yhat built on the device)."""
    if cfg.collect not in ("all", "summary"):
        raise ValueError(f"collect={cfg.collect!r}: 'all' or 'summary'")
    n = ms.n
    lead = (chains,) if chains else ()
    mesh = ms.mesh
    rank0 = mesh is None or mesh.rank == 0
    gather = _chain_gather(ms, chains)
    # this rank's chains among all of the run's (a mesh's chains axis)
    n_all = chains * (mesh.n_chains if mesh is not None else 1)
    c0 = mesh.chain_rank * chains if mesh is not None and chains else 0
    wire = _resolve_wire(cfg, ms)
    summary = cfg.collect == "summary"
    mc, ipc, n_keep_chunks, n_burn_chunks = chunk_sizes(cfg)
    burn_actual = n_burn_chunks * ipc
    sub_stride, sub_cstride = _subsample_plan(cfg, mc, summary)
    if yhat_rngs is None:
        yhat_rngs = make_yhat_rngs(ms, yhat_seed)
    yhat = _make_yhat_host(ms, _DeviceNormal(yhat_rngs[1], ms.device))
    acc = ((init_moments if init_moments is not None
            else _moments_zero(ms, lead)) if summary else None)
    burn_done0, kept_done0 = base_counts

    def save(burn_done, kept_done):
        from spamtree_tpu_torch.utils.checkpoint import save_state

        with trace.span("mcmc.save"):
            st, gs, mom = state, gens, acc
            if chains and mesh is not None:
                # every chains rank's chains; generator states cross on the
                # device, as every collective's tensors do
                g = lambda x: gather(x, 0)
                ram = st.ram
                st = st._replace(
                    w=g(st.w), beta=g(st.beta), tausq_inv=g(st.tausq_inv),
                    XB=g(st.XB), theta=g(st.theta), logdetCi=g(st.logdetCi),
                    ram=ram._replace(paramsd=g(ram.paramsd),
                                     prodparam=g(ram.prodparam),
                                     propos_count=g(ram.propos_count),
                                     accept_count=g(ram.accept_count)))
                gs = list(g(torch.stack([x.get_state() for x in gens]).to(
                    ms.device)).cpu())
                if mom is not None:
                    mom = Moments(mom.count, *(g(x) for x in mom[1:]))
            if rank0:
                save_state(checkpoint_path, st, gs, yhat_rngs, moments=mom,
                           counts=(mc, burn_done, kept_done, cfg.thin))

    def _dispatch(ki):
        nonlocal state, acc
        take = min(mc, cfg.keep - ki * mc)
        # skipped chunks' subsample draws are never copied
        use_sub = bool(sub_stride) and ki % sub_cstride == 0
        small, slot, rows = [], None, 0
        for j in range(take):
            with trace.span("mcmc.iterate"):
                for i in range(cfg.thin):
                    ran = set()
                    state = one(state, i == cfg.thin - 1, ran)
                    part_calls.update(ran)
            send = not summary or (use_sub and j % sub_stride == 0)
            if send and slot is None:
                slot = ring.take()
            with trace.span("mcmc.stage"):
                # the draw leaves the device finished: its yhat built here,
                # w and yhat streamed into the slot's row (a graphed run's
                # state is buffers the next iteration overwrites)
                w_k = state.w[..., :n]
                yh = yhat(state, n_all, c0)
                if summary:
                    acc = _moments_add(acc, w_k, yh)
                if send:
                    ring.put(slot, rows, {
                        "w": gather(w_k.to(wire) if wire is not None
                                    else w_k, 0),
                        "yhat": gather(yh, 0)})
                    rows += 1
                small.append((state.beta.clone(), 1.0 / state.tausq_inv,
                              state.theta.clone()))
        trace.count("mcmc.iterations", take * cfg.thin)
        trace.count("mcmc.yhat_device", take * max(chains, 1))
        trace.count("mcmc.chunks")
        with trace.span("mcmc.stage"):
            dev = {k: gather(torch.stack(v), 1)
                   for k, v in zip(("beta", "tausq", "theta"), zip(*small))}
            slot, host, event = ring.copy(dev, slot)
            if rows:
                host.update({k: slot[k][:rows] for k in ("w", "yhat")})
        # dev stays referenced until the drain has waited for its copies
        return (slot, host, event, dev, take, use_sub,
                rep.snap(state) if verbose else None)

    def _drain(slot, host, event, dev, m_take, use_sub, rep_snap):
        nonlocal drained
        with trace.span("mcmc.drain"):
            try:
                if event is not None:
                    with trace.span("mcmc.drain.copy_wait"):
                        event.synchronize()
                theta_s, tausq_s = _drain_samples(
                    host, m_take, summary=summary, sinks=sinks, outs=outs)
                if use_sub:
                    _drain_subsample(host, m_take, sub_stride, outs=outs)
            finally:
                del dev
                ring.release(slot)
        drained += m_take
        if checkpoint_path:
            # sequential drain: the live state is the just-drained chunk's
            save(burn_done0 + burn_actual, kept_done0 + drained)
        if verbose:
            rep.report("keep", drained, cfg.keep, rep_snap,
                       burn_actual + drained * cfg.thin)
        rep.printall(theta_s, tausq_s, drained - theta_s.shape[0])

    rec = trace.current()
    if ms.device.type == "cuda":
        torch.cuda.synchronize(ms.device)
    with trace.span("mcmc.run"):
        rep = _Reporter(time.time(), verbose, chains=chains)
        for bi in range(n_burn_chunks):
            with trace.span("mcmc.iterate"):
                for _ in range(ipc):
                    state = one(state, False)
                if chains:
                    _check_theta(state)
            trace.count("mcmc.iterations", ipc)
            if checkpoint_path:
                save(burn_done0 + (bi + 1) * ipc, kept_done0)
            if verbose:
                rep.report("burn", (bi + 1) * ipc, burn_actual,
                           rep.snap(state), (bi + 1) * ipc)

        sinks = _make_sinks(sink_dir, summary, sink_append, write=rank0)
        outs = {k: [] for k in _out_keys(summary, sub_stride)}
        if sinks is None and "w" in outs:
            # every kept draw, or the subsample's strided rows
            kept_rows = cfg.keep if not summary else sum(
                -(-min(mc, cfg.keep - ki * mc) // sub_stride)
                for ki in range(0, n_keep_chunks, sub_cstride))
            shape = ((n_all,) if chains else ()) + (n,)
            np_dt = lambda dt: torch.empty(0, dtype=dt).numpy().dtype
            outs["w"] = _Draws(kept_rows, shape, np_dt(
                ms.dtype if wire is None else torch.float32))
            outs["yhat"] = _Draws(kept_rows, shape, np_dt(ms.dtype))
        drained = 0
        # pipelined drain (see _drain_loop); sequential when
        # checkpointing, so the saved state never runs ahead of the drained
        # samples
        pipeline = checkpoint_path is None
        ring = HostRing(_QUEUE_DEPTH + 1 if pipeline else 1, ms.device, mc)
        part_calls = Counter()
        _drain_loop(n_keep_chunks, _dispatch, _drain, pipeline)

        with trace.span("mcmc.result"):
            if sinks is not None:
                for sk in sinks.values():
                    sk.close()
            if ms.device.type == "cuda":
                torch.cuda.synchronize(ms.device)
            res = {k: (v.result() if isinstance(v, _Draws)
                       else np.concatenate(v) if v else np.zeros((0,)))
                   for k, v in outs.items()}
            if sinks is not None:
                res["sink_files"] = {k: sk.path for k, sk in sinks.items()}
            if summary:
                if chains:
                    acc = Moments(acc.count, *(gather(x, 0) for x in acc[1:]))
                _summary_result(res, acc, (0,) + ((n_all,) if chains else ())
                                + (n,))
    res["burn_actual"] = burn_actual
    res["part_calls"] = part_calls
    # host seconds: the loop; the iterations alone (one chain syncs once
    # an iteration, on the accept decision; batched chains only queue
    # work); the checkpoint saves; the drains' own work (on the worker
    # thread when pipelined, so overlapping the iterations)
    res["mcmc_time"] = rec.seconds("mcmc.run")
    res["iter_s"] = rec.seconds("mcmc.iterate")
    res["save_s"] = rec.seconds("mcmc.save")
    res["drain_work_s"] = (rec.seconds("mcmc.drain")
                           - rec.seconds("mcmc.drain.copy_wait"))
    res["paramsd"] = gather(state.ram.paramsd, 0).cpu().numpy()
    res["state"] = state
    if mesh is not None:
        # rank 0's files are whole before any rank returns
        mesh.barrier()
    return res
