"""Per-phase timing diagnostics.

Port of ``spamtree_tpu/utils/diagnostics.py``.  The reference hand-times
every sampler phase with steady_clock spans printed under ``verbose``
(reference: spamtree_fit.cpp:182-330, spamtree_model.cpp timer blocks).
``time_phases`` runs each phase of one MCMC iteration on its own, between
``torch.cuda.synchronize`` fences on a CUDA model (plain wall time on the
CPU), and reports milliseconds per phase; ``trace_profile`` records one
call under ``torch.profiler`` for deep dives.  A state with a chain axis
(``mcmc.stack_chain_states``) times the batched phases of
``run_mcmc_chains``.
"""

from __future__ import annotations

import os
import time

import torch

from spamtree_tpu_torch.model.core import (
    ModelStatic,
    gibbs_beta,
    gibbs_tausq,
    gibbs_w,
    predict,
    quad_loglik,
    sweep,
    tausq_shape,
)


def _fence(ms: ModelStatic):
    if ms.device.type == "cuda":
        torch.cuda.synchronize(ms.device)


def time_phases(ms: ModelStatic, state, iters: int = 20) -> dict:
    """Milliseconds per call of each MCMC phase at ``state`` (one warm-up
    call each first): the likelihood sweep alone and with both quadratic
    forms fused (the step's), ``quad_loglik``, ``gibbs_w`` (Gram blocks
    formed in place), ``predict``, ``gibbs_tausq`` and ``gibbs_beta``, and
    ``total_per_iter``, the sum of the phases one iteration runs."""
    gen = torch.Generator(device=ms.device).manual_seed(0)
    kw = dict(generator=gen, dtype=ms.dtype, device=ms.device)
    lead = tuple(state.w.shape[:-1])  # (C,) with a chain axis
    z = torch.randn(state.w.shape, **kw)
    g = torch._standard_gamma(
        tausq_shape(ms, (2.01, 1.0)).expand(lead + (ms.q,)).contiguous(),
        generator=gen)
    z_beta = torch.randn(lead + (ms.p, ms.q), **kw)
    Vi = 0.01 * torch.eye(ms.p, dtype=ms.dtype, device=ms.device)
    Vim = torch.zeros(ms.p, dtype=ms.dtype, device=ms.device)
    th, w = state.theta, state.w
    ld, pd, _, _ = sweep(ms, th, w)
    phases = {
        "sweep(theta-loglik)": lambda: sweep(ms, th, w),
        "sweep_fused(+quad x2)": lambda: sweep(ms, th, w, quad_prev=ld),
        "quad_loglik": lambda: quad_loglik(ms, ld, w),
        "gibbs_w": lambda: gibbs_w(ms, ld, w, state.tausq_inv, state.XB, z),
        "predict": lambda: predict(ms, pd, w, z),
        "gibbs_tausq": lambda: gibbs_tausq(ms, w, state.XB, g, (2.01, 1.0)),
        "gibbs_beta": lambda: gibbs_beta(ms, w, state.tausq_inv, z_beta, Vi,
                                         Vim),
    }
    out = {}
    for name, fn in phases.items():
        fn()  # warm-up: kernel builds, allocator
        _fence(ms)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _fence(ms)
        out[name] = (time.perf_counter() - t0) / iters * 1e3
    # the step runs the fused sweep (both MH quadratic forms ride the
    # proposal sweep); the standalone sweep and quad rows are for comparison
    out["total_per_iter"] = (
        out["sweep_fused(+quad x2)"] + out["gibbs_w"]
        + out["gibbs_tausq"] + out["gibbs_beta"])
    return out


def trace_profile(fn, args, logdir: str):
    """Record one call ``fn(*args)`` under ``torch.profiler`` (CPU, and the
    card's kernels when CUDA is available) and write its Chrome trace to
    ``logdir/trace.json`` (open it in Perfetto or chrome://tracing).
    Returns (the call's result, the profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return out, prof
