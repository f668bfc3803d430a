"""drain_ms_per_chunk: milliseconds of the drain's own work per keep chunk
of the window's chain call (f16 decode, the host's yhat of every kept
draw, storing): the call's span ``mcmc.drain`` less its
``mcmc.drain.copy_wait`` (the wait for the chunk's copy to land) over its
counter ``mcmc.chunks``, read from the program's trace record of that call
(``spamtree_tpu_torch.utils.trace.history()``: the inactive ``run_mcmc``
record with the most ``mcmc.iterations``, the untraced window, not the
profiled call).  Moves chain_iters_per_s.host_bound."""

SOURCE = "program_span"
LAYER = "model.mcmc"
MOVES = "chain_iters_per_s.host_bound"


def window_record(ctx):
    """The window's ``run_mcmc`` record; None outside a fit cell's run or
    where the program keeps no records."""
    if not ctx.get("iters"):
        return None
    try:
        from spamtree_tpu_torch.utils import trace
    except ImportError:
        return None
    recs = [r for r in trace.history()
            if r.name == "run_mcmc" and not r.active]
    return max(recs, key=lambda r: r.counter("mcmc.iterations"),
               default=None)


def read(ctx):
    rec = window_record(ctx)
    if rec is None or not rec.counter("mcmc.chunks"):
        return None
    work = rec.seconds("mcmc.drain") - rec.seconds("mcmc.drain.copy_wait")
    return 1e3 * work / rec.counter("mcmc.chunks")
