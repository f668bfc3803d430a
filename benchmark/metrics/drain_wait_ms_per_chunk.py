"""drain_wait_ms_per_chunk: milliseconds that the sampling thread of the
window's chain call waits on the drain, per keep chunk: the call's span
``mcmc.drain_wait`` (blocked on a free pinned host slot or on the drain's
queue) over its counter ``mcmc.chunks``, read from the program's trace
record of that call (``spamtree_tpu_torch.utils.trace.history()``: the
inactive ``run_mcmc`` record with the most ``mcmc.iterations``, the
untraced window, not the profiled call).  Moves
chain_iters_per_s.host_bound."""

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
    return 1e3 * rec.seconds("mcmc.drain_wait") / rec.counter("mcmc.chunks")
