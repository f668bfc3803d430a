"""chain_iters_per_s: MCMC iterations completed, times chains, over the
window's whole wall time (host clock): the window is one chain call, burn
and keep, its drains included.  Fit cells."""

SOURCE = "host_clock"
LAYER = None  # end to end


def read(ctx):
    if "chain_iters" not in ctx or not ctx.get("window_s"):
        return None
    return ctx["chain_iters"] / ctx["window_s"]
