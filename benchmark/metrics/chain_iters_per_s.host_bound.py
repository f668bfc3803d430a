"""chain_iters_per_s.host_bound: chain_iters_per_s in the fit cells whose
pace the host's drain of kept draws sets, where the host's drift between
runs spreads the rate several times wider than in the device-bound cells:
MCMC iterations completed, times chains, over the window's whole wall time
(host clock), drains included."""

SOURCE = "host_clock"
LAYER = None  # end to end


def read(ctx):
    if "chain_iters" not in ctx or not ctx.get("window_s"):
        return None
    return ctx["chain_iters"] / ctx["window_s"]
