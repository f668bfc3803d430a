"""predict_draws_per_s: posterior-predictive draws at new locations over the
wall time of the window's whole ``spamtree_predict`` calls (host clock):
staging, tree, draws and the host's yhat.  The predict cell."""

SOURCE = "host_clock"
LAYER = None  # end to end


def read(ctx):
    if "calls" not in ctx or not ctx.get("window_s"):
        return None
    return ctx["draws"] / ctx["window_s"]
