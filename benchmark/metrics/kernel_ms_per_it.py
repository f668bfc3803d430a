"""kernel_ms_per_it: device milliseconds per iteration of the profiled
stretch in the hand-written kernels K1 (``inv_chol``), K3 (``thin_gibbs``)
and K4 (``thin_decision``).  Moves chain_iters_per_s."""

SOURCE = "device_trace"
LAYER = "ops"
MOVES = "chain_iters_per_s"


def read(ctx):
    p = ctx.get("profile")
    if not p or not p.get("iters"):
        return None
    s = sum(p["kernel_s"].values())
    return 1e3 * s / p["iters"] if s > 0 else None
