"""device_idle_share.fit: the share of the untraced window's wall time in
which the card idles, in a fit cell: 1 - (device-busy seconds per iteration
over the profiled stretch, busy being the union of the device events'
intervals) / (the window's seconds per iteration), the arithmetic of
``spamtree_tpu_torch/utils/profile_step.py`` at commit 1ed94f536e0e.  The
traced stretch's own wall is not the denominator: the profiler's host work
at each accept read and buffer request stretches it.  Moves
chain_iters_per_s."""

SOURCE = "device_trace"
LAYER = "device"
MOVES = "chain_iters_per_s"


def read(ctx):
    p = ctx.get("profile")
    if not p or not p.get("iters") or not ctx.get("iters"):
        return None
    return 1.0 - (p["busy_s"] / p["iters"]) / (ctx["window_s"] / ctx["iters"])
