"""device_idle_share.predict: the share of the untraced window's wall time
in which the card idles: 1 - (device-busy seconds of one profiled
``spamtree_predict`` call, busy being the union of the device events'
intervals) / (the window's seconds per call).  Moves
predict_draws_per_s."""

SOURCE = "device_trace"
LAYER = "device"
MOVES = "predict_draws_per_s"


def read(ctx):
    p = ctx.get("profile")
    if not p or "draws" not in p or not ctx.get("calls"):
        return None
    return 1.0 - p["busy_s"] / (ctx["window_s"] / ctx["calls"])
