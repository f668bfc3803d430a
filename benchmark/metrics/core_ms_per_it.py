"""core_ms_per_it: device milliseconds per iteration of the profiled stretch
in every device operation but the hand-written kernels K1, K3 and K4: the
torch ops of ``model.core`` and the drain's copies.  Moves
chain_iters_per_s."""

SOURCE = "device_trace"
LAYER = "model.core"
MOVES = "chain_iters_per_s"


def read(ctx):
    p = ctx.get("profile")
    if not p or not p.get("iters"):
        return None
    total = sum(r[1] for r in p["kernels"])
    own = sum(p["kernel_s"].values())
    return 1e3 * (total - own) / p["iters"]
