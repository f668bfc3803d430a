"""prepare_fit_s: the harness's clock around ``api.prepare_fit`` (tree,
schedule, staging, tuner, initial state).  Moves setup_s."""

SOURCE = "host_clock"
LAYER = "api + tree (set-up)"
MOVES = "setup_s"


def read(ctx):
    return ctx.get("prepare_fit_s")
