"""replays_per_it: CUDA-graph replays per chain iteration of the window
(``res["graph_replays"]``, the program's counter), a count.  Moves
chain_iters_per_s."""

SOURCE = "program_counter"
LAYER = "model.mcmc"
MOVES = "chain_iters_per_s"


def read(ctx):
    if not ctx.get("replays") or not ctx.get("iters"):
        return None
    return ctx["replays"] / ctx["iters"]
