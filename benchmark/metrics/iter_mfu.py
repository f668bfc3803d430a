"""iter_mfu: the iteration's operations, counted by the benchmark's own
formula from the tree's block shapes (``reference/cost.py::
iteration_flops``), over the H100's float32 peak (67 TFLOP/s outside the
tensor cores; the program keeps TF32 off) times the window's seconds per
iteration, in %.  Moves chain_iters_per_s."""

SOURCE = "host_clock"
LAYER = "the whole iteration"
MOVES = "chain_iters_per_s"


def read(ctx):
    from benchmark.reference import cost

    if ctx.get("tree") is None or not ctx.get("iters"):
        return None
    conf = ctx["config"]
    d = conf["data"]
    tree = ctx["tree"]
    flops = cost.iteration_flops(
        tree, tree.n_rows, 2 if d["maker"] == "multivariate" else 3,
        d.get("q", 1), ctx["thin"], conf["model"]["limited_tree"],
        chains=ctx["chains"])
    s_per_it = ctx["window_s"] / ctx["iters"]
    return 100.0 * flops / (cost.PEAK_F32_FLOPS * s_per_it)
