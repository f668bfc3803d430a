"""install_ms_per_it: device milliseconds per chain iteration in the
install on accept (part I of the single chain's graphed iteration: the
factor swap, the Gram blocks and the prediction operators), over the
profiled call: the program's device span ``mcmc.part.I`` (CUDA events
around each replay of part I) over the call's counter
``mcmc.iterations``, read from the newest active ``run_mcmc`` record in
``spamtree_tpu_torch.utils.trace.history()`` (the call run under the
profiler).  Moves chain_iters_per_s."""

SOURCE = "program_span"
LAYER = "model.mcmc"
MOVES = "chain_iters_per_s"


def read(ctx):
    if not ctx.get("profile"):
        return None
    try:
        from spamtree_tpu_torch.utils import trace
    except ImportError:
        return None
    recs = [r for r in trace.history() if r.name == "run_mcmc" and r.active]
    if not recs or not recs[-1].device:
        return None
    rec = recs[-1]
    its = rec.counter("mcmc.iterations")
    return rec.device_ms("mcmc.part.I") / its if its else None
