"""cov_kernel_share: the share of the covariance-block calls of the
profiled chain call that kernel K6 ran, in %: the program's counters
``ops.cov.launches`` over ``ops.cov.launches`` + ``ops.cov.plain_calls``
(a replayed graph adds what its capture counted), read from the newest
``run_mcmc`` or ``run_mcmc_chains`` record in
``spamtree_tpu_torch.utils.trace.history()``.  A program without the
counters reports nothing.  Moves chain_iters_per_s."""

SOURCE = "program_counter"
LAYER = "model.core"
MOVES = "chain_iters_per_s"


def read(ctx):
    if not ctx.get("profile"):
        return None
    try:
        from spamtree_tpu_torch.utils import trace
    except ImportError:
        return None
    recs = [r for r in trace.history()
            if r.name in ("run_mcmc", "run_mcmc_chains")]
    if not recs:
        return None
    k6 = recs[-1].counter("ops.cov.launches", None)
    plain = recs[-1].counter("ops.cov.plain_calls", None)
    if k6 is None or plain is None or k6 + plain == 0:
        return None
    return 100.0 * k6 / (k6 + plain)
