"""k1_block_share: the share of the blocks factorised in the profiled chain
call that kernel K1 factorised, in %: the program's counters
``ops.chol.k1_blocks`` over ``ops.chol.k1_blocks`` + ``ops.chol.
plain_blocks`` (a replayed graph adds what its capture factorised), read
from the newest ``run_mcmc`` or ``run_mcmc_chains`` record in
``spamtree_tpu_torch.utils.trace.history()``.  A program without the
counters reports nothing.  Moves chain_iters_per_s."""

SOURCE = "program_counter"
LAYER = "ops.chol (K1)"
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
    k1 = recs[-1].counter("ops.chol.k1_blocks", None)
    plain = recs[-1].counter("ops.chol.plain_blocks", None)
    if k1 is None or plain is None or k1 + plain == 0:
        return None
    return 100.0 * k1 / (k1 + plain)
