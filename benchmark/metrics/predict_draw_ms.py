"""predict_draw_ms: milliseconds per draw in ``spamtree_predict``'s draws
(``predict_breakdown``'s draws_s, the program's span, over the draws), over
the window's calls.  Moves predict_draws_per_s."""

SOURCE = "program_span"
LAYER = "model.predict"
MOVES = "predict_draws_per_s"


def read(ctx):
    b = ctx.get("predict_breakdowns")
    if not b or not ctx.get("draws"):
        return None
    return 1e3 * sum(x["draws_s"] for x in b) / ctx["draws"]
