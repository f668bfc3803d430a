"""predict_upload_ms_per_draw: milliseconds per prediction draw that
``spamtree_predict`` spends moving the fit's kept draws to the card, chunk
by chunk (indexing them on the host, the copy from pageable memory, the
layout on the augmented rows): ``predict_breakdown``'s upload_s (the
program's span ``predict.upload``) over the draws, over the window's
calls.  Moves predict_draws_per_s."""

SOURCE = "program_span"
LAYER = "model.predict"
MOVES = "predict_draws_per_s"


def read(ctx):
    b = ctx.get("predict_breakdowns")
    if not b or not ctx.get("draws") or any("upload_s" not in x for x in b):
        return None
    return 1e3 * sum(x["upload_s"] for x in b) / ctx["draws"]
