"""predict_stage_s: seconds per ``spamtree_predict`` call in its staging,
the tree over the augmented rows and the model (``predict_breakdown``'s
tree_s + stage_s, the program's span), the mean over the window's calls.
Moves predict_draws_per_s."""

SOURCE = "program_span"
LAYER = "api.stage_predict + tree"
MOVES = "predict_draws_per_s"


def read(ctx):
    b = ctx.get("predict_breakdowns")
    if not b:
        return None
    return sum(x["tree_s"] + x["stage_s"] for x in b) / len(b)
