"""The benchmark's own count of an iteration's operations against the
program's dispatch-level count of the same iteration (``utils/cost.py``)."""

import numpy as np

from benchmark import data
from benchmark.reference import cost
from spamtree_tpu_torch import api
from spamtree_tpu_torch.model import mcmc


def test_iteration_flops_against_the_programs_count():
    """At config 1's size (n = 625, thin 2) the formula reads 0.2-0.6 of the
    program's count (0.37 when written): it counts a triangular factor's
    product at half a dense one's, no block padding (the program pads each
    level to its widest block and parent set) and no elementwise op; the
    program's count is A + 0.234 I + (T0 + T1) / 2 an iteration."""
    d = data.make(dict(data=dict(maker="univariate", n=625, miss=0.1,
                                 layout_seed=7)), 7, "cpu")
    y, X = d["y"], d["X"]
    fit = api.prepare_fit(y - np.nanmean(y), X, d["coords"],
                          mcmc=dict(keep=10, burn=10, thin=2), device="cpu")
    work = mcmc.part_work(fit.ms, fit.bounds, fit.cfg, fit.state)
    f = {k: c.work.flops for k, c in work.items()}
    program = (f["A"] + cost.RAM_TARGET_ACCEPT * f["I"]
               + 0.5 * (f["T0"] + f["T1"]))
    ours = cost.iteration_flops(fit.tree, len(y), X.shape[1], 1, 2, False)
    assert 0.2 <= ours / program <= 0.6


def test_kernel_costs_are_the_programs():
    from spamtree_tpu_torch.ops import chol, level
    import torch

    for B, S, P in ((16384, 25, 0), (1024, 68, 293)):
        assert cost.inv_chol_cost(B, S, False, 4) == chol.inv_chol_cost(
            B, S, False, torch.float32)
        if P:
            assert cost.thin_gibbs_cost(B, S, P, 4) == \
                level.thin_gibbs_cost(B, S, P, torch.float32)
            assert cost.thin_decision_cost(B, S, P, 4) == \
                level.thin_decision_cost(B, S, P, torch.float32)
