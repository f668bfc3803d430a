"""The port against the dense oracle at n=2500 (tests/test_reference_oracle.py
::test_posterior_parity_aligned_scale_fixed_theta), where the
parent-aligned thin and prediction layouts activate (P >= 128 at cell_size
49); theta fixed, float64 on the CPU.  In a file of its own so that the
test workers give it a worker of its own; the chain runs on one torch
thread (the autouse ``_one_thread``)."""

import numpy as np
import torch

import spamtree_tpu_torch
from spamtree_tpu_torch.model.core import ModelStatic
from spamtree_tpu_torch.model.params import make_theta_spec
from spamtree_tpu_torch.tree.partition import make_tree
from spamtree_tpu_torch.tree.schedule import build_schedule

from _oracle_numpy import DenseOracle
from test_torch_oracle import _gp_data, _one_thread, check_parity  # noqa: F401


def test_posterior_parity_aligned_scale_fixed_theta():
    n = 2500
    coords, X, y, y_full, miss = _gp_data(33, n, 200)
    seed, keep, burn = 17, 700, 300
    th_fix = np.array([1.4, 1.0, 1.0, 5.2])
    bounds = np.zeros((4, 2))
    bounds[:, 0], bounds[:, 1] = 1e-3, 30.0
    tree = make_tree(coords, np.isfinite(y), np.zeros(n, dtype=np.int64),
                     axis_cell_size=int(round(49 ** 0.5)), K=2,
                     rng=np.random.default_rng(seed))
    # the point of this test: the aligned layouts must actually be active
    ms_probe = ModelStatic(build_schedule(tree), coords,
                           np.zeros(n, np.int64), y, X,
                           make_theta_spec(2, 1).spec, dtype=torch.float64,
                           device="cpu")
    assert any(ms_probe.level_aligned), "thin-level alignment did not activate"
    assert any(ms_probe.pred_aligned), "pred alignment did not activate"

    oracle = DenseOracle(tree, coords, y, X, bounds, th_fix, start_tausq=0.1,
                         beta_Vi=0.01, tausq_ab=(2.01, 1.0), mcmcsd=0.05,
                         seed=seed)
    oc = oracle.run(keep=keep, burn=burn, sample_theta=False)

    out = spamtree_tpu_torch.spamtree(
        y, X, coords, cell_size=49, mcmc=dict(keep=keep, burn=burn, thin=1),
        prior=dict(toplim=30.0, tausq=(2.01, 1.0), beta=0.01),
        starting=dict(theta=th_fix, tausq=0.1),
        debug=dict(sample_theta=False), dtype=torch.float64, seed=seed,
        device="cpu")
    check_parity(out, oc, miss, y_full, q=1, sd_frac=0.7)
