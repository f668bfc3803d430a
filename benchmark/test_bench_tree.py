"""The frozen tree and schedule under benchmark/reference hold equal to the
program's, so that drift in either shows."""

import numpy as np
import pytest

from benchmark import data, run
from benchmark.reference import partition, schedule
from spamtree_tpu_torch.tree import partition as p_partition
from spamtree_tpu_torch.tree import schedule as p_schedule


@pytest.mark.parametrize("limited", [False, True])
@pytest.mark.parametrize("imbalance", [None, (0.8, 0.2)])
def test_frozen_tree_equals_program(limited, imbalance):
    d = data.make(dict(data=dict(maker="multivariate", n_per_q=700, q=2,
                                 imbalance=imbalance, miss=0.1,
                                 layout_seed=3)), 3, "cpu")
    order, cs, mvs, ys = run._sorted(d)
    trees = [m.make_tree(cs, np.isfinite(ys), mvs, axis_cell_size=5, K=2,
                         limited_tree=limited, rng=np.random.default_rng(11))
             for m in (partition, p_partition)]
    scheds = [schedule.build_schedule(trees[0], limited_tree=limited),
              p_schedule.build_schedule(trees[1], limited_tree=limited)]
    assert run.tree_diff(trees[0], scheds[0], trees[1], scheds[1]) == 0
    assert trees[0].n_blocks == trees[1].n_blocks > 10
