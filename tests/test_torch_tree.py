"""The PyTorch port's NumPy copies of the partitioner and the schedule
produce exactly the JAX package's tree and padded layout (integer arrays:
compared for equality)."""

import dataclasses

import numpy as np
import pytest

from spamtree_tpu.tree.partition import make_tree as make_tree_jax
from spamtree_tpu.tree.schedule import build_schedule as build_schedule_jax
from spamtree_tpu_torch.tree.partition import make_tree
from spamtree_tpu_torch.tree.schedule import build_schedule


def _inputs(case, n=400, seed=5):
    rng = np.random.default_rng(seed)
    if case == "q2":
        base = rng.uniform(size=(n // 2, 2))
        coords = np.repeat(base, 2, axis=0)
        mv = np.tile(np.arange(2), n // 2)
    elif case == "q3_imbalanced":  # bench config 4's margins, misaligned
        coords = rng.uniform(size=(n, 2))
        mv = rng.choice(3, size=n, p=[0.55, 0.3, 0.15])
    else:
        coords = rng.uniform(size=(n, 2))
        mv = np.zeros(n, dtype=np.int64)
    na = (rng.uniform(size=len(coords)) > 0.15
          if case in ("missing", "q3_imbalanced")
          else np.ones(len(coords), dtype=bool))
    order = np.lexsort((np.arange(len(coords)), coords[:, 1], coords[:, 0]))
    return coords[order], na[order], mv[order]


def _assert_same(a, b, where):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif a is None:
        assert b is None, where
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)


@pytest.mark.parametrize("case", ["univariate", "q2", "missing"])
def test_tree_and_schedule_match_jax_package(case):
    coords, na, mv = _inputs(case)
    kw = dict(axis_cell_size=3, K=2)
    tree_j = make_tree_jax(coords, na, mv, rng=np.random.default_rng(1), **kw)
    tree_t = make_tree(coords, na, mv, rng=np.random.default_rng(1), **kw)
    _assert_same(tree_j, tree_t, "tree")
    sched_j, sched_t = build_schedule_jax(tree_j), build_schedule(tree_t)
    _assert_same(sched_j, sched_t, "schedule")
    assert len(sched_t.levels) >= 3
    assert (sched_t.pred is not None) == (case == "missing")


@pytest.mark.parametrize("kw", [
    dict(K=3),
    dict(start_level=1, tree_depth=3),
    dict(tree_depth=2, last_not_reference=False),
    dict(limited_tree=True),
    dict(cherrypick_same_margin=False, cherrypick_group_locations=False),
    dict(mvbias=1.0),
    dict(limited_tree=True, tree_depth=3),
], ids=["K3", "start_level", "shallow_all_ref", "limited", "no_cherrypick",
        "mvbias", "limited_shallow"])
def test_tree_knobs_match_jax_package(kw):
    """The tree-shape knobs of tests/test_e2e.py::test_tree_knob_configs
    and bench config 4's mvbias=1.0, on three imbalanced, misaligned
    margins with missing rows: the same tree and padded schedule."""
    coords, na, mv = _inputs("q3_imbalanced", n=600)
    kw = dict(axis_cell_size=3, K=2) | kw
    limited = kw.get("limited_tree", False)
    tree_j = make_tree_jax(coords, na, mv, rng=np.random.default_rng(2), **kw)
    tree_t = make_tree(coords, na, mv, rng=np.random.default_rng(2), **kw)
    _assert_same(tree_j, tree_t, "tree")
    _assert_same(build_schedule_jax(tree_j, limited_tree=limited),
                 build_schedule(tree_t, limited_tree=limited), "schedule")


def test_mvbias_changes_the_knots():
    """mvbias=1.0 weighs the knot picks towards the rarer margins: the
    reference levels' rows differ from mvbias=0's and hold more of the
    rarest margin."""
    coords, na, mv = _inputs("q3_imbalanced", n=600)
    trees = {b: make_tree(coords, na, mv, axis_cell_size=3, K=2, mvbias=b,
                          rng=np.random.default_rng(2)) for b in (0.0, 1.0)}

    def rare_on_ref(tree):
        ref = [r for r, lv in zip(tree.block_rows, tree.block_level)
               if tree.res_is_ref[lv - 1]]
        rows = np.concatenate(ref)
        return np.mean(mv[rows] == 2)

    assert not np.array_equal(trees[0.0].block_of_row, trees[1.0].block_of_row)
    assert rare_on_ref(trees[1.0]) > rare_on_ref(trees[0.0])
