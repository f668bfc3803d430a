"""``attach_rows`` extends a fit's tree with new missing rows into exactly
the tree, and the padded schedule, that ``make_tree`` and
``build_schedule`` build over the augmented rows (integer arrays: compared
for equality), the way ``spamtree_predict`` augments and sorts them; and
it declines the inputs it cannot extend."""

import dataclasses

import numpy as np
import pytest

from spamtree_tpu_torch.tree.partition import attach_rows, make_tree
from spamtree_tpu_torch.tree.schedule import build_schedule

TREE_FIELDS = ("block_of_row", "res_of_row", "block_rows", "parents",
               "block_level", "res_is_ref", "n_levels", "block_ct_obs",
               "n_blocks", "n_obs_blocks", "branch_res")


def _sorted(coords):
    dd = coords.shape[1]
    return np.lexsort(tuple([np.arange(len(coords))]
                            + [coords[:, j] for j in range(dd - 1, -1, -1)]))


def _case(q=1, held=0.0, n_sites=1500, m=300, new_margins=None, seed=3):
    """A fit's rows (q margins at n_sites sites: co-located for q = 2,
    misaligned and imbalanced for q = 3; a share ``held`` missing) and m
    new missing rows, in the caller's order."""
    rng = np.random.default_rng(seed)
    if q == 2:
        coords = np.repeat(rng.uniform(size=(n_sites, 2)), 2, axis=0)
        mv = np.tile(np.arange(2), n_sites)
    else:
        coords = rng.uniform(size=(n_sites, 2))
        mv = (rng.choice(3, size=n_sites, p=[0.55, 0.3, 0.15]) if q == 3
              else np.zeros(n_sites, dtype=np.int64))
    obs = rng.uniform(size=len(coords)) >= held
    coords_new = rng.uniform(size=(m, 2))
    mv_new = (rng.integers(q, size=m) if new_margins is None
              else rng.choice(new_margins, size=m))
    return coords, obs, mv, coords_new, mv_new


def _fit_and_augmented(case, kw):
    coords, obs, mv, coords_new, mv_new = case
    n = len(coords)
    fit_order = _sorted(coords)
    fit_tree = make_tree(coords[fit_order], obs[fit_order], mv[fit_order],
                         rng=np.random.default_rng(11), **kw)
    c_aug = np.vstack([coords, coords_new])
    obs_aug = np.concatenate([obs, np.zeros(len(coords_new), dtype=bool)])
    mv_aug = np.concatenate([mv, mv_new])
    order = _sorted(c_aug)
    inv = np.empty(len(order), dtype=np.int64)
    inv[order] = np.arange(len(order))
    row_map = inv[fit_order]
    assert np.array_equal(order[order < n], fit_order)
    return fit_tree, row_map, c_aug[order], obs_aug[order], mv_aug[order]


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


CASES = {
    "full_q1_held0": (dict(q=1), {}),
    "full_q1_held01": (dict(q=1, held=0.1), {}),
    "limited_q1_held01": (dict(q=1, held=0.1), dict(limited_tree=True)),
    "full_q2_held0": (dict(q=2), {}),
    "full_q2_held01": (dict(q=2, held=0.1), {}),
    "limited_q2_held0": (dict(q=2), dict(limited_tree=True)),
    "limited_q2_held01": (dict(q=2, held=0.1), dict(limited_tree=True)),
    "full_q3_held01": (dict(q=3, held=0.1), {}),
    "limited_q3_held01": (dict(q=3, held=0.1), dict(limited_tree=True)),
    "leftover_full": (dict(q=2, held=0.1), dict(tree_depth=3)),
    "leftover_limited": (dict(q=3, held=0.1),
                         dict(tree_depth=3, limited_tree=True)),
    "shallow_all_ref": (dict(q=2, held=0.1),
                        dict(tree_depth=2, last_not_reference=False)),
    "no_same_margin": (dict(q=2, held=0.1),
                       dict(cherrypick_same_margin=False,
                            cherrypick_group_locations=False)),
    "start_level1": (dict(q=3, held=0.1), dict(start_level=1, tree_depth=4)),
    "mvbias1": (dict(q=3, held=0.1), dict(mvbias=1.0)),
    "new_one_margin": (dict(q=2, held=0.1, new_margins=[1]), {}),
    "K3_cell4": (dict(q=1, held=0.1, n_sites=4000, m=800),
                 dict(axis_cell_size=4, K=3)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_attached_tree_and_schedule_match_make_tree(name):
    data_kw, tree_kw = CASES[name]
    kw = dict(axis_cell_size=3, K=2) | tree_kw
    limited = kw.get("limited_tree", False)
    fit_tree, row_map, cs, obs, mvs = _fit_and_augmented(_case(**data_kw),
                                                         kw)
    want = make_tree(cs, obs, mvs, rng=np.random.default_rng(11), **kw)
    got = attach_rows(fit_tree, row_map, cs, obs, mvs, limited_tree=limited,
                      cherrypick_same_margin=kw.get("cherrypick_same_margin",
                                                    True))
    assert got is not None
    assert got.n_levels >= 3
    if name.startswith("leftover"):  # a leftover level between
        assert want.n_levels == fit_tree.n_levels + (data_kw["held"] == 0)
        assert (want.block_level[:want.n_obs_blocks]
                > want.branch_res).any()
    for f in TREE_FIELDS:
        _assert_same(getattr(want, f), getattr(got, f), f"tree.{f}")
    _assert_same(build_schedule(want, limited_tree=limited),
                 build_schedule(got, limited_tree=limited), "schedule")


def _declined(fit_tree, row_map, cs, obs, mvs, how):
    if how == "no_facts":
        fit_tree = dataclasses.replace(fit_tree, n_obs_blocks=None,
                                       branch_res=None)
    elif how == "not_increasing":
        row_map = row_map.copy()
        row_map[[3, 4]] = row_map[[4, 3]]
    elif how == "other_observed":
        obs = obs.copy()
        obs[row_map[np.flatnonzero(fit_tree.block_of_row
                                   < fit_tree.n_obs_blocks)[7]]] = False
    elif how == "one_level":
        # fewer observed rows than one level's cells: a single level
        cs, obs, mvs = cs[:40], np.arange(40) < 8, mvs[:40]
        fit_tree = make_tree(cs[:20], obs[:20], mvs[:20], axis_cell_size=3,
                             K=2, rng=np.random.default_rng(11))
        assert fit_tree.n_levels == 2 and fit_tree.n_obs_blocks
        row_map = np.arange(20)
    return attach_rows(fit_tree, row_map, cs, obs, mvs)


@pytest.mark.parametrize("how", ["no_facts", "not_increasing",
                                 "other_observed", "one_level"])
def test_attach_declines_what_it_cannot_extend(how):
    kw = dict(axis_cell_size=3, K=2)
    args = _fit_and_augmented(_case(q=1, held=0.1, n_sites=600, m=100), kw)
    assert attach_rows(*args) is not None
    assert _declined(*args, how) is None
