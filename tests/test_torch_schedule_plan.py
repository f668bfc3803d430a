"""``build_schedule`` plans its levels with array operations; the schedule
is the one the per-block planner built, entry by entry.

The per-block planner is kept here, frozen, as the oracle: ``_pad2``,
``_merge_by_ancestor``, ``_group_ref_plan`` and the level loop of
``build_schedule`` as they were written with a Python loop per block or per
group.  Every ``LevelPlan`` field, array shape and dtype, ``Smax``, ``pred``
and ``pred_buckets`` are compared over trees from ``make_tree`` (limited
and full, q = 1, 2, 3, with and without held-out rows, ``mvbias`` 0 and 1,
one tree past the 20000 blocks above which ``validate`` is off) under the
planner's flags, and over trees that ``attach_rows`` extends by new sites,
as ``spamtree_predict`` does, some of them in the fit's own held-out cells.
"""

import dataclasses
import os

import numpy as np
import pytest

from spamtree_tpu_torch.tree.partition import attach_rows, make_tree
from spamtree_tpu_torch.tree.schedule import (
    LevelPlan, Schedule, _align_to_parent, _bucket_plan, _pad_S,
    build_schedule)

# -- the per-block planner, frozen ----------------------------------------


def _pad2(arrs, width, fill):
    out = np.full((len(arrs), width), fill, dtype=np.int64)
    for i, a in enumerate(arrs):
        out[i, : len(a)] = a
    return out


def _merge_by_ancestor(plan, n, nb):
    if plan.P == 0 or plan.B <= 1 or plan.is_ref:
        return plan
    order = np.argsort(plan.lp_pos, kind="stable")
    lp_sorted = plan.lp_pos[order]
    starts = np.flatnonzero(np.r_[True, lp_sorted[1:] != lp_sorted[:-1]])
    groups = np.split(order, starts[1:])
    if len(groups) == plan.B:
        return plan
    sizes = (plan.rows < n).sum(axis=1)
    row_lists = [
        np.concatenate([plan.rows[i, : sizes[i]] for i in g]) for g in groups
    ]
    S = max(len(r) for r in row_lists)
    bid = plan.block_ids.reshape(plan.B, -1)
    ids_src = [np.concatenate([bid[i][bid[i] < nb] for i in g]) for g in groups]
    M = max(len(s) for s in ids_src)
    ids = np.full((len(groups), M), nb, dtype=np.int64)
    for k, s in enumerate(ids_src):
        ids[k, : len(s)] = s
    first = np.array([g[0] for g in groups])
    return LevelPlan(
        res=plan.res, is_ref=plan.is_ref,
        block_ids=ids,
        rows=_pad2(row_lists, S, n),
        prows=plan.prows[first],
        lp_pos=plan.lp_pos[first], lp_level=plan.lp_level,
        anc_blocks=plan.anc_blocks[first],
        seg_off=list(plan.seg_off), seg_size=list(plan.seg_size),
    )


def _group_ref_plan(plan, n, nb, max_waste=1.15):
    if plan.P == 0 or plan.B <= 1 or not plan.is_ref:
        return plan
    order = np.argsort(plan.lp_pos, kind="stable")
    lp_sorted = plan.lp_pos[order]
    starts = np.flatnonzero(np.r_[True, lp_sorted[1:] != lp_sorted[:-1]])
    groups = np.split(order, starts[1:])
    C = max(len(g) for g in groups)
    if C <= 1 or len(groups) * C > max_waste * plan.B:
        return plan
    perm = np.full(len(groups) * C, -1, dtype=np.int64)
    for k, g in enumerate(groups):
        perm[k * C : k * C + len(g)] = g
    real = perm >= 0
    src = np.maximum(perm, 0)
    leader = np.repeat([g[0] for g in groups], C)
    take = np.where(real, src, leader)

    def _take(a, dummy_fill=None):
        out = a[take].copy()
        if dummy_fill is not None:
            out[~real] = dummy_fill
        return out

    return LevelPlan(
        res=plan.res, is_ref=True,
        block_ids=_take(plan.block_ids, nb),
        rows=_take(plan.rows, n),
        prows=_take(plan.prows),
        lp_pos=_take(plan.lp_pos),
        lp_level=plan.lp_level,
        anc_blocks=_take(plan.anc_blocks, nb),
        seg_off=list(plan.seg_off), seg_size=list(plan.seg_size),
        group_c=C,
    )


def _build_schedule_per_block(
    tree, limited_tree=False, validate=None, bucket_thin=True,
    merge_thin=True, group_ref=True, align_thin=True, align_min_p=128,
    joint_align=None, thin_s_align=None,
):
    if joint_align is None:
        joint_align = int(os.environ.get("SPAMTREE_JOINT_ALIGN", "0") or 0)
    if thin_s_align is None:
        thin_s_align = int(os.environ.get("SPAMTREE_THIN_S_ALIGN", "0") or 0)
    n = tree.n_rows
    nb = tree.n_blocks
    if validate is None:
        validate = nb <= 20000
    levels_1b = sorted(set(int(v) for v in tree.block_level))
    sweep_levels = []
    pred_plan = None
    last_ref_res = None
    if joint_align > 1 and not limited_tree:
        for li, res in enumerate(levels_1b):
            ids0 = np.flatnonzero(tree.block_level == res)
            if (tree.block_ct_obs[ids0] > 0).any() and tree.res_is_ref[li] == 1:
                last_ref_res = res
    joint_rows = {}
    joint_segs = {}
    block_pos = {}
    block_sweep_level = {}
    t_sweep = 0
    for li, res in enumerate(levels_1b):
        ids = np.flatnonzero(tree.block_level == res)
        obs = tree.block_ct_obs[ids] > 0
        is_pred_level = not obs.any()
        if not is_pred_level:
            assert obs.all()
        is_ref = bool(tree.res_is_ref[li] == 1) and not is_pred_level
        row_lists = [tree.block_rows[u] for u in ids]
        S = max(len(r) for r in row_lists)
        rows = _pad2(row_lists, S, n)
        par_lists = [tree.parents[u] for u in ids]
        has_par = [len(p) > 0 for p in par_lists]
        if not any(has_par):
            prows = np.zeros((len(ids), 0), dtype=np.int64)
            lp_pos = np.full(len(ids), -1, dtype=np.int64)
            lp_level = -1
            anc_blocks = np.zeros((len(ids), 0), dtype=np.int64)
            seg_off, seg_size = [], []
        else:
            assert all(has_par)
            assert len({len(p) for p in par_lists}) == 1
            lps = np.array([p[-1] for p in par_lists])
            lp_levels = {block_sweep_level[int(b)] for b in lps}
            assert len(lp_levels) == 1
            lp_level = lp_levels.pop()
            lp_pos = np.array([block_pos[int(b)] for b in lps])
            if limited_tree:
                src_rows = sweep_levels[lp_level].rows
                seg_off = [0]
                seg_size = [src_rows.shape[1]]
            else:
                src_rows = joint_rows[lp_level]
                seg_off, seg_size = joint_segs[lp_level]
            prows = src_rows[lp_pos]
            anc_blocks = np.stack(par_lists, axis=0)
            assert anc_blocks.shape[1] == len(seg_off)
            if validate:
                for i, u in enumerate(ids):
                    for a, (o, s) in enumerate(zip(seg_off, seg_size)):
                        seg = prows[i, o : o + s]
                        rows_a = tree.block_rows[par_lists[i][a]]
                        assert np.array_equal(
                            seg[: len(rows_a)], rows_a
                        ) and np.all(seg[len(rows_a) :] == n)
        plan = LevelPlan(
            res=res, is_ref=is_ref, block_ids=ids, rows=rows, prows=prows,
            lp_pos=lp_pos, lp_level=lp_level, anc_blocks=anc_blocks,
            seg_off=list(seg_off), seg_size=list(seg_size),
        )
        if is_pred_level:
            assert pred_plan is None
            pred_plan = plan
            continue
        if is_ref:
            if group_ref:
                plan = _group_ref_plan(plan, n, nb)
            for i, u in enumerate(plan.block_ids):
                if u >= nb:
                    continue
                block_pos[int(u)] = i
                block_sweep_level[int(u)] = t_sweep
            joint = np.concatenate([plan.prows, plan.rows], axis=1)
            if last_ref_res is not None and res == last_ref_res:
                W = joint.shape[1]
                Wp = -(-W // joint_align) * joint_align
                if Wp > W:
                    joint = np.concatenate([
                        joint,
                        np.full((joint.shape[0], Wp - W), n, dtype=np.int64),
                    ], axis=1)
            joint_rows[t_sweep] = joint
            joint_segs[t_sweep] = (
                list(seg_off) + [plan.prows.shape[1]],
                list(seg_size) + [S],
            )
            sweep_levels.append(plan)
            t_sweep += 1
        else:
            if merge_thin:
                plan = _merge_by_ancestor(plan, n, nb)
            aplan = None
            if (align_thin and merge_thin and plan.P >= align_min_p
                    and plan.lp_level >= 0):
                aplan = _align_to_parent(
                    plan, n, nb, sweep_levels[plan.lp_level].B, src_rows
                )
            if aplan is not None:
                buckets = [aplan]
            else:
                buckets = _bucket_plan(plan, n) if bucket_thin else [plan]
            if thin_s_align > 1:
                buckets = [_pad_S(b, thin_s_align, n) for b in buckets]
            sweep_levels.extend(buckets)
            t_sweep += len(buckets)
    pred_buckets = []
    if pred_plan is not None:
        if merge_thin:
            pred_plan = _merge_by_ancestor(pred_plan, n, nb)
        aplan = None
        if (align_thin and merge_thin and pred_plan.P >= align_min_p
                and pred_plan.lp_level >= 0):
            lp = pred_plan.lp_level
            src = (sweep_levels[lp].rows if limited_tree else joint_rows[lp])
            aplan = _align_to_parent(
                pred_plan, n, nb, sweep_levels[lp].B, src
            )
        if aplan is not None:
            pred_plan = aplan
            pred_buckets = [aplan]
        else:
            pred_buckets = (
                _bucket_plan(pred_plan, n) if bucket_thin else [pred_plan]
            )
        if thin_s_align > 1:
            pred_buckets = [_pad_S(b, thin_s_align, n) for b in pred_buckets]
            pred_plan = pred_buckets[0] if len(pred_buckets) == 1 else pred_plan
    Smax = max(p.S for p in sweep_levels)
    return Schedule(
        n=n, n_blocks=nb, Smax=Smax, levels=sweep_levels, pred=pred_plan,
        limited_tree=limited_tree, pred_buckets=pred_buckets,
    )


# -- the comparison --------------------------------------------------------


def _assert_identical(want, got, where):
    """Equal entries, shapes and dtypes, field by field."""
    if dataclasses.is_dataclass(want):
        assert type(want) is type(got), where
        for f in dataclasses.fields(want):
            _assert_identical(getattr(want, f.name), getattr(got, f.name),
                              f"{where}.{f.name}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), where
        for i, (x, y) in enumerate(zip(want, got)):
            _assert_identical(x, y, f"{where}[{i}]")
    elif want is None:
        assert got is None, where
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert want.dtype == got.dtype, (where, want.dtype, got.dtype)
        assert want.shape == got.shape, (where, want.shape, got.shape)
        np.testing.assert_array_equal(want, got, err_msg=where)
    else:
        assert want == got and np.asarray(want).dtype.kind == \
            np.asarray(got).dtype.kind, (where, want, got)


def _check(tree, limited, flags):
    kw = dict(limited_tree=limited) | flags
    want = _build_schedule_per_block(tree, **kw)
    got = build_schedule(tree, **kw)
    _assert_identical(want, got, "schedule")
    return got


FLAGS = {
    "defaults": dict(joint_align=0, thin_s_align=0),
    "all_off": dict(group_ref=False, merge_thin=False, bucket_thin=False,
                    align_thin=False, joint_align=0, thin_s_align=0),
    "aligned": dict(align_min_p=0, joint_align=0, thin_s_align=0),
    "aligned_no_group_bucket": dict(align_min_p=0, group_ref=False,
                                    bucket_thin=False, joint_align=0,
                                    thin_s_align=0),
    "merged_bucketed": dict(align_thin=False, joint_align=0, thin_s_align=0),
    "unmerged_bucketed": dict(merge_thin=False, joint_align=0,
                              thin_s_align=0),
    "lane_aligned": dict(align_min_p=0, joint_align=128, thin_s_align=128),
    "lane_aligned_unmerged": dict(merge_thin=False, joint_align=8,
                                  thin_s_align=16),
}


def _data(q, held, n_sites, seed, clustered=False):
    """q margins at n_sites sites (co-located for q = 2, misaligned and
    imbalanced for q = 3; ``clustered``: two margins at sites in three
    tight clusters, which leave some reference parents short of children),
    a share ``held`` missing, sorted as the fit sorts them."""
    rng = np.random.default_rng(seed)
    if clustered:
        centres = rng.uniform(size=(3, 2))
        coords = (centres[rng.integers(3, size=n_sites)]
                  + 0.02 * rng.normal(size=(n_sites, 2)))
        mv = rng.integers(2, size=n_sites)
    elif q == 2:
        coords = np.repeat(rng.uniform(size=(n_sites, 2)), 2, axis=0)
        mv = np.tile(np.arange(2), n_sites)
    else:
        coords = rng.uniform(size=(n_sites, 2))
        mv = (rng.choice(3, size=n_sites, p=[0.55, 0.3, 0.15]) if q == 3
              else np.zeros(n_sites, dtype=np.int64))
    obs = rng.uniform(size=len(coords)) >= held
    order = _sorted(coords)
    return coords[order], obs[order], mv[order]


def _sorted(coords):
    return np.lexsort((np.arange(len(coords)), coords[:, 1], coords[:, 0]))


TREES = {
    f"{'limited' if lim else 'full'}_q{q}_held{int(held * 100):02d}"
    f"_mvbias{int(b)}": (q, held, lim, b)
    for q in (1, 2, 3) for held in (0.0, 0.15) for lim in (False, True)
    for b in ((0.0, 1.0) if q > 1 else (0.0,))
} | {f"clustered_{'limited' if lim else 'full'}": (2, 0.15, lim, 0.0)
     for lim in (False, True)}


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("name", list(TREES))
def test_schedule_matches_the_per_block_planner(name, flags):
    q, held, limited, mvbias = TREES[name]
    clustered = name.startswith("clustered")
    coords, obs, mv = _data(
        q, held, n_sites=1200 if clustered else 700 if q == 2 else 1000,
        seed=1 if clustered else q + 10 * int(held > 0), clustered=clustered)
    tree = make_tree(coords, obs, mv, axis_cell_size=3, K=2,
                     limited_tree=limited, mvbias=mvbias,
                     rng=np.random.default_rng(7))
    sched = _check(tree, limited, FLAGS[flags])
    assert tree.n_blocks <= 20000  # the layout asserts ran
    assert (sched.pred is not None) == (held > 0)
    if limited:
        assert all(p.anc_blocks.shape[1] <= 1 for p in sched.levels)
    if clustered and FLAGS[flags].get("group_ref", True):
        # a grouped reference level padded with dummy blocks, and one
        # whose grouping would waste too much and is left as it was
        refs = [p for p in sched.levels if p.is_ref and p.P > 0]
        assert any(p.group_c > 1 and (p.block_ids >= tree.n_blocks).any()
                   for p in refs)
        assert any(p.group_c == 1 for p in refs)


@pytest.mark.parametrize("flags", ["defaults", "aligned"])
@pytest.mark.parametrize("limited", [False, True], ids=["full", "limited"])
def test_schedule_matches_past_the_validate_size(limited, flags):
    """Past 20000 blocks ``validate`` is off: the plans alone are
    compared, at the leftover and prediction levels' long-tailed sizes."""
    coords, obs, mv = _data(1, 0.1, n_sites=60000, seed=4)
    tree = make_tree(coords, obs, mv, axis_cell_size=2, K=2,
                     limited_tree=limited, rng=np.random.default_rng(7))
    assert tree.n_blocks > 20000
    sched = _check(tree, limited, FLAGS[flags])
    assert sched.pred is not None and len(sched.pred_buckets) >= 1


ATTACHED = {
    "full_q1": (1, False, "anywhere"),
    "limited_q2": (2, True, "anywhere"),
    "full_q3": (3, False, "anywhere"),
    "limited_q2_held_cells": (2, True, "held_cells"),
    "full_q2_held_cells": (2, False, "held_cells"),
    "limited_q3_held_cells": (3, True, "held_cells"),
}


@pytest.mark.parametrize("flags", ["defaults", "aligned", "all_off"])
@pytest.mark.parametrize("name", list(ATTACHED))
def test_schedule_matches_on_attached_trees(name, flags):
    """``spamtree_predict``'s tree: the fit's, extended by new sites
    (``attach_rows``) over the augmented rows sorted as the call sorts
    them.  ``held_cells`` puts half the new sites beside the fit's own
    held-out rows, so they join those rows' prediction blocks."""
    q, limited, where = ATTACHED[name]
    coords, obs, mv = _data(q, 0.1, n_sites=1200, seed=20 + q)
    fit_tree = make_tree(coords, obs, mv, axis_cell_size=3, K=2,
                         limited_tree=limited, rng=np.random.default_rng(11))
    rng = np.random.default_rng(5)
    m = 400
    coords_new = rng.uniform(size=(m, 2))
    if where == "held_cells":
        held = np.flatnonzero(~obs)
        near = rng.choice(held, size=m // 2)
        coords_new[: m // 2] = coords[near] + rng.normal(
            scale=1e-6, size=(m // 2, 2))
    mv_new = rng.integers(q, size=m)
    c_aug = np.vstack([coords, coords_new])
    obs_aug = np.concatenate([obs, np.zeros(m, dtype=bool)])
    mv_aug = np.concatenate([mv, mv_new])
    order = _sorted(c_aug)
    inv = np.empty(len(order), dtype=np.int64)
    inv[order] = np.arange(len(order))
    tree = attach_rows(fit_tree, inv[: len(coords)], c_aug[order],
                       obs_aug[order], mv_aug[order], limited_tree=limited)
    assert tree is not None and tree.n_blocks > fit_tree.n_obs_blocks
    sched = _check(tree, limited, FLAGS[flags])
    # the prediction level holds the fit's held-out rows and the new ones
    pred_rows = np.concatenate([b.rows[b.rows < tree.n_rows]
                                for b in sched.pred_buckets])
    assert len(pred_rows) == int((~obs).sum()) + m
    if where == "held_cells":
        # new sites share prediction blocks with the fit's held-out rows
        new_rows = inv[len(coords) + np.arange(m // 2)]
        old_held = inv[np.flatnonzero(~obs)]
        shared = np.intersect1d(tree.block_of_row[new_rows],
                                tree.block_of_row[old_held])
        assert len(shared) > 0
