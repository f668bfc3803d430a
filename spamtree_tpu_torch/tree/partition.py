"""Host-side recursive axis-parallel tree partitioner (NumPy).

Builds the treed DAG over blocks of locations, reproducing the structure of
the reference's R/C++ partitioner:

* quantile thresholds        (reference: src/tree_dep.cpp:16-27 ``kthresholds``)
* axis-parallel binning      (reference: src/tree_dep.cpp:42-67, R/axis_parallel.R)
* knot cherry-picking loop   (reference: R/make_tree.R:62-154)
* leftover / missing levels  (reference: R/make_tree.R:213-413, 1-NN via kd-tree)
* DAG edges                  (reference: src/tree_dep.cpp:75-186 ``make_edges[_limited]``)

Because the per-level quantile grids are nested (cut positions i*n/K^(r-1)
are a subset of the level-(r) positions), every block has a complete chain of
ancestors, one per earlier branching level; parents are defined as the finite
*reference* ancestors of that chain (full tree) or only the deepest one
(limited tree), exactly as ``make_edges``/``make_edges_limited`` compute them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy.spatial import cKDTree


def kthresholds(x: np.ndarray, k: int) -> np.ndarray:
    """k-quantile cut points: sorted(x)[i*n//k], i=1..k-1 (tree_dep.cpp:16-27).

    Dispatches to the native C++ kernel (nth_element-based, like the
    reference) when native/libspamtree_host.so is available."""
    from spamtree_tpu_torch.utils import native

    return native.kthresholds(np.asarray(x, dtype=np.float64), k)


def column_threshold(col: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """1 + #{t : col >= t} per entry (tree_dep.cpp:42-55)."""
    from spamtree_tpu_torch.utils import native

    return native.column_threshold(
        np.asarray(col, dtype=np.float64), np.asarray(thresholds, dtype=np.float64)
    )


def axis_bins(coords: np.ndarray, thresholds: list[np.ndarray]) -> np.ndarray:
    """(n, dd) per-axis interval indices (part_axis_parallel_lmt, tree_dep.cpp:58-67)."""
    out = np.empty(coords.shape, dtype=np.int64)
    for j in range(coords.shape[1]):
        out[:, j] = column_threshold(coords[:, j], thresholds[j])
    return out


def combined_cell_id(bins: np.ndarray, strides: np.ndarray) -> np.ndarray:
    """Injective scalar cell key from per-axis interval indices."""
    return bins @ strides


def _group_rows(keys: np.ndarray):
    """(order, starts): stable grouping by ascending key.

    Native C++ stable_sort when available (the R reference does this with
    group_by/split, make_tree.R; at n ~ 1e6 the host grouping passes are a
    real setup cost)."""
    from spamtree_tpu_torch.utils import native

    return native.group_by_key(np.asarray(keys, dtype=np.int64))


@dataclass
class TreeLevels:
    """Partition output: flat per-row assignment plus per-block structure."""

    n_rows: int
    block_of_row: np.ndarray  # (n,) int, 0-based block id (-1 never happens)
    res_of_row: np.ndarray  # (n,) int, 1-based level
    res_is_ref: np.ndarray  # (L,) int 0/1 per level
    n_levels: int
    n_blocks: int
    block_rows: list  # [n_blocks] arrays of row indices
    block_level: np.ndarray  # (n_blocks,) 1-based level of each block
    parents: list  # [n_blocks] int arrays, ref-ancestor block ids (ascending level)
    block_ct_obs: np.ndarray  # (n_blocks,) observed-row counts
    # what ``attach_rows`` extends: blocks 0..n_obs_blocks-1 hold the
    # observed rows (branching levels, then the leftover level), and
    # branch_res is the deepest branching level, whose blocks host the
    # prediction level; None where unknown
    n_obs_blocks: int | None = None
    branch_res: int | None = None


def _host_level(
    rows: np.ndarray,
    res: int,
    host_blocks: np.ndarray,
    host_ref: bool,
    coords: np.ndarray,
    mv_id: np.ndarray,
    block_of_row: np.ndarray,
    res_of_row: np.ndarray,
    block_rows: list,
    block_level: list,
    parents: list,
    limited_tree: bool,
    cherrypick_same_margin: bool,
) -> None:
    """Append a level ``res`` of blocks over ``rows`` (the leftover and the
    prediction levels, make_tree.R:213-413).

    Each row joins its 1-NN among the rows of ``host_blocks`` (the deepest
    branching level; among its own margin's rows under
    ``cherrypick_same_margin``, kd-tree), and the rows of one host form a
    block, blocks in ascending host order, rows in their order in ``rows``.
    A block's parents are its host's followed by the host itself when
    ``host_ref`` (the host's level is a reference level): the host's chain
    of reference ancestors (make_edges); ``limited_tree`` keeps only the
    last (make_edges_limited).  Fills the rows' entries of ``block_of_row``
    and ``res_of_row`` and extends ``block_rows``, ``block_level`` and
    ``parents``, numbering the new blocks from ``len(block_rows)``."""
    target = np.concatenate([block_rows[u] for u in host_blocks])
    host = np.empty(len(rows), dtype=np.int64)
    if cherrypick_same_margin:
        pt_mv = mv_id[rows]
        for vv in np.unique(pt_mv):
            mask_p = pt_mv == vv
            tmask = mv_id[target] == vv
            tr = target[tmask] if tmask.any() else target
            _, nn = cKDTree(coords[tr]).query(coords[rows[mask_p]], k=1)
            host[mask_p] = block_of_row[tr[nn]]
    else:
        _, nn = cKDTree(coords[target]).query(coords[rows], k=1)
        host[:] = block_of_row[target[nn]]

    order, starts = _group_rows(host)
    uniq_hosts = host[order[starts[:-1]]]
    rows_sorted = rows[order]
    base = len(block_rows)
    block_of_row[rows_sorted] = base + np.repeat(np.arange(len(uniq_hosts)), np.diff(starts))
    res_of_row[rows_sorted] = res
    block_rows.extend(np.split(rows_sorted, starts[1:-1]))
    block_level.extend([res] * len(uniq_hosts))
    if not host_ref:
        parents.extend(parents[h] for h in uniq_hosts)
    elif limited_tree:
        parents.extend(uniq_hosts[:, None])
    else:
        chains = [parents[h] for h in uniq_hosts]
        ends = np.cumsum(np.fromiter(map(len, chains), np.int64, len(chains)) + 1)
        flat = np.empty(ends[-1], dtype=np.int64)
        own = np.zeros(flat.size, dtype=bool)
        own[ends - 1] = True
        flat[own] = uniq_hosts
        flat[~own] = np.concatenate(chains)
        parents.extend(np.split(flat, ends[:-1]))


def make_tree(
    coords: np.ndarray,
    na_which: np.ndarray,
    mv_id: np.ndarray,
    axis_cell_size,
    K,
    start_level: int = 0,
    tree_depth: float = np.inf,
    last_not_reference: bool = True,
    limited_tree: bool = False,
    cherrypick_same_margin: bool = True,
    cherrypick_group_locations: bool = True,
    mvbias: float = 0.0,
    rng: np.random.Generator | None = None,
    verbose: bool = False,
) -> TreeLevels:
    """Build the treed partition (reference: R/make_tree.R:1-420).

    ``coords`` (n, dd); ``na_which`` boolean observed mask; ``mv_id`` 0-based
    margin ids.  Returns block assignments + DAG parents.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    n, dd = coords.shape
    axis_cell_size = np.broadcast_to(np.asarray(axis_cell_size, dtype=np.int64), (dd,))
    K = np.broadcast_to(np.asarray(K, dtype=np.int64), (dd,))
    observed = np.asarray(na_which, dtype=bool)
    mv_id = np.asarray(mv_id, dtype=np.int64)
    q = int(mv_id.max()) + 1 if n else 1

    # margin weights for knot cherry-picking (make_tree.R:13-22)
    counts = np.bincount(mv_id[observed], minlength=q).astype(np.float64)
    counts = np.maximum(counts, 1.0)
    w_margin = counts ** (-mvbias)
    w_margin = w_margin / w_margin.sum()

    avail = np.flatnonzero(observed)
    missing = np.flatnonzero(~observed)
    cavail = coords[avail]

    max_res = start_level + tree_depth

    block_of_row = np.full(n, -1, dtype=np.int64)
    res_of_row = np.full(n, -1, dtype=np.int64)

    # per available row, coarse-cell key at each branching level
    lev_cells: list[np.ndarray] = []  # each (n_avail,) int64 keys
    # per level: (sorted unique cell keys, first block id) -- block at key
    # uniq[j] is base + j (vectorized stand-in for a key->block dict)
    cell2block: list[tuple[np.ndarray, int]] = []
    block_rows: list[np.ndarray] = []
    block_level_list: list[int] = []
    res_is_ref_list: list[int] = []

    in_pool = np.ones(len(avail), dtype=bool)  # rows of `avail` still unassigned
    max_block_number = 0
    res = start_level + 1
    n_branch_levels = 0

    # coordinate-duplicate groups for cherrypick_group_locations
    _, coord_gid_avail = np.unique(cavail, axis=0, return_inverse=True)

    while res <= max_res and in_pool.any():
        r_ix = n_branch_levels  # 0-based level index
        fine_thr = [kthresholds(cavail[:, i], int(axis_cell_size[i] * K[i] ** (res - 1))) for i in range(dd)]
        grid_size = int(np.prod([len(t) + 1 for t in fine_thr]))
        pool_idx = np.flatnonzero(in_pool)

        if grid_size < pool_idx.size:
            # bin the pool into fine cells, pick 1 knot per cell with margin weights
            fb = axis_bins(cavail[pool_idx], fine_thr)
            strides = np.cumprod([1] + [len(t) + 2 for t in fine_thr[:-1]])
            fkey = combined_cell_id(fb, np.asarray(strides))
            w = w_margin[mv_id[avail[pool_idx]]]
            gumbel = rng.gumbel(size=pool_idx.size)
            score = np.log(np.maximum(w, 1e-300)) + gumbel
            order = np.lexsort((-score, fkey))
            fsorted = fkey[order]
            first = np.ones(len(order), dtype=bool)
            first[1:] = fsorted[1:] != fsorted[:-1]
            knots_local = pool_idx[order[first]]
            if cherrypick_group_locations:
                sel_gids = np.zeros(coord_gid_avail.max() + 1, dtype=bool)
                sel_gids[coord_gid_avail[knots_local]] = True
                knots_local = pool_idx[sel_gids[coord_gid_avail[pool_idx]]]
        else:
            knots_local = pool_idx

        # coarse blocks at this level (make_tree.R:118-125)
        coarse_thr = [kthresholds(cavail[:, i], int(K[i] ** (res - 1))) for i in range(dd)]
        cb_all = axis_bins(cavail, coarse_thr)
        strides = np.asarray(np.cumprod([1] + [len(t) + 2 for t in coarse_thr[:-1]]))
        ckey_all = combined_cell_id(cb_all, strides)
        lev_cells.append(ckey_all)

        knot_keys = ckey_all[knots_local]
        order2, starts = _group_rows(knot_keys)
        uniq_keys = knot_keys[order2[starts[:-1]]]  # ascending (stable sort)
        cell2block.append((np.asarray(uniq_keys, dtype=np.int64), max_block_number))
        rows_sorted = avail[knots_local[order2]]
        gid = np.repeat(np.arange(len(uniq_keys)), np.diff(starts))
        block_of_row[rows_sorted] = max_block_number + gid
        res_of_row[rows_sorted] = res
        block_rows.extend(np.split(rows_sorted, starts[1:-1]))
        block_level_list.extend([res] * len(uniq_keys))
        max_block_number += len(uniq_keys)
        res_is_ref_list.append(1)

        in_pool[knots_local] = False
        n_branch_levels += 1
        res += 1

    # last branching level may be demoted to non-reference (make_tree.R:162-165)
    if last_not_reference and res < max_res and n_branch_levels > 0:
        res_is_ref_list[-1] = 0

    ref_levels = [g for g in range(n_branch_levels) if res_is_ref_list[g] == 1]

    def _chain_parents_batch(hosts: np.ndarray) -> list[np.ndarray]:
        """Reference ancestors of each branching block's chain (make_edges
        parent rule, tree_dep.cpp:75-186), batched over all blocks at once:
        the reference branching levels strictly above the block's own level
        whose coarse cell (looked up by the block's first row) formed a
        block; ``limited_tree`` keeps only the deepest (make_edges_limited)."""
        hosts = np.asarray(hosts, dtype=np.int64)
        m = hosts.size
        if m == 0:
            return []
        r0 = np.fromiter((block_rows[h][0] for h in hosts), np.int64, m)
        a0 = np.searchsorted(avail, r0)  # host rows are available rows
        host_lev = np.asarray(
            [block_level_list[h] for h in hosts], dtype=np.int64
        ) - (start_level + 1)  # 0-based branch level
        cols, valid = [], []
        for g in ref_levels:
            uniq, base = cell2block[g]
            keys = lev_cells[g][a0]
            if len(uniq):
                pos = np.searchsorted(uniq, keys)
                pos_c = np.minimum(pos, len(uniq) - 1)
                found = uniq[pos_c] == keys
            else:
                pos_c = np.zeros(m, dtype=np.int64)
                found = np.zeros(m, dtype=bool)
            cols.append(base + pos_c)
            valid.append(found & (g < host_lev))
        if not cols:
            return [np.empty(0, dtype=np.int64)] * m
        cmat = np.stack(cols, axis=1)  # columns in ascending-level order
        vmat = np.stack(valid, axis=1)
        if limited_tree:
            has = vmat.any(axis=1)
            last = vmat.shape[1] - 1 - np.argmax(vmat[:, ::-1], axis=1)
            flat = cmat[np.arange(m), last][has]
            counts = has.astype(np.int64)
        else:
            flat = cmat[vmat]  # row-major: per-host ascending levels
            counts = vmat.sum(axis=1)
        return np.split(flat, np.cumsum(counts)[:-1])

    parents: list[np.ndarray] = list(_chain_parents_batch(np.arange(max_block_number)))

    max_branch_res = (start_level + n_branch_levels) if n_branch_levels else start_level
    level_kw = dict(
        host_blocks=np.flatnonzero(np.asarray(block_level_list) == max_branch_res),
        host_ref=n_branch_levels > 0 and res_is_ref_list[-1] == 1,
        coords=coords, mv_id=mv_id, block_of_row=block_of_row,
        res_of_row=res_of_row, block_rows=block_rows,
        block_level=block_level_list, parents=parents,
        limited_tree=limited_tree, cherrypick_same_margin=cherrypick_same_margin)

    # ---- leftover observed rows -> 1-NN extra non-reference level ----
    # (make_tree.R:213-305)
    has_leftover = bool(in_pool.any())
    if has_leftover:
        _host_level(avail[in_pool], max_branch_res + 1, **level_kw)
        res_is_ref_list.append(0)
    n_obs_blocks = len(block_rows)

    if len(res_is_ref_list) == 1:
        res_is_ref_list = [1]

    # ---- missing rows -> final prediction level ---- (make_tree.R:317-413)
    if missing.size:
        _host_level(missing, max_branch_res + (2 if has_leftover else 1), **level_kw)
        res_is_ref_list.append(0)

    n_blocks = len(block_rows)
    block_ct_obs = np.bincount(
        block_of_row[observed & (block_of_row >= 0)], minlength=n_blocks
    ).astype(np.int64)

    # structural invariant: no block shares a level with any of its parents
    # (the Gibbs-group coloring check, reference: spamtree_model.cpp:201-226)
    blk_lev = np.asarray(block_level_list)
    par_sizes = np.fromiter((p.size for p in parents), np.int64, n_blocks)
    if par_sizes.sum():
        par_flat = np.concatenate([p for p in parents if p.size])
        own_lev = np.repeat(blk_lev, par_sizes)
        assert np.all(blk_lev[par_flat] < own_lev), (
            "coloring invariant violated: parent at same/deeper level"
        )

    return TreeLevels(
        n_rows=n,
        block_of_row=block_of_row,
        res_of_row=res_of_row,
        res_is_ref=np.asarray(res_is_ref_list, dtype=np.int64),
        n_levels=len(res_is_ref_list),
        n_blocks=n_blocks,
        block_rows=block_rows,
        block_level=blk_lev,
        parents=parents,
        block_ct_obs=block_ct_obs,
        n_obs_blocks=n_obs_blocks,
        branch_res=max_branch_res,
    )


def attach_rows(
    tree: TreeLevels,
    row_map: np.ndarray,
    coords: np.ndarray,
    observed: np.ndarray,
    mv_id: np.ndarray,
    limited_tree: bool = False,
    cherrypick_same_margin: bool = True,
) -> TreeLevels | None:
    """``make_tree``'s tree over (``coords``, ``observed``, ``mv_id``), built
    from ``tree``: ``make_tree``'s, with the same settings, over rows of
    which ``row_map`` gives each one's position among the new rows
    (increasing), the new rows holding the same observed rows and more
    missing ones.

    The observed rows alone set the branching and leftover levels (their
    rows, thresholds, knots and parents), so their blocks are ``tree``'s
    with the rows renumbered; the prediction level is built anew over every
    missing row by ``make_tree``'s own rule (``_host_level``).  None where
    that does not hold or ``tree`` cannot tell: ``row_map`` not increasing,
    other observed rows, no ``n_obs_blocks`` / ``branch_res``, or a single
    level of observed rows (``make_tree`` then reports it as a reference
    level whatever its blocks were to the prediction level)."""
    nb = getattr(tree, "n_obs_blocks", None)
    hres = getattr(tree, "branch_res", None)
    if nb is None or hres is None:
        return None
    n_obs_levels = tree.n_levels - int(tree.n_blocks > nb)
    row_map = np.asarray(row_map, dtype=np.int64)
    observed = np.asarray(observed, dtype=bool)
    kept = tree.block_of_row < nb  # the tree's observed rows
    if (n_obs_levels < 2
            or row_map.shape != (tree.n_rows,) or np.any(np.diff(row_map) <= 0)
            or int(observed.sum()) != int(kept.sum())
            or not observed[row_map[kept]].all()):
        return None
    n = len(coords)
    block_of_row = np.full(n, -1, dtype=np.int64)
    res_of_row = np.full(n, -1, dtype=np.int64)
    block_of_row[row_map[kept]] = tree.block_of_row[kept]
    res_of_row[row_map[kept]] = tree.res_of_row[kept]
    ends = np.cumsum(np.fromiter(map(len, tree.block_rows[:nb]), np.int64, nb))
    flat = row_map[np.concatenate(tree.block_rows[:nb])]
    block_rows = [flat[a:b] for a, b in zip([0, *ends[:-1].tolist()], ends.tolist())]
    block_level = tree.block_level[:nb].tolist()
    parents = list(tree.parents[:nb])
    res_is_ref = tree.res_is_ref[:n_obs_levels].tolist()
    missing = np.flatnonzero(~observed)
    if missing.size:
        _host_level(
            missing, block_level[-1] + 1,
            host_blocks=np.flatnonzero(tree.block_level[:nb] == hres),
            host_ref=res_is_ref[hres - block_level[0]] == 1,
            coords=coords, mv_id=np.asarray(mv_id, dtype=np.int64),
            block_of_row=block_of_row, res_of_row=res_of_row,
            block_rows=block_rows, block_level=block_level, parents=parents,
            limited_tree=limited_tree,
            cherrypick_same_margin=cherrypick_same_margin)
        res_is_ref.append(0)
    n_blocks = len(block_rows)
    return TreeLevels(
        n_rows=n,
        block_of_row=block_of_row,
        res_of_row=res_of_row,
        res_is_ref=np.asarray(res_is_ref, dtype=np.int64),
        n_levels=len(res_is_ref),
        n_blocks=n_blocks,
        block_rows=block_rows,
        block_level=np.asarray(block_level),
        parents=parents,
        block_ct_obs=np.concatenate(
            [tree.block_ct_obs[:nb], np.zeros(n_blocks - nb, dtype=np.int64)]),
        n_obs_blocks=nb,
        branch_res=hres,
    )
