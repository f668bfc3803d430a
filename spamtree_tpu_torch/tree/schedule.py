"""Static treed-DAG schedule compiler.

Converts the ragged per-block structure produced by the partitioner into
dense, padded per-level arrays that the jitted MCMC kernels consume.  This is
the TPU-native replacement for the reference's per-block Armadillo field
indexing (``init_indexing``/``init_finalize``/``make_gibbs_groups``,
reference: src/spamtree_model.cpp:194-420):

* per level, blocks are padded to a common size ``S`` and parent sets to a
  common padded layout ``P`` (identity-padding semantics: padded slots behave
  as independent standard normals with zero cross-covariance, so all the
  linear algebra downstream is exact on the real slots);
* each block's padded parent layout *is* the padded joint layout
  ``[parents, rows]`` of its deepest reference ancestor, which is what makes
  the reference's nested inverse-Cholesky propagation
  (``invchol_block_inplace_direct``, src/tree_utils.cpp:194-208) a single
  batched gather per level here;
* the child->parent Gibbs messages (``u_is_which_col_f``/``this_is_jth_child``
  machinery, src/spamtree_model.cpp:355-420 and 1158-1210) become static
  *contiguous segments*: because the layout is built recursively with
  level-wide fixed padding, ancestor ``a``'s padded rows always occupy the
  same slice ``[seg_off[a], seg_off[a]+seg_size[a])`` of the parent layout
  for every block of a level.  Messages are then per-segment slices
  scatter-added by ancestor block id -- no per-slot owner masks, and the
  dense (P, P) child Gram matrix never needs materializing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from spamtree_tpu_torch.tree.partition import TreeLevels


@dataclass
class LevelPlan:
    res: int  # 1-based level id
    is_ref: bool
    block_ids: np.ndarray  # (B,)
    rows: np.ndarray  # (B, S) int32, sentinel = n
    prows: np.ndarray  # (B, P) int32, sentinel = n (P may be 0)
    lp_pos: np.ndarray  # (B,) position of deepest ref ancestor in its level batch
    lp_level: int  # sweep index of the level providing propagated factors (-1 = root)
    anc_blocks: np.ndarray  # (B, n_anc) ancestor block id per layout segment
    seg_off: list  # [n_anc] static start offset of each ancestor segment
    seg_size: list  # [n_anc] static padded size of each ancestor segment
    # reference levels only: blocks are ordered parent-major in groups of
    # group_c children per parent (dummy-padded), so the (P, P) parent joint
    # factor is gathered once per *parent* instead of once per child
    group_c: int = 1
    # thin/pred levels only: one block per parent batch POSITION (empty slots
    # padded), so the parent joint factor needs no gather at all -- the
    # kernels read the factor array directly, element-aligned.  On a sharded
    # mesh this also removes the cross-shard gather (parent and child shard
    # boundaries coincide).
    aligned: bool = False

    @property
    def B(self) -> int:
        return self.rows.shape[0]

    @property
    def S(self) -> int:
        return self.rows.shape[1]

    @property
    def P(self) -> int:
        return self.prows.shape[1]


@dataclass
class Schedule:
    n: int
    n_blocks: int
    Smax: int  # max padded block size over sweep levels (accumulator width)
    levels: list  # [LevelPlan] observed levels, root -> leaf order
    pred: LevelPlan | None  # prediction (all-missing) level, or None (unsplit)
    limited_tree: bool
    pred_buckets: list = None  # size-bucketed prediction plans (see _bucket_plan)


def _csr(arrs: list) -> tuple[np.ndarray, np.ndarray]:
    """(offsets (len + 1,), flat entries) of a list of 1-D integer arrays:
    entry i is ``flat[offsets[i]:offsets[i + 1]]``."""
    off = np.zeros(len(arrs) + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, arrs), np.int64, len(arrs)), out=off[1:])
    return off, np.concatenate(arrs).astype(np.int64, copy=False)


def _pad_rows(vals: np.ndarray, lens: np.ndarray, width: int,
              fill) -> np.ndarray:
    """(len(lens), width) int64: row i holds the next lens[i] entries of
    ``vals`` in order, then ``fill``."""
    mask = np.arange(width) < lens[:, None]
    out = np.full(mask.shape, fill, dtype=np.int64)
    out[mask] = vals  # row-major: each row's entries in order
    return out


def _gather_pad(off: np.ndarray, flat: np.ndarray, ids: np.ndarray, fill,
                width: int | None = None) -> np.ndarray:
    """Entries ``ids`` of a CSR list (``_csr``), padded with ``fill`` to
    ``width`` (default: the longest); none may be longer than ``width``."""
    lens = off[ids + 1] - off[ids]
    if width is None:
        width = int(lens.max())
    # entry k of the selection: its list's start, less the selection's
    # entries before that list, plus k
    skip = np.repeat(off[ids] - (np.cumsum(lens) - lens), lens)
    return _pad_rows(flat[skip + np.arange(len(skip))], lens, width, fill)


def _groups_by(keys: np.ndarray):
    """(order, starts, group) of non-empty ``keys``: a stable sort, the
    sorted positions where each run of equal keys starts, and each sorted
    position's run."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    first = np.r_[True, ks[1:] != ks[:-1]]
    return order, np.flatnonzero(first), np.cumsum(first) - 1


def _bucket_boundaries(sizes: np.ndarray, max_buckets: int) -> list[np.ndarray]:
    """Partition blocks into <=max_buckets size classes minimizing the padded
    area sum(B_i * Smax_i).  Exact DP over the (few) distinct sizes."""
    uniq, counts = np.unique(sizes, return_counts=True)
    m = len(uniq)
    if m <= 1 or max_buckets <= 1:
        return [np.arange(len(sizes))]
    csum = np.concatenate([[0], np.cumsum(counts)])
    # cost of one bucket covering distinct-size range [i, j): count * max size
    cost = np.full((m, m + 1), np.inf)
    for i in range(m):
        for j in range(i + 1, m + 1):
            cost[i, j] = (csum[j] - csum[i]) * uniq[j - 1]
    best = np.full((max_buckets + 1, m + 1), np.inf)
    prev = np.zeros((max_buckets + 1, m + 1), dtype=np.int64)
    best[0, 0] = 0.0
    for k in range(1, max_buckets + 1):
        for j in range(1, m + 1):
            for i in range(j):
                c = best[k - 1, i] + cost[i, j]
                if c < best[k, j]:
                    best[k, j] = c
                    prev[k, j] = i
    k = int(np.argmin(best[:, m]))
    cuts = [m]
    j = m
    for kk in range(k, 0, -1):
        j = int(prev[kk, j])
        cuts.append(j)
    cuts = cuts[::-1]  # [0, ..., m]
    out = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        lo, hi = uniq[a], uniq[b - 1]
        out.append(np.flatnonzero((sizes >= lo) & (sizes <= hi)))
    return out


def _merge_by_ancestor(plan: LevelPlan, n: int, nb: int) -> LevelPlan:
    """Merge all blocks of a non-reference level that share the same deepest
    reference ancestor into one block.

    Exact: thin (and prediction) rows are conditionally independent given
    their parent set, and blocks with the same deepest ancestor have
    *identical* padded parent layouts (``prows = joint_rows[lp][lp_pos]``), so
    concatenating their rows changes nothing in the math -- the diagonal
    conditional variance, the per-row H operator, and the summed Gibbs
    messages to each ancestor segment are all row-separable.

    Why: the (B, P, P) gather of the parent joint inverse-Cholesky factor is
    the sweep's dominant HBM traffic (measured ~2.7 GB/sweep at n=1e5), and
    without merging each parent factor is re-read once per *child block*
    (~4x fan-in at default settings).  After merging each parent is read at
    most once per level.  ``block_ids`` becomes (B, M) padded with ``nb`` --
    the kernels never read it; host-side consumers must treat it as a set.
    """
    if plan.P == 0 or plan.B <= 1 or plan.is_ref:
        return plan
    order, starts, _ = _groups_by(plan.lp_pos)
    if len(starts) == plan.B:
        return plan

    def _merged(a, fill):
        # each sorted block's real entries (< fill), concatenated group by
        # group in block order, padded with ``fill``
        a = a[order]
        real = a < fill
        lens = np.add.reduceat(real.sum(axis=1), starts)
        return _pad_rows(a[real], lens, int(lens.max()), fill)

    first = order[starts]
    return LevelPlan(
        res=plan.res, is_ref=plan.is_ref,
        block_ids=_merged(plan.block_ids.reshape(plan.B, -1), nb),
        rows=_merged(plan.rows, n),
        prows=plan.prows[first],
        lp_pos=plan.lp_pos[first], lp_level=plan.lp_level,
        anc_blocks=plan.anc_blocks[first],
        seg_off=list(plan.seg_off), seg_size=list(plan.seg_size),
    )


def _align_to_parent(plan: LevelPlan, n: int, nb: int, parent_B: int,
                     src_rows: np.ndarray,
                     max_waste: float = 3.0) -> LevelPlan | None:
    """Lay an ancestor-merged thin/pred level out with exactly one block per
    PARENT batch position (empty slots for parents without children here).

    The level's padded parent layouts then coincide element-for-element with
    the parent level's joint-factor batch, so the sweep reads the (P, P)
    factors as a straight stream instead of a row gather (measured 97 vs
    405 GB/s on the target chip), and block-axis sharding needs no
    cross-device gather.  Requires ``plan`` already merged by ancestor
    (unique lp_pos per block).  Returns None when the empty-slot padding
    would exceed ``max_waste`` x the real row count.
    """
    if plan.P == 0 or plan.is_ref:
        return None
    sizes = (plan.rows < n).sum(axis=1)
    S = int(plan.rows.shape[1])
    real = int(sizes.sum())
    if real == 0 or parent_B * S > max_waste * real:
        return None
    if len(np.unique(plan.lp_pos)) != plan.B:
        return None  # not merged; alignment needs one block per ancestor
    bid = plan.block_ids.reshape(plan.B, -1)
    M = bid.shape[1]
    rows = np.full((parent_B, S), n, dtype=np.int64)
    ids = np.full((parent_B, M), nb, dtype=np.int64)
    anc = np.full((parent_B, plan.anc_blocks.shape[1]), nb, dtype=np.int64)
    rows[plan.lp_pos] = plan.rows
    ids[plan.lp_pos] = bid
    anc[plan.lp_pos] = plan.anc_blocks
    return LevelPlan(
        res=plan.res, is_ref=False,
        block_ids=ids, rows=rows,
        prows=src_rows.copy(),
        lp_pos=np.arange(parent_B, dtype=np.int64),
        lp_level=plan.lp_level,
        anc_blocks=anc,
        seg_off=list(plan.seg_off), seg_size=list(plan.seg_size),
        aligned=True,
    )


def _group_ref_plan(plan: LevelPlan, n: int, nb: int,
                    max_waste: float = 1.15) -> LevelPlan:
    """Reorder a reference level parent-major and pad each parent's children
    to a uniform count ``group_c`` with dummy blocks.

    Unlike thin levels, reference blocks cannot be merged (each one is a unit
    of the treed DAG: it emits its own joint factor and its children condition
    on it) -- but they *can* be reordered.  With children of one parent
    contiguous, the sweep gathers the (P, P) parent joint inverse-Cholesky
    factor once per parent and applies it to all ``group_c`` children as one
    batched GEMM with a (P, group_c*S) right-hand side: fewer HBM reads of the
    level's largest operand and taller MXU tiles.  Dummy blocks (rows all
    sentinel) factor to identity and send zero messages; they are skipped for
    position registration via their ``nb`` block id.  Applied only when the
    dummy padding is <= max_waste of the real block count.
    """
    if plan.P == 0 or plan.B <= 1 or not plan.is_ref:
        return plan
    order, starts, grp = _groups_by(plan.lp_pos)
    C = int(np.diff(np.r_[starts, plan.B]).max())
    if C <= 1 or len(starts) * C > max_waste * plan.B:
        return plan
    # permutation with -1 marking dummy slots: group k's children at
    # k * C + their rank in the group
    perm = np.full(len(starts) * C, -1, dtype=np.int64)
    perm[grp * C + np.arange(plan.B) - starts[grp]] = order
    real = perm >= 0
    src = np.maximum(perm, 0)
    # dummies copy their group leader's parent pointers (the gather then
    # reads no extra factor) but get sentinel rows/ancestors (masked out)
    leader = np.repeat(order[starts], C)
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


def _bucket_plan(plan: LevelPlan, n: int, max_buckets: int = 4,
                 min_gain: float = 1.15, min_blocks: int = 64) -> list[LevelPlan]:
    """Split a non-reference level into size buckets, each padded to its own
    block width.  Thin levels never serve as parents (no joint factors, no
    children gather into their batch), so regrouping their blocks is free --
    and they are where the padding waste concentrates (the leftover 1-NN
    level's block sizes are long-tailed; ~4x measured at n=1e5 defaults).
    """
    sizes = (plan.rows < n).sum(axis=1)
    B = plan.B
    if B < min_blocks:
        return [plan]
    groups = _bucket_boundaries(sizes, max_buckets)
    if len(groups) <= 1:
        return [plan]
    padded = sum(len(g) * int(sizes[g].max()) for g in groups)
    if B * plan.S < min_gain * padded:
        return [plan]
    out = []
    for g in groups:
        S_g = int(sizes[g].max())
        out.append(LevelPlan(
            res=plan.res, is_ref=plan.is_ref,
            block_ids=plan.block_ids[g],
            rows=plan.rows[g, :S_g],
            prows=plan.prows[g],
            lp_pos=plan.lp_pos[g], lp_level=plan.lp_level,
            anc_blocks=plan.anc_blocks[g],
            seg_off=list(plan.seg_off), seg_size=list(plan.seg_size),
        ))
    return out


def _pad_S(plan: LevelPlan, align: int, n: int) -> LevelPlan:
    """Round a thin/pred level's block width S up to a multiple of ``align``
    with sentinel rows (identity-padding semantics): the per-row kernels'
    (B, S)/(B, S, P) operands then have 128-lane-aligned trailing/second
    dims, which the fused Pallas level kernels need for stride-free block
    DMA.  Exact: sentinel rows are masked out of every reduction."""
    S = plan.rows.shape[1]
    Sp = -(-S // align) * align
    if Sp == S:
        return plan
    ext = np.full((plan.rows.shape[0], Sp - S), n, dtype=plan.rows.dtype)
    plan.rows = np.concatenate([plan.rows, ext], axis=1)
    return plan


def build_schedule(
    tree: TreeLevels, limited_tree: bool = False, validate: bool | None = None,
    bucket_thin: bool = True, merge_thin: bool = True, group_ref: bool = True,
    align_thin: bool = True, align_min_p: int = 128,
    joint_align: int | None = None, thin_s_align: int | None = None,
) -> Schedule:
    import os as _os

    # 128-lane layout alignment for the fused Pallas level kernels
    # (VERDICT r4 item 2): ``joint_align`` pads the DEEPEST reference
    # level's joint layout (the (B, P, P) factor batch every thin/pred
    # level streams) to a multiple, ``thin_s_align`` rounds thin/pred
    # block widths S up.  Only the deepest ref joint is padded, so the
    # padding never compounds through the ancestor recursion.  Exact by
    # identity-padding semantics; default off (0) -- measured A/B knobs.
    if joint_align is None:
        joint_align = int(_os.environ.get("SPAMTREE_JOINT_ALIGN", "0") or 0)
    if thin_s_align is None:
        thin_s_align = int(_os.environ.get("SPAMTREE_THIN_S_ALIGN", "0") or 0)
    n = tree.n_rows
    nb = tree.n_blocks
    if validate is None:
        # the layout asserts gather every block's ancestor segments again;
        # skip them at large scale (they are structural invariants fully
        # exercised by the test suite at small n)
        validate = nb <= 20000

    # group blocks by level, ascending; separate all-empty (prediction) levels
    levels_1b = np.unique(tree.block_level).tolist()
    sweep_levels: list[LevelPlan] = []
    pred_plan: LevelPlan | None = None

    # deepest observed reference level: the only joint layout joint_align
    # pads (its consumers are all thin/pred, so the pad cannot compound)
    last_ref_res = None
    if joint_align > 1 and not limited_tree:
        for li, res in enumerate(levels_1b):
            ids0 = np.flatnonzero(tree.block_level == res)
            if (tree.block_ct_obs[ids0] > 0).any() and tree.res_is_ref[li] == 1:
                last_ref_res = res

    # every block's rows and parents as CSR lists, read level by level
    row_off, row_flat = _csr(tree.block_rows)
    par_off, par_flat = _csr(tree.parents)
    row_len = np.diff(row_off)
    # per REF sweep level: padded joint layout rows + static segment structure
    joint_rows: dict[int, np.ndarray] = {}
    joint_segs: dict[int, tuple] = {}  # t -> (seg_off list, seg_size list)
    # per block of a REF sweep level: its position in its level batch and
    # that level's sweep index (-1: not registered)
    block_pos = np.full(nb, -1, dtype=np.int64)
    block_sweep_level = np.full(nb, -1, dtype=np.int64)
    t_sweep = 0

    for li, res in enumerate(levels_1b):
        ids = np.flatnonzero(tree.block_level == res)
        obs = tree.block_ct_obs[ids] > 0
        is_pred_level = not obs.any()
        if not is_pred_level:
            assert obs.all(), f"level {res} mixes observed and empty blocks"
        is_ref = bool(tree.res_is_ref[li] == 1) and not is_pred_level

        rows = _gather_pad(row_off, row_flat, ids, n)
        S = rows.shape[1]

        # parent layout
        n_par = par_off[ids + 1] - par_off[ids]
        if not n_par.any():
            prows = np.zeros((len(ids), 0), dtype=np.int64)
            lp_pos = np.full(len(ids), -1, dtype=np.int64)
            lp_level = -1
            anc_blocks = np.zeros((len(ids), 0), dtype=np.int64)
            seg_off, seg_size = [], []
        else:
            assert n_par.all(), f"level {res} mixes root and non-root blocks"
            assert (n_par == n_par[0]).all(), (
                f"level {res}: blocks have ragged ancestor counts "
                f"{set(np.unique(n_par).tolist())}"
            )
            anc_blocks = par_flat[par_off[ids][:, None] + np.arange(n_par[0])]
            lps = anc_blocks[:, -1]
            lp_levels = set(np.unique(block_sweep_level[lps]).tolist())
            assert len(lp_levels) == 1 and -1 not in lp_levels, (
                f"level {res}: deepest ancestors at levels {lp_levels}"
            )
            lp_level = lp_levels.pop()
            lp_pos = block_pos[lps]
            if limited_tree:
                src_rows = sweep_levels[lp_level].rows
                seg_off = [0]
                seg_size = [src_rows.shape[1]]
            else:
                src_rows = joint_rows[lp_level]
                seg_off, seg_size = joint_segs[lp_level]
            prows = src_rows[lp_pos]
            assert anc_blocks.shape[1] == len(seg_off), (
                f"level {res}: {anc_blocks.shape[1]} ancestors vs "
                f"{len(seg_off)} layout segments"
            )
            # invariant: segment a of the layout == padded rows of ancestor a
            if validate:
                for a, (o, s) in enumerate(zip(seg_off, seg_size)):
                    anc = anc_blocks[:, a]
                    ok = row_len[anc] <= s
                    if ok.all():
                        ok = (prows[:, o : o + s] == _gather_pad(
                            row_off, row_flat, anc, n, width=s)).all(axis=1)
                    assert ok.all(), (
                        f"block {ids[np.argmin(ok)]}: segment {a} layout "
                        "mismatch"
                    )

        plan = LevelPlan(
            res=res, is_ref=is_ref, block_ids=ids, rows=rows, prows=prows,
            lp_pos=lp_pos, lp_level=lp_level, anc_blocks=anc_blocks,
            seg_off=list(seg_off), seg_size=list(seg_size),
        )

        if is_pred_level:
            assert pred_plan is None, "more than one all-empty prediction level"
            pred_plan = plan
            continue

        if is_ref:
            if group_ref:
                plan = _group_ref_plan(plan, n, nb)
            real = plan.block_ids < nb  # not a dummy group-padding block
            block_pos[plan.block_ids[real]] = np.flatnonzero(real)
            block_sweep_level[plan.block_ids[real]] = t_sweep
            joint = np.concatenate([plan.prows, plan.rows], axis=1)
            if last_ref_res is not None and res == last_ref_res:
                W = joint.shape[1]
                Wp = -(-W // joint_align) * joint_align
                if Wp > W:
                    # sentinel tail: identity rows in the emitted factor,
                    # masked out of every Kxc/message; the thin consumers'
                    # (B, P, P) factor stream becomes 128-lane aligned
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
            # thin levels never serve as parents, so their blocks can be
            # regrouped freely: first merge blocks sharing a deepest ref
            # ancestor (one parent-factor gather per ancestor instead of one
            # per child block), then split into size buckets, each padded to
            # its own width (eliminates the ~4x padding waste of the
            # long-tailed leftover 1-NN level)
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
