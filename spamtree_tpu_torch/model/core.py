"""SpamTree model core: batched level-synchronous sweeps in PyTorch.

Port of the main path of ``spamtree_tpu/model/core.py`` (reference class
``SpamTreeMV``, src/spamtree_model.cpp).  Every tree level is one batched
computation over padded block arrays (``tree.schedule``); the level loop,
the B-axis slab loop and every branch are plain Python:

* likelihood sweep  -> ``sweep``        (get_loglik_comps_w_std, .cpp:834-998)
* latent w Gibbs    -> ``gibbs_w``      (gibbs_sample_w_std, .cpp:1011-1226)
* prediction        -> ``predict``      (predict_std, .cpp:1234-1358)
* beta/tausq Gibbs  -> ``gibbs_beta_tausq`` (.cpp:1364-1417), or
                       ``gibbs_tausq`` / ``gibbs_beta`` when one is off
* prior draw of w   -> ``prior_sample_w`` (Geweke test, forward simulation)

Cholesky failure never raises: validity flags are carried and a failed
theta proposal is rejected.  Random draws come in as arguments (the
``(n+1,)`` normal vectors of ``gibbs_w``/``predict``, the gamma and normal
draws of the conjugate tail), so the same draws give the same step as the
JAX package.

Every padded slot of a level scatters into the sentinel row ``w[n]``; its
values are masked to 0, so the duplicate writes agree and ``w[n]`` stays 0.
The draws of a pass are written into w at once, as a gather through a
table of the rows (``RowTable``, ``put_rows``): deterministic by
construction, and as cheap with deterministic algorithms on as off, where
``index_put_`` takes a sort-based path (~165x the gather's time at config
5's levels on an H100, ``chip_smoke.py`` phase 19).

The decision-only sweep of the accept-aware step (``sweep(decision_only=
True)``) propagates joint factors only to sweep levels, lets a reference
level hand its thin children factor parts instead of an assembled joint
(``SPAMTREE_COMPOSED_FACTORS``, default on), and with
``SPAMTREE_LEVEL_KERNELS=1`` runs thin levels through the fused kernels of
``ops.level`` (K4 in the decision sweep, K3 in ``gibbs_w``).

Above 256 MB of prediction operators (``pred_in_carry`` False) the
sampler carries none and ``predict_recompute`` rebuilds them for the
current theta at each kept iteration.

Batched chains: ``sweep`` (full and decision-only), ``gibbs_w`` (Gram
blocks formed in place), ``pred_operators_from_joint``, ``predict``,
``predict_recompute``, ``quad_loglik`` and the conjugate tail also take a
leading chain axis C -- theta (C, n_theta), w and XB (C, n+1), tausq_inv
(C, q), every level's H/prec (C, B, ...) -- and return one logdet, ok flag
and quadratic form per chain.  Static level arrays have no chain axis;
each reference level's Cholesky batch is folded to (C*B, S, S), one K1
launch for all chains, and each thin level's K4 batch to C*B blocks.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from spamtree_tpu_torch.ops import level as level_ops
from spamtree_tpu_torch.ops.chol import max_s
from spamtree_tpu_torch.ops.covariance import (
    CovModel,
    cov_block,
    pairwise_cov,
    pairwise_cov_diag,
    unpack_theta,
)
from spamtree_tpu_torch.ops.linalg import (
    chol_inv_masked,
    chol_masked,
    chol_nan,
    tri_solve,
)


class LevelArrays(NamedTuple):
    """Static per-level index tensors (int64) and masks (bool)."""

    rows: torch.Tensor  # (B, S) sentinel n
    prows: torch.Tensor  # (B, P) sentinel n
    rmask: torch.Tensor  # (B, S)
    pmask: torch.Tensor  # (B, P)
    lp_pos: torch.Tensor  # (B,) parent position in the lp level's batch


class LevelData(NamedTuple):
    """Per-level theta-dependent state (reference param_data,
    src/tree_utils.h:63-102)."""

    H: torch.Tensor  # (B, S, P) conditional mean operator
    prec: torch.Tensor  # (B, S, S) ref levels / (B, S) thin levels


class RowTable(NamedTuple):
    """Where a write of flat values lands in an (n+1,) w (``put_rows``):
    ``hit`` (n+1,) bool marks the rows written, ``src`` (n+1,) int64 the
    flat position each one takes its value from."""

    hit: torch.Tensor
    src: torch.Tensor


def row_table(rows: np.ndarray, n: int, device) -> RowTable:
    """The RowTable of a write of values at the flat ``rows`` (each real
    row at most once; padded slots name the sentinel n, whose value is
    taken from the first of them, all holding 0)."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    u, first = np.unique(rows, return_index=True)
    assert len(u) + int((rows == n).sum()) - int(n in u) == len(rows), \
        "a row is written twice"
    hit = np.zeros(n + 1, dtype=bool)
    src = np.zeros(n + 1, dtype=np.int64)
    hit[u], src[u] = True, first
    return RowTable(torch.as_tensor(hit, device=device),
                    torch.as_tensor(src, device=device))


def put_rows(ms: "ModelStatic", w, vals, table: RowTable):
    """A new w with the (..., B, S) draws ``vals`` (a list, in the order
    of ``table``'s rows) written at their rows: a gather through the table
    and a select, the same bits as ``w[..., rows] = vals`` with no scatter
    (deterministic in either mode of ``torch.use_deterministic_algorithms``,
    whose ``index_put_`` sorts its indices).
    On a blocks mesh ``vals`` are this rank's shards, joined over the ranks
    first (``table`` lists every rank's rows in rank order)."""
    flat = torch.cat([v.flatten(-2) for v in vals], dim=-1)
    if ms.mesh is not None:
        flat = ms.mesh.cat_blocks(flat, flat.dim() - 1)
    return torch.where(table.hit, flat.index_select(-1, table.src), w)


class ModelStatic:
    """All static data and the schedule, as tensors on one device."""

    def __init__(self, sched, coords: np.ndarray, mv_id: np.ndarray,
                 y: np.ndarray, X: np.ndarray, spec: CovModel,
                 dtype=torch.float32, device="cuda", chunk_bytes: float = 512e6,
                 use_kernel: bool = True, block_multiple: int = 1):
        n = sched.n
        self.limited_tree = sched.limited_tree
        self.spec = spec
        self.dtype = dtype
        self.device = torch.device(device)
        # Cholesky up to ops.chol.max_s(dtype) rows goes through kernel K1
        # (ops.chol.inv_chol), which takes its plain version on CPU tensors
        self.use_kernel = use_kernel
        self.n = n
        self.p = X.shape[1]
        self.q = spec.q

        def _put(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), device=self.device).to(dt)

        obs = np.isfinite(np.asarray(y, dtype=np.float64))
        y0 = np.where(obs, y, 0.0)
        self.coords = _put(np.vstack([coords, np.zeros((1, coords.shape[1]))]))
        self.mv = _put(np.append(mv_id, 0), torch.long)
        self.y = _put(np.append(y0, 0.0))
        self.X = _put(X)
        onehot = mv_id[:, None] == np.arange(spec.q)[None, :]
        self.mv_onehot_obs = _put(onehot & obs[:, None])  # (n, q)
        self.mv_onehot = _put(onehot)
        self.n_obs_by_q = np.asarray(
            [(obs & (mv_id == j)).sum() for j in range(spec.q)],
            dtype=np.float64)
        # X'X on observed rows per margin (reference: spamtree_model.cpp:151-155)
        Xh = np.asarray(X)
        self.XtX = _put(np.stack([
            Xh[obs & (mv_id == j)].T @ Xh[obs & (mv_id == j)]
            for j in range(spec.q)
        ]))

        # B-axis chunking, identical to the JAX package: a level whose
        # largest transient would exceed chunk_bytes runs as n_chunks
        # sequential slabs (B padded to a multiple of block_multiple *
        # n_chunks * group_c, so every shard of a blocks mesh holds whole
        # slabs and whole parent-major groups).
        itemsize = torch.empty((), dtype=dtype).element_size()

        def _n_chunks(plan, factor=1) -> int:
            B, P = plan.rows.shape[0], plan.prows.shape[1]
            big = factor * B * max(P * P, 1) * itemsize
            if not chunk_bytes or big <= chunk_bytes:
                return 1
            return int(np.ceil(big / chunk_bytes))

        def _n_chunks_aligned(plan) -> int:
            # aligned levels read the parent factor batch in place; the peak
            # transient is the (B, P, S)-class tensors
            B, S, P = plan.rows.shape[0], plan.rows.shape[1], plan.prows.shape[1]
            big = 3 * B * P * max(S, 1) * itemsize
            if not chunk_bytes or big <= chunk_bytes:
                return 1
            return int(np.ceil(big / chunk_bytes))

        pred_buckets = sched.pred_buckets or []
        # parent-aligned thin/pred levels need the child's padded B to equal
        # the parent's and the level to run unchunked; otherwise they demote
        # to the gather path (their lp_pos is the identity)
        padded_B: list = []
        self.level_chunks = []
        self.level_aligned = []
        for p in sched.levels:
            gc = getattr(p, "group_c", 1)
            B = p.rows.shape[0]
            al = bool(getattr(p, "aligned", False))
            nc = _n_chunks_aligned(p) if al else _n_chunks(p)
            al = al and nc == 1
            if not al:
                nc = _n_chunks(p)
            mult = block_multiple * nc * gc
            tgt = padded_B[p.lp_level] if al else None
            if al and (tgt < B or tgt % mult != 0):
                al, tgt = False, None
                nc = _n_chunks(p)
                mult = block_multiple * nc * gc
            self.level_chunks.append(nc)
            self.level_aligned.append(al)
            padded_B.append(tgt if tgt is not None else B + (-B) % mult)
        self.pred_chunks = []
        self.pred_aligned = []
        pred_pad_to = []
        for p in pred_buckets:
            B = p.rows.shape[0]
            al = bool(getattr(p, "aligned", False))
            nc = _n_chunks_aligned(p) if al else _n_chunks(p, 2)
            al = al and nc == 1
            if not al:
                nc = _n_chunks(p, 2)
            tgt = padded_B[p.lp_level] if al else None
            if al and (tgt < B or tgt % (block_multiple * nc) != 0):
                al, tgt = False, None
                nc = _n_chunks(p, 2)
            self.pred_chunks.append(nc)
            self.pred_aligned.append(al)
            pred_pad_to.append(tgt)

        nb = sched.n_blocks

        def _stage(plan, n_chunks=1, pad_to=None) -> dict:
            # whole dummy blocks so shards, slabs and parent-major groups
            # stay even
            B = plan.rows.shape[0]
            mult = block_multiple * n_chunks * getattr(plan, "group_c", 1)
            pad = (-B) % mult if pad_to is None else pad_to - B

            def _padB(a, fill):
                a = np.asarray(a, dtype=np.int64)
                if pad == 0:
                    return a
                ext = np.full((pad,) + a.shape[1:], fill, dtype=np.int64)
                return np.concatenate([a, ext], axis=0)

            return dict(rows=_padB(plan.rows, n), prows=_padB(plan.prows, n),
                        lp_pos=_padB(plan.lp_pos, 0),
                        anc_blocks=_padB(plan.anc_blocks, nb),
                        block_ids=_padB(plan.block_ids, nb))

        def _build(sd) -> LevelArrays:
            t = {k: _put(sd[k], torch.long) for k in ("rows", "prows", "lp_pos")}
            return LevelArrays(rows=t["rows"], prows=t["prows"],
                               rmask=t["rows"] < n, pmask=t["prows"] < n,
                               lp_pos=t["lp_pos"])

        staged = [_stage(p, nc, padded_B[t])
                  for t, (p, nc) in enumerate(zip(sched.levels,
                                                  self.level_chunks))]
        staged_pred = [_stage(p, nc, pt) for p, nc, pt in
                       zip(pred_buckets, self.pred_chunks, pred_pad_to)]
        self.levels = [_build(s) for s in staged]
        self.pred_arrays = [_build(s) for s in staged_pred] or None
        # parallel.sharding.shard_model replaces levels/pred_arrays with this
        # rank's block shard; the whole padded levels stay here, the shards'
        # offsets in them in level_off/pred_off, and the mesh in ``mesh``.
        # level_local/pred_local: the level reads its parent's factor and w
        # rows from the rank's own parent shard (lp_pos local); msg_local:
        # every message to the level comes from the rank's own children
        # (anc_pos local).  Always so on one device.
        self.levels_full = self.levels
        self.pred_full = self.pred_arrays
        self.level_off = [0] * len(self.levels)
        self.pred_off = [0] * len(self.pred_arrays or [])
        self.level_local = [True] * len(self.levels)
        self.pred_local = [True] * len(self.pred_arrays or [])
        self.msg_local = [True] * len(self.levels)
        self.mesh = None

        self.level_is_ref = [p.is_ref for p in sched.levels]
        self.level_group_c = [getattr(p, "group_c", 1) for p in sched.levels]
        self.level_lp = [p.lp_level for p in sched.levels]
        self.level_segs = [(p.seg_off, p.seg_size) for p in sched.levels]
        # which levels emit a joint factor (used by a later level or by the
        # prediction buckets), and the last level that consumes each one
        used = {p.lp_level for p in sched.levels if p.lp_level >= 0}
        # parents of sweep levels only: the decision-only sweep builds no
        # prediction operators, so it skips joints that only they consume
        self.serves_as_sweep_parent = [t in used
                                       for t in range(len(sched.levels))]
        self.pred_lp = pred_buckets[0].lp_level if pred_buckets else -1
        if self.pred_lp >= 0:
            used.add(self.pred_lp)
        # identity-pad width of each ref level's emitted joint factor: > 0
        # only when the schedule aligned the deepest joint layout
        self.joint_pad = [0] * len(sched.levels)
        for t2, p2 in enumerate(sched.levels):
            if not p2.is_ref:
                continue
            w_emit = p2.prows.shape[1] + p2.rows.shape[1]
            widths = {
                sched.levels[c].prows.shape[1]
                for c in range(len(sched.levels))
                if sched.levels[c].lp_level == t2 and c != t2
                and sched.levels[c].prows.shape[1] > 0
            }
            if self.pred_lp == t2:
                widths |= {p.prows.shape[1] for p in pred_buckets}
            if widths and not sched.limited_tree:
                assert len(widths) == 1, (t2, widths)
                wc = widths.pop()
                assert wc >= w_emit, (t2, wc, w_emit)
                self.joint_pad[t2] = wc - w_emit
        self.serves_as_parent = [t in used for t in range(len(sched.levels))]
        self.last_consumer = {}
        for t2, p in enumerate(sched.levels):
            if p.lp_level >= 0:
                self.last_consumer[p.lp_level] = t2
        if self.pred_lp >= 0:
            # the prediction operators are built after the level loop
            self.last_consumer[self.pred_lp] = len(sched.levels)
        # the prediction operators ride the sampler state up to 256 MB;
        # above, predict_recompute rebuilds them at each kept iteration
        if pred_buckets:
            pH = sum(p.rows.shape[0] * p.rows.shape[1] * p.prows.shape[1]
                     for p in pred_buckets) * itemsize
            self.pred_in_carry = pH <= 256e6
        else:
            self.pred_in_carry = True

        # Gibbs-message routing: segment a of child level t targets parent
        # level seg_level[t][a]; anc_pos[(t, a)] is each child's parent
        # position in that level's batch (sentinel Bp = dropped), and
        # child_table[(t, a)] lists each parent's children for the
        # fixed-order child->parent sum (see child_tables).
        level_of_block = np.full(nb + 1, -1, dtype=np.int64)
        for t, p in enumerate(sched.levels):
            level_of_block[np.asarray(p.block_ids)] = t
        self.seg_level = []
        self.anc_pos = {}
        for t, plan in enumerate(sched.levels):
            segs = []
            anc = staged[t]["anc_blocks"]
            for a in range(len(plan.seg_off)):
                anc_a = anc[:, a]
                real = anc_a[anc_a < nb]
                tp_set = set(np.unique(level_of_block[real]).tolist())
                assert len(tp_set) == 1, f"segment {a} of level {t}: {tp_set}"
                tp = tp_set.pop()
                segs.append(tp)
                par_ids = np.asarray(sched.levels[tp].block_ids)
                Bp = staged[tp]["rows"].shape[0]
                # dummy group-padding blocks (id == n_blocks) must not claim
                # the sentinel slot, which routes masked children to "dropped"
                pos_table = np.full(nb + 1, Bp, dtype=np.int64)
                real_par = par_ids < nb
                pos_table[par_ids[real_par]] = np.arange(len(par_ids))[real_par]
                self.anc_pos[(t, a)] = _put(
                    pos_table[np.minimum(anc_a, nb)], torch.long)
            self.seg_level.append(segs)
        self.child_table = child_tables(
            self.anc_pos, {k: staged[self.seg_level[k[0]][k[1]]]["rows"]
                           .shape[0] for k in self.anc_pos})
        # put_rows' tables: every level's rows in level order (gibbs_w,
        # prior_sample_w), every prediction bucket's (predict)
        self.level_rows = row_table(
            np.concatenate([s["rows"].reshape(-1) for s in staged]), n,
            self.device)
        self.pred_rows = (row_table(np.concatenate(
            [s["rows"].reshape(-1) for s in staged_pred]), n, self.device)
            if staged_pred else None)

    def tausq_long(self, tausq_inv):
        """(n+1,) per-row noise precision ((C, n+1) for (C, q) chains);
        sentinel slot = 0."""
        t = tausq_inv[..., self.mv]
        t[..., self.n].zero_()  # a kernel, where "= 0.0" copies from the host
        return t


def child_tables(anc_pos: dict, n_parents: dict) -> dict:
    """{(t, a): (Bp, K) int64}: row p lists, in ascending order, the
    children whose ``anc_pos[(t, a)]`` is p, padded with Bc (the index of
    a zero row appended to the children); children at the sentinel Bp =
    ``n_parents[(t, a)]`` are dropped.  ``_scatter_parents`` gathers
    through it and sums along K, an order that is the same in every run,
    where an ``index_add_`` on the card adds in whatever order its atomics
    land."""
    out = {}
    for key, pos_t in anc_pos.items():
        pos, Bp = pos_t.cpu().numpy(), n_parents[key]
        child = np.nonzero(pos < Bp)[0]  # ascending
        par = pos[child]
        order = np.argsort(par, kind="stable")
        child, par = child[order], par[order]
        counts = np.bincount(par, minlength=Bp)
        table = np.full((Bp, max(int(counts.max(initial=0)), 1)), len(pos),
                        dtype=np.int64)
        table[par, np.arange(len(par)) - (np.cumsum(counts) - counts)[par]] = \
            child
        out[key] = torch.as_tensor(table, device=pos_t.device)
    return out


def _tree_map(fn, *xs):
    """Apply ``fn`` to matching tensor leaves of nested tuples/NamedTuples
    (None leaves stay None)."""
    x = xs[0]
    if x is None:
        return None
    if isinstance(x, tuple):
        parts = [_tree_map(fn, *(y[i] for y in xs)) for i in range(len(x))]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return fn(*xs)


def _chains(x, nd: int) -> int:
    """Number of leading chain dimensions (0 or 1) of ``x``, whose
    single-chain rank is ``nd``."""
    return x.dim() - nd


def _bsel(x, idx, cb: int):
    """Gather along the block axis, which follows ``cb`` chain dims."""
    return x[(slice(None),) * cb + (idx,)]


def _csum(x, cb: int):
    """Total of ``x`` per chain (over everything for one chain)."""
    return torch.sum(x) if cb == 0 else x.flatten(cb).sum(-1)


def _call(x, cb: int):
    """All of ``x`` per chain: one chain's failed block rejects that
    chain's proposal alone."""
    return torch.all(x) if cb == 0 else x.flatten(cb).all(-1)


def _run_level(args, nc: int, carry, body, cb: int = 0, chained=()):
    """Run ``body(carry, args) -> (carry, outs)`` over the whole level
    (nc = 1) or over nc sequential slabs of its block axis, concatenating
    the slabs' outputs.  Sequential slabs bound peak device memory: the
    largest (B, P, P) transients exist for one slab at a time.  ``args[0]``
    is the level's LevelArrays; every tensor in ``args`` has the block axis
    first, except in the entries indexed by ``chained``, whose block axis
    follows ``cb`` chain dims, as does every output's."""
    if nc == 1:
        return body(carry, args)
    Bc = args[0].rows.shape[0] // nc
    outs = []
    for c in range(nc):
        sl = slice(c * Bc, (c + 1) * Bc)
        part = tuple(
            _tree_map(lambda a, i=i: _bsel(a, sl, cb if i in chained else 0),
                      x) for i, x in enumerate(args))
        carry, o = body(carry, part)
        outs.append(o)
    return carry, _tree_map(lambda *o: torch.cat(o, dim=cb), *outs)


def _apply_parent_factor(parent_joint, lp_pos, Kxc, gc: int,
                         aligned: bool = False, need_H: bool = True):
    """Conditional-mean machinery M = LAi Kxc, H = Kxc' LAi' LAi.

    With ``gc > 1`` the level is parent-major in groups of gc children, so
    the (P, P) parent joint factor is gathered once per parent and applied
    to all its children as one batched product with a (P, gc*S) right-hand
    side.  Returns (M, H, LAi); LAi is (B, P, P) for gc == 1 and (G, P, P)
    grouped otherwise.  ``need_H=False`` (decision-only sweep) returns None
    for H: the decision needs only M-derived forms.  A chain
    axis leads every tensor when ``Kxc`` has one."""
    B, P, S = Kxc.shape[-3:]
    pre = Kxc.shape[:-3]
    cb = len(pre)
    if gc <= 1:
        LAi = parent_joint if aligned else _bsel(parent_joint, lp_pos, cb)
        M = LAi @ Kxc
        H = torch.einsum("...bps,...bpq->...bsq", M, LAi) if need_H else None
        return M, H, LAi
    G = B // gc
    LAi = _bsel(parent_joint, lp_pos[::gc], cb)
    M4 = torch.einsum("...gpq,...gcqs->...gcps", LAi,
                      Kxc.reshape(*pre, G, gc, P, S))
    H = (torch.einsum("...gcps,...gpq->...gcsq", M4, LAi).reshape(
        *pre, B, S, P) if need_H else None)
    return M4.reshape(*pre, B, P, S), H, LAi


def _hw_from_M(M, LAi, wpar, gc: int):
    """Prior conditional mean H wpar = M' (LAi wpar) without forming H
    (exact: H = Kxc' LAi' LAi = M' LAi).  A chain axis leads every tensor
    when ``M`` has one."""
    B, P, S = M.shape[-3:]
    pre = tuple(M.shape[:-3])
    if gc <= 1:
        u = torch.einsum("...bpq,...bq->...bp", LAi, wpar)
        return torch.einsum("...bps,...bp->...bs", M, u)
    G = B // gc
    u = torch.einsum("...gpq,...gcq->...gcp", LAi,
                     wpar.reshape(*pre, G, gc, P))
    return torch.einsum("...gcps,...gcp->...gcs", M.reshape(*pre, G, gc, P, S),
                        u).reshape(*pre, B, S)


def _assemble_joint(LAi, Rinv, H, P, S, gc, pad: int = 0):
    """Joint inverse-Cholesky factor J = [[LAi, 0], [-Rinv H, Rinv]];
    ``pad > 0`` appends identity rows/cols (the aligned joint layout's
    sentinel tail): J_pad = [[J, 0], [0, I]].  A chain axis leads every
    tensor when ``Rinv`` has one."""
    B = Rinv.shape[-3]
    pre = tuple(Rinv.shape[:-3])
    if P == 0:
        J = Rinv
    else:
        LAi_b = LAi if gc <= 1 else LAi.unsqueeze(-3).expand(
            *pre, B // gc, gc, P, P).reshape(*pre, B, P, P)
        top = torch.cat([LAi_b, Rinv.new_zeros(pre + (B, P, S))], dim=-1)
        bot = torch.cat([-torch.einsum("...bst,...btp->...bsp", Rinv, H),
                         Rinv], dim=-1)
        J = torch.cat([top, bot], dim=-2)
    if pad:
        W = J.shape[-1]
        eye = torch.eye(pad, dtype=J.dtype, device=J.device).expand(
            pre + (B, pad, pad))
        J = torch.cat([
            torch.cat([J, J.new_zeros(pre + (B, W, pad))], dim=-1),
            torch.cat([J.new_zeros(pre + (B, pad, W)), eye], dim=-1),
        ], dim=-2)
    return J


def _composed_enabled() -> bool:
    """Gate of the parts-composed decision sweep
    (``SPAMTREE_COMPOSED_FACTORS``, default on), read at call time."""
    return os.environ.get("SPAMTREE_COMPOSED_FACTORS", "1") not in (
        "0", "false", "")


def _compose_children(ms: ModelStatic, t: int) -> bool:
    """May ref level ``t`` emit factor parts (LAi, H, Rinv) instead of its
    assembled joint J in the decision-only sweep?  True when every sweep
    consumer is a thin, parent-aligned, unchunked, ungrouped level whose
    parent layout is exactly [t's prows ; t's rows]: the child then applies
    J = [[LAi, 0], [-Rinv H, Rinv]] block by block and the (B, P+S, P+S)
    joint is never formed.  Limited trees keep their plain factor."""
    if ms.limited_tree or ms.level_chunks[t] != 1:
        return False
    consumers = [c for c in range(len(ms.levels)) if ms.level_lp[c] == t]
    if not consumers:
        return False
    P_t = ms.levels[t].prows.shape[1]
    S_t = ms.levels[t].rows.shape[1]
    return all(
        (not ms.level_is_ref[c])
        and ms.level_aligned[c]
        and ms.level_chunks[c] == 1
        and ms.level_group_c[c] <= 1
        and ms.levels[c].prows.shape[1] == P_t + S_t
        for c in consumers
    )


def _apply_parts_thin(parts, Kxc, wpar):
    """Thin-level decision quantities (hk, hw), both (B, S), from parent
    factor parts (LAi, H, Rinv, gc_p): LAi (B/gc_p, Pp, Pp) grouped by the
    parent's parent-major groups, H (B, Sp, Pp), Rinv (B, Sp, Sp); Kxc
    (B, P, S) with P = Pp + Sp rows ordered [parent's ancestors ; parent's
    rows].  Exactly J Kxc and M'(J wpar) for J = [[LAi, 0], [-Rinv H,
    Rinv]]:  M_top = LAi K_anc, M_bot = Rinv (K_par - H K_anc),
    hk = sum_p M_top^2 + sum_s M_bot^2, hw = M_top' u_top + M_bot' u_bot with
    u_top = LAi w_anc and u_bot = Rinv (w_par - H w_anc).  A chain axis
    leads every tensor when ``Kxc`` has one."""
    LAi, H, Rinv, gc_p = parts
    B, P, S = Kxc.shape[-3:]
    pre = tuple(Kxc.shape[:-3])
    Pp = 0 if LAi is None else LAi.shape[-1]
    K_anc, K_par = Kxc[..., :Pp, :], Kxc[..., Pp:, :]
    w_anc, w_par = wpar[..., :Pp], wpar[..., Pp:]
    if Pp == 0:
        # parent is the root level: J = Rinv alone
        M_bot = torch.einsum("...bst,...btu->...bsu", Rinv, K_par)
        hk = torch.sum(M_bot * M_bot, dim=-2)
        u_bot = torch.einsum("...bst,...bt->...bs", Rinv, w_par)
        return hk, torch.einsum("...bsu,...bs->...bu", M_bot, u_bot)
    if gc_p <= 1:
        M_top = torch.einsum("...bpq,...bqs->...bps", LAi, K_anc)
        u_top = torch.einsum("...bpq,...bq->...bp", LAi, w_anc)
    else:
        G = B // gc_p
        M_top = torch.einsum(
            "...gpq,...gcqs->...gcps", LAi,
            K_anc.reshape(*pre, G, gc_p, Pp, S)).reshape(*pre, B, Pp, S)
        u_top = torch.einsum(
            "...gpq,...gcq->...gcp", LAi,
            w_anc.reshape(*pre, G, gc_p, Pp)).reshape(*pre, B, Pp)
    HK = torch.einsum("...bsp,...bpt->...bst", H, K_anc)
    M_bot = torch.einsum("...bst,...btu->...bsu", Rinv, K_par - HK)
    hk = torch.sum(M_top * M_top, dim=-2) + torch.sum(M_bot * M_bot, dim=-2)
    u_bot = torch.einsum("...bst,...bt->...bs", Rinv,
                         w_par - torch.einsum("...bsp,...bp->...bs", H, w_anc))
    hw = (torch.einsum("...bps,...bp->...bs", M_top, u_top)
          + torch.einsum("...bsu,...bs->...bu", M_bot, u_bot))
    return hk, hw


def _wpar_from(wj_src, lp_pos, al: bool, gc: int):
    """wpar (B, P) for a level as a row gather of its parent level's joint w
    rows (``prows[b] == joint_rows[lp][lp_pos[b]]``), or a direct read on
    aligned levels.  ``wj_src`` is (B', W), or (C, B', W) with chains."""
    if al:
        return wj_src
    cb = _chains(wj_src, 2)
    if gc > 1:
        # parent-major groups share their leader's parent pointers
        G = lp_pos.shape[0] // gc
        W = wj_src.shape[-1]
        lead = _bsel(wj_src, lp_pos[::gc], cb)
        return lead.unsqueeze(-2).expand(
            *wj_src.shape[:cb], G, gc, W).reshape(*wj_src.shape[:cb], -1, W)
    return _bsel(wj_src, lp_pos, cb)


def _shard_of(ms: ModelStatic, x, t: int, cb: int = 0, pred: bool = False):
    """This rank's blocks of ``x``, a tensor over the whole padded level
    ``t`` (prediction bucket ``t`` with ``pred``) whose block axis follows
    ``cb`` chain dims; ``x`` itself without a mesh."""
    if ms.mesh is None:
        return x
    lvl, off = ((ms.pred_arrays[t], ms.pred_off[t]) if pred
                else (ms.levels[t], ms.level_off[t]))
    return x.narrow(cb, off, lvl.rows.shape[0])


def _wj_src(ms: ModelStatic, wjs: dict, t: int, pred: bool = False):
    """The parent's joint w rows that level ``t`` (bucket ``t`` with
    ``pred``) reads through ``_wpar_from``: the whole parent level (``wjs``
    holds whole levels), or this rank's parent shard of it when the level
    reads its parent locally."""
    lp = ms.pred_lp if pred else ms.level_lp[t]
    src = wjs[lp]
    if ms.mesh is None or not (ms.pred_local[t] if pred
                               else ms.level_local[t]):
        return src
    return src.narrow(_chains(src, 2), ms.level_off[lp],
                      ms.levels[lp].rows.shape[0])


def _wj_parents_needed(ms: ModelStatic) -> set:
    """Transitive closure of levels whose joint w rows feed some sweep
    level's wpar (gibbs_w / the quad sweep)."""
    need = set()
    stack = [ms.level_lp[t] for t in range(len(ms.levels))
             if ms.levels[t].prows.shape[1] > 0]
    while stack:
        t = stack.pop()
        if t < 0 or t in need:
            continue
        need.add(t)
        if ms.levels[t].prows.shape[1] > 0:
            stack.append(ms.level_lp[t])
    return need


def _w_joints(ms: ModelStatic, w, need: set) -> dict:
    """Per-parent-level joint w rows {t: (B, W)} built root->leaf through the
    recursive layout (see _wpar_from); (C, B, W) with chains.  Over whole
    levels on a blocks mesh too: w is replicated, so no rank needs another's
    rows."""
    wjs = {}
    for t in sorted(need):
        lvl = ms.levels_full[t]
        w_r = w[..., lvl.rows]
        if ms.limited_tree:
            # limited trees: children condition on the parent's rows alone
            wjs[t] = w_r
            continue
        if lvl.prows.shape[1] == 0:
            wj = w_r
        else:
            wpar = _wpar_from(wjs[ms.level_lp[t]], lvl.lp_pos,
                              ms.level_aligned[t], ms.level_group_c[t])
            wj = torch.cat([wpar, w_r], dim=-1)
        if ms.joint_pad[t]:
            # sentinel tail of the aligned joint layout: w[n] == 0
            wj = torch.cat([wj, wj.new_zeros(wj.shape[:-1]
                                             + (ms.joint_pad[t],))], dim=-1)
        wjs[t] = wj
    return wjs


def level_coords(ms: ModelStatic):
    """Per-level (coords[rows], mv[rows], coords[prows], mv[prows]) plus the
    prediction buckets' -- the static gathers of every sweep, built once
    per run and passed to ``sweep``/``pred_operators_from_joint``."""
    lvls = []
    for lvl in ms.levels:
        P = lvl.prows.shape[1]
        lvls.append((ms.coords[lvl.rows], ms.mv[lvl.rows],
                     ms.coords[lvl.prows] if P > 0 else None,
                     ms.mv[lvl.prows] if P > 0 else None))
    pred = [(ms.coords[lvl.rows], ms.mv[lvl.rows], ms.coords[lvl.prows],
             ms.mv[lvl.prows]) for lvl in (ms.pred_arrays or [])]
    return tuple(lvls), tuple(pred)


def _bcov(ms: ModelStatic, params, cx1, mv1, cx2, mv2, m1=None, m2=None,
          eye=False):
    """Pairwise covariance over a leading block-batch axis, masked by
    ``m1`` x ``m2`` or identity-padded by ``m1`` (``eye``): kernel K6 on
    the card (``ops.covariance.cov_block``).  The formula is this module's
    ``pairwise_cov``, looked up at each call, so a fault control that
    rebinds it reaches every block."""
    return cov_block(cx1, mv1, cx2, mv2, params, ms.spec, m1, m2, eye,
                     pairwise_cov)


def sweep(ms: ModelStatic, theta, w, build_pred: bool = True,
          quad_prev: tuple | None = None, emit_pred_joint: bool = False,
          decision_only: bool = False, coords_cache=None):
    """Full root->leaf likelihood sweep for a theta value.

    Returns (leveldata tuple, pred_data, logdetCi scalar, ok flag), with the
    propagated identity-padded joint inverse-Cholesky factors replacing the
    reference's nested-ancestor update (spamtree_model.cpp:900-907).

    With ``quad_prev=prev_leveldata`` it also returns ``(quad_new,
    quad_cur)``: the -0.5 w'Ci w quadratic forms under the new factors and
    under ``prev_leveldata``.  ``emit_pred_joint=True`` returns the raw
    deepest-reference joint factor as pred_data, so the MCMC step builds the
    prediction operators only on accept.

    ``decision_only=True`` (requires quad_prev) returns only ``(logdet, ok,
    quad_new, quad_cur)``: no leveldata or prediction operators, H and prec
    are never formed (M-derived forms replace them), joint factors go only
    to levels that later sweep levels consume, and a reference level whose
    consumers allow it passes them factor parts (``_compose_children``).

    Batched chains: theta (C, n_theta) and w (C, n+1) (``quad_prev`` with
    (C, B, ...) leaves) give (C,) logdet, ok and quadratic forms, each over
    its own chain's blocks only, ``decision_only`` included: factor parts
    carry the chain axis, and K4 runs each thin level for all chains in one
    launch (``level_ops.thin_decision_chains``).

    On a blocks mesh (``shard_model``) each rank sweeps its shard of every
    level: the leveldata and prediction operators it returns are its
    shard's, a parent joint factor is gathered whole for children that
    index it through lp_pos (aligned children read their own shard of it),
    and logdet, ok and the quadratic forms are reduced over the ranks."""
    if decision_only:
        assert quad_prev is not None, "decision_only requires quad_prev"
    cb = _chains(theta, 1)
    pre = tuple(theta.shape[:-1])
    params = unpack_theta(theta.to(ms.dtype), ms.spec)
    leveldata = []
    zero = torch.zeros(pre, dtype=ms.dtype, device=ms.device)
    logdet, qn, qc = zero, zero, zero
    ok = torch.ones(pre, dtype=torch.bool, device=ms.device)
    joints = {}
    joints_whole = {}  # a blocks mesh's gathered parent factors
    wjs = {}  # joint w rows per parent level (see _wpar_from)
    wj_need = _wj_parents_needed(ms) if quad_prev is not None else set()
    if ms.mesh is not None:
        # over whole levels, up front: children index them through lp_pos
        wjs = _w_joints(ms, w, wj_need)

    def drop_consumed(t):
        # drop joint factors whose last consumer has now run
        for k in [k for k, last in ms.last_consumer.items() if last == t]:
            joints.pop(k, None)
            joints_whole.pop(k, None)
            wjs.pop(k, None)

    for t, lvl_full in enumerate(ms.levels):
        P = lvl_full.prows.shape[1]
        S_lvl = lvl_full.rows.shape[1]
        is_ref = ms.level_is_ref[t]
        gc = ms.level_group_c[t]
        al = ms.level_aligned[t]
        emit_joint = is_ref and (ms.serves_as_sweep_parent[t] if decision_only
                                 else ms.serves_as_parent[t])
        parent_joint = (_parent_factor(
            ms, joints_whole, ms.level_lp[t], joints.get(ms.level_lp[t]),
            ms.level_local[t], cb) if P > 0 else None)
        prev_t = quad_prev[t] if quad_prev is not None else None
        if coords_cache is not None:
            cx = coords_cache[0][t]
        else:
            cx = (ms.coords[lvl_full.rows], ms.mv[lvl_full.rows],
                  ms.coords[lvl_full.prows] if P > 0 else None,
                  ms.mv[lvl_full.prows] if P > 0 else None)
        w_r_full = wpar_full = None
        if quad_prev is not None:
            w_r_full = w[..., lvl_full.rows]
            if P > 0:
                wpar_full = _wpar_from(_wj_src(ms, wjs, t), lvl_full.lp_pos,
                                       al, gc)
            if is_ref and t in wj_need and ms.mesh is None:
                wj = (w_r_full if ms.limited_tree or wpar_full is None
                      else torch.cat([wpar_full, w_r_full], dim=-1))
                if ms.joint_pad[t]:
                    wj = torch.cat([wj, wj.new_zeros(
                        wj.shape[:-1] + (ms.joint_pad[t],))], -1)
                wjs[t] = wj
        # decision mode: factor parts instead of the assembled joint when
        # every consumer can apply them block by block
        compose = (decision_only and emit_joint and _composed_enabled()
                   and _compose_children(ms, t))

        if (decision_only and not is_ref and P > 0 and gc <= 1
                and ms.level_chunks[t] == 1 and parent_joint is not None):
            parts = isinstance(parent_joint, tuple)
            kernel_ok = (not parts and P <= level_ops.MAX_P
                         and S_lvl <= level_ops.MAX_S
                         and level_ops.use_level_kernels())
            if kernel_ok or parts:
                lvl = lvl_full
                cxr, mvr, cxp, mvp = cx
                Kxc = _bcov(ms, params, cxp, mvp, cxr, mvr, lvl.pmask,
                            lvl.rmask)
                kdiag = pairwise_cov_diag(cxr, mvr, params, ms.spec)
                if parts:
                    # composed parts: thin-level decision without the joint
                    hk, hw = _apply_parts_thin(parent_joint, Kxc, wpar_full)
                    r = torch.where(lvl.rmask, kdiag - hk, 1.0)
                    okl = torch.isfinite(r) & (r > 0)
                    ok = ok & _call(okl, cb)
                    r = torch.where(okl, r, 1.0)
                    logdet = logdet - 0.5 * _csum(
                        torch.where(lvl.rmask, torch.log(r), 0.0), cb)
                    wx = w_r_full - hw
                    qn = qn - 0.5 * _csum(wx * wx / r, cb)
                    wxc = w_r_full - torch.einsum("...bsp,...bp->...bs",
                                                  prev_t.H, wpar_full)
                    qc = qc - 0.5 * _csum(prev_t.prec * wxc * wxc, cb)
                else:
                    # fused thin-level kernel K4: the whole level's decision
                    # quantities in one launch, for every chain
                    k4 = (level_ops.thin_decision_chains if cb
                          else level_ops.thin_decision_level)
                    ld_b, ok_b, qn_b, qc_b = k4(
                        Kxc.contiguous(), parent_joint.contiguous(),
                        lvl.lp_pos,
                        wpar_full.contiguous(), w_r_full.contiguous(),
                        prev_t.H.contiguous(), prev_t.prec.contiguous(),
                        kdiag.contiguous(), lvl.rmask.to(ms.dtype),
                        aligned=al)
                    logdet = logdet + ld_b
                    ok = ok & ok_b
                    qn = qn + qn_b
                    qc = qc + qc_b
                drop_consumed(t)
                continue

        def level_body(carry, args, P=P, is_ref=is_ref, emit_joint=emit_joint,
                       parent_joint=parent_joint, gc=gc, al=al,
                       compose=compose, jpad=ms.joint_pad[t]):
            logdet, ok, qn, qc = carry
            lvl, prev, w_r, wpar, cxr, mvr, cxp, mvp = args
            B, S = lvl.rows.shape
            need_H = (not decision_only) or emit_joint
            if P > 0:
                Kxc = _bcov(ms, params, cxp, mvp, cxr, mvr, lvl.pmask,
                            lvl.rmask)
                M, H, LAi = _apply_parent_factor(parent_joint, lvl.lp_pos,
                                                 Kxc, gc, al, need_H)
                hw = hw_prev = None
                if quad_prev is not None:
                    # the prior mean goes through M when H was not formed
                    hw = (torch.einsum("...bsp,...bp->...bs", H, wpar)
                          if H is not None else _hw_from_M(M, LAi, wpar, gc))
                    hw_prev = torch.einsum("...bsp,...bp->...bs", prev.H,
                                           wpar)
            else:
                Kxc = M = LAi = None
                H = ms.X.new_zeros(pre + (B, S, 0))
                hw = hw_prev = 0.0

            if is_ref:
                # identity-padded; chol_inv_masked pads what it takes
                # again, so the limited tree's factor of Kcc below gets
                # the raw block's bits
                Kcc = _bcov(ms, params, cxr, mvr, cxr, mvr, lvl.rmask,
                            eye=True)
                Rcc = Kcc
                if P > 0:
                    Rcc = Kcc - torch.einsum("...bps,...bpt->...bst", M, M)
                use_k = ms.use_kernel and S <= max_s(ms.dtype)
                _, Rinv, okl = chol_inv_masked(Rcc, lvl.rmask, use_k)
                logdet = logdet + _csum(
                    torch.log(torch.diagonal(Rinv, dim1=-2, dim2=-1)), cb)
                ok = ok & _call(okl, cb)
                if quad_prev is not None:
                    v = torch.einsum("...bst,...bt->...bs", Rinv, w_r - hw)
                    qn = qn - 0.5 * _csum(v * v, cb)
                    wxc = w_r - hw_prev
                    qc = qc - 0.5 * torch.einsum("...bs,...bst,...bt->...",
                                                 wxc, prev.prec, wxc)
                J = None
                if emit_joint and not compose:
                    if ms.limited_tree:
                        # limited tree: children condition on this block's
                        # rows alone, so the factor is the inverse Cholesky
                        # factor of Kcc (reference: .cpp:901-903)
                        _, J, okp = chol_inv_masked(Kcc, lvl.rmask, use_k)
                        ok = ok & _call(okp, cb)
                    else:
                        J = _assemble_joint(LAi, Rinv, H, P, S, gc, pad=jpad)
                if decision_only:
                    if compose:
                        outs = (LAi, H, Rinv)
                    else:
                        outs = (J,) if emit_joint else ()
                    return (logdet, ok, qn, qc), outs
                prec = torch.einsum("...bks,...bkt->...bst", Rinv, Rinv)
                outs = (H, prec, J) if emit_joint else (H, prec)
                return (logdet, ok, qn, qc), outs
            kdiag = pairwise_cov_diag(cxr, mvr, params, ms.spec)
            if P == 0:
                hk = 0.0
            elif H is not None:
                hk = torch.einsum("...bsp,...bps->...bs", H, Kxc)
            else:
                hk = torch.sum(M * M, dim=-2)  # diag(M'M)
            r = torch.where(lvl.rmask, kdiag - hk, 1.0)
            okl = torch.isfinite(r) & (r > 0)
            ok = ok & _call(okl, cb)
            r = torch.where(okl, r, 1.0)
            logdet = logdet - 0.5 * _csum(
                torch.where(lvl.rmask, torch.log(r), 0.0), cb)
            if quad_prev is not None:
                wx = w_r - hw
                qn = qn - 0.5 * _csum(wx * wx / r, cb)
                wxc = w_r - hw_prev
                qc = qc - 0.5 * _csum(prev.prec * wxc * wxc, cb)
            if decision_only:
                return (logdet, ok, qn, qc), ()
            return (logdet, ok, qn, qc), (H, 1.0 / r)

        args = (lvl_full, prev_t, w_r_full, wpar_full, *cx)
        (logdet, ok, qn, qc), outs = _run_level(
            args, ms.level_chunks[t], (logdet, ok, qn, qc), level_body,
            cb, chained=(1, 2, 3))
        if decision_only:
            if compose:
                joints[t] = (*outs, gc)  # (LAi, H, Rinv, gc_p) parts
            elif emit_joint:
                joints[t] = outs[0]
        else:
            if emit_joint:
                joints[t] = outs[2]
            leveldata.append(LevelData(H=outs[0], prec=outs[1]))
        drop_consumed(t)

    if ms.mesh is not None:
        # sums over all blocks, added in rank order on every rank
        logdet, qn, qc = ms.mesh.sum_blocks(torch.stack([logdet, qn, qc]))
        ok = ms.mesh.all_blocks(ok)
    if decision_only:
        return logdet, ok, qn, qc
    # prediction operators for the all-missing blocks, from the deepest
    # reference joint factor while it is live (none carried when they are
    # too big: predict_recompute rebuilds them); a blocks mesh's rank keeps
    # its shard of the factor
    pred_data = None
    if ms.pred_arrays is not None and ms.pred_in_carry and build_pred:
        pj = joints.get(ms.pred_lp)
        pred_data = pj if emit_pred_joint else _pred_operators(
            ms, params, pj, coords_cache)
    if quad_prev is not None:
        return tuple(leveldata), pred_data, logdet, ok, qn, qc
    return tuple(leveldata), pred_data, logdet, ok


def pred_operators_from_joint(ms: ModelStatic, theta, parent_joint,
                              coords_cache=None) -> tuple:
    """Prediction (H, r) operators from a theta and the raw deepest-reference
    joint factor emitted by ``sweep(emit_pred_joint=True)``; per chain
    for (C, n_theta) theta and a (C, B, P, P) factor."""
    return _pred_operators(ms, unpack_theta(theta.to(ms.dtype), ms.spec),
                           parent_joint, coords_cache)


def _parent_factor(ms: ModelStatic, cache: dict, lp: int, J, local: bool,
                   cb: int):
    """The joint factor ``J`` of parent level ``lp`` as a child level reads
    it: ``J`` itself without a mesh, for factor parts (aligned children
    only) and where the child's parents all sit on this rank (``local``),
    else the whole level, gathered over the blocks ranks at its first use
    and kept in ``cache``."""
    if ms.mesh is None or J is None or isinstance(J, tuple) or local:
        return J
    if lp not in cache:
        cache[lp] = ms.mesh.cat_blocks(J, cb)
    return cache[lp]


def _pred_operators(ms: ModelStatic, params, parent_joint,
                    coords_cache=None) -> tuple:
    """Per-bucket (H, r) conditional operators for the prediction blocks;
    the LevelData ``prec`` slot holds the variance r."""

    cb = _chains(params.ai1, 1)
    gathered = {}

    def pred_body(carry, args, al=False, loc=True):
        lvl, cxr, mvr, cxp, mvp = args
        Kxc = _bcov(ms, params, cxp, mvp, cxr, mvr, lvl.pmask, lvl.rmask)
        _, H, _ = _apply_parent_factor(
            _parent_factor(ms, gathered, ms.pred_lp, parent_joint, loc, cb),
            lvl.lp_pos, Kxc, 1, al)
        kdiag = pairwise_cov_diag(cxr, mvr, params, ms.spec)
        r = kdiag - torch.einsum("...bsp,...bps->...bs", H, Kxc)
        # chol failure -> deterministic mean (reference: .cpp:1316-1322)
        r = torch.where(torch.isfinite(r) & (r > 0), r, 0.0)
        return carry, (H, r)

    out = []
    for bi, (plvl, nc, al) in enumerate(
            zip(ms.pred_arrays, ms.pred_chunks, ms.pred_aligned)):
        if coords_cache is not None:
            cx = coords_cache[1][bi]
        else:
            cx = (ms.coords[plvl.rows], ms.mv[plvl.rows],
                  ms.coords[plvl.prows], ms.mv[plvl.prows])
        _, (Hp, rp) = _run_level(
            (plvl, *cx), nc, None,
            lambda c, a, al=al, loc=ms.pred_local[bi]: pred_body(c, a, al,
                                                                 loc), cb)
        out.append(LevelData(H=Hp, prec=rp))
    return tuple(out)


def quad_loglik(ms: ModelStatic, leveldata, w):
    """-0.5 times the sum of the blocks' quadratic forms of w under the
    stored factors: ``get_loglik_w_std`` less its theta-independent
    constant (reference: spamtree_model.cpp:781-826).  One per chain for
    (C, n+1) w and (C, B, ...) factors."""
    cb = _chains(w, 1)
    total = w.new_zeros(w.shape[:-1])
    for t, lvl in enumerate(ms.levels):
        data = leveldata[t]
        w_x = w[..., lvl.rows]
        if lvl.prows.shape[1] > 0:
            w_x = w_x - torch.einsum("...bsp,...bp->...bs", data.H,
                                     w[..., lvl.prows])
        if ms.level_is_ref[t]:
            total = total - 0.5 * torch.einsum("...bs,...bst,...bt->...",
                                               w_x, data.prec, w_x)
        else:
            total = total - 0.5 * _csum(data.prec * w_x * w_x, cb)
    return total if ms.mesh is None else ms.mesh.sum_blocks(total)


def msg_gram(ms: ModelStatic, leveldata):
    """Per-segment Gibbs-message Gram blocks G_aa = H_a' prec H_a: functions
    of the stored factors alone, so the sampler recomputes them only when a
    theta proposal is accepted.  Returns a tuple over levels of tuples over
    ancestor segments of (B, s_a, s_a) tensors."""
    out = []
    for t, lvl in enumerate(ms.levels):
        data = leveldata[t]
        if lvl.prows.shape[1] == 0:
            out.append(())
            continue
        Gs = []
        for o, sa in zip(*ms.level_segs[t]):
            H_a = data.H[:, :, o : o + sa]
            if ms.level_is_ref[t]:
                t_a = torch.einsum("bst,btq->bsq", data.prec, H_a)
            else:
                t_a = data.prec[:, :, None] * H_a
            Gs.append(torch.einsum("bsp,bsq->bpq", H_a, t_a))
        out.append(tuple(Gs))
    return tuple(out)


def _msg_level(ms: ModelStatic, tp: int) -> LevelArrays:
    """The blocks a rank's message buffer of level ``tp`` spans: its own
    shard when every message to tp comes from its own children, else the
    whole level (summed over the ranks before tp is sampled)."""
    return (ms.levels if ms.msg_local[tp] else ms.levels_full)[tp]


def _scatter_parents(ms: ModelStatic, t: int, a: int, x, cb: int = 0):
    """Sum child rows ``x`` (Bc, ...) into their segment-a parents: (Bp,
    ...), dropped children left out.  A gather through the padded child
    table (``child_tables``) and a sum along it, so the children are added
    in the same order in every run.  With ``cb`` chain dims ahead of the
    block axis the sum runs along it, for every chain at once."""
    table = ms.child_table[(t, a)]
    lead, rest = tuple(x.shape[:cb]), tuple(x.shape[cb + 1:])
    xz = torch.cat([x, x.new_zeros(lead + (1,) + rest)], dim=cb)
    return xz.index_select(cb, table.reshape(-1)).reshape(
        lead + tuple(table.shape) + rest).sum(cb + 1)


def _route_messages(ms: ModelStatic, acc: dict, t: int, outs,
                    vs_only: bool = False):
    """Route a level's per-segment Gibbs messages (Gs, vs) into the parent
    levels' accumulators {tp: (Sigi (Bp, Sp, Sp) or None, Smu (Bp, Sp))}.
    ``vs_only`` routes only the w-dependent means (the Gram halves come
    precomputed from route_gram).  Chains lead every tensor with their
    axis."""
    Gs, vs = outs
    pre = tuple(vs[0].shape[:-2]) if vs else ()
    cb = len(pre)
    for a in range(len(vs)):
        tp = ms.seg_level[t][a]
        Bp, Sp = _msg_level(ms, tp).rows.shape
        if tp not in acc:
            acc[tp] = (None if vs_only else ms.X.new_zeros(pre + (Bp, Sp, Sp)),
                       ms.X.new_zeros(pre + (Bp, Sp)))
        add_m = _scatter_parents(ms, t, a, vs[a], cb)
        if vs_only:
            acc[tp] = (None, acc[tp][1] + add_m)
        else:
            acc[tp] = (acc[tp][0] + _scatter_parents(ms, t, a, Gs[a], cb),
                       acc[tp][1] + add_m)


def route_gram(ms: ModelStatic, gram):
    """Per-parent-level sums of the routed Gibbs-message Gram blocks (the
    w-independent half of gibbs_w's child->parent Sigi accumulation),
    refreshed with msg_gram on theta accept.  Returns a tuple over levels:
    (Bp, Sp, Sp) for levels that receive messages, () otherwise.  On a
    blocks mesh each rank routes its children, and gets its parents' rows
    of the sum over the ranks."""
    acc = {}
    for t in reversed(range(len(ms.levels))):
        if ms.levels[t].prows.shape[1] == 0:
            continue
        for a, G in enumerate(gram[t]):
            tp = ms.seg_level[t][a]
            add = _scatter_parents(ms, t, a, G)
            acc[tp] = acc[tp] + add if tp in acc else add
    if ms.mesh is not None:
        acc = {tp: (v if ms.msg_local[tp]
                    else _shard_of(ms, ms.mesh.sum_blocks(v), tp))
               for tp, v in sorted(acc.items())}
    return tuple(acc.get(t, ()) for t in range(len(ms.levels)))


def gram_full(ms: ModelStatic, leveldata):
    """(msg_gram, route_gram) pair -- the accept-refreshed carried state."""
    g = msg_gram(ms, leveldata)
    return g, route_gram(ms, g)


def gibbs_w(ms: ModelStatic, leveldata, w, tausq_inv, XB, z, y=None,
            gram=None, routed=None):
    """Leaf->root blocked Gibbs update of w with child->parent message
    accumulation (reference: gibbs_sample_w_std, spamtree_model.cpp:1011-1226).

    ``z`` is the (n+1,) standard-normal draw.  ``gram`` (msg_gram) and
    ``routed`` (route_gram), refreshed on theta accept, supply the message
    Gram blocks and their per-level sums; without them they are formed in
    place.  Returns a new w; the input is not modified.

    Batched chains: leveldata with (C, B, ...) leaves, w, XB and z (C, n+1),
    tausq_inv (C, q), and no gram (formed in place, as the JAX package's
    vmapped chains do).

    On a blocks mesh each rank samples its shard of every level: the
    messages a level receives are summed over the ranks before it is
    sampled, and the sampled rows go to every rank at the end, so every
    rank returns the whole new w.

    No level reads w after the joint rows are built up front, so every
    level's draws are written at the end, at once (``put_rows``)."""
    if routed is not None:
        assert gram is not None, "routed requires the matching gram blocks"
    if y is None:
        y = ms.y
    cb = _chains(w, 1)
    assert not (cb and gram is not None), "batched chains carry no gram"
    pre = tuple(w.shape[:-1])
    tl = ms.tausq_long(tausq_inv)
    acc = {}  # per-parent-level accumulated messages {t: (Sigi, Smu)}
    # every wpar read sees pre-pass ancestor values (deeper updates never
    # touch shallower rows), so the joint w rows are built once up front
    wjs = _w_joints(ms, w, _wj_parents_needed(ms))
    aux = torch.stack([tl, tl * (y - XB), z], dim=-1)  # (..., n+1, 3)
    wus = {}  # each level's draws

    for t in reversed(range(len(ms.levels))):
        lvl_full = ms.levels[t]
        P = lvl_full.prows.shape[1]
        is_ref = ms.level_is_ref[t]
        seg_off, seg_size = ms.level_segs[t]
        acc_t = acc.pop(t, None)
        if ms.mesh is not None and acc_t is not None and not ms.msg_local[t]:
            # every rank's children's messages, summed; this rank's rows
            acc_t = tuple(None if a is None else _shard_of(
                ms, ms.mesh.sum_blocks(a), t, cb) for a in acc_t)
        if routed is not None and is_ref and not isinstance(routed[t], tuple):
            # precomputed Sigi message sum; acc carries only the Smu half
            acc_t = (routed[t], acc_t[1] if acc_t is not None
                     else ms.X.new_zeros(lvl_full.rows.shape))
        gram_t = gram[t] if gram is not None and P > 0 else None
        wj_src = _wj_src(ms, wjs, t) if P > 0 else None

        if (not is_ref and P > 0 and ms.level_chunks[t] == 1 and acc_t is None
                and gram_t is not None and P <= level_ops.MAX_P
                and lvl_full.rows.shape[1] <= level_ops.MAX_S
                and level_ops.use_level_kernels()):
            # fused thin-level kernel K3: prior mean, posterior draw and the
            # full parent message vector in one launch; the per-segment Gram
            # additions and the routing stay outside
            assert ms.level_group_c[t] == 1, "thin levels are never grouped"
            lvl, data = lvl_full, leveldata[t]
            wpar = _wpar_from(wj_src, lvl.lp_pos, ms.level_aligned[t], 1)
            ti, resid, zz = (a.contiguous() for a in aux[lvl.rows].unbind(-1))
            wu, msg_full = level_ops.thin_gibbs_level(
                data.H.contiguous(), data.prec.contiguous(),
                wpar.contiguous(), zz, ti, resid, lvl.rmask.to(ms.dtype))
            wus[t] = wu
            vs = tuple(msg_full[:, o : o + sa] + torch.einsum(
                "bpq,bq->bp", gram_t[a], wpar[:, o : o + sa])
                for a, (o, sa) in enumerate(zip(seg_off, seg_size)))
            _route_messages(ms, acc, t, (gram_t, vs),
                            vs_only=routed is not None)
            continue

        def level_body(carry, args, P=P, is_ref=is_ref, wj_src=wj_src,
                       al=ms.level_aligned[t], gc=ms.level_group_c[t]):
            lvl, data, acc_sl, gram_sl = args
            B, S = lvl.rows.shape
            wpar = _wpar_from(wj_src, lvl.lp_pos, al, gc) if P > 0 else None
            ti, resid, zz = aux[..., lvl.rows, :].unbind(-1)
            hw_prior = (torch.einsum("...bsp,...bp->...bs", data.H, wpar)
                        if P > 0 else ms.X.new_zeros(pre + (B, S)))
            if is_ref:
                Sigi = data.prec + ti[..., None] * torch.eye(
                    S, dtype=ms.dtype, device=ms.device)
                Smu = torch.einsum("...bst,...bt->...bs", data.prec,
                                   hw_prior) + resid
                if acc_sl is not None:
                    if acc_sl[0] is not None:
                        Sigi = Sigi + acc_sl[0]
                    Smu = Smu + acc_sl[1]
                if ms.use_kernel and S <= max_s(ms.dtype):
                    _, Lci, _ = chol_inv_masked(Sigi, lvl.rmask, True)
                    tmp = torch.einsum("...bst,...bt->...bs", Lci, Smu)
                    wu = torch.einsum("...bts,...bt->...bs", Lci, tmp + zz)
                else:
                    Lg, _ = chol_masked(Sigi, lvl.rmask)
                    tmp = tri_solve(Lg, Smu[..., None])
                    wu = tri_solve(Lg, tmp + zz[..., None], trans=True)[..., 0]
            else:
                sig = data.prec + ti
                wu = (data.prec * hw_prior + resid) / sig + zz / torch.sqrt(sig)
            wu = torch.where(lvl.rmask, wu, 0.0)
            if P == 0:
                return carry, (wu,)
            # messages to every ancestor (reference: .cpp:1158-1210):
            # msg_full = H' prec (w_u - H w_par) as two products; ancestor
            # a's rows are the static slice [off_a, off_a + s_a) of wpar
            diff = wu - hw_prior
            v = (torch.einsum("...bst,...bt->...bs", data.prec, diff)
                 if is_ref else data.prec * diff)
            msg_full = torch.einsum("...bsp,...bs->...bp", data.H, v)
            Gs, vs = [], []
            for a, (o, sa) in enumerate(zip(seg_off, seg_size)):
                if gram_sl is not None:
                    G_aa = gram_sl[a]
                else:
                    H_a = data.H[..., o : o + sa]
                    t_a = (torch.einsum("...bst,...btq->...bsq", data.prec,
                                        H_a)
                           if is_ref else data.prec[..., None] * H_a)
                    G_aa = torch.einsum("...bsp,...bsq->...bpq", H_a, t_a)
                vs.append(msg_full[..., o : o + sa] + torch.einsum(
                    "...bpq,...bq->...bp", G_aa, wpar[..., o : o + sa]))
                Gs.append(G_aa)
            return carry, (wu, tuple(Gs), tuple(vs))

        _, (wus[t], *outs) = _run_level(
            (lvl_full, leveldata[t], acc_t, gram_t), ms.level_chunks[t],
            None, level_body, cb, chained=(1, 2, 3))
        if P > 0:
            _route_messages(ms, acc, t, outs, vs_only=routed is not None)
    # on a blocks mesh every rank's sampled rows, one gather for all levels
    return put_rows(ms, w, [wus[t] for t in range(len(ms.levels))],
                    ms.level_rows)


def _wj_pred_need(ms: ModelStatic) -> set:
    """Ancestor chain of the prediction levels (for _w_joints)."""
    need = set()
    t = ms.pred_lp
    while t >= 0 and t not in need:
        need.add(t)
        t = ms.level_lp[t] if ms.levels[t].prows.shape[1] > 0 else -1
    return need


def predict(ms: ModelStatic, pred_data, w, z):
    """Conditional-normal draws at all-missing blocks (reference:
    predict_std, spamtree_model.cpp:1234-1358): w = H w_par + sqrt(r) z per
    prediction block, ``z`` the (n+1,) standard-normal draw.  Returns a new
    w; the input is not modified.  Chains: (C, ...) operators, w and z."""
    if ms.pred_arrays is None or pred_data is None:
        return w
    wjs = _w_joints(ms, w, _wj_pred_need(ms))
    wus = []
    for bi, (lvl, pd, al) in enumerate(zip(ms.pred_arrays, pred_data,
                                           ms.pred_aligned)):
        wpar = _wpar_from(_wj_src(ms, wjs, bi, pred=True), lvl.lp_pos, al, 1)
        mean = torch.einsum("...bsp,...bp->...bs", pd.H, wpar)
        wus.append(torch.where(
            lvl.rmask, mean + torch.sqrt(pd.prec) * z[..., lvl.rows], 0.0))
    return put_rows(ms, w, wus, ms.pred_rows)


def _joints_upto(ms: ModelStatic, params, upto: int, coords_cache=None):
    """The joint inverse-Cholesky factor of reference level ``upto`` alone
    (this rank's shard on a blocks mesh), re-propagated through the
    reference levels 0..upto (no H, prec or loglik) -- for
    predict_recompute.  On a limited tree a level's factor
    is that of its own Kcc, so only level ``upto`` is factored (the JAX
    package's loop over the ancestors is dead code there, which XLA
    drops).  Per chain for chain-batched ``params``."""
    use_k = ms.use_kernel
    cb = _chains(params.ai1, 1)
    joints, gathered = {}, {}
    for t in ([upto] if ms.limited_tree else range(upto + 1)):
        assert ms.level_is_ref[t], "prediction ancestors must be ref levels"
        lvl_full = ms.levels[t]
        P = lvl_full.prows.shape[1] if not ms.limited_tree else 0
        gc = ms.level_group_c[t]
        parent_joint = (_parent_factor(
            ms, gathered, ms.level_lp[t], joints.get(ms.level_lp[t]),
            ms.level_local[t], cb) if P > 0 else None)
        if coords_cache is not None:
            cx = coords_cache[0][t]
        else:
            cx = (ms.coords[lvl_full.rows], ms.mv[lvl_full.rows],
                  ms.coords[lvl_full.prows] if P > 0 else None,
                  ms.mv[lvl_full.prows] if P > 0 else None)

        def body(carry, args, P=P, parent_joint=parent_joint, gc=gc,
                 al=ms.level_aligned[t], jpad=ms.joint_pad[t]):
            lvl, cxr, mvr, cxp, mvp = args
            S = lvl.rows.shape[1]
            k = use_k and S <= max_s(ms.dtype)
            Kcc = _bcov(ms, params, cxr, mvr, cxr, mvr, lvl.rmask, eye=True)
            if ms.limited_tree:
                _, J, _ = chol_inv_masked(Kcc, lvl.rmask, k)
                return carry, (J,)
            Rcc = Kcc
            LAi = H = None
            if P > 0:
                Kxc = _bcov(ms, params, cxp, mvp, cxr, mvr, lvl.pmask,
                            lvl.rmask)
                M, H, LAi = _apply_parent_factor(parent_joint, lvl.lp_pos,
                                                 Kxc, gc, al)
                Rcc = Rcc - torch.einsum("...bps,...bpt->...bst", M, M)
            _, Rinv, _ = chol_inv_masked(Rcc, lvl.rmask, k)
            return carry, (_assemble_joint(LAi, Rinv, H, P, S, gc, pad=jpad),)

        _, (J,) = _run_level((lvl_full, *cx), ms.level_chunks[t], None, body,
                             cb)
        joints[t] = J
        if ms.level_lp[t] >= 0:
            joints.pop(ms.level_lp[t], None)
            gathered.pop(ms.level_lp[t], None)
    return joints[upto]


def predict_recompute(ms: ModelStatic, theta, w, z, coords_cache=None):
    """Prediction without carried operators (pred_in_carry False): the
    reference-level factors are re-propagated for ``theta`` and the
    prediction operators rebuilt slab by slab with the draw fused in, so
    the (B, S, P) operators of all buckets never exist at once.  ``z`` is
    the (n+1,) standard-normal draw, as in ``predict``; returns a new w.
    Chains: theta (C, n_theta), w and z (C, n+1)."""
    if ms.pred_arrays is None:
        return w
    cb = _chains(theta, 1)
    params = unpack_theta(theta.to(ms.dtype), ms.spec)
    parent_joint = _joints_upto(ms, params, ms.pred_lp, coords_cache)
    gathered = {}
    wjs = _w_joints(ms, w, _wj_pred_need(ms))
    wus = []

    def body(carry, args, bi, al=False):
        lvl, cxr, mvr, cxp, mvp = args
        Kxc = _bcov(ms, params, cxp, mvp, cxr, mvr, lvl.pmask, lvl.rmask)
        _, H, _ = _apply_parent_factor(
            _parent_factor(ms, gathered, ms.pred_lp, parent_joint,
                           ms.pred_local[bi], cb), lvl.lp_pos, Kxc, 1, al)
        kdiag = pairwise_cov_diag(cxr, mvr, params, ms.spec)
        r = kdiag - torch.einsum("...bsp,...bps->...bs", H, Kxc)
        r = torch.where(torch.isfinite(r) & (r > 0), r, 0.0)
        wpar = _wpar_from(_wj_src(ms, wjs, bi, pred=True), lvl.lp_pos, al, 1)
        mean = torch.einsum("...bsp,...bp->...bs", H, wpar)
        return carry, (torch.where(lvl.rmask, mean + torch.sqrt(r)
                                   * z[..., lvl.rows], 0.0),)

    for bi, (plvl, nc, al) in enumerate(
            zip(ms.pred_arrays, ms.pred_chunks, ms.pred_aligned)):
        if coords_cache is not None:
            cx = coords_cache[1][bi]
        else:
            cx = (ms.coords[plvl.rows], ms.mv[plvl.rows],
                  ms.coords[plvl.prows], ms.mv[plvl.prows])
        _, (wu,) = _run_level((plvl, *cx), nc, None,
                              lambda c, a, bi=bi, al=al: body(c, a, bi, al),
                              cb)
        wus.append(wu)
    return put_rows(ms, w, wus, ms.pred_rows)


def prior_sample_w(ms: ModelStatic, leveldata, z):
    """A draw of w from the treed-DAG prior SpamTree_G(0, C_theta), root to
    leaf: w_u = H_u w_par + L_u z_u with L_u L_u' = R_u, from the stored
    conditional precisions (reference levels: L_u = chol(prec)^-T; thin
    levels: sqrt(1 / prec)).  ``z`` is the (n+1,) standard-normal draw;
    returns a new (n+1,) w.  Used by the Geweke test and for forward
    simulation from a fitted tree.  Each level reads its ancestors' rows,
    so w is rewritten after each level, the levels not yet drawn as 0."""
    w = z.new_zeros(ms.n + 1)
    wus = [torch.zeros(lvl.rows.shape, dtype=z.dtype, device=z.device)
           for lvl in ms.levels]
    for t, lvl in enumerate(ms.levels):
        data = leveldata[t]
        zt = z[lvl.rows]
        mean = (torch.einsum("bsp,bp->bs", data.H, w[lvl.prows])
                if lvl.prows.shape[1] > 0 else torch.zeros_like(zt))
        if ms.level_is_ref[t]:
            # Lp Lp' = prec = R^-1, so L = Lp^-T and the draw solves Lp' x = z
            Lp, _ = chol_masked(data.prec, lvl.rmask)
            draw = tri_solve(Lp, zt[..., None], trans=True)[..., 0]
        else:
            draw = zt / torch.sqrt(data.prec)
        wus[t] = torch.where(lvl.rmask, mean + draw, 0.0)
        w = put_rows(ms, w, wus, ms.level_rows)
    return w


def _small_spd_sample(Si, rhs, z):
    """Batched N(Si^{-1} rhs, Si^{-1}) draw for tiny p by an unrolled
    Cholesky and substitutions.  Si (q, p, p) SPD, rhs (q, p), z (q, p)
    standard normal -> (q, p) draw."""
    p = Si.shape[-1]
    L = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            s = Si[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    tvec = [None] * p
    for i in range(p):
        s = rhs[..., i]
        for k in range(i):
            s = s - L[i][k] * tvec[k]
        tvec[i] = s / L[i][i]
    mu = [None] * p
    for i in reversed(range(p)):
        s = tvec[i]
        for k in range(i + 1, p):
            s = s - L[k][i] * mu[k]
        mu[i] = s / L[i][i]
    d = [None] * p
    for i in reversed(range(p)):
        s = z[..., i]
        for k in range(i + 1, p):
            s = s - L[k][i] * d[k]
        d[i] = s / L[i][i]
    return torch.stack([mu[i] + d[i] for i in range(p)], dim=-1)


def tausq_shape(ms: ModelStatic, tausq_ab) -> torch.Tensor:
    """(q,) gamma shapes of the tausq^-1 conditional (its ``g`` draw)."""
    return torch.as_tensor(tausq_ab[0] + ms.n_obs_by_q / 2.0, dtype=ms.dtype,
                           device=ms.device)


def gibbs_beta_tausq(ms: ModelStatic, w, XB, g, z_beta, tausq_ab, beta_Vi,
                     beta_Vim, y=None):
    """tausq-Gibbs + beta-Gibbs + XB refresh (reference order: tausq then
    beta, spamtree_fit.cpp:308-330; updates at spamtree_model.cpp:1360-1417).

    ``g`` (q,) are standard-gamma draws with shape ``tausq_shape``, ``z_beta``
    (p, q) standard normals.  Both O(n) reductions ride one (p+1, n) x
    (n, 2q) product.  Returns (tausq_inv, beta, XB).

    Chains: w and XB (C, n+1), g (C, q), z_beta (C, p, q); per-chain p x p
    solves, and the two reductions as batched products."""
    n, p, q = ms.n, ms.p, ms.q
    if y is None:
        y = ms.y
    yw = y[:n] - w[..., :n]
    resid = yw - XB[..., :n]
    if w.dim() == 1:
        A = torch.cat([ms.X, resid[:, None]], dim=1)  # (n, p+1)
        Bm = torch.cat([yw[:, None] * ms.mv_onehot_obs,
                        resid[:, None] * ms.mv_onehot_obs], dim=1)  # (n, 2q)
        C = A.T @ Bm  # [[Xty, Xtr], [r'y, r'r]]
        Xty = C[:p, :q]
        r2 = C[p, q:]
    else:
        Xty = ms.X.T @ (yw[..., :, None] * ms.mv_onehot_obs)  # (C, p, q)
        r2 = (resid * resid) @ ms.mv_onehot_obs  # (C, q)
    tausq_inv = g / (tausq_ab[1] + 0.5 * r2)

    Si = tausq_inv[..., :, None, None] * ms.XtX + beta_Vi  # (.., q, p, p)
    rhs = beta_Vim + tausq_inv[..., None] * Xty.mT  # (.., q, p)
    if p <= 8:
        bj = _small_spd_sample(Si, rhs, z_beta.mT)
    else:
        L = chol_nan(Si)
        half = tri_solve(L, rhs[..., None])
        mu = tri_solve(L, half, trans=True)[..., 0]
        bj = mu + tri_solve(L, z_beta.mT[..., None], trans=True)[..., 0]
    beta = bj.mT  # (.., p, q)
    XBn = torch.sum((ms.X @ beta) * ms.mv_onehot, dim=-1)
    return tausq_inv, beta, torch.cat(
        [XBn, XBn.new_zeros(XBn.shape[:-1] + (1,))], dim=-1)


def gibbs_tausq(ms: ModelStatic, w, XB, g, tausq_ab, y=None):
    """Conjugate Gamma update of the noise precisions per margin (reference:
    gibbs_sample_tausq, spamtree_model.cpp:1393-1417); ``g`` (q,) are
    standard-gamma draws with shape ``tausq_shape``.  Returns tausq_inv
    ((C, q) for chains)."""
    if y is None:
        y = ms.y
    resid = y[: ms.n] - XB[..., : ms.n] - w[..., : ms.n]
    r2 = (resid * resid) @ ms.mv_onehot_obs
    return g / (tausq_ab[1] + 0.5 * r2)


def gibbs_beta(ms: ModelStatic, w, tausq_inv, z_beta, beta_Vi, beta_Vim,
               y=None):
    """Conjugate Normal update of the regression coefficients per margin
    (reference: gibbs_sample_beta, spamtree_model.cpp:1364-1391); ``z_beta``
    (p, q) standard normals.  Returns (beta, XB); chains as in
    ``gibbs_beta_tausq``."""
    if y is None:
        y = ms.y
    yw = y[: ms.n] - w[..., : ms.n]
    Xty = ms.X.T @ (yw[..., :, None] * ms.mv_onehot_obs)  # (.., p, q)
    Si = tausq_inv[..., :, None, None] * ms.XtX + beta_Vi  # (.., q, p, p)
    L = chol_nan(Si)
    rhs = (beta_Vim + tausq_inv[..., None] * Xty.mT)[..., None]
    mu = tri_solve(L, tri_solve(L, rhs), trans=True)[..., 0]
    bj = mu + tri_solve(L, z_beta.mT[..., None], trans=True)[..., 0]
    beta = bj.mT  # (.., p, q)
    XBn = torch.sum((ms.X @ beta) * ms.mv_onehot, dim=-1)
    return beta, torch.cat([XBn, XBn.new_zeros(XBn.shape[:-1] + (1,))],
                           dim=-1)
