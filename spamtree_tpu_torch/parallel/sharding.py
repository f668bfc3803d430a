"""Block sharding of a SpamTree model over a device mesh.

Counterpart of ``shard_model`` in ``spamtree_tpu/parallel/sharding.py``;
its ``replicated`` has no counterpart (every rank builds the replicated
state itself) and its ``chain_sharded`` is each chains rank's own chains
(``api.prepare_fit``, ``utils.checkpoint.load_state(chains=)``).  The
reference's only parallelism is OpenMP threads over the blocks of a tree
level (reference:
spamtree_model.cpp:849-852, spamtree_fit.cpp:57-59); here the ``blocks``
axis of a ``parallel.mesh.Mesh`` gives each rank one contiguous shard of
every level's padded block batch (``ModelStatic(block_multiple=
mesh.n_blocks)`` pads each level to whole shards), and the ``chains`` axis
gives each rank its own chains.

Global row-indexed state -- coords, mv, y, X, obs masks, one-hots, XtX, w,
XB, theta, tausq, beta and the RAM adapter -- is replicated: every rank of
a blocks group holds all of it and makes the same draws from the same
seeded generators, so the sharded step is the unsharded step's math and
every rank takes the same accept decision.  Only the (B, ...) level
tensors -- the static LevelArrays and the per-level factors -- are
sharded; ``model.core`` inserts the collectives where a level reads
another rank's blocks.

Which reads cross ranks is worked out here, once, from the schedule: a
level whose real children all find their parent in their rank's own
parent shard (aligned levels, and the parent-major levels of a full
quadtree below its padded top) reads the parent's factor and w rows
locally, through local lp_pos; otherwise the parent's factor is gathered
whole.  Likewise a level whose Gibbs messages all come from its rank's
own children accumulates them locally, through local anc_pos; otherwise
each rank routes into the whole level and the sums are added over the
ranks.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from spamtree_tpu_torch.model.core import (
    LevelArrays,
    ModelStatic,
    child_tables,
    row_table,
)


def _shard(lvl: LevelArrays, rank: int, n: int):
    """(rank's shard of a whole level, its offset in the level)."""
    B = lvl.rows.shape[0]
    if B % n:
        raise ValueError(f"a level of {B} blocks does not split into {n} "
                         f"shards: build the model with block_multiple={n}")
    b = B // n
    return LevelArrays(*(a[rank * b:(rank + 1) * b] for a in lvl)), rank * b


def _localize(pos: np.ndarray, keep: np.ndarray, b: int, b_par: int,
              fill: int):
    """Local parent positions of a whole level's children, or None: child
    i of rank k = i // b must point (``pos``, into the whole parent level)
    into rank k's parent shard [k b_par, (k + 1) b_par) wherever ``keep``;
    elsewhere the local position is ``fill``."""
    lo = (np.arange(len(pos)) // b) * b_par
    if not np.all((pos[keep] >= lo[keep]) & (pos[keep] < lo[keep] + b_par)):
        return None
    return np.where(keep, pos - lo, fill)


def shard_model(ms: ModelStatic, mesh) -> ModelStatic:
    """A view of ``ms`` holding this rank's block shard of every level and
    prediction bucket (the whole levels stay in ``levels_full`` and
    ``pred_full``), with ``mesh`` attached.  ``ms`` must be on the mesh's
    device and padded for its blocks axis."""
    if ms.device != mesh.device:
        raise ValueError(f"model on {ms.device}, mesh rank on {mesh.device}")
    D, r = mesh.n_blocks, mesh.block_rank
    sm = copy.copy(ms)
    sm.levels, sm.level_off = map(list, zip(*(
        _shard(lvl, r, D) for lvl in ms.levels_full)))
    if ms.pred_full is not None:
        sm.pred_arrays, sm.pred_off = map(list, zip(*(
            _shard(lvl, r, D) for lvl in ms.pred_full)))
    host = lambda x: x.cpu().numpy()
    b = lambda lvl: lvl.rows.shape[0] // D
    own = lambda x, lvl: torch.as_tensor(x[r * b(lvl):(r + 1) * b(lvl)],
                                         device=ms.device)

    def localize(lvl, lp, local):
        # children that read parent level lp through lp_pos; dummy blocks
        # (masked, so any parent serves) read local position 0
        real = host((lvl.rows < ms.n).any(1))
        loc = _localize(host(lvl.lp_pos), real, b(lvl), b(ms.levels_full[lp]),
                        0)
        local.append(loc is not None)
        return None if loc is None else own(loc, lvl)

    sm.level_local, sm.pred_local = [], []
    for t, lvl in enumerate(ms.levels_full):
        if lvl.prows.shape[1] == 0 or ms.level_aligned[t]:
            sm.level_local.append(True)
            continue
        lp_pos = localize(lvl, ms.level_lp[t], sm.level_local)
        if lp_pos is not None:
            sm.levels[t] = sm.levels[t]._replace(lp_pos=lp_pos)
    for bi, lvl in enumerate(ms.pred_full or []):
        if ms.pred_aligned[bi]:
            sm.pred_local.append(True)
            continue
        lp_pos = localize(lvl, ms.pred_lp, sm.pred_local)
        if lp_pos is not None:
            sm.pred_arrays[bi] = sm.pred_arrays[bi]._replace(lp_pos=lp_pos)
    # message routing: local when every message to a level comes from its
    # rank's own children (dropped children go to the local sentinel);
    # else this rank's children point into the whole level
    routes = {}
    for (t, a), pos in ms.anc_pos.items():
        tp = ms.seg_level[t][a]
        Bp = ms.levels_full[tp].rows.shape[0]
        pos = host(pos)
        routes.setdefault(tp, []).append(((t, a), pos, _localize(
            pos, pos < Bp, b(ms.levels_full[t]), Bp // D, Bp // D)))
    sm.msg_local = [all(loc is not None for _, _, loc in routes.get(tp, []))
                    for tp in range(len(ms.levels_full))]
    sm.anc_pos, n_par = {}, {}
    for tp, rs in routes.items():
        Bp = ms.levels_full[tp].rows.shape[0]
        for (t, a), pos, loc in rs:
            sm.anc_pos[(t, a)] = own(loc if sm.msg_local[tp] else pos,
                                     ms.levels_full[t])
            n_par[(t, a)] = Bp // D if sm.msg_local[tp] else Bp
    sm.child_table = child_tables(sm.anc_pos, n_par)
    # put_rows' tables on the mesh: each rank writes its shards of every
    # level (bucket), joined over the ranks, so the rows are every rank's
    # shards in rank order
    def rows_by_rank(full):
        return np.concatenate([host(_shard(lvl, k, D)[0].rows).reshape(-1)
                               for k in range(D) for lvl in full])

    sm.level_rows = row_table(rows_by_rank(ms.levels_full), ms.n, ms.device)
    if ms.pred_full is not None:
        sm.pred_rows = row_table(rows_by_rank(ms.pred_full), ms.n, ms.device)
    sm.mesh = mesh
    return sm

