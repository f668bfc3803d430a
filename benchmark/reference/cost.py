"""The benchmark's yardstick of work and of the chip: published peaks, the
hand-written kernels' cost functions, and the operations of one MCMC
iteration counted from the tree's block shapes.

``inv_chol_cost``, ``thin_gibbs_cost`` and ``thin_decision_cost`` are
frozen copies of ``spamtree_tpu_torch/ops/chol.py`` and ``ops/level.py`` at
commit 1ed94f536e0e (formulas from shapes that count each input byte read
once and each output byte written once).  Do not edit them to follow the
program.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, NVIDIA's data sheet, at its 700 W limit: float32 outside
# the tensor cores (TF32 is off in the program), and the HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# the Metropolis acceptance the adaptive (RAM) theta proposal steers to
RAM_TARGET_ACCEPT = 0.234


def inv_chol_cost(B: int, S: int, write_l: bool, itemsize: int) -> tuple:
    """(flops, bytes) of one K1 call on (B, S, S): A read once, Linv (and
    L with ``write_l``) written once; S^3/3 operations per block for the
    factor and as many for its inverse."""
    return (B * 2 * S ** 3 / 3, (3 if write_l else 2) * B * S * S * itemsize)


def thin_gibbs_cost(B: int, S: int, P: int, itemsize: int) -> tuple:
    """(flops, bytes) of one K3 call: H (B,S,P), wpar (B,P) and five (B,S)
    vectors read once, wu (B,S) and msg (B,P) written once; 4 B S P
    operations (H wpar and H' prec (wu - hw))."""
    return 4 * B * S * P, itemsize * (B * S * P + 6 * B * S + 2 * B * P)


def thin_decision_cost(B: int, S: int, P: int, itemsize: int, slabs=None,
                       aligned: bool = True) -> tuple:
    """(flops, bytes) of one K4 call over B blocks (see ops/level.py)."""
    slabs = B if slabs is None else slabs
    return (2 * P * P * (S + 1) * B + 6 * P * S * B,
            itemsize * (2 * B * P * S + slabs * P * P + B * P
                        + 4 * B * S + 4 * B)
            + (0 if aligned else 8 * B))


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the chip can take: the larger of the two bounds."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S)


def block_shapes(tree):
    """(s, p, is_ref, observed) per block of a frozen-copy tree: its rows and
    its reference ancestors' rows, unpadded."""
    lv = np.asarray(tree.block_level)
    levels = sorted(set(int(v) for v in lv))
    ref = {res: bool(tree.res_is_ref[i] == 1) for i, res in enumerate(levels)}
    sizes = np.array([len(r) for r in tree.block_rows], dtype=np.float64)
    s = sizes
    p = np.array([sizes[list(pa)].sum() if len(pa) else 0.0
                  for pa in tree.parents])
    obs = np.asarray(tree.block_ct_obs) > 0
    is_ref = np.array([ref[int(v)] for v in lv]) & obs
    return s, p, is_ref, obs


def iteration_flops(tree, n: int, n_x: int, q: int, thin: int,
                    limited_tree: bool, chains: int = 1) -> float:
    """Operations of one iteration of the always-emit sampler, counted from
    the algorithm over the tree's true block sizes (s rows, p ancestor rows;
    no padding), per chain:

    - the proposal's sweep, every observed block: M = La^-1 Kac (p^2 s),
      H = M' La^-1 (p^2 s), the two quadratic forms (4 s p); reference
      blocks also R = Kcc - M'M (p s^2), its inverse factor (2 s^3 / 3),
      prec = Rinv' Rinv (s^3 / 3), the forms' s^2 terms (3 s^2) and the
      children's joint factor (s^2 p; the limited tree: the inverse factor
      of Kcc, 2 s^3 / 3); thin blocks diag(M'M) (2 s p);
    - the w Gibbs sweep, every observed block: the prior mean H w_anc
      (2 s p) and the messages' vectors (2 s p); reference blocks the
      factor of Q and its solves (s^3 / 3 + 6 s^2); the messages' Gram
      matrices G' Q G (2 s^2 p + 2 s p^2 reference, s p^2 thin) only when
      theta moves, at the adaptive proposal's target acceptance;
    - predicting iterations (one in ``thin``), every prediction block: M, H
      (2 p^2 s), r (2 s p) and the mean (2 s p);
    - the conjugate tail: X'(y - w) and X beta (4 n n_x) and the residuals
      (3 n), the (n_x, n_x) solves per margin.

    Data movement (gathers, copies, padding) counts nothing."""
    s, p, ref, obs = block_shapes(tree)
    th = obs & ~ref
    pr = ~obs
    sweep = (2 * p * p * s + 4 * s * p)[obs].sum()
    ref_extra = p * s * s + 2 * s ** 3 / 3 + s ** 3 / 3 + 3 * s * s
    ref_extra = ref_extra + (2 * s ** 3 / 3 if limited_tree else s * s * p)
    sweep += ref_extra[ref].sum() + (2 * s * p)[th].sum()
    gibbs = (4 * s * p)[obs].sum() + (s ** 3 / 3 + 6 * s * s)[ref].sum()
    gram = (2 * s * s * p + 2 * s * p * p)[ref].sum() + (s * p * p)[th].sum()
    predict = (2 * p * p * s + 4 * s * p)[pr].sum() / max(thin, 1)
    tail = 4.0 * n * n_x + 3.0 * n + q * 2.0 * n_x ** 3
    return chains * float(sweep + gibbs + RAM_TARGET_ACCEPT * gram + predict
                          + tail)
