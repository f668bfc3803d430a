"""The fused thin-level kernels (ops.level, K3 and K4/K5) and the sweeps
that reach them: the plain versions against the Pallas kernels they replace
(interpret mode on the CPU), K4 folded over chains against the Pallas
kernel under ``jax.vmap``, the port's decision-only sweep and its K3
w-Gibbs branch against the JAX package's, and -- on a CUDA card only -- the
kernels against their plain versions.

Tolerances, float64: the plain versions repeat the Pallas kernels' math in
another summation order (rtol 1e-12); the sweeps run a few levels of
Cholesky factorisations (LAPACK against XLA) before the level quantities
(rtol 1e-10); w-Gibbs adds one more solve per level (rtol 1e-9, as
tests/test_torch_core.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spamtree_tpu_torch.model import core as ct
from spamtree_tpu_torch.model.params import make_theta_spec
from spamtree_tpu_torch.ops import kernel_counts, level
from spamtree_tpu_torch.tree.partition import make_tree
from spamtree_tpu_torch.tree.schedule import build_schedule

# jax and the JAX package are imported inside the tests that compare with
# them, so that the card test also runs where jax is absent:
#   python -m pytest --noconftest -m cuda tests/test_torch_level.py


def _t(a):
    return torch.as_tensor(np.array(a))


def _decision_inputs(seed, B, Bp, P, S, lp_pos=None):
    """Random K4 inputs (numpy, float64); the joint is a full random matrix
    (not triangular), as in tests/test_pallas_level.py."""
    rng = np.random.default_rng(seed)
    rmask = np.ones((B, S))
    rmask[min(1, B - 1), S // 2:] = 0.0  # a partly masked block
    return dict(
        Kxc=rng.normal(size=(B, P, S)), joint=rng.normal(size=(Bp, P, P)),
        lp_pos=(np.arange(B) if lp_pos is None else np.asarray(lp_pos)),
        wpar=rng.normal(size=(B, P)), w_r=rng.normal(size=(B, S)),
        prevH=rng.normal(size=(B, S, P)),
        prevprec=rng.uniform(1.0, 2.0, size=(B, S)),
        kdiag=rng.uniform(5.0, 9.0, size=(B, S)) * P * P, rmask_f=rmask)


DECISION_CASES = {
    # shuffled, repeated parent positions with Bp != B
    "unaligned": dict(B=6, Bp=4, P=9, S=5, lp_pos=[2, 0, 0, 3, 1, 2]),
    "aligned": dict(B=6, Bp=6, P=9, S=5),
    # P % 128 == 0 on an aligned level selects the TPU's K5 body
    "vpu_p128": dict(B=4, Bp=4, P=128, S=16),
    # kdiag too small on one block: r <= 0 there, ok must be False
    "not_ok": dict(B=6, Bp=4, P=9, S=5, lp_pos=[1, 3, 0, 2, 2, 1]),
}


@pytest.mark.parametrize("case", sorted(DECISION_CASES))
def test_decision_plain_matches_pallas(case):
    import jax.numpy as jnp
    from spamtree_tpu.ops import pallas_level as plj

    c = dict(DECISION_CASES[case])
    aligned = "lp_pos" not in c
    d = _decision_inputs(len(case), **c)
    if case == "not_ok":
        d["kdiag"][4] = 1e-3
    names = ("Kxc", "joint", "lp_pos", "wpar", "w_r", "prevH", "prevprec",
             "kdiag", "rmask_f")
    ref = plj.thin_decision_level(
        *(jnp.asarray(d[k], jnp.int32 if k == "lp_pos" else jnp.float64)
          for k in names), aligned=aligned, interpret=True)
    got = level.thin_decision_level(*(_t(d[k]) for k in names),
                                    aligned=aligned)
    assert bool(got[1]) == bool(ref[1]) == (case != "not_ok")
    for i in (0, 2, 3):
        np.testing.assert_allclose(float(got[i]), float(ref[i]), rtol=1e-12)
    # the per-block partials reduce to the same level values
    part = level.thin_decision_partials_plain(*(_t(d[k]) for k in names),
                                              aligned=aligned)
    assert part.shape == (c["B"], 4)
    assert part[:, 3].tolist() == [float(b != 4 or case != "not_ok")
                                   for b in range(c["B"])]


def _chain_inputs(case, C=3, bad=1):
    """C chains' K4 inputs of a DECISION_CASES level, stacked (C, ...) but
    for the level's shared lp_pos and rmask_f; chain ``bad`` has an r <= 0
    row in block 0."""
    c = dict(DECISION_CASES[case])
    per = [_decision_inputs(len(case) + 10 * k, **c) for k in range(C)]
    per[bad]["kdiag"][0] = 1e-3
    d = {k: np.stack([x[k] for x in per]) for k in per[0]}
    d["lp_pos"], d["rmask_f"] = per[0]["lp_pos"], per[0]["rmask_f"]
    return d, "lp_pos" not in c


@pytest.mark.parametrize("case", sorted(DECISION_CASES))
def test_decision_chains_is_per_chain(case):
    """thin_decision_chains over three chains (one with a failing block):
    each chain's (logdet, ok, qn, qc) is its own thin_decision_level, and
    jax.vmap over the Pallas kernel (lp_pos and rmask_f unbatched, as in
    the JAX package's vmapped chains) gives the same, rtol 1e-12."""
    import jax
    import jax.numpy as jnp
    from spamtree_tpu.ops import pallas_level as plj

    names = ("Kxc", "joint", "lp_pos", "wpar", "w_r", "prevH", "prevprec",
             "kdiag", "rmask_f")
    d, aligned = _chain_inputs(case)
    got = level.thin_decision_chains(*(_t(d[k]) for k in names),
                                     aligned=aligned)
    assert got[1].tolist() == [True, False, True]
    one = [level.thin_decision_level(*(_t(d[k] if k in ("lp_pos", "rmask_f")
                                          else d[k][c]) for k in names),
                                     aligned=aligned) for c in range(3)]
    ref = jax.vmap(lambda *a: plj.thin_decision_level(
        *a, aligned=aligned, interpret=True),
        in_axes=tuple(None if k in ("lp_pos", "rmask_f") else 0
                      for k in names))(
        *(jnp.asarray(d[k], jnp.int32 if k == "lp_pos" else jnp.float64)
          for k in names))
    assert np.asarray(ref[1]).tolist() == got[1].tolist()
    for i in (0, 2, 3):
        np.testing.assert_allclose(got[i].numpy(), [float(o[i]) for o in one],
                                   rtol=1e-12)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   rtol=1e-12)
    with pytest.raises(ValueError, match="C, B, P, S"):
        level.thin_decision_chains(*(_t(d[k][0] if k not in (
            "lp_pos", "rmask_f") else d[k]) for k in names))


def _cu_source():
    return (Path(level.__file__).resolve().parents[1] / "csrc"
            / "thin_level.cu").read_text()


def _cu_constants():
    """The top-level ``constexpr int`` constants of csrc/thin_level.cu."""
    env = {}
    for decl in re.findall(r"^constexpr int ([^;]+);", _cu_source(), re.M):
        for part in decl.split(","):
            name, expr = (x.strip() for x in part.split("=", 1))
            env[name] = eval(expr, {"__builtins__": {}}, env)
    return env


def _k4_tiling():
    """K4's tiling as csrc/thin_level.cu declares it, so that the emulation
    follows the kernel: TP rows of LAi per row tile, TQ contraction depth
    per stage, slab width W (up to W - 1 columns of Kxc and u's column)."""
    env = _cu_constants()
    return env["TP"], env["TQ"], env["W"]


K4_TP, K4_TQ, K4_W = _k4_tiling()


def _decision_one_pass(Kxc, joint, lp_pos, wpar, w_r, prevH, prevprec, kdiag,
                       rmask_f, aligned=False):
    """Step-by-step emulation of csrc/thin_level.cu's K4 schedule: for each
    column pass, each row tile of LAi makes its slab [M | u] over depth
    tiles, and hk and hw accumulate from M and the u of the same tile."""
    LAi = joint if aligned else joint[lp_pos]
    B, P, S = Kxc.shape
    hk = torch.zeros(B, S, dtype=Kxc.dtype)
    hw = torch.zeros(B, S, dtype=Kxc.dtype)
    for c0 in range(0, S, K4_W - 1):
        nc = min(K4_W - 1, S - c0)
        rhs = torch.cat([Kxc[:, :, c0:c0 + nc], wpar[:, :, None]], dim=2)
        for p0 in range(0, P, K4_TP):
            acc = 0
            for q0 in range(0, P, K4_TQ):
                acc = acc + (LAi[:, p0:p0 + K4_TP, q0:q0 + K4_TQ]
                             @ rhs[:, q0:q0 + K4_TQ])
            m, u = acc[:, :, :nc], acc[:, :, nc:]
            hk[:, c0:c0 + nc] += (m * m).sum(dim=1)
            hw[:, c0:c0 + nc] += (m * u).sum(dim=1)
    rmask = rmask_f > 0.5
    r = torch.where(rmask, kdiag - hk, 1.0)
    okl = torch.isfinite(r) & (r > 0)
    r = torch.where(okl, r, 1.0)
    logdet = -0.5 * torch.where(rmask, torch.log(r), 0.0).sum(dim=1)
    qn = -0.5 * ((w_r - hw) ** 2 / r).sum(dim=1)
    wxc = w_r - torch.einsum("bsp,bp->bs", prevH, wpar)
    qc = -0.5 * (prevprec * wxc * wxc).sum(dim=1)
    return torch.stack([logdet, qn, qc, okl.all(dim=1).to(Kxc.dtype)], dim=1)


ONE_PASS_CASES = {
    # config 1's thin level through shuffled, repeated parents, Bp != B
    "config1": dict(B=16, Bp=12, P=69, S=18,
                    lp_pos=np.random.default_rng(5).integers(0, 12, 16)),
    # P not a multiple of the row tile, S + 1 > W: two column passes
    "ragged_two_passes": dict(B=3, Bp=2, P=150, S=100, lp_pos=[1, 0, 1]),
    # aligned, with a block forced to r <= 0
    "aligned_not_ok": dict(B=4, Bp=4, P=70, S=9),
}


@pytest.mark.parametrize("case", sorted(ONE_PASS_CASES))
def test_decision_one_pass_schedule_matches_plain(case):
    """The kernel's schedule in float64 against the plain partials (rtol
    1e-12: another summation order), with identical ok flags."""
    c = dict(ONE_PASS_CASES[case])
    aligned = "lp_pos" not in c
    d = _decision_inputs(len(case), **c)
    if case == "aligned_not_ok":
        d["kdiag"][2] = 1e-3
    names = ("Kxc", "joint", "lp_pos", "wpar", "w_r", "prevH", "prevprec",
             "kdiag", "rmask_f")
    args = [_t(d[k]) for k in names]
    got = _decision_one_pass(*args, aligned=aligned)
    ref = level.thin_decision_partials_plain(*args, aligned=aligned)
    assert torch.equal(got[:, 3], ref[:, 3])
    assert ref[:, 3].tolist() == [float(not (aligned and b == 2))
                                  for b in range(c["B"])]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12)


@pytest.mark.parametrize("B,S,P", [(5, 7, 11), (3, 16, 128)])
def test_gibbs_plain_matches_pallas(B, S, P):
    import jax.numpy as jnp
    from spamtree_tpu.ops import pallas_level as plj

    rng = np.random.default_rng(B * S)
    rmask = np.ones((B, S))
    rmask[1, S - 3:] = 0.0
    d = dict(H=rng.normal(size=(B, S, P)),
             prec=rng.uniform(0.5, 2.0, size=(B, S)),
             wpar=rng.normal(size=(B, P)), z=rng.normal(size=(B, S)),
             ti=rng.uniform(2.0, 5.0, size=(B, S)),
             resid=rng.normal(size=(B, S)), rmask_f=rmask)
    names = ("H", "prec", "wpar", "z", "ti", "resid", "rmask_f")
    ref = plj.thin_gibbs_level(*(jnp.asarray(d[k]) for k in names),
                               interpret=True)
    got = level.thin_gibbs_level(*(_t(d[k]) for k in names))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12)
    assert (got[0][1, S - 3:] == 0).all()


def _k3_capacities():
    """The rows variant's capacities as csrc/thin_level.cu lists them,
    (warps, rows per warp, columns per lane), per type."""
    src = _cu_source()

    def table(name):
        line = re.search(rf"^#define {name}\(X\) (.*)$", src, re.M).group(1)
        return [tuple(int(v) for v in m.split(","))
                for m in re.findall(r"X\(([^)]*)\)", line)]

    return dict(f32=[c[:3] for c in table("GIBBS_ROWS_F32")],
                f64=[c[:3] for c in table("GIBBS_ROWS_F64")])


K3_CAP = _k3_capacities()
K3_CONST = _cu_constants()


def _k3_variant(S, P, table):
    """The launcher's choice (gibbs_variant in csrc/thin_level.cu) as
    (name, capacity); ``table`` is "f32" or "f64"."""
    if (P <= K3_CONST["kFlatMaxP"] and S <= K3_CONST["kFlatMaxS"]
            and S * P <= K3_CONST["kFlatMaxN"]):
        return "flat", None
    for w, r, c in K3_CAP[table]:
        if S <= w * r and P <= 32 * c:
            return f"rows{w}x{r}x{c}", (w, r, c)
    return "tiled", None


def _butterfly(t):
    """warp_sum: the xor butterfly over the 32 lanes (last axis)."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        t = t + t[..., lanes ^ o]
    return t[..., 0]


def _k3_rows_of(hw, d):
    """gibbs_row: wu and v = prec (wu - hw) of every row."""
    sig = d["prec"] + d["ti"]
    wu = (d["prec"] * hw + d["resid"]) / sig + d["z"] / torch.sqrt(sig)
    wu = torch.where(d["rmask_f"] > 0.5, wu, 0.0)
    return wu, d["prec"] * (wu - hw)


def _k3_emulate_rows(d, cap):
    """thin_gibbs_rows_kernel: warp w holds rows w, w + WARPS, ..., lane l
    columns l, l + 32, ...; hw per lane in column order, then the butterfly;
    msg per thread in row order, then over the warps in warp order."""
    W, R, C = cap
    H, wpar = d["H"], d["wpar"]
    B, S, P = H.shape
    Hp = torch.zeros(B, W * R, 32 * C, dtype=H.dtype)
    Hp[:, :S, :P] = H
    sw = torch.zeros(B, 32 * C, dtype=H.dtype)
    sw[:, :P] = wpar
    hw = torch.zeros(B, W * R, dtype=H.dtype)
    for s in range(W * R):
        t = torch.zeros(B, 32, dtype=H.dtype)
        for c in range(C):
            t = t + Hp[:, s, 32 * c:32 * c + 32] * sw[:, 32 * c:32 * c + 32]
        hw[:, s] = _butterfly(t)
    wu, v = _k3_rows_of(hw[:, :S], d)
    vp = torch.zeros(B, W * R, dtype=H.dtype)
    vp[:, :S] = v
    msg = torch.zeros(B, 32 * C, dtype=H.dtype)
    for w in range(W):
        acc = torch.zeros(B, 32 * C, dtype=H.dtype)
        for r in range(R):
            acc = acc + Hp[:, w + r * W] * vp[:, w + r * W, None]
        msg = msg + acc
    return wu, msg[:, :P]


def _k3_emulate_flat(d):
    """thin_gibbs_flat_kernel: lane l copies elements l, l + 32, ... of the
    flattened slab to (s, p) at row pitch P | 1, stepped as the kernel
    steps them; rows summed in column order, columns in row order."""
    H, wpar = d["H"], d["wpar"]
    B, S, P = H.shape
    n, PP = S * P, P | 1
    q32, r32 = divmod(32, P)
    es, dst = [], []
    for lane in range(32):
        s, p = divmod(lane, P)
        for e in range(lane, n, 32):
            assert divmod(e, P) == (s, p)
            es.append(e)
            dst.append(s * PP + p)
            s, p = s + q32, p + r32
            if p >= P:
                s, p = s + 1, p - P
    assert sorted(es) == list(range(n))  # every element copied once
    sH = torch.full((B, S * PP), float("nan"), dtype=H.dtype)
    sH[:, torch.tensor(dst)] = H.reshape(B, n)[:, torch.tensor(es)]
    sH = sH.view(B, S, PP)
    hw = torch.zeros(B, S, dtype=H.dtype)
    for c in range(P):
        hw = hw + sH[:, :, c] * wpar[:, None, c]
    wu, v = _k3_rows_of(hw, d)
    msg = torch.zeros(B, P, dtype=H.dtype)
    for s in range(S):
        msg = msg + sH[:, s, :P] * v[:, s, None]
    return wu, msg


def _k3_emulate_tiled(d):
    """thin_gibbs_tiled_kernel: a warp per row (lane l sums columns l,
    l + 32, ..., then the butterfly), then a thread per column in row
    order."""
    H, wpar = d["H"], d["wpar"]
    B, S, P = H.shape
    nchunk = -(-P // 32)
    prod = torch.zeros(B, S, 32 * nchunk, dtype=H.dtype)
    prod[:, :, :P] = H * wpar[:, None, :]
    t = torch.zeros(B, S, 32, dtype=H.dtype)
    for c in range(nchunk):
        t = t + prod[:, :, 32 * c:32 * c + 32]
    wu, v = _k3_rows_of(_butterfly(t), d)
    msg = torch.zeros(B, P, dtype=H.dtype)
    for s in range(S):
        msg = msg + H[:, s] * v[:, s, None]
    return wu, msg


# (B, S, P, capacity table, the variant the launcher must take)
K3_CASES = {
    "config3": (8, 68, 293, "f32", "rows8x9x10"),
    "config3_f64": (8, 68, 293, "f64", "rows16x5x10"),
    # bench config 5's four thin levels (n = 1e6, limited tree), B cut
    "config5_s23": (16, 23, 25, "f32", "flat"),
    "config5_s29": (16, 29, 25, "f32", "flat"),
    "config5_s37": (16, 37, 25, "f32", "flat"),
    "config5_s57": (16, 57, 25, "f32", "flat"),
    "config1": (16, 18, 69, "f32", "rows8x4x4"),
    "config1_limited": (16, 18, 19, "f32", "flat"),
    # both sides of every boundary of the choice
    "flat_full": (3, 48, 32, "f32", "flat"),
    "flat_s128": (3, 128, 12, "f32", "flat"),
    "flat_p32": (3, 25, 32, "f32", "flat"),
    "flat_over": (3, 49, 32, "f32", "rows8x9x10"),
    "flat_even_p": (3, 40, 30, "f32", "flat"),
    "p33": (3, 4, 33, "f32", "rows8x4x4"),
    "s129": (3, 129, 1, "f32", "tiled"),
    "rows_a_full": (3, 32, 128, "f32", "rows8x4x4"),
    "rows_a_over_s": (3, 33, 128, "f32", "rows8x9x10"),
    "rows_a_over_p": (3, 32, 129, "f32", "rows8x9x10"),
    "rows_b_full": (3, 72, 320, "f32", "rows8x9x10"),
    "rows_b_over_s": (3, 73, 320, "f32", "tiled"),
    "rows_b_over_p": (3, 72, 321, "f32", "tiled"),
    "rows_f64_full": (3, 80, 320, "f64", "rows16x5x10"),
    "rows_f64_over": (3, 81, 320, "f64", "tiled"),
    "s1": (4, 1, 293, "f32", "rows8x9x10"),
    "p1": (4, 68, 1, "f32", "flat"),
    "s1_p1": (4, 1, 1, "f32", "flat"),
    "gate_edge": (2, 512, 1024, "f32", "tiled"),
}


def _gibbs_inputs(seed, B, S, P):
    """Random K3 inputs (float64 tensors): wpar gathered from fewer parents
    through a shuffled, repeating lp_pos, masked rows in two blocks and one
    block masked whole."""
    rng = np.random.default_rng(seed)
    Bp = max(1, B // 2)
    lp_pos = rng.integers(0, Bp, B)
    rmask = np.ones((B, S))
    rmask[min(1, B - 1), S // 2:] = 0.0
    rmask[B - 1, ::3] = 0.0
    if B > 2:
        rmask[2] = 0.0
    d = dict(H=rng.normal(size=(B, S, P)) / np.sqrt(P),
             prec=rng.uniform(0.5, 2.0, size=(B, S)),
             wpar=rng.normal(size=(Bp, P))[lp_pos],
             z=rng.normal(size=(B, S)), ti=rng.uniform(2.0, 5.0, size=(B, S)),
             resid=rng.normal(size=(B, S)), rmask_f=rmask)
    return {k: _t(v) for k, v in d.items()}


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_gibbs_schedule_matches_plain(case):
    """Each K3 variant's ownership map and summation order, step by step in
    float64, against the plain version (rtol 1e-12 of the largest value:
    another summation order); masked rows come out exactly 0.  This checks
    the schedule's algebra and the launcher's choice as this file derives
    them from the source's constants, not the compiled kernel:
    ``test_gibbs_variants_on_card`` holds the shipped code to the same
    cases."""
    B, S, P, table, want = K3_CASES[case]
    name, cap = _k3_variant(S, P, table)
    assert name == want
    d = _gibbs_inputs(len(case), B, S, P)
    if name == "flat":
        got = _k3_emulate_flat(d)
    elif name.startswith("rows"):
        got = _k3_emulate_rows(d, cap)
    else:
        got = _k3_emulate_tiled(d)
    ref = level.thin_gibbs_level_plain(**d)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(r.abs().max()))
    assert (got[0][d["rmask_f"] <= 0.5] == 0).all()
    assert (got[0][d["rmask_f"] > 0.5] != 0).all()


def test_wrappers_reject_what_the_kernels_do_not_take():
    # the checks run before any device work: meta tensors reach them
    m = dict(device="meta", dtype=torch.float32)
    B, S, P = 2, 4, 6
    vec = [torch.empty(B, S, **m) for _ in range(5)]
    with pytest.raises(ValueError, match="S <= 512"):
        level.thin_gibbs_level(torch.empty(B, 513, P, **m),
                               *[torch.empty(B, 513, **m)], torch.empty(B, P, **m),
                               *[torch.empty(B, 513, **m) for _ in range(4)])
    with pytest.raises(ValueError, match="unsupported device"):
        level.thin_gibbs_level(torch.empty(B, S, P, **m), vec[0],
                               torch.empty(B, P, **m), *vec[1:])
    with pytest.raises(TypeError):
        level.thin_gibbs_level(torch.empty(B, S, P, device="meta",
                                           dtype=torch.float16), vec[0],
                               torch.empty(B, P, **m), *vec[1:])
    lp = torch.zeros(B, dtype=torch.int64, device="meta")
    args = (torch.empty(B, P, S, **m), torch.empty(3, P, P, **m), lp,
            torch.empty(B, P, **m), vec[0], torch.empty(B, S, P, **m),
            *vec[1:4])
    with pytest.raises(ValueError, match="aligned needs"):
        level.thin_decision_level(*args, aligned=True)
    with pytest.raises(ValueError, match="P <= 1024"):
        level.thin_decision_level(torch.empty(B, 1025, S, **m),
                                  *args[1:])
    before = kernel_counts.snapshot()
    d = _decision_inputs(0, B=3, Bp=2, P=5, S=4, lp_pos=[1, 0, 1])
    level.thin_decision_level(*(_t(d[k]) for k in (
        "Kxc", "joint", "lp_pos", "wpar", "w_r", "prevH", "prevprec",
        "kdiag", "rmask_f")))  # CPU: the plain version, never counted
    launched = kernel_counts.diff(before)
    assert (launched["k3_launches"], launched["k4_launches"]) == (0, 0)


def test_apply_parts_thin_matches_jax():
    """Grouped parent (gc_p > 1), ungrouped, and the root parent (Pp = 0)."""
    import jax.numpy as jnp
    from spamtree_tpu.model import core as cj

    rng = np.random.default_rng(2)
    B, Pp, Sp, S = 8, 7, 5, 6
    for gc_p, pp in ((4, Pp), (1, Pp), (1, 0)):
        G = B // gc_p
        LAi = rng.normal(size=(G, pp, pp)) if pp else None
        H = rng.normal(size=(B, Sp, pp))
        Rinv = np.tril(rng.normal(size=(B, Sp, Sp)))
        Kxc = rng.normal(size=(B, pp + Sp, S))
        wpar = rng.normal(size=(B, pp + Sp))
        ref = cj._apply_parts_thin(
            (None if LAi is None else jnp.asarray(LAi), jnp.asarray(H),
             jnp.asarray(Rinv), gc_p), jnp.asarray(Kxc), jnp.asarray(wpar),
            jnp.float64)
        got = ct._apply_parts_thin(
            (None if LAi is None else _t(LAi), _t(H), _t(Rinv), gc_p),
            _t(Kxc), _t(wpar))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                       atol=1e-12)


def _models(limited, align_min_p=128, n_loc=220, seed=3, imbalance=None):
    """JAX and port models of one bivariate dataset (tests/test_pallas_level
    .py's, with ``align_min_p=1`` optional so that composed parts activate,
    as tests/test_composed_sweep.py).  ``imbalance=(f0, f1)`` instead gives
    bench config 5's kind of data (bench.make_multivariate's): each margin
    its own uniform locations, 2 n_loc f_j of them."""
    import jax.numpy as jnp
    from spamtree_tpu.model import core as cj
    from spamtree_tpu.model import params as pj
    from spamtree_tpu.tree.partition import make_tree as make_tree_jax
    from spamtree_tpu.tree.schedule import (
        build_schedule as build_schedule_jax)

    rng = np.random.default_rng(seed)
    if imbalance is None:
        coords = np.repeat(rng.uniform(size=(n_loc, 2)), 2, axis=0)
        mv = np.tile(np.arange(2), n_loc)
    else:
        nj = [int(2 * n_loc * f) for f in imbalance]
        coords = rng.uniform(size=(sum(nj), 2))
        mv = np.repeat(np.arange(2), nj)
    n = len(coords)
    order = np.lexsort((np.arange(n), coords[:, 1], coords[:, 0]))
    coords, mv = coords[order], mv[order]
    na = rng.uniform(size=n) > 0.1
    y = rng.normal(size=n)
    y[~na] = np.nan
    X = rng.normal(size=(n, 2))
    kw = dict(axis_cell_size=4, K=2, limited_tree=limited)
    spec = make_theta_spec(2, 2)
    ms_j = cj.ModelStatic(
        build_schedule_jax(make_tree_jax(coords, na, mv,
                                         rng=np.random.default_rng(0), **kw),
                           limited_tree=limited, align_min_p=align_min_p),
        coords, mv, y, X, pj.make_theta_spec(2, 2).spec, dtype=jnp.float64)
    ms_t = ct.ModelStatic(
        build_schedule(make_tree(coords, na, mv,
                                 rng=np.random.default_rng(0), **kw),
                       limited_tree=limited, align_min_p=align_min_p),
        coords, mv, y, X, spec.spec, dtype=torch.float64, device="cpu")
    thin = [t for t in range(len(ms_t.levels))
            if not ms_t.level_is_ref[t] and ms_t.levels[t].prows.shape[1] > 0]
    assert thin, "the model must have a thin level with parents"
    return ms_j, ms_t, spec, rng


def _ld_t(ld):
    return tuple(ct.LevelData(_t(d.H), _t(d.prec)) for d in ld)


@pytest.fixture(scope="module", params=["full", "limited", "config5"])
def tree(request):
    """``config5``: bench config 5's structure at n = 2000 -- imbalanced
    margins on a limited tree, four reference levels, several unaligned
    thin levels on one parent level, several prediction buckets."""
    import jax
    import jax.numpy as jnp
    from spamtree_tpu.model import core as cj

    limited = request.param != "full"
    if request.param == "config5":
        ms_j, ms_t, spec, rng = _models(True, n_loc=1000, seed=0,
                                        imbalance=(0.8, 0.2))
        thin = [t for t in range(len(ms_t.levels)) if not ms_t.level_is_ref[t]]
        assert len(thin) >= 3 and len(ms_t.pred_arrays) >= 2
        assert len({ms_t.level_lp[t] for t in thin}) == 1
        assert not any(ms_t.level_aligned[t] for t in thin)
        assert set(ms_t.level_chunks) == {1}
        # the prediction operators stay in the carried state, as at n = 1e6
        # (12 MB there against the 256 MB threshold)
        assert ms_t.pred_in_carry and ms_j.pred_in_carry
    else:
        ms_j, ms_t, spec, rng = _models(limited, align_min_p=1)
    assert ms_t.limited_tree == limited
    for f in ("serves_as_sweep_parent", "joint_pad", "level_aligned"):
        assert getattr(ms_t, f) == getattr(ms_j, f), f
    composed = [t for t in range(len(ms_t.levels))
                if ms_t.level_is_ref[t] and ct._compose_children(ms_t, t)]
    assert composed == [t for t in range(len(ms_j.levels))
                        if ms_j.level_is_ref[t]
                        and cj._compose_children(ms_j, t)]
    assert bool(composed) != limited  # composed parts only on full trees
    theta = jnp.asarray(spec.start, jnp.float64)
    w = np.append(rng.normal(size=ms_t.n) * 0.4, 0.0)
    ld, _, _, ok0 = jax.jit(lambda t: cj.sweep(ms_j, t, jnp.asarray(w)))(
        theta)
    assert bool(ok0)
    return dict(ms_j=ms_j, ms_t=ms_t, w=w, ld=ld, prop=np.asarray(
        theta) * 1.12 + 0.01, limited=limited)


def _spy(monkeypatch, name):
    """Count the calls of ops.level.<name> made through the model core."""
    calls = []
    fn = getattr(level, name)

    def spy(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(level, name, spy)
    return calls


@pytest.mark.parametrize("kernels", ["1", "0"], ids=["kernels", "plain"])
@pytest.mark.parametrize("composed", ["1", "0"], ids=["composed", "joint"])
def test_decision_sweep_matches_jax(tree, monkeypatch, kernels, composed):
    """The port's sweep(decision_only=True) against the JAX package's, with
    both gates set alike for both packages, and against the port's own full
    sweep."""
    import jax
    import jax.numpy as jnp
    from spamtree_tpu.model import core as cj

    monkeypatch.setenv("SPAMTREE_LEVEL_KERNELS", kernels)
    monkeypatch.setenv("SPAMTREE_COMPOSED_FACTORS", composed)
    ms_j, ms_t, w, ld = tree["ms_j"], tree["ms_t"], tree["w"], tree["ld"]
    prop = tree["prop"]
    ref = jax.jit(lambda t: cj.sweep(ms_j, t, jnp.asarray(w), quad_prev=ld,
                                     decision_only=True))(jnp.asarray(prop))
    calls = _spy(monkeypatch, "thin_decision_level")
    got = ct.sweep(ms_t, _t(prop), _t(w), quad_prev=_ld_t(ld),
                   decision_only=True, coords_cache=ct.level_coords(ms_t))
    # K4 runs where the thin level's parent is an assembled joint
    k4 = kernels == "1" and (composed == "0" or tree["limited"])
    assert bool(calls) == k4
    full = ct.sweep(ms_t, _t(prop), _t(w), quad_prev=_ld_t(ld))
    assert bool(got[1]) and bool(ref[1]) and bool(full[3])
    for i, j in ((0, 2), (2, 4), (3, 5)):
        np.testing.assert_allclose(float(got[i]), float(ref[i]), rtol=1e-10)
        np.testing.assert_allclose(float(got[i]), float(full[j]), rtol=1e-10)
    assert float(got[2]) != 0.0 and float(got[3]) != 0.0


def test_gibbs_w_thin_kernel_matches_jax(tree, monkeypatch):
    """gibbs_w with the K3 branch on (carried Gram blocks), in both
    packages, given the same normal vector; and against the port's own
    plain branch."""
    import jax
    import jax.numpy as jnp
    from spamtree_tpu.model import core as cj

    monkeypatch.setenv("SPAMTREE_LEVEL_KERNELS", "1")
    ms_j, ms_t, w, ld = tree["ms_j"], tree["ms_t"], tree["w"], tree["ld"]
    ti = np.asarray([4.0, 7.0])
    XB = np.zeros(ms_t.n + 1)
    key = jax.random.PRNGKey(7)
    ref = jax.jit(lambda: cj.gibbs_w(
        ms_j, ld, jnp.asarray(w), jnp.asarray(ti), jnp.asarray(XB), key,
        gram=cj.msg_gram(ms_j, ld)))()
    z = np.asarray(jax.random.normal(key, (ms_t.n + 1,), dtype=jnp.float64))
    ld_t = _ld_t(ld)
    gram = ct.gram_full(ms_t, ld_t)
    calls = _spy(monkeypatch, "thin_gibbs_level")
    got = ct.gibbs_w(ms_t, ld_t, _t(w), _t(ti), _t(XB), _t(z), gram=gram[0],
                     routed=gram[1])
    n_thin = sum(1 for t in range(len(ms_t.levels))
                 if not ms_t.level_is_ref[t]
                 and ms_t.levels[t].prows.shape[1] > 0)
    assert len(calls) == n_thin  # K3's hook on every thin level
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9,
                               atol=1e-9 * float(np.abs(ref).max()))
    monkeypatch.setenv("SPAMTREE_LEVEL_KERNELS", "0")
    plain = ct.gibbs_w(ms_t, ld_t, _t(w), _t(ti), _t(XB), _t(z), gram=gram[0],
                       routed=gram[1])
    assert len(calls) == n_thin
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-11,
                               atol=1e-12)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K3 and K4 against their plain versions on the card, f32 and f64,
    aligned and through lp_pos, with a masked block and an ok=False block;
    run on the card with
    ``python -m pytest --noconftest -m cuda tests/test_torch_level.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    names = ("Kxc", "joint", "lp_pos", "wpar", "w_r", "prevH", "prevprec",
             "kdiag", "rmask_f")
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        for case, c in sorted(DECISION_CASES.items()):
            aligned = "lp_pos" not in c
            d = _decision_inputs(len(case), **c)
            if case == "not_ok":
                d["kdiag"][4] = 1e-3
            args = [torch.as_tensor(d[k], device="cuda",
                                    dtype=torch.int64 if k == "lp_pos"
                                    else dtype) for k in names]
            before = kernel_counts.snapshot()
            pk = level.thin_decision_partials(*args, aligned=aligned)
            torch.cuda.synchronize()
            assert kernel_counts.diff(before)["k4_launches"] == 1
            pp = level.thin_decision_partials_plain(*args, aligned=aligned)
            assert torch.equal(pk[:, 3], pp[:, 3])
            assert ((pk - pp).abs() <= tol * pp.abs().clamp(min=1)).all()
        rng = np.random.default_rng(1)
        B, S, P = 5, 70, 300
        ga = [rng.normal(size=(B, S, P)), rng.uniform(0.5, 2, size=(B, S)),
              rng.normal(size=(B, P)), rng.normal(size=(B, S)),
              rng.uniform(2, 5, size=(B, S)), rng.normal(size=(B, S)),
              (rng.uniform(size=(B, S)) > 0.2).astype(float)]
        ga = [torch.as_tensor(a, device="cuda", dtype=dtype) for a in ga]
        wk, mk = level.thin_gibbs_level(*ga)
        wp, mp = level.thin_gibbs_level_plain(*ga)
        torch.cuda.synchronize()
        for k, p in ((wk, wp), (mk, mp)):
            assert ((k - p).abs() <= tol * p.abs().clamp(min=1)).all()


@pytest.mark.cuda
def test_decision_chains_on_card():
    """thin_decision_chains on the card, f32 and f64: one K4 launch over the
    three chains' folded blocks, each chain's values within the tolerance
    of thin_decision_chains_plain on the same inputs, and the failing
    block's chain alone ok=False."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        for case in sorted(DECISION_CASES):
            d, aligned = _chain_inputs(case)
            a = {k: torch.as_tensor(v, device="cuda",
                                    dtype=torch.int64 if k == "lp_pos"
                                    else dtype) for k, v in d.items()}
            before = kernel_counts.snapshot()
            got = level.thin_decision_chains(**a, aligned=aligned)
            torch.cuda.synchronize()
            assert kernel_counts.diff(before)["k4_launches"] == 1
            ref = level.thin_decision_chains_plain(**a, aligned=aligned)
            assert got[1].tolist() == ref[1].tolist() == [True, False, True]
            for i in (0, 2, 3):
                assert ((got[i] - ref[i]).abs()
                        <= tol * ref[i].abs().clamp(min=1)).all(), (case, i)


@pytest.mark.cuda
def test_gibbs_variants_on_card():
    """K3 at every case of the schedule test, f32 and f64: the launcher's
    choice is the one this file derives from the source, the kernel agrees
    with the plain version, and two runs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for case, (B, S, P, _, _) in sorted(K3_CASES.items()):
        for dtype, table, tol in ((torch.float32, "f32", 1e-4),
                                  (torch.float64, "f64", 1e-10)):
            assert (level.thin_gibbs_variant(S, P, dtype)
                    == _k3_variant(S, P, table)[0]), (case, dtype)
            d = {k: v.to(device="cuda", dtype=dtype)
                 for k, v in _gibbs_inputs(len(case), B, S, P).items()}
            got = level.thin_gibbs_level(**d)
            again = level.thin_gibbs_level(**d)
            ref = level.thin_gibbs_level_plain(**d)
            torch.cuda.synchronize()
            for g, a, r in zip(got, again, ref):
                assert torch.equal(g, a), (case, dtype)
                assert ((g - r).abs() <= tol * r.abs().clamp(min=1)).all(), (
                    case, dtype)
