"""The fused thin-level kernels (ops.level, K3 and K4/K5) and the sweeps
that reach them: the plain versions against the Pallas kernels they replace
(interpret mode on the CPU), the port's decision-only sweep and its K3
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
from spamtree_tpu_torch.ops import level
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


def _k4_tiling():
    """K4's tiling as csrc/thin_level.cu declares it (its top-level
    ``constexpr int`` lines), so that the emulation follows the kernel:
    TP rows of LAi per row tile, TQ contraction depth per stage, slab width
    W (up to W - 1 columns of Kxc and u's column)."""
    src = (Path(level.__file__).resolve().parents[1] / "csrc"
           / "thin_level.cu").read_text()
    env = {}
    for decl in re.findall(r"^constexpr int ([^;]+);", src, re.M):
        for part in decl.split(","):
            name, expr = (x.strip() for x in part.split("=", 1))
            env[name] = eval(expr, {"__builtins__": {}}, env)
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
    before = (level.LAUNCHES_GIBBS, level.LAUNCHES_DECISION)
    d = _decision_inputs(0, B=3, Bp=2, P=5, S=4, lp_pos=[1, 0, 1])
    level.thin_decision_level(*(_t(d[k]) for k in (
        "Kxc", "joint", "lp_pos", "wpar", "w_r", "prevH", "prevprec",
        "kdiag", "rmask_f")))  # CPU: the plain version, never counted
    assert (level.LAUNCHES_GIBBS, level.LAUNCHES_DECISION) == before


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


def _models(limited, align_min_p=128, n_loc=220, seed=3):
    """JAX and port models of one bivariate dataset (tests/test_pallas_level
    .py's, with ``align_min_p=1`` optional so that composed parts activate,
    as tests/test_composed_sweep.py)."""
    import jax.numpy as jnp
    from spamtree_tpu.model import core as cj
    from spamtree_tpu.model import params as pj
    from spamtree_tpu.tree.partition import make_tree as make_tree_jax
    from spamtree_tpu.tree.schedule import (
        build_schedule as build_schedule_jax)

    rng = np.random.default_rng(seed)
    coords = np.repeat(rng.uniform(size=(n_loc, 2)), 2, axis=0)
    mv = np.tile(np.arange(2), n_loc)
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
        coords, mv, y, X, spec.spec, dtype=torch.float64)
    thin = [t for t in range(len(ms_t.levels))
            if not ms_t.level_is_ref[t] and ms_t.levels[t].prows.shape[1] > 0]
    assert thin, "the model must have a thin level with parents"
    return ms_j, ms_t, spec, rng


def _ld_t(ld):
    return tuple(ct.LevelData(_t(d.H), _t(d.prec)) for d in ld)


@pytest.fixture(scope="module", params=["full", "limited"])
def tree(request):
    import jax
    import jax.numpy as jnp
    from spamtree_tpu.model import core as cj

    limited = request.param == "limited"
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
    assert calls
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9,
                               atol=1e-9 * float(np.abs(ref).max()))
    monkeypatch.setenv("SPAMTREE_LEVEL_KERNELS", "0")
    plain = ct.gibbs_w(ms_t, ld_t, _t(w), _t(ti), _t(XB), _t(z), gram=gram[0],
                       routed=gram[1])
    assert len(calls) == 1
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
            before = level.LAUNCHES_DECISION
            pk = level.thin_decision_partials(*args, aligned=aligned)
            torch.cuda.synchronize()
            assert level.LAUNCHES_DECISION == before + 1
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
