"""Model-core port parity: the likelihood sweep, w-Gibbs, prediction and
the conjugate tail of spamtree_tpu_torch equal the JAX package's in
float64 on the same tree, the same state and the same draws.

rtol 1e-9, with atol 1e-9 x max|reference| for entries near zero: both
run the same algebra, but the Cholesky factorisations (LAPACK in the port,
XLA's in the JAX package) and the batched products sum in different
orders; over a few levels of Schur complements that leaves relative
differences around 1e-12..1e-10."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spamtree_tpu.model import core as cj
from spamtree_tpu.model.params import make_theta_spec
from spamtree_tpu.tree.partition import make_tree as make_tree_jax
from spamtree_tpu.tree.schedule import build_schedule as build_schedule_jax
from spamtree_tpu_torch.model import core as ct
from spamtree_tpu_torch.tree.partition import make_tree
from spamtree_tpu_torch.tree.schedule import build_schedule

RTOL = 1e-9


def _models(case):
    """JAX and port models of one dataset with missing rows; "elevation":
    a third coordinate column, covariance model 2 (AG10 with elevation)."""
    q = 2 if case.startswith("biv") else 1
    chunk_bytes = 2e4 if case.endswith("chunked") else 512e6
    elevation = case == "elevation"
    rng = np.random.default_rng(3)
    n = 360
    if elevation:
        coords = np.column_stack([rng.uniform(size=(n, 2)),
                                  0.3 * rng.uniform(size=n)])
        mv = np.zeros(n, dtype=np.int64)
    elif q == 1:
        coords = rng.uniform(size=(n, 2))
        mv = np.zeros(n, dtype=np.int64)
    else:
        coords = np.repeat(rng.uniform(size=(n // 2, 2)), 2, axis=0)
        mv = np.tile(np.arange(2), n // 2)
    order = np.lexsort((np.arange(n),)
                       + tuple(coords[:, j] for j in range(coords.shape[1] - 1,
                                                            -1, -1)))
    coords, mv = coords[order], mv[order]
    na = rng.uniform(size=n) > 0.15
    y = rng.normal(size=n)
    y[~na] = np.nan
    X = np.column_stack([np.ones(n), rng.normal(size=n)])
    kw = dict(axis_cell_size=3, K=2)
    tree_j = make_tree_jax(coords, na, mv, rng=np.random.default_rng(0), **kw)
    tree_t = make_tree(coords, na, mv, rng=np.random.default_rng(0), **kw)
    spec = make_theta_spec(coords.shape[1], q, elevation=elevation).spec
    ms_j = cj.ModelStatic(build_schedule_jax(tree_j), coords, mv, y, X, spec,
                          dtype=jnp.float64, chunk_bytes=chunk_bytes)
    ms_t = ct.ModelStatic(build_schedule(tree_t), coords, mv, y, X, spec,
                          dtype=torch.float64, chunk_bytes=chunk_bytes,
                          device="cpu")
    return ms_j, ms_t, rng


def _theta(case, q, rng):
    if case == "elevation":
        th = np.array([1.2, 0.4, 4.0, 6.0, 2.0])  # ..., d_elevation
    elif q == 1:
        th = np.array([1.2, 0.4, 4.0, 6.0])  # ai1, ai2, phi_i, thetamv
    else:
        th = np.array([1.1, 0.7, 0.3, 0.2, 5.0, 4.0, 6.0, 0.8])
    return th * rng.uniform(0.9, 1.1, size=th.shape)


def _t(a):
    return torch.as_tensor(np.array(a))


def _ld_t(ld):
    return tuple(ct.LevelData(_t(d.H), _t(d.prec)) for d in ld)


def _close(got, ref, what, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    atol = rtol * max(float(np.abs(ref).max()), 1.0) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


CASES = ["univariate", "bivariate", "bivariate_chunked", "elevation"]
TAUSQ_AB = (2.01, 1.0)


def _jax_reference(ms_j, th0, th1, w, tausq_inv, XB, key):
    """Every JAX-package result the tests compare with, as ONE jitted
    program (eager JAX compiles each op separately: ~20 s per case)."""
    kw, kp, kq, kb = jax.random.split(key, 4)
    kz = jax.random.fold_in(key, 1)
    p = ms_j.p
    Vi = 0.01 * jnp.eye(p)

    def run(m, th0, th1, w, tausq_inv, XB):
        ld0, pd0, _, ok0 = cj.sweep(m, th0, w)
        ld1, pj1, lg1, ok1, qn1, qc1 = cj.sweep(
            m, th1, w, quad_prev=ld0, emit_pred_joint=True)
        g0 = cj.gram_full(m, ld0)
        w_gram = cj.gibbs_w(m, ld0, w, tausq_inv, XB, kw, gram=g0[0],
                            routed=g0[1])
        w_plain = cj.gibbs_w(m, ld0, w, tausq_inv, XB, kw)
        w_pred = cj.predict(m, pd0, w_gram, kp)
        tail = cj.gibbs_beta_tausq(m, w_pred, XB, kq, kb, TAUSQ_AB, Vi,
                                   jnp.zeros(p))
        tinv_sep = cj.gibbs_tausq(m, w_pred, XB, kq, TAUSQ_AB)
        y2 = 0.5 * m.y + XB
        beta_sep = cj.gibbs_beta(m, w_pred, tinv_sep, kb, Vi, jnp.zeros(p),
                                 y=y2)
        return dict(
            ld0=ld0, pd0=pd0, ok0=ok0, ld1=ld1, pj1=pj1, lg1=lg1, ok1=ok1,
            qn1=qn1, qc1=qc1, routed0=g0[1],
            po1=cj.pred_operators_from_joint(m, th1, pj1),
            w_gram=w_gram, w_plain=w_plain, w_pred=w_pred, tail=tail,
            tinv_sep=tinv_sep, y2=y2, beta_sep=beta_sep,
            w_prior=cj.prior_sample_w(m, ld0, kz),
            z_prior=jax.random.normal(kz, w.shape, dtype=w.dtype),
            z_w=jax.random.normal(kw, w.shape, dtype=w.dtype),
            z_p=jax.random.normal(kp, w.shape, dtype=w.dtype),
            g=jax.random.gamma(kq, TAUSQ_AB[0] + m.n_obs_by_q / 2.0,
                               dtype=w.dtype),
            zb=jax.random.normal(kb, (p, m.q), dtype=w.dtype),
        )

    ms_j.materialize_device()
    out = jax.jit(run)(ms_j, *(jnp.asarray(a) for a in
                               (th0, th1, w, tausq_inv, XB)))
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module", params=CASES)
def setup(request):
    ms_j, ms_t, rng = _models(request.param)
    q = ms_t.q
    th0, th1 = (_theta(request.param, q, rng),
                _theta(request.param, q, rng))
    w = rng.normal(size=ms_t.n + 1)
    w[-1] = 0.0
    tausq_inv = rng.uniform(2.0, 8.0, size=q)
    XB = np.append(rng.normal(size=ms_t.n) * 0.3, 0.0)
    ref = _jax_reference(ms_j, th0, th1, w, tausq_inv, XB,
                         jax.random.PRNGKey(7))
    assert bool(ref["ok0"]) and bool(ref["ok1"])
    return dict(ms_j=ms_j, ms_t=ms_t, th0=th0, th1=th1, w=w,
                tausq_inv=tausq_inv, XB=XB, ref=ref, case=request.param)


def test_layout_matches(setup):
    """The port's ModelStatic makes the JAX package's chunking, alignment,
    grouping and segment decisions and pads to the same shapes."""
    ms_j, ms_t = setup["ms_j"], setup["ms_t"]
    for f in ("level_chunks", "level_aligned", "level_group_c", "level_lp",
              "level_is_ref", "pred_chunks", "pred_aligned", "pred_lp",
              "joint_pad", "serves_as_parent", "last_consumer", "seg_level",
              "pred_in_carry"):
        assert getattr(ms_t, f) == getattr(ms_j, f), f
    assert ms_t.level_segs == ms_j.level_segs
    for lt, lj in zip(ms_t.levels + ms_t.pred_arrays,
                      ms_j.levels + ms_j.pred_arrays):
        for a, b in zip(lt, lj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if setup["case"].endswith("chunked"):
        assert max(ms_t.level_chunks) > 1
    assert max(ms_t.level_group_c) > 1


def test_sweep_matches(setup):
    """sweep(quad_prev=..., emit_pred_joint=True): logdet, ok, both
    quadratic forms, every level's H/prec and the prediction joint; the
    prediction operators built from that joint and by the plain sweep."""
    ms_t, th1, w, ref = setup["ms_t"], setup["th1"], setup["w"], setup["ref"]
    coords_cache = ct.level_coords(ms_t)
    ld_t, pj_t, lg_t, ok_t, qn_t, qc_t = ct.sweep(
        ms_t, _t(th1), _t(w), quad_prev=_ld_t(ref["ld0"]),
        emit_pred_joint=True, coords_cache=coords_cache)
    assert bool(ok_t)
    for got, key in ((lg_t, "lg1"), (qn_t, "qn1"), (qc_t, "qc1"),
                     (pj_t, "pj1")):
        _close(got, ref[key], key)
    assert len(ld_t) == len(ref["ld1"])
    for t, (a, b) in enumerate(zip(ld_t, ref["ld1"])):
        _close(a.H, b.H, f"H[{t}]")
        _close(a.prec, b.prec, f"prec[{t}]")

    po_t = ct.pred_operators_from_joint(ms_t, _t(th1), pj_t, coords_cache)
    _, pd_t, _, _ = ct.sweep(ms_t, _t(th1), _t(w))
    for a, b, c in zip(po_t, ref["po1"], pd_t):
        _close(a.H, b.H, "pred H")
        _close(a.prec, b.prec, "pred r")
        _close(c.H, b.H, "sweep pred H")
        _close(c.prec, b.prec, "sweep pred r")


@pytest.mark.parametrize("carried_gram", [True, False])
def test_gibbs_w_predict_and_tail_match(setup, carried_gram):
    """gibbs_w (with the carried Gram blocks, and forming them in place),
    predict and gibbs_beta_tausq given the same draws; the sentinel w[n]
    stays 0 through every scatter."""
    ms_t, ref = setup["ms_t"], setup["ref"]
    ld_t = _ld_t(ref["ld0"])
    gram_kw = {}
    if carried_gram:
        g_t = ct.gram_full(ms_t, ld_t)
        for a, b in zip(g_t[1], ref["routed0"]):
            if not isinstance(b, tuple):
                _close(a, b, "routed gram")
        gram_kw = dict(gram=g_t[0], routed=g_t[1])
    w_in = _t(setup["w"])
    w_t = ct.gibbs_w(ms_t, ld_t, w_in, _t(setup["tausq_inv"]),
                     _t(setup["XB"]), _t(ref["z_w"]), **gram_kw)
    _close(w_t, ref["w_gram" if carried_gram else "w_plain"], "gibbs_w")
    assert w_t[ms_t.n] == 0.0
    assert torch.equal(w_in, _t(setup["w"]))  # input untouched
    if not carried_gram:
        return

    wp_t = ct.predict(ms_t, _ld_t(ref["pd0"]), w_t, _t(ref["z_p"]))
    _close(wp_t, ref["w_pred"], "predict")
    assert wp_t[ms_t.n] == 0.0

    p = ms_t.p
    _close(ct.tausq_shape(ms_t, TAUSQ_AB), TAUSQ_AB[0] + ms_t.n_obs_by_q / 2,
           "gamma shape")
    out_t = ct.gibbs_beta_tausq(
        ms_t, wp_t, _t(setup["XB"]), _t(ref["g"]), _t(ref["zb"]), TAUSQ_AB,
        _t(0.01 * np.eye(p)), torch.zeros(p, dtype=torch.float64))
    for got, r, what in zip(out_t, ref["tail"], ("tausq_inv", "beta", "XB")):
        _close(got, r, what)


def test_prior_draw_and_separate_tail_match(setup):
    """prior_sample_w (the Geweke tests' forward draw of w from the treed
    prior) and the separate gibbs_tausq / gibbs_beta (the tail when debug
    switches one of the two off; beta with a given y) on the same draws."""
    ms_t, ref = setup["ms_t"], setup["ref"]
    w_t = ct.prior_sample_w(ms_t, _ld_t(ref["ld0"]), _t(ref["z_prior"]))
    _close(w_t, ref["w_prior"], "prior_sample_w")
    assert w_t[ms_t.n] == 0.0
    wp, XB, p = _t(ref["w_pred"]), _t(setup["XB"]), ms_t.p
    tinv = ct.gibbs_tausq(ms_t, wp, XB, _t(ref["g"]), TAUSQ_AB)
    _close(tinv, ref["tinv_sep"], "gibbs_tausq")
    beta, XBn = ct.gibbs_beta(ms_t, wp, tinv, _t(ref["zb"]),
                              _t(0.01 * np.eye(p)),
                              torch.zeros(p, dtype=torch.float64),
                              y=_t(ref["y2"]))
    _close(beta, ref["beta_sep"][0], "gibbs_beta beta")
    _close(XBn, ref["beta_sep"][1], "gibbs_beta XB")
