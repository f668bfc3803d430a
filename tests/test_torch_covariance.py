"""Covariance port parity: pairwise_cov, pairwise_cov_diag, unpack_theta and
cross_covariance_ag10 equal the JAX functions in float64 on the same
numpy-made inputs.  rtol 1e-12: the same elementwise formulas, so only
libm rounding of exp/sqrt/log1p separates the two.

``cov_block`` (the masked blocks the sweeps call): on the CPU its plain
route gives ``pairwise_cov`` and the mask, bit for bit, with and without a
chain axis, counted as plain calls; models 1 and 2 and a substituted
formula keep that route; the sweep reaches ``model.core.pairwise_cov``.
On a card (``-m cuda``): kernel K6 against the plain version at every
level shape of the benchmark's configurations, at q = 1, 2, 3 and 5, in
f32 and f64, with four chains, and replayed from a CUDA graph."""

import numpy as np
import pytest
import torch

from spamtree_tpu_torch.ops import covariance as ct
from spamtree_tpu_torch.ops import kernel_counts
from spamtree_tpu_torch.ops.linalg import chol_inv_masked, identity_pad

# jax is imported inside the test that compares with the JAX package, so
# that the card tests also run where jax is absent:
#   python -m pytest --noconftest -m cuda tests/test_torch_covariance.py

RTOL = 1e-12

# (model, q, dd): AG10 q=1 fast path / q=2 closed form / q=3 Gneiting base,
# nonspatial univariate, AG10 with elevation
CASES = [(0, 1, 2), (0, 2, 2), (0, 3, 2), (1, 1, 3), (2, 2, 3)]


def _inputs(model, q, dd, seed=0):
    from spamtree_tpu.ops import covariance as cj

    rng = np.random.default_rng(seed)
    spec_j = cj.make_cov_model(dd, q, model)
    nt = spec_j.npars + spec_j.k
    theta = rng.uniform(0.3, 2.0, size=nt)
    if model in (0, 2) and q > 2:
        theta[3 * q + 1] = 0.4  # beta_psi1 in (0, 1)
    c1, c2 = rng.uniform(size=(3, 7, dd)), rng.uniform(size=(3, 5, dd))
    m1, m2 = rng.integers(0, q, size=(3, 7)), rng.integers(0, q, size=(3, 5))
    c2[0, 0] = c1[0, 0]  # a zero-distance pair (model 1's nugget term)
    return spec_j, theta, c1, m1, c2, m2


@pytest.mark.parametrize("model,q,dd", CASES,
                         ids=[f"model{m}_q{q}" for m, q, _ in CASES])
def test_covariance_matches_jax(model, q, dd):
    import jax.numpy as jnp
    from spamtree_tpu.ops import covariance as cj

    spec_j, theta, c1, m1, c2, m2 = _inputs(model, q, dd)
    spec_t = ct.make_cov_model(dd, q, model)
    assert tuple(spec_t) == tuple(spec_j)
    pj = cj.unpack_theta(jnp.asarray(theta), spec_j)
    pt = ct.unpack_theta(torch.as_tensor(theta), spec_t)
    for a, b in zip(pj, pt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL)

    # batched port vs per-block JAX calls
    kt = ct.pairwise_cov(torch.as_tensor(c1), torch.as_tensor(m1),
                         torch.as_tensor(c2), torch.as_tensor(m2), pt, spec_t)
    dt = ct.pairwise_cov_diag(torch.as_tensor(c1), torch.as_tensor(m1), pt,
                              spec_t)
    for b in range(c1.shape[0]):
        kj = cj.pairwise_cov(jnp.asarray(c1[b]), jnp.asarray(m1[b]),
                             jnp.asarray(c2[b]), jnp.asarray(m2[b]), pj, spec_j)
        np.testing.assert_allclose(kt[b].numpy(), np.asarray(kj), rtol=RTOL)
        dj = cj.pairwise_cov_diag(jnp.asarray(c1[b]), jnp.asarray(m1[b]), pj,
                                  spec_j)
        np.testing.assert_allclose(dt[b].numpy(), np.asarray(dj), rtol=RTOL)
        kself = ct.pairwise_cov(torch.as_tensor(c1[b]), torch.as_tensor(m1[b]),
                                torch.as_tensor(c1[b]), torch.as_tensor(m1[b]),
                                pt, spec_t)
        np.testing.assert_allclose(torch.diagonal(kself).numpy(),
                                   dt[b].numpy(), rtol=RTOL)

    if model == 0 and q >= 2:
        ai1, ai2, phi = theta[:q], theta[q:2 * q], theta[2 * q:3 * q]
        tmv = theta[3 * q:3 * q + spec_j.n_cbase]
        D = np.array(pj.Dmat)
        args = (c1[0], m1[0] + 1, c2[0], m2[0] + 1, ai1, ai2, phi, tmv, D)
        np.testing.assert_allclose(ct.cross_covariance_ag10(
                                       *args, device="cpu").numpy(),
                                   np.asarray(cj.cross_covariance_ag10(*args)),
                                   rtol=RTOL)


# -- cov_block ---------------------------------------------------------------


def _block_inputs(q, B=4, n1=9, n2=6, C=None, model=0, dd=2, seed=3,
                  dtype=torch.float64, device="cpu"):
    """Seeded coordinates, margins, masks (a padded tail, as a level's) and
    parameters (with a chain axis of C) of one cov_block call."""
    spec = ct.make_cov_model(dd, q, model)
    rng = np.random.default_rng(seed)
    nt = spec.npars + spec.k
    theta = rng.uniform(0.3, 2.0, size=(nt,) if C is None else (C, nt))
    if model in (0, 2) and q > 2:
        theta[..., 3 * q + 1] = 0.4  # beta_psi1 in (0, 1)
    t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=device)
    mask = lambda n: t(np.arange(n)[None, :] < rng.integers(
        1, n + 1, size=(B, 1)), torch.bool)
    return dict(cx1=t(rng.uniform(size=(B, n1, dd))),
                mv1=t(rng.integers(0, q, size=(B, n1)), torch.int64),
                cx2=t(rng.uniform(size=(B, n2, dd))),
                mv2=t(rng.integers(0, q, size=(B, n2)), torch.int64),
                m1=mask(n1), m2=mask(n2),
                params=ct.unpack_theta(t(theta), spec), spec=spec)


def _today(d, eye):
    """What the sweeps computed before ``cov_block``: pairwise_cov, then
    the caller's mask (or its identity pad)."""
    if eye:
        K = ct.pairwise_cov(d["cx1"], d["mv1"], d["cx1"], d["mv1"],
                            d["params"], d["spec"])
        return identity_pad(K, d["m1"])
    K = ct.pairwise_cov(d["cx1"], d["mv1"], d["cx2"], d["mv2"],
                        d["params"], d["spec"])
    return K * (d["m1"][:, :, None] & d["m2"][:, None, :])


def _call(d, eye, fn=ct.cov_block, **kw):
    """``fn`` (``cov_block`` or its plain version) on ``d``: Kcc
    identity-padded by m1 with ``eye``, else Kxc masked by m1 x m2."""
    if eye:
        return fn(d["cx1"], d["mv1"], d["cx1"], d["mv1"], d["params"],
                  d["spec"], d["m1"], eye=True, **kw)
    return fn(d["cx1"], d["mv1"], d["cx2"], d["mv2"], d["params"], d["spec"],
              d["m1"], d["m2"], **kw)


@pytest.mark.parametrize("eye", [False, True], ids=["masked", "eye"])
@pytest.mark.parametrize("C", [None, 3], ids=["one", "chains3"])
@pytest.mark.parametrize("q", [1, 2, 3, 5])
def test_cov_block_plain_route_is_pairwise_cov_then_the_mask(q, C, eye):
    """On the CPU ``cov_block`` gives what the sweeps computed before it,
    bit for bit: ``pairwise_cov`` times the (B, n1) x (B, n2) mask, or its
    identity pad; a chain axis leads; contiguous; one plain call counted,
    no launch."""
    d = _block_inputs(q, C=C)
    before = kernel_counts.snapshot()
    got = _call(d, eye)
    counts = kernel_counts.diff(before)
    want = _today(d, eye)
    assert got.shape == want.shape == ((C,) if C else ()) + (
        4, 9, 9 if eye else 6)
    assert got.is_contiguous()
    assert torch.equal(got, want)
    assert (counts["cov_launches"], counts["cov_plain_calls"]) == (0, 1)


@pytest.mark.parametrize("eye", [False, True], ids=["masked", "eye"])
def test_cov_block_takes_the_masks_its_form_needs(eye):
    """Every call masks: Kxc needs m1 and m2, the identity-padded Kcc m1
    alone; a call with the other form's masks raises on any device's
    route."""
    d = _block_inputs(2)
    a = (d["cx1"], d["mv1"], d["cx1" if eye else "cx2"],
         d["mv1" if eye else "mv2"], d["params"], d["spec"], d["m1"])
    with pytest.raises(ValueError, match="m2 mask"):
        ct.cov_block(*a, None if eye else d["m2"], eye=not eye)
    before = kernel_counts.snapshot()
    with pytest.raises(ValueError, match="m2 mask"):
        ct.cov_block(*a, d["m2"] if eye else None, eye=eye)
    assert kernel_counts.diff(before)["cov_plain_calls"] == 0


@pytest.mark.parametrize("model,q,dd", [(1, 1, 3), (2, 2, 3)],
                         ids=["model1", "model2"])
def test_cov_block_models_1_and_2_keep_the_plain_route(model, q, dd):
    """Models 1 and 2 (no cell runs them) take ``cov_block_plain`` and
    count a plain call."""
    d = _block_inputs(q, model=model, dd=dd)
    for eye in (False, True):
        before = kernel_counts.snapshot()
        assert torch.equal(_call(d, eye), _today(d, eye))
        counts = kernel_counts.diff(before)
        assert (counts["cov_launches"], counts["cov_plain_calls"]) == (0, 1)


def test_cov_block_takes_a_substituted_formula():
    """A formula handed as ``cov`` (what a fault control rebinds in
    ``model.core``) gives its own blocks under the caller's mask."""
    d = _block_inputs(3)
    swapped = lambda c1, m1, c2, m2, p, s: ct.pairwise_cov(
        c1, (s.q - 1) - m1, c2, (s.q - 1) - m2, p, s)
    got = _call(d, False, cov=swapped)
    want = swapped(d["cx1"], d["mv1"], d["cx2"], d["mv2"], d["params"],
                   d["spec"]) * (d["m1"][:, :, None] & d["m2"][:, None, :])
    assert torch.equal(got, want)
    assert not torch.equal(got, _today(d, False))


def test_identity_padded_block_factors_as_the_raw_one():
    """The limited tree factors ``cov_block``'s identity-padded Kcc where
    it factored the raw one: ``chol_inv_masked`` pads what it takes, so
    both give the same bits."""
    d = _block_inputs(2, B=5, n1=12)
    raw = ct.pairwise_cov(d["cx1"], d["mv1"], d["cx1"], d["mv1"],
                          d["params"], d["spec"])
    padded = _call(d, True)
    for a, b in zip(chol_inv_masked(raw, d["m1"]),
                    chol_inv_masked(padded, d["m1"])):
        assert torch.equal(a, b)


def test_sweep_reaches_the_formula_model_core_names(monkeypatch):
    """Every block of a sweep goes through ``model.core.pairwise_cov``,
    looked up at the call: the benchmark's ``margins_swapped`` control
    rebinds that name and must reach the covariance."""
    from spamtree_tpu_torch.api import prepare_fit
    from spamtree_tpu_torch.model import core

    rng = np.random.default_rng(0)
    n = 120
    coords = rng.uniform(size=(n, 2))
    mv = np.tile([1, 2], n // 2)
    y = rng.normal(size=n)
    fit = prepare_fit(y, np.ones((n, 1)), coords, mv_id=mv, cell_size=25,
                      mcmc=dict(keep=2, burn=2, thin=1), device="cpu",
                      dtype=torch.float64)
    seen = []

    def spy(*a):
        seen.append(a[0].shape)
        return ct.pairwise_cov(*a)

    theta = fit.state.theta
    _, _, ld, ok = core.sweep(fit.ms, theta, fit.state.w, build_pred=False)
    monkeypatch.setattr(core, "pairwise_cov", spy)
    _, _, ld2, ok2 = core.sweep(fit.ms, theta, fit.state.w, build_pred=False)
    n_ref = sum(fit.ms.level_is_ref)
    n_par = sum(lvl.prows.shape[1] > 0 for lvl in fit.ms.levels)
    assert len(seen) == n_ref + n_par
    assert torch.equal(ld, ld2) and bool(ok) and bool(ok2)


# -- kernel K6 on a card ------------------------------------------------------

# |K6 - plain| <= RTOL * |plain| elementwise, and the same zeros and NaNs:
# the kernel repeats the plain version's IEEE operations in its order and
# calls the same libm (expf, log1pf, sqrtf without fast-math), so the two
# differ at most by the libm's own rounding of one exp (a few ulps,
# amplified by the exponent's size, at most ~30 here)
K6_RTOL = {torch.float32: 4e-6, torch.float64: 1e-14}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 has no CPU mode")


def _close(got, want, dtype):
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got == 0, want == 0)
    err = ((got - want).abs() / want.abs().clamp_min(1e-300)).nan_to_num()
    assert float(err.max()) <= K6_RTOL[dtype], float(err.max())


# every covariance-block call of a sweep of each benchmark configuration
# on the card (f32, layout seed 7, fit seed 1): its q, then (B, S, P) of its
# reference levels (a Kcc call, identity-padded, and a Kxc call where P >
# 0), its thin levels and its prediction buckets (a Kxc call each); B is a
# slab's where the level runs in slabs (triv's and q5's deepest levels)
CARD_CALLS = {
    "biv_n1e5_ag10": (2, [(1, 46, 0), (4, 49, 46), (16, 50, 95),
                          (64, 50, 145), (256, 50, 195), (1024, 47, 245)],
                      [(1024, 70, 292)], [(1024, 23, 292)]),
    "climate_n1e6": (2, [(4 ** k, 25, 25 if k else 0) for k in range(8)],
                     [(6159, 23, 25), (5958, 29, 25), (3768, 37, 25),
                      (499, 55, 25)],
                     [(7109, 5, 25), (6435, 8, 25), (2350, 11, 25),
                      (451, 20, 25)]),
    "triv_n1.5e5_ag10": (3, [(1, 67, 0), (4, 71, 67), (16, 73, 138),
                             (64, 74, 211), (256, 75, 285), (512, 69, 360)],
                         [(512, 103, 429)], [(1024, 33, 429)]),
    "q5_n2.5e5_ag10": (5, [(1, 110, 0), (4, 118, 110), (16, 119, 228),
                           (64, 121, 347), (256, 122, 468), (344, 116, 590)],
                       [(256, 182, 706)], [(1032, 47, 706)]),
}


def _config_calls(name):
    """(q, [(B, n1, n2, eye)]) of a configuration's calls."""
    q, ref, thin, pred = CARD_CALLS[name]
    calls = [(B, S, S, True) for B, S, _ in ref]
    calls += [(B, P, S, False) for B, S, P in ref + thin + pred if P]
    return q, calls


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(CARD_CALLS))
def test_k6_matches_plain_at_the_configurations_levels(name, dtype):
    """K6 against ``cov_block_plain`` at every call shape of a sweep of
    the configuration (and config 3's with four chains): Kxc zero-masked,
    Kcc identity-padded; one launch a call, none on the plain route."""
    _card()
    q, calls = _config_calls(name)
    for i, (B, n1, n2, eye) in enumerate(calls):
        for C in ((None, 4) if name == "biv_n1e5_ag10" else (None,)):
            d = _block_inputs(q, B, n1, n2, C=C, seed=i, dtype=dtype,
                              device="cuda")
            before = kernel_counts.snapshot()
            got = _call(d, eye)
            assert kernel_counts.diff(before)["cov_launches"] == 1
            want = _call(d, eye, ct.cov_block_plain)
            torch.cuda.synchronize()
            _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("q", [1, 2, 3, 5, 16])
def test_k6_matches_plain_by_q_dtype_and_chains(q, dtype):
    """Each branch of the formula (the q = 1 fast path, q = 2, q > 2, up
    to the kernel's q = 16), with and without four chains, masked (padded
    tails, and all rows valid) and identity-padded; shapes past the
    kernel's 512-column tile and its 1024-row tile, one entry, and one
    row."""
    _card()
    for B, n1, n2 in ((7, 33, 19), (2, 5, 700), (1, 1300, 3), (1, 1, 1),
                      (3, 1, 40)):
        for C in (None, 4):
            d = _block_inputs(q, B, n1, n2, C=C, seed=q, dtype=dtype,
                              device="cuda")
            a = (d["cx1"], d["mv1"], d["cx2"], d["mv2"], d["params"],
                 d["spec"])
            _close(ct.cov_block(*a, d["m1"], d["m2"]),
                   ct.cov_block_plain(*a, d["m1"], d["m2"]), dtype)
            full = [torch.ones_like(d[k]) for k in ("m1", "m2")]
            _close(ct.cov_block(*a, *full), ct.cov_block_plain(*a, *full),
                   dtype)
            e = (d["cx1"], d["mv1"], d["cx1"], d["mv1"], d["params"],
                 d["spec"], d["m1"])
            _close(ct.cov_block(*e, eye=True),
                   ct.cov_block_plain(*e, eye=True), dtype)


@pytest.mark.cuda
def test_k6_replayed_from_a_cuda_graph():
    """Config 3's deepest reference level, Kxc and Kcc, captured in a CUDA
    graph (``model.graph.Graph``) and replayed: the eager call's bits, one
    launch a call counted on each replay and none by the capture."""
    _card()
    from spamtree_tpu_torch.model import graph

    d = _block_inputs(2, 1024, 245, 47, seed=1, dtype=torch.float32,
                      device="cuda")

    def part():
        return (_call(d, False), _call(d, True))

    eager = part()
    before = kernel_counts.snapshot()
    g = graph.Graph("cov", part, None, None)
    assert kernel_counts.snapshot() == before
    assert g.counted["cov_launches"] == 2
    assert g.counted["cov_plain_calls"] == 0
    for _ in range(3):
        g.replay()
    torch.cuda.synchronize()
    assert kernel_counts.diff(before)["cov_launches"] == 6
    for a, b in zip(g.out, eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k6_route_and_checks_on_the_card():
    """On a CUDA tensor: models 1 and 2 and a substituted formula take the
    plain route (no launch); model 0 raises on what K6 does not take --
    a half-precision dtype, q past 16, mismatched shapes, an identity pad
    of a non-square block -- rather than falling back."""
    _card()
    for model, q, dd in ((1, 1, 3), (2, 2, 3)):
        d = _block_inputs(q, model=model, dd=dd, device="cuda")
        before = kernel_counts.snapshot()
        got = _call(d, False)
        counts = kernel_counts.diff(before)
        assert (counts["cov_launches"], counts["cov_plain_calls"]) == (0, 1)
        assert torch.equal(got, _call(d, False, ct.cov_block_plain))
    d = _block_inputs(3, device="cuda")
    before = kernel_counts.snapshot()
    _call(d, False, cov=lambda *a: ct.pairwise_cov(*a))
    assert kernel_counts.diff(before)["cov_launches"] == 0
    h = _block_inputs(2, dtype=torch.float16, device="cuda")
    with pytest.raises(TypeError, match="dtype"):
        _call(h, False)
    with pytest.raises(ValueError, match="q=17"):
        _call(_block_inputs(17, device="cuda"), False)
    with pytest.raises(ValueError, match="mv2"):
        ct.cov_block(d["cx1"], d["mv1"], d["cx2"], d["mv1"], d["params"],
                     d["spec"], d["m1"], d["m2"])
    with pytest.raises(ValueError, match="eye"):
        ct.cov_block(d["cx1"], d["mv1"], d["cx2"], d["mv2"], d["params"],
                     d["spec"], d["m1"], eye=True)
