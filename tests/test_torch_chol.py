"""Kernel K1 (ops.chol): the plain version against the Pallas kernels it
replaces (interpret mode on the CPU), the ok=False contract on a non-SPD
block, the wrapper's input checks, and -- on a CUDA card only -- the kernel
itself against the plain version."""

import numpy as np
import pytest
import torch

from spamtree_tpu_torch.ops import chol, kernel_counts
from spamtree_tpu_torch.ops.linalg import chol_inv_masked

# jax is imported inside the tests that compare with the JAX package, so
# that the card test also runs where jax is absent:
#   python -m pytest --noconftest -m cuda tests/test_torch_chol.py


def _spd(B, S, seed, dtype=np.float64):
    M = np.random.default_rng(seed).normal(size=(B, S, S))
    return (M @ np.transpose(M, (0, 2, 1)) + S * np.eye(S)).astype(dtype)


@pytest.mark.parametrize("B,S", [(5, 7), (130, 16), (64, 50)])
def test_plain_matches_pallas_kernels(B, S):
    """rtol 1e-10 in float64: the two factorisations sum in different
    orders (LAPACK blocked vs the kernel's column loop)."""
    import jax.numpy as jnp
    from spamtree_tpu.ops.pallas_chol import chol_and_inv_lanes, inv_chol_lanes

    A = _spd(B, S, seed=S)
    L_p, X_p = chol.inv_chol_plain(torch.as_tensor(A), write_l=True)
    X_only = chol.inv_chol_plain(torch.as_tensor(A))
    L_k, X_k = chol_and_inv_lanes(jnp.asarray(A), interpret=True)
    X_k1 = inv_chol_lanes(jnp.asarray(A), interpret=True)
    for got, ref in ((L_p, L_k), (X_p, X_k), (X_only, X_k1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                                   atol=1e-12)
    np.testing.assert_array_equal(X_only.numpy(), X_p.numpy())


def test_non_spd_block_is_not_ok():
    """A non-SPD block gives ok=False (and only there) in the JAX package's
    chol_inv_masked and in both dispatches of the port's."""
    import jax.numpy as jnp
    from spamtree_tpu.ops.linalg import chol_inv_masked as chol_inv_masked_jax

    A = _spd(4, 6, seed=1)
    A[2, 0, 1] = A[2, 1, 0] = 50.0  # indefinite
    mask = np.ones((4, 6), dtype=bool)
    mask[3, 4:] = False  # padded slots become identity
    want = [True, True, False, True]
    _, _, ok_j = chol_inv_masked_jax(jnp.asarray(A), jnp.asarray(mask))
    assert np.asarray(ok_j).tolist() == want
    for use_kernel in (True, False):
        L, Linv, ok = chol_inv_masked(torch.as_tensor(A),
                                      torch.as_tensor(mask), use_kernel)
        assert ok.tolist() == want
        assert (L is None) == use_kernel
        assert torch.isnan(Linv[2]).all()
        assert torch.isfinite(Linv[[0, 1, 3]]).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    # shape/dtype checks run before any device work: a meta tensor
    # (no storage, no card) reaches them
    with pytest.raises(ValueError, match="S <= 96"):
        chol.inv_chol(torch.empty((2, 97, 97), device="meta"))
    with pytest.raises(ValueError, match="S <= 64"):  # float64's forms
        chol.inv_chol(torch.empty((2, 65, 65), dtype=torch.float64,
                                  device="meta"))
    with pytest.raises(TypeError):
        chol.inv_chol(torch.empty((2, 8, 8), dtype=torch.float16,
                                  device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        chol.inv_chol(torch.empty((2, 8, 8), device="meta"))
    with pytest.raises(ValueError, match="S=97"):
        chol_inv_masked(torch.eye(97)[None], torch.ones(1, 97, dtype=bool),
                        use_kernel=True)
    with pytest.raises(ValueError, match="S=65"):
        chol_inv_masked(torch.eye(65, dtype=torch.float64)[None],
                        torch.ones(1, 65, dtype=bool), use_kernel=True)
    before = kernel_counts.snapshot()
    chol.inv_chol(torch.as_tensor(_spd(3, 5, seed=0)))  # CPU: plain version
    assert kernel_counts.diff(before)["k1_launches"] == 0


def _inv_chol_right_looking(a):
    """Step-by-step emulation of csrc/inv_chol.cu's schedule: a right-looking
    Cholesky that carries the inverse along as an unscaled residual T
    (T = I at the start; row k of Linv is row k of T over L_kk).  At step k
    every row i > k subtracts (A[i, k] / L_kk^2) v from [T[i, :k+1] |
    A[i, k+1:]], with v = [T[k, :k], 1 | A[k+1:, k]]: one update of the
    trailing matrix and of the residual."""
    B, S, _ = a.shape
    A = a.clone()
    T = torch.eye(S, dtype=a.dtype).expand(B, S, S).clone()
    L = torch.zeros_like(a)
    rdiag = torch.zeros(B, S, dtype=a.dtype)
    for k in range(S):
        lkk = torch.sqrt(A[:, k, k])
        rk = 1.0 / lkk
        aik = A[:, k + 1:, k].clone()
        L[:, k, k] = lkk
        L[:, k + 1:, k] = aik * rk[:, None]
        rdiag[:, k] = rk
        f = aik * (rk * rk)[:, None]
        A[:, k + 1:, k + 1:] -= torch.tril(f[:, :, None] * aik[:, None, :])
        T[:, k + 1:, :k + 1] -= f[:, :, None] * T[:, k, None, :k + 1]
    return L, torch.tril(T * rdiag[:, :, None])


def _schedule_against_plain(S, dtype, tol):
    """The kernel's schedule against inv_chol_plain in ``dtype`` (within
    ``tol`` of the largest entry), and a non-SPD block that must turn NaN
    from its first bad pivot on, and only there."""
    B = 5
    A = _spd(B, S, seed=S + 3)
    if S == 1:
        A[2, 0, 0] = -1.0
    else:
        A[2, 0, 1] = A[2, 1, 0] = 10.0 * S
    bad_k = next(k for k in range(S)
                 if np.linalg.eigvalsh(A[2, :k + 1, :k + 1]).min() <= 0)
    a = torch.as_tensor(A.astype(dtype))
    L_e, X_e = _inv_chol_right_looking(a)
    L_p, X_p = chol.inv_chol_plain(a, write_l=True)
    good = [0, 1, 3, 4]
    for got, ref in ((L_e, L_p), (X_e, X_p)):
        np.testing.assert_allclose(got[good].numpy(), ref[good].numpy(),
                                   rtol=0, atol=tol * float(
                                       ref[good].abs().max()))
    low = torch.tril(torch.ones(S, S, dtype=torch.bool))
    assert torch.isfinite(X_e[2, :bad_k]).all()
    assert torch.isnan(X_e[2, bad_k:][low[bad_k:]]).all()
    d = torch.diagonal(X_e, dim1=-2, dim2=-1)
    ok = torch.all(torch.isfinite(d) & (d > 0), dim=-1)
    assert ok.tolist() == [True, True, False, True, True]
    _, _, ok_p = chol_inv_masked(a, torch.ones(B, S, dtype=torch.bool),
                                 use_kernel=S <= chol.max_s(a.dtype))
    assert ok_p.tolist() == ok.tolist()


@pytest.mark.parametrize("S", [1, 7, 47, 64, 65, 75, 96, 128])
def test_right_looking_schedule_matches_plain(S):
    """float64, rtol 1e-10 of the largest entry: another summation order.
    S 65-96 are the trivariate configuration's reference blocks (70-75
    rows) and the ends of the kernel's 96-thread form; 128 lies past the
    kernel, where the callers take the plain route."""
    _schedule_against_plain(S, np.float64, 1e-10)


@pytest.mark.parametrize("S", [65, 75, 96, 128])
def test_right_looking_schedule_matches_plain_f32(S):
    """float32, 1e-4 of the largest entry: each entry sums up to S
    rounded products in an order of its own (measured: under 1e-5 at these
    well-conditioned blocks)."""
    _schedule_against_plain(S, np.float32, 1e-4)


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card: the kernel has no CPU mode")
def test_kernel_matches_plain_on_card():
    _card_parity(((1, 50), (130, 33), (1024, 47), (3, 64)))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card_past_64():
    """The 96-thread form, float32 only: the trivariate configuration's
    reference shapes (1024, 70) and (64, 75), and the form's ends."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _card_parity(((1, 73), (5, 65), (1024, 70), (64, 75), (3, 96)),
                 ((np.float32, 1e-4),))


def _card_parity(shapes, dtypes=((np.float32, 1e-4), (np.float64, 1e-10))):
    for dtype, tol in dtypes:
        for B, S in shapes:
            A = _spd(B, S, seed=B + S, dtype=dtype)
            A[B // 2, 0, 1] = A[B // 2, 1, 0] = 10.0 * S  # one non-SPD block
            a = torch.as_tensor(A, device="cuda")
            before = kernel_counts.snapshot()
            L_k, X_k = chol.inv_chol(a, write_l=True)
            X_only = chol.inv_chol(a)
            torch.cuda.synchronize()
            assert kernel_counts.diff(before)["k1_launches"] == 2
            L_p, X_p = chol.inv_chol_plain(a, write_l=True)
            good = torch.ones(B, dtype=torch.bool, device="cuda")
            good[B // 2] = False
            for X in (X_k, X_p):
                d = torch.diagonal(X, dim1=-2, dim2=-1)
                assert torch.equal(
                    torch.all(torch.isfinite(d) & (d > 0), dim=-1), good)
            assert torch.equal(X_only.nan_to_num(), X_k.nan_to_num())
            if B > 1:
                for k, p in ((X_k, X_p), (L_k, L_p)):
                    err = (k[good] - p[good]).abs().max()
                    assert err <= tol * p[good].abs().max()
