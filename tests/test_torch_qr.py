"""``linalg/qr.py`` of the PyTorch port against its JAX twin in f64.

Each ported ``qr_reduced`` method gets the same numpy panel in both
packages; Q and R must agree to 1e-10 after column signs are fixed
(the CholeskyQR methods give positive-diagonal R in both; Householder's
signs are LAPACK's choice)."""

import functools
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.linalg import qr as jqr
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import qr as tqr

PORTED = ("robust", "robust1", "cholqr1", "cholqr1_fused", "cholqr2",
          "cholqr3", "householder")

# the port's entry points default to the card; these tests run on the CPU
from_numpy = functools.partial(convert.from_numpy, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tall(m=200, l=24, cond=100.0, seed=0):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, l)))
    v, _ = np.linalg.qr(rng.standard_normal((l, l)))
    s = np.geomspace(cond, 1.0, l)
    return (u * s) @ v.T


def _rank_deficient(seed=3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((100, 60))
    a[:, 30:] = a[:, :30]            # exact rank 30 < l = 60
    return a


def _sign_fixed(q, r):
    sign = np.where(np.diag(r) < 0, -1.0, 1.0)
    return q * sign[None, :], r * sign[:, None]


@pytest.mark.parametrize("method", PORTED)
def test_qr_reduced_matches_jax_f64(method):
    a = _tall()
    q_j, r_j = (np.asarray(x) for x in jqr.qr_reduced(jnp.asarray(a),
                                                      method))
    q_t, r_t = (to_numpy(x) for x in tqr.qr_reduced(from_numpy(a), method))
    assert q_t.dtype == np.float64
    q_j, r_j = _sign_fixed(q_j, r_j)
    q_t, r_t = _sign_fixed(q_t, r_t)
    # same f64 algorithm on the same input: differences are BLAS/LAPACK
    # summation order, amplified at most cond^2 = 1e4 by single-pass
    # CholeskyQR -> ~1e-12; 1e-10 leaves two digits of margin
    assert np.linalg.norm(q_t - q_j) <= 1e-10
    assert np.linalg.norm(r_t - r_j) <= 1e-10 * np.linalg.norm(r_j)


@pytest.mark.parametrize("method", ["robust", "robust1"])
def test_rank_deficient_takes_householder_fallback(method):
    """Trap 1: cholesky_ex reports failure in ``info`` with a FINITE
    factor, so the fallback must key on info, not isfinite.  A rank-
    deficient panel must take the Householder branch, as in JAX."""
    a = _rank_deficient()
    _, _, degraded = tqr._cholesky_qr_flagged(from_numpy(a))
    assert bool(degraded)
    q_t, r_t = (to_numpy(x) for x in tqr.qr_reduced(from_numpy(a), method))
    q_j, r_j = (np.asarray(x) for x in jqr.qr_reduced(jnp.asarray(a),
                                                      method))
    hh_q, hh_r = (to_numpy(x) for x in
                  torch.linalg.qr(from_numpy(a), mode="reduced"))
    for q, r in ((q_t, r_t), (q_j, r_j)):
        assert np.isfinite(q).all() and np.isfinite(r).all()
        # orthonormal to f64 roundoff, and an exact factorization
        assert np.abs(q.T @ q - np.eye(60)).max() <= 1e-10
        assert np.linalg.norm(q @ r - a) <= 1e-10 * np.linalg.norm(a)
    # the port's result IS the Householder factorization
    np.testing.assert_array_equal(q_t, hh_q)
    np.testing.assert_array_equal(r_t, hh_r)


def test_chol_maybe_shifted_matches_jax_on_indefinite_gram():
    """[[1, 2], [2, 1]] is indefinite: torch's cholesky_ex returns a
    finite factor with info = 2, JAX returns NaN.  Both must flag it and
    pick the same shifted/last-resort factor."""
    g = np.array([[1.0, 2.0], [2.0, 1.0]])
    c_j, d_j = jqr._chol_maybe_shifted(jnp.asarray(g), 4)
    c_t, d_t = tqr._chol_maybe_shifted(from_numpy(g), 4)
    assert bool(d_j) and bool(d_t)
    # same 2 x 2 Cholesky of the same SPD matrix: roundoff only
    np.testing.assert_allclose(to_numpy(c_t), np.asarray(c_j),
                               rtol=1e-12, atol=1e-12)


def test_well_conditioned_gram_is_not_flagged():
    g = _tall(50, 8, 3.0, 1)
    g = g.T @ g
    c_t, d_t = tqr._chol_maybe_shifted(from_numpy(g), 50)
    assert not bool(d_t)
    # plain Cholesky chosen: exact to f64 roundoff
    np.testing.assert_allclose(to_numpy(c_t), np.linalg.cholesky(g),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("method", ["cholqr1", "cholqr1_fused"])
def test_cholqr1_rank_deficient_is_nan_like_jax(method):
    a = _rank_deficient()
    q_t, r_t = tqr.qr_reduced(from_numpy(a), method)
    q_j, _ = jqr.qr_reduced(jnp.asarray(a), method)
    assert not np.isfinite(np.asarray(q_j)).all()
    assert not torch.isfinite(q_t).all()


@pytest.mark.parametrize("method", ["cholqr2", "cholqr3"])
def test_cholqr23_rank_deficient_stays_finite_like_jax(method):
    """The last-resort regularized Cholesky keeps cholqr2/3 finite."""
    a = _rank_deficient()
    q_t, r_t = tqr.qr_reduced(from_numpy(a), method)
    q_j, r_j = jqr.qr_reduced(jnp.asarray(a), method)
    assert np.isfinite(np.asarray(q_j)).all()
    assert torch.isfinite(q_t).all() and torch.isfinite(r_t).all()


def test_qr_full_matches_jax_f64():
    a = _tall(40, 12, 10.0, 5)
    q_t, r_t = (to_numpy(x) for x in tqr.qr_full(from_numpy(a)))
    q_j, r_j = (np.asarray(x) for x in jqr.qr_full(jnp.asarray(a)))
    assert q_t.shape == q_j.shape == (40, 40)
    assert r_t.shape == r_j.shape == (40, 12)
    assert np.abs(q_t.T @ q_t - np.eye(40)).max() <= 1e-12
    assert np.linalg.norm(q_t @ r_t - a) <= 1e-12 * np.linalg.norm(a)
    # R is unique up to row signs
    np.testing.assert_allclose(np.abs(r_t), np.abs(r_j), atol=1e-12)


def test_orthonormal_basis_spans_range():
    a = _tall(80, 10, 20.0, 6)
    q = to_numpy(tqr.orthonormal_basis(from_numpy(a), "robust"))
    assert np.linalg.norm(q @ (q.T @ a) - a) <= 1e-12 * np.linalg.norm(a)


def test_low_precision_input_factors_in_f32():
    a = from_numpy(_tall(64, 8, 4.0, 7), dtype=torch.bfloat16)
    q, r = tqr.qr_reduced(a, "cholqr2")
    assert q.dtype == torch.bfloat16 and r.dtype == torch.bfloat16
    qf = q.float()
    # bf16 storage of an orthonormal Q: ~3 significant digits
    assert (qf.T @ qf - torch.eye(8)).abs().max() <= 2e-2


def test_unknown_method_raises_value_error():
    with pytest.raises(ValueError, match="unknown QR method"):
        tqr.qr_reduced(from_numpy(_tall(40, 4, 2.0, 8)), "givens")
