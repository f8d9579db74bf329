"""The degenerate shapes and pathological inputs of
tests/test_edge_cases.py:17-83 on the port (vectors, 1x1, zero matrices,
a sketch wider than the matrix, k = min(m, n), Jacobi's tiny blocks, a
constant matrix), on the CPU in f64 (tests/conftest.py turns x64 on).

Each case holds the port to the JAX case's own bar at its sizes.  Where
the JAX case calls a function that is deterministic in its input
(``svd``, ``qr_reduced``, ``cholesky_qr2``, ``jacobi_svd``), the port
is also held to the JAX function on the same numpy input: singular
values to ``JAX_RTOL`` = 1e-12 relative to sigma_1 (absolute 1e-14 on
a zero matrix), Q and R to 1e-12 absolute.  ``rsvd`` draws, so it is
held to the bar on the port's own stream.  The complex-rejection cases
are held by tests/test_torch_rsvd.py and tests/test_torch_engines.py."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.linalg import (
    cholesky_qr2 as jax_cholesky_qr2,
    jacobi_svd as jax_jacobi_svd,
    qr_reduced as jax_qr_reduced,
    svd as jax_svd,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import (
    cholesky_qr2,
    jacobi_svd,
    qr_reduced,
    svd,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import rsvd

# the port's entry points default to the card; these tests run on the CPU
from_numpy = functools.partial(convert.from_numpy, device="cpu")
JAX_RTOL = 1e-12          # sigma against JAX's, relative to sigma_1
QR_ATOL = 1e-12           # Q and R against JAX's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(factors):
    return tuple(to_numpy(x) for x in factors)


def _sigma_matches_jax(s, s_jax, atol=0.0):
    s_jax = np.asarray(s_jax)
    np.testing.assert_allclose(
        s, s_jax, rtol=0, atol=max(JAX_RTOL * float(np.max(s_jax)), atol))


def test_svd_one_by_one():
    u, s, v = _np(svd(from_numpy(np.array([[3.0]])), "jacobi"))
    assert float(s[0]) == pytest.approx(3.0)
    assert abs(float(u[0, 0])) == pytest.approx(1.0)
    ju, js, _ = jax_svd(jnp.asarray([[3.0]]), "jacobi")
    _sigma_matches_jax(s, js)
    np.testing.assert_allclose(np.abs(u), np.abs(np.asarray(ju)), atol=1e-15)


def test_svd_column_vector(rng):
    a = rng.standard_normal((20, 1))
    u, s, v = _np(svd(from_numpy(a), "parallel_jacobi"))
    assert float(s[0]) == pytest.approx(np.linalg.norm(a), rel=1e-10)
    _sigma_matches_jax(s, jax_svd(jnp.asarray(a), "parallel_jacobi")[1])


def test_svd_row_vector(rng):
    a = rng.standard_normal((1, 15))
    u, s, v = _np(svd(from_numpy(a), "jacobi"))
    assert float(s[0]) == pytest.approx(np.linalg.norm(a), rel=1e-10)
    _sigma_matches_jax(s, jax_svd(jnp.asarray(a), "jacobi")[1])


@pytest.mark.parametrize("method", ["jacobi", "eigh"])
def test_svd_zero_matrix(method):
    a = np.zeros((10, 6))
    u, s, v = _np(svd(from_numpy(a), method))
    assert np.allclose(s, 0.0)
    assert np.isfinite(u).all()
    _sigma_matches_jax(s, jax_svd(jnp.asarray(a), method)[1], atol=1e-14)


def test_qr_single_column(rng):
    a = rng.standard_normal((30, 1))
    q, r = _np(qr_reduced(from_numpy(a), "robust"))
    np.testing.assert_allclose(q @ r, a, atol=1e-12)
    assert float(np.linalg.norm(q)) == pytest.approx(1.0, rel=1e-10)
    jq, jr = jax_qr_reduced(jnp.asarray(a), "robust")
    np.testing.assert_allclose(q, np.asarray(jq), atol=QR_ATOL)
    np.testing.assert_allclose(r, np.asarray(jr), atol=QR_ATOL)


def test_qr_zero_matrix_stays_finite():
    a = np.zeros((12, 4))
    q, r = _np(cholesky_qr2(from_numpy(a)))
    assert np.isfinite(q).all()
    assert np.allclose(q @ r, 0.0)
    jq, jr = jax_cholesky_qr2(jnp.asarray(a))
    np.testing.assert_allclose(q, np.asarray(jq), atol=QR_ATOL)
    np.testing.assert_allclose(r, np.asarray(jr), atol=QR_ATOL)


def test_rsvd_sketch_larger_than_matrix(rng):
    a = rng.standard_normal((10, 8))
    u, s, v = _np(rsvd(from_numpy(a), k=0, p=50, q=1))  # l clamps to 8
    assert s.shape[0] == 8
    np.testing.assert_allclose(s, np.linalg.svd(a, compute_uv=False),
                               rtol=1e-6)


def test_rsvd_k_equals_min_dim(rng):
    a = rng.standard_normal((12, 9))
    u, s, v = _np(rsvd(from_numpy(a), k=9, p=4, q=2))
    np.testing.assert_allclose(s, np.linalg.svd(a, compute_uv=False),
                               rtol=1e-6)


def test_jacobi_tiny_blocks(rng):
    a = rng.standard_normal((10, 6))
    u, s, v = _np(jacobi_svd(from_numpy(a), apply="block", block_size=2))
    np.testing.assert_allclose(s, np.linalg.svd(a, compute_uv=False),
                               rtol=1e-9)
    _sigma_matches_jax(s, jax_jacobi_svd(jnp.asarray(a), apply="block",
                                         block_size=2)[1])


def test_constant_matrix():
    a = np.full((16, 12), 7.0)                     # rank 1
    u, s, v = _np(svd(from_numpy(a), "jacobi"))
    assert float(s[0]) == pytest.approx(7.0 * np.sqrt(16 * 12), rel=1e-9)
    assert np.all(s[1:] < 1e-9 * float(s[0]))
    _sigma_matches_jax(s, jax_svd(jnp.asarray(a), "jacobi")[1])


# --- the same degenerate inputs through the kernels' plain versions (the
# CPU path of chip_smoke.py's phase 14a), in f32 ---------------------------


@pytest.mark.parametrize("shape", [(1, 1), (20, 1), (1, 15)])
def test_svd_of_a_vector_through_k3(shape):
    a = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    u, s, v = _np(svd(from_numpy(a), "eigh_pallas"))
    norm = np.linalg.norm(a.astype(np.float64))
    assert abs(float(s[0]) - norm) <= 1e-6 * norm
    np.testing.assert_allclose(np.abs(u * s) @ np.abs(v.T), np.abs(a),
                               rtol=1e-6)


def test_svd_zero_matrix_through_k3():
    u, s, v = _np(svd(from_numpy(np.zeros((10, 6), np.float32)),
                      "eigh_pallas"))
    assert (s == 0).all() and np.isfinite(u).all() and np.isfinite(v).all()


@pytest.mark.parametrize("cols", [12, 11])
def test_constant_matrix_through_k3(cols):
    """K3 at equal diagonal entries.  Every mirror pair of the constant
    matrix's Gram has tau = 0; the JAX kernel's rule (t = +1 at both
    ends of the pair) makes J singular and returned every eigenvalue as
    2.8e19.  The port's K3 takes +1 and -1 there (cols 11 also pads the
    Gram to an even n)."""
    a = np.full((16, cols), 7.0, np.float32)
    u, s, v = _np(svd(from_numpy(a), "eigh_pallas"))
    want = 7.0 * np.sqrt(16 * cols)
    assert abs(float(s[0]) - want) <= 1e-6 * want
    # the Gram route rounds lambda by ~eps lambda_1: sigma by
    # sqrt(eps) sigma_1 = 3.5e-4 sigma_1 in f32
    assert np.all(s[1:] <= 2e-3 * s[0])
    np.testing.assert_allclose((u * s) @ v.T, a, rtol=0, atol=1e-4 * 7.0)
