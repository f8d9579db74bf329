"""The port's block-Krylov rSVD (``rsvd/krylov.py``) against the JAX
package's, on the CPU.

In f64 (``method='eigh'``, every f64 ``qr_method``; 'cholqr1_fused' and
'polar_fused' take ``cholesky_qr1``/``polar_qr`` at f64, as in JAX),
with JAX's Omega patched into the port's ``generate_omega``: sigma to
``RTOL`` = 1e-10 relative, the subspaces to sines of 1e-8, the basis Q
to 1e-10 (CholeskyQR's positive-diagonal R fixes every column sign).
In f32 the kernel routes (``qr_method`` 'cholqr1_fused' / 'polar_fused',
``method='eigh_pallas'``) run the kernels' plain versions here and the
JAX package's Pallas kernels in interpret mode, as its own tests run
them: sigma within ``F32_SIGMA_TOL`` = 1e-4 of sigma_1 (the card's
'highest' kernel-path limit) and the reconstruction errors within 1e-3
of each other.  200 x 120, k = 8, p = 4, q = 2: l(q+1) = 36."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.rsvd import krylov as jkry
from rsvd_kamaneh_raganato_terrana_tpu.rsvd.driver import (
    generate_omega as jax_generate_omega,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import kernels
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdriver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import krylov as tkry
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import rsvd

from_numpy = functools.partial(convert.from_numpy, device="cpu")
RTOL = 1e-10
F32_SIGMA_TOL = 1e-4
M, N, K, P, Q = 200, 120, 8, 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_omega(monkeypatch):
    def omega(key_or_seed, n, l, dtype=torch.float32, kind="gaussian",
              device=None):
        # JAX draws f32 and f64 normals differently: draw in the dtype
        jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
        return from_numpy(np.asarray(jax_generate_omega(
            key_or_seed, n, l, jdt, kind)))
    monkeypatch.setattr(tdriver, "generate_omega", omega)


def _slow_decay(m=M, n=N, seed=0, dtype=np.float64):
    """sigma_i = (i + 1)^(-1/2): Krylov's use case, full rank."""
    r = np.random.default_rng(seed)
    u, _ = np.linalg.qr(r.standard_normal((m, n)))
    v, _ = np.linalg.qr(r.standard_normal((n, n)))
    s = (np.arange(n) + 1.0) ** -0.5
    return ((u * s) @ v.T).astype(dtype)


def _sines(x, y):
    qx, _ = np.linalg.qr(x.astype(np.float64))
    qy, _ = np.linalg.qr(y.astype(np.float64))
    return np.linalg.svd(qy - qx @ (qx.T @ qy), compute_uv=False)


def _both(a, **kw):
    out_j = jkry.rsvd_krylov(jnp.asarray(a), **kw)
    out_t = tkry.rsvd_krylov(from_numpy(a), **kw)
    return [np.asarray(x) for x in out_j], [to_numpy(x) for x in out_t]


@pytest.mark.parametrize("qr_method", ["robust", "cholqr2", "householder",
                                       "cholqr1_fused", "polar_fused"])
def test_rsvd_krylov_f64_matches_jax(jax_omega, qr_method):
    a = _slow_decay()
    (u_j, s_j, v_j), (u_t, s_t, v_t) = _both(a, k=K, p=P, q=Q,
                                             qr_method=qr_method)
    assert u_t.shape == (M, K) and s_t.shape == (K,) and v_t.shape == (N, K)
    assert s_t.dtype == np.float64
    np.testing.assert_allclose(s_t, s_j, rtol=RTOL)
    assert _sines(u_t, u_j).max() <= 1e-8
    assert _sines(v_t, v_j).max() <= 1e-8


@pytest.mark.parametrize("method", ["jacobi", "xla"])
def test_rsvd_krylov_f64_tails_match_jax(jax_omega, method):
    a = _slow_decay(seed=1)
    (_, s_j, _), (_, s_t, _) = _both(a, k=K, p=P, q=1, method=method)
    np.testing.assert_allclose(s_t, s_j, rtol=RTOL)


def test_krylov_basis_f64_matches_jax():
    a = _slow_decay(seed=2)
    omega = np.random.default_rng(3).standard_normal((N, K + P))
    q_j = np.asarray(jkry.krylov_basis(jnp.asarray(a), jnp.asarray(omega),
                                       Q, "cholqr2"))
    q_t = to_numpy(tkry.krylov_basis(from_numpy(a), from_numpy(omega), Q,
                                     "cholqr2"))
    assert q_t.shape == (M, (K + P) * (Q + 1))
    np.testing.assert_allclose(q_t, q_j, atol=RTOL)
    np.testing.assert_allclose(q_t.T @ q_t, np.eye(q_t.shape[1]), atol=1e-12)


def test_k_zero_returns_all_and_defaults(jax_omega):
    a = _slow_decay(60, 40)
    u, s, v = tkry.rsvd_krylov(from_numpy(a), k=0, p=8, q=1)
    assert u.shape == (60, 8) and s.shape == (8,) and v.shape == (40, 8)


@pytest.mark.parametrize("qr_method, method", [
    ("cholqr1_fused", "eigh_pallas"),
    ("polar_fused", "eigh"),
    ("robust", "eigh"),
])
def test_rsvd_krylov_f32_kernel_routes_match_jax(jax_omega, qr_method,
                                                  method):
    """The kernel routes in f32: the port's plain versions against JAX's
    Pallas kernels in interpret mode."""
    a = _slow_decay(dtype=np.float32)
    (u_j, s_j, v_j), (u_t, s_t, v_t) = _both(a, k=K, p=P, q=Q,
                                             qr_method=qr_method,
                                             method=method)
    assert s_t.dtype == np.float32 and s_j.dtype == np.float32
    assert np.isfinite(s_t).all()
    assert np.max(np.abs(s_t - s_j)) / s_j[0] <= F32_SIGMA_TOL
    a64 = a.astype(np.float64)
    e_j = np.linalg.norm(a64 - (u_j * s_j) @ v_j.T)
    e_t = np.linalg.norm(a64 - (u_t * s_t) @ v_t.T)
    assert abs(e_t / e_j - 1.0) <= 1e-3


def test_kernel_wrappers_are_called_per_block_and_once_for_the_tail(
        monkeypatch):
    """K1 (or K2) once per Krylov block, q + 1 calls, each on one m x l
    panel; K3 once on the l(q+1) x l(q+1) Gram."""
    calls = []

    def spy(name):
        real = getattr(kernels, name)

        def wrapper(x, *args, **kwargs):
            calls.append((name, tuple(x.shape)))
            return real(x, *args, **kwargs)
        return wrapper

    for name in ("fused_cholqr1", "polar_qr_fused", "eigh_small"):
        monkeypatch.setattr(kernels, name, spy(name))
    a = from_numpy(_slow_decay(dtype=np.float32))
    l, big = K + P, (K + P) * (Q + 1)
    tkry.rsvd_krylov(a, k=K, p=P, q=Q, qr_method="cholqr1_fused",
                     method="eigh_pallas")
    assert calls == [("fused_cholqr1", (M, l))] * (Q + 1) + [
        ("eigh_small", (big, big))]
    calls.clear()
    tkry.rsvd_krylov(a, k=K, p=P, q=Q, qr_method="polar_fused")
    assert calls == [("polar_qr_fused", (M, l))] * (Q + 1)
    calls.clear()
    tkry.rsvd_krylov(from_numpy(_slow_decay()), k=K, p=P, q=Q,
                     qr_method="cholqr1_fused")
    assert calls == []                       # f64 panels: no kernel


def test_rank_deficient_operand_gives_non_finite_through_k1():
    """K1 has no fallback: a Krylov block of an operand whose rank is
    below l(q+1) is rank-deficient after deflation, and CholeskyQR1 gives
    NaN, as XLA's does (the card holds the kernel to the same)."""
    r = np.random.default_rng(4)
    a = (r.standard_normal((M, 10)) @ r.standard_normal((10, N))
         ).astype(np.float32)
    u, s, v = tkry.rsvd_krylov(from_numpy(a), k=K, p=P, q=Q,
                               qr_method="cholqr1_fused")
    assert not all(bool(torch.isfinite(x).all()) for x in (u, s, v))
    u, s, v = tkry.rsvd_krylov(from_numpy(a), k=K, p=P, q=Q)   # robust
    assert all(bool(torch.isfinite(x).all()) for x in (u, s, v))


def test_krylov_beats_power_iteration_at_equal_q():
    a = _slow_decay(300, 200, seed=5)
    a_t = from_numpy(a)
    err = {}
    for name, fn in (("krylov", tkry.rsvd_krylov), ("power", rsvd)):
        u, s, v = (to_numpy(x) for x in fn(a_t, k=10, p=5, q=2,
                                            method="eigh", seed=3))
        err[name] = np.linalg.norm(a - (u * s) @ v.T)
    opt = np.linalg.norm(np.linalg.svd(a, compute_uv=False)[10:])
    assert err["krylov"] <= err["power"] * (1 + 1e-9)
    assert err["krylov"] < 1.02 * opt


@pytest.mark.parametrize("method", ["eigh", "xla"])
def test_gram_eigh_tail_gives_nan_as_jax_does(method):
    """A NaN panel reaching the 'eigh' or 'xla' tail (K1's NaN on a
    rank-deficient block) gives NaN factors in both packages: torch's
    eigh and svd would raise, ``core/device.py::eigh_nan``/``svd_nan``
    write NaN instead.  Finite input keeps
    ``torch.linalg.eigh``'s results bit for bit."""
    from rsvd_kamaneh_raganato_terrana_tpu.linalg.svd import svd as jsvd
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import eigh_nan
    from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.svd import svd

    b = np.random.default_rng(6).standard_normal((12, 40))
    b[3, 5] = np.nan
    got = [to_numpy(x) for x in svd(from_numpy(b), method)]
    want = [np.asarray(x) for x in jsvd(jnp.asarray(b), method)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_array_equal(np.nan_to_num(g), np.nan_to_num(w))
    assert np.isnan(got[0]).all() and np.isnan(got[1]).all()
    if method == "xla":
        return
    g = from_numpy(b[:, :12] @ b[:, :12].T)
    g = torch.nan_to_num(g)
    lam, q = eigh_nan(g)
    lam0, q0 = torch.linalg.eigh(g)
    assert torch.equal(lam, lam0) and torch.equal(q, q0)
