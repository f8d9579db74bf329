"""The port's randomized LU (``rsvd/rlu.py``), CCA (``rsvd/cca.py``) and
DMD (``rsvd/dmd.py``) against the JAX package's, on the CPU in f64.

With JAX's Omega patched into the port's ``generate_omega``: RLU's two
permutations equal JAX's exactly (as int64) and its factors to
``RTOL`` = 1e-10; CCA's correlations to 1e-10 and its weight columns to
1e-8 up to sign, on both branches (exact SVD at min(p, q) <= 256, the
rSVD driver above: a 600 x 300 / 600 x 260 case); DMD's eigenvalues to
1e-10 and its reconstruction over the window to 1e-8.  JAX's own
results carried over by ``convert.rlu_from_jax`` / ``cca_from_jax``
give the port's ``rlu_solve``, ``rlu_reconstruct`` and CCA projection
equal to JAX's to 1e-12."""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.rsvd.driver import (
    generate_omega as jax_generate_omega,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdriver

# the packages' ``rsvd`` attributes ``cca``, ``dmd`` and ``rlu`` are the
# functions of the same names: take the modules from the import system
jcca, jdmd, jrlu, tcca, tdmd, trlu = (
    importlib.import_module(f"{pkg}.rsvd.{mod}")
    for pkg in ("rsvd_kamaneh_raganato_terrana_tpu",
                "rsvd_kamaneh_raganato_terrana_tpu_torch")
    for mod in ("cca", "dmd", "rlu"))

from_numpy = functools.partial(convert.from_numpy, device="cpu")
RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_omega(monkeypatch):
    def omega(key_or_seed, n, l, dtype=torch.float64, kind="gaussian",
              device=None):
        return from_numpy(np.asarray(jax_generate_omega(
            key_or_seed, n, l, jnp.float64, kind)))
    monkeypatch.setattr(tdriver, "generate_omega", omega)


def _low_rank(m=160, n=110, r=12, noise=1e-6, seed=0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((m, r)) @ g.standard_normal((r, n))
            + noise * g.standard_normal((m, n)))


def test_swaps_to_perm_matches_jax_lu_and_torch_p():
    y = np.random.default_rng(1).standard_normal((90, 14))
    _, _, perm_j = jax.lax.linalg.lu(jnp.asarray(y))
    lu, perm = trlu._pivoted_lu(from_numpy(y))
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(to_numpy(perm), np.asarray(perm_j))
    p_mat, low, up = torch.linalg.lu(from_numpy(y))      # y = P L U
    np.testing.assert_array_equal(to_numpy(perm),
                                  to_numpy(torch.argmax(p_mat, dim=0)))
    np.testing.assert_allclose(y[to_numpy(perm)],
                               to_numpy(trlu._unit_lower(lu, 90, 14)
                                        @ torch.triu(lu[:14])), atol=1e-13)


def _decaying(m, n, seed=0):
    """sigma_i = 10^(-3i/min(m, n)): the leading l directions are well
    separated, so the factors are well conditioned."""
    g = np.random.default_rng(seed)
    r = min(m, n)
    u, _ = np.linalg.qr(g.standard_normal((m, r)))
    v, _ = np.linalg.qr(g.standard_normal((n, r)))
    return (u * np.logspace(0, -3, r)) @ v.T


@pytest.mark.parametrize("shape", [(160, 110), (90, 140)])
def test_rlu_matches_jax(jax_omega, shape):
    a = _decaying(*shape)
    res_j = jrlu.rlu(jnp.asarray(a), k=10, p=4, seed=3)
    res_t = trlu.rlu(from_numpy(a), k=10, p=4, seed=3)
    for name in ("perm_rows", "perm_cols"):
        got = getattr(res_t, name)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(to_numpy(got),
                                      np.asarray(getattr(res_j, name)))
    for name in ("l_factor", "u_factor", "l_ortho", "u2"):
        want = np.asarray(getattr(res_j, name))
        got = to_numpy(getattr(res_t, name))
        assert got.shape == want.shape
        assert np.linalg.norm(got - want) <= RTOL * np.linalg.norm(want)
    rec_j = np.asarray(jrlu.rlu_reconstruct(res_j))
    rec_t = to_numpy(trlu.rlu_reconstruct(res_t))
    np.testing.assert_allclose(rec_t, rec_j, atol=RTOL * np.abs(a).max())
    opt = np.linalg.norm(np.linalg.svd(a, compute_uv=False)[14:])
    assert np.linalg.norm(rec_t - a) <= 3.0 * opt


def test_rlu_downstream_on_jax_factors():
    a = _low_rank(seed=4)
    res_j = jrlu.rlu(jnp.asarray(a), k=8, p=4, seed=0)     # l = rank
    res_t = convert.rlu_from_jax(res_j, device="cpu")
    assert res_t.perm_rows.dtype == torch.int64
    b = a @ np.random.default_rng(5).standard_normal((110, 2))
    np.testing.assert_allclose(to_numpy(trlu.rlu_solve(res_t,
                                                       from_numpy(b))),
                               np.asarray(jrlu.rlu_solve(res_j,
                                                         jnp.asarray(b))),
                               rtol=1e-12, atol=1e-12)
    x1 = to_numpy(trlu.rlu_solve(res_t, from_numpy(b[:, 0])))
    assert x1.shape == (110,)
    assert np.linalg.norm(a @ x1 - b[:, 0]) < 1e-4 * np.linalg.norm(b[:, 0])
    np.testing.assert_allclose(to_numpy(trlu.rlu_reconstruct(res_t)),
                               np.asarray(jrlu.rlu_reconstruct(res_j)),
                               rtol=1e-12, atol=1e-12)


def test_rlu_structure_and_guards():
    res = trlu.rlu(from_numpy(_low_rank(seed=6)), k=8, p=4, seed=1)
    l_f, u_f = to_numpy(res.l_factor), to_numpy(res.u_factor)
    assert np.abs(np.triu(l_f, 1)).max() == 0.0
    assert np.abs(np.tril(u_f, -1)).max() == 0.0
    np.testing.assert_allclose(np.diag(u_f), 1.0)
    assert sorted(to_numpy(res.perm_rows)) == list(range(160))
    with pytest.raises(ValueError, match="positive"):
        trlu.rlu(from_numpy(np.eye(5)), k=0)
    with pytest.raises(ValueError, match="2-D"):
        trlu.rlu(from_numpy(np.ones(5)), k=1)
    with pytest.raises(ValueError, match="real"):
        trlu.rlu(torch.ones(5, 5, dtype=torch.complex128), k=1)


def _views(n, p, q, shared=4, seed=0):
    """Two views sharing ``shared`` latent directions."""
    g = np.random.default_rng(seed)
    z = g.standard_normal((n, shared))
    x = z @ g.standard_normal((shared, p)) + g.standard_normal((n, p))
    y = z @ g.standard_normal((shared, q)) + g.standard_normal((n, q))
    return x + 3.0, y - 1.0


def _same_columns_up_to_sign(got, want, tol):
    sign = np.sign(np.sum(got * want, axis=0))
    assert np.linalg.norm(got * sign - want) <= tol * np.linalg.norm(want)


@pytest.mark.parametrize("shape, k", [((200, 12, 9), 3),
                                      ((600, 300, 260), 4)])
def test_cca_matches_jax_on_both_branches(jax_omega, shape, k):
    x, y = _views(*shape)
    res_j = jcca.cca(jnp.asarray(x), jnp.asarray(y), k=k, seed=2)
    res_t = tcca.cca(from_numpy(x), from_numpy(y), k=k, seed=2)
    np.testing.assert_allclose(to_numpy(res_t.correlations),
                               np.asarray(res_j.correlations), rtol=RTOL)
    for name in ("x_weights", "y_weights"):
        _same_columns_up_to_sign(to_numpy(getattr(res_t, name)),
                                 np.asarray(getattr(res_j, name)), 1e-8)
    for name in ("x_mean", "y_mean"):
        np.testing.assert_allclose(to_numpy(getattr(res_t, name)),
                                   np.asarray(getattr(res_j, name)),
                                   rtol=1e-13)


def test_cca_projection_on_jax_fit():
    x, y = _views(200, 12, 9, seed=1)
    res_j = jcca.cca(jnp.asarray(x), jnp.asarray(y), k=3)
    res_t = convert.cca_from_jax(res_j, device="cpu")
    x_new = np.random.default_rng(3).standard_normal((5, 12))
    want = (x_new - np.asarray(res_j.x_mean)) @ np.asarray(res_j.x_weights)
    got = to_numpy((from_numpy(x_new) - res_t.x_mean) @ res_t.x_weights)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    corr = [np.corrcoef(((x - np.asarray(res_j.x_mean))
                         @ np.asarray(res_j.x_weights))[:, i],
                        ((y - np.asarray(res_j.y_mean))
                         @ np.asarray(res_j.y_weights))[:, i])[0, 1]
            for i in range(3)]
    np.testing.assert_allclose(np.abs(corr), to_numpy(res_t.correlations),
                               rtol=1e-4)


def test_cca_guards_and_clipping():
    with pytest.raises(ValueError, match="same number of rows"):
        tcca.cca(from_numpy(np.ones((5, 2))), from_numpy(np.ones((4, 2))))
    x, y = _views(100, 5, 3, seed=2)
    res = tcca.cca(from_numpy(x), from_numpy(y), k=10)
    assert res.correlations.shape == (3,)
    c = to_numpy(res.correlations)
    assert (c >= 0).all() and (c <= 1).all() and (np.diff(c) <= 0).all()


def _two_mode_signal(n=120, m=50, dt=0.1):
    """tests/test_dmd.py:12-25's two decaying oscillations."""
    xs = np.linspace(0, 1, n)
    phi1 = np.sin(2 * np.pi * xs) + 1j * 0.3 * np.cos(2 * np.pi * xs)
    phi2 = np.sin(5 * np.pi * xs) - 1j * 0.2 * np.sin(np.pi * xs)
    w1, w2 = -0.2 + 2.0j, -0.5 + 5.0j
    t = np.arange(m + 1) * dt
    snaps = np.real(np.outer(phi1, np.exp(w1 * t))
                    + np.outer(phi2, np.exp(w2 * t)))
    return snaps, (w1, w2), dt


def test_dmd_matches_jax(jax_omega):
    snaps, ws, dt = _two_mode_signal()
    res_j = jdmd.dmd(jnp.asarray(snaps), k=4, dt=dt, p=4)
    res_t = tdmd.dmd(from_numpy(snaps), k=4, dt=dt, p=4)
    for name in ("modes", "eigs", "omega", "amplitudes", "singular_values"):
        assert isinstance(getattr(res_t, name), np.ndarray)
    assert res_t.dt == dt

    def by_eig(res):
        return np.sort_complex(np.round(res.eigs, 6))
    np.testing.assert_allclose(np.sort_complex(res_t.eigs),
                               np.sort_complex(res_j.eigs), rtol=RTOL)
    np.testing.assert_allclose(res_t.singular_values, res_j.singular_values,
                               rtol=RTOL)
    np.testing.assert_allclose(tdmd.dmd_predict(res_t, [0.0, 0.7, 9.0]),
                               jdmd.dmd_predict(res_j, [0.0, 0.7, 9.0]),
                               rtol=1e-8, atol=1e-10)
    err_t = tdmd.dmd_reconstruction_error(res_t, from_numpy(snaps))
    assert abs(err_t - jdmd.dmd_reconstruction_error(res_j, snaps)) < 1e-10
    assert err_t < 1e-8
    for w in ws:
        assert np.min(np.abs(res_t.omega - w)) < 1e-6
    assert tdmd.dmd_predict(res_t, 0.5).shape == (120,)


def test_cca_failed_whitening_is_nan_as_in_jax():
    """A negative ridge makes the whitening Cholesky fail: NaN in both
    packages, no exception (``core/device.py::cholesky``)."""
    x, y = _views(100, 5, 3, seed=3)
    res_j = jcca.cca(jnp.asarray(x), jnp.asarray(y), k=2, reg=-5.0)
    res_t = tcca.cca(from_numpy(x), from_numpy(y), k=2, reg=-5.0)
    assert np.isnan(np.asarray(res_j.x_weights)).all()
    assert torch.isnan(res_t.x_weights).all()
    assert torch.isnan(res_t.correlations).all() == \
        bool(np.isnan(np.asarray(res_j.correlations)).all())
