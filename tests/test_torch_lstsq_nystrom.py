"""The port's sketched least squares (``rsvd/lstsq.py``) and Nystrom /
randomized eigh (``rsvd/nystrom.py``) against the JAX package's, on the
CPU in f64.

JAX's draws are patched into the port's: the dense sketch S
(``sketch_matrix``), CountSketch's buckets and signs for
``kind='sparse'``, and Omega (``generate_omega``).  Solutions, residuals
and eigenvalues must then equal JAX's to ``RTOL`` = 1e-10 relative, and
eigenvector spans to sines of 1e-8 (the same f64 algorithms; the
differences are LAPACK/BLAS summation order, amplified by at most 40
iterations of an O(1)-conditioned solver).  On the port's own streams
the solutions must equal numpy's (``np.linalg.lstsq``, ``pinv``, a
dense solve) to 1e-8, as the JAX package's tests hold its own
(tests/test_lstsq.py, tests/test_nystrom.py).  Every new Cholesky gives
NaN where XLA's does."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.core.rng import (
    key_from_seed as jax_key_from_seed,
    sketch_matrix as jax_sketch_matrix,
)
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import lstsq as jlstsq
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import nystrom as jnys
from rsvd_kamaneh_raganato_terrana_tpu.rsvd.driver import (
    generate_omega as jax_generate_omega,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert, device
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops import sketching as tsk
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdriver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import lstsq as tlstsq
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import nystrom as tnys

from_numpy = functools.partial(convert.from_numpy, device="cpu")
RTOL = 1e-10
SEED = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_draws(monkeypatch):
    """JAX's S, CountSketch draws and Omega for seed SEED in the port."""
    def sketch(key, n, l, dtype=torch.float64, kind="gaussian"):
        return from_numpy(np.asarray(jax_sketch_matrix(
            jax_key_from_seed(SEED), n, l, jnp.float64, kind)))

    def buckets(key, m, s, t):
        k = jax_key_from_seed(SEED)
        out = []
        for j in range(t):
            kb, ks = jax.random.split(jax.random.fold_in(k, j))
            out.append((torch.from_numpy(np.asarray(jax.random.randint(
                kb, (m,), 0, s)).astype(np.int64)), torch.from_numpy(
                np.array(jax.random.bernoulli(ks, 0.5, (m,))))))
        return out

    def omega(key_or_seed, n, l, dtype=torch.float64, kind="gaussian",
              device=None):
        return from_numpy(np.asarray(jax_generate_omega(
            key_or_seed, n, l, jnp.float64, kind)))

    monkeypatch.setattr(tlstsq, "sketch_matrix", sketch)
    monkeypatch.setattr(tsk, "_buckets_and_signs", buckets)
    monkeypatch.setattr(tdriver, "generate_omega", omega)


def _tall(m=200, n=24, cond=1e4, seed=0):
    r = np.random.default_rng(seed)
    u, _ = np.linalg.qr(r.standard_normal((m, n)))
    v, _ = np.linalg.qr(r.standard_normal((n, n)))
    return (u * np.geomspace(cond, 1.0, n)) @ v.T


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("kind, damp, nrhs", [
    ("gaussian", 0.0, None), ("gaussian", 0.0, 3), ("rademacher", 0.0, 2),
    ("sparse", 0.0, 2), ("gaussian", 0.5, 2), ("sparse", 0.5, None)])
def test_sketch_lstsq_matches_jax(jax_draws, kind, damp, nrhs):
    a = _tall()
    r = np.random.default_rng(1)
    b = r.standard_normal(200 if nrhs is None else (200, nrhs))
    kw = dict(seed=SEED, kind=kind, damp=damp, iters=30)
    x_j = np.asarray(jlstsq.sketch_lstsq(jnp.asarray(a), jnp.asarray(b),
                                         **kw))
    x_t = to_numpy(tlstsq.sketch_lstsq(from_numpy(a), from_numpy(b), **kw))
    assert x_t.shape == x_j.shape and x_t.dtype == np.float64
    assert _rel(x_t, x_j) <= RTOL
    res_j = np.asarray(jlstsq.lstsq_residual(jnp.asarray(a),
                                             jnp.asarray(x_j),
                                             jnp.asarray(b)))
    res_t = to_numpy(tlstsq.lstsq_residual(from_numpy(a), from_numpy(x_j),
                                           from_numpy(b)))
    assert res_t.shape == res_j.shape
    np.testing.assert_allclose(res_t, res_j, rtol=1e-12)


@pytest.mark.parametrize("kind", ["gaussian", "sparse"])
def test_sketch_minnorm_matches_jax(jax_draws, kind):
    a = _tall(150, 20, cond=1e3, seed=2).T            # 20 x 150
    b = np.random.default_rng(3).standard_normal((20, 2))
    kw = dict(seed=SEED, kind=kind, iters=30)
    x_j = np.asarray(jlstsq.sketch_minnorm(jnp.asarray(a), jnp.asarray(b),
                                           **kw))
    x_t = to_numpy(tlstsq.sketch_minnorm(from_numpy(a), from_numpy(b),
                                         **kw))
    assert x_t.shape == (150, 2)
    assert _rel(x_t, x_j) <= RTOL


@pytest.mark.parametrize("kind", ["gaussian", "rademacher", "sparse"])
def test_sketch_lstsq_own_stream_matches_numpy(kind):
    a = _tall(seed=4)
    b = np.random.default_rng(5).standard_normal((200, 2))
    x = to_numpy(tlstsq.sketch_lstsq(from_numpy(a), from_numpy(b),
                                     seed=9, kind=kind))
    x_np = np.linalg.lstsq(a, b, rcond=None)[0]
    np.testing.assert_allclose(x, x_np, rtol=1e-8, atol=1e-10)
    x_ridge = to_numpy(tlstsq.sketch_lstsq(from_numpy(a), from_numpy(b),
                                           seed=9, kind=kind, damp=0.3))
    np.testing.assert_allclose(
        x_ridge, np.linalg.solve(a.T @ a + 0.3 * np.eye(24), a.T @ b),
        rtol=1e-8, atol=1e-10)


def test_sketch_minnorm_own_stream_is_the_pinv_solution():
    a = _tall(120, 16, cond=1e3, seed=6).T
    b = np.random.default_rng(7).standard_normal(16)
    x = to_numpy(tlstsq.sketch_minnorm(from_numpy(a), from_numpy(b), seed=1))
    np.testing.assert_allclose(x, np.linalg.pinv(a) @ b, rtol=1e-8,
                               atol=1e-10)


def test_lstsq_guards():
    a = from_numpy(_tall(40, 8))
    with pytest.raises(ValueError, match="tall"):
        tlstsq.sketch_lstsq(a.T, from_numpy(np.ones(8)))
    with pytest.raises(ValueError, match="damp"):
        tlstsq.sketch_lstsq(a, from_numpy(np.ones(40)), damp=-1.0)
    with pytest.raises(ValueError, match="precondition"):
        tlstsq.sketch_lstsq(a, from_numpy(np.ones(40)), sketch_size=4)
    with pytest.raises(ValueError, match="wide"):
        tlstsq.sketch_minnorm(a, from_numpy(np.ones(40)))


def _psd(n=150, seed=0, decay=0.8):
    r = np.random.default_rng(seed)
    u, _ = np.linalg.qr(r.standard_normal((n, n)))
    lam = decay ** np.arange(n)
    return (u * lam) @ u.T, lam, u


def _sines(x, y):
    qx, _ = np.linalg.qr(x)
    qy, _ = np.linalg.qr(y)
    return np.linalg.svd(qy - qx @ (qx.T @ qy), compute_uv=False)


def test_nystrom_psd_matches_jax(jax_draws):
    a, _, _ = _psd()
    u_j, lam_j = (np.asarray(x) for x in jnys.nystrom_psd(jnp.asarray(a),
                                                          k=12, seed=SEED))
    u_t, lam_t = (to_numpy(x) for x in tnys.nystrom_psd(from_numpy(a), k=12,
                                                        seed=SEED))
    assert u_t.shape == (150, 12) and lam_t.shape == (12,)
    np.testing.assert_allclose(lam_t, lam_j, rtol=RTOL)
    assert _sines(u_t, u_j).max() <= 1e-8
    np.testing.assert_allclose(
        to_numpy(tnys.nystrom_reconstruct(from_numpy(u_j),
                                          from_numpy(lam_j))),
        np.asarray(jnys.nystrom_reconstruct(jnp.asarray(u_j),
                                            jnp.asarray(lam_j))),
        atol=1e-13)


@pytest.mark.parametrize("indefinite", [False, True])
def test_reigh_matches_jax(jax_draws, indefinite):
    a, lam, u = _psd(seed=1)
    if indefinite:
        a = (u * (lam * np.where(np.arange(150) % 3 == 1, -1.0, 1.0))) @ u.T
    w_j, v_j = (np.asarray(x) for x in jnys.reigh(jnp.asarray(a), k=8,
                                                  seed=SEED))
    w_t, v_t = (to_numpy(x) for x in tnys.reigh(from_numpy(a), k=8,
                                                seed=SEED))
    np.testing.assert_allclose(w_t, w_j, rtol=RTOL)
    assert _sines(v_t, v_j).max() <= 1e-8


def _spd_b(n=150, seed=2):
    """Diagonal plus low rank, SPD."""
    r = np.random.default_rng(seed)
    g = r.standard_normal((n, 5))
    return np.diag(1.0 + r.random(n)) + 0.1 * g @ g.T


def test_reigh_generalized_matches_jax(jax_draws):
    a, _, _ = _psd(seed=3)
    b = _spd_b()
    w_j, v_j = (np.asarray(x) for x in jnys.reigh_generalized(
        jnp.asarray(a), jnp.asarray(b), k=6, seed=SEED))
    w_t, v_t = (to_numpy(x) for x in tnys.reigh_generalized(
        from_numpy(a), from_numpy(b), k=6, seed=SEED))
    np.testing.assert_allclose(w_t, w_j, rtol=RTOL)
    assert _sines(v_t, v_j).max() <= 1e-8
    np.testing.assert_allclose(v_t.T @ b @ v_t, np.eye(6), atol=1e-8)


def test_nystrom_pcg_matches_jax(jax_draws):
    a, _, _ = _psd(seed=4, decay=0.9)
    b = np.random.default_rng(5).standard_normal((150, 2))
    kw = dict(mu=1e-2, rank=60, iters=20, seed=SEED)   # converged
    x_j = np.asarray(jnys.nystrom_pcg(jnp.asarray(a), jnp.asarray(b), **kw))
    x_t = to_numpy(tnys.nystrom_pcg(from_numpy(a), from_numpy(b), **kw))
    assert _rel(x_t, x_j) <= RTOL
    u, lam = np.random.default_rng(6).standard_normal((150, 4)), \
        np.array([4.0, 3.0, 2.0, 1.0])
    r = np.random.default_rng(7).standard_normal((150, 2))
    pj = jnys.nystrom_preconditioner(jnp.asarray(u), jnp.asarray(lam), 0.5)
    pt = tnys.nystrom_preconditioner(from_numpy(u), from_numpy(lam), 0.5)
    np.testing.assert_allclose(to_numpy(pt(from_numpy(r))),
                               np.asarray(pj(jnp.asarray(r))), rtol=1e-12)


def _kernel_system(n=160, seed=11):
    """tests/test_nystrom.py:89-96's RBF kernel system, mu = 1e-4."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, 2))
    a = np.exp(-((x[:, None, :] - x[None, :, :]) ** 2).sum(-1) / 2.0)
    return a, r.standard_normal(n), 1e-4


def test_nystrom_pcg_own_stream_solves_and_beats_plain_cg():
    a, b, mu = _kernel_system()
    sys_mat = a + mu * np.eye(160)
    x = to_numpy(tnys.nystrom_pcg(from_numpy(a), from_numpy(b), mu,
                                  rank=60, iters=30, seed=2))
    np.testing.assert_allclose(x, np.linalg.solve(sys_mat, b), rtol=1e-7,
                               atol=1e-9)
    x15 = to_numpy(tnys.nystrom_pcg(from_numpy(a), from_numpy(b), mu,
                                    rank=60, iters=15, seed=2))
    plain = to_numpy(tlstsq._pcg_scan(
        lambda v: from_numpy(a) @ v + mu * v, lambda r: r,
        from_numpy(b)[:, None], 15))[:, 0]
    res = [np.linalg.norm(sys_mat @ y - b) for y in (x15, plain)]
    assert res[0] < 1e-3 * res[1]


def test_nystrom_guards():
    with pytest.raises(ValueError, match="square"):
        tnys.nystrom_psd(from_numpy(np.ones((4, 3))), k=2)
    with pytest.raises(ValueError, match="square"):
        tnys.reigh(from_numpy(np.ones((4, 3))), k=2)
    with pytest.raises(ValueError, match="mu"):
        tnys.nystrom_pcg(from_numpy(np.eye(4)), from_numpy(np.ones(4)), 0.0)
    with pytest.raises(ValueError, match="equal shape"):
        tnys.reigh_generalized(from_numpy(np.eye(4)), from_numpy(np.eye(3)),
                               k=2)


def test_cholesky_failure_is_nan_as_in_xla(jax_draws):
    """A failed Cholesky gives NaN in both packages (torch's cholesky_ex
    returns a finite partial factor; the port reads ``info``)."""
    bad = np.diag([1.0, -1.0, 2.0])
    c = to_numpy(device.cholesky(from_numpy(bad)))
    c_j = np.asarray(jnp.linalg.cholesky(jnp.asarray(bad)))
    np.testing.assert_array_equal(np.isnan(c), np.isnan(c_j))
    np.testing.assert_array_equal(np.nan_to_num(c), np.nan_to_num(c_j))
    assert np.isnan(c[np.tril_indices(3)]).all()
    batch = to_numpy(device.cholesky(from_numpy(np.stack([bad, np.eye(3)]))))
    np.testing.assert_array_equal(np.isnan(batch[0]), np.isnan(c_j))
    assert np.allclose(batch[1], np.eye(3))
    a, _, _ = _psd(seed=5)
    b_indef = _spd_b() - 5.0 * np.eye(150)
    w_j, _ = jnys.reigh_generalized(jnp.asarray(a), jnp.asarray(b_indef),
                                    k=4, seed=SEED)
    w_t, v_t = tnys.reigh_generalized(from_numpy(a), from_numpy(b_indef),
                                      k=4, seed=SEED)
    assert not np.isfinite(np.asarray(w_j)).all()
    assert not torch.isfinite(w_t).all() and not torch.isfinite(v_t).all()
