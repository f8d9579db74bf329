"""Frequent Directions (tests/test_fd.py:23-76) and the randomized ID,
CUR and leverage sampling (tests/test_interp.py:24-119) on the port, on
the CPU in f64 (tests/conftest.py turns x64 on).

Each case holds the port to the JAX case's own bar at its sizes, on the
port's own random stream.  ``column_id``, ``row_id`` and ``cur`` are
deterministic once Omega is given, so each of their cases also runs the
JAX function and the port with JAX's Omega patched into the port's
``generate_omega``: pivots equal, X and U to ``JAX_RTOL`` = 1e-10
relative (Frobenius).  FD's values are held to the JAX package's by
tests/test_torch_pca.py, which also holds its never-overestimate bar."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.rsvd import interp as jinterp
from rsvd_kamaneh_raganato_terrana_tpu.rsvd.driver import (
    generate_omega as jax_generate_omega,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdriver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import interp as tinterp
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.fd import (
    FrequentDirections,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.interp import (
    column_id,
    cur,
    cur_reconstruct,
    id_reconstruct,
    leverage_sample,
    leverage_scores,
    row_id,
)

# the port's entry points default to the card; these tests run on the CPU
from_numpy = functools.partial(convert.from_numpy, device="cpu")
JAX_RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _held_to_jax(monkeypatch, name, a, **kwargs):
    """The port's ``name`` with JAX's Omega patched in against JAX's
    ``name`` on the same ``a``: index outputs equal, the others to
    JAX_RTOL."""
    def omega(seed, n, l, dtype=None, kind="gaussian", device=None):
        return from_numpy(np.asarray(jax_generate_omega(
            seed, n, l, jnp.float64, kind)))

    want = getattr(jinterp, name)(jnp.asarray(a), **kwargs)
    with monkeypatch.context() as m:
        m.setattr(tdriver, "generate_omega", omega)
        got = getattr(tinterp, name)(from_numpy(a), **kwargs)
    for g, w in zip(got, want):
        g, w = to_numpy(g), np.asarray(w)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            assert _rel(g, w) <= JAX_RTOL, (name, _rel(g, w))


# --- tests/test_fd.py ----------------------------------------------------


def _stream(a, fd, batch):
    for i in range(0, a.shape[0], batch):
        fd.update(a[i:i + batch])
    return fd


def _fd(n, l):
    return FrequentDirections(n, l, dtype=torch.float64, device="cpu")


def _low_rank_rows(m, n, k, seed=0, noise=1e-3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)) @ rng.standard_normal((k, n))
    return a + noise * rng.standard_normal((m, n))


class TestFrequentDirections:
    def test_covariance_bound(self):
        """||A^T A - S^T S||_2 <= ||A - A_k||_F^2 / (l - k), every k < l."""
        m, n, l = 400, 64, 24
        a = _low_rank_rows(m, n, 8, seed=0, noise=0.05)
        s = to_numpy(_stream(a, _fd(n, l), 37).sketch())
        gap = np.linalg.norm(a.T @ a - s.T @ s, 2)
        sv = np.linalg.svd(a, compute_uv=False)
        for k in (0, 4, 8, 16):
            bound = np.sum(sv[k:] ** 2) / (l - k)
            assert gap <= bound * (1 + 1e-9), (k, gap, bound)

    def test_batch_size_invariance(self):
        m, n, l = 256, 40, 12
        a = _low_rank_rows(m, n, 5, seed=2)
        s1 = _stream(a, _fd(n, l), 7).sketch()
        s2 = _stream(a, _fd(n, l), 64).sketch()
        np.testing.assert_allclose(to_numpy(s1), to_numpy(s2), atol=1e-9)

    def test_eigvec_recovery_low_rank(self):
        m, n, l = 500, 32, 16
        a = _low_rank_rows(m, n, 4, seed=3, noise=1e-6)
        lam, v = _stream(a, _fd(n, l), 61).eigh_estimate(k=4)
        true_w, true_v = np.linalg.eigh(a.T @ a)
        true_w, true_v = true_w[::-1][:4], true_v[:, ::-1][:, :4]
        np.testing.assert_allclose(to_numpy(lam), true_w, rtol=1e-3)
        overlap = np.abs(np.einsum("ij,ij->j", to_numpy(v), true_v))
        assert overlap.min() > 1.0 - 1e-6

    def test_short_stream_is_exact(self):
        a = _low_rank_rows(10, 20, 3, seed=4)
        fd = _fd(20, 16).update(a)
        np.testing.assert_allclose(to_numpy(fd.sketch()), a)
        assert fd.rows_seen == 10

    def test_memory_is_bounded(self):
        fd = _fd(30, 8)
        for i in range(50):
            fd.update(np.random.default_rng(i).standard_normal((13, 30)))
        assert fd.sketch().shape[0] <= 16
        assert fd.rows_seen == 650


# --- tests/test_interp.py ------------------------------------------------


def _low_rank(m, n, k, seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)) @ rng.standard_normal((k, n))
    if noise:
        a = a + noise * rng.standard_normal((m, n))
    return a


class TestColumnID:
    def test_exact_on_low_rank(self, monkeypatch):
        a = _low_rank(120, 90, 8, seed=0)
        cols, x = column_id(from_numpy(a), k=8, p=8)
        err = np.linalg.norm(a - to_numpy(id_reconstruct(from_numpy(a),
                                                         cols, x)))
        assert err < 1e-8 * np.linalg.norm(a)
        _held_to_jax(monkeypatch, "column_id", a, k=8, p=8)

    def test_pivots_unique_and_in_range(self, monkeypatch):
        a = _low_rank(64, 48, 6, seed=1, noise=1e-3)
        cols = to_numpy(column_id(from_numpy(a), k=6)[0])
        assert len(np.unique(cols)) == 6
        assert cols.min() >= 0 and cols.max() < 48
        _held_to_jax(monkeypatch, "column_id", a, k=6)

    def test_selected_columns_represent_themselves(self, monkeypatch):
        a = _low_rank(80, 60, 5, seed=2)
        cols, x = column_id(from_numpy(a), k=5)
        sub = to_numpy(x)[:, to_numpy(cols)]
        np.testing.assert_allclose(sub, np.eye(5), atol=1e-8)
        _held_to_jax(monkeypatch, "column_id", a, k=5)

    def test_near_optimal_on_noisy(self, monkeypatch):
        a = _low_rank(100, 100, 10, seed=3, noise=1e-4)
        cols, x = column_id(from_numpy(a), k=10, p=10)
        err = np.linalg.norm(a - to_numpy(id_reconstruct(from_numpy(a),
                                                         cols, x)))
        s = np.linalg.svd(a, compute_uv=False)
        assert err < 20.0 * np.sqrt(np.sum(s[10:] ** 2))
        _held_to_jax(monkeypatch, "column_id", a, k=10, p=10)

    def test_deterministic(self, monkeypatch):
        a = _low_rank(64, 48, 6, seed=4, noise=1e-3)
        c1, x1 = column_id(from_numpy(a), k=6, seed=7)
        c2, x2 = column_id(from_numpy(a), k=6, seed=7)
        np.testing.assert_array_equal(to_numpy(c1), to_numpy(c2))
        np.testing.assert_allclose(to_numpy(x1), to_numpy(x2))
        _held_to_jax(monkeypatch, "column_id", a, k=6, seed=7)


class TestRowIDAndCUR:
    def test_row_id_exact_on_low_rank(self, monkeypatch):
        a = _low_rank(90, 120, 7, seed=5)
        rows, x = row_id(from_numpy(a), k=7, p=8)
        rec = to_numpy(x) @ a[to_numpy(rows), :]
        assert np.linalg.norm(a - rec) < 1e-8 * np.linalg.norm(a)
        _held_to_jax(monkeypatch, "row_id", a, k=7, p=8)

    def test_cur_exact_on_low_rank(self, monkeypatch):
        a = _low_rank(100, 80, 6, seed=6)
        cols, rows, u = cur(from_numpy(a), k=6, p=8)
        rec = to_numpy(cur_reconstruct(from_numpy(a), cols, rows, u))
        assert np.linalg.norm(a - rec) < 1e-7 * np.linalg.norm(a)
        _held_to_jax(monkeypatch, "cur", a, k=6, p=8)

    def test_cur_noisy_bounded(self, monkeypatch):
        a = _low_rank(100, 80, 8, seed=7, noise=1e-4)
        cols, rows, u = cur(from_numpy(a), k=8, p=10)
        rec = to_numpy(cur_reconstruct(from_numpy(a), cols, rows, u))
        s = np.linalg.svd(a, compute_uv=False)
        assert np.linalg.norm(a - rec) < 50.0 * np.sqrt(np.sum(s[8:] ** 2))
        _held_to_jax(monkeypatch, "cur", a, k=8, p=10)


class TestLeverage:
    def test_scores_match_exact_subspace(self):
        rng = np.random.default_rng(40)
        u = np.linalg.qr(rng.standard_normal((80, 4)))[0]
        a = u @ rng.standard_normal((4, 50))
        s = to_numpy(leverage_scores(from_numpy(a), 4, seed=1))
        np.testing.assert_allclose(s, (u ** 2).sum(axis=1), atol=1e-8)
        np.testing.assert_allclose(s.sum(), 4.0, rtol=1e-9)

    def test_column_axis(self):
        rng = np.random.default_rng(41)
        v = np.linalg.qr(rng.standard_normal((30, 3)))[0]
        a = rng.standard_normal((50, 3)) @ v.T
        s = to_numpy(leverage_scores(from_numpy(a), 3, axis=1, seed=2))
        np.testing.assert_allclose(s, (v ** 2).sum(axis=1), atol=1e-8)

    def test_sampling_distinct_and_importance_weighted(self):
        rng = np.random.default_rng(42)
        # one row carries almost all the rank-1 energy
        a = np.outer(np.r_[10.0, 0.1 * np.ones(99)],
                     rng.standard_normal(20))
        a += 1e-6 * rng.standard_normal(a.shape)
        idx, scores = leverage_sample(from_numpy(a), 1, 5, seed=0)
        idx = to_numpy(idx)
        assert len(set(idx.tolist())) == 5          # distinct
        assert 0 in idx.tolist()                    # dominant row sampled
