"""The port's sparse sign embedding (``ops/sketching.py``) and the
diagnostics probe estimators (``rsvd/diagnostics.py``) against the JAX
package's, on the CPU in f64.

Values: JAX's buckets and signs (CountSketch) and JAX's probes (the
estimators) are patched into the port's draws, and the results must
equal JAX's to ``RTOL`` = 1e-12 (the same f64 sums in another order).
The port's own streams are torch Philox draws and are held by
statistics instead: E||S x||^2 = ||x||^2 within 10% over 200 seeds, the
singular values of S Q for an orthonormal Q in [0.5, 1.5], the
certificates above the true error at every one of 30 seeds and at most
40x it (JAX's bars, tests/test_diagnostics.py:26-44), and the probes'
stream disjoint from ``generate_omega``'s."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.core.rng import (
    key_from_seed as jax_key_from_seed,
)
from rsvd_kamaneh_raganato_terrana_tpu.ops import sketching as jsk
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import diagnostics as jdiag
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops import sketching as tsk
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import diagnostics as tdiag
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    generate_omega,
)

from_numpy = functools.partial(convert.from_numpy, device="cpu")
RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_buckets_and_signs(seed, m, s, t):
    """JAX's (bucket, sign) draws of countsketch_apply (ops/sketching.py:
    49-54), as the port's ``_buckets_and_signs`` returns them."""
    key = jax_key_from_seed(seed)
    out = []
    for j in range(t):
        kb, ks = jax.random.split(jax.random.fold_in(key, j))
        bucket = np.asarray(jax.random.randint(kb, (m,), 0, s))
        sign = np.asarray(jax.random.bernoulli(ks, 0.5, (m,)))
        out.append((torch.from_numpy(bucket.astype(np.int64)),
                    torch.from_numpy(np.array(sign))))
    return out


def _dense_s(draws, m, s):
    """The plain S (s x m) of given (bucket, sign) rounds."""
    t = len(draws)
    dense = np.zeros((s, m))
    for bucket, sign in draws:
        vals = np.where(sign.numpy(), 1.0, -1.0) / np.sqrt(t)
        np.add.at(dense, (bucket.numpy(), np.arange(m)), vals)
    return dense


@pytest.mark.parametrize("shape, s, t", [((200, 12), 48, 8),
                                         ((150, 5), 40, 1),
                                         ((120,), 30, 3)])
def test_countsketch_matches_jax_on_jax_draws(monkeypatch, shape, s, t):
    x = np.random.default_rng(0).standard_normal(shape)
    seed = 11
    monkeypatch.setattr(
        tsk, "_buckets_and_signs",
        lambda key, m, size, tt: _jax_buckets_and_signs(seed, m, size, tt))
    got = to_numpy(tsk.countsketch_apply(seed, from_numpy(x), s, t))
    want = np.asarray(jsk.countsketch_apply(seed, jnp.asarray(x), s, t))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


def test_countsketch_is_its_dense_s():
    """The scatter-adds equal the plain S of the same buckets and signs."""
    m, s, t = 300, 64, 8
    x = np.random.default_rng(1).standard_normal((m, 7))
    draws = tsk._buckets_and_signs(torch.Generator().manual_seed(5), m, s, t)
    got = to_numpy(tsk.countsketch_apply(torch.Generator().manual_seed(5),
                                         from_numpy(x), s, t))
    np.testing.assert_allclose(got, _dense_s(draws, m, s) @ x, rtol=RTOL,
                               atol=1e-13)


def test_countsketch_draws_are_per_round_and_deterministic():
    gen = torch.Generator().manual_seed(3)
    a = tsk._buckets_and_signs(gen, 500, 50, 4)
    b = tsk._buckets_and_signs(torch.Generator().manual_seed(3), 500, 50, 4)
    for (ba, sa), (bb, sb) in zip(a, b):
        assert torch.equal(ba, bb) and torch.equal(sa, sb)
        assert int(ba.min()) >= 0 and int(ba.max()) < 50
    assert not torch.equal(a[0][0], a[1][0])
    x = from_numpy(np.random.default_rng(2).standard_normal((500, 3)))
    assert torch.equal(tsk.countsketch_apply(3, x, 50, 4),
                       tsk.countsketch_apply(3, x, 50, 4))


def test_countsketch_preserves_norm_in_expectation():
    x = from_numpy(np.random.default_rng(4).standard_normal((400, 6)))
    true = float(torch.sum(x * x))
    norms = [float(torch.sum(tsk.countsketch_apply(seed, x, 64) ** 2))
             for seed in range(200)]
    assert abs(np.mean(norms) - true) < 0.1 * true


def test_countsketch_subspace_embedding():
    q, _ = np.linalg.qr(np.random.default_rng(5).standard_normal((2000, 10)))
    sq = tsk.countsketch_apply(0, from_numpy(q), 4 * 10 * 4)
    sv = np.linalg.svd(to_numpy(sq), compute_uv=False)
    assert 0.5 < sv[-1] and sv[0] < 1.5, (sv[0], sv[-1])


def test_countsketch_vector_and_linearity():
    rng = np.random.default_rng(6)
    x, y = (from_numpy(rng.standard_normal(100)) for _ in range(2))
    sx, sy = (tsk.countsketch_apply(9, v, 16) for v in (x, y))
    assert sx.shape == (16,)
    np.testing.assert_allclose(to_numpy(tsk.countsketch_apply(9, 2 * x - y,
                                                              16)),
                               to_numpy(2 * sx - sy), atol=1e-12)


def _jax_probes(seed, shape, dtype, device):
    return from_numpy(np.asarray(jax.random.normal(
        jdiag._probe_key(seed), shape, jnp.float64)))


def _low_rank_plus_noise(m=120, n=90, r=10, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    return a + 1e-3 * rng.standard_normal((m, n))


@pytest.mark.parametrize("seed", [0, 7])
def test_probe_estimators_match_jax_on_jax_probes(monkeypatch, seed):
    monkeypatch.setattr(tdiag, "_probes", _jax_probes)
    a = _low_rank_plus_noise()
    q, _ = np.linalg.qr(a @ np.random.default_rng(1).standard_normal((90,
                                                                       12)))
    u, s, vt = np.linalg.svd(a, full_matrices=False)
    u, s, v = u[:, :8], s[:8], vt[:8].T
    ja, tq = jnp.asarray(a), from_numpy(a)
    pairs = [
        (jdiag.range_error_estimate(ja, jnp.asarray(q), seed, 6),
         tdiag.range_error_estimate(tq, from_numpy(q), seed, 6)),
        (jdiag.factorization_error_estimate(
            ja, *map(jnp.asarray, (u, s, v)), seed=seed, num_probes=6),
         tdiag.factorization_error_estimate(
            tq, *map(from_numpy, (u, s, v)), seed=seed, num_probes=6)),
        (jdiag.spectral_norm_estimate(ja, seed, 12),
         tdiag.spectral_norm_estimate(tq, seed, 12)),
        (jdiag.stable_rank_estimate(ja, seed, 12),
         tdiag.stable_rank_estimate(tq, seed, 12)),
    ]
    for want, got in pairs:
        assert got.dim() == 0 and got.dtype == torch.float64
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_certificates_hold_over_seeds():
    """The port's own probes: every seed's certificate bounds the true
    2-norm error and stays within 40x of it."""
    a = _low_rank_plus_noise(seed=3)
    q, _ = np.linalg.qr(a @ np.random.default_rng(2).standard_normal((90, 8)))
    true_range = np.linalg.norm(a - q @ (q.T @ a), 2)
    u, s, vt = np.linalg.svd(a, full_matrices=False)
    true_fact = s[8]
    tq, tqq = from_numpy(a), from_numpy(q)
    uvs = [from_numpy(x) for x in (u[:, :8], s[:8], vt[:8].T)]
    for seed in range(30):
        est = float(tdiag.range_error_estimate(tq, tqq, seed))
        assert true_range * (1 - 1e-9) <= est <= 40.0 * true_range
        est = float(tdiag.factorization_error_estimate(tq, *uvs, seed=seed))
        assert true_fact * (1 - 1e-9) <= est <= 40.0 * true_fact


def test_probe_stream_is_disjoint_from_omega():
    for seed in (0, 1, 12345):
        g = tdiag._probes(seed, (90, 10), torch.float64, "cpu")
        omega = generate_omega(seed, 90, 10, torch.float64, device="cpu")
        assert not torch.allclose(g, omega)
        assert torch.equal(g, tdiag._probes(seed, (90, 10), torch.float64,
                                            "cpu"))


def test_spectral_norm_and_stable_rank():
    rng = np.random.default_rng(8)
    u, _ = np.linalg.qr(rng.standard_normal((150, 40)))
    v, _ = np.linalg.qr(rng.standard_normal((60, 40)))
    s = np.geomspace(10.0, 0.1, 40)
    s[1] = 5.0                                    # a gap: converges fast
    a = (u * s) @ v.T
    sig = float(tdiag.spectral_norm_estimate(from_numpy(a), seed=2))
    assert abs(sig - 10.0) < 1e-10 * 10.0 and sig <= 10.0 * (1 + 1e-12)
    sr = float(tdiag.stable_rank_estimate(from_numpy(a), seed=2))
    np.testing.assert_allclose(sr, np.sum(s ** 2) / 100.0, rtol=1e-9)
