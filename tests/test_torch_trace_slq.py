"""The port's trace and diagonal estimators (``rsvd/trace.py``) and
stochastic Lanczos quadrature (``rsvd/slq.py``) against the JAX
package's, on the CPU in f64.

With JAX's probes patched into the port's draws (one value per call, in
the order JAX draws them), every estimate equals JAX's to ``RTOL`` =
1e-10 relative (Lanczos, run on the same vector, the same); the matrix-
free forms equal the dense ones to 1e-12.  The port's own streams are
held by the JAX package's statistical bars (tests/test_trace.py,
tests/test_slq.py): Hutchinson within 5 standard errors of tr(A),
Hutch++ exact on a PSD matrix whose rank is below budget/3 and 5x
better than Hutchinson on a decaying spectrum, diag_estimate exact on
a diagonal matrix, log det within 5% of slogdet's."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.core.rng import (
    key_from_seed as jax_key_from_seed,
    rademacher as jax_rademacher,
    sketch_matrix as jax_sketch_matrix,
)
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import slq as jslq
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import trace as jtrace
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import slq as tslq
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import trace as ttrace

from_numpy = functools.partial(convert.from_numpy, device="cpu")
RTOL = 1e-10
N = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _patch_queue(monkeypatch, module, name, values):
    """Replace ``module.name`` by a draw that returns ``values`` in
    order, one a call."""
    queue = [from_numpy(np.asarray(v)) for v in values]

    def draw(*args, **kwargs):
        return queue.pop(0)
    monkeypatch.setattr(module, name, draw)
    return queue


def _spd(n=N, seed=0, decay=0.9):
    r = np.random.default_rng(seed)
    u, _ = np.linalg.qr(r.standard_normal((n, n)))
    lam = 0.05 + decay ** np.arange(n)
    return (u * lam) @ u.T, lam


def _gram_apply(x, b):
    """A X for A = B^T B, the matrix-free operator of the tests."""
    return b.T @ (b @ x)


@pytest.mark.parametrize("kind", ["rademacher", "gaussian"])
def test_hutchinson_matches_jax(monkeypatch, kind):
    a, _ = _spd()
    seed, m = 3, 16
    queue = _patch_queue(monkeypatch, ttrace, "sketch_matrix", [
        jax_sketch_matrix(jax_key_from_seed(seed), N, m, jnp.float64, kind)])
    est_j, se_j = jtrace.hutchinson(jnp.asarray(a), seed, m, kind)
    est_t, se_t = ttrace.hutchinson(from_numpy(a), seed, m, kind)
    assert not queue
    np.testing.assert_allclose(float(est_t), float(est_j), rtol=RTOL)
    np.testing.assert_allclose(float(se_t), float(se_j), rtol=RTOL)


def test_hutchpp_matches_jax(monkeypatch):
    a, _ = _spd(seed=1)
    seed, budget = 4, 30
    ks, kg = jax.random.split(jax_key_from_seed(seed))
    queue = _patch_queue(monkeypatch, ttrace, "sketch_matrix", [
        jax_sketch_matrix(k, N, budget // 3, jnp.float64, "rademacher")
        for k in (ks, kg)])
    est_j = jtrace.hutchpp(jnp.asarray(a), seed, budget)
    est_t = ttrace.hutchpp(from_numpy(a), seed, budget)
    assert not queue
    np.testing.assert_allclose(float(est_t), float(est_j), rtol=RTOL)


def test_diag_estimate_matches_jax(monkeypatch):
    a, _ = _spd(seed=2)
    seed, m = 5, 24
    _patch_queue(monkeypatch, ttrace, "sketch_matrix", [
        jax_sketch_matrix(jax_key_from_seed(seed), N, m, jnp.float64,
                          "rademacher")])
    d_j, se_j = jtrace.diag_estimate(jnp.asarray(a), seed, m)
    d_t, se_t = ttrace.diag_estimate(from_numpy(a), seed, m)
    np.testing.assert_allclose(to_numpy(d_t), np.asarray(d_j), rtol=RTOL,
                               atol=1e-14)
    np.testing.assert_allclose(to_numpy(se_t), np.asarray(se_j), rtol=RTOL,
                               atol=1e-14)


@pytest.mark.parametrize("estimator, kw", [
    ("hutchinson", dict(num_samples=32)), ("hutchpp", dict(budget=45)),
    ("diag_estimate", dict(num_samples=32))])
def test_matrix_free_equals_dense(estimator, kw):
    b = np.random.default_rng(3).standard_normal((150, N))
    fn = getattr(ttrace, estimator)
    dense = fn(from_numpy(b.T @ b), seed=7, **kw)
    op = fn(_gram_apply, seed=7, n=N, dtype=torch.float64,
            operands=(from_numpy(b),), **kw)
    for x, y in zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (dense, op))):
        np.testing.assert_allclose(to_numpy(y), to_numpy(x), rtol=1e-12)
    with pytest.raises(ValueError, match="needs n"):
        fn(_gram_apply, operands=(from_numpy(b),))


def test_trace_estimators_on_their_own_stream():
    a, lam = _spd(seed=4)
    est, se = ttrace.hutchinson(from_numpy(a), seed=2, num_samples=256)
    assert abs(float(est) - lam.sum()) < 5 * float(se)
    d = np.diag(np.arange(1.0, 21.0))
    est, se = ttrace.hutchinson(from_numpy(d), seed=0, num_samples=4)
    np.testing.assert_allclose(float(est), np.trace(d), rtol=1e-12)
    assert float(se) < 1e-10
    dg, dse = ttrace.diag_estimate(from_numpy(d), seed=0, num_samples=4)
    np.testing.assert_allclose(to_numpy(dg), np.diag(d), rtol=1e-12)
    assert float(dse.max()) < 1e-10
    r = np.random.default_rng(5)
    g = r.standard_normal((N, 8))
    low = g @ g.T                                   # rank 8 < 96 // 3
    np.testing.assert_allclose(float(ttrace.hutchpp(from_numpy(low),
                                                    seed=0)),
                               np.trace(low), rtol=1e-8)
    u, _ = np.linalg.qr(r.standard_normal((N, N)))
    dec = (u * (1.0 / (np.arange(N) + 1.0) ** 2)) @ u.T
    t = np.trace(dec)
    err_pp = [abs(float(ttrace.hutchpp(from_numpy(dec), seed=s, budget=60))
                  - t) for s in range(8)]
    err_h = [abs(float(ttrace.hutchinson(from_numpy(dec), seed=s,
                                         num_samples=60)[0]) - t)
             for s in range(8)]
    assert np.median(err_pp) < 0.2 * np.median(err_h)


def test_lanczos_tridiag_matches_jax():
    a, _ = _spd(seed=6)
    v0 = np.random.default_rng(7).standard_normal(N)
    al_j, be_j = (np.asarray(x) for x in jslq.lanczos_tridiag(
        jnp.asarray(a), jnp.asarray(v0), 25))
    al_t, be_t = (to_numpy(x) for x in tslq.lanczos_tridiag(
        from_numpy(a), from_numpy(v0), 25))
    assert al_t.shape == (25,) and be_t.shape == (24,)
    np.testing.assert_allclose(al_t, al_j, rtol=RTOL)
    np.testing.assert_allclose(be_t, be_j, rtol=1e-9)
    # N steps recover the spectrum (tests/test_slq.py:26-33)
    al, be = (to_numpy(x) for x in tslq.lanczos_tridiag(
        from_numpy(a[:40, :40]), from_numpy(v0[:40]), 40))
    t = np.diag(al) + np.diag(be, 1) + np.diag(be, -1)
    np.testing.assert_allclose(np.linalg.eigvalsh(t),
                               np.linalg.eigvalsh(a[:40, :40]), atol=1e-10)


@pytest.mark.parametrize("which", ["exp", "logdet", "logdet_shift"])
def test_slq_matches_jax(monkeypatch, which):
    a, _ = _spd(seed=8)
    seed, probes, steps = 6, 8, 20
    _patch_queue(monkeypatch, tslq, "rademacher", [jax_rademacher(
        jax_key_from_seed(seed), (probes, N), jnp.float64)])
    kw = dict(seed=seed, num_probes=probes, steps=steps)
    if which == "exp":
        want = jslq.slq_trace(jnp.asarray(a), jnp.exp, **kw)
        got = tslq.slq_trace(from_numpy(a), torch.exp, **kw)
    else:
        shift = 0.5 if which == "logdet_shift" else 0.0
        want = jslq.logdet_psd(jnp.asarray(a), shift=shift, **kw)
        got = tslq.logdet_psd(from_numpy(a), shift=shift, **kw)
    assert got.dim() == 0 and got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_slq_on_its_own_stream():
    a, lam = _spd(seed=9)
    est = float(tslq.logdet_psd(from_numpy(a), seed=0, num_probes=48,
                                steps=40))
    true = float(np.sum(np.log(lam)))
    assert abs(est - true) < 0.05 * abs(true), (est, true)
    b = np.random.default_rng(10).standard_normal((100, N)) / 10.0
    dense = float(tslq.slq_trace(from_numpy(b.T @ b), torch.exp, seed=4,
                                 num_probes=8, steps=15))
    op = float(tslq.slq_trace(lambda v, bb: bb.T @ (bb @ v), torch.exp,
                              seed=4, num_probes=8, steps=15, n=N,
                              dtype=torch.float64,
                              operands=(from_numpy(b),)))
    assert abs(dense - op) < 1e-8 * abs(dense)
    with pytest.raises(ValueError, match="needs n"):
        tslq.slq_trace(lambda v: v, torch.exp)
    r = np.random.default_rng(11)
    g = r.standard_normal((N, 2))
    rank2 = g @ g.T                               # breakdown after 2 steps
    est = float(tslq.slq_trace(from_numpy(rank2), lambda x: x, seed=1,
                               num_probes=32, steps=12))
    assert np.isfinite(est) and abs(est - np.trace(rank2)) < 0.35 * \
        np.trace(rank2)
