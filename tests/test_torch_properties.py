"""The hypothesis sweeps of tests/test_properties.py:29-246 on the port,
on the CPU (f64 where the JAX case is; f32 where it casts to f32): the
same strategies, the same ``settings`` and the same ``slow`` marks (six
slow, four in Tier-1), each drawn input held to the JAX case's own bar.

Where the function is deterministic in its input the Tier-1 sweeps also
run the JAX function on the same numpy input and compare:
``round_robin_schedule`` equal to the bit, the robust QR's Q R product
and (full rank) Q and R to ``QR_ATOL`` = 1e-10 times max(1, max|A|),
the DEIM indices equal and the projector to ``DEIM_ATOL`` = 1e-10.
``rsvd``, the streaming drivers, rUTV and completion draw: the port is
held to the bar on its own stream."""

import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.linalg.jacobi import (
    round_robin_schedule as jax_round_robin_schedule,
)
from rsvd_kamaneh_raganato_terrana_tpu.linalg.qr import (
    qr_reduced as jax_qr_reduced,
)
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import deim as jdeim
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.incremental import (
    svd_append_columns,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.jacobi import (
    jacobi_svd,
    round_robin_schedule,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import qr_reduced
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.svd import svd
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import (
    reconstruction_error,
    rsvd,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.streaming import (
    rsvd_streaming,
    rsvd_streaming_onepass,
)

# the port's entry points default to the card; these tests run on the CPU
from_numpy = functools.partial(convert.from_numpy, device="cpu")
QR_ATOL = 1e-10
DEIM_ATOL = 1e-10

# the JAX file's settings: every example re-runs a whole pipeline
COMMON = dict(deadline=None, max_examples=6, print_blob=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(*xs):
    return tuple(to_numpy(x) for x in xs)


@given(n=st.integers(2, 40))
@settings(deadline=None, max_examples=20)
def test_round_robin_covers_every_pair_once(n):
    sched = round_robin_schedule(n)
    seen = set()
    for rnd in sched:
        cols = set()
        for p, q in rnd:
            if p == n:
                continue
            assert p not in cols and q not in cols
            cols.update((p, q))
            seen.add((min(p, q), max(p, q)))
    assert len(seen) == n * (n - 1) // 2
    want = jax_round_robin_schedule(n)
    assert sched.dtype == want.dtype and np.array_equal(sched, want)


@given(m=st.sampled_from([2, 3, 17, 40]), n=st.sampled_from([2, 5, 23, 40]),
       seed=st.integers(0, 2**16))
@settings(**COMMON)
@pytest.mark.slow
def test_jacobi_svd_contract(m, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    u, s, v = _np(*jacobi_svd(from_numpy(a)))
    s_np = np.linalg.svd(a, compute_uv=False)
    scale = max(s_np[0], 1.0)
    np.testing.assert_allclose(s, s_np, atol=1e-9 * scale)
    assert np.linalg.norm((u * s[None, :]) @ v.T - a) < 1e-9 * scale
    assert np.all(np.diff(s) <= 1e-12 * scale)  # sorted


@given(m=st.integers(3, 60), n=st.integers(1, 12), seed=st.integers(0, 2**16),
       rank_def=st.booleans())
@settings(**COMMON)
def test_robust_qr_contract(m, n, seed, rank_def):
    if n > m:
        m, n = n, m
    rng = np.random.default_rng(seed)
    if rank_def and n >= 2:
        a = np.outer(rng.standard_normal(m), rng.standard_normal(n))
    else:
        a = rng.standard_normal((m, n))
    q, r = _np(*qr_reduced(from_numpy(a), "robust"))
    scale = max(1.0, np.abs(a).max())
    np.testing.assert_allclose(q @ r, a, atol=1e-8 * scale)
    if not rank_def:
        assert np.linalg.norm(q.T @ q - np.eye(n)) < 1e-8
    jq, jr = (np.asarray(x) for x in jax_qr_reduced(jnp.asarray(a), "robust"))
    np.testing.assert_allclose(q @ r, jq @ jr, atol=QR_ATOL * scale)
    if not (rank_def and n >= 2):
        np.testing.assert_allclose(q, jq, atol=QR_ATOL * scale)
        np.testing.assert_allclose(r, jr, atol=QR_ATOL * scale)


@given(seed=st.integers(0, 2**16), r=st.integers(1, 6),
       k_extra=st.integers(0, 6))
@settings(**COMMON)
@pytest.mark.slow
def test_rsvd_near_optimal(seed, r, k_extra):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((50, 5 + r)) @ rng.standard_normal((5 + r, 40))
    k = min(r + k_extra, 11)
    at = from_numpy(a)
    u, s, v = rsvd(at, k=k, p=8, q=2)
    err = float(reconstruction_error(at, u, s, v))
    s_np = np.linalg.svd(a, compute_uv=False)
    opt = float(np.sqrt((s_np[k:] ** 2).sum()))
    assert err <= opt * 1.02 + 1e-8 * s_np[0]


@given(seed=st.integers(0, 2**16), m=st.sampled_from([20, 47, 70]),
       n=st.sampled_from([16, 33, 50]), panel_rows=st.sampled_from([7, 16, 33]),
       r=st.integers(1, 5))
@settings(**COMMON)
@pytest.mark.slow
def test_streaming_driver_contract(seed, m, n, panel_rows, r):
    """Streamed rSVD (a) is invariant to the panel decomposition and (b)
    recovers an exact rank-r matrix to near machine precision."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((m, r)) @ rng.standard_normal((r, n))).astype(
        np.float32)
    k = min(r + 4, min(m, n))
    run = functools.partial(rsvd_streaming, a, k=k, p=4, q=1, method="eigh",
                            seed=seed % 97, device="cpu")
    u, s, v = _np(*run(panel_rows=panel_rows))
    scale = max(float(np.linalg.norm(a)), 1.0)
    assert np.linalg.norm(a - (u * s[None, :]) @ v.T) < 3e-5 * scale
    s2 = to_numpy(run(panel_rows=m)[1])
    np.testing.assert_allclose(s, s2, rtol=2e-4, atol=1e-5 * scale)


@given(seed=st.integers(0, 2**16), m=st.sampled_from([24, 51, 70]),
       n=st.sampled_from([20, 37, 50]), panel_rows=st.sampled_from([9, 21]),
       r=st.integers(1, 4))
@settings(**COMMON)
@pytest.mark.slow
def test_streaming_onepass_contract(seed, m, n, panel_rows, r):
    """One-pass (two-sided sketch) driver: exact rank-r recovery and
    panel invariance with a single streamed pass over A."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((m, r)) @ rng.standard_normal((r, n))).astype(
        np.float32)
    k = min(r + 4, min(m, n) - 1)
    run = functools.partial(rsvd_streaming_onepass, a, k=k, p=4,
                            seed=seed % 89, device="cpu")
    u, s, v = _np(*run(panel_rows=panel_rows))
    scale = max(float(np.linalg.norm(a)), 1.0)
    assert np.linalg.norm(a - (u * s[None, :]) @ v.T) < 5e-5 * scale
    s2 = to_numpy(run(panel_rows=m)[1])
    np.testing.assert_allclose(s[:r], s2[:r], rtol=2e-4, atol=1e-5 * scale)


@given(seed=st.integers(0, 2**16), n1=st.sampled_from([3, 7, 12]),
       n2=st.sampled_from([1, 4, 8]))
@settings(**COMMON)
@pytest.mark.slow
def test_incremental_append_equals_batch(seed, n1, n2):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((20, n1))
    c = rng.standard_normal((20, n2))
    u, s, v = svd(from_numpy(a), "eigh")
    s2 = to_numpy(svd_append_columns(u, s, v, from_numpy(c))[1])
    s_np = np.linalg.svd(np.concatenate([a, c], axis=1), compute_uv=False)
    np.testing.assert_allclose(s2, s_np, rtol=1e-6,
                               atol=1e-8 * max(s_np[0], 1.0))


@given(seed=st.integers(0, 2**16), m=st.sampled_from([40, 90]),
       k=st.integers(2, 8))
@settings(**COMMON)
def test_deim_interpolation_projector_property(seed, m, k):
    """DEIM invariants for any orthonormal basis: exactness on span(U),
    idempotence of the oblique projector P = proj @ P^T, distinct rows."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.deim import (
        deim_indices,
        deim_projector,
    )

    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, k)))
    ut = from_numpy(u)
    idx_t = deim_indices(ut)
    idx = to_numpy(idx_t)
    assert len(np.unique(idx)) == k
    proj = to_numpy(deim_projector(ut, idx_t))
    p_mat = np.zeros((m, m))
    p_mat[:, idx] = proj
    np.testing.assert_allclose(p_mat @ p_mat, p_mat, atol=1e-8)
    f = u @ rng.standard_normal(k)
    np.testing.assert_allclose(proj @ f[idx], f, atol=1e-8)
    jidx = jdeim.deim_indices(jnp.asarray(u))
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_allclose(
        proj, np.asarray(jdeim.deim_projector(jnp.asarray(u), jidx)),
        atol=DEIM_ATOL)


@given(seed=st.integers(0, 2**16), m=st.sampled_from([30, 64]),
       n=st.sampled_from([24, 50]), k=st.integers(2, 6))
@settings(**COMMON)
@pytest.mark.slow
def test_rutv_factor_contract(seed, m, n, k):
    """UTV invariants on random input: orthonormal U/V, triangular
    positive-diagonal T, and ||A - UTV^T|| <= rsvd-grade error."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.utv import (
        rutv,
        rutv_reconstruct,
    )

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    u, t, v = rutv(from_numpy(a), k=k, p=6, seed=seed)
    rec = to_numpy(rutv_reconstruct(u, t, v))
    u, t, v = _np(u, t, v)
    l = t.shape[0]
    np.testing.assert_allclose(u.T @ u, np.eye(l), atol=1e-8)
    np.testing.assert_allclose(v.T @ v, np.eye(l), atol=1e-8)
    np.testing.assert_allclose(np.tril(t, -1), 0.0, atol=1e-8)
    assert np.all(np.diag(t) >= 0)
    err = np.linalg.norm(a - rec)
    s_np = np.linalg.svd(a, compute_uv=False)
    assert err < 10.0 * np.sqrt(np.sum(s_np[l:] ** 2)) + 1e-9


@given(seed=st.integers(0, 2**16), frac=st.sampled_from([0.5, 0.7, 0.9]))
@settings(**COMMON)
def test_completion_recovery_property(seed, frac):
    """SVP completes any rank-3 matrix from enough random entries,
    whatever its scale, and the observed-RMSE trace never rises (the
    backtracking guard's contract); the bars of
    tests/test_properties.py:218-246."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.completion import (
        complete_lowrank,
    )

    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.integers(-2, 3)
    a = scale * (rng.standard_normal((48, 40))[:, :3]
                 @ rng.standard_normal((3, 40)))
    mask = rng.random((48, 40)) < frac
    res = complete_lowrank(from_numpy(a), from_numpy(mask), k=3, iters=50)
    u, s, v, rmse = _np(res.u, res.s, res.v, res.obs_rmse)
    x = u @ np.diag(s) @ v.T
    assert np.linalg.norm(x - a) < 1e-3 * np.linalg.norm(a)
    assert np.all(rmse[1:] <= rmse[:-1] + 1e-9 * rmse[0])
