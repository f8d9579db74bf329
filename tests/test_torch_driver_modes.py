"""The port's other driver modes -- ``rsvd_batched`` (both modes),
``rsvd_warm``, ``rsvd_onepass``, ``rsvd_adaptive`` and
``rsvd_image_preset`` -- against the JAX package's, on the same numpy
inputs, in float64 (tests/conftest.py turns x64 on).

Torch's generators cannot reproduce JAX's threefry draws, so each test
patches the port's draw with the JAX package's values: per element
``seed + i`` (batched), JAX's split key's Omega and Psi (one-pass), and
``seed + 7919 * round`` per grown block (adaptive)."""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.rsvd import driver as jdriver
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdriver

# the port's entry points default to the card; these tests run on the CPU
from_numpy = functools.partial(convert.from_numpy, device="cpu")
RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _decaying(seed, m, n, ratio=0.7, floor=0.0):
    """U diag(s) V^T with s_i = ratio^i (+ floor), from numpy."""
    rng = np.random.default_rng(seed)
    r = min(m, n)
    u, _ = np.linalg.qr(rng.standard_normal((m, r)))
    v, _ = np.linalg.qr(rng.standard_normal((n, r)))
    return (u * (ratio ** np.arange(r) + floor)) @ v.T


def _jax_draws():
    """The port's ``generate_omega`` answering with JAX's Omega."""
    def draw(key_or_seed, n, l, dtype=None, kind="gaussian", device=None):
        assert kind == "gaussian"
        return from_numpy(np.asarray(jdriver.generate_omega(
            int(key_or_seed), n, l, jnp.float64)))
    return mock.patch.object(tdriver, "generate_omega",
                             side_effect=draw)


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max()


def _recon(u, s, v):
    return (np.asarray(u) * np.asarray(s)[..., None, :]) @ np.swapaxes(
        np.asarray(v), -1, -2)


def _check_factors(got, want, rtol=RTOL):
    tu, ts, tv = (to_numpy(x) for x in got)
    ju, js, jv = (np.asarray(x) for x in want)
    assert tu.shape == ju.shape and ts.shape == js.shape \
        and tv.shape == jv.shape
    assert _rel(ts, js) <= rtol
    assert _rel(_recon(tu, ts, tv), _recon(ju, js, jv)) <= rtol


@pytest.mark.parametrize("mode", ["scan", "vmap"])
def test_batched_matches_jax(mode):
    stack = np.stack([_decaying(s, 40, 30, floor=1e-3) for s in range(3)])
    kw = dict(k=5, p=6, q=1, seed=11, mode=mode)
    want = jdriver.rsvd_batched(jnp.asarray(stack), **kw)
    with _jax_draws() as draw:
        got = tdriver.rsvd_batched(from_numpy(stack), **kw)
    assert [c.args[0] for c in draw.call_args_list] == [11, 12, 13]
    assert tuple(got[0].shape) == (3, 40, 5) and tuple(got[1].shape) == (3, 5)
    _check_factors(got, want)


def test_batched_scan_element_is_the_single_matrix_pipeline():
    stack = from_numpy(np.stack([_decaying(s, 24, 20) for s in range(2)]))
    u, s, v = tdriver.rsvd_batched(stack, k=4, p=4, seed=7)
    for i in range(2):
        omega = tdriver.generate_omega(7 + i, 20, 8, torch.float64,
                                       device="cpu")
        ui, si, vi = tdriver.rsvd_with_omega(stack[i], omega, q=2, k=4,
                                             method="eigh")
        assert torch.equal(s[i], si) and torch.equal(u[i], ui)


@pytest.mark.parametrize("bad", ["k0", "mode", "ndim"])
def test_batched_rejects_bad_arguments(bad):
    stack = torch.zeros((2, 8, 8), dtype=torch.float64)
    with pytest.raises(ValueError):
        if bad == "k0":
            tdriver.rsvd_batched(stack, k=0)
        elif bad == "mode":
            tdriver.rsvd_batched(stack, k=2, mode="pmap")
        else:
            tdriver.rsvd_batched(stack[0], k=2)


@pytest.mark.parametrize("k", [0, 6])
def test_warm_matches_jax(k):
    a = _decaying(1, 50, 40, floor=1e-3)
    a_next = a + 1e-3 * np.random.default_rng(2).standard_normal(a.shape)
    q_prev = np.linalg.qr(a @ np.random.default_rng(3).standard_normal(
        (40, 10)))[0]
    want = jdriver.rsvd_warm(jnp.asarray(a_next), jnp.asarray(q_prev), k=k)
    got = tdriver.rsvd_warm(from_numpy(a_next), from_numpy(q_prev), k=k)
    assert got[1].shape[0] == (k or 10)
    _check_factors(got, want)


@pytest.mark.parametrize("precision", ["highest", "int8"])
def test_onepass_matches_jax(precision):
    a = _decaying(4, 60, 45, floor=1e-2)
    k, p, seed = 5, 6, 9
    want = jdriver.rsvd_onepass(jnp.asarray(a), k=k, p=p, seed=seed,
                                precision=precision)
    l = k + p
    k_om, k_psi = jax.random.split(jax.random.PRNGKey(seed))
    omega = jax.random.normal(k_om, (45, l), jnp.float64)
    psi = jax.random.normal(k_psi, (60, 2 * l + 1), jnp.float64)
    with mock.patch.object(tdriver, "gaussian", side_effect=[
            from_numpy(np.asarray(omega)), from_numpy(np.asarray(psi))]):
        got = tdriver.rsvd_onepass(from_numpy(a), k=k, p=p, seed=seed,
                                   precision=precision)
    _check_factors(got, want)


def test_onepass_takes_a_prequantized_operand():
    a = from_numpy(_decaying(5, 48, 40, floor=1e-2))
    a8 = tdriver.quantize_int8_rows(a)
    u, s, v = tdriver.rsvd_onepass(a8, k=4, seed=2)
    u2, s2, v2 = tdriver.rsvd_onepass(a, k=4, seed=2, precision="int8")
    assert torch.equal(s, s2) and tuple(u.shape) == (48, 4)


def test_onepass_draws_omega_then_psi_from_one_generator():
    a = from_numpy(_decaying(6, 30, 20))
    seen = []
    real = tdriver.gaussian

    def spy(key, shape, dtype):
        seen.append((key.initial_seed(), tuple(shape)))
        return real(key, shape, dtype)
    with mock.patch.object(tdriver, "gaussian", spy):
        tdriver.rsvd_onepass(a, k=3, p=4, seed=8)
    assert seen == [(8, (20, 7)), (8, (30, 15))]     # Omega, then Psi


@pytest.mark.parametrize("tol,k0,spectrum", [
    (1e-2, 4, "0.8^i"), (1e-4, 8, "0.8^i"), (1e-9, 4, "rank 5"),
    (1e-2, 16, "0.97^i")])
def test_adaptive_matches_jax(tol, k0, spectrum):
    if spectrum == "rank 5":
        rng = np.random.default_rng(7)
        a = rng.standard_normal((50, 5)) @ rng.standard_normal((5, 40))
    elif spectrum == "0.8^i":
        a = _decaying(8, 70, 55, ratio=0.8)
    else:
        a = _decaying(8, 300, 240, ratio=0.97)
    want = jdriver.rsvd_adaptive(jnp.asarray(a), tol=tol, k0=k0, seed=3,
                                 return_stats=True)
    with _jax_draws() as draw:
        got = tdriver.rsvd_adaptive(from_numpy(a), tol=tol, k0=k0, seed=3,
                                    return_stats=True)
    tu, ts, tv, tk, tstats = got
    ju, js, jv, jk, jstats = want
    assert tk == jk
    assert tstats["block_sizes"] == jstats["block_sizes"]
    assert tstats["rounds"] == jstats["rounds"]
    assert tstats["work_ratio"] == jstats["work_ratio"]
    assert [c.args[0] for c in draw.call_args_list] == [
        3 + 7919 * r for r in range(tstats["rounds"] + 1)]
    _check_factors((tu, ts, tv), (ju, js, jv))
    err = np.linalg.norm(a - _recon(to_numpy(tu), to_numpy(ts),
                                    to_numpy(tv)))
    assert err <= tol * np.linalg.norm(a) * 1.05
    if spectrum == "rank 5":
        assert tk == 5
    else:                                        # the basis really grew
        assert tstats["rounds"] >= 1
    if spectrum == "0.97^i":
        # from 16 columns of a slowly decaying spectrum the log-linear
        # rank prediction overshoots to k_cap, in both packages
        assert tk == 152 and sum(tstats["block_sizes"]) == 240


def test_adaptive_k_max_cap_and_dense_only():
    a = from_numpy(np.random.default_rng(9).standard_normal((40, 40)))
    *_, k = tdriver.rsvd_adaptive(a, tol=1e-8, k0=8, k_max=16)
    assert k <= 16
    with pytest.raises(TypeError):
        tdriver.rsvd_adaptive(tdriver.quantize_int8_rows(a), tol=1e-2)


@pytest.mark.parametrize("case", range(4))
def test_predict_rank_and_work_ratio_match_jax(case):
    rng = np.random.default_rng(case)
    l = [8, 16, 12, 20][case]
    s64 = np.sort(rng.uniform(0.01, 1.0, l))[::-1] * (
        0.9 ** np.arange(l) if case % 2 else 1.0)
    a_norm_sq = float(np.sum(s64 ** 2) * (1.5 + case))
    args = (s64, a_norm_sq, 1e-4 * a_norm_sq, l, 200)
    assert tdriver._predict_rank(*args) == jdriver._predict_rank(*args)
    blocks = (l, 7, 13)[:case % 3 + 1]
    assert tdriver.adaptive_work_ratio(500, 300, blocks, 2) == \
        jdriver.adaptive_work_ratio(500, 300, blocks, 2)


def test_image_preset_matches_jax():
    a = _decaying(10, 48, 44, ratio=0.85)
    want = jdriver.rsvd_image_preset(jnp.asarray(a), seed=4)
    with _jax_draws():
        got = tdriver.rsvd_image_preset(from_numpy(a), seed=4)
    assert got[1].shape == (11,)                 # min(m, n) / 4
    _check_factors(got, want)
