"""The port's tensor formats (``rsvd/_modewise.py``, ``tucker.py``,
``tt.py``, ``cp.py``), ``complete_tucker`` and the Tucker video codec
against the JAX package's, on the CPU in f64.

Each case of ``tests/test_tucker.py``, ``test_tt.py`` and ``test_cp.py``
runs here on the same numpy input through both packages.  Torch's
generators cannot reproduce JAX's threefry draws, so the JAX package's
Omega for each seed is patched into the port's ``generate_omega`` (and
its CPRAND fiber indices into ``cp._fiber_indices``).  The sign of each
eigenvector of the projected Grams is the LAPACK build's choice (torch's
and jaxlib's differ), and a flipped sign in one mode changes every later
mode's sketch; so the port's eigenvectors are kept but each is given the
sign of JAX's for the same matrix (``_jax_signed_eigh``).  The results must
then equal JAX's to ``RTOL`` = 1e-9 relative, the arithmetic being the
same.  Looser bars, each with its reason: CP-ALS/CPRAND factors 1e-7
(25-60 sweeps of normal-equation solves amplify the solves' roundoff;
the reconstruction stays at 1e-9), ``complete_tucker``'s RMSE trace
1e-6 where above 1e-12 (the backtracking compares RMSEs that agree to
f64 summation noise, which it amplifies late in the iteration, as in
``test_torch_rpca_completion.py``).  The JAX tests' own bars are then
held on the port's results, and each format runs once more on the
port's own draws."""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.apps import image as jimage
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import completion as jcomp
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import cp as jcp
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import tt as jtt
from rsvd_kamaneh_raganato_terrana_tpu.rsvd.driver import (
    generate_omega as jax_generate_omega,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import image as timage
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import device as tdevice
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import _modewise as tmw
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import completion as tcomp
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import cp as tcp
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import tt as ttt

# ``rsvd.tucker`` is the function of that name in both packages
jtucker, ttucker = (importlib.import_module(f"{pkg}.rsvd.tucker") for pkg in (
    "rsvd_kamaneh_raganato_terrana_tpu",
    "rsvd_kamaneh_raganato_terrana_tpu_torch"))

from_numpy = functools.partial(convert.from_numpy, device="cpu")
RTOL = 1e-9
CP_RTOL = 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_omega(seed, n, l, dtype=torch.float64, kind="gaussian",
               device=None):
    """The JAX package's generate_omega(seed, n, l) in f64, on the CPU."""
    return from_numpy(np.asarray(jax_generate_omega(int(seed), n, l,
                                                    jnp.float64)))


def _jax_signed_eigh(g):
    """The port's ``core/device.py::eigh``, each eigenvector signed as
    ``jnp.linalg.eigh``'s of the same matrix."""
    lam, vecs = tdevice.eigh(g)
    _, vj = jnp.linalg.eigh(jnp.asarray(to_numpy(g)))
    sign = np.where(np.sum(to_numpy(vecs) * np.asarray(vj), axis=0) < 0,
                    -1.0, 1.0)
    return lam, vecs * from_numpy(sign, dtype=vecs.dtype)


@pytest.fixture
def jax_draws(monkeypatch):
    """Every port module of this slice draws JAX's Omega for its seed, and
    the per-mode eigenvectors take JAX's signs."""
    for module in (ttucker, ttt, tmw, tcp):
        monkeypatch.setattr(module, "generate_omega", _jax_omega)
    monkeypatch.setattr(tmw, "eigh", _jax_signed_eigh)


def _rel(got, want):
    got = to_numpy(got) if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def _low_mlrank_tensor(shape, ranks, seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal(ranks)
    for mode, (n, r) in enumerate(zip(shape, ranks)):
        u = np.linalg.qr(rng.standard_normal((n, r)))[0]
        t = np.moveaxis(np.tensordot(u, np.moveaxis(t, mode, 0),
                                     axes=(1, 0)), 0, mode)
    if noise:
        t = t + noise * rng.standard_normal(shape)
    return t.astype(np.float64)


def _tt_tensor(shape, ranks, seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    rs = (1,) + tuple(ranks) + (1,)
    cores = [rng.standard_normal((rs[i], n, rs[i + 1]))
             for i, n in enumerate(shape)]
    out = cores[0]
    for c in cores[1:]:
        out = np.tensordot(out, c, axes=((out.ndim - 1,), (0,)))
    t = out[0, ..., 0]
    if noise:
        t = t + noise * rng.standard_normal(shape)
    return t


def _cp_tensor(shape, rank, seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    factors = [rng.standard_normal((n, rank)) for n in shape]
    w = np.sort(rng.uniform(1.0, 3.0, rank))[::-1]
    subs = "".join(chr(ord("a") + i) for i in range(len(shape)))
    t = np.einsum(",".join(f"{c}z" for c in subs) + ",z->" + subs,
                  *factors, w)
    if noise:
        t = t + noise * rng.standard_normal(shape)
    return t


# -- the unfolding algebra and the per-mode step ------------------------------

def test_unfold_fold_roundtrip_matches_jax():
    t = np.random.default_rng(0).standard_normal((3, 4, 5))
    for mode in range(3):
        unf = ttucker._unfold(from_numpy(t), mode)
        np.testing.assert_array_equal(
            to_numpy(unf), np.asarray(jtucker._unfold(jnp.asarray(t), mode)))
        np.testing.assert_array_equal(
            to_numpy(ttucker._fold(unf, mode, t.shape)), t)


def test_mode_dot_matches_numpy_and_jax():
    rng = np.random.default_rng(1)
    t = rng.standard_normal((3, 4, 5))
    m = rng.standard_normal((7, 4))
    got = to_numpy(ttucker.mode_dot(from_numpy(t), from_numpy(m), 1))
    np.testing.assert_allclose(got, np.einsum("ijk,qj->iqk", t, m),
                               atol=1e-12)
    assert _rel(got, jtucker.mode_dot(jnp.asarray(t), jnp.asarray(m), 1)) \
        <= RTOL


def test_modewise_pieces_match_jax(jax_draws):
    from rsvd_kamaneh_raganato_terrana_tpu.rsvd import _modewise as jmw

    unf = np.random.default_rng(2).standard_normal((12, 30))
    q_j, w_j, v_j, tot_j = jmw.mode_spectrum(jnp.asarray(unf), 5, 8, 1)
    q_t, w_t, v_t, tot_t = tmw.mode_spectrum(from_numpy(unf), 5, 8, 1)
    assert _rel(q_t, q_j) <= RTOL
    assert _rel(w_t, w_j) <= RTOL
    assert _rel(tot_t, tot_j) <= RTOL
    u_j, c_j = jmw.mode_contract(jnp.asarray(unf), q_j, v_j, 4)
    u_t, c_t = tmw.mode_contract(from_numpy(unf), q_t, v_t, 4)
    # eigenvectors are defined up to sign: compare the projector and the
    # rank-4 approximation it gives
    assert _rel(u_t @ u_t.T, np.asarray(u_j @ u_j.T)) <= RTOL
    assert _rel(u_t @ c_t, np.asarray(u_j @ c_j)) <= RTOL
    u2, c2 = tmw.tighten_contract(from_numpy(unf), q_t, 4, "highest")
    assert _rel(u2 @ c2, np.asarray(u_j @ c_j)) <= RTOL


# -- Tucker -------------------------------------------------------------------

def _tucker_both(t, ranks, **kw):
    core_j, f_j = jtucker.tucker(t, ranks, **kw)
    core_t, f_t = ttucker.tucker(from_numpy(t), ranks, **kw)
    assert tuple(core_t.shape) == tuple(core_j.shape)
    assert [tuple(f.shape) for f in f_t] == [tuple(f.shape) for f in f_j]
    rec_j = np.asarray(jtucker.tucker_reconstruct(core_j, f_j))
    rec_t = to_numpy(ttucker.tucker_reconstruct(core_t, f_t))
    assert _rel(rec_t, rec_j) <= RTOL
    for u_t, u_j in zip(f_t, f_j):
        assert _rel(u_t @ u_t.T, np.asarray(u_j @ u_j.T)) <= RTOL
    return core_t, f_t, rec_t


def test_tucker_exact_at_full_multilinear_rank(jax_draws):
    shape, ranks = (20, 16, 12), (4, 3, 5)
    t = _low_mlrank_tensor(shape, ranks, seed=2)
    core, _, rec = _tucker_both(t, ranks, q=1, seed=0)
    assert tuple(core.shape) == ranks
    assert np.linalg.norm(rec - t) / np.linalg.norm(t) < 1e-10


def test_tucker_factors_orthonormal(jax_draws):
    t = _low_mlrank_tensor((18, 14, 10), (3, 4, 2), seed=3, noise=0.01)
    _, factors, _ = _tucker_both(t, (3, 4, 2), seed=1)
    for u in factors:
        np.testing.assert_allclose(to_numpy(u.T @ u), np.eye(u.shape[1]),
                                   atol=1e-10)


def test_tucker_4d_and_rank_clipping(jax_draws):
    t = np.random.default_rng(4).standard_normal((6, 5, 4, 3))
    core, factors, _ = _tucker_both(t, (10, 2, 2, 2))
    assert tuple(core.shape) == (6, 2, 2, 2)
    assert [tuple(f.shape) for f in factors] == [(6, 6), (5, 2), (4, 2),
                                                 (3, 2)]


def test_tucker_error_decreases_with_rank(jax_draws):
    """Held to JAX at rank 4 (each rank is one more JAX compile); the
    ordering on the port's runs with JAX's draws."""
    t = _low_mlrank_tensor((24, 20, 16), (6, 6, 6), seed=5, noise=0.05)
    _tucker_both(t, (4, 4, 4), seed=0)
    errs = []
    for r in (2, 4, 6):
        core, factors = ttucker.tucker(from_numpy(t), (r, r, r), seed=0)
        rec = to_numpy(ttucker.tucker_reconstruct(core, factors))
        errs.append(np.linalg.norm(rec - t))
    assert errs[0] > errs[1] > errs[2]


def test_tucker_wrong_rank_count_raises():
    with pytest.raises(ValueError):
        ttucker.tucker(from_numpy(np.zeros((3, 3, 3))), (2, 2))


def test_tucker_pythagorean_identity(jax_draws):
    t = np.random.default_rng(9).standard_normal((14, 12, 10))
    core, _, rec = _tucker_both(t, (5, 4, 3), seed=0)
    np.testing.assert_allclose(
        np.linalg.norm(t - rec) ** 2,
        np.linalg.norm(t) ** 2 - np.linalg.norm(to_numpy(core)) ** 2,
        rtol=1e-9)


def test_tucker_over_asked_ranks_clip_consistently(jax_draws):
    t = np.random.default_rng(8).standard_normal((6, 50, 50))
    core, factors, _ = _tucker_both(t, (30, 2, 2))
    assert tuple(core.shape) == (4, 2, 2)
    assert [tuple(f.shape) for f in factors] == [(6, 4), (50, 2), (50, 2)]


@pytest.mark.parametrize("precision", ["default", "bf16"])
def test_tucker_precision_names_map_as_the_driver(jax_draws, precision):
    """On the CPU 'default' and the storage names run at full precision
    in both packages (JAX's DEFAULT on the CPU is f64 here)."""
    t = _low_mlrank_tensor((12, 10, 8), (3, 3, 3), seed=6, noise=1e-3)
    _tucker_both(t, (3, 3, 3), precision=precision)


def test_tucker_adaptive_meets_tolerance(jax_draws):
    t = _low_mlrank_tensor((25, 20, 15), (5, 4, 3), seed=6, noise=1e-9)
    core_j, f_j, ranks_j = jtucker.tucker_adaptive(t, tol=1e-6)
    core, factors, ranks = ttucker.tucker_adaptive(from_numpy(t), tol=1e-6)
    assert ranks == ranks_j
    rec = to_numpy(ttucker.tucker_reconstruct(core, factors))
    assert _rel(rec, jtucker.tucker_reconstruct(core_j, f_j)) <= RTOL
    assert np.linalg.norm(rec - t) / np.linalg.norm(t) <= 1e-6
    assert all(r <= tr + 2 for r, tr in zip(ranks, (5, 4, 3)))


def test_tucker_adaptive_rank_cap_respected(jax_draws):
    t = np.random.default_rng(7).standard_normal((20, 20, 20))
    _, f_j, ranks_j = jtucker.tucker_adaptive(t, tol=1e-12,
                                              rank_cap=(4, 5, 6))
    core, factors, ranks = ttucker.tucker_adaptive(
        from_numpy(t), tol=1e-12, rank_cap=(4, 5, 6))
    assert ranks == ranks_j == (4, 5, 6)
    assert [f.shape[1] for f in factors] == [4, 5, 6]
    for u_t, u_j in zip(factors, f_j):
        assert _rel(u_t @ u_t.T, np.asarray(u_j @ u_j.T)) <= RTOL


def test_tucker_on_its_own_stream():
    t = _low_mlrank_tensor((20, 16, 12), (4, 3, 5), seed=2)
    core, factors = ttucker.tucker(from_numpy(t), (4, 3, 5))
    rec = to_numpy(ttucker.tucker_reconstruct(core, factors))
    assert np.linalg.norm(rec - t) / np.linalg.norm(t) < 1e-10


# -- the Tucker video codec ---------------------------------------------------

def _pan(t_len=32, h=48, w=40, r=4, seed=10):
    rng = np.random.default_rng(seed)
    us = np.linalg.qr(rng.standard_normal((h, r)))[0]
    vs = np.linalg.qr(rng.standard_normal((w, r)))[0]
    tt = np.linspace(0, 1, t_len)[:, None]
    coef = np.cos(tt * np.arange(1, r + 1) * np.pi)
    return np.einsum("tr,ir,jr->tij", coef, us, vs)


def test_video_tucker_matches_jax_and_beats_per_frame(jax_draws):
    frames, r = _pan(), 4
    core_j, f_j = jimage.compress_video_tucker(frames, (r, r, r),
                                               dtype=jnp.float64)
    core, factors = timage.compress_video_tucker(
        frames, (r, r, r), dtype=torch.float64, device="cpu")
    assert isinstance(core, np.ndarray)
    assert all(isinstance(f, np.ndarray) for f in factors)
    rec_t = timage.reconstruct_video_tucker(core, factors, device="cpu")
    assert isinstance(rec_t, np.ndarray) and rec_t.shape == frames.shape
    assert _rel(rec_t, jimage.reconstruct_video_tucker(core_j, f_j)) <= RTOL
    err_t = np.linalg.norm(rec_t - frames) / np.linalg.norm(frames)
    assert err_t < 1e-8
    # the JAX test's comparison with per-frame compression, on the port's
    # own per-frame codec
    u, s, v = timage.compress_video(frames, k=r, dtype=torch.float64,
                                    device="cpu")
    rec_f = timage.reconstruct_video(u, s, v)
    err_f = np.linalg.norm(rec_f - frames) / np.linalg.norm(frames)
    storage_t = core.size + sum(f.size for f in factors)
    assert err_t < max(err_f, 1e-8) * 10
    assert storage_t < 0.2 * (u.size + s.size + v.size)


# -- complete_tucker ----------------------------------------------------------

@pytest.mark.parametrize("eta", [None, 2.0])
def test_complete_tucker_matches_jax(jax_draws, eta):
    shape, ranks = (14, 12, 10), (3, 3, 3)
    t = _low_mlrank_tensor(shape, ranks, seed=11)
    mask = np.random.default_rng(12).random(shape) < 0.5
    a_obs = np.where(mask, t, 1e6)                   # never read
    kw = dict(iters=12, eta=eta, seed=3)
    res_j = jcomp.complete_tucker(jnp.asarray(a_obs), jnp.asarray(mask),
                                  ranks, **kw)
    res_t = tcomp.complete_tucker(from_numpy(a_obs), from_numpy(mask),
                                  ranks, **kw)
    assert isinstance(res_t, tcomp.TuckerCompletionResult)
    assert tuple(res_t.core.shape) == ranks
    assert res_t.obs_rmse.shape == (12,)
    x_j = np.asarray(jtucker.tucker_reconstruct(res_j.core, res_j.factors))
    x_t = to_numpy(ttucker.tucker_reconstruct(res_t.core, res_t.factors))
    assert _rel(x_t, x_j) <= RTOL
    want = np.asarray(res_j.obs_rmse)
    big = np.abs(want) > 1e-12
    np.testing.assert_allclose(to_numpy(res_t.obs_rmse)[big], want[big],
                               rtol=1e-6)


def test_complete_tucker_recovers_on_its_own_stream():
    shape, ranks = (14, 12, 10), (3, 3, 3)
    t = _low_mlrank_tensor(shape, ranks, seed=13)
    mask = np.random.default_rng(14).random(shape) < 0.6
    res = tcomp.complete_tucker(from_numpy(np.where(mask, t, -7.0)),
                                from_numpy(mask), ranks, iters=40)
    x = to_numpy(ttucker.tucker_reconstruct(res.core, res.factors))
    rmse = to_numpy(res.obs_rmse)
    assert np.isfinite(rmse).all() and rmse[-1] < 1e-2 * rmse[0]
    assert np.linalg.norm(x - t) / np.linalg.norm(t) < 5e-2


# -- tensor train -------------------------------------------------------------

def _tt_both(t, ranks, **kw):
    cores_j = jtt.tt_decompose(t, ranks, **kw)
    cores_t = ttt.tt_decompose(from_numpy(t), ranks, **kw)
    assert [tuple(c.shape) for c in cores_t] == \
        [tuple(c.shape) for c in cores_j]
    assert ttt.tt_ranks(cores_t) == jtt.tt_ranks(cores_j)
    rec_t = to_numpy(ttt.tt_reconstruct(cores_t))
    assert _rel(rec_t, jtt.tt_reconstruct(cores_j)) <= RTOL
    return cores_t, rec_t


def test_tt_exact_recovery_at_true_ranks(jax_draws):
    shape, ranks = (8, 9, 7, 6), (3, 4, 2)
    t = _tt_tensor(shape, ranks, seed=0)
    cores, rec = _tt_both(t, ranks, q=1, seed=0)
    assert ttt.tt_ranks(cores) == ranks
    assert np.linalg.norm(rec - t) / np.linalg.norm(t) < 1e-10


def test_tt_core_shapes_and_boundary_ranks(jax_draws):
    t = _tt_tensor((5, 6, 7), (2, 3), seed=1)
    cores, _ = _tt_both(t, (2, 3))
    assert [tuple(c.shape) for c in cores] == [(1, 5, 2), (2, 6, 3),
                                              (3, 7, 1)]


def test_tt_error_decreases_with_rank(jax_draws):
    """Held to JAX at rank 4; the ordering on the port's runs."""
    t = _tt_tensor((10, 10, 10), (6, 6), seed=2, noise=0.02)
    _tt_both(t, (4, 4))
    errs = [np.linalg.norm(to_numpy(ttt.tt_reconstruct(ttt.tt_decompose(
        from_numpy(t), (r, r)))) - t) for r in (2, 4, 6)]
    assert errs[0] > errs[1] > errs[2]


def test_tt_wrong_rank_count_raises():
    with pytest.raises(ValueError):
        ttt.tt_decompose(from_numpy(np.zeros((3, 3, 3))), (2,))


def test_tt_pythagorean_identity(jax_draws):
    t = np.random.default_rng(9).standard_normal((10, 9, 8, 7))
    _, rec = _tt_both(t, (3, 4, 3), seed=1)
    np.testing.assert_allclose(np.linalg.norm(t - rec) ** 2,
                               np.linalg.norm(t) ** 2
                               - np.linalg.norm(rec) ** 2, rtol=1e-9)


def test_tt_quantized_reshape_compresses_smooth_signal(jax_draws):
    """At tol 1e-8 over 7 modes each mode's budget^2 is 1.4e-17 of the
    energy, below the f64 roundoff of ``total - cumsum(w)``: the rank
    decisions are roundoff's, so the ranks may differ from JAX's (the
    port keeps rank 4 at one mode where JAX keeps 2), and the two trains
    are held to each other at the accuracy both reach, 1e-7."""
    x = np.linspace(0, 1, 2 ** 8)
    sig = np.exp(-3 * x) * np.sin(7 * np.pi * x)
    t = sig.reshape((2,) * 8)
    cores_j, _ = jtt.tt_adaptive(t, tol=1e-8, rank_cap=16)
    cores, ranks = ttt.tt_adaptive(from_numpy(t), tol=1e-8, rank_cap=16)
    rec = to_numpy(ttt.tt_reconstruct(cores)).reshape(-1)
    assert _rel(rec, np.asarray(jtt.tt_reconstruct(cores_j)).reshape(-1)) \
        <= 1e-7
    assert np.linalg.norm(rec - sig) / np.linalg.norm(sig) < 1e-7
    assert ttt.tt_compression_ratio(cores) > 2.0
    assert max(ranks) <= 16


def test_tt_adaptive_meets_tolerance_near_true_ranks(jax_draws):
    t = _tt_tensor((12, 10, 8, 6), (3, 4, 2), seed=3, noise=1e-10)
    cores_j, ranks_j = jtt.tt_adaptive(t, tol=1e-6)
    cores, ranks = ttt.tt_adaptive(from_numpy(t), tol=1e-6)
    assert ranks == ranks_j
    rec = to_numpy(ttt.tt_reconstruct(cores))
    assert _rel(rec, jtt.tt_reconstruct(cores_j)) <= RTOL
    assert np.linalg.norm(rec - t) / np.linalg.norm(t) <= 1e-6
    assert all(r <= tr + 2 for r, tr in zip(ranks, (3, 4, 2)))


# -- CP -----------------------------------------------------------------------

def test_khatri_rao_matches_outer_products_and_jax():
    rng = np.random.default_rng(1)
    b, c = rng.standard_normal((4, 3)), rng.standard_normal((5, 3))
    kr = to_numpy(tcp.khatri_rao([from_numpy(b), from_numpy(c)]))
    want = np.stack([np.outer(b[:, r], c[:, r]).reshape(-1)
                     for r in range(3)], axis=1)
    np.testing.assert_allclose(kr, want, atol=1e-12)
    np.testing.assert_array_equal(
        kr, np.asarray(jcp.khatri_rao([jnp.asarray(b), jnp.asarray(c)])))


def _jax_fibers(seed, iters, shape, rank, num_samples):
    """The JAX package's CPRAND fiber indices, keyed (sweep, mode)."""
    key0 = jax.random.fold_in(jax.random.PRNGKey(seed), 12345)
    d = len(shape)
    out = {}
    for it in range(iters):
        for i in range(d):
            key = jax.random.fold_in(jax.random.fold_in(key0, it), i)
            ks = jax.random.split(key, d - 1)
            others = [j for j in range(d) if j != i]
            out[it, i] = [from_numpy(np.asarray(jax.random.randint(
                ks[t], (num_samples,), 0, shape[j])), dtype=torch.int64)
                for t, j in enumerate(others)]
    return out


def _cp_both(monkeypatch, t, rank, **kw):
    w_j, f_j = jcp.cp_decompose(t, rank, **kw)
    if kw.get("method") == "rand":
        s = kw.get("num_samples") or 4 * rank + 64
        s = max(min(s, t.size // min(t.shape)), rank)
        table = _jax_fibers(kw.get("seed", 0), kw["iters"], t.shape, rank, s)
        monkeypatch.setattr(
            tcp, "_fiber_indices",
            lambda key0, it, i, shape, num_samples: table[it, i])
    w_t, f_t = tcp.cp_decompose(from_numpy(t), rank, **kw)
    assert _rel(w_t, w_j) <= CP_RTOL
    for a, b in zip(f_t, f_j):
        assert _rel(a, b) <= CP_RTOL
    rec_t = to_numpy(tcp.cp_reconstruct(w_t, f_t))
    assert _rel(rec_t, jcp.cp_reconstruct(w_j, f_j)) <= RTOL
    return w_t, f_t, rec_t


def test_cp_recovers_exact_cp_tensor(jax_draws, monkeypatch):
    t = _cp_tensor((12, 10, 8), 3, seed=2)
    _, _, rec = _cp_both(monkeypatch, t, 3, iters=30, seed=0)
    assert np.linalg.norm(rec - t) / np.linalg.norm(t) < 1e-6


def test_cp_conventions(jax_draws, monkeypatch):
    t = _cp_tensor((9, 7, 6), 2, seed=3)
    w, factors, _ = _cp_both(monkeypatch, t, 2, iters=20)
    w = to_numpy(w)
    assert w[0] >= w[1] > 0
    for f in factors:
        np.testing.assert_allclose(np.linalg.norm(to_numpy(f), axis=0), 1.0,
                                   rtol=1e-6)


def test_cp_4way_noisy(jax_draws, monkeypatch):
    t = _cp_tensor((8, 7, 6, 5), 2, seed=4, noise=1e-3)
    _, _, rec = _cp_both(monkeypatch, t, 2, iters=30, seed=1)
    assert np.linalg.norm(rec - t) / np.linalg.norm(t) < 5e-3


def test_cp_matrix_case_matches_svd_energy(jax_draws, monkeypatch):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((20, 4)) @ rng.standard_normal((4, 15))
    _, _, rec = _cp_both(monkeypatch, a, 4, iters=30)
    assert np.linalg.norm(rec - a) / np.linalg.norm(a) < 1e-8


def test_cp_zero_tensor_yields_zero_weights_not_nan():
    w, factors = tcp.cp_decompose(from_numpy(np.zeros((6, 5, 4))), 2,
                                  iters=5)
    w_j, _ = jcp.cp_decompose(np.zeros((6, 5, 4)), 2, iters=5)
    np.testing.assert_array_equal(to_numpy(w), np.asarray(w_j))
    np.testing.assert_allclose(to_numpy(w), 0.0, atol=1e-12)
    for f in factors:
        assert torch.isfinite(f).all()


def test_cp_ndim_guard_and_size_guard():
    with pytest.raises(ValueError):
        tcp.cp_decompose(from_numpy(np.zeros(5)), 2)
    with pytest.raises(ValueError):
        tcp.cp_decompose(from_numpy(np.zeros((3, 3))), 2, method="magic")
    big = torch.zeros((1, 1, 1)).expand(2 ** 16, 2 ** 15, 1)  # no storage
    with pytest.raises(ValueError, match="2\\^31"):
        tcp.cp_decompose(big, 2, method="rand")


def test_cprand_recovers_cp_tensor(jax_draws, monkeypatch):
    t = _cp_tensor((16, 14, 12), 3, seed=6)
    _, _, rec = _cp_both(monkeypatch, t, 3, iters=60, seed=0,
                         method="rand", num_samples=96)
    assert np.linalg.norm(rec - t) / np.linalg.norm(t) < 1e-3


def test_cprand_conventions_match_als(jax_draws, monkeypatch):
    t = _cp_tensor((10, 9, 8), 2, seed=7)
    w, factors, _ = _cp_both(monkeypatch, t, 2, iters=40, method="rand")
    w = to_numpy(w)
    assert w[0] >= w[1] > 0
    for f in factors:
        np.testing.assert_allclose(np.linalg.norm(to_numpy(f), axis=0), 1.0,
                                   rtol=1e-5)


@pytest.mark.parametrize("method", ["als", "rand"])
def test_cp_on_its_own_stream(method):
    t = _cp_tensor((16, 14, 12), 3, seed=6)
    w, factors = tcp.cp_decompose(from_numpy(t), 3, iters=60, method=method,
                                  num_samples=96)
    rec = to_numpy(tcp.cp_reconstruct(w, factors))
    assert np.linalg.norm(rec - t) / np.linalg.norm(t) < 1e-3


def test_exports_match_jax():
    rsvd_j = importlib.import_module("rsvd_kamaneh_raganato_terrana_tpu.rsvd")
    rsvd_t = importlib.import_module(
        "rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd")
    for name in ("tucker", "tucker_adaptive", "tucker_reconstruct",
                 "tt_decompose", "tt_reconstruct", "tt_ranks",
                 "tt_compression_ratio", "tt_adaptive", "cp_decompose",
                 "cp_reconstruct", "khatri_rao", "complete_tucker"):
        assert callable(getattr(rsvd_j, name))
        assert callable(getattr(rsvd_t, name))
