"""The port's SVD tail engines -- tournament Jacobi, power iteration, the
``svd()`` dispatch, the ``SVD`` class, ``polar`` and ``procrustes`` --
against the JAX package on the same numpy inputs, at f64
(tests/conftest.py turns x64 on) and at f32."""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.linalg import jacobi as jjac
from rsvd_kamaneh_raganato_terrana_tpu.linalg import power as jpow
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import jacobi as tjac
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import power as tpow

# the modules, not the functions of the same name the packages export
jsvd = importlib.import_module("rsvd_kamaneh_raganato_terrana_tpu.linalg.svd")
tsvd = importlib.import_module(
    "rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.svd")

# the port's entry points default to the card; these tests run on the CPU
from_numpy = functools.partial(convert.from_numpy, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _matrix(kind, dtype=np.float64):
    """The inputs of tests/test_jacobi.py:49-155 that do not use the block
    engine, at sizes that keep each JAX compile short."""
    rng = np.random.default_rng(0)
    if kind == "square":
        a = rng.standard_normal((24, 24))
    elif kind == "tall":
        a = rng.standard_normal((40, 16))
    elif kind == "wide":
        a = rng.standard_normal((16, 40))
    elif kind == "odd":
        a = rng.standard_normal((25, 25))
    elif kind == "rank_deficient":
        a = rng.standard_normal((30, 4)) @ rng.standard_normal((4, 20))
    elif kind == "diagonal":
        a = np.diag([5.0, 3.0, 1.0, 0.5])
    else:
        raise ValueError(kind)
    return a.astype(dtype)


def _same_up_to_signs(x_t, x_j, atol):
    """Columns equal up to sign."""
    signs = np.sign(np.sum(x_t * x_j, axis=0))
    signs[signs == 0] = 1.0
    np.testing.assert_allclose(x_t * signs, x_j, atol=atol)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8, 13, 16, 17])
def test_round_robin_schedule_is_bitwise_jax(n):
    got, want = tjac.round_robin_schedule(n), jjac.round_robin_schedule(n)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 16, 100, 4096, 10 ** 6])
def test_theoretical_iterations_is_jax(n):
    assert tpow.theoretical_iterations(n) == jpow.theoretical_iterations(n)
    assert tpow.DEFLATION_CUTOFF == jpow.DEFLATION_CUTOFF


def test_scalar_rotations_match_jax():
    x = np.array([1.0, 2.0, -3.0, 4.0, 0.5])
    y = np.array([0.5, 0.0, 1.5, -2.0, 1e-9])
    z = np.array([2.0, 1.0, 3.0, 4.0, 0.5])
    for got, want in zip(tjac.make_jacobi(*(torch.from_numpy(v)
                                            for v in (x, y, z))),
                         jjac.make_jacobi(x, y, z)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-15, atol=1e-15)
    a = np.array([3.0, 0.0, -1.0, 0.0])
    b = np.array([4.0, 2.0, 1.0, 0.0])
    for got, want in zip(tjac.givens_rotation(torch.from_numpy(a),
                                              torch.from_numpy(b)),
                         jjac.givens_rotation(a, b)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-15, atol=1e-15)


def test_convergence_measures_match_jax():
    w = _matrix("tall")
    for name in ("_max_normalized_offdiag", "_offdiag_mass_ratio"):
        got = float(getattr(tjac, name)(from_numpy(w)))
        want = float(getattr(jjac, name)(jnp.asarray(w)))
        assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("kind", ["square", "tall", "wide", "odd",
                                  "rank_deficient", "diagonal"])
@pytest.mark.parametrize("apply", ["scatter", "gemm"])
def test_jacobi_svd_matches_jax_f64(apply, kind):
    a = _matrix(kind)
    u_j, s_j, v_j = (np.asarray(x) for x in
                     jjac.jacobi_svd(jnp.asarray(a), apply=apply))
    u_t, s_t, v_t = (to_numpy(x) for x in
                     tjac.jacobi_svd(from_numpy(a), apply=apply))
    k = min(a.shape)
    assert u_t.shape == (a.shape[0], k) and v_t.shape == (a.shape[1], k)
    # the same rotations in the same order, summed in other orders
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-10 * s_j[0])
    nz = s_j > 1e-8 * s_j[0]            # null-space columns are free
    _same_up_to_signs(u_t[:, nz], u_j[:, nz], atol=1e-8)
    _same_up_to_signs(v_t[:, nz], v_j[:, nz], atol=1e-8)
    np.testing.assert_allclose((u_t * s_t) @ v_t.T, a, atol=1e-10)


@pytest.mark.parametrize("apply", ["scatter", "gemm"])
def test_jacobi_svd_matches_jax_f32(apply):
    a = _matrix("tall", np.float32)
    s_j = np.asarray(jjac.jacobi_svd(jnp.asarray(a), apply=apply)[1])
    u_t, s_t, v_t = (to_numpy(x) for x in
                     tjac.jacobi_svd(from_numpy(a), apply=apply))
    assert s_t.dtype == np.float32
    # f32 roundoff through ~7 sweeps of 15 rounds (tests/test_jacobi.py
    # holds the JAX engine to 2e-4 of numpy's f64 SVD)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-5, atol=1e-5 * s_j[0])
    np.testing.assert_allclose((u_t * s_t) @ v_t.T, a, atol=1e-5)


def test_jacobi_svd_leaves_its_input_alone():
    a = from_numpy(_matrix("odd"))
    before = a.clone()
    tjac.jacobi_svd(a, apply="scatter", precondition=False)
    assert torch.equal(a, before)


def test_power_triplet_matches_jax_on_the_same_x0():
    a = _matrix("tall")
    x0 = np.random.default_rng(1).standard_normal(16)
    got = [to_numpy(x) for x in tpow.power_triplet(from_numpy(a),
                                                    from_numpy(x0), 40)]
    want = [np.asarray(x) for x in jpow.power_triplet(jnp.asarray(a),
                                                      jnp.asarray(x0), 40)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def _jax_x0s(seed, k, n, dtype):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (k, n),
                                        dtype))


def _patch_x0s(monkeypatch, seed, k, n, dtype=np.float64):
    """The port's x0 draw replaced by JAX's, as
    tests/test_torch_serving.py patches Omega."""
    x0s = _jax_x0s(seed, k, n, dtype)
    monkeypatch.setattr(tpow, "gaussian",
                        lambda key, shape, dt: from_numpy(x0s).to(dt))


def _graded(m=30, n=20, seed=2):
    """Singular values 2^-i: every triplet converges well inside the
    iteration bound, so both packages reach the same fixed point."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (u * 2.0 ** -np.arange(n)) @ v.T


def test_power_svd_matches_jax_with_jax_x0s(monkeypatch):
    a = _graded()
    _patch_x0s(monkeypatch, 3, 6, 20)
    res_j = jpow.power_svd(jnp.asarray(a), k=6, seed=3)
    res_t = tpow.power_svd(from_numpy(a), k=6, seed=3)
    np.testing.assert_allclose(to_numpy(res_t.s), np.asarray(res_j.s),
                               rtol=1e-10)
    for got, want in ((res_t.u, res_j.u), (res_t.v, res_j.v)):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   atol=1e-8)
    assert int(res_t.effective_rank) == int(res_j.effective_rank) == 6


def test_power_svd_zeroes_triplets_below_the_cutoff():
    a = np.zeros((8, 5))
    a[0, 0] = 2.0
    res = tpow.power_svd(from_numpy(a), k=3, num_iters=20)
    assert res.s.tolist() == [2.0, 0.0, 0.0]
    assert int(res.effective_rank) == 1
    assert torch.all(res.u[:, 1:] == 0) and torch.all(res.v[:, 1:] == 0)


@pytest.mark.parametrize("method", ["jacobi", "parallel_jacobi", "power",
                                    "eigh", "xla", "auto"])
def test_svd_every_method_matches_jax_f64(method, monkeypatch):
    a = _graded()
    r = 5 if method == "power" else 0
    _patch_x0s(monkeypatch, 0, 5, 20)
    u_j, s_j, v_j = (np.asarray(x) for x in
                     jsvd.svd(jnp.asarray(a), method, r=r))
    u_t, s_t, v_t = (to_numpy(x) for x in
                     tsvd.svd(from_numpy(a), method, r=r))
    assert s_t.shape == s_j.shape
    # the Gram-eigh route loses eps * (s_1 / s_i)^2 on the small ones
    atol = 1e-9 if method == "eigh" else 1e-10
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=atol)
    np.testing.assert_allclose((u_t * s_t) @ v_t.T, (u_j * s_j) @ v_j.T,
                               atol=1e-9)


def test_svd_eigh_pallas_matches_jax_f32():
    """The K3 route: the tail Gram's eigh by eigh_small (plain version on
    the CPU, Pallas interpret mode in JAX)."""
    a = _graded().astype(np.float32).T              # wide, 20 x 30
    u_j, s_j, v_j = (np.asarray(x) for x in
                     jsvd.svd(jnp.asarray(a), "eigh_pallas"))
    u_t, s_t, v_t = (to_numpy(x) for x in
                     tsvd.svd(from_numpy(a), "eigh_pallas"))
    assert u_t.dtype == np.float32 and s_t.shape == (20,)
    # K3's bound on lambda = s^2 (1e-5 |lambda|max, tested in
    # tests/test_torch_eigh_sketch.py), twice over: the small s of this
    # graded spectrum are below f32 resolution of the Gram
    np.testing.assert_allclose(s_t ** 2, s_j ** 2, rtol=0,
                               atol=2e-5 * s_j[0] ** 2)
    # K3's rotations drift from orthogonal by ~1e-5 (in JAX too): the
    # reconstruction is held to JAX's own error, with room for roundoff
    err_t = np.linalg.norm((u_t * s_t) @ v_t.T - a)
    err_j = np.linalg.norm((u_j * s_j) @ v_j.T - a)
    assert err_t <= 2 * err_j + 1e-6 * np.linalg.norm(a)


def test_svd_auto_above_256_is_xla_and_drops_engine_kwargs():
    a = np.random.default_rng(4).standard_normal((300, 260))
    s_j = np.asarray(jsvd.svd(jnp.asarray(a), "auto", tol=1e-3)[1])
    u_t, s_t, v_t = (to_numpy(x) for x in
                     tsvd.svd(from_numpy(a), "auto", tol=1e-3))
    np.testing.assert_allclose(s_t, s_j, rtol=1e-12)
    np.testing.assert_allclose((u_t * s_t) @ v_t.T, a, atol=1e-10)


def test_svd_engine_kwargs_reach_jacobi():
    a = from_numpy(_matrix("square"))
    _, s_one, _ = tsvd.svd(a, "jacobi", max_sweeps=1)
    _, s_all, _ = tsvd.svd(a, "jacobi")
    assert not torch.allclose(s_one, s_all, rtol=1e-12, atol=0)


def test_svd_class_matches_jax():
    a = _graded()
    obj_j = jsvd.SVD(jnp.asarray(a), r=4, method="parallel_jacobi").compute()
    obj_t = tsvd.SVD(from_numpy(a), r=4, method="parallel_jacobi")
    assert obj_t.rank == 4 and obj_t.method is tsvd.SVDMethod.ParallelJacobi
    # getters compute on first use, as the reference's do
    np.testing.assert_allclose(to_numpy(obj_t.getS()),
                               np.asarray(obj_j.getS()), atol=1e-10)
    assert obj_t.getU().shape == (30, 4) and obj_t.getV().shape == (20, 4)
    np.testing.assert_allclose(to_numpy(obj_t.reconstruction()),
                               np.asarray(obj_j.reconstruction()), atol=1e-10)
    assert float(obj_t.reconstruction_error()) == pytest.approx(
        float(obj_j.reconstruction_error()), rel=1e-8)
    obj_t.setData(from_numpy(2.0 * a))
    np.testing.assert_allclose(to_numpy(obj_t.getS()),
                               2.0 * np.asarray(obj_j.getS()), atol=1e-10)


@pytest.mark.parametrize("side", ["right", "left"])
def test_polar_matches_jax(side):
    a = _matrix("tall")
    u_j, h_j = (np.asarray(x) for x in jsvd.polar(jnp.asarray(a), side))
    u_t, h_t = (to_numpy(x) for x in tsvd.polar(from_numpy(a), side))
    np.testing.assert_allclose(u_t, u_j, atol=1e-12)
    np.testing.assert_allclose(h_t, h_j, atol=1e-12)
    with pytest.raises(ValueError, match="side"):
        tsvd.polar(from_numpy(a), "up")


def test_procrustes_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((30, 6))
    q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    b = a @ q + 1e-3 * rng.standard_normal((30, 6))
    got = to_numpy(tsvd.procrustes(from_numpy(a), from_numpy(b)))
    want = np.asarray(jsvd.procrustes(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-12)
    np.testing.assert_allclose(got, q, atol=1e-3)


def test_complex_input_goes_to_xla_only():
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((6, 4))
                         + 1j * rng.standard_normal((6, 4)))
    u, s, v = tsvd.svd(a, "xla")
    assert torch.allclose((u * s) @ v.conj().T, a, atol=1e-12)
    with pytest.raises(TypeError, match="real-only"):
        tsvd.svd(a, "jacobi")


def test_block_engine_runs_where_jax_reaches_it():
    """The block engine, which raised before it was ported, now runs
    wherever the JAX package reaches it: apply='block', 'auto' above
    n = 512 and svd(..., 'parallel_jacobi') there."""
    a = _matrix("square")
    u, s, v = tjac.jacobi_svd(from_numpy(a), apply="block", block_size=8)
    np.testing.assert_allclose(s.numpy(), np.linalg.svd(a, compute_uv=False),
                               rtol=1e-12)
    np.testing.assert_allclose((u * s) @ v.T, a, atol=1e-12)
    zeros = torch.zeros((520, 513), dtype=torch.float64)
    for u, s, v in (tjac.jacobi_svd(zeros),          # 'auto' above 512
                    tsvd.svd(zeros, "parallel_jacobi")):
        assert u.shape == (520, 513) and v.shape == (513, 513)
        assert torch.all(s == 0) and torch.all(u == 0)
    assert tjac._auto_apply(512) == jjac._auto_apply(512) == "scatter"
    assert tjac._auto_apply(513) == jjac._auto_apply(513) == "block"


def test_svd_auto_above_512_does_not_reach_the_block_engine():
    """'auto' sends min(m, n) > 256 to 'xla' (JAX svd.py:122-124), so it
    runs at every size."""
    a = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (530, 520)))
    _, s, _ = tsvd.svd(a, "auto")
    np.testing.assert_allclose(s.numpy(),
                               np.linalg.svd(a.numpy(), compute_uv=False),
                               rtol=1e-12)


def _fro_orth(x):
    x = x.double()
    return float(torch.linalg.norm(
        x.T @ x - torch.eye(x.shape[1], dtype=x.dtype)))


@pytest.mark.parametrize("shape", [(24, 60), (60, 24)])
def test_gram_eigh_tail_restores_orthogonality(monkeypatch, shape):
    """The f32 'eigh' tail's default eigh is ``core/device.py::eigh``:
    fed eigenvectors 1e-4 from orthogonal (as cuSOLVER's f32 eigh gives
    on the card), it returns U and V orthogonal to f32 working
    precision, where the raw eigenvectors' error stays; singular values
    unchanged to 1e-6 relative."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import device

    a = from_numpy(np.random.default_rng(11).standard_normal(shape),
                   dtype=torch.float32)
    real = device.eigh_nan
    noise = 1e-4 * torch.from_numpy(np.random.default_rng(12).standard_normal(
        (min(shape), min(shape)))).to(torch.float32)

    def sloppy(g):
        lam, q = real(g)
        return lam, q + noise / np.sqrt(q.shape[0])

    monkeypatch.setattr(device, "eigh_nan", sloppy)
    _, s_raw, _ = tsvd._gram_eigh_svd(a, sloppy)
    u, s, v = tsvd.svd(a, "eigh")
    small = u if shape[0] <= shape[1] else v     # the eigenvector side
    g = a @ a.T if shape[0] <= shape[1] else a.T @ a
    assert _fro_orth(sloppy(g)[1]) > 2e-5
    assert _fro_orth(small) <= 2e-6
    np.testing.assert_allclose(to_numpy(s), to_numpy(s_raw), rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gram_eigh_tail_keeps_nan_contract(dtype):
    """A non-finite Gram gives NaN U and s (in f32 through the
    Newton-Schulz step) and V zeroed where s is not positive, as the JAX
    tail gives, and raises nothing."""
    x = np.random.default_rng(13).standard_normal((8, 20)).astype(dtype)
    x[2, 3] = np.nan
    u, s, v = tsvd.svd(from_numpy(x), "eigh")
    uj, sj, vj = (np.asarray(t) for t in jsvd.svd(jnp.asarray(x), "eigh"))
    assert bool(torch.isnan(u).all()) and bool(torch.isnan(s).all())
    assert np.isnan(uj).all() and np.isnan(sj).all()
    np.testing.assert_array_equal(to_numpy(v), vj)


# --- tests/test_linalg_utils.py:30-32, :48-50, :105-119 and
# tests/test_f32_engines.py:43-49, at the JAX cases' bars ---------------


def test_make_jacobi_zero_offdiag():
    c, s = (float(v) for v in tjac.make_jacobi(2.0, 0.0, 1.0))
    assert c == 1.0 and s == 0.0
    assert (c, s) == tuple(float(v) for v in jjac.make_jacobi(2.0, 0.0, 1.0))


def test_givens_zero():
    c, s, r = (float(v) for v in tjac.givens_rotation(0.0, 0.0))
    assert c == 1.0 and s == 0.0 and r == 0.0
    assert (c, s, r) == tuple(float(v)
                              for v in jjac.givens_rotation(0.0, 0.0))


def test_procrustes_aligns_rsvd_factors():
    """Two rSVD seeds' U of an exact rank-10 matrix, aligned by
    Procrustes (the port's own draws)."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import rsvd

    rng = np.random.default_rng(3)
    a = from_numpy(rng.standard_normal((80, 10))
                   @ rng.standard_normal((10, 60)))
    u1, _, _ = rsvd(a, k=10, seed=0, method="eigh")
    u2, _, _ = rsvd(a, k=10, seed=99, method="eigh")
    q = tsvd.procrustes(u2, u1)
    assert float(torch.linalg.norm(u2 @ q - u1)) < 1e-6


def test_equal_norm_columns_f32():
    """sign(0) regression: a constant matrix needs a 45-degree rotation.
    Both engines are deterministic: sigma also held to JAX's at 1e-6 of
    sigma_1 (f32)."""
    ones = np.ones((4, 4), np.float32)
    u, s, v = tjac.jacobi_svd(from_numpy(ones))
    assert s.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(s), [4.0, 0, 0, 0], atol=1e-5)
    np.testing.assert_allclose(
        to_numpy(s), np.asarray(jjac.jacobi_svd(jnp.asarray(ones))[1]),
        rtol=0, atol=1e-6 * 4.0)
    threes = np.full((8, 8), 3.0, np.float32)
    u, s, v = tsvd.svd(from_numpy(threes), "parallel_jacobi")
    np.testing.assert_allclose(float(s[0]), 24.0, rtol=1e-6)
    np.testing.assert_allclose(
        to_numpy(s),
        np.asarray(jsvd.svd(jnp.asarray(threes), "parallel_jacobi")[1]),
        rtol=0, atol=1e-6 * 24.0)
