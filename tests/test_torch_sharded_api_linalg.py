"""Row-sharded operands through the port's public API, part three: the
``linalg`` entry points (QR, SVD, Jacobi, power), the driver's stage-A
and reconstruction functions, serving and its health check and rescore,
Lanczos, DEIM, the kernel matrix and POD.

The two checks of tests/test_torch_sharded_api.py: (i) the port on
P = 4 gloo ranks, the operand a row-sharded DTensor and its own draws,
against the port's single-rank call on the same input: f64 and
deterministic at rtol 1e-9, the iterative ones (power, Lanczos) at 1e-8,
indices equal, with no all-gather of a block as large as the rank's
block of A (``no_whole_gather``); the QR methods that gather their panel
(K1's, K2's and Householder's, a standing difference) and a row-sharded
y of the kernel matrix (each row of K needs every point) gather it once;
(ii) the port's single-rank call with the JAX package's draws patched in
against the JAX function on a row-sharded array of conftest's 8-device
mesh, at ``RTOL`` = 1e-10 (the f32 Pallas eigh of JAX's 'eigh_pallas'
at its 1e-4 bar, as tests/test_torch_sharded_api.py holds it).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdriver

from _torch_sharded import (  # noqa: F401 -- fixtures by name
    ITER_RTOL,
    RTOL,
    _jax,
    _jax_omega,
    _one_torch_thread,
    _port,
    _rel,
    from_numpy,
    no_whole_gather,
    ranks,
    shard_rows8,
    sharded,
    single,
    whole,
)

DET_RTOL = 1e-9            # (i): f64, deterministic
PALLAS_TOL = 1e-4          # JAX's f32 Pallas eigh, relative to s_1


def _decaying(seed, m, n, ratio=0.8, floor=1e-3):
    """U diag(ratio^i + floor) V^T from numpy."""
    g = np.random.default_rng(seed)
    r = min(m, n)
    u, _ = np.linalg.qr(g.standard_normal((m, r)))
    v, _ = np.linalg.qr(g.standard_normal((n, r)))
    return (u * (ratio ** np.arange(r) + floor)) @ v.T


def _recon(u, s, v):
    return (np.asarray(u) * np.asarray(s)) @ np.asarray(v).T


def _close(got, want, rtol=DET_RTOL):
    np.testing.assert_allclose(whole(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _jax_x0(monkeypatch):
    """JAX's power-method start vectors in the port's power engine."""
    def draws(key, shape, dtype):
        return from_numpy(np.asarray(jax.random.normal(
            jax.random.PRNGKey(0), shape, jnp.float64)))

    monkeypatch.setattr(_port("linalg.power"), "gaussian", draws)


# --- linalg/qr.py -----------------------------------------------------------

_GATHERING = ("cholqr1_fused", "polar_fused", "householder")


@pytest.mark.parametrize("method", ["robust", "robust1", "cholqr2",
                                    "cholqr1_fused", "polar_fused",
                                    "householder"])
def test_qr_reduced_sharded(mesh8, ranks, method):
    """Q row-sharded, R replicated: (i) 1e-9; the CholeskyQR methods
    all-reduce their Grams and gather nothing, K1's, K2's and
    Householder's gather the panel once; (ii) JAX on mesh8."""
    a = _decaying(1, 96, 12, ratio=0.7)
    fn = "linalg.qr:qr_reduced"
    (q, r), tally = sharded(ranks, fn, a, method=method)
    assert q["placements"] == ["S(0)"]
    if method in _GATHERING:
        assert tally["all_gather"]["calls"] == 1
        assert tally["all_gather"]["bytes"] == a.nbytes // 4
    else:
        assert set(tally) == {"all_reduce"}
    want = single(fn, a, method=method)
    _close(q, want[0])
    _close(r, want[1])
    qj, rj = _jax("linalg.qr").qr_reduced(shard_rows8(mesh8, a), method)
    assert _rel(want[0], qj) <= RTOL and _rel(want[1], rj) <= RTOL


@pytest.mark.parametrize("name", ["cholesky_qr", "cholesky_qr2",
                                  "cholesky_qr3", "orthonormal_basis"])
def test_cholesky_qr_family_sharded(mesh8, ranks, name):
    """By rows: (i) 1e-9, only all-reduces; (ii) JAX on mesh8."""
    a = _decaying(2, 96, 10, ratio=0.5)
    fn = "linalg.qr:" + name
    out, tally = sharded(ranks, fn, a)
    assert set(tally) == {"all_reduce"}
    want = single(fn, a)
    got_j = getattr(_jax("linalg.qr"), name)(shard_rows8(mesh8, a))
    if name == "orthonormal_basis":
        out, want, got_j = [out], [want], [got_j]
    assert out[0]["placements"] == ["S(0)"]
    for got, ref, ref_j in zip(out, want, got_j):
        _close(got, ref)
        assert _rel(ref, ref_j) <= RTOL


# --- linalg/svd.py, jacobi.py, power.py ---------------------------------------


@pytest.mark.parametrize("method", ["eigh", "eigh_pallas", "jacobi",
                                    "power", "xla"])
def test_svd_sharded(mesh8, ranks, monkeypatch, method):
    """A tall row-sharded A: the Gram engines on its all-reduced Gram
    (K3 on the card for 'eigh_pallas'), the Jacobi engine on R of its
    row-split QR as on one card; 'power' and 'xla' factor that R where
    the single call factors A (by design: held at 1e-8).  (i) U
    row-sharded; (ii) JAX on mesh8 (JAX's start vectors for 'power')."""
    a = _decaying(3, 96, 16, ratio=0.6)
    kw = dict(method=method, r=6)
    fn = "linalg.svd:svd"
    out, tally = sharded(ranks, fn, a, **kw)
    no_whole_gather(tally, a)
    assert out[0]["placements"] == ["S(0)"]
    want = single(fn, a, **kw)
    tol = ITER_RTOL if method in ("power", "xla") else DET_RTOL
    np.testing.assert_allclose(out[1], want[1], rtol=tol)
    assert _rel(_recon(whole(out[0]), out[1], out[2]),
                _recon(*want)) <= tol
    _jax_x0(monkeypatch)
    uj, sj, vj = _jax("linalg.svd").svd(shard_rows8(mesh8, a), method, 6)
    got = single(fn, a, **kw)
    bar = PALLAS_TOL if method == "eigh_pallas" else RTOL
    assert np.abs(got[1] - np.asarray(sj)).max() / sj[0] <= bar
    assert _rel(_recon(*got), _recon(uj, sj, vj)) <= bar


@pytest.mark.parametrize("apply", ["gemm", "scatter"])
def test_jacobi_svd_sharded(mesh8, ranks, apply):
    """The preconditioning QR by rows, the sweeps on R replicated, U
    row-sharded: (i) 1e-9; (ii) JAX on mesh8."""
    a = _decaying(4, 96, 12, ratio=0.7)
    fn = "linalg.jacobi:jacobi_svd"
    out, tally = sharded(ranks, fn, a, apply=apply)
    assert set(tally) == {"all_reduce"}
    assert out[0]["placements"] == ["S(0)"]
    want = single(fn, a, apply=apply)
    np.testing.assert_allclose(out[1], want[1], rtol=DET_RTOL)
    assert _rel(_recon(whole(out[0]), out[1], out[2]),
                _recon(*want)) <= DET_RTOL
    uj, sj, vj = _jax("linalg.jacobi").jacobi_svd(shard_rows8(mesh8, a),
                                                  apply=apply)
    assert _rel(want[1], sj) <= RTOL
    assert _rel(_recon(*want), _recon(uj, sj, vj)) <= RTOL


def test_power_svd_sharded(mesh8, ranks, monkeypatch):
    """Each power step's A v local, A^T (A v) and ||A v|| all-reduced,
    the deflation by blocks: (i) 1e-8 (iterative), U row-sharded, only
    all-reduces and the norms' partials; (ii) JAX's start vectors."""
    a = _decaying(5, 96, 24, ratio=0.5)
    kw = dict(k=4, num_iters=60)
    fn = "linalg.power:power_svd"
    out, tally = sharded(ranks, fn, a, **kw)
    no_whole_gather(tally, a)
    assert out[0]["placements"] == ["S(0)"]
    want = single(fn, a, **kw)
    assert out[3] == want[3] == 4
    np.testing.assert_allclose(out[1], want[1], rtol=ITER_RTOL)
    assert _rel(_recon(whole(out[0]), out[1], out[2]),
                _recon(*want[:3])) <= ITER_RTOL
    _jax_x0(monkeypatch)
    res_j = _jax("linalg.power").power_svd(shard_rows8(mesh8, a), **kw)
    got = single(fn, a, **kw)
    assert _rel(got[1], res_j.s) <= RTOL
    assert _rel(_recon(*got[:3]), _recon(res_j.u, res_j.s, res_j.v)) \
        <= RTOL


def test_power_triplet_sharded(mesh8, ranks):
    """x0 whole on every rank: (i) sigma and v to 1e-8, u row-sharded;
    (ii) JAX on mesh8."""
    a = _decaying(6, 96, 20, ratio=0.5)
    x0 = np.random.default_rng(7).standard_normal(20)
    fn = "linalg.power:power_triplet"
    out, tally = sharded(ranks, fn, a, x0, layouts=("rows", None),
                         num_iters=40)
    assert out[1]["placements"] == ["S(0)"]
    want = single(fn, a, x0, num_iters=40)
    np.testing.assert_allclose(out[0], want[0], rtol=ITER_RTOL)
    for got, ref in zip(out[1:], want[1:]):
        _close(got, ref, ITER_RTOL)
    sj, uj, vj = _jax("linalg.power").power_triplet(
        shard_rows8(mesh8, a), jnp.asarray(x0), 40)
    assert _rel(want[0], sj) <= RTOL
    assert _rel(want[1], uj) <= RTOL and _rel(want[2], vj) <= RTOL


# --- rsvd/driver.py -------------------------------------------------------------


@pytest.mark.parametrize("qr_method", ["robust", "cholqr1_fused"])
def test_subspace_iteration_sharded(mesh8, ranks, qr_method):
    """Omega whole, Q row-sharded: (i) 1e-9 (K1 factors 2q + 1 panels:
    the q + 1 m x l ones gathered, the n x l ones of Z = A^T Q
    replicated already); (ii) JAX on mesh8."""
    a = _decaying(8, 96, 64, ratio=0.85)
    omega = np.random.default_rng(9).standard_normal((64, 8))
    kw = dict(q=2, qr_method=qr_method)
    fn = "rsvd.driver:subspace_iteration"
    out, tally = sharded(ranks, fn, a, omega, layouts=("rows", None), **kw)
    no_whole_gather(tally, a)
    if qr_method == "cholqr1_fused":
        assert tally["all_gather"]["calls"] == 2 + 1
    assert out["placements"] == ["S(0)"]
    want = single(fn, a, omega, **kw)
    _close(out, want)
    qj = _jax("rsvd.driver").subspace_iteration(
        shard_rows8(mesh8, a), jnp.asarray(omega), **kw)
    assert _rel(want, qj) <= RTOL


def test_power_refine_and_reconstructions_sharded(mesh8, ranks):
    """power_refine of a row-sharded basis, reconstruct of a row-sharded
    U (row-sharded A_k) and reconstruction_error (the squares summed by
    rank): (i) 1e-9, only all-reduces and the norm's partials; (ii) JAX
    on mesh8."""
    a = _decaying(10, 96, 48, ratio=0.8)
    q0 = np.linalg.qr(a @ np.random.default_rng(11).standard_normal(
        (48, 6)))[0]
    u, s, vt = np.linalg.svd(a, full_matrices=False)
    u, s, v = u[:, :5], s[:5], vt[:5].T
    jd = _jax("rsvd.driver")
    out, tally = sharded(ranks, "rsvd.driver:power_refine", a, q0,
                         layouts=("rows", "rows"), q=2)
    no_whole_gather(tally, a)
    want = single("rsvd.driver:power_refine", a, q0, q=2)
    _close(out, want)
    assert _rel(want, jd.power_refine(shard_rows8(mesh8, a),
                                      shard_rows8(mesh8, q0), 2)) <= RTOL
    out, tally = sharded(ranks, "rsvd.driver:reconstruct", u, s, v)
    assert tally == {} and out["placements"] == ["S(0)"]
    want = single("rsvd.driver:reconstruct", u, s, v)
    _close(out, want)
    assert _rel(want, jd.reconstruct(shard_rows8(mesh8, u), s, v)) <= RTOL
    for lay in ("rows", None):
        out, tally = sharded(ranks, "rsvd.driver:reconstruction_error", a,
                             u, s, v, layouts=("rows", lay))
        assert set(tally) == {"all_gather"}          # the norms' partials
        want = single("rsvd.driver:reconstruction_error", a, u, s, v)
        np.testing.assert_allclose(out, want, rtol=DET_RTOL)
    np.testing.assert_allclose(want, float(jd.reconstruction_error(
        shard_rows8(mesh8, a), shard_rows8(mesh8, u), s, v)), rtol=RTOL)


# --- rsvd/serving.py, diagnostics.factor_health, utv.utv_rescore --------------


@pytest.mark.parametrize("storage", ["int8", "default"])
def test_rsvd_serving_sharded(mesh8, ranks, monkeypatch, storage):
    """Each rank quantizes its rows ('int8'), the driver's split products
    run the serving stack, U row-sharded, ``factor_health`` read by rows:
    (i) 1e-9 (the integer sums exact), health equal; (ii) JAX's Omega,
    JAX on mesh8."""
    a = _decaying(12, 96, 64, ratio=0.7, floor=1e-2)
    kw = dict(k=5, p=6, seed=3, storage=storage)
    fn = "rsvd.serving:rsvd_serving"
    out, tally = sharded(ranks, fn, a, **kw)
    no_whole_gather(tally, a)
    assert out[0]["placements"] == ["S(0)"]
    want = single(fn, a, **kw)
    np.testing.assert_allclose(out[1], want[1], rtol=DET_RTOL)
    assert _rel(_recon(whole(out[0]), out[1], out[2]),
                _recon(*want[:3])) <= DET_RTOL
    assert out[3]["ok"] and want[3]["ok"]
    for key in ("u_col_err", "v_orth_err", "s_min"):
        np.testing.assert_allclose(out[3][key], want[3][key],
                                   rtol=1e-6, atol=1e-12)
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    uj, sj, vj, hj = _jax("rsvd.serving").rsvd_serving(
        shard_rows8(mesh8, a), **kw)
    got = single(fn, a, **kw)
    assert _rel(got[1], sj) <= RTOL
    assert _rel(_recon(*got[:3]), _recon(uj, sj, vj)) <= RTOL
    assert got[3]["ok"] == hj["ok"]


def _utv_factors():
    """A UTV-finish style triple: unit-column U, weights, orthonormal V."""
    g = np.random.default_rng(13)
    u = g.standard_normal((96, 6))
    u /= np.linalg.norm(u, axis=0)
    v = np.linalg.qr(g.standard_normal((40, 6)))[0]
    return u, np.array([5.0, 3.0, 2.0, 1.5, 0.7, 0.2]), v


def test_factor_health_sharded(mesh8, ranks):
    """U row-sharded: its finite flag and column norms from two small
    all-reduces, no gather: (i) the same health; a NaN on one rank trips
    every rank; (ii) JAX on mesh8."""
    u, s, v = _utv_factors()
    fn = "rsvd.diagnostics:factor_health"
    out, tally = sharded(ranks, fn, u, s, v)
    assert set(tally) == {"all_reduce"}
    assert tally["all_reduce"]["calls"] == 2
    want = single(fn, u, s, v)
    assert out.keys() == want.keys() and out["ok"] == want["ok"]
    for key in ("u_col_err", "v_orth_err", "s_ascending_violation",
                "s_min"):                  # the errors at roundoff level
        np.testing.assert_allclose(out[key], want[key], rtol=DET_RTOL,
                                   atol=1e-14)
    bad = u.copy()
    bad[70, 2] = np.nan                              # rank 2's rows
    out_bad, _ = sharded(ranks, fn, bad, s, v)
    assert not out_bad["finite"] and not out_bad["ok"]
    hj = _jax("rsvd.diagnostics").factor_health(shard_rows8(mesh8, u), s, v)
    assert hj["ok"] == want["ok"]
    for key in ("u_col_err", "v_orth_err", "s_min"):
        np.testing.assert_allclose(want[key], hj[key], rtol=RTOL,
                                   atol=1e-14)


def test_utv_rescore_sharded(mesh8, ranks):
    """G from the all-reduced local Grams, eigh replicated, U* row-sharded:
    (i) 1e-9; (ii) JAX on mesh8."""
    u, s, v = _utv_factors()
    fn = "rsvd.utv:utv_rescore"
    out, tally = sharded(ranks, fn, u, s, v)
    assert set(tally) == {"all_reduce"}
    assert out[0]["placements"] == ["S(0)"]
    want = single(fn, u, s, v)
    np.testing.assert_allclose(out[1], want[1], rtol=DET_RTOL)
    assert _rel(_recon(whole(out[0]), out[1], out[2]),
                _recon(*want)) <= DET_RTOL
    uj, sj, vj = _jax("rsvd.utv").utv_rescore(shard_rows8(mesh8, u), s, v)
    assert _rel(want[1], sj) <= RTOL
    assert _rel(_recon(*want), _recon(uj, sj, vj)) <= RTOL


# --- rsvd/slq.py ----------------------------------------------------------------


@pytest.mark.parametrize("v0_layout", ["rows", None])
def test_lanczos_tridiag_sharded(mesh8, ranks, v0_layout):
    """The Lanczos vectors row-split, one all-gather of the n-vector a
    step (not a block of A), the dot products all-reduced, the norms'
    partials gathered (P values each): (i) 1e-8 (iterative); (ii) JAX on
    mesh8."""
    g = np.random.default_rng(14)
    q = np.linalg.qr(g.standard_normal((96, 96)))[0]
    a = (q * np.linspace(3.0, 0.1, 96)) @ q.T
    v0 = g.standard_normal(96)
    steps = 8
    fn = "rsvd.slq:lanczos_tridiag"
    out, tally = sharded(ranks, fn, a, v0, layouts=("rows", v0_layout),
                         steps=steps)
    no_whole_gather(tally, a)
    assert tally["all_gather"]["calls"] == steps + (steps + 1)
    want = single(fn, a, v0, steps=steps)
    for got, ref in zip(out, want):
        np.testing.assert_allclose(got, ref, rtol=ITER_RTOL)
    v0_j = jax.device_put(jnp.asarray(v0), NamedSharding(
        mesh8, PartitionSpec("rows")))
    alj, bej = _jax("rsvd.slq").lanczos_tridiag(shard_rows8(mesh8, a), v0_j,
                                                steps)
    assert _rel(want[0], alj) <= RTOL and _rel(want[1], bej) <= RTOL


# --- rsvd/deim.py ---------------------------------------------------------------


@pytest.mark.parametrize("method", ["qdeim", "deim"])
def test_deim_sharded(mesh8, ranks, method):
    """The basis read by its rows, never gathered: each pivot a global
    argmax (ties to the lower index), the picked rows from their ranks;
    (i) indices equal, the projector row-sharded and the condition to
    1e-9, only all-reduces; (ii) JAX on mesh8."""
    g = np.random.default_rng(15)
    u = np.linalg.qr(g.standard_normal((96, 7)) * np.linspace(
        1.0, 3.0, 96)[:, None])[0]
    jd = _jax("rsvd.deim")
    out, tally = sharded(ranks, "rsvd.deim:deim_indices", u, method=method)
    assert set(tally) == {"all_reduce"}
    idx = single("rsvd.deim:deim_indices", u, method=method)
    np.testing.assert_array_equal(out, idx)
    np.testing.assert_array_equal(idx, np.asarray(jd.deim_indices(
        shard_rows8(mesh8, u), method)))
    for name in ("deim_projector", "deim_condition"):
        out, tally = sharded(ranks, "rsvd.deim:" + name, u, idx)
        assert set(tally) == {"all_reduce"}
        want = single("rsvd.deim:" + name, u, idx)
        _close(out, want)
        assert _rel(want, getattr(jd, name)(shard_rows8(mesh8, u),
                                            jnp.asarray(idx))) <= RTOL
    assert out >= 1.0


def test_deim_tie_breaks_to_the_lower_index(ranks):
    """Equal maxima on two ranks: the lower global index wins, as the
    single call's argmax takes the first."""
    u = np.zeros((96, 2))
    u[[30, 75], 0] = 1.0 / np.sqrt(2.0)              # ranks 1 and 3
    u[[10, 60], 1] = 1.0 / np.sqrt(2.0)              # ranks 0 and 2
    for method in ("qdeim", "deim"):
        out, _ = sharded(ranks, "rsvd.deim:deim_indices", u, method=method)
        want = single("rsvd.deim:deim_indices", u, method=method)
        np.testing.assert_array_equal(out, want)
        # qdeim: rows 10, 30, 60 and 75 tie on their norms; deim: 30 and
        # 75 on column 0
        assert out[0] == (10 if method == "qdeim" else 30)


# --- apps/kpca.py: kernel_matrix ------------------------------------------------


@pytest.mark.parametrize("kernel, y_layout", [("rbf", None),
                                              ("poly", "rows")])
def test_kernel_matrix_sharded(mesh8, ranks, kernel, y_layout):
    """K's rows those of the row-sharded x, against y whole (a row-sharded
    y gathered once, m x d): (i) 1e-9; (ii) JAX on mesh8."""
    g = np.random.default_rng(16)
    x, y = g.standard_normal((96, 5)), g.standard_normal((32, 5))
    kw = dict(kernel=kernel, gamma=0.3)
    fn = "apps.kpca:kernel_matrix"
    out, tally = sharded(ranks, fn, x, y, layouts=("rows", y_layout), **kw)
    assert out["placements"] == ["S(0)"]
    if y_layout is None:
        assert tally == {}
    else:
        assert tally["all_gather"]["calls"] == 1
    want = single(fn, x, y, **kw)
    _close(out, want)
    kj = _jax("apps.kpca").kernel_matrix(shard_rows8(mesh8, x),
                                         jnp.asarray(y), **kw)
    assert _rel(want, kj) <= RTOL


# --- apps/pod.py ----------------------------------------------------------------


def _snapshots():
    g = np.random.default_rng(17)
    modes = np.linalg.qr(g.standard_normal((96, 6)))[0]
    coeff = g.standard_normal((6, 20)) * (0.5 ** np.arange(6))[:, None]
    return modes @ coeff + 1e-6 * g.standard_normal((96, 20))


@pytest.mark.parametrize("fn, kw", [
    ("perform_svd", dict(svd_type=1)),
    ("perform_svd", dict(svd_type=4, rank=4)),
    ("standard_pod", dict(rank=4)),
    ("naive_pod", dict(rank=4)),
])
def test_pod_sharded(mesh8, ranks, monkeypatch, fn, kw):
    """Snapshots sharded by nodes: the standard POD's S^T S all-reduced,
    its SVD replicated, W = S V / sigma by rows; the naive POD and
    perform_svd through the sharded svd and rsvd.  (i) modes row-sharded
    to 1e-9; (ii) JAX's Omega, JAX on mesh8."""
    snaps = _snapshots()
    name = "apps.pod:" + fn
    out, tally = sharded(ranks, name, snaps, **kw)
    no_whole_gather(tally, snaps)
    want = single(name, snaps, **kw)
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    got = single(name, snaps, **kw)
    got_j = getattr(_jax("apps.pod"), fn)(shard_rows8(mesh8, snaps), **kw)
    if fn == "perform_svd":
        u, s, v = out
        assert u["placements"] == ["S(0)"]
        np.testing.assert_allclose(s, want[1], rtol=DET_RTOL)
        assert _rel(_recon(whole(u), s, v), _recon(*want)) <= DET_RTOL
        assert _rel(got[1], got_j[1]) <= RTOL
        assert _rel(_recon(*got), _recon(*got_j)) <= RTOL
        return
    assert out["modes"]["placements"] == ["S(0)"]
    assert out["rank"] == want.rank
    np.testing.assert_allclose(out["sigma"], want.sigma.numpy(),
                               rtol=DET_RTOL)
    w = want.modes.numpy()
    sign = np.sign(np.sum(whole(out["modes"]) * w, axis=0))
    _close(whole(out["modes"]) * sign, w)
    assert got.rank == got_j.rank
    assert _rel(got.sigma.numpy(), got_j.sigma) <= RTOL
    wj = np.asarray(got_j.modes)
    sign = np.sign(np.sum(got.modes.numpy() * wj, axis=0))
    assert _rel(got.modes.numpy() * sign, wj) <= RTOL
