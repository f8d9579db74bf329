"""Row-sharded operands through the port's public API beyond ``rsvd``,
part one: the driver variants, the diagnostics, block Krylov, ID/CUR and
leverage sampling, the symmetric eigensolvers and least squares (the
JAX package's functions take a row-sharded ``jax.Array`` and XLA
inserts the collectives; docs/USAGE.md's "Row-sharded inputs work").

Each case holds two things (tests/_torch_sharded.py):

(i) the port's call on P = 4 gloo ranks, the operand a row-sharded
    DTensor and its own draws, against the port's single-rank call on
    the same input: f64 and deterministic at rtol 1e-9, the iterative
    solvers (PCG, LSQR, the sparse sketch's sums) at 1e-8, indices and
    pivots equal; and the collectives tally, where no all-gather hands
    in a block as large as the rank's block of A (``no_whole_gather``);
(ii) the port's single-rank call with the JAX package's draws patched in
    against the JAX function on a row-sharded array of conftest's
    8-device mesh, at ``RTOL`` = 1e-10 (spans by the sines of their
    principal angles, 1e-8).

A row count that does not divide the ranks raises, as ``shard_rows``
does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.core.rng import (
    key_from_seed as jax_key_from_seed,
    sketch_matrix as jax_sketch_matrix,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdriver

from _torch_sharded import (  # noqa: F401 -- fixtures by name
    ITER_RTOL,
    RTOL,
    _jax,
    _jax_omega,
    _one_torch_thread,
    _port,
    _queue,
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


def _decaying(seed, m, n, ratio=0.8, floor=1e-3):
    """U diag(ratio^i + floor) V^T from numpy."""
    g = np.random.default_rng(seed)
    r = min(m, n)
    u, _ = np.linalg.qr(g.standard_normal((m, r)))
    v, _ = np.linalg.qr(g.standard_normal((n, r)))
    return (u * (ratio ** np.arange(r) + floor)) @ v.T


def _sym(n, seed, decay=0.7):
    """A symmetric indefinite matrix, |eigenvalues| decaying."""
    g = np.random.default_rng(seed)
    q, _ = np.linalg.qr(g.standard_normal((n, n)))
    lam = decay ** np.arange(n) * np.where(np.arange(n) % 3 == 1, -1, 1)
    return (q * lam) @ q.T


def _spd(n, seed, decay=0.6):
    g = np.random.default_rng(seed)
    q, _ = np.linalg.qr(g.standard_normal((n, n)))
    return (q * (decay ** np.arange(n) + 1e-3)) @ q.T


def _sines(x, y):
    qx, _ = np.linalg.qr(x)
    qy, _ = np.linalg.qr(y)
    return np.linalg.svd(qy - qx @ (qx.T @ qy), compute_uv=False)


def _recon(u, s, v):
    return (np.asarray(u) * np.asarray(s)) @ np.asarray(v).T


# --- rsvd/driver.py: rsvd_adaptive, rsvd_onepass, rsvd_warm -----------------


def test_rsvd_adaptive_sharded(mesh8, ranks, monkeypatch):
    """(i) the same rank, blocks and rounds, s and U V^T to 1e-9; U
    row-sharded; (ii) against JAX on mesh8, rank and stats equal."""
    a = _decaying(8, 96, 56)
    kw = dict(tol=1e-2, k0=4, seed=3, return_stats=True)
    fn = "rsvd.driver:rsvd_adaptive"
    out, tally = sharded(ranks, fn, a, **kw)
    no_whole_gather(tally, a)
    assert out[0]["placements"] == ["S(0)"]
    want = single(fn, a, **kw)
    assert out[3] == want[3] and out[4] == want[4]
    assert out[4]["rounds"] >= 1                     # the basis grew
    np.testing.assert_allclose(out[1], want[1], rtol=DET_RTOL)
    assert _rel(_recon(whole(out[0]), out[1], out[2]),
                _recon(*want[:3])) <= DET_RTOL
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    ju, js, jv, jk, jstats = _jax("rsvd.driver").rsvd_adaptive(
        shard_rows8(mesh8, a), **kw)
    got = single(fn, a, **kw)
    assert got[3] == jk and got[4] == jstats
    assert _rel(got[1], js) <= RTOL
    assert _rel(_recon(*got[:3]), _recon(ju, js, jv)) <= RTOL


@pytest.mark.parametrize("precision", ["highest", "int8"])
def test_rsvd_onepass_sharded(mesh8, ranks, monkeypatch, precision):
    """Psi^T A all-reduced, Omega and Psi drawn whole: (i) 1e-9 (int8:
    the rows quantized alike, the integer sums exact); (ii) JAX's Omega
    and Psi."""
    a = _decaying(4, 64, 48, floor=1e-2)
    kw = dict(k=5, p=6, seed=9, precision=precision)
    fn = "rsvd.driver:rsvd_onepass"
    out, tally = sharded(ranks, fn, a, **kw)
    no_whole_gather(tally, a)
    assert out[0]["placements"] == ["S(0)"]
    want = single(fn, a, **kw)
    np.testing.assert_allclose(out[1], want[1], rtol=DET_RTOL)
    assert _rel(_recon(whole(out[0]), out[1], out[2]),
                _recon(*want)) <= DET_RTOL
    k_om, k_psi = jax.random.split(jax.random.PRNGKey(9))
    _queue(monkeypatch, tdriver, "gaussian", [
        jax.random.normal(k_om, (48, 11), jnp.float64),
        jax.random.normal(k_psi, (64, 23), jnp.float64)])
    ju, js, jv = _jax("rsvd.driver").rsvd_onepass(shard_rows8(mesh8, a),
                                                  **kw)
    got = single(fn, a, **kw)
    assert _rel(got[1], js) <= RTOL
    assert _rel(_recon(*got), _recon(ju, js, jv)) <= RTOL


@pytest.mark.parametrize("k", [0, 6])
def test_rsvd_warm_sharded(mesh8, ranks, k):
    """A and the previous basis both row-sharded: (i) 1e-9; (ii) JAX with
    both sharded on mesh8 (no draws)."""
    a = _decaying(1, 64, 40)
    q_prev = np.linalg.qr(a @ np.random.default_rng(3).standard_normal(
        (40, 10)))[0]
    fn = "rsvd.driver:rsvd_warm"
    out, tally = sharded(ranks, fn, a, q_prev, layouts=("rows", "rows"),
                         k=k)
    no_whole_gather(tally, a)
    assert out[0]["placements"] == ["S(0)"]
    want = single(fn, a, q_prev, k=k)
    np.testing.assert_allclose(out[1], want[1], rtol=DET_RTOL)
    assert _rel(_recon(whole(out[0]), out[1], out[2]),
                _recon(*want)) <= DET_RTOL
    ju, js, jv = _jax("rsvd.driver").rsvd_warm(
        shard_rows8(mesh8, a), shard_rows8(mesh8, q_prev), k=k)
    assert _rel(want[1], js) <= RTOL
    assert _rel(_recon(*want), _recon(ju, js, jv)) <= RTOL


# --- rsvd/diagnostics.py ------------------------------------------------------


def _jax_probes(seed, shape, dtype, device):
    return from_numpy(np.asarray(jax.random.normal(
        _jax("rsvd.diagnostics")._probe_key(seed), shape, jnp.float64)))


@pytest.mark.parametrize("name", [
    "range_error_estimate", "factorization_error_estimate",
    "spectral_norm_estimate", "stable_rank_estimate"])
def test_diagnostics_sharded(mesh8, ranks, monkeypatch, name):
    """Probes drawn whole, the norms completed over the rows: (i) 1e-9,
    only small all-reduces and the power iteration's per-rank norms;
    (ii) JAX's probes, JAX on mesh8."""
    g = np.random.default_rng(0)
    a = g.standard_normal((96, 10)) @ g.standard_normal((10, 72)) \
        + 1e-3 * g.standard_normal((96, 72))
    q = np.linalg.qr(a @ g.standard_normal((72, 12)))[0]
    u, s, vt = np.linalg.svd(a, full_matrices=False)
    args = {"range_error_estimate": ((a, q), ("rows", "rows")),
            "factorization_error_estimate": (
                (a, u[:, :8], s[:8], vt[:8].T), ("rows", "rows")),
            "spectral_norm_estimate": ((a,), ("rows",)),
            "stable_rank_estimate": ((a,), ("rows",))}[name]
    kw = dict(seed=7, num_probes=6) if "error" in name else \
        dict(seed=7, num_iters=12)
    fn = "rsvd.diagnostics:" + name
    out, tally = sharded(ranks, fn, *args[0], layouts=args[1], **kw)
    no_whole_gather(tally, a)
    assert set(tally) <= {"all_reduce", "all_gather"}
    np.testing.assert_allclose(out, single(fn, *args[0], **kw),
                               rtol=DET_RTOL)
    monkeypatch.setattr(_port("rsvd.diagnostics"), "_probes", _jax_probes)
    want = getattr(_jax("rsvd.diagnostics"), name)(
        *(shard_rows8(mesh8, x) if lay == "rows" else jnp.asarray(x)
          for x, lay in zip(args[0], args[1] + (None,) * 2)), **kw)
    np.testing.assert_allclose(single(fn, *args[0], **kw), float(want),
                               rtol=RTOL)


# --- rsvd/krylov.py -----------------------------------------------------------


@pytest.mark.parametrize("qr_method, method", [
    ("robust", "eigh"), ("cholqr1_fused", "eigh_pallas"),
    ("polar_fused", "jacobi")])
def test_rsvd_krylov_sharded(mesh8, ranks, monkeypatch, qr_method, method):
    """Blocks row-split (K1's and K2's routes gather the l-wide block, the
    only gathers), the Gram-Schmidt coefficients and the projection
    all-reduced, the tail replicated: (i) 1e-9, U row-sharded; (ii) JAX's
    Omega, JAX on mesh8."""
    a = _decaying(2, 96, 64, ratio=0.9)
    kw = dict(k=6, p=4, q=2, qr_method=qr_method, method=method)
    fn = "rsvd.krylov:rsvd_krylov"
    out, tally = sharded(ranks, fn, a, **kw)
    no_whole_gather(tally, a)
    assert ("all_gather" in tally) == (qr_method != "robust")
    assert out[0]["placements"] == ["S(0)"]
    want = single(fn, a, **kw)
    np.testing.assert_allclose(out[1], want[1], rtol=DET_RTOL)
    assert _rel(_recon(whole(out[0]), out[1], out[2]),
                _recon(*want)) <= DET_RTOL
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    ju, js, jv = _jax("rsvd.krylov").rsvd_krylov(shard_rows8(mesh8, a),
                                                 **kw)
    got = single(fn, a, **kw)
    # JAX's Pallas eigh (interpret mode) factors the tail in f32: its
    # route is held at tests/test_torch_krylov.py's f32 bar, 1e-4 of s_1
    tol = 1e-4 if method == "eigh_pallas" else RTOL
    assert np.abs(got[1] - np.asarray(js)).max() / js[0] <= tol
    assert _rel(_recon(*got), _recon(ju, js, jv)) <= tol


def test_krylov_basis_sharded(ranks):
    """The basis itself comes back row-sharded, to 1e-9 of the single
    call's."""
    a = _decaying(3, 64, 48)
    omega = np.random.default_rng(4).standard_normal((48, 5))
    fn = "rsvd.krylov:krylov_basis"
    out, tally = sharded(ranks, fn, a, omega, 2, layouts=("rows", None))
    no_whole_gather(tally, a)
    assert out["placements"] == ["S(0)"]
    np.testing.assert_allclose(out["whole"], single(fn, a, omega, 2),
                               rtol=DET_RTOL, atol=1e-12)


# --- rsvd/interp.py -----------------------------------------------------------


@pytest.mark.parametrize("name", ["column_id", "row_id", "cur"])
def test_interp_sharded(mesh8, ranks, monkeypatch, name):
    """Pivots equal to the single call's and JAX's; X (row ID: row-sharded)
    and U to 1e-9 and RTOL.  The row ID gathers its l-wide panel Y."""
    a = _decaying(5, 96, 64, floor=1e-4)
    kw = dict(k=8, p=6, seed=2)
    fn = "rsvd.interp:" + name
    out, tally = sharded(ranks, fn, a, **kw)
    no_whole_gather(tally, a)
    want = single(fn, a, **kw)
    for got, ref in zip(out, want):
        if np.issubdtype(np.asarray(ref).dtype, np.integer):
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(whole(got), ref, rtol=DET_RTOL,
                                       atol=1e-12)
    if name == "row_id":
        assert out[1]["placements"] == ["S(0)"]
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    want_j = getattr(_jax("rsvd.interp"), name)(shard_rows8(mesh8, a), **kw)
    for got, ref in zip(single(fn, a, **kw), want_j):
        ref = np.asarray(ref)
        if np.issubdtype(ref.dtype, np.integer):
            np.testing.assert_array_equal(got, ref)
        else:
            assert _rel(got, ref) <= RTOL


def test_reconstructions_sharded(ranks):
    """id_reconstruct and cur_reconstruct of a row-sharded A come back
    row-sharded, to 1e-9 of the single calls (CUR's rows of A taken from
    the ranks that hold them by one all-reduce)."""
    a = _decaying(6, 64, 40, floor=1e-4)
    cols, x = single("rsvd.interp:column_id", a, k=6)
    c2, rows, u = single("rsvd.interp:cur", a, k=6)
    for fn, args in (("id_reconstruct", (a, cols, x)),
                     ("cur_reconstruct", (a, c2, rows, u))):
        out, tally = sharded(ranks, "rsvd.interp:" + fn, *args)
        assert out["placements"] == ["S(0)"]
        assert set(tally) <= {"all_reduce"}
        np.testing.assert_allclose(out["whole"],
                                   single("rsvd.interp:" + fn, *args),
                                   rtol=DET_RTOL, atol=1e-12)


@pytest.mark.parametrize("axis", [0, 1])
def test_leverage_sample_sharded(mesh8, ranks, monkeypatch, axis):
    """The sample equal to the single call's (row scores row-sharded, the
    top candidates of each rank gathered); (ii) JAX's Omega and Gumbel
    noise, JAX on mesh8."""
    a = _decaying(7, 96, 48, ratio=0.7)
    kw = dict(k=4, num_samples=12, p=6, seed=3, axis=axis)
    fn = "rsvd.interp:leverage_sample"
    out, tally = sharded(ranks, fn, a, **kw)
    no_whole_gather(tally, a)
    want = single(fn, a, **kw)
    np.testing.assert_array_equal(out[0], want[0])
    np.testing.assert_allclose(whole(out[1]), want[1], rtol=DET_RTOL)
    if axis == 0:
        assert out[1]["placements"] == ["S(0)"]
    key = jax.random.fold_in(jax.random.PRNGKey(3), 0x1e7a)
    n = a.shape[axis]
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    monkeypatch.setattr(_port("rsvd.interp"), "gumbel_uniforms",
                        lambda *args: from_numpy(np.asarray(
                            jax.random.uniform(key, (n,), jnp.float64,
                                               1e-12, 1.0))))
    idx_j, sc_j = _jax("rsvd.interp").leverage_sample(
        shard_rows8(mesh8, a), **kw)
    got = single(fn, a, **kw)
    np.testing.assert_array_equal(got[0], np.asarray(idx_j))
    assert _rel(got[1], sc_j) <= RTOL


# --- rsvd/nystrom.py ----------------------------------------------------------


def test_reigh_sharded(mesh8, ranks, monkeypatch):
    """Rayleigh-Ritz's A Q gathers the l-wide Q: (i) w 1e-9, U
    row-sharded; (ii) JAX's Omega: w RTOL, the span to 1e-8."""
    a = _sym(96, 9)
    kw = dict(k=6, p=8, q=2, seed=1)
    fn = "rsvd.nystrom:reigh"
    out, tally = sharded(ranks, fn, a, **kw)
    no_whole_gather(tally, a)
    assert out[1]["placements"] == ["S(0)"]
    want = single(fn, a, **kw)
    np.testing.assert_allclose(out[0], want[0], rtol=DET_RTOL)
    assert _sines(whole(out[1]), want[1]).max() <= 1e-9
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    w_j, u_j = _jax("rsvd.nystrom").reigh(shard_rows8(mesh8, a), **kw)
    got = single(fn, a, **kw)
    assert _rel(got[0], w_j) <= RTOL
    assert _sines(got[1], np.asarray(u_j)).max() <= 1e-8


@pytest.mark.parametrize("b_layout", ["rows", None])
def test_reigh_generalized_sharded(mesh8, ranks, monkeypatch, b_layout):
    """A and B row-sharded (or B whole): B's Cholesky by blocks over the
    ranks, the solves by block substitution, C never formed: (i) w 1e-9,
    V row-sharded with V^T B V = I; (ii) JAX on mesh8 with both sharded:
    w RTOL, the span to 1e-8."""
    a = _sym(96, 10)
    b = np.diag(1.0 + np.random.default_rng(11).random(96)) + 0.1 * _spd(
        96, 12)
    kw = dict(k=5, p=8, q=2, seed=4)
    fn = "rsvd.nystrom:reigh_generalized"
    out, tally = sharded(ranks, fn, a, b, layouts=("rows", b_layout), **kw)
    no_whole_gather(tally, a)
    assert out[1]["placements"] == ["S(0)"]
    want = single(fn, a, b, **kw)
    np.testing.assert_allclose(out[0], want[0], rtol=DET_RTOL)
    v = whole(out[1])
    assert _sines(v, want[1]).max() <= 1e-9
    np.testing.assert_allclose(v.T @ b @ v, np.eye(5), atol=1e-9)
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    w_j, v_j = _jax("rsvd.nystrom").reigh_generalized(
        shard_rows8(mesh8, a), shard_rows8(mesh8, b), **kw)
    got = single(fn, a, b, **kw)
    assert _rel(got[0], w_j) <= RTOL
    assert _sines(got[1], np.asarray(v_j)).max() <= 1e-8


def test_nystrom_pcg_sharded(mesh8, ranks, monkeypatch):
    """b whole on every rank, the iterates row-split: (i) x whole, to
    1e-8 (iterative), one gather of the n x nrhs direction a step;
    (ii) JAX's Omega, JAX on mesh8."""
    a = _spd(96, 13, decay=0.9)
    b = np.random.default_rng(14).standard_normal((96, 2))
    kw = dict(mu=1e-2, rank=40, iters=20, seed=5)
    fn = "rsvd.nystrom:nystrom_pcg"
    out, tally = sharded(ranks, fn, a, b, layouts=("rows", None), **kw)
    no_whole_gather(tally, a)
    assert tally["all_gather"]["calls"] == 20 + 1
    want = single(fn, a, b, **kw)
    np.testing.assert_allclose(out, want, rtol=ITER_RTOL)
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    x_j = _jax("rsvd.nystrom").nystrom_pcg(shard_rows8(mesh8, a),
                                           jnp.asarray(b), **kw)
    assert _rel(single(fn, a, b, **kw), x_j) <= RTOL


# --- rsvd/lstsq.py ------------------------------------------------------------


def _tall(m, n, cond, seed):
    g = np.random.default_rng(seed)
    u, _ = np.linalg.qr(g.standard_normal((m, n)))
    v, _ = np.linalg.qr(g.standard_normal((n, n)))
    return (u * np.geomspace(cond, 1.0, n)) @ v.T


def _jax_lstsq_draws(monkeypatch, seed, kind):
    """JAX's dense S or CountSketch draws for ``seed`` in the port."""
    def sketch(key, n, l, dtype=torch.float64, kind="gaussian"):
        return from_numpy(np.asarray(jax_sketch_matrix(
            jax_key_from_seed(seed), n, l, jnp.float64, kind)))

    def buckets(key, m, s, t):
        k = jax_key_from_seed(seed)
        out = []
        for j in range(t):
            kb, ks = jax.random.split(jax.random.fold_in(k, j))
            out.append((torch.from_numpy(np.asarray(jax.random.randint(
                kb, (m,), 0, s)).astype(np.int64)), torch.from_numpy(
                np.array(jax.random.bernoulli(ks, 0.5, (m,))))))
        return out

    monkeypatch.setattr(_port("rsvd.lstsq"), "sketch_matrix", sketch)
    monkeypatch.setattr(_port("ops.sketching"), "_buckets_and_signs",
                        buckets)


@pytest.mark.parametrize("kind, damp", [
    ("gaussian", 0.3), ("sparse", 0.0), ("sparse", 0.3)])
def test_sketch_lstsq_sharded(mesh8, ranks, monkeypatch, kind, damp):
    """The sparse sketch and ``damp`` on a sharded operand: (i) x within
    1e-8 (the sketch's sums are reordered over the ranks); with
    ``damp`` the augmented rows sqrt(damp) I join the last rank's block
    once (counted on every rank, the ridge term would be 4 damp and x
    would move by far more); (ii) JAX's draws, JAX on mesh8."""
    a = _tall(192, 16, 1e3, 15)
    b = np.random.default_rng(16).standard_normal((192, 2))
    kw = dict(seed=6, kind=kind, damp=damp, iters=30)
    fn = "rsvd.lstsq:sketch_lstsq"
    out, tally = sharded(ranks, fn, a, b, layouts=("rows", None), **kw)
    assert set(tally) == {"all_reduce"}
    want = single(fn, a, b, **kw)
    np.testing.assert_allclose(out, want, rtol=ITER_RTOL)
    if damp:
        four = single(fn, a, b, **dict(kw, damp=4 * damp))
        assert _rel(want, four) > 1e3 * ITER_RTOL
    _jax_lstsq_draws(monkeypatch, 6, kind)
    x_j = _jax("rsvd.lstsq").sketch_lstsq(shard_rows8(mesh8, a),
                                          jnp.asarray(b), **kw)
    assert _rel(single(fn, a, b, **kw), x_j) <= RTOL


@pytest.mark.parametrize("kind", ["gaussian", "sparse"])
def test_sketch_minnorm_sharded(mesh8, ranks, monkeypatch, kind):
    """A wide (24 x 160) and row-sharded: the s x m sketch of A^T and, a
    step, the m x nrhs PCG residual gathered: (i) x whole, within 1e-8;
    (ii) JAX's draws, JAX on mesh8."""
    a = _tall(160, 24, 1e2, 17).T
    b = np.random.default_rng(18).standard_normal((24, 2))
    kw = dict(seed=8, kind=kind, iters=30)
    fn = "rsvd.lstsq:sketch_minnorm"
    out, tally = sharded(ranks, fn, a, b, layouts=("rows", None), **kw)
    no_whole_gather(tally, a)
    want = single(fn, a, b, **kw)
    np.testing.assert_allclose(out, want, rtol=ITER_RTOL)
    _jax_lstsq_draws(monkeypatch, 8, kind)
    x_j = _jax("rsvd.lstsq").sketch_minnorm(shard_rows8(mesh8, a),
                                            jnp.asarray(b), **kw)
    assert _rel(single(fn, a, b, **kw), x_j) <= RTOL


def test_lstsq_residual_sharded(mesh8, ranks):
    """x and b whole, A row-sharded: (i) 1e-9; (ii) JAX on mesh8 at the
    single-card tests' 1e-12."""
    a = _tall(96, 12, 10.0, 19)
    g = np.random.default_rng(20)
    x, b = g.standard_normal((12, 2)), g.standard_normal((96, 2))
    fn = "rsvd.lstsq:lstsq_residual"
    out, tally = sharded(ranks, fn, a, x, b, layouts=("rows", None, None))
    assert set(tally) == {"all_reduce"}
    want = single(fn, a, x, b)
    np.testing.assert_allclose(out, want, rtol=DET_RTOL)
    r_j = _jax("rsvd.lstsq").lstsq_residual(shard_rows8(mesh8, a),
                                            jnp.asarray(x), jnp.asarray(b))
    np.testing.assert_allclose(want, np.asarray(r_j), rtol=1e-12)


# --- ragged rows --------------------------------------------------------------


@pytest.mark.parametrize("fn, extra", [
    ("rsvd.krylov:rsvd_krylov", {}), ("rsvd.interp:cur", {"k": 4}),
    ("rsvd.nystrom:reigh", {"k": 4}),
    ("rsvd.driver:rsvd_onepass", {"k": 4}),
    ("linalg.qr:qr_reduced", {}), ("linalg.svd:svd", {}),
    ("rsvd.deim:deim_indices", {}), ("apps.pod:standard_pod", {"rank": 4}),
    ("rsvd.hodlr:hodlr_build", {"levels": 1, "k": 4}),
    ("apps.cluster:spectral_cluster", {"n_clusters": 2})])
def test_ragged_rows_raise(ranks, fn, extra):
    """A DTensor in torch's own uneven split (98 rows over 4 ranks)
    raises, as ``core/mesh.py::shard_rows`` does; only ``rsvd_sharded``
    pads."""
    a = np.random.default_rng(21).standard_normal((98, 98))
    got = ranks.run("raises", fn=fn, args=(a,), layouts=("ragged",),
                    **extra)
    for res in got:
        assert res is not None and res["type"] == "ValueError"
        assert "does not divide" in res["message"]
