"""A sparse operand split by its stored entries over the ranks: the port's
counterpart of a BCOO placed with ``jax.device_put(a, NamedSharding(mesh,
P('rows')))``, which JAX applies to the BCOO's data and indices.

``core/mesh.py::shard_rows`` of a torch sparse tensor cuts the coalesced
row-major entry list into one run a rank (``core/distributed.py::
EntrySplit``); each product is the run's product all-reduced, so every
panel and U come back whole on every rank, as JAX's do.  Each case runs
the port on P = 4 gloo ranks (tests/_torch_ranks.py) against the JAX
function on conftest's 8-device mesh, the BCOO's nse padded to a
multiple of 8 (``device_put``'s rule), the same f64 NumPy input and
JAX's own draws handed to the ranks (Omega, Psi, the probes): s by
relative error at ``RTOL`` = 1e-9, the leading subspaces by the sines of
their principal angles at 1e-9; the routes through K1/K3 (JAX's Pallas
eigh in interpret mode factors in f32) at 1e-4 of s_1.  Each call
issues all-reduces only, and every rank holds the same U.  One rank in
this process is bitwise the single-card sparse call; a run length that
does not divide the ranks is held to the port's single call.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import sparse as jsparse
from jax.sharding import NamedSharding, PartitionSpec

from rsvd_kamaneh_raganato_terrana_tpu.rsvd import driver as jdriver
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.mesh import (
    make_mesh,
    shard_rows,
)

from _torch_ranks import one_rank_group
from _torch_sharded import (  # noqa: F401 -- fixtures by name
    RANKS,
    _jax,
    _one_torch_thread,
    _port,
    _rel,
    from_numpy,
    ranks,
)

RTOL = 1e-9
K3_TOL = 1e-4            # JAX's Pallas eigh factors the l x l tail in f32
M, N = 96, 72


def _sparse(seed, m=M, n=N, density=0.15):
    """A sparse m x n f64 matrix with a decaying spectrum: 0.75^i at
    (rows[i], cols[i]) of two permutations, plus entries of scale 1e-2
    at ``density``; the singular values fall off by 0.75."""
    g = np.random.default_rng(seed)
    r = min(m, n)
    a = np.zeros((m, n))
    a[g.permutation(m)[:r], g.permutation(n)[:r]] = 0.75 ** np.arange(r)
    return a + (g.random((m, n)) < density) * 1e-2 * g.standard_normal(
        (m, n))


def _bcoo8(mesh8, a):
    """``a`` as JAX's BCOO placed with the row sharding on mesh8, nse
    padded to a multiple of the 8 devices."""
    nse = int(np.count_nonzero(a))
    bcoo = jsparse.BCOO.fromdense(jnp.asarray(a), nse=-(-nse // 8) * 8)
    return jax.device_put(bcoo, NamedSharding(mesh8, PartitionSpec("rows")))


def _omega(seed, n, l):
    return np.asarray(jdriver.generate_omega(seed, n, l, jnp.float64))


def _sines(x, y, k):
    """Sines of the principal angles between the spans of the first k
    columns of x and y."""
    qx, _ = np.linalg.qr(np.asarray(x)[:, :k])
    qy, _ = np.linalg.qr(np.asarray(y)[:, :k])
    return np.linalg.svd(qy - qx @ (qx.T @ qy), compute_uv=False)


def _on_ranks(ranks, fn, *args, layouts=("sparse",), **kwargs):
    """Every rank's result of the port's ``fn``: the result is whole on
    every rank and equal (U replicated), and only all-reduces ran.
    Rank 0's packed result."""
    res = ranks.run("call", fn=fn, args=args, layouts=layouts, **kwargs)
    for r in res[1:]:
        for got, want in zip(_leaves(r["out"]), _leaves(res[0]["out"])):
            np.testing.assert_array_equal(got, want)
    assert set(res[0]["tally"]) == {"all_reduce"}, res[0]["tally"]
    return res[0]["out"]


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _leaves(item)]
    if isinstance(x, dict):
        assert "whole" not in x, "a DTensor where JAX's result is whole"
        return [v for item in x.values() for v in _leaves(item)]
    return [np.asarray(x)]


def _close(got, want, k, tol=RTOL):
    """(U, s, V) against JAX's: s by relative error, the k leading
    columns of U and V by principal angles."""
    s, sj = np.asarray(got[1])[:k], np.asarray(want[1])[:k]
    assert np.abs(s - sj).max() <= tol * sj[0]
    assert _sines(got[0], want[0], k).max() <= tol
    assert _sines(got[2], want[2], k).max() <= tol


# --- the placement ------------------------------------------------------------


@pytest.mark.parametrize("layout, density", [
    ("sparse", 0.15), ("csr", 0.15), ("csc", 0.15), ("sparse", 0.0204)])
def test_entries_split_in_row_major_runs(ranks, layout, density):
    """Any layout; duplicates summed; rank r holds entries [r nse / P,
    (r + 1) nse / P) of the row-major list at the whole shape, whatever
    nse (the last case: 141 entries over 4 ranks)."""
    a = _sparse(1, density=density)
    got = ranks.run("entries", a=a, layout=layout)
    rows, cols = np.nonzero(a)                   # row-major, as coalesced
    nse = rows.size
    assert sum(r["dense"] for r in got).tolist() == a.tolist()
    for r, part in enumerate(got):
        lo, hi = r * nse // RANKS, (r + 1) * nse // RANKS
        assert part["shape"] == a.shape
        np.testing.assert_array_equal(part["entries"],
                                      np.stack([rows[lo:hi], cols[lo:hi]],
                                               axis=1))


# --- rsvd/driver.py -----------------------------------------------------------


@pytest.mark.parametrize("qr_method, method, finish", [
    ("robust", "jacobi", "project"), ("robust", "eigh", "rowspace"),
    ("cholqr1_fused", "eigh_pallas", "project")])
def test_rsvd_with_omega_entry_split(mesh8, ranks, qr_method, method,
                                     finish):
    """The same explicit Omega on both sides; the K1/K3 route (their plain
    versions here) held at the f32 tail's bar."""
    a = _sparse(2)
    omega = _omega(3, N, 12)
    kw = dict(q=2, k=8, method=method, qr_method=qr_method, finish=finish)
    got = _on_ranks(ranks, "rsvd.driver:rsvd_with_omega", a, omega, **kw)
    want = jdriver.rsvd_with_omega(_bcoo8(mesh8, a), jnp.asarray(omega),
                                   **kw)
    _close(got, want, 8, K3_TOL if method == "eigh_pallas" else RTOL)


@pytest.mark.parametrize("fn, kw", [
    ("rsvd", dict(k=6, p=6, q=1, seed=4)),
    ("rsvd_image_preset", dict(k=6, seed=4)),
    ("rsvd_onepass", dict(k=5, p=6, seed=9)),
    ("rsvd_adaptive", dict(tol=5e-2, k0=4, seed=3, return_stats=True))])
def test_driver_entry_split(mesh8, ranks, fn, kw):
    """The driver's own draws replaced by JAX's (Omega for every block
    of the adaptive basis, Omega and Psi of the one-pass sketch); the
    adaptive rank and stats equal."""
    a = _sparse(4)
    want = getattr(jdriver, fn)(_bcoo8(mesh8, a), **kw)
    if fn == "rsvd_onepass":
        k_om, k_psi = jax.random.split(jax.random.PRNGKey(kw["seed"]))
        draws = {"rsvd.driver:gaussian": [
            np.asarray(jax.random.normal(k_om, (N, 11), jnp.float64)),
            np.asarray(jax.random.normal(k_psi, (M, 23), jnp.float64))]}
    elif fn == "rsvd_adaptive":
        sizes = want[4]["block_sizes"]
        draws = {"rsvd.driver:generate_omega": [
            _omega(kw["seed"] + 7919 * i, N, l) for i, l in
            enumerate(sizes)]}
    else:
        l = kw["k"] + (kw.get("p", 10))
        draws = {"rsvd.driver:generate_omega": [_omega(kw["seed"], N, l)]}
    got = _on_ranks(ranks, "rsvd.driver:" + fn, a, draws=draws, **kw)
    if fn == "rsvd_adaptive":
        assert got[3] == want[3] and got[4] == want[4]
    _close(got, want, 5)


@pytest.mark.parametrize("q_layout", [None, "rows"])
def test_rsvd_warm_entry_split(mesh8, ranks, q_layout):
    """The previous basis whole, or row-sharded (gathered: an m x l
    panel)."""
    a = _sparse(5)
    q_prev = np.linalg.qr(np.random.default_rng(6).standard_normal(
        (M, 10)))[0]
    kw = dict(k=6, q=2)
    got = ranks.run("call", fn="rsvd.driver:rsvd_warm", args=(a, q_prev),
                    layouts=("sparse", q_layout), **kw)[0]
    assert set(got["tally"]) == ({"all_reduce"} if q_layout is None
                                 else {"all_reduce", "all_gather"})
    want = jdriver.rsvd_warm(_bcoo8(mesh8, a), jnp.asarray(q_prev), **kw)
    _close(got["out"], want, 6)


@pytest.mark.parametrize("fn", ["subspace_iteration", "power_refine"])
def test_stage_a_entry_split(mesh8, ranks, fn):
    """Q whole on every rank, its span JAX's."""
    a = _sparse(7)
    x = _omega(8, N, 10) if fn == "subspace_iteration" else \
        np.linalg.qr(np.random.default_rng(9).standard_normal((M, 10)))[0]
    got = _on_ranks(ranks, "rsvd.driver:" + fn, a, x, q=2)
    want = getattr(jdriver, fn)(_bcoo8(mesh8, a), jnp.asarray(x), q=2)
    assert _sines(got, want, 10).max() <= RTOL


# --- rsvd/diagnostics.py ------------------------------------------------------


@pytest.mark.parametrize("name", ["range_error_estimate",
                                  "factorization_error_estimate"])
def test_certificates_entry_split(mesh8, ranks, name):
    """JAX's probes handed to the ranks; the bound to 1e-9."""
    a = _sparse(10)
    u, s, vt = np.linalg.svd(a, full_matrices=False)
    args = (u[:, :8],) if name == "range_error_estimate" else \
        (u[:, :8], s[:8], vt[:8].T)
    kw = dict(seed=7, num_probes=6)
    diag = _jax("rsvd.diagnostics")
    probes = np.asarray(jax.random.normal(diag._probe_key(7), (N, 6),
                                          jnp.float64))
    got = _on_ranks(ranks, "rsvd.diagnostics:" + name, a, *args,
                    draws={"rsvd.diagnostics:_probes": [probes]}, **kw)
    want = getattr(diag, name)(_bcoo8(mesh8, a),
                               *(jnp.asarray(x) for x in args), **kw)
    np.testing.assert_allclose(got, float(want), rtol=RTOL)


@pytest.mark.parametrize("name, jax_error", [
    ("spectral_norm_estimate", "matmul requires ndarray"),
    ("stable_rank_estimate", "setting an array element with a sequence")])
def test_norm_estimates_refuse_like_jax(mesh8, ranks, name, jax_error):
    """The JAX package fails on a BCOO so placed (shown on a 16 x 8 corner:
    JAX's failing conversion walks the BCOO row by row, a minute at the
    full size); the port refuses it and names that failure."""
    a = _sparse(11)
    with pytest.raises(Exception, match=jax_error):
        getattr(_jax("rsvd.diagnostics"), name)(_bcoo8(mesh8, a[:16, :8]))
    for res in ranks.run("raises", fn="rsvd.diagnostics:" + name, args=(a,),
                         layouts=("sparse",)):
        assert res["type"] == "TypeError"
        assert "JAX package fails" in res["message"]


# --- apps/estimators.py, apps/retrieval.py ------------------------------------


def test_randomized_svd_entry_split(mesh8, ranks):
    """fit_transform and transform whole on every rank; the attributes,
    the variance's all-reduced column sums included, against JAX's."""
    a = _sparse(12)
    init = dict(n_components=5, p=6, q=2, seed=2)
    names = ["components_", "singular_values_", "explained_variance_",
             "explained_variance_ratio_"]
    res = ranks.run("fit", cls="apps.estimators:RandomizedSVD", args=(a,),
                    layouts=("sparse",), init=dict(init, device="cpu"),
                    method="fit_transform", attrs=names,
                    then=[("transform", (a,), ("sparse",))],
                    draws={"rsvd.driver:generate_omega": [
                        _omega(2, N, 11)]})
    for r in res[1:]:
        np.testing.assert_array_equal(r["out"], res[0]["out"])
    got = res[0]
    assert set(got["tally"]) == {"all_reduce"}
    jx = _jax("apps.estimators").RandomizedSVD(**init)
    z = jx.fit_transform(_bcoo8(mesh8, a))
    s = np.asarray(jx.singular_values_)
    assert np.abs(got["attrs"]["singular_values_"] - s).max() <= RTOL * s[0]
    np.testing.assert_allclose(got["attrs"]["explained_variance_ratio_"],
                               jx.explained_variance_ratio_, rtol=RTOL)
    assert _sines(got["attrs"]["components_"].T,
                  np.asarray(jx.components_).T, 5).max() <= RTOL
    for mine, ref in ((got["out"], z),
                      (got["then"][0], jx.transform(_bcoo8(mesh8, a)))):
        ref = np.asarray(ref)
        sign = np.where(np.sum(mine * ref, axis=0) < 0, -1.0, 1.0)
        assert np.abs(mine * sign - ref).max() <= RTOL * np.abs(ref).max()


def test_factorize_interactions_entry_split(mesh8, ranks):
    """The embedding tables whole on every rank; their product JAX's."""
    a = np.abs(_sparse(13))
    got = _on_ranks(ranks, "apps.retrieval:factorize_interactions", a, k=6,
                    draws={"rsvd.driver:generate_omega": [
                        _omega(0, N, 22)]})
    want = _jax("apps.retrieval").factorize_interactions(_bcoo8(mesh8, a),
                                                         k=6)
    assert _rel(np.asarray(got[0]) @ np.asarray(got[1]).T,
                np.asarray(want.users) @ np.asarray(want.items).T) <= RTOL
    assert _rel(got[2], want.sigma) <= RTOL


# --- one rank, and a run length that does not divide the ranks ----------------


def _single_calls():
    om = from_numpy(_omega(3, N, 12))
    q_prev = from_numpy(np.linalg.qr(np.random.default_rng(6)
                                     .standard_normal((M, 10)))[0])
    drv = _port("rsvd.driver")
    diag = _port("rsvd.diagnostics")
    est = _port("apps.estimators")

    def fit(a):
        e = est.RandomizedSVD(n_components=5, device="cpu")
        return (torch.from_numpy(e.fit_transform(a)),
                torch.from_numpy(e.explained_variance_ratio_))

    return {
        "rsvd": lambda a: drv.rsvd(a, k=6, seed=1),
        "rsvd_with_omega": lambda a: drv.rsvd_with_omega(
            a, om, k=8, qr_method="cholqr1_fused", method="eigh_pallas"),
        "rsvd_adaptive": lambda a: drv.rsvd_adaptive(a, tol=5e-2, k0=4)[:3],
        "rsvd_onepass": lambda a: drv.rsvd_onepass(a, k=5),
        "rsvd_warm": lambda a: drv.rsvd_warm(a, q_prev, k=6),
        "power_refine": lambda a: (drv.power_refine(a, q_prev, 2),),
        "range_error_estimate": lambda a: (diag.range_error_estimate(
            a, q_prev),),
        "RandomizedSVD": fit,
    }


@pytest.mark.parametrize("name", sorted(_single_calls()))
def test_one_rank_is_the_single_call(name):
    """A one-rank group in this process: the run is all of A, so each
    call is the single-card call on the sparse tensor, to the bit."""
    a = torch.from_numpy(_sparse(14)).to_sparse()
    call = _single_calls()[name]
    want = call(a)
    with one_rank_group():
        got = call(shard_rows(a, make_mesh(device="cpu")))
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_ragged_runs_match_the_single_call(ranks):
    """An nse that does not divide the 4 ranks (runs of two lengths): s
    and the reconstruction of ``rsvd`` to 1e-9 of the port's single
    call."""
    a = _sparse(15)
    rows, cols = np.nonzero(a)
    a[rows[:len(rows) % RANKS or 1], cols[:len(rows) % RANKS or 1]] = 0.0
    assert np.count_nonzero(a) % RANKS
    kw = dict(k=6, p=6, seed=5)
    got = _on_ranks(ranks, "rsvd.driver:rsvd", a, **kw)
    u, s, v = (to_numpy(t) for t in _port("rsvd.driver").rsvd(
        from_numpy(a).to_sparse(), **kw))
    assert _rel(got[1], s) <= RTOL
    assert _rel((got[0] * got[1]) @ got[2].T, (u * s) @ v.T) <= RTOL

