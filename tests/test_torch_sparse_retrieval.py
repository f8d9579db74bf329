"""Sparse operands of the port's driver (``rsvd/driver.py``'s
``SparseStored`` path) and the single-card retrieval app
(``apps/retrieval.py``), against the JAX package on the CPU in f64.

The JAX sparse cases (tests/test_sparse.py) are marked slow because BCOO
compiles slowly; here the port's sparse path is held to JAX's *dense*
call on the same Omega, which is fast.  JAX's Omega is patched into the
port's ``generate_omega``.  Singular values must equal JAX's to
``RTOL`` = 1e-10 of sigma_1 (the same f64 algorithm on the same
numbers; the sparse product sums each row in its own order), subspaces
to sines of 1e-8.  Retrieval: the port's tables equal JAX's to the same
bar, the quantized tables and int8 scores equal JAX's bit for bit on the
same f64 tables, top-k values equal JAX's and ids wherever no tie exists
(none does in these draws)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import sparse as jsparse

from rsvd_kamaneh_raganato_terrana_tpu.apps import retrieval as jret
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import driver as jdrv
from rsvd_kamaneh_raganato_terrana_tpu.rsvd.driver import (
    generate_omega as jax_generate_omega,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import retrieval as tret
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdrv

from_numpy = functools.partial(convert.from_numpy, device="cpu")
RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def jax_omega(monkeypatch):
    def omega(key_or_seed, n, l, dtype=torch.float64, kind="gaussian",
              device=None):
        return from_numpy(np.asarray(jax_generate_omega(
            key_or_seed, n, l, jnp.float64, kind)), dtype=dtype)

    monkeypatch.setattr(tdrv, "generate_omega", omega)


def _sparse_lowrank(rng, m, n, r, density=0.08):
    """Low-rank interaction pattern with a sparse observation mask."""
    full = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    mask = rng.random((m, n)) < density
    return np.where(mask, full, 0.0)


def _interactions(rng, n_users=128, n_items=96, rank=6):
    return (rng.standard_normal((n_users, rank))
            @ rng.standard_normal((rank, n_items)))


def _assert_sigma(s, sj, rtol=RTOL):
    """|s - s_jax| <= rtol sigma_1 (singular values at roundoff, past a
    low-rank signal, agree only in absolute terms)."""
    assert s.shape == sj.shape
    assert np.abs(s - sj).max() <= rtol * sj[0]


def _sines(x, y):
    qx, _ = np.linalg.qr(x)
    qy, _ = np.linalg.qr(y)
    return np.linalg.svd(qy - qx @ (qx.T @ qy), compute_uv=False)


LAYOUTS = {
    "coo": lambda t: t.to_sparse(),
    "csr": lambda t: t.to_sparse_csr(),
    "csc": lambda t: t.to_sparse_csc(),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("finish", ["project", "rowspace", "utv",
                                    "rowspace_utv"])
def test_sparse_rsvd_matches_jax_dense(rng, layout, finish):
    d = _sparse_lowrank(rng, 120, 90, 5)
    a = LAYOUTS[layout](from_numpy(d))
    kw = dict(k=10, p=6, q=2, method="eigh", finish=finish)
    u, s, v = (to_numpy(x) for x in tdrv.rsvd(a, **kw))
    uj, sj, vj = (np.asarray(x) for x in jdrv.rsvd(jnp.asarray(d), **kw))
    _assert_sigma(s, sj)
    # the rank-5 signal's subspaces (the rest is the mask's spectrum)
    assert _sines(u[:, :5], uj[:, :5]).max() <= 1e-8
    assert _sines(v[:, :5], vj[:, :5]).max() <= 1e-8


def test_rsvd_accepts_sparse(rng):
    """tests/test_sparse.py::test_rsvd_accepts_bcoo: the sparse call
    equals the dense one on the same sketch stream."""
    d = _sparse_lowrank(rng, 120, 90, 5)
    u, s, v = tdrv.rsvd(from_numpy(d).to_sparse(), k=10, p=6, q=2)
    assert u.shape == (120, 10) and v.shape == (90, 10)
    _, s_d, _ = tdrv.rsvd(from_numpy(d), k=10, p=6, q=2)
    np.testing.assert_allclose(to_numpy(s), to_numpy(s_d), rtol=1e-8)
    sj = np.asarray(jdrv.rsvd(jnp.asarray(d), k=10, p=6, q=2)[1])
    np.testing.assert_allclose(to_numpy(s), sj, rtol=1e-8)


def test_sparse_diagonal_exact(input_matrices):
    """tests/test_sparse.py::test_sparse_diagonal_exact: the reference's
    diagonal .mtx input fed as an actual sparse matrix."""
    d = input_matrices["sparse_matrix100.mtx"]
    u, s, v = tdrv.rsvd(from_numpy(d).to_sparse(), k=0, p=16, q=2)
    err = float(tdrv.reconstruction_error(from_numpy(d), u, s, v))
    assert err <= np.sqrt(max(0.0, 100 - 16)) * 1.001 + 1e-9


def test_sparse_embeddings_end_to_end(rng):
    """tests/test_sparse.py::test_sparse_embeddings_end_to_end, and the
    tables equal JAX's from the dense matrix."""
    d = _sparse_lowrank(rng, 96, 64, 4, density=0.15)
    tables = tret.factorize_interactions(from_numpy(d).to_sparse(), k=8)
    scores = to_numpy(tables.users) @ to_numpy(tables.items).T
    s_np = np.linalg.svd(d, compute_uv=False)
    assert np.linalg.norm(scores - d) <= np.sqrt((s_np[8:] ** 2).sum()) * 1.1
    tj = jret.factorize_interactions(jnp.asarray(d), k=8)
    _assert_sigma(to_numpy(tables.sigma), np.asarray(tj.sigma))
    np.testing.assert_allclose(
        scores, np.asarray(tj.users) @ np.asarray(tj.items).T,
        atol=1e-9 * np.abs(scores).max())
    vals, ids = tret.top_k_items(tables, [0, 3], k=5)
    assert ids.shape == (2, 5)


def test_sparse_duplicates_are_summed(rng):
    """Duplicate COO entries are one logical entry (BCOO's
    ``sum_duplicates``): ``rsvd_adaptive``'s ||A||_F^2 and every product
    see the summed value.  Through ``bcoo_from_jax`` from a JAX BCOO
    with duplicates."""
    d = _sparse_lowrank(rng, 80, 60, 3, density=0.2)
    b = jsparse.BCOO.fromdense(jnp.asarray(d))
    idx = np.asarray(b.indices)
    data = np.asarray(b.data)
    half = data / 2.0                      # every entry split in two
    idx2, data2 = np.concatenate([idx, idx]), np.concatenate([half, half])
    a = convert.bcoo_from_jax(idx2, data2, b.shape, device="cpu")
    assert not a.is_coalesced() and a._nnz() == 2 * len(data)
    out = tdrv.rsvd_adaptive(a, tol=1e-2, k0=4, method="eigh",
                             return_stats=True)
    dense = tdrv.rsvd_adaptive(from_numpy(d), tol=1e-2, k0=4,
                               method="eigh", return_stats=True)
    jout = jdrv.rsvd_adaptive(jnp.asarray(d), tol=1e-2, k0=4,
                              method="eigh", return_stats=True)
    assert out[3] == dense[3] == jout[3]
    assert out[4]["block_sizes"] == jout[4]["block_sizes"]
    np.testing.assert_allclose(to_numpy(out[1]), np.asarray(jout[1]),
                               rtol=1e-9)


def test_sparse_mm_both_sides(rng):
    """``_mm``: sparse x dense and dense x sparse, for a raw sparse
    tensor and for the stored A / A^T pair, equal the dense products."""
    d = _sparse_lowrank(rng, 30, 20, 3, density=0.3)
    x, y = rng.standard_normal((20, 4)), rng.standard_normal((5, 30))
    for a in (from_numpy(d).to_sparse(), tdrv.sparse_operand(
            from_numpy(d).to_sparse_csr())):
        np.testing.assert_allclose(to_numpy(tdrv._mm(a, from_numpy(x))),
                                   d @ x, rtol=1e-12)
        np.testing.assert_allclose(to_numpy(tdrv._mm(from_numpy(y), a)),
                                   y @ d, rtol=1e-12)
    st = tdrv.sparse_operand(from_numpy(d).to_sparse())
    assert st.T.shape == (20, 30) and st.fwd.crow_indices().dtype == \
        torch.int32
    np.testing.assert_allclose(to_numpy(tdrv._mm(st.T, from_numpy(y.T))),
                               d.T @ y.T, rtol=1e-12)
    with pytest.raises(TypeError):
        tdrv.rsvd(st, k=2, p=2, sketch="fused")


def test_factorization_approximates_interactions(rng):
    a = _interactions(rng)
    tables = tret.factorize_interactions(from_numpy(a), k=8)
    approx = to_numpy(tables.users) @ to_numpy(tables.items).T
    assert np.linalg.norm(approx - a) / np.linalg.norm(a) < 1e-8
    tj = jret.factorize_interactions(jnp.asarray(a), k=8)
    _assert_sigma(to_numpy(tables.sigma), np.asarray(tj.sigma))


def test_top_k_matches_dense_argmax(rng):
    a = _interactions(rng)
    tj = jret.factorize_interactions(jnp.asarray(a), k=8)
    tables = convert.tables_from_jax(tj, device="cpu")
    ids = [0, 5, 17]
    vals, items = tret.top_k_items(tables, ids, k=5)
    scores = to_numpy(tret.score(tables, ids))
    np.testing.assert_array_equal(to_numpy(items),
                                  np.argsort(-scores, axis=1)[:, :5])
    vj, ij = jret.top_k_items(tj, jnp.asarray(ids), k=5)
    np.testing.assert_array_equal(to_numpy(items), np.asarray(ij))
    np.testing.assert_allclose(to_numpy(vals), np.asarray(vj), rtol=1e-12)
    # a scalar id scores one row
    np.testing.assert_allclose(to_numpy(tret.score(tables, 5)), scores[1],
                               rtol=1e-12)


def test_quantized_retrieval(rng):
    a = _interactions(rng, n_users=96, n_items=120, rank=8)
    tj = jret.factorize_interactions(jnp.asarray(a), k=8)
    tables = convert.tables_from_jax(tj, device="cpu")
    qt = tret.quantize_tables(tables)
    assert qt.users_q.dtype == torch.int8 and qt.items_q.dtype == torch.int8
    qj = jret.quantize_tables(tj)
    for got, want in zip(qt, qj):
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    assert isinstance(convert.tables_from_jax(qj, device="cpu"),
                      tret.QuantizedTables)
    ids = [0, 7, 33]
    full = to_numpy(tret.score(tables, ids))
    quant = to_numpy(tret.score_quantized(qt, ids))
    np.testing.assert_array_equal(
        quant, np.asarray(jret.score_quantized(qj, jnp.asarray(ids))))
    np.testing.assert_array_equal(
        to_numpy(tret.score_quantized(qt, 7)), quant[1])
    assert np.abs(full - quant).max() < 0.03 * np.abs(full).max()
    _, items_q = tret.top_k_items_quantized(qt, ids, k=10)
    _, items_f = tret.top_k_items(tables, ids, k=10)
    for r in range(3):
        overlap = len(set(to_numpy(items_q)[r]) & set(to_numpy(items_f)[r]))
        assert overlap >= 8, overlap
    _, ij = jret.top_k_items_quantized(qj, jnp.asarray(ids), k=10)
    np.testing.assert_array_equal(to_numpy(items_q), np.asarray(ij))


def test_top_k_items_sharded_waits_for_the_distributed_slice(rng, mesh8):
    """Ported with the distributed slice: ``top_k_items_sharded`` on a
    one-rank group (this process) against JAX's on mesh8, on JAX's
    tables; the four-rank case is in tests/test_torch_distributed.py."""
    from _torch_ranks import one_rank_group
    from rsvd_kamaneh_raganato_terrana_tpu.core.mesh import (
        shard_rows as jax_shard_rows,
    )
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.mesh import make_mesh

    a = _interactions(rng)
    tj = jret.factorize_interactions(jax_shard_rows(jnp.asarray(a), mesh8),
                                     k=4)
    users = tj.users[:2]
    vals_j, ids_j = jret.top_k_items_sharded(mesh8, tj, users, k=3)
    tables = convert.tables_from_jax(tj, device="cpu")
    with one_rank_group():
        vals, ids = tret.top_k_items_sharded(make_mesh(device="cpu"), tables,
                                             tables.users[:2], k=3)
    np.testing.assert_array_equal(to_numpy(ids), np.asarray(ids_j))
    np.testing.assert_allclose(to_numpy(vals), np.asarray(vals_j),
                               rtol=1e-12)
