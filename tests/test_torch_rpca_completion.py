"""The port's robust PCA (``rsvd/rpca.py``) and matrix completion
(``rsvd/completion.py``) against the JAX package's, on the CPU in f64.

JAX's sketches are patched into the port's ``sketch_matrix``, one value
a call in the order JAX draws them (rpca: the sigma_1 start vector, one
Omega per iteration, the final rank probe; completion: one Omega per
iteration).  The results must then equal JAX's: L, S and the completed
matrix to ``RTOL`` = 1e-8 relative, the residual and RMSE traces to 1e-6
relative where they are above 1e-12 (the iterations threshold and
backtrack on the iterate, which amplifies f64 summation-order noise in
the late, converged iterations), the rank exactly.  On the port's own
streams the JAX package's recovery bars hold (tests/
test_completion_rpca.py): L and S within 5e-3, rank 4, the residual
below 1e-6; completion within 1e-3 of the full matrix.  80 x 70 / 80 x
60, rank 4."""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.core.rng import (
    sketch_matrix as jax_sketch_matrix,
)
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import completion as jcomp
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import completion as tcomp

# ``rsvd.rpca`` is the function of that name in both packages
jrpca, trpca = (importlib.import_module(f"{pkg}.rsvd.rpca") for pkg in (
    "rsvd_kamaneh_raganato_terrana_tpu",
    "rsvd_kamaneh_raganato_terrana_tpu_torch"))

from_numpy = functools.partial(convert.from_numpy, device="cpu")
RTOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _low_rank(m, n, k, seed=0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((m, k)) / np.sqrt(k)) @ g.standard_normal(
        (k, n))


def _corrupted(m=80, n=70, k=4, frac=0.05, mag=10.0, seed=5):
    g = np.random.default_rng(seed)
    low = _low_rank(m, n, k, seed=seed)
    sp = np.zeros((m, n))
    idx = g.random((m, n)) < frac
    sp[idx] = mag * g.standard_normal(idx.sum())
    return low, sp


def _patch_sketches(monkeypatch, module, keys_shapes):
    """JAX's sketches for (key, n, l) in order, one a call."""
    queue = [from_numpy(np.asarray(jax_sketch_matrix(k, n, l, jnp.float64)))
             for k, n, l in keys_shapes]

    def draw(key, n, l, dtype=torch.float32, kind="gaussian"):
        out = queue.pop(0)
        assert out.shape == (n, l)
        return out
    monkeypatch.setattr(module, "sketch_matrix", draw)
    return queue


def _close_where_big(got, want, rtol):
    big = np.abs(want) > 1e-12
    np.testing.assert_allclose(got[big], want[big], rtol=rtol)


@pytest.mark.parametrize("kw", [dict(), dict(lam=0.1, mu=0.05, rho=1.4)])
def test_rpca_matches_jax(monkeypatch, kw):
    low, sp = _corrupted()
    m_mat = low + sp
    seed, iters, k_max, p = 3, 20, 8, 10
    key = jax.random.PRNGKey(seed)
    l = k_max + p
    queue = _patch_sketches(monkeypatch, trpca, [
        (jax.random.fold_in(key, 0x51e17), 70, 1)]
        + [(jax.random.fold_in(key, i), 70, l) for i in range(iters + 1)])
    res_j = jrpca.rpca(jnp.asarray(m_mat), k_max=k_max, iters=iters,
                       seed=seed, **kw)
    res_t = trpca.rpca(from_numpy(m_mat), k_max=k_max, iters=iters,
                       seed=seed, **kw)
    assert not queue
    for name in ("low_rank", "sparse"):
        want = np.asarray(getattr(res_j, name))
        got = to_numpy(getattr(res_t, name))
        assert np.linalg.norm(got - want) <= RTOL * np.linalg.norm(want)
    assert int(res_t.rank) == int(res_j.rank)
    assert res_t.resid.shape == (iters,)
    _close_where_big(to_numpy(res_t.resid), np.asarray(res_j.resid), 1e-6)


def test_rpca_recovers_on_its_own_stream():
    low, sp = _corrupted()
    res = trpca.rpca(from_numpy(low + sp), k_max=8, iters=50)
    rel_l = np.linalg.norm(to_numpy(res.low_rank) - low) / np.linalg.norm(low)
    rel_s = np.linalg.norm(to_numpy(res.sparse) - sp) / np.linalg.norm(sp)
    assert rel_l < 5e-3 and rel_s < 5e-3
    assert int(res.rank) == 4
    r = to_numpy(res.resid)
    assert r[-1] < 1e-6 and r[-1] < r[0]


@pytest.mark.parametrize("eta", [None, 1.5])
def test_complete_lowrank_matches_jax(monkeypatch, eta):
    g = np.random.default_rng(1)
    a = _low_rank(80, 60, 4, seed=1)
    mask = g.random((80, 60)) < 0.5
    a_obs = np.where(mask, a, 1e6)               # never read
    seed, iters, k, p = 2, 15, 4, 10
    key = jax.random.PRNGKey(seed)
    queue = _patch_sketches(monkeypatch, tcomp, [
        (jax.random.fold_in(key, i), 60, k + p) for i in range(iters)])
    res_j = jcomp.complete_lowrank(jnp.asarray(a_obs), jnp.asarray(mask),
                                   k=k, iters=iters, eta=eta, seed=seed)
    res_t = tcomp.complete_lowrank(from_numpy(a_obs), from_numpy(mask),
                                   k=k, iters=iters, eta=eta, seed=seed)
    assert not queue
    assert res_t.u.shape == (80, k) and res_t.s.shape == (k,)
    assert res_t.v.shape == (60, k) and res_t.obs_rmse.shape == (iters,)
    x_j = (np.asarray(res_j.u) * np.asarray(res_j.s)) @ np.asarray(res_j.v).T
    x_t = to_numpy((res_t.u * res_t.s) @ res_t.v.T)
    assert np.linalg.norm(x_t - x_j) <= RTOL * np.linalg.norm(x_j)
    np.testing.assert_allclose(to_numpy(res_t.s), np.asarray(res_j.s),
                               rtol=RTOL)
    _close_where_big(to_numpy(res_t.obs_rmse), np.asarray(res_j.obs_rmse),
                     1e-6)


def test_complete_lowrank_recovers_on_its_own_stream():
    g = np.random.default_rng(4)
    a = _low_rank(80, 60, 4, seed=4)
    mask = g.random((80, 60)) < 0.5
    res = tcomp.complete_lowrank(from_numpy(np.where(mask, a, -3e5)),
                                 from_numpy(mask), k=4, iters=40)
    x = to_numpy((res.u * res.s) @ res.v.T)
    assert np.linalg.norm(x - a) / np.linalg.norm(a) < 1e-3
    rmse = to_numpy(res.obs_rmse)
    assert np.isfinite(rmse).all() and rmse[-1] < 1e-4 * rmse[0]


def test_complete_tucker_raises_until_tucker_is_ported():
    """``complete_tucker`` is ported with the Tucker format (queue 1 item
    8): it runs and returns JAX's result type, with the fields of JAX's
    result types (tests/test_torch_tucker_tt_cp.py holds its values)."""
    g = np.random.default_rng(6)
    t = np.einsum("i,j,k->ijk", *(g.standard_normal(n) for n in (6, 5, 4)))
    mask = g.random(t.shape) < 0.7
    res = tcomp.complete_tucker(from_numpy(np.where(mask, t, 0.0)),
                                from_numpy(mask), ranks=(1, 1, 1), iters=6)
    assert isinstance(res, tcomp.TuckerCompletionResult)
    assert tuple(res.core.shape) == (1, 1, 1)
    assert [tuple(f.shape) for f in res.factors] == [(6, 1), (5, 1), (4, 1)]
    rmse = to_numpy(res.obs_rmse)
    assert rmse.shape == (6,) and np.isfinite(rmse).all()
    assert rmse[-1] < rmse[0]
    assert tcomp.TuckerCompletionResult._fields == \
        jcomp.TuckerCompletionResult._fields
    assert tcomp.CompletionResult._fields == jcomp.CompletionResult._fields
    assert trpca.RpcaResult._fields == jrpca.RpcaResult._fields
