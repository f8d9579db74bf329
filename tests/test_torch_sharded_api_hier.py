"""Row-sharded operands through the port's public API, part four: HODLR
(build, matvec, CG solve), the GP on HODLR or dense, spectral clustering,
the incremental SVD and Tucker completion.

The two checks of tests/test_torch_sharded_api.py: (i) the port on
P = 4 gloo ranks, the operand a row-sharded DTensor and its own draws,
against the port's single-rank call on the same input: f64 and
deterministic at rtol 1e-9, the iterative ones (CG, Lanczos, k-means
and the completion's sweeps) at 1e-8, labels equal, with no all-gather
of a block as large as the rank's block of A (``no_whole_gather``; the
GP and spectral clustering gather their points once, n x d, as kernel
PCA does); (ii) the port's single-rank call with the JAX package's draws
patched in against the JAX function on a row-sharded array of
conftest's 8-device mesh, at ``RTOL`` = 1e-10 (the CG solves at 1e-8,
the tensor format at ``TUCKER_RTOL``, JAX's f32 Pallas eigh at 1e-4).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdriver

from _torch_sharded import (  # noqa: F401 -- fixtures by name
    ITER_RTOL,
    RANKS,
    RTOL,
    TUCKER_RTOL,
    _jax,
    _jax_omega,
    _jax_signed_eigh,
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
HODLR_KW = dict(levels=3, k=4, p=4)


def _close(got, want, rtol=DET_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(whole(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _kernel_spd(n, seed, lengthscale=0.2, ridge=0.1):
    """An RBF kernel of sorted 1-D points plus a ridge: SPD, its
    off-diagonal blocks numerically low-rank."""
    x = np.sort(np.random.default_rng(seed).random(n))
    d2 = (x[:, None] - x[None, :]) ** 2
    return np.exp(-0.5 * d2 / lengthscale ** 2) + ridge * np.eye(n)


def _blocks(h):
    """Every off-diagonal block's U V^T and the leaves of a HODLR
    matrix (a packed one or the single call's), as arrays in order."""
    out = []
    for ell in range(len(h[0])):
        for fu, fv in ((h[0][ell], h[1][ell]), (h[2][ell], h[3][ell])):
            fu, fv = np.asarray(whole(fu)), np.asarray(whole(fv))
            out += [f @ g.T for f, g in zip(fu, fv)]
    return out + [np.asarray(whole(h[4]))]


def _jax_hodlr_draws(monkeypatch):
    monkeypatch.setattr(_port("rsvd.hodlr"), "generate_omega", _jax_omega)


# --- rsvd/hodlr.py ----------------------------------------------------------


def test_hodlr_build_sharded(mesh8, ranks, monkeypatch):
    """n = 64, levels 3 over 4 ranks: level 0's blocks each a row-split
    rSVD over the 2 ranks that hold its rows, level 1's blocks one a
    rank, level 2's whole pairs on each rank (stacks sharded on the block
    index), the leaves sharded; levels 0 and 1 replicated by one
    all-gather each of U's and V's rows.  (i) every block's U V^T and the
    leaves to 1e-9; (ii) JAX's Omega, JAX on mesh8."""
    a = _kernel_spd(64, 1)
    fn = "rsvd.hodlr:hodlr_build"
    out, tally = sharded(ranks, fn, a, **HODLR_KW)
    no_whole_gather(tally, a)
    assert tally["all_gather"]["calls"] >= 2 * 2
    assert out[4]["placements"] == ["S(0)"]
    assert out[0][2]["placements"] == ["S(0)"]
    assert not isinstance(out[0][0], dict)           # replicated level
    want = single(fn, a, **HODLR_KW)
    for got, ref in zip(_blocks(out), _blocks(want)):
        _close(got, ref)
    _jax_hodlr_draws(monkeypatch)
    hj = _jax("rsvd.hodlr").hodlr_build(shard_rows8(mesh8, a), **HODLR_KW)
    got = single(fn, a, **HODLR_KW)
    for mine, ref in zip(_blocks(got), _blocks(hj)):
        assert _rel(mine, ref) <= RTOL


@pytest.mark.parametrize("cols", [0, 3])
def test_hodlr_matvec_and_solve_sharded(mesh8, ranks, monkeypatch, cols):
    """x and y row-split: each replicated level's V^T x one all-reduce of
    its k-coefficients, the rest local; CG's dot products all-reduced,
    the leaves' Cholesky local.  (i) y to 1e-9, x to 1e-8 with the same
    steps, both row-sharded; (ii) JAX's Omega, JAX's matvec and CG on
    mesh8 (x at 1e-8)."""
    a = _kernel_spd(64, 2)
    g = np.random.default_rng(3)
    x = g.standard_normal((64, cols) if cols else 64)
    b = g.standard_normal((64, cols) if cols else 64)
    res = ranks.run("chain", fn="rsvd.hodlr:hodlr_build", args=(a,),
                    layouts=("rows",), **HODLR_KW, then=[
                        ("rsvd.hodlr:hodlr_matvec", (x,), ("rows",), {}),
                        ("rsvd.hodlr:hodlr_solve", (b,), ("rows",),
                         dict(return_steps=True))])[0]
    build, mv, sol = res
    assert mv["out"]["placements"] == ["S(0)"]
    assert set(mv["tally"]) == {"all_reduce"}
    assert mv["tally"]["all_reduce"]["calls"] == 2     # levels 0 and 1
    no_whole_gather(sol["tally"], a)
    assert sol["out"][0]["placements"] == ["S(0)"]
    phodlr = _port("rsvd.hodlr")
    h = phodlr.hodlr_build(from_numpy(a), **HODLR_KW)
    y = phodlr.hodlr_matvec(h, from_numpy(x)).numpy()
    xs, steps = phodlr.hodlr_solve(h, from_numpy(b), return_steps=True)
    _close(mv["out"], y)
    _close(sol["out"][0], xs.numpy(), ITER_RTOL)
    np.testing.assert_array_equal(sol["out"][1], steps.numpy())
    _jax_hodlr_draws(monkeypatch)
    jh = _jax("rsvd.hodlr")
    hj = jh.hodlr_build(shard_rows8(mesh8, a), **HODLR_KW)
    h = phodlr.hodlr_build(from_numpy(a), **HODLR_KW)
    # JAX's matvec and solve take one vector: the block's first column
    xv, bv = (x[:, 0], b[:, 0]) if cols else (x, b)
    assert _rel(phodlr.hodlr_matvec(h, from_numpy(xv)).numpy(),
                jh.hodlr_matvec(hj, jnp.asarray(xv))) <= RTOL
    assert _rel(phodlr.hodlr_solve(h, from_numpy(bv)).numpy(),
                jh.hodlr_solve(hj, jnp.asarray(bv))) <= ITER_RTOL


def test_hodlr_levels_must_cover_the_ranks(ranks):
    """A leaf spanning ranks (2^levels not a multiple of P) raises."""
    got = ranks.run("raises", fn="rsvd.hodlr:hodlr_build",
                    args=(_kernel_spd(64, 4),), layouts=("rows",),
                    levels=1, k=4)
    for res in got:
        assert res["type"] == "ValueError" and "2^levels" in res["message"]


# --- apps/gp.py ------------------------------------------------------------------


def _gp_data(n=64, seed=5):
    g = np.random.default_rng(seed)
    x = g.random(n)                                  # unsorted: fit sorts
    return x[:, None], np.sin(6.0 * x) + 0.05 * g.standard_normal(n)


@pytest.mark.parametrize("solver, extra", [
    ("hodlr", {}), ("dense", {}), ("hodlr", dict(implicit_threshold=32))])
def test_gp_sharded(mesh8, ranks, monkeypatch, solver, extra):
    """Points and y row-sharded: the points gathered once and sorted,
    each rank building its rows of K (the implicit route asking only for
    blocks in its rows); (i) alpha row-sharded, the posterior mean and
    variance and the log-marginal-likelihood to 1e-8 (CG; the dense
    route's block substitutions), no gather but the points' (n x d) and
    the Lanczos blocks'; (ii) JAX's Omega, JAX's GP on mesh8."""
    x, y = _gp_data()
    xt = np.linspace(0.05, 0.95, 7)
    init = dict(noise=0.1, solver=solver, levels=2, rank=4, device="cpu",
                **extra)
    res = ranks.run("fit", cls="apps.gp:GP", args=(x, y),
                    layouts=("rows", "rows"), init=init, method="fit",
                    attrs=("alpha_", "solver_used_"), then=[
                        ("predict", (xt,), (None,), dict(return_var=True)),
                        ("log_marginal_likelihood", (), (),
                         dict(num_probes=4, steps=8))])[0]
    gp = _port("apps.gp").GP(**init).fit(from_numpy(x), from_numpy(y))
    assert res["attrs"]["solver_used_"] == gp.solver_used_
    assert ("implicit" in gp.solver_used_) == bool(extra)
    assert res["attrs"]["alpha_"]["placements"] == ["S(0)"]
    _close(res["attrs"]["alpha_"], gp.alpha_.numpy(), ITER_RTOL)
    mean, var = gp.predict(from_numpy(xt), return_var=True)
    _close(res["then"][0][0], mean.numpy(), ITER_RTOL)
    # the variance k_ss - k_*^T w cancels: held absolutely, as
    # tests/test_torch_hodlr_gp.py holds it
    np.testing.assert_allclose(res["then"][0][1], var.numpy(), rtol=0,
                               atol=ITER_RTOL)
    np.testing.assert_allclose(
        res["then"][1], gp.log_marginal_likelihood(num_probes=4, steps=8),
        rtol=ITER_RTOL)
    _jax_hodlr_draws(monkeypatch)
    jinit = {k: v for k, v in init.items() if k != "device"}
    gj = _jax("apps.gp").GP(**jinit).fit(shard_rows8(mesh8, x),
                                         shard_rows8(mesh8, y[:, None])[:, 0])
    gp = _port("apps.gp").GP(**init).fit(from_numpy(x), from_numpy(y))
    assert gp.solver_used_ == gj.solver_used_
    assert _rel(gp.alpha_.numpy(), gj.alpha_) <= ITER_RTOL
    mj, vj = gj.predict(jnp.asarray(xt), return_var=True)
    mean, var = gp.predict(from_numpy(xt), return_var=True)
    assert _rel(mean.numpy(), mj) <= ITER_RTOL
    np.testing.assert_allclose(var.numpy(), np.asarray(vj), rtol=0,
                               atol=ITER_RTOL)


# --- apps/cluster.py ----------------------------------------------------------


def _blobs(n=96, seed=6):
    g = np.random.default_rng(seed)
    centres = np.array([[0.0, 0.0], [4.0, 0.0], [0.0, 4.0]])
    return centres[np.arange(n) % 3] + 0.4 * g.standard_normal((n, 2))


def _jax_cluster_draws(monkeypatch):
    def first(seed, n, device):
        return from_numpy(np.asarray(jax.random.randint(
            jax.random.PRNGKey(seed), (), 0, n)))

    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    monkeypatch.setattr(_port("apps.cluster"), "_first_center", first)


@pytest.mark.parametrize("affinity", ["rbf", "knn", "precomputed"])
def test_spectral_cluster_sharded(mesh8, ranks, monkeypatch, affinity):
    """The affinity's rows local against the points gathered once (the
    median heuristic selected over the ranks by bits; knn's W^T by one
    all-to-all), the degrees gathered, reigh row-split, k-means' sums
    and counts all-reduced: (i) labels equal, the embedding row-sharded
    to 1e-9, centres and inertia to 1e-8; (ii) JAX's draws, JAX on
    mesh8."""
    pts = _blobs()
    arg = pts
    if affinity == "precomputed":
        d2 = np.sum((pts[:, None] - pts[None]) ** 2, axis=-1)
        arg = np.exp(-d2) * (1.0 - np.eye(len(pts)))
    kw = dict(n_clusters=3, affinity=affinity, eig_solver="randomized",
              seed=2, n_neighbors=8)
    fn = "apps.cluster:spectral_cluster"
    out, tally = sharded(ranks, fn, arg, **kw)
    if affinity == "precomputed":
        no_whole_gather(tally, arg)
    else:
        assert tally["all_gather"]["bytes"] <= 8 * pts.size + 8 * len(pts) \
            + tally["all_gather"]["calls"] * 8 * 2 * RANKS * 8
    assert out[0]["placements"] == out[1]["placements"] == ["S(0)"]
    want = single(fn, arg, **kw)
    np.testing.assert_array_equal(whole(out[0]), want[0])
    _close(out[1], want[1])
    _close(out[2], want[2], ITER_RTOL)
    np.testing.assert_allclose(out[3], want[3], rtol=ITER_RTOL)
    assert len(set(want[0].tolist())) == 3
    _jax_cluster_draws(monkeypatch)
    rj = _jax("apps.cluster").spectral_cluster(shard_rows8(mesh8, arg),
                                               **kw)
    got = single(fn, arg, **kw)
    np.testing.assert_array_equal(got[0], np.asarray(rj.labels))
    # each library signs its eigenvectors: the embedding's Gram compared
    emb = np.asarray(rj.embedding)
    assert _rel(got[1] @ got[1].T, emb @ emb.T) <= RTOL


def test_spectral_cluster_exact_refuses_a_sharded_graph(ranks):
    """The exact eigh needs the n x n operator whole: refused."""
    got = ranks.run("raises", fn="apps.cluster:spectral_cluster",
                    args=(_blobs(),), layouts=("rows",), n_clusters=3,
                    eig_solver="exact")
    for res in got:
        assert res["type"] == "ValueError" and "exact" in res["message"]


# --- linalg/incremental.py -----------------------------------------------------


def _snapshot_batches():
    g = np.random.default_rng(7)
    modes = np.linalg.qr(g.standard_normal((96, 5)))[0]
    return [modes @ (g.standard_normal((5, 6)) * (0.6 ** np.arange(5))
                     [:, None]) + 1e-4 * g.standard_normal((96, 6))
            for _ in range(3)]


@pytest.mark.parametrize("method", ["eigh", "eigh_pallas"])
def test_incremental_svd_sharded(mesh8, ranks, method):
    """Column batches row-sharded like U: U^T C and the Grams all-reduced,
    the residual's QR by rows, the small SVD replicated (K3 on the card
    under 'eigh_pallas'): (i) U row-sharded, s and V to 1e-9; (ii) JAX on
    mesh8."""
    c1, c2, c3 = _snapshot_batches()
    init = dict(rank=4, method=method)
    res = ranks.run("fit", cls="linalg.incremental:IncrementalSVD",
                    args=(c1,), layouts=("rows",), init=init,
                    method="update", then=[
                        ("update", (c2,), ("rows",)),
                        ("update", (c3,), (None,)),
                        ("factors", (), ())])[0]
    no_whole_gather(res["tally"], c1)
    u, s, v = res["then"][-1]
    assert u["placements"] == ["S(0)"]
    inc = _port("linalg.incremental").IncrementalSVD(**init)
    for c in (c1, c2, c3):
        inc.update(from_numpy(c))
    want = [t.numpy() for t in inc.factors()]
    np.testing.assert_allclose(s, want[1], rtol=DET_RTOL)
    assert _rel((whole(u) * s) @ v.T, (want[0] * want[1]) @ want[2].T) \
        <= DET_RTOL
    jinc = _jax("linalg.incremental").IncrementalSVD(**init)
    for c in (c1, c2, c3):
        jinc.update(shard_rows8(mesh8, c))
    uj, sj, vj = jinc.u, jinc.s, jinc.v
    bar = PALLAS_TOL if method == "eigh_pallas" else RTOL
    assert np.abs(want[1] - np.asarray(sj)).max() / want[1][0] <= bar
    assert _rel((want[0] * want[1]) @ want[2].T,
                (np.asarray(uj) * np.asarray(sj)) @ np.asarray(vj).T) <= bar


def test_svd_append_columns_sharded(mesh8, ranks):
    """U and C row-sharded: (i) U' row-sharded, s' and V' to 1e-9, only
    all-reduces; (ii) JAX on mesh8."""
    c1, c2, _ = _snapshot_batches()
    u, s, vt = np.linalg.svd(c1, full_matrices=False)
    u, s, v = u[:, :4], s[:4], vt[:4].T
    fn = "linalg.incremental:svd_append_columns"
    out, tally = sharded(ranks, fn, u, s, v, c2, layouts=("rows", None,
                                                           None, "rows"),
                         rank=5)
    assert set(tally) == {"all_reduce"}
    assert out[0]["placements"] == ["S(0)"]
    want = single(fn, u, s, v, c2, rank=5)
    np.testing.assert_allclose(out[1], want[1], rtol=DET_RTOL)
    assert _rel((whole(out[0]) * out[1]) @ out[2].T,
                (want[0] * want[1]) @ want[2].T) <= DET_RTOL
    uj, sj, vj = _jax("linalg.incremental").svd_append_columns(
        shard_rows8(mesh8, u), s, v, shard_rows8(mesh8, c2), rank=5)
    assert _rel(want[1], sj) <= RTOL
    assert _rel((want[0] * want[1]) @ want[2].T,
                (np.asarray(uj) * np.asarray(sj)) @ np.asarray(vj).T) <= RTOL


# --- rsvd/completion.py: complete_tucker ----------------------------------------


def test_complete_tucker_sharded(mesh8, ranks, monkeypatch):
    """Tensor and mask sharded on mode 0: the sharded Tucker each sweep,
    every sum over the iterates all-reduced; (i) U_0 row-sharded, core,
    factors and trace to 1e-8 (the sweeps); (ii) JAX's Omega and signs,
    JAX on mesh8."""
    g = np.random.default_rng(8)
    core = g.standard_normal((2, 2, 2))
    fac = [np.linalg.qr(g.standard_normal((n, 2)))[0] for n in (16, 6, 5)]
    t = np.einsum("abc,ia,jb,kc->ijk", core, *fac)
    mask = g.random(t.shape) < 0.7
    kw = dict(ranks=(2, 2, 2), iters=4, p=2, seed=3)
    fn = "rsvd.completion:complete_tucker"
    res = ranks.run("call", fn=fn, args=(t, mask),
                    layouts=("rows", "rows"), **kw)[0]
    out, tally = res["out"], res["tally"]
    no_whole_gather(tally, t)
    assert out[1][0]["placements"] == ["S(0)"]
    want = single(fn, t, mask, **kw)
    np.testing.assert_allclose(out[2], want[2], rtol=ITER_RTOL)
    _close(out[0], want[0], ITER_RTOL)
    for got, ref in zip(out[1], want[1]):
        _close(got, ref, ITER_RTOL)
    for module in ("rsvd.tucker", "rsvd._modewise"):
        monkeypatch.setattr(_port(module), "generate_omega", _jax_omega)
    monkeypatch.setattr(_port("rsvd._modewise"), "eigh", _jax_signed_eigh)
    res_j = _jax("rsvd.completion").complete_tucker(
        shard_rows8(mesh8, t), shard_rows8(mesh8, mask), **kw)
    got = single(fn, t, mask, **kw)
    assert _rel(got[2], res_j.obs_rmse) <= TUCKER_RTOL
    assert _rel(got[0], res_j.core) <= TUCKER_RTOL
    for mine, ref in zip(got[1], res_j.factors):
        assert _rel(mine, ref) <= TUCKER_RTOL
