"""Row-sharded operands through the port's public API beyond ``rsvd``,
part two: CCA, DMD, PCA, the sklearn-style estimators, kernel PCA and
its feature maps, and the tensor formats (Tucker, TT and CP on a tensor
sharded on mode 0).

The two checks of tests/test_torch_sharded_api.py: (i) the port on
P = 4 gloo ranks against the port's single-rank call, f64 deterministic
at rtol 1e-9 and the iterative CP sweeps at 1e-8, with no all-gather of
a block as large as the rank's block of the operand, kernel PCA's one
gather of its points X (n x d, the named exception: each row of K needs
every point) aside; (ii) the port's single call with the JAX package's
draws (and, for the tensor formats, JAX's eigenvector signs) patched in
against the JAX function on a row-sharded array of conftest's 8-device
mesh, at ``RTOL`` = 1e-10, or ``TUCKER_RTOL`` = 1e-9 for the tensor
formats.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.core.rng import (
    key_from_seed as jax_key_from_seed,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
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


def _data(n, f, seed):
    """n samples of f features, centred singular values geomspace(10, 1)
    (every gap a factor 1.2 or more), plus an offset."""
    g = np.random.default_rng(seed)
    u = np.linalg.qr(g.standard_normal((n, f)))[0]
    u -= u.mean(axis=0)
    w = np.linalg.qr(g.standard_normal((f, f)))[0]
    return (u * np.geomspace(10.0, 1.0, f)) @ w.T + g.standard_normal(f)


def _fit(ranks, cls, args, layouts, init=None, method=None, attrs=(),
         then=()):
    res = ranks.run("fit", cls=cls, args=args, layouts=layouts, init=init,
                    method=method, attrs=attrs, then=then)[0]
    return res


def _same_up_to_sign(got, want, tol):
    """Columns equal up to each column's sign, to ``tol`` of the max."""
    got, want = np.asarray(got), np.asarray(want)
    sign = np.where(np.sum(got * want, axis=0) < 0, -1.0, 1.0)
    assert np.abs(got * sign - want).max() <= tol * np.abs(want).max()


# --- rsvd/cca.py, rsvd/dmd.py -------------------------------------------------


def test_cca_sharded(mesh8, ranks):
    """Both views row-sharded on one mesh: the means merged, the three
    covariances all-reduced; (i) 1e-9, only all-reduces and the means'
    partials; (ii) JAX on mesh8 (the exact branch: no draws)."""
    g = np.random.default_rng(3)
    z = g.standard_normal((96, 3))
    x = z @ g.standard_normal((3, 10)) + 0.5 * g.standard_normal((96, 10))
    y = z @ g.standard_normal((3, 7)) + 0.5 * g.standard_normal((96, 7))
    kw = dict(k=3, reg=1e-6)
    fn = "rsvd.cca:cca"
    out, tally = sharded(ranks, fn, x, y, layouts=("rows", "rows"), **kw)
    no_whole_gather(tally, x)
    want = single(fn, x, y, **kw)
    for got, ref in zip(out, want):
        np.testing.assert_allclose(got, ref, rtol=DET_RTOL, atol=1e-12)
    res_j = _jax("rsvd.cca").cca(shard_rows8(mesh8, x),
                                 shard_rows8(mesh8, y), **kw)
    assert _rel(want[0], res_j.correlations) <= RTOL
    _same_up_to_sign(want[1], res_j.x_weights, RTOL)
    _same_up_to_sign(want[2], res_j.y_weights, RTOL)


def test_dmd_sharded(mesh8, ranks, monkeypatch):
    """Snapshots row-sharded: the modes come back row-sharded (complex),
    the eigenvalues and amplitudes replicated: (i) 1e-9, the k-wide panel
    and the first snapshot the only gathers; (ii) JAX's Omega, JAX on
    mesh8."""
    g = np.random.default_rng(4)
    modes = g.standard_normal((96, 4))
    lam = np.array([0.99, 0.95, 0.9, 0.8])
    snaps = modes @ (lam[:, None] ** np.arange(21)[None, :]) \
        + 1e-6 * g.standard_normal((96, 21))
    kw = dict(k=4, p=6, seed=2)
    fn = "rsvd.dmd:dmd"
    out, tally = sharded(ranks, fn, snaps, **kw)
    no_whole_gather(tally, snaps)
    assert out[0]["placements"] == ["S(0)"]
    want = single(fn, snaps, **kw)
    np.testing.assert_allclose(out[0]["whole"], want[0], rtol=DET_RTOL,
                               atol=1e-12)
    for got, ref in zip(out[1:5], want[1:5]):
        np.testing.assert_allclose(got, ref, rtol=DET_RTOL)
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    res_j = _jax("rsvd.dmd").dmd(shard_rows8(mesh8, snaps), **kw)
    got = single(fn, snaps, **kw)
    order = np.argsort(np.angle(got[1]) + 10 * np.abs(got[1]))
    order_j = np.argsort(np.angle(res_j.eigs) + 10 * np.abs(res_j.eigs))
    assert _rel(got[1][order], res_j.eigs[order_j]) <= RTOL
    assert _rel(got[4], res_j.singular_values) <= RTOL
    rec = (got[0] * got[3]) @ np.ones(4)
    rec_j = (res_j.modes * res_j.amplitudes) @ np.ones(4)
    assert _rel(rec, rec_j) <= RTOL


# --- apps/pca.py ----------------------------------------------------------------


@pytest.mark.parametrize("init", [
    {}, {"normalize": True}, {"use_rsvd": True, "rank": 4},
    {"method": "eigh"}, {"method": "jacobi"}, {"method": "xla"},
    {"method": "power", "rank": 3}])
def test_pca_sharded(mesh8, ranks, monkeypatch, init):
    """Every ``SVDMethod`` on row-sharded data (the Jacobi engines, 'xla'
    and 'power' on the R factor of the row-split thin QR, the Gram
    engine on the all-reduced Gram, ``use_rsvd`` through the sharded
    rsvd): (i) s, V and the scores (row-sharded) to 1e-9; (ii) JAX's
    PCA on mesh8 with the same method, s to RTOL, V up to sign."""
    x = _data(96, 12, seed=5)
    res = _fit(ranks, "apps.pca:PCA", (x,), ("rows",), init=init,
               attrs=("getS", "getV", "scores", "explained_variance_ratio",
                      "mean"), then=[("project", (x[:16],), ("rows",))])
    no_whole_gather(res["tally"], x)
    got = res["attrs"]
    assert got["scores"]["placements"] == ["S(0)"]
    pca = _port("apps.pca").PCA(from_numpy(x), device="cpu", **init)
    want = [to_numpy(t) for t in (pca.getS(), pca.getV(), pca.scores(),
                                  pca.explained_variance_ratio(), pca.mean)]
    np.testing.assert_allclose(got["getS"], want[0], rtol=DET_RTOL)
    _same_up_to_sign(got["getV"], want[1], DET_RTOL)
    _same_up_to_sign(got["scores"]["whole"], want[2], DET_RTOL)
    np.testing.assert_allclose(got["explained_variance_ratio"], want[3],
                               rtol=DET_RTOL)
    np.testing.assert_allclose(got["mean"], want[4], rtol=1e-12)
    assert res["then"][0]["placements"] == ["S(0)"]
    _same_up_to_sign(res["then"][0]["whole"],
                     to_numpy(pca.project(from_numpy(x[:16]))), DET_RTOL)
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    pj = _jax("apps.pca").PCA(shard_rows8(mesh8, x), **init)
    pt = _port("apps.pca").PCA(from_numpy(x), device="cpu", **init)
    assert _rel(to_numpy(pt.getS()), pj.getS()) <= RTOL
    _same_up_to_sign(to_numpy(pt.getV()), pj.getV(), RTOL)


# --- apps/estimators.py -------------------------------------------------------


@pytest.mark.parametrize("cls, init", [
    ("RandomizedSVD", {}), ("RandomizedPCA", {}),
    ("RandomizedPCA", {"scale": True})])
def test_estimators_sharded(mesh8, ranks, monkeypatch, cls, init):
    """fit_transform, transform and inverse_transform on row-sharded X
    (the scores row-sharded, the fitted attributes replicated): (i)
    1e-9; (ii) JAX's Omega, JAX's estimator on mesh8."""
    x = _data(96, 12, seed=6)
    init = dict(n_components=4, q=2, device="cpu", **init)
    names = ["components_", "singular_values_", "explained_variance_",
             "explained_variance_ratio_"]
    if cls == "RandomizedPCA":
        names += ["mean_", "noise_variance_"]
    est = getattr(_port("apps.estimators"), cls)(**init)
    z = est.fit_transform(from_numpy(x))
    res = _fit(ranks, "apps.estimators:" + cls, (x,), ("rows",), init=init,
               method="fit_transform", attrs=names,
               then=[("transform", (x,), ("rows",)),
                     ("inverse_transform", (z,), ("rows",))])
    no_whole_gather(res["tally"], x)
    assert res["out"]["placements"] == ["S(0)"]
    np.testing.assert_allclose(res["out"]["whole"], z, rtol=DET_RTOL,
                               atol=1e-12)
    for name in names:
        np.testing.assert_allclose(res["attrs"][name], getattr(est, name),
                                   rtol=DET_RTOL, atol=1e-12)
    for got, ref in zip(res["then"], (est.transform(x),
                                      est.inverse_transform(z))):
        assert got["placements"] == ["S(0)"]
        np.testing.assert_allclose(got["whole"], ref, rtol=DET_RTOL,
                                   atol=1e-12)
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    kw = {k: v for k, v in init.items() if k != "device"}
    jx = getattr(_jax("apps.estimators"), cls)(**kw)
    jx.fit_transform(shard_rows8(mesh8, x))
    ours = getattr(_port("apps.estimators"), cls)(**init)
    ours.fit_transform(from_numpy(x))
    s, sj = ours.singular_values_, np.asarray(jx.singular_values_)
    assert np.abs(s - sj).max() <= RTOL * sj[0]
    _same_up_to_sign(ours.components_.T, np.asarray(jx.components_).T,
                     RTOL)
    np.testing.assert_allclose(ours.explained_variance_ratio_,
                               jx.explained_variance_ratio_, atol=1e-12)


# --- apps/kpca.py ---------------------------------------------------------------


def _rings(n, seed):
    g = np.random.default_rng(seed)
    t = g.random(n) * 2 * np.pi
    r = np.where(np.arange(n) % 2, 1.0, 2.5) + 0.05 * g.standard_normal(n)
    return np.stack([r * np.cos(t), r * np.sin(t)], axis=1)


@pytest.mark.parametrize("solver, p", [("randomized", 16),
                                       ("nystrom", 64)])
def test_kernel_pca_sharded(mesh8, ranks, monkeypatch, solver, p):
    """X gathered once (the named exception), K kept row-split, its
    centring means merged and K^T read by one all-to-all: (i)
    eigenvalues, alphas and scores (row-sharded) and a transform to
    1e-9; no gather as large as a rank's rows of K; (ii) JAX's Omega,
    JAX's KernelPCA on mesh8."""
    x = _rings(128, seed=7)
    y = _rings(16, seed=8)
    init = dict(n_components=4, kernel="rbf", gamma=0.8, solver=solver,
                p=p, seed=1)
    res = _fit(ranks, "apps.kpca:KernelPCA", (x,), ("rows",),
               init=dict(init, device="cpu"), method="fit",
               attrs=("eigenvalues_", "alphas_", "scores_"),
               then=[("transform", (y,), (None,)),
                     ("transform", (y,), ("rows",))])
    tally = res["tally"]
    assert tally["all_gather"]["bytes"] >= x.nbytes / RANKS   # X, once
    assert tally["all_to_all"]["calls"] == 1                  # K^T
    no_whole_gather(tally, np.empty((128, 128)))
    kp = _port("apps.kpca").KernelPCA(**init, device="cpu").fit(
        from_numpy(x))
    got = res["attrs"]
    assert got["alphas_"]["placements"] == ["S(0)"]
    np.testing.assert_allclose(got["eigenvalues_"],
                               to_numpy(kp.eigenvalues_), rtol=DET_RTOL)
    for name in ("alphas_", "scores_"):
        _same_up_to_sign(got[name]["whole"], to_numpy(getattr(kp, name)),
                         DET_RTOL)
    z = to_numpy(kp.transform(from_numpy(y)))
    _same_up_to_sign(res["then"][0], z, DET_RTOL)
    assert res["then"][1]["placements"] == ["S(0)"]
    _same_up_to_sign(res["then"][1]["whole"], z, DET_RTOL)
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    jx = _jax("apps.kpca").KernelPCA(**init).fit(shard_rows8(mesh8, x))
    ours = _port("apps.kpca").KernelPCA(**init, device="cpu").fit(
        from_numpy(x))
    assert _rel(to_numpy(ours.eigenvalues_), jx.eigenvalues_) <= RTOL
    _same_up_to_sign(to_numpy(ours.alphas_), np.asarray(jx.alphas_), RTOL)


def test_feature_maps_sharded(mesh8, ranks, monkeypatch):
    """nystrom_features and rff_features of row-sharded points come back
    row-sharded with no collective: (i) 1e-9; (ii) JAX's RFF draws,
    JAX on mesh8."""
    x = _rings(96, seed=9)
    land = x[::8]
    for fn, args, kw in (
            ("apps.kpca:nystrom_features", (x, land), dict(gamma=0.7)),
            ("apps.kpca:rff_features", (x,), dict(n_features=32,
                                                  gamma=0.7, seed=3))):
        out, tally = sharded(ranks, fn, *args, **kw)
        assert tally == {} and out["placements"] == ["S(0)"]
        np.testing.assert_allclose(out["whole"], single(fn, *args, **kw),
                                   rtol=DET_RTOL, atol=1e-12)

    def rff(seed, d, n_features, dtype, device):
        kw_, kb = jax.random.split(jax_key_from_seed(seed))
        return (from_numpy(np.asarray(jax.random.normal(
            kw_, (d, n_features), jnp.float64))),
            from_numpy(np.asarray(jax.random.uniform(
                kb, (n_features,), jnp.float64, 0.0, 2.0 * jnp.pi))))
    monkeypatch.setattr(_port("apps.kpca"), "_rff_draws", rff)
    jkp = _jax("apps.kpca")
    assert _rel(single("apps.kpca:rff_features", x, n_features=32,
                       gamma=0.7, seed=3),
                jkp.rff_features(shard_rows8(mesh8, x), n_features=32,
                                 gamma=0.7, seed=3)) <= RTOL
    # the landmark eigh's eigenvectors are signed as each library signs
    # them: the feature Gram z z^T, the kernel estimate, is compared
    z = single("apps.kpca:nystrom_features", x, land, gamma=0.7)
    zj = np.asarray(jkp.nystrom_features(shard_rows8(mesh8, x),
                                         jnp.asarray(land), gamma=0.7))
    assert _rel(z @ z.T, zj @ zj.T) <= RTOL


# --- rsvd/tucker.py, rsvd/tt.py, rsvd/cp.py ----------------------------------


def _planted(shape, ranks_, seed, noise=1e-3):
    g = np.random.default_rng(seed)
    core = g.standard_normal(ranks_)
    t = core
    for mode, n in enumerate(shape):
        u = np.linalg.qr(g.standard_normal((n, ranks_[mode])))[0]
        t = np.moveaxis(np.tensordot(u, np.moveaxis(t, mode, 0), axes=1),
                        0, mode)
    return t + noise * np.linalg.norm(t) / np.sqrt(t.size) \
        * g.standard_normal(shape)


def _format_draws(monkeypatch):
    for module in ("rsvd.tucker", "rsvd._modewise", "rsvd.tt", "rsvd.cp"):
        monkeypatch.setattr(_port(module), "generate_omega", _jax_omega)
    monkeypatch.setattr(_port("rsvd._modewise"), "eigh", _jax_signed_eigh)


def test_tucker_adaptive_sharded(mesh8, ranks, monkeypatch):
    """Sharded on mode 0: the same ranks (the rule reads each mode's
    spectrum on the host), core and factors to 1e-9, U_0 row-sharded;
    (ii) JAX's Omega and signs, JAX on mesh8."""
    t = _planted((32, 12, 10), (4, 3, 3), seed=10)
    kw = dict(tol=1e-2, p=4, seed=2)
    fn = "rsvd.tucker:tucker_adaptive"
    out, tally = sharded(ranks, fn, t, **kw)
    no_whole_gather(tally, t)
    want = single(fn, t, **kw)
    assert tuple(out[2]) == tuple(want[2]) == (4, 3, 3)
    assert out[1][0]["placements"] == ["S(0)"]
    np.testing.assert_allclose(out[0], want[0], rtol=DET_RTOL, atol=1e-12)
    for got, ref in zip(out[1], want[1]):
        np.testing.assert_allclose(whole(got), ref, rtol=DET_RTOL,
                                   atol=1e-12)
    _format_draws(monkeypatch)
    core_j, f_j, r_j = _jax("rsvd.tucker").tucker_adaptive(
        shard_rows8(mesh8, t), **kw)
    core_t, f_t, r_t = single(fn, t, **kw)
    assert tuple(r_t) == tuple(r_j)
    assert _rel(core_t, core_j) <= TUCKER_RTOL
    for got, ref in zip(f_t, f_j):
        assert _rel(got, ref) <= TUCKER_RTOL


@pytest.mark.parametrize("name, arg", [("tt_decompose", (3, 3, 2)),
                                      ("tt_adaptive", 1e-2)])
def test_tt_sharded(mesh8, ranks, monkeypatch, name, arg):
    """Sharded on mode 0: the first unfolding row-split, the cores after
    it replicated, the first core sharded on n_0; (i) 1e-9; (ii) JAX's
    Omega and signs.  ``arg`` is the internal ranks or the tolerance."""
    t = _planted((16, 6, 5, 4), (3, 3, 2, 2), seed=11)
    kw = dict(p=4, seed=3)
    fn = "rsvd.tt:" + name
    out, tally = sharded(ranks, fn, t, arg, **kw)
    no_whole_gather(tally, t)
    want = single(fn, t, arg, **kw)
    cores, cores_w = (out, want) if name == "tt_decompose" else \
        (out[0], want[0])
    assert cores[0]["placements"] == ["S(1)"]
    for got, ref in zip(cores, cores_w):
        np.testing.assert_allclose(whole(got), ref, rtol=DET_RTOL,
                                   atol=1e-12)
    _format_draws(monkeypatch)
    got_j = getattr(_jax("rsvd.tt"), name)(shard_rows8(mesh8, t), arg,
                                           **kw)
    got_t = single(fn, t, arg, **kw)
    cores_j, cores_t = (got_j, got_t) if name == "tt_decompose" else \
        (got_j[0], got_t[0])
    for got, ref in zip(cores_t, cores_j):
        assert _rel(got, ref) <= TUCKER_RTOL


def test_tt_and_tucker_reconstruct_sharded(ranks):
    """A row-sharded first factor (Tucker's U_0, TT's first core) gives
    the reconstruction sharded on mode 0, to 1e-9 of the single call."""
    t = _planted((16, 6, 5), (3, 3, 2), seed=12)
    out, _ = sharded(ranks, "rsvd.tt:tt_decompose", t, (3, 2))
    cores = single("rsvd.tt:tt_decompose", t, (3, 2))
    np.testing.assert_allclose(
        whole(out[0]), cores[0], rtol=DET_RTOL, atol=1e-12)
    core, factors = single("rsvd.tucker:tucker", t, (3, 3, 2))
    rec = single("rsvd.tucker:tucker_reconstruct", core,
                 tuple(torch.from_numpy(f) for f in factors))
    rec_tt = single("rsvd.tt:tt_reconstruct",
                    tuple(torch.from_numpy(c) for c in cores))
    res = ranks.run("call", fn="rsvd.tucker:tucker", args=(t, (3, 3, 2)),
                    layouts=("rows",))[0]["out"]
    np.testing.assert_allclose(res[0], core, rtol=DET_RTOL, atol=1e-12)
    assert res[1][0]["placements"] == ["S(0)"]
    assert np.abs(rec - t).max() < 1e-2 and np.abs(rec_tt - t).max() < 1e-2


@pytest.mark.parametrize("method", ["als", "rand"])
def test_cp_sharded(mesh8, ranks, monkeypatch, method):
    """Sharded on mode 0: mode 0's MTTKRP local, the others' partial sums
    all-reduced, CPRAND's fibers drawn whole; (i) weights and factors to
    1e-8 (iterative), F_1 row-sharded, the reconstruction sharded on
    mode 0; (ii) JAX's Omega, signs and fibers, JAX on mesh8 at 1e-8."""
    t = _planted((16, 10, 8), (3, 3, 3), seed=13, noise=1e-4)
    kw = dict(rank=3, iters=15, seed=4, method=method)
    fn = "rsvd.cp:cp_decompose"
    out, tally = sharded(ranks, fn, t, **kw)
    no_whole_gather(tally, t)
    want = single(fn, t, **kw)
    assert out[1][0]["placements"] == ["S(0)"]
    np.testing.assert_allclose(out[0], want[0], rtol=ITER_RTOL)
    for got, ref in zip(out[1], want[1]):
        np.testing.assert_allclose(whole(got), ref, rtol=ITER_RTOL,
                                   atol=1e-10)
    _format_draws(monkeypatch)
    s = max(min(4 * 3 + 64, t.size // min(t.shape)), 3)
    key0 = jax.random.fold_in(jax.random.PRNGKey(4), 12345)
    table = {}
    for it in range(15):
        for i in range(3):
            key = jax.random.fold_in(jax.random.fold_in(key0, it), i)
            ks = jax.random.split(key, 2)
            others = [j for j in range(3) if j != i]
            table[it, i] = [torch.from_numpy(np.asarray(jax.random.randint(
                ks[n], (s,), 0, t.shape[j])).astype(np.int64))
                for n, j in enumerate(others)]
    monkeypatch.setattr(_port("rsvd.cp"), "_fiber_indices",
                        lambda key0, it, i, shape, n: table[it, i])
    w_j, f_j = _jax("rsvd.cp").cp_decompose(shard_rows8(mesh8, t), **kw)
    w_t, f_t = single(fn, t, **kw)
    assert _rel(w_t, w_j) <= ITER_RTOL
    for got, ref in zip(f_t, f_j):
        assert _rel(got, ref) <= ITER_RTOL
