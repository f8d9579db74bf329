"""``PCA.add_data`` on row-sharded data and the exact ``KernelPCA`` solver
on a sharded fit (the JAX package concatenates the sharded data and
refits; its ``jnp.linalg.eigh`` of a sharded K runs replicated).

The two checks of tests/test_torch_sharded_api.py: (i) the port on
P = 4 gloo ranks against the port's single-rank call at rtol 1e-9, with
the collectives each step issued; (ii) the port on the four ranks, JAX's
draws handed to them where a call draws, against the JAX function on a
row-sharded array of conftest's 8-device mesh: s and eigenvalues by
relative error at 1e-9, components by the sines of their principal
angles at 1e-9, scores in the global row order up to each column's
sign.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.rsvd import driver as jdriver
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy

from _torch_sharded import (  # noqa: F401 -- fixtures by name
    RANKS,
    _jax,
    _one_torch_thread,
    _port,
    _rel,
    from_numpy,
    no_whole_gather,
    ranks,
    shard_rows8,
)

RTOL = 1e-9


def _data(n, f, seed):
    """n samples of f features, centred singular values geomspace(10, 1),
    plus an offset (tests/test_torch_sharded_api_apps.py's)."""
    g = np.random.default_rng(seed)
    u = np.linalg.qr(g.standard_normal((n, f)))[0]
    u -= u.mean(axis=0)
    w = np.linalg.qr(g.standard_normal((f, f)))[0]
    return (u * np.geomspace(10.0, 1.0, f)) @ w.T + g.standard_normal(f)


def _sines(x, y):
    qx, _ = np.linalg.qr(np.asarray(x))
    qy, _ = np.linalg.qr(np.asarray(y))
    return np.linalg.svd(qy - qx @ (qx.T @ qy), compute_uv=False)


def _same_up_to_sign(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    sign = np.where(np.sum(got * want, axis=0) < 0, -1.0, 1.0)
    assert np.abs(got * sign - want).max() <= tol * np.abs(want).max()


# --- apps/pca.py: add_data ----------------------------------------------------


@pytest.mark.parametrize("init, new_rows, layout", [
    ({}, 16, "rows"), ({}, 20, None),
    ({"normalize": True}, 16, "rows"),
    ({"use_rsvd": True, "rank": 4}, 32, "rows")])
def test_pca_add_data_sharded(mesh8, ranks, init, new_rows, layout):
    """New rows as a DTensor on the same mesh or whole on every rank
    (20 rows: the refit's 116 rows divide the ranks, the new ones do
    not); the data's global order [X; Y], one all-to-all and no gather
    in add_data: (i) s, V and the scores to 1e-9 of the port's single
    ``PCA(X).add_data(Y)``; (ii) JAX's ``PCA(X).add_data(Y)`` on mesh8,
    its Omega handed to the ranks for ``use_rsvd``."""
    x = _data(96, 12, seed=21)
    y = _data(new_rows, 12, seed=22)
    draws = None
    if init.get("use_rsvd"):
        draws = {"rsvd.driver:generate_omega": [np.asarray(
            jdriver.generate_omega(0, 12, 14, jnp.float64))] * 2}
    res = ranks.run("fit", cls="apps.pca:PCA", args=(x,), layouts=("rows",),
                    init=init, draws=draws,
                    then=[("add_data", (y,), (layout,)),
                          ("getS", (), ()), ("getV", (), ()),
                          ("scores", (), ())])[0]
    add_tally = res["then_tally"][0]
    assert add_tally["all_to_all"]["calls"] == 1
    no_whole_gather(add_tally, np.concatenate([x, y]))
    s, v, scores = res["then"][1:]
    assert scores["placements"] == ["S(0)"]
    pca = _port("apps.pca").PCA(from_numpy(x), device="cpu", **init)
    pca.add_data(from_numpy(y))
    np.testing.assert_allclose(s, to_numpy(pca.getS()), rtol=RTOL)
    _same_up_to_sign(v, to_numpy(pca.getV()), RTOL)
    _same_up_to_sign(scores["whole"], to_numpy(pca.scores()), RTOL)
    pj = _jax("apps.pca").PCA(shard_rows8(mesh8, x), **init)
    pj.add_data(jnp.asarray(y))
    assert _rel(s, pj.getS()) <= RTOL
    k = 4 if init.get("use_rsvd") else 11            # the nonzero s
    assert _sines(v[:, :k], np.asarray(pj.getV())[:, :k]).max() <= RTOL
    _same_up_to_sign(scores["whole"][:, :k],
                     np.asarray(pj.scores())[:, :k], RTOL)


# --- apps/kpca.py: the exact solver -------------------------------------------


def _rings(n, seed):
    g = np.random.default_rng(seed)
    t = g.random(n) * 2 * np.pi
    r = np.where(np.arange(n) % 2, 1.0, 2.5) + 0.05 * g.standard_normal(n)
    return np.stack([r * np.cos(t), r * np.sin(t)], axis=1)


@pytest.mark.parametrize("solver", ["exact", "auto"])
def test_kernel_pca_exact_sharded(mesh8, ranks, solver):
    """'exact', and 'auto' at n = 128 <= 1024: X gathered once and the
    centred K (n x n) once (besides the centring means' small partials),
    the eigh replicated, alphas and scores
    row-sharded: (i) eigenvalues, alphas, scores and a transform to 1e-9
    of the port's single fit; (ii) JAX's KernelPCA on mesh8, the
    eigenvalues to 1e-9."""
    x = _rings(128, seed=7)
    y = _rings(16, seed=8)
    init = dict(n_components=8, kernel="rbf", gamma=0.8, solver=solver)
    res = ranks.run("fit", cls="apps.kpca:KernelPCA", args=(x,),
                    layouts=("rows",), init=dict(init, device="cpu"),
                    method="fit",
                    attrs=("eigenvalues_", "alphas_", "scores_"),
                    then=[("transform", (y,), ("rows",))])[0]
    gather = res["tally"]["all_gather"]               # X and K, once each,
    whole = (x.nbytes + 128 * 128 * 8) // RANKS       # and the means' pairs
    assert whole <= gather["bytes"] <= whole + 64 * gather["calls"] * 8
    kp = _port("apps.kpca").KernelPCA(**init, device="cpu").fit(
        from_numpy(x))
    got = res["attrs"]
    assert got["alphas_"]["placements"] == ["S(0)"]
    np.testing.assert_allclose(got["eigenvalues_"],
                               to_numpy(kp.eigenvalues_), rtol=RTOL)
    for name in ("alphas_", "scores_"):
        _same_up_to_sign(got[name]["whole"], to_numpy(getattr(kp, name)),
                         RTOL)
    assert res["then"][0]["placements"] == ["S(0)"]
    _same_up_to_sign(res["then"][0]["whole"],
                     to_numpy(kp.transform(from_numpy(y))), RTOL)
    jx = _jax("apps.kpca").KernelPCA(**init).fit(shard_rows8(mesh8, x))
    assert _rel(got["eigenvalues_"], jx.eigenvalues_) <= RTOL
