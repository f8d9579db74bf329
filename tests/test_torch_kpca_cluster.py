"""The port's kernel PCA (``apps/kpca.py``) and spectral clustering
(``apps/cluster.py``) against the JAX package's, on the CPU in f64.

JAX's draws are patched into the port's: Omega (``generate_omega``, for
the 'randomized' and 'nystrom' solvers and ``reigh``), the random
Fourier features' (W, b) (``kpca._rff_draws``) and k-means' first
centre (``cluster._first_center``).  Then kernels equal JAX's (and
sklearn's) to 1e-10 relative, eigenvalues to ``RTOL`` = 1e-9 of the
largest, scores up to each component's sign and embeddings up to a
rotation of their eigenspace (a sign flip where no eigenvalue repeats)
to 1e-8 of their largest entry, and cluster labels exactly (a rotation
of the embedding moves every point and centre alike).  Each JAX test's
own bar (tests/test_kpca.py, tests/test_cluster.py) is held on the port
too."""

import functools
from itertools import permutations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.apps import cluster as jcl
from rsvd_kamaneh_raganato_terrana_tpu.apps import kpca as jkp
from rsvd_kamaneh_raganato_terrana_tpu.core.rng import (
    key_from_seed as jax_key_from_seed,
)
from rsvd_kamaneh_raganato_terrana_tpu.rsvd.driver import (
    generate_omega as jax_generate_omega,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import cluster as tcl
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import kpca as tkp
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdrv

from_numpy = functools.partial(convert.from_numpy, device="cpu")
RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def jax_draws(monkeypatch):
    def omega(key_or_seed, n, l, dtype=torch.float64, kind="gaussian",
              device=None):
        return from_numpy(np.asarray(jax_generate_omega(
            key_or_seed, n, l, jnp.float64, kind)), dtype=dtype)

    def rff(seed, d, n_features, dtype, device):
        kw, kb = jax.random.split(jax_key_from_seed(seed))
        w0 = jax.random.normal(kw, (d, n_features), jnp.float64)
        b = jax.random.uniform(kb, (n_features,), jnp.float64, 0.0,
                               2.0 * jnp.pi)
        return from_numpy(np.asarray(w0)), from_numpy(np.asarray(b))

    def first(seed, n, device):
        return torch.tensor(int(jax.random.randint(
            jax.random.PRNGKey(seed), (), 0, n)))

    monkeypatch.setattr(tdrv, "generate_omega", omega)
    monkeypatch.setattr(tkp, "_rff_draws", rff)
    monkeypatch.setattr(tcl, "_first_center", first)


def _two_rings(n, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    r = np.where(np.arange(n) % 2 == 0, 1.0, 3.0)
    pts = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
    return pts + 0.05 * rng.standard_normal((n, 2))


def _same_up_to_sign(got, want, tol=1e-8):
    scale = np.abs(want).max()
    for j in range(want.shape[1]):
        d = min(np.abs(got[:, j] - want[:, j]).max(),
                np.abs(got[:, j] + want[:, j]).max())
        assert d <= tol * scale, (j, d)


def _same_up_to_rotation(got, want, tol=1e-8):
    """got R = want for an orthogonal R (Procrustes): embeddings of a
    repeated eigenvalue (a graph of several components) are fixed only up
    to a rotation of their eigenspace, and k-means is blind to it."""
    w, _, vt = np.linalg.svd(got.T @ want)
    assert np.abs(got @ (w @ vt) - want).max() <= tol * np.abs(want).max()


def _eigs_close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * abs(want[0])


# -- kernel PCA --------------------------------------------------------------

@pytest.mark.parametrize("kernel,kw", [
    ("rbf", dict(gamma=0.7)),
    ("linear", {}),
    ("poly", dict(gamma=0.5, degree=2, coef0=1.5)),
])
def test_kernel_matrix_matches_jax_and_sklearn(kernel, kw):
    from sklearn.metrics.pairwise import pairwise_kernels

    rng = np.random.default_rng(1)
    x, y = rng.standard_normal((40, 5)), rng.standard_normal((25, 5))
    got = to_numpy(tkp.kernel_matrix(x, y, kernel, device="cpu", **kw))
    np.testing.assert_allclose(got, np.asarray(jkp.kernel_matrix(
        x, y, kernel, **kw)), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got, pairwise_kernels(
        x, y, metric=kernel, **kw), rtol=1e-10, atol=1e-12)


def test_exact_matches_jax_and_sklearn():
    from sklearn.decomposition import KernelPCA as SkKPCA

    x = _two_rings(120, seed=2)
    ours = tkp.KernelPCA(4, kernel="rbf", gamma=0.8, solver="exact",
                         device="cpu").fit(x)
    jx = jkp.KernelPCA(4, kernel="rbf", gamma=0.8, solver="exact").fit(x)
    sk = SkKPCA(n_components=4, kernel="rbf", gamma=0.8).fit(x)
    lam = to_numpy(ours.eigenvalues_)
    _eigs_close(lam, np.asarray(jx.eigenvalues_))
    np.testing.assert_allclose(lam, sk.eigenvalues_, rtol=1e-6)
    _same_up_to_sign(to_numpy(ours.scores_), np.asarray(jx.scores_))
    _same_up_to_sign(to_numpy(ours.scores_), sk.transform(x), tol=1e-6)


def test_transform_of_train_equals_scores():
    x = _two_rings(80, seed=3)
    kp = tkp.KernelPCA(3, kernel="rbf", gamma=0.5, solver="exact",
                       device="cpu").fit(x)
    np.testing.assert_allclose(to_numpy(kp.transform(x)),
                               to_numpy(kp.scores_), rtol=1e-5, atol=1e-8)


def test_transform_of_the_jax_fit_matches_jax():
    """``kpca_from_jax``: the port's transform on a JAX fit's state
    equals the JAX transform."""
    x = _two_rings(90, seed=6)
    y = _two_rings(30, seed=7)
    jx = jkp.KernelPCA(3, kernel="poly", gamma=0.3, degree=2,
                       solver="exact").fit(x)
    kp = convert.kpca_from_jax(jx, device="cpu")
    np.testing.assert_allclose(to_numpy(kp.transform(y)),
                               np.asarray(jx.transform(y)), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_array_equal(to_numpy(kp.scores_),
                                  np.asarray(jx.scores_))


@pytest.mark.parametrize("solver, p, bar", [("randomized", 16, 1e-5),
                                            ("nystrom", 64, 1e-2)])
def test_sketched_solvers_match_jax_and_exact(solver, p, bar):
    x = _two_rings(200, seed=4)
    exact = tkp.KernelPCA(4, kernel="rbf", gamma=0.8, solver="exact",
                          device="cpu").fit(x)
    ours = tkp.KernelPCA(4, kernel="rbf", gamma=0.8, solver=solver, p=p,
                         device="cpu").fit(x)
    jx = jkp.KernelPCA(4, kernel="rbf", gamma=0.8, solver=solver,
                       p=p).fit(x)
    _eigs_close(to_numpy(ours.eigenvalues_), np.asarray(jx.eigenvalues_))
    _same_up_to_sign(to_numpy(ours.alphas_), np.asarray(jx.alphas_))
    np.testing.assert_allclose(to_numpy(ours.eigenvalues_),
                               to_numpy(exact.eigenvalues_), rtol=bar)
    if solver == "randomized":
        overlap = np.abs(np.diag(to_numpy(exact.alphas_).T
                                 @ to_numpy(ours.alphas_)))
        assert overlap.min() > 0.999


def test_rings_separate_in_kernel_space():
    x = _two_rings(150, seed=5)
    labels = np.arange(150) % 2
    z0 = to_numpy(tkp.KernelPCA(1, kernel="rbf", gamma=0.5,
                                device="cpu").fit(x).scores_)[:, 0]
    thr = np.median(z0)
    acc = max(np.mean((z0 > thr) == labels), np.mean((z0 > thr) != labels))
    assert acc > 0.95


def test_rank_deficient_components_are_zero():
    x = np.random.default_rng(8).standard_normal((30, 2))
    kp = tkp.KernelPCA(10, kernel="linear", solver="exact",
                       device="cpu").fit(x)
    lam = to_numpy(kp.eigenvalues_)
    assert np.all(lam[3:] == 0.0)
    z = to_numpy(kp.transform(x[:5]))
    assert np.all(np.isfinite(z))
    assert np.abs(z[:, 3:]).max() == 0.0
    assert np.abs(z[:, :2]).max() > 0.1
    jx = jkp.KernelPCA(10, kernel="linear", solver="exact").fit(x)
    np.testing.assert_array_equal(lam == 0.0,
                                  np.asarray(jx.eigenvalues_) == 0.0)


def test_unknown_kernel_or_solver_raises():
    x = _two_rings(30)
    with pytest.raises(ValueError):
        tkp.KernelPCA(2, kernel="sigmoidish", device="cpu").fit(x)
    with pytest.raises(ValueError):
        tkp.KernelPCA(2, solver="magic", device="cpu").fit(x)
    with pytest.raises(ValueError):
        tkp.nystrom_features(np.zeros((4, 2)), np.zeros((2, 2)),
                             kernel="nope", device="cpu")


def test_rff_matches_jax_and_approximates_rbf():
    x = np.random.default_rng(9).standard_normal((60, 4))
    z = to_numpy(tkp.rff_features(x, n_features=8192, gamma=0.3, seed=0,
                                  device="cpu"))
    np.testing.assert_allclose(z, np.asarray(jkp.rff_features(
        x, n_features=8192, gamma=0.3, seed=0)), rtol=1e-9, atol=1e-12)
    exact = to_numpy(tkp.kernel_matrix(x, x, "rbf", gamma=0.3,
                                       device="cpu"))
    assert np.abs(z @ z.T - exact).max() < 0.05


def test_rff_deterministic_and_shaped(monkeypatch):
    monkeypatch.undo()                   # the port's own draws
    x = np.random.default_rng(10).standard_normal((7, 3))
    z1 = tkp.rff_features(x, n_features=64, gamma=1.0, seed=5, device="cpu")
    z2 = tkp.rff_features(x, n_features=64, gamma=1.0, seed=5, device="cpu")
    assert z1.shape == (7, 64)
    assert torch.equal(z1, z2)


def test_nystrom_features_exact_on_landmark_subspace():
    x = _two_rings(60, seed=20)
    z = to_numpy(tkp.nystrom_features(x, x, gamma=0.5, device="cpu"))
    exact = to_numpy(tkp.kernel_matrix(x, x, "rbf", gamma=0.5,
                                       device="cpu"))
    np.testing.assert_allclose(z @ z.T, exact, atol=1e-5)
    zj = np.asarray(jkp.nystrom_features(x, x, gamma=0.5))
    np.testing.assert_allclose(z @ z.T, zj @ zj.T, atol=1e-8)


def test_nystrom_features_subset_landmarks_approximate():
    rng = np.random.default_rng(21)
    centers = rng.standard_normal((5, 3)) * 3
    x = np.concatenate([c + 0.1 * rng.standard_normal((40, 3))
                        for c in centers])
    lm = x[::8]
    z = to_numpy(tkp.nystrom_features(x, lm, gamma=0.5, device="cpu"))
    exact = to_numpy(tkp.kernel_matrix(x, x, "rbf", gamma=0.5,
                                       device="cpu"))
    assert np.abs(z @ z.T - exact).max() < 0.05
    zj = np.asarray(jkp.nystrom_features(x, lm, gamma=0.5))
    _same_up_to_sign(z, zj, tol=1e-6)


# -- spectral clustering -----------------------------------------------------

def _accuracy(labels, truth, k):
    labels = np.asarray(labels)
    best = 0.0
    for perm in permutations(range(k)):
        mapped = np.asarray([perm[c] for c in labels])
        best = max(best, float(np.mean(mapped == truth)))
    return best


def _cluster_both(x, n_clusters, **kw):
    got = tcl.spectral_cluster(x, n_clusters, device="cpu", **kw)
    want = jcl.spectral_cluster(x, n_clusters, **kw)
    assert got.labels.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(got.labels),
                                  np.asarray(want.labels))
    _same_up_to_rotation(to_numpy(got.embedding),
                         np.asarray(want.embedding))
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=1e-8, atol=1e-12)
    return got


def test_two_moons():
    from sklearn.datasets import make_moons

    x, y = make_moons(n_samples=400, noise=0.05, random_state=0)
    res = _cluster_both(x, 2, affinity="knn", seed=0)
    assert _accuracy(to_numpy(res.labels), y, 2) > 0.99
    res_rbf = _cluster_both(x, 2, gamma=10.0, seed=0)
    assert _accuracy(to_numpy(res_rbf.labels), y, 2) > 0.95


def test_gaussian_blobs_three_way():
    rng = np.random.default_rng(1)
    centers = np.asarray([[0.0, 0.0], [6.0, 0.0], [0.0, 6.0]])
    truth = np.repeat(np.arange(3), 120)
    x = centers[truth] + 0.5 * rng.standard_normal((360, 2))
    res = _cluster_both(x, 3, seed=0)
    assert _accuracy(to_numpy(res.labels), truth, 3) > 0.98


def test_precomputed_block_affinity():
    n = 60
    w = np.zeros((2 * n, 2 * n))
    w[:n, :n] = 1.0
    w[n:, n:] = 1.0
    np.fill_diagonal(w, 0.0)
    truth = np.repeat([0, 1], n)
    res = tcl.spectral_cluster(w, 2, affinity="precomputed", seed=0,
                               device="cpu")
    assert _accuracy(to_numpy(res.labels), truth, 2) == 1.0


def test_embedding_shape_and_normalization():
    x = np.random.default_rng(2).standard_normal((100, 3))
    res = _cluster_both(x, 4, seed=0)
    assert res.embedding.shape == (100, 4)
    norms = np.linalg.norm(to_numpy(res.embedding), axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-6)
    assert set(np.unique(to_numpy(res.labels))) <= set(range(4))


def test_affinity_properties_and_median_heuristic():
    """rbf_affinity's median heuristic is numpy's median (the mean of the
    two middle distances): the affinity equals JAX's; k-NN too."""
    x = np.random.default_rng(3).standard_normal((50, 2))
    w = to_numpy(tcl.rbf_affinity(x, device="cpu"))
    np.testing.assert_allclose(w, w.T, atol=1e-12)
    np.testing.assert_allclose(np.diag(w), 0.0)
    assert np.all(w >= 0) and np.all(w <= 1)
    np.testing.assert_allclose(w, np.asarray(jcl.rbf_affinity(x)),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(
        to_numpy(tcl.knn_affinity(x, 5, device="cpu")),
        np.asarray(jcl.knn_affinity(x, 5)))


def test_randomized_solver_on_gapped_graph():
    rng = np.random.default_rng(5)
    centers = np.asarray([[0.0, 0.0], [8.0, 0.0]])
    truth = np.repeat(np.arange(2), 100)
    x = centers[truth] + 0.4 * rng.standard_normal((200, 2))
    res = _cluster_both(x, 2, eig_solver="randomized", seed=0)
    assert _accuracy(to_numpy(res.labels), truth, 2) > 0.99


def test_unknown_affinity_raises():
    with pytest.raises(ValueError):
        tcl.spectral_cluster(np.zeros((4, 2)), 2, affinity="cosine",
                             device="cpu")
    with pytest.raises(ValueError):
        tcl.spectral_cluster(np.zeros((4, 2)), 2, eig_solver="arpack",
                             device="cpu")
