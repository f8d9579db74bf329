"""The port's sklearn-compatible estimators (``apps/estimators.py``)
against the JAX package's and sklearn's, on the CPU in f64.

JAX's Omega is patched into the port's ``generate_omega``, so each
estimator's fit equals the JAX estimator's: singular values and
variances to ``RTOL`` = 1e-10 of the largest, components up to each
row's sign to 1e-9, ratios to 1e-12 absolute.  The JAX tests' own bars
against sklearn (tests/test_estimators.py) are held on the port too."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import sparse as jsparse

from rsvd_kamaneh_raganato_terrana_tpu.apps import estimators as jest
from rsvd_kamaneh_raganato_terrana_tpu.rsvd.driver import (
    generate_omega as jax_generate_omega,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import estimators as pest
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.pca import PCA
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdrv

from sklearn.base import clone
from sklearn.decomposition import PCA as SkPCA
from sklearn.decomposition import TruncatedSVD
from sklearn.pipeline import Pipeline
from sklearn.preprocessing import StandardScaler

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


def _data(n=200, f=30, k=6, seed=0, noise=1e-3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k)) @ rng.standard_normal((k, f))
    return (x + noise * rng.standard_normal((n, f))).astype(np.float64)


def _rows_up_to_sign(got, want, tol=1e-9):
    dots = np.abs(np.sum(got * want, axis=1))
    np.testing.assert_allclose(dots, 1.0, atol=tol)


def _same_fit(ours, jx, attrs=("explained_variance_",)):
    s, sj = ours.singular_values_, jx.singular_values_
    assert np.abs(s - sj).max() <= RTOL * sj[0]
    _rows_up_to_sign(ours.components_, jx.components_)
    for name in attrs:
        got, want = getattr(ours, name), getattr(jx, name)
        assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    np.testing.assert_allclose(ours.explained_variance_ratio_,
                               jx.explained_variance_ratio_, atol=1e-12)


class TestRandomizedSVD:
    def test_matches_jax_and_sklearn_truncated_svd(self):
        x = _data()
        ours = pest.RandomizedSVD(n_components=6, q=2, device="cpu").fit(x)
        _same_fit(ours, jest.RandomizedSVD(n_components=6, q=2).fit(x))
        ref = TruncatedSVD(n_components=6, algorithm="arpack",
                           random_state=0).fit(x)
        np.testing.assert_allclose(ours.singular_values_,
                                   ref.singular_values_, rtol=1e-6)
        _rows_up_to_sign(ours.components_, ref.components_, 1e-6)
        np.testing.assert_allclose(ours.explained_variance_ratio_,
                                   ref.explained_variance_ratio_, atol=1e-6)

    def test_transform_inverse_roundtrip(self):
        x = _data(seed=1)
        est = pest.RandomizedSVD(n_components=6, device="cpu")
        z = est.fit_transform(x)
        assert z.shape == (200, 6) and isinstance(z, np.ndarray)
        xr = est.inverse_transform(est.transform(x))
        assert np.linalg.norm(xr - x) < 1e-2 * np.linalg.norm(x)

    def test_fit_transform_equals_transform(self):
        x = _data(seed=2)
        est = pest.RandomizedSVD(n_components=5, device="cpu")
        z1 = est.fit_transform(x)
        np.testing.assert_allclose(z1, est.transform(x), atol=1e-8)
        np.testing.assert_allclose(z1, est.transform(from_numpy(x)),
                                   atol=1e-8)

    def test_sparse_input(self):
        """A torch sparse input stays sparse: the same numbers as the
        dense fit and as the JAX estimator on the BCOO; the variance
        ratio's denominator from the stored values."""
        rng = np.random.default_rng(3)
        x = rng.standard_normal((100, 40))
        x[np.abs(x) < 1.0] = 0.0
        xb = jsparse.BCOO.fromdense(jnp.asarray(x))
        xs = convert.bcoo_from_jax(xb.indices, xb.data, xb.shape, "cpu")
        est = pest.RandomizedSVD(n_components=5, q=2, device="cpu").fit(xs)
        dense = pest.RandomizedSVD(n_components=5, q=2,
                                    device="cpu").fit(x)
        np.testing.assert_allclose(est.singular_values_,
                                   dense.singular_values_, rtol=1e-4)
        np.testing.assert_allclose(est.explained_variance_ratio_,
                                   dense.explained_variance_ratio_,
                                   rtol=1e-4)
        _same_fit(est, jest.RandomizedSVD(n_components=5, q=2).fit(x))
        assert pest._total_column_variance(xs) == pytest.approx(
            jest._total_column_variance(xb), rel=1e-12)
        z = est.transform(xs)
        assert z.shape == (100, 5)
        np.testing.assert_allclose(z, est.transform(x), atol=1e-10)

    def test_clone_and_pipeline(self):
        x = _data(seed=4)
        est = pest.RandomizedSVD(n_components=4, q=1, seed=7, device="cpu")
        c = clone(est)
        assert c.get_params() == est.get_params()
        pipe = Pipeline([("scale", StandardScaler()),
                         ("svd", pest.RandomizedSVD(n_components=4,
                                                     device="cpu"))])
        z = pipe.fit_transform(x)
        assert z.shape == (200, 4)
        zj = Pipeline([("scale", StandardScaler()),
                       ("svd", jest.RandomizedSVD(n_components=4))]
                      ).fit_transform(x)
        _rows_up_to_sign((z / np.linalg.norm(z, axis=0)).T,
                         (zj / np.linalg.norm(zj, axis=0)).T)


class TestRandomizedPCA:
    def test_matches_jax_and_sklearn_pca(self):
        x = _data(seed=5)
        ours = pest.RandomizedPCA(n_components=6, device="cpu").fit(x)
        jx = jest.RandomizedPCA(n_components=6).fit(x)
        _same_fit(ours, jx)
        np.testing.assert_allclose(ours.mean_, jx.mean_, rtol=1e-12)
        np.testing.assert_allclose(ours.noise_variance_, jx.noise_variance_,
                                   rtol=1e-8)
        ref = SkPCA(n_components=6, svd_solver="full").fit(x)
        np.testing.assert_allclose(ours.singular_values_,
                                   ref.singular_values_, rtol=1e-6)
        np.testing.assert_allclose(ours.explained_variance_,
                                   ref.explained_variance_, rtol=1e-6)
        np.testing.assert_allclose(ours.explained_variance_ratio_,
                                   ref.explained_variance_ratio_, atol=1e-6)
        np.testing.assert_allclose(ours.mean_, ref.mean_, atol=1e-10)
        np.testing.assert_allclose(ours.noise_variance_,
                                   ref.noise_variance_, rtol=1e-5,
                                   atol=1e-12)
        _rows_up_to_sign(ours.components_, ref.components_, 1e-6)

    def test_transform_matches_sklearn_up_to_sign(self):
        x = _data(seed=6)
        ours = pest.RandomizedPCA(n_components=4, device="cpu").fit(x)
        ref = SkPCA(n_components=4, svd_solver="full").fit(x)
        sign = np.sign(np.sum(ours.components_ * ref.components_, axis=1))
        np.testing.assert_allclose(ours.transform(x),
                                   ref.transform(x) * sign[None, :],
                                   atol=1e-6)

    def test_inverse_transform_roundtrip_scaled(self):
        x = _data(seed=7)
        est = pest.RandomizedPCA(n_components=8, scale=True, device="cpu")
        z = est.fit_transform(x)
        xr = est.inverse_transform(z)
        assert np.linalg.norm(xr - x) < 5e-2 * np.linalg.norm(x)
        jx = jest.RandomizedPCA(n_components=8, scale=True).fit(x)
        np.testing.assert_allclose(est.scale_, jx.scale_, rtol=1e-12)
        _same_fit(est, jx)

    def test_consistent_with_framework_pca(self):
        x = _data(seed=8)
        est = pest.RandomizedPCA(n_components=6, device="cpu").fit(x)
        ref = PCA(x, normalize=False, device="cpu")
        np.testing.assert_allclose(
            est.explained_variance_ratio_,
            np.asarray(ref.explained_variance_ratio().cpu())[:6],
            rtol=1e-5)
