"""scikit-learn-compatible estimators over the rSVD driver (the JAX
package's ``apps/estimators.py``).

The framework's rSVD behind the standard fit / transform /
fit_transform / inverse_transform contract with sklearn's attribute
names (``components_``, ``singular_values_``,
``explained_variance_ratio_``, ...), so the estimators drop into sklearn
Pipelines and ``clone()``.  The fit runs on ``device`` (the card unless
the caller names another; a tensor stays on its own); the fitted
attributes, ``transform`` and ``inverse_transform`` are numpy, as the
JAX estimators' are.  A torch sparse input stays sparse: the driver
factors it through its CSR path and the variance ratio's denominator is
summed from its stored values.

A dense X whose rows (the samples) are sharded, a DTensor, is fitted on
its blocks through the sharded ``rsvd``: the means, the scales and the
variances are merged over the ranks (``rsvd/_sharded.py``; one rank's
are the local ones), the fitted attributes are replicated numpy arrays
as on one card, and the scores of ``fit_transform``, ``transform`` and
``inverse_transform`` of row-sharded rows come back as row-sharded
DTensors (each rank's rows computed on the host as one card computes
them).  ``RandomizedSVD`` also takes a sparse X split by its entries
over the ranks (``core/mesh.py::shard_rows`` of a sparse tensor, as JAX
places a BCOO): the fit and ``transform`` run on the all-reduced
products of the sharded ``rsvd`` and come back whole, and the variance's
per-column sums are summed over the ranks.

sklearn is optional: if importable, the classes subclass
BaseEstimator/TransformerMixin; otherwise a minimal duck-typed base with
the same methods stands in.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    EntrySplit,
    Sharded,
    is_dtensor,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _like,
    _local,
    _mean,
    _merge_moments,
    _partials,
    _reduce,
    _row_split,
    _sharded_view,
    _spread,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    SparseStored,
    _mm,
    is_sparse,
    rsvd,
    sparse_operand,
)

try:  # pragma: no cover - exercised through the subclass machinery
    from sklearn.base import BaseEstimator, TransformerMixin
except Exception:  # sklearn not installed: duck-typed fallback

    class BaseEstimator:  # type: ignore[no-redef]
        def get_params(self, deep=True):
            import inspect

            keys = inspect.signature(type(self).__init__).parameters
            return {k: getattr(self, k) for k in keys if k != "self"}

        def set_params(self, **params):
            for k, v in params.items():
                setattr(self, k, v)
            return self

    class TransformerMixin:  # type: ignore[no-redef]
        def fit_transform(self, x, y=None, **kw):
            return self.fit(x, **kw).transform(x)


def _on_device(x, device):
    """``x`` as an operand: a dense tensor stays on its device unless
    ``device`` names another, a sparse one becomes the driver's
    :class:`SparseStored` (built once, for the factorization and the
    variance alike); any other array goes to ``device`` (the card when
    None); a DTensor becomes its row-split view, an entry-split sparse X
    stays as it is."""
    if is_dtensor(x):
        return _row_split(x)
    if isinstance(x, torch.Tensor):
        x = x if device is None else x.to(device)
        return sparse_operand(x) if is_sparse(x) else x
    if isinstance(x, (SparseStored, EntrySplit)):
        return x
    return torch.as_tensor(np.asarray(x), device=device or "cuda")


def _total_column_variance(x) -> float:
    """sum_j Var(X[:, j]) (sklearn's TruncatedSVD ratio denominator),
    without densifying a sparse x: per-column sums of the stored values
    and of their squares, in f64, duplicates summed first (an
    entry-split x: its run's sums, all-reduced)."""
    if is_sparse(x):
        local = x.local if isinstance(x, EntrySplit) else sparse_operand(x)
        xs = local.fwd                             # CSR, duplicates summed
        data = xs.values()
        col = xs.col_indices().to(torch.int64)
        n, nf = xs.shape
        sums = torch.zeros((2, nf), dtype=torch.float64, device=data.device)
        sums[0].index_add_(0, col, (data * data).to(torch.float64))
        sums[1].index_add_(0, col, data.to(torch.float64))
        sq, cs = _reduce(sums, x)
        return float(torch.sum(sq / n - (cs / n) ** 2))
    if isinstance(x, (torch.Tensor, Sharded)):
        return float(torch.sum(_spread(x, correction=0)))
    return float(np.var(np.asarray(x), axis=0).sum())


def _host_rows(rows, fn):
    """``fn`` (numpy, row by row) of a row-sharded DTensor's local rows,
    as a row-sharded DTensor on its device; of anything else, as numpy."""
    if not is_dtensor(rows):
        if isinstance(rows, torch.Tensor):
            rows = to_numpy(rows)
        return fn(np.asarray(rows))
    view = _row_split(rows)
    out = torch.as_tensor(fn(to_numpy(view.local)), device=view.device)
    return view.with_local(out).to_dtensor()


def _scores_out(u, s):
    """U diag(s) on the host: numpy, or for a row-split U the row-sharded
    DTensor of this rank's rows; with the rows' (mean, population
    variance) merged over the ranks."""
    local = to_numpy(_local(u)) * s[None, :]
    var = np.var(local, axis=0)
    if isinstance(u, Sharded):
        dev = u.device
        stats = _partials(torch.as_tensor(
            np.stack([np.mean(local, axis=0), var]), device=dev), u)
        parts = [(local.shape[0], to_numpy(st[0]), to_numpy(st[1]))
                 for st in stats]
        var = functools.reduce(
            lambda a, b: _merge_moments(a, b, 0), parts)[2]
        return u.with_local(torch.as_tensor(local, device=dev)) \
            .to_dtensor(), var
    return local, var


class RandomizedSVD(TransformerMixin, BaseEstimator):
    """sklearn-style TruncatedSVD on the rSVD driver.

    Mirrors ``sklearn.decomposition.TruncatedSVD(algorithm='randomized')``
    attribute for attribute (components_, singular_values_,
    explained_variance_[ratio_]); ``transform(X) = X @ components_.T``.
    No centring, so sparse inputs stay sparse."""

    def __init__(self, n_components: int = 2, p: int = 10, q: int = 2,
                 method: str = "eigh", precision: str = "highest",
                 seed: int = 0, device=None):
        self.n_components = n_components
        self.p = p
        self.q = q
        self.method = method
        self.precision = precision
        self.seed = seed
        self.device = device

    def fit(self, x, y=None):
        self.fit_transform(x)
        return self

    def fit_transform(self, x, y=None):
        a = _on_device(x, self.device)
        u, s, v = rsvd(a, k=self.n_components, p=self.p, q=self.q,
                       method=self.method, precision=self.precision,
                       seed=self.seed)
        s, v = to_numpy(s), to_numpy(v)
        scores, self.explained_variance_ = _scores_out(_sharded_view(u), s)
        self.components_ = v.T                          # (k, n_features)
        self.singular_values_ = s
        # ratio against the TOTAL variance of X (sklearn's semantics)
        full_var = _total_column_variance(a)
        self.explained_variance_ratio_ = (
            self.explained_variance_ / full_var if full_var > 0
            else np.zeros_like(s))
        self.n_features_in_ = a.shape[1]
        return scores

    def transform(self, x):
        if is_sparse(x):
            comp = torch.as_tensor(self.components_.T, device=x.device)
            return to_numpy(_mm(x, comp))
        return _host_rows(x, lambda xs: xs @ self.components_.T)

    def inverse_transform(self, z):
        return _host_rows(z, lambda zs: zs @ self.components_)


class RandomizedPCA(TransformerMixin, BaseEstimator):
    """sklearn-style PCA (mean-centring, optional unit-variance scaling
    like the reference's normalize flag) on the rSVD driver.  Attributes
    follow ``sklearn.decomposition.PCA``: mean_, components_,
    singular_values_, explained_variance_[ratio_], noise_variance_ (0 for
    the truncated fit).  Centring, scaling and the total variance run on
    the fit's device in the data's dtype (f64 for integer data)."""

    def __init__(self, n_components: int = 2, scale: bool = False,
                 p: int = 10, q: int = 2, method: str = "eigh",
                 precision: str = "highest", seed: int = 0, device=None):
        self.n_components = n_components
        self.scale = scale
        self.p = p
        self.q = q
        self.method = method
        self.precision = precision
        self.seed = seed
        self.device = device

    def fit(self, x, y=None):
        self.fit_transform(x)
        return self

    def fit_transform(self, x, y=None):
        x = _on_device(x, self.device)
        if x.dtype not in (torch.float32, torch.float64):
            x = x.to(torch.float64)
        n = x.shape[0]
        mean = _mean(x)
        xc = _like(x, _local(x) - mean)
        if self.scale:
            sd = _spread(xc, correction=1, std=True)
            sd = torch.where(sd > 0, sd, torch.ones_like(sd))
            xc = _like(x, _local(xc) / sd)
            self.scale_ = to_numpy(sd)
        else:
            self.scale_ = None
        u, s, v = rsvd(xc, k=self.n_components, p=self.p, q=self.q,
                       method=self.method, precision=self.precision,
                       seed=self.seed)
        total_var = float(_reduce(torch.sum(_local(xc) * _local(xc)),
                                  xc)) / (n - 1)
        del xc
        u, s, v = _sharded_view(u), to_numpy(s), to_numpy(v)
        self.mean_ = to_numpy(mean)
        self.components_ = v.T
        self.singular_values_ = s
        self.explained_variance_ = (s ** 2) / (n - 1)
        self.explained_variance_ratio_ = (
            self.explained_variance_ / total_var if total_var > 0
            else np.zeros_like(s))
        # sklearn's PCA: the average variance of the discarded
        # dimensions (0 when nothing is discarded)
        n_rest = x.shape[1] - self.n_components
        self.noise_variance_ = (
            max(total_var - float(self.explained_variance_.sum()), 0.0)
            / n_rest if n_rest > 0 else 0.0)
        self.n_features_in_ = x.shape[1]
        return _scores_out(u, s)[0]

    def _center(self, x):
        xc = x - self.mean_
        return xc / self.scale_ if self.scale_ is not None else xc

    def transform(self, x):
        return _host_rows(x, lambda xs: self._center(xs) @ self.components_.T)

    def _uncenter(self, z):
        xr = z @ self.components_
        if self.scale_ is not None:
            xr = xr * self.scale_
        return xr + self.mean_

    def inverse_transform(self, z):
        return _host_rows(z, self._uncenter)
