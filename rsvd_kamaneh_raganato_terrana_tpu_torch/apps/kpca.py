"""Kernel PCA with randomized eigensolvers (the JAX package's
``apps/kpca.py``).

Kernel PCA generalizes the reference's linear PCA to nonlinear feature
spaces through the kernel trick.  Its core is an n x n centred kernel
Gram -- symmetric PSD, with fast spectral decay for smooth kernels --
of which only the top-k eigenpairs are needed.  The 'auto' solver takes
the exact eigh up to n = 1024 and the power-iterated Rayleigh-Ritz
sketch (``rsvd/nystrom.py::_reigh_impl``) above; 'nystrom' is the
one-pass sketch (``_nystrom_impl``).

Every kernel here is one GEMM plus rank-1 corrections (the RBF distance
matrix is ||x||^2 + ||y||^2 - 2 x y^T), at 'highest' precision as the
JAX module's ``DOT_PRECISION``.  The exact eighs (the 'exact' solver and
the Nystrom feature map's landmark eigh) go through ``core/device.py::
eigh``: the JAX module's ``jnp.linalg.eigh`` returns eigenvectors
orthogonal to working precision, torch's f32 eigh on the card only to
about 1e-5.  The data and the fit live on the fit's device: a tensor
stays on its own, any other array goes to ``device`` (the card unless
the caller names another).

The training points may be a DTensor whose rows are sharded.  Each row
of K needs every point, so ``fit`` gathers X (n x d) once, a counted
all-gather and the one whole gather of the sharded API; K (n x n) is
built and kept row-split, its centring means are merged over the ranks,
its symmetrization reads K^T through one all-to-all, and the
randomized and Nystrom solvers run on the row-split K.  The exact solver
(and 'auto' up to n = 1024) gathers the centred K (n x n, one counted
all-gather of n^2 itemsize bytes a rank) and runs the eigh replicated on
every rank, as XLA runs the JAX package's ``jnp.linalg.eigh`` of a
sharded K; each rank keeps its rows of the eigenvectors.  ``alphas_``
and ``scores_`` come back row-sharded, ``transform`` of row-sharded
rows row-sharded.  The
feature maps take row-sharded rows and return them row-sharded.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    eigh,
    matmul_at,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import key_from_seed
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _like,
    _local,
    _mean,
    _row_block,
    _row_split,
    _sharded_view,
    _to_api,
    _transpose,
    _whole,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.nystrom import (
    _nystrom_impl,
    _reigh_impl,
)

_KERNELS = ("rbf", "poly", "linear")


def _mm(a, b):
    return matmul_at(a, b, DOT_PRECISION)


def _kernel(x, y, kernel: str, gamma, degree: int, coef0):
    """The kernel block k(x_i, y_j)."""
    if kernel == "linear":
        return _mm(x, y.T)
    if kernel == "poly":
        return (gamma * _mm(x, y.T) + coef0) ** degree
    # rbf: ||x_i - y_j||^2 = ||x_i||^2 + ||y_j||^2 - 2 <x_i, y_j>
    xx = torch.sum(x * x, dim=1)[:, None]
    yy = torch.sum(y * y, dim=1)[None, :]
    d2 = torch.clamp(xx + yy - 2.0 * _mm(x, y.T), min=0.0)
    return torch.exp(-gamma * d2)


def _check_kernel(kernel):
    if kernel not in _KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")


def kernel_matrix(x, y, kernel: str = "rbf", gamma: Optional[float] = None,
                  degree: int = 3, coef0: float = 1.0, device=None):
    """K[i, j] = k(x_i, y_j) for the rows of x (n x d) and y (m x d), on
    x's device (``device`` for a non-tensor x; the card unless named).
    A row-sharded x gives K's rows row-sharded alike, each rank's rows
    against the whole y (a row-sharded y is gathered once, m x d)."""
    _check_kernel(kernel)
    x = _row_split(x, device)
    y = _whole(_row_split(y, _local(x).device, x.dtype))
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return _to_api(_like(x, _kernel(_local(x), y, kernel, gamma, degree,
                                    coef0)))


def _finish(w, v, kc):
    """Shared fit tail: clamp the spectrum, zero the rank-deficient
    components, build the scores.  A component whose eigenvalue is
    negligible against the leading one gets a ZERO projection scale:
    dividing by sqrt(~0) would emit huge garbage in transform (the
    centred kernel's rank is at most the data's intrinsic rank)."""
    w = torch.clamp(w, min=0.0)
    floor = (torch.finfo(kc.dtype).eps * kc.shape[0]
             * torch.clamp(w[0], min=0.0))
    ok = w > floor
    inv_sqrt = torch.where(ok, 1.0 / torch.sqrt(torch.where(
        ok, w, torch.ones_like(w))), torch.zeros_like(w))
    scores = _like(v, _local(v) * torch.sqrt(w)[None, :] * ok)
    return w * ok, v, inv_sqrt, scores


def _fit_impl(x, kernel: str, gamma, degree: int, coef0, k: int,
              solver: str, p: int, seed):
    """The fit on x (a row-split ``x`` carries the whole points as
    ``x_all``: K's rows are this rank's, its columns every point's)."""
    x_all = _whole(x)
    kmat = _like(x, _kernel(_local(x), x_all, kernel, gamma, degree, coef0))
    col_means = _mean(kmat)
    tot = _mean(kmat, dim=None)
    local = _local(kmat)
    row = torch.mean(local, dim=1, keepdim=True)
    kc = _like(x, local - row - col_means[None, :] + tot)   # centred
    del kmat, local
    kc = _like(x, 0.5 * (_local(kc) + _local(_transpose(kc))))
    if solver == "exact":
        w, v = eigh(_whole(kc))           # a row-split K gathered once
        w, v = w.flip(0)[:k], v.flip(1)[:, :k]
        v = _like(kc, _row_block(kc, v))
    elif solver == "randomized":
        w, v = _reigh_impl(kc, k=k, p=p, q=2, seed=seed,
                           precision="highest")
    else:                                            # nystrom (one pass)
        v, w = _nystrom_impl(kc, k=k, p=p, seed=seed, precision="highest")
    return (col_means, tot) + _finish(w, v, kc)


def _transform_impl(y, x, kernel: str, gamma, degree: int, coef0,
                    col_means, tot, alphas, inv_sqrt):
    k_new = _kernel(y, x, kernel, gamma, degree, coef0)
    row = torch.mean(k_new, dim=1, keepdim=True)
    kc = k_new - row - col_means[None, :] + tot
    # alphas row-major, as a gathered panel is (a fit's own is a column
    # slice of a wider product)
    return _mm(kc, _whole(alphas).contiguous()) * inv_sqrt[None, :]


class KernelPCA:
    """Nonlinear PCA through the kernel trick, a randomized eigensolver
    inside.

    >>> kp = KernelPCA(n_components=8, kernel="rbf", gamma=0.5).fit(x)
    >>> z = kp.transform(x_new)          # (m, 8) kernel principal scores

    ``solver``: 'exact' (eigh of the centred kernel), 'randomized'
    (power-iterated Rayleigh-Ritz, ``rsvd/nystrom.py::reigh``), 'nystrom'
    (ONE pass over K, fastest, biased low on slowly decaying spectra
    unless p is generous), or 'auto' (exact up to n = 1024, randomized
    above).  Attributes after fit: ``eigenvalues_`` (k, zeroed past the
    kernel's numerical rank), ``alphas_`` (n x k kernel-space
    eigenvectors), ``scores_`` (n x k, alphas * sqrt(eigenvalues), the
    training projections).  Components beyond the centred kernel's
    numerical rank transform to exactly zero.  ``device`` places a
    non-tensor x (the card unless named); a tensor stays on its own.
    """

    def __init__(self, n_components: int, kernel: str = "rbf",
                 gamma: Optional[float] = None, degree: int = 3,
                 coef0: float = 1.0, solver: str = "auto", p: int = 10,
                 seed: int = 0, device=None):
        self.k = int(n_components)
        self.kernel = kernel
        self.gamma = gamma
        self.degree = degree
        self.coef0 = coef0
        self.solver = solver
        self.p = p
        self.seed = seed
        self.device = device

    def _params(self):
        gamma = self.gamma if self.gamma is not None else 1.0 / self._d
        return gamma, self.degree, self.coef0

    def fit(self, x) -> "KernelPCA":
        _check_kernel(self.kernel)
        x = _row_split(x, self.device)
        self._d = x.shape[1]
        solver = self.solver
        if solver == "auto":
            solver = "exact" if x.shape[0] <= 1024 else "randomized"
        if solver not in ("exact", "randomized", "nystrom"):
            raise ValueError(f"unknown solver {solver!r}")
        gamma, degree, coef0 = self._params()
        (self._col_means, self._tot, self.eigenvalues_, alphas,
         self._inv_sqrt, scores) = _fit_impl(
            x, self.kernel, gamma, degree, coef0, self.k, solver, self.p,
            self.seed)
        self._x = _whole(x)
        self.alphas_, self.scores_ = _to_api(alphas), _to_api(scores)
        return self

    def transform(self, y) -> torch.Tensor:
        """Project new rows onto the kernel principal axes:
        z = K_c(new, train) alphas / sqrt(eigenvalues), with the
        rank-deficient components pinned to zero.  Row-sharded rows give
        row-sharded scores (a sharded fit's alphas gathered, k wide)."""
        gamma, degree, coef0 = self._params()
        rows = _row_split(y, self._x.device, self._x.dtype)
        return _to_api(_like(rows, _transform_impl(
            _local(rows), self._x, self.kernel, gamma, degree, coef0,
            self._col_means, self._tot, _sharded_view(self.alphas_),
            self._inv_sqrt)))

    def fit_transform(self, x) -> torch.Tensor:
        return self.fit(x).scores_


def nystrom_features(x, landmarks, kernel: str = "rbf",
                     gamma: Optional[float] = None, degree: int = 3,
                     coef0: float = 1.0, device=None) -> torch.Tensor:
    """Data-dependent kernel feature map (Williams-Seeger Nystrom):
    z(x) = K(x, L) K(L, L)^{-1/2} for a landmark set L (rows), so
    z(x) z(y)^T ~ k(x, y), with an error set by how well the landmarks
    cover the data.  Directions of K(L, L) below a spectrum-relative
    floor are dropped (the pseudo-inverse square root).  Two kernel
    GEMMs and one landmark eigh (``core/device.py::eigh``).  Row-sharded
    x gives row-sharded features."""
    _check_kernel(kernel)
    rows = _row_split(x, device)
    x = _local(rows)
    landmarks = as_tensor(landmarks, x.device, x.dtype)
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    k_ll = _kernel(landmarks, landmarks, kernel, gamma, degree, coef0)
    k_ll = 0.5 * (k_ll + k_ll.T)
    w, u = eigh(k_ll)
    floor = (torch.finfo(x.dtype).eps * k_ll.shape[0]
             * torch.clamp(w[-1], min=0.0))
    keep = w > floor
    inv_sqrt = torch.where(keep, 1.0 / torch.sqrt(torch.where(
        keep, w, torch.ones_like(w))), torch.zeros_like(w))
    k_xl = _kernel(x, landmarks, kernel, gamma, degree, coef0)
    # the JAX module multiplies by diag(inv_sqrt): the same products
    return _to_api(_like(rows, _mm(k_xl, u) * inv_sqrt[None, :]))


def _rff_draws(seed, d: int, n_features: int, dtype, device):
    """(W0, b): a d x n_features standard-normal matrix and n_features
    phases uniform on [0, 2 pi), both from one generator seeded with
    ``seed`` on ``device``."""
    key = key_from_seed(seed, device)
    w0 = torch.randn((d, n_features), generator=key, device=key.device,
                     dtype=dtype)
    b = torch.rand((n_features,), generator=key, device=key.device,
                   dtype=dtype) * (2.0 * math.pi)
    return w0, b


def rff_features(x, n_features: int = 256, gamma: float = 1.0, seed=0,
                 device=None) -> torch.Tensor:
    """Random Fourier features for the RBF kernel (Rahimi-Recht 2007):
    z(x) (n x D) with E[z(x) z(y)^T] = exp(-gamma ||x - y||^2), error
    O(1/sqrt(D)) uniformly.  The kernel exp(-gamma d^2) is the Gaussian
    kernel of variance 1/(2 gamma), whose spectral measure is
    N(0, 2 gamma I).  One GEMM and a cosine, deterministic in the seed
    (:func:`_rff_draws`).  Row-sharded x gives row-sharded features,
    the draws made whole."""
    rows = _row_split(x, device)
    x = _local(rows)
    w0, b = _rff_draws(seed, x.shape[1], n_features, x.dtype, x.device)
    w = w0 * math.sqrt(2.0 * gamma)
    proj = _mm(x, w) + b[None, :]
    return _to_api(_like(rows, math.sqrt(2.0 / n_features)
                         * torch.cos(proj)))
