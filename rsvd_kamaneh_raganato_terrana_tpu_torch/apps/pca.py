"""Principal Component Analysis on the SVD engine (the JAX package's
``apps/pca.py``).

``PCA`` mean-centres (optionally z-scores) the data, runs the dispatched
SVD of the whole centred matrix (``'parallel_jacobi'`` by default, the
block Jacobi engine above 512 features) or, with ``use_rsvd``, a
randomized SVD of it, and exposes the variance, score and loading
accessors, the R-style ``summary()`` table, ``save_results`` and
``add_data``.  ``StreamingPCA`` keeps no rows: a Frequent Directions
sketch (``rsvd/fd.py``) absorbs the stream.

The data and the factors live on ``device``: a tensor stays on its own,
any other array goes to the card unless the caller names another device.
Products: JAX's bare ``@`` runs at ``Precision.DEFAULT``, so ``project``
and ``reconstruct`` run at the port's 'default' (one bf16 pass with f32
accumulation on the card, as on the TPU; full precision on the CPU, as
JAX gives there).  ``check_orthogonality`` runs at 'highest': a bf16
product would measure its own operand rounding (about 2^-9 sqrt(d)), not
V.  The means and sums are ``torch.mean``/``torch.sum`` in the data's
dtype.

``PCA`` takes a data matrix whose rows (the observations) are sharded, a
DTensor: the column means and scales are merged over the ranks
(``rsvd/_sharded.py``: one rank's are the local ones), the centred data
stays row-split, and every ``SVDMethod`` runs on it as ``linalg/svd.py``
says (the Jacobi engines on the R factor of its row-split thin QR, the
Gram engines on its all-reduced Gram); ``use_rsvd`` goes through the
sharded ``rsvd``.  U, the scores and what ``project`` returns for
row-sharded rows come back row-sharded, the rest replicated.
``add_data`` appends to the row split and refits.
"""

from __future__ import annotations

import io as _io
import os
from typing import Optional, Sequence

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import (
    as_tensor,
    to_numpy,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import matmul_at
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import Sharded
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.io import (
    load_whitespace_dataset,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.svd import SVDMethod, svd
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _append_rows,
    _like,
    _local,
    _mean,
    _reduce,
    _row_split,
    _sharded_view,
    _spread,
    _to_api,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import rsvd
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.fd import (
    FrequentDirections,
)


class PCA:
    """PCA via the SVD of the centred (optionally standardized) data
    matrix.  ``method`` picks the SVD engine; ``use_rsvd``/``rank`` take
    the randomized path (rank 0: all but one component)."""

    def __init__(self, data, normalize: bool = False,
                 method=SVDMethod.ParallelJacobi, use_rsvd: bool = False,
                 rank: int = 0, device=None):
        self._method = SVDMethod.parse(method)
        self._normalize = bool(normalize)
        self._use_rsvd = bool(use_rsvd)
        self._rank = int(rank)
        self._assign(_row_split(data, device))
        self._initialize()

    # ------------------------------------------------------------------
    def _assign(self, data):
        if len(data.shape) != 2 or data.shape[0] < 2 or data.shape[1] < 2:
            raise ValueError("PCA needs an at least 2 x 2 data matrix")
        self._raw = data

    def _initialize(self):
        x = self._raw
        self._mean = _mean(x)
        xc = _like(x, _local(x) - self._mean[None, :])
        if self._normalize:
            self._std = _spread(xc, correction=1, std=True)
            xc = _like(x, _local(xc) / self._safe_std()[None, :])
        else:
            self._std = None
        self._centered = xc
        # the ratios divide by the total variance, not by sum(s^2), so
        # the truncated use_rsvd/rank path reports honest proportions
        self._total_sq = _reduce(torch.sum(torch.square(_local(xc))), xc)
        if self._use_rsvd:
            k = self._rank if self._rank > 0 else min(xc.shape)
            self._u, self._s, self._v = rsvd(
                xc, k=min(k, min(xc.shape) - 1) if k >= min(xc.shape) else k,
                method=self._method)
            self._u = _sharded_view(self._u)
        else:
            self._u, self._s, self._v = svd(xc, self._method, self._rank)

    def _safe_std(self):
        return torch.where(self._std > 0, self._std,
                           torch.ones_like(self._std))

    # -- reference accessors -------------------------------------------
    def getU(self):  # noqa: N802
        return _to_api(self._u)

    def getS(self):  # noqa: N802
        return self._s

    def getV(self):  # noqa: N802
        return self._v

    @property
    def mean(self):
        return self._mean

    def explained_variance(self):
        """Component standard deviations S / sqrt(n - 1)."""
        return self._s / np.sqrt(self._raw.shape[0] - 1.0)

    def explained_variance_ratio(self):
        return torch.square(self._s) / self._total_sq

    def scores(self):
        """Projections U diag(S)."""
        return _to_api(_like(self._u, _local(self._u) * self._s[None, :]))

    def loadings(self):
        """Right singular vectors V."""
        return self._v

    def _components(self, n_components):
        return self._v if n_components is None else \
            self._v[:, :n_components]

    def project(self, data, n_components: Optional[int] = None):
        """Map new rows into PC space (row-sharded rows stay so)."""
        rows = _row_split(data, self._raw.device, self._raw.dtype)
        x = _local(rows) - self._mean[None, :]
        if self._std is not None:
            x = x / self._safe_std()[None, :]
        return _to_api(_like(rows, matmul_at(
            x, self._components(n_components), "default")))

    def reconstruct(self, scores_mat, n_components: Optional[int] = None):
        """Back-map scores to data space."""
        v = self._components(n_components)
        x = matmul_at(as_tensor(scores_mat, v.device, v.dtype), v.T,
                      "default")
        if self._std is not None:
            x = x * self._safe_std()[None, :]
        return x + self._mean[None, :]

    def check_orthogonality(self) -> float:
        """||V^T V - I||_F."""
        k = self._v.shape[1]
        eye = torch.eye(k, dtype=self._v.dtype, device=self._v.device)
        return float(torch.linalg.norm(
            matmul_at(self._v.T, self._v, "highest") - eye))

    def add_data(self, new_rows):
        """Append observations and recompute (a PCA of whole data).  On
        row-sharded data the new rows (a DTensor on the same mesh, a
        tensor or an array) join the row split in the order [data; new]
        (``rsvd/_sharded.py::_append_rows``: one all-to-all, nothing
        gathered), and the PCA is refitted as a sharded one."""
        raw = self._raw
        if isinstance(raw, Sharded):
            data = _append_rows(raw, _row_split(new_rows, raw.device,
                                                raw.dtype))
        else:
            data = torch.cat([raw, as_tensor(new_rows, raw.device,
                                             raw.dtype)], dim=0)
        self._assign(data)
        self._initialize()
        return self

    # -- reporting ------------------------------------------------------
    def summary(self, feature_names: Optional[Sequence[str]] = None) -> str:
        """R-style importance-of-components table."""
        sd = to_numpy(self.explained_variance())
        ratio = to_numpy(self.explained_variance_ratio())
        cum = np.cumsum(ratio)
        k = len(sd)
        buf = _io.StringIO()
        buf.write("Importance of components:\n")
        header = "".join(f"{'PC' + str(i + 1):>12}" for i in range(k))
        buf.write(f"{'':24}{header}\n")
        rows = [
            ("Standard deviation", sd),
            ("Proportion of Variance", ratio),
            ("Cumulative Proportion", cum),
        ]
        for label, vals in rows:
            line = "".join(f"{v:12.4f}" for v in vals)
            buf.write(f"{label:<24}{line}\n")
        if feature_names is not None:
            buf.write("\nLoadings:\n")
            v = to_numpy(self._v)
            buf.write(f"{'':16}" + "".join(
                f"{'PC' + str(i + 1):>12}" for i in range(v.shape[1])) + "\n")
            for name, row in zip(feature_names, v):
                buf.write(f"{name[:15]:<16}"
                          + "".join(f"{x:12.4f}" for x in row) + "\n")
        return buf.getvalue()

    def save_results(self, path: str) -> None:
        """Write the cumulative variance ratios, the scores and the
        loadings."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        cum = np.cumsum(to_numpy(self.explained_variance_ratio()))
        scores = to_numpy(self.scores())
        loadings = to_numpy(self.loadings())
        with open(path, "w") as f:
            f.write("# cumulative explained variance ratio\n")
            f.write(" ".join(f"{x:.12e}" for x in cum) + "\n")
            f.write(f"# scores ({scores.shape[0]} x {scores.shape[1]})\n")
            for row in scores:
                f.write(" ".join(f"{x:.12e}" for x in row) + "\n")
            f.write(f"# loadings ({loadings.shape[0]} x "
                    f"{loadings.shape[1]})\n")
            for row in loadings:
                f.write(" ".join(f"{x:.12e}" for x in row) + "\n")


def load_tourists_dataset(path: str):
    """tourists.txt: skip 3 leading categorical columns, keep 8 numeric."""
    return load_whitespace_dataset(path, skip_cols=3)


def load_athletic_dataset(path: str):
    """dataset_athletic.txt: country label + 7 event times."""
    return load_whitespace_dataset(path, skip_cols=1)


class StreamingPCA:
    """One-pass PCA over an unbounded row stream, O(l d) memory.

    A Frequent Directions sketch absorbs the uncentred stream, a running
    f64 sum and count track the mean, and ``finalize`` eigendecomposes
    the mean-corrected sketch Gram

        C_hat = (S^T S - n mu mu^T) / (n - 1)

    in f64 numpy on the host, as the JAX package does: the true sample
    covariance up to FD's additive ||A - A_k||_F^2 / (l - k).

    >>> sp = StreamingPCA(n_features=d, l=64)
    >>> for batch in stream:
    ...     sp.update(batch)
    >>> lam, components = sp.finalize(k=8)   # descending eigenpairs
    """

    def __init__(self, n_features: int, l: int = 64, dtype=torch.float32,
                 device=None):
        self.d = int(n_features)
        self._fd = FrequentDirections(self.d, int(l), dtype=dtype,
                                      device=device)
        self._sum = np.zeros((self.d,), dtype=np.float64)
        self._n = 0

    def update(self, rows) -> "StreamingPCA":
        rows = to_numpy(rows) if isinstance(rows, torch.Tensor) else \
            np.asarray(rows)
        if rows.ndim == 1:
            rows = rows[None, :]
        self._sum += rows.sum(axis=0, dtype=np.float64)
        self._n += rows.shape[0]
        self._fd.update(rows)
        return self

    @property
    def n_seen(self) -> int:
        return self._n

    @property
    def mean(self) -> np.ndarray:
        return self._sum / max(self._n, 1)

    def finalize(self, k: Optional[int] = None):
        """Top-k eigenpairs of the estimated sample covariance:
        ``(lam: k, V: d x k)`` descending; lam are UNDER-estimates within
        FD's deterministic bound."""
        if self._n < 2:
            raise ValueError("need at least 2 rows")
        s = to_numpy(self._fd.sketch()).astype(np.float64)
        mu = self.mean
        g = (s.T @ s - self._n * np.outer(mu, mu)) / (self._n - 1)
        g = 0.5 * (g + g.T)
        w, v = np.linalg.eigh(g)
        w, v = np.maximum(w[::-1], 0.0), v[:, ::-1]
        kk = min(k or self.d, self.d)
        return w[:kk], v[:, :kk]

    def project(self, rows, k: Optional[int] = None) -> np.ndarray:
        """Centre new rows with the stream's mean and project them onto
        the current principal axes."""
        _, v = self.finalize(k)
        return (np.asarray(rows) - self.mean[None, :]) @ v
