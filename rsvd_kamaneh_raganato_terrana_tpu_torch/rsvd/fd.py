"""Frequent Directions: deterministic single-pass row-stream sketching
(the JAX package's ``rsvd/fd.py``; Liberty 2013, Ghashami, Liberty,
Phillips & Woodruff 2016).

Rows arrive once, in order; the l x n sketch S keeps the deterministic
guarantee

    0  <=  ||A^T A - S^T S||_2  <=  ||A - A_k||_F^2 / (l - k).

The 2l x n buffer lives on ``device`` (the card unless the caller names
another).  ``update(rows)`` copies a host batch in and, each time the
buffer fills, shrinks it: the 2l x 2l Gram, one eigh
(``core/device.py::eigh``), the (l+1)-th eigenvalue subtracted from the
top spectrum, and one product rebuilding l sketch rows.

The shrink computes in f64 whatever the buffer's dtype and stores the
rows back in that dtype.  The JAX package shrinks in the buffer's
dtype: on an uncentred f32 stream whose mean carries most of ||X||^2
each shrink then rounds at eps of the mean's share, which reaches the
smallest kept eigenvalues, and both packages left FD's bound about 4x
on chip_smoke.py's PCA model and overshot the true covariance; in f64
the f32 stream stays under it and inside the bound (PERF.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import eigh
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import _mm


def _shrink(buf, l: int):
    """One FD shrink of a full 2l x n buffer: a buffer whose first l rows
    are the shrunken sketch and whose last l rows are zero.  The eigh is
    of buf buf^T (2l x 2l), not an SVD of the 2l x n buffer; all of it
    runs in f64 (module docstring)."""
    b = buf.to(torch.float64)
    g = _mm(b, b.T, "highest")
    g = 0.5 * (g + g.T)
    w, q = eigh(g)                                    # ascending
    w = torch.clamp(w.flip(0), min=0.0)               # descending sigma^2
    q = q.flip(1)
    shrunk = torch.sqrt(torch.clamp(w - w[l], min=0.0))   # zeros past l
    # sketch rows: diag(shrunk) V^T = diag(shrunk / sigma) Q^T buf
    sigma = torch.sqrt(w)
    scale = torch.where(sigma > 0, shrunk / torch.clamp(sigma, min=1e-30),
                        torch.zeros_like(sigma))
    return _mm((q * scale[None, :]).T, b, "highest").to(buf.dtype)


def _host_rows(rows, dtype) -> np.ndarray:
    """A batch as a 2-D host array of ``dtype``'s numpy type."""
    rows = to_numpy(rows) if isinstance(rows, torch.Tensor) else rows
    rows = np.ascontiguousarray(
        rows, dtype=torch.empty((), dtype=dtype).numpy().dtype)
    return rows[None, :] if rows.ndim == 1 else rows


class FrequentDirections:
    """Streaming l x n sketch with the FD guarantee (module docstring).

    >>> fd = FrequentDirections(n_cols=..., l=64)
    >>> for batch in row_batches:      # each batch: (b, n), any b
    ...     fd.update(batch)
    >>> s_rows = fd.sketch()           # l x n, ||A^T A - S^T S|| bounded
    >>> w, v = fd.eigh_estimate(k=16)  # top right-singular estimates

    Batches are copied on the host and moved to the buffer in chunks of
    at most the free rows; one shrink runs per fill.  Device memory is
    O(l n), whatever the stream's length.
    """

    def __init__(self, n_cols: int, l: int, dtype=torch.float32,
                 device=None):
        if l < 1:
            raise ValueError("l must be >= 1")
        self.n = int(n_cols)
        self.l = int(l)
        self._buf = torch.zeros((2 * self.l, self.n), dtype=dtype,
                                device=device or "cuda")
        self.dtype = self._buf.dtype
        self._fill = 0           # next free buffer row
        self._seen = 0

    def update(self, rows) -> "FrequentDirections":
        """Absorb a batch of rows (b x n, any b)."""
        rows = _host_rows(rows, self.dtype)
        if rows.shape[1] != self.n:
            raise ValueError(f"expected {self.n} columns, got {rows.shape}")
        self._seen += rows.shape[0]
        pos = 0
        while pos < rows.shape[0]:
            take = min(2 * self.l - self._fill, rows.shape[0] - pos)
            self._buf[self._fill:self._fill + take] = torch.from_numpy(
                rows[pos:pos + take]).to(self._buf.device)
            self._fill += take
            pos += take
            if self._fill == 2 * self.l:
                self._buf = _shrink(self._buf, self.l)
                self._fill = self.l
        return self

    def sketch(self) -> torch.Tensor:
        """The current sketch: up to 2l rows S with
        ||A^T A - S^T S||_2 <= ||A - A_k||_F^2 / (l - k)."""
        return self._buf[: self._fill]

    def eigh_estimate(self, k: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k estimated eigenpairs of A^T A from the sketch:
        (lam: k, V: n x k) with lam descending.  FD's deterministic bound
        makes lam an UNDER-estimate within ||A - A_k||_F^2 / (l - k)."""
        s = self.sketch()
        g = _mm(s, s.T, "highest")
        w, q = eigh(0.5 * (g + g.T))
        w = torch.clamp(w.flip(0), min=0.0)
        q = q.flip(1)
        kk = min(k or self.l, s.shape[0])
        sigma = torch.sqrt(torch.clamp(w[:kk], min=1e-30))
        v = _mm(s.T, q[:, :kk] / sigma[None, :], "highest")
        return w[:kk], v

    @property
    def rows_seen(self) -> int:
        return self._seen
