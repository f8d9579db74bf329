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

The buffer may be a DTensor whose columns are sharded (its natural
layout: the n columns are the wide side): each rank keeps its columns of
every row, the shrink's 2l x 2l Gram is the local columns' Gram
all-reduced, and the eigh and the rebuilt rows' product run on each
rank's columns, so the sketch does not depend on the split.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import eigh
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    is_dtensor,
    mesh_axis,
    row_dtensor,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import _mm


def _column_split(buf):
    """(this rank's block, its first column, the column split's ``Axis``)
    of a buffer whose columns are sharded (a DTensor, every other mesh
    dimension replicated), or (buf, 0, None)."""
    if not is_dtensor(buf):
        return buf, 0, None
    from torch.distributed.tensor import Replicate, Shard

    mesh = buf.device_mesh
    dims = [d for d, pl in enumerate(buf.placements) if pl == Shard(1)]
    if not dims or not all(pl == Shard(1) or isinstance(pl, Replicate)
                           for pl in buf.placements):
        raise ValueError("the FD buffer is split by columns or not at all, "
                         f"not {buf.placements}")
    axis = mesh_axis(mesh, tuple(mesh.mesh_dim_names[d] for d in dims))
    if buf.shape[1] % axis.size:
        raise ValueError(f"{buf.shape[1]} columns do not divide over "
                         f"{axis.size} ranks")
    local = buf.to_local()
    return local, axis.index * local.shape[1], axis


def _split_like(buf, local):
    """``local`` (rows of this rank's columns) laid out as ``buf`` is: a
    DTensor of the same placements, or ``local`` itself."""
    if not is_dtensor(buf):
        return local
    from torch.distributed.tensor import DTensor

    shape = (local.shape[0], buf.shape[1])
    return DTensor.from_local(local, buf.device_mesh, buf.placements,
                              run_check=False, shape=shape,
                              stride=(shape[1], 1))


def _shrink(buf, l: int, cols=None):
    """One FD shrink of a full 2l x n buffer: a buffer whose first l rows
    are the shrunken sketch and whose last l rows are zero.  The eigh is
    of buf buf^T (2l x 2l), not an SVD of the 2l x n buffer; all of it
    runs in f64 (module docstring).  ``cols``: the column split of
    ``buf``, this rank's columns (its Gram is all-reduced)."""
    b = buf.to(torch.float64)
    g = _mm(b, b.T, "highest")
    if cols is not None:
        g = collectives.all_reduce(g, cols.group)
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
        """Absorb a batch of rows (b x n, any b); a rank whose buffer is
        column-split keeps its columns of them."""
        rows = _host_rows(rows, self.dtype)
        if rows.shape[1] != self.n:
            raise ValueError(f"expected {self.n} columns, got {rows.shape}")
        self._seen += rows.shape[0]
        buf, c0, cols = _column_split(self._buf)
        mine = slice(c0, c0 + buf.shape[1])
        pos = 0
        while pos < rows.shape[0]:
            take = min(2 * self.l - self._fill, rows.shape[0] - pos)
            buf[self._fill:self._fill + take] = torch.from_numpy(
                rows[pos:pos + take, mine]).to(buf.device)
            self._fill += take
            pos += take
            if self._fill == 2 * self.l:
                buf = _shrink(buf, self.l, cols)
                self._fill = self.l
        self._buf = _split_like(self._buf, buf)
        return self

    def sketch(self) -> torch.Tensor:
        """The current sketch: up to 2l rows S with
        ||A^T A - S^T S||_2 <= ||A - A_k||_F^2 / (l - k); laid out as the
        buffer is."""
        buf = _column_split(self._buf)[0]
        return _split_like(self._buf, buf[: self._fill])

    def eigh_estimate(self, k: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k estimated eigenpairs of A^T A from the sketch:
        (lam: k, V: n x k) with lam descending.  FD's deterministic bound
        makes lam an UNDER-estimate within ||A - A_k||_F^2 / (l - k).
        With a column-split buffer V comes back row-sharded."""
        buf, _, cols = _column_split(self._buf)
        s = buf[: self._fill]
        g = _mm(s, s.T, "highest")
        if cols is not None:
            g = collectives.all_reduce(g, cols.group)
        w, q = eigh(0.5 * (g + g.T))
        w = torch.clamp(w.flip(0), min=0.0)
        q = q.flip(1)
        kk = min(k or self.l, s.shape[0])
        sigma = torch.sqrt(torch.clamp(w[:kk], min=1e-30))
        v = _mm(s.T, q[:, :kk] / sigma[None, :], "highest")
        if cols is not None:
            v = row_dtensor(v, self._buf.device_mesh, cols, self.n)
        return w[:kk], v

    @property
    def rows_seen(self) -> int:
        return self._seen
