"""The reference's view of the operand: A @ X and A^T @ Y in f64, in
row blocks, at a stated numerics.

``numerics``:
- ``exact``: A as made (f32), products in f64;
- ``int8_rows``: A replaced by the serving storage rule's int8 rows
  (``quant.int8_rows``) times their scales, products in f64: what the
  serving cell's program factors, worked out again;
- ``int8`` / ``int4``: a control: A's rows and every panel quantized
  (per row / per column, 127 or 7 levels a side), as an int8 / int4
  product would read them; A^T Y folds A's row scales into Y before Y
  is quantized, as a row-scaled integer product must;
- ``tf32``: a control: A and every panel rounded to TF32.

A dense operand is read from ``blocks``, a callable that yields (first
row, f32 block) over this rank's rows (``operands.planted_blocks``, or
slices of a held tensor).  ``comm`` (:class:`Comm`) joins ranks: the
m x l panels are whole on every rank, each rank multiplies its rows.
"""

from __future__ import annotations

import warnings

import torch

from portbench.reference import quant

F64 = torch.float64


class Comm:
    """One rank alone: every collective is the identity."""
    rank, size = 0, 1

    def gather_rows(self, local):
        return local

    def sum(self, t):
        return t

    def bcast(self, t):
        return t


class DistComm(Comm):
    """Plain ``torch.distributed`` over the default group (the ranks each
    hold ``rows`` consecutive rows, in rank order)."""

    def __init__(self):
        import torch.distributed as dist
        self.dist = dist
        self.rank, self.size = dist.get_rank(), dist.get_world_size()

    def gather_rows(self, local):
        parts = [torch.empty_like(local) for _ in range(self.size)]
        self.dist.all_gather(parts, local.contiguous())
        return torch.cat(parts)

    def sum(self, t):
        t = t.contiguous()
        self.dist.all_reduce(t)
        return t

    def bcast(self, t):
        t = t.contiguous()
        self.dist.broadcast(t, 0)
        return t


def _levels(numerics):
    return {"int8": 127, "int4": 7}.get(numerics)


class DenseRef:
    """A dense operand of ``rows_local`` rows (this rank's) x ``cols``."""

    def __init__(self, blocks, rows_local, cols, numerics="exact",
                 comm=None):
        self.blocks, self.rows, self.cols = blocks, rows_local, cols
        self.numerics = numerics
        self.comm = comm or Comm()
        self.m = self.rows * self.comm.size
        self._scales = None

    def _block(self, blk):
        """(f64 block, f64 row scales or None): what a product reads."""
        if self.numerics == "exact":
            return blk.to(F64), None
        if self.numerics == "int8_rows":
            q8, scale = quant.int8_rows(blk)
            return q8.to(F64) * scale.to(F64)[:, None], None
        if self.numerics == "tf32":
            return quant.tf32(blk).to(F64), None
        codes, scale = quant.rows_codes(blk, _levels(self.numerics))
        return codes.to(F64), scale.to(F64)

    def _panel(self, x):
        if self.numerics == "tf32":
            return quant.tf32(x.float()).to(F64)
        lv = _levels(self.numerics)
        return x if lv is None else quant.cols_rounded(x, lv)

    def row_scales(self):
        """This rank's row scales at the control's levels (f64)."""
        if self._scales is None:
            lv = _levels(self.numerics)
            self._scales = torch.cat([quant.rows_codes(blk, lv)[1].to(F64)
                                      for _, blk in self.blocks()])
        return self._scales

    def mm(self, x):
        """A @ x (m x l, whole on every rank) for x (cols x l) f64."""
        x = self._panel(x)
        out = torch.empty(self.rows, x.shape[1], dtype=F64, device=x.device)
        for r0, blk in self.blocks():
            a, s = self._block(blk)
            y = a @ x
            out[r0:r0 + blk.shape[0]] = y if s is None else y * s[:, None]
        return self.comm.gather_rows(out)

    def tmm(self, y):
        """A^T @ y (cols x l) for y (m x l, whole) f64."""
        me = slice(self.comm.rank * self.rows, (self.comm.rank + 1)
                   * self.rows)
        y_loc = y[me]
        if _levels(self.numerics) is not None:
            # fold the row scales into y, then quantize y's columns
            # (over all m rows, so every rank rounds alike)
            w = y_loc * self.row_scales().to(y.device)[:, None]
            w = self.comm.gather_rows(w.contiguous())
            y_loc = quant.cols_rounded(w, _levels(self.numerics))[me]
        elif self.numerics == "tf32":
            y_loc = self._panel(y_loc)
        z = torch.zeros(self.cols, y.shape[1], dtype=F64, device=y.device)
        for r0, blk in self.blocks():
            a, _ = self._block(blk)
            z += a.T @ y_loc[r0:r0 + blk.shape[0]]
        return self.comm.sum(z)


class SparseRef:
    """A sparse operand from its COO entries (indices 2 x nnz, f32
    values), whole on this rank, held as f64 CSR of A and of A^T built
    here with plain torch (duplicates summed)."""

    def __init__(self, indices, values, shape, numerics="exact"):
        if numerics not in ("exact", "tf32"):
            raise ValueError(f"sparse numerics {numerics!r}")
        self.numerics = numerics
        vals = quant.tf32(values) if numerics == "tf32" else values
        coo = torch.sparse_coo_tensor(indices, vals.to(F64), shape,
                                      check_invariants=False)
        with warnings.catch_warnings():      # "CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            self.fwd = coo.coalesce().to_sparse_csr()
            self.bwd = coo.t().coalesce().to_sparse_csr()
        self.m, self.cols = shape
        self.comm = Comm()

    def _panel(self, x):
        return quant.tf32(x.float()).to(F64) if self.numerics == "tf32" \
            else x

    def mm(self, x):
        return self.fwd @ self._panel(x).contiguous()

    def tmm(self, y):
        return self.bwd @ self._panel(y).contiguous()
