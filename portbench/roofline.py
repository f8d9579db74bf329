"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at
the 700 W limit) and the least work of a cell's stage-A products.

Repaired copy of ``chip_smoke.py::bound``, which divided every route's
operations by the f32 peak: here the peak is that of the precision the
products run in.
"""

from __future__ import annotations

PEAK_OPS = {           # operations per second
    "bf16": 989e12,
    "int8": 1979e12,
    "tf32": 495e12,
    "fp32": 67e12,     # outside the tensor cores
    "fp64": 67e12,
}
PEAK_BYTES = 3.35e12   # HBM3, bytes per second


def bound(ops: float, nbytes: float, peak: str):
    """(least seconds, 'operations' or 'bytes': which of the two bounds)."""
    t_ops, t_bytes = ops / PEAK_OPS[peak], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def spmm_bytes(rows, cols, nnz, l, idx_bytes=4, val_bytes=4):
    """Bytes a CSR x dense product must move (frozen copy of
    ``chip_smoke.py::spmm_bytes``): values and column indices once, the
    row pointers, the dense operand once, the output once."""
    return nnz * (val_bytes + idx_bytes) + 4 * (rows + 1) \
        + 4 * l * (cols + rows)


def products_least(work: dict, m: int, n: int, l: int, nnz: int = 0):
    """(least seconds, bound-by, ops, bytes) of one call's passes over A.

    ``work`` (the workload's ``products``): ``passes`` dependent passes;
    a dense A is read once at ``a_first`` bytes an element and at
    ``a_other`` in each other pass (the width of the precision's
    operands), each pass reads its panel at ``panel`` bytes an element
    and writes its f32 output once; a sparse A (``sparse``: true) moves
    ``spmm_bytes`` a pass, half of them through A^T's CSR.  Operations:
    2 m n l (2 nnz l sparse) a pass, at the ``peak`` of the precision."""
    p = work["passes"]
    if work.get("sparse"):
        fwd = spmm_bytes(m, n, nnz, l)
        bwd = spmm_bytes(n, m, nnz, l)
        nbytes = sum(fwd if i % 2 == 0 else bwd for i in range(p))
        ops = 2.0 * nnz * l * p
    else:
        nbytes = m * n * (work["a_first"] + work["a_other"] * (p - 1))
        # passes alternate A X (reads n x l, writes m x l) and A^T Y
        for i in range(p):
            rd, wr = (n, m) if i % 2 == 0 else (m, n)
            nbytes += rd * l * work["panel"] + wr * l * 4
        ops = 2.0 * m * n * l * p
    t, by = bound(ops, nbytes, work["peak"])
    return t, by, ops, nbytes
