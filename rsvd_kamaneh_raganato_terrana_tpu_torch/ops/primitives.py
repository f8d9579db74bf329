"""Primitive products (the JAX package's ``ops/primitives.py``, as far as
the QR, SVD and driver layers need it).  The ``*_sharded`` variants wait
for the distributed slice (ROADMAP.md, queue 1)."""

from __future__ import annotations

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import matmul_at

# Linear-algebra accuracy (QR/Gram conditioning) needs full fp32
# products: no TF32, no bf16 operand rounding.
DOT_PRECISION = "highest"


def matmul(a, b):
    """C = A @ B at full precision, in A's dtype."""
    return matmul_at(a, b, DOT_PRECISION)


def gram(a):
    """G = A^T A at full precision."""
    return matmul_at(a.T, a, DOT_PRECISION)
