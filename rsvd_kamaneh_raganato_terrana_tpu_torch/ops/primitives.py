"""Primitive single-device operations (the JAX package's
``ops/primitives.py``).  The ``*_sharded`` variants wait for the
distributed slice (ROADMAP.md, queue 1)."""

from __future__ import annotations

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import matmul_at

# Linear-algebra accuracy (QR/Gram conditioning) needs full fp32
# products: no TF32, no bf16 operand rounding.
DOT_PRECISION = "highest"


def matmul(a, b):
    """C = A @ B at full precision, in A's dtype."""
    return matmul_at(a, b, DOT_PRECISION)


def matvec(a, x):
    """y = A @ x at full precision, in A's dtype."""
    if x.dim() == 1:
        return matmul_at(a, x[:, None], DOT_PRECISION)[:, 0]
    return matmul_at(a, x, DOT_PRECISION)


def frobenius_norm(a):
    """||A||_F as the square root of the sum of squares."""
    return torch.sqrt(torch.sum(torch.square(a)))


def normalize(x, eps=0.0):
    """x / (||x||_2 + eps), the 2-norm of x flattened."""
    return x / (torch.linalg.vector_norm(x) + eps)


def transpose(a):
    """A^T over the last two axes."""
    return torch.swapaxes(a, -1, -2)


def gram(a):
    """G = A^T A at full precision."""
    return matmul_at(transpose(a), a, DOT_PRECISION)
