"""Operation counts of the rSVD pipeline (the JAX package's
``core/profiling.py::rsvd_flops``, copied: that module imports jax)."""

from __future__ import annotations


def rsvd_flops(m: int, n: int, l: int, q: int) -> float:
    """FLOP count of the dense rSVD pipeline (sketch + q power rounds +
    B-projection + QR work), used for the GFLOP/s benchmark metrics."""
    sketch = 2.0 * m * n * l
    power = q * 2 * (2.0 * m * n * l)     # A^T Q and A Z per round
    proj = 2.0 * m * n * l                # B = Q^T A
    qr = (2 * q + 1) * 2.0 * m * l * l    # CholeskyQR-ish cost per orthonormalization
    return sketch + power + proj + qr
