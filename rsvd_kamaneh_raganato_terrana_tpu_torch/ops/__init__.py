"""Primitive single-device operations (`primitives`)."""

from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (  # noqa: F401
    DOT_PRECISION,
    frobenius_norm,
    gram,
    matmul,
    matvec,
    normalize,
    transpose,
)
