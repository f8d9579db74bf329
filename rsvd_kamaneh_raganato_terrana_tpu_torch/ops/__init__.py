"""Primitive single-device operations (`primitives`) and sparse sign
embeddings (`sketching`)."""

from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (  # noqa: F401
    DOT_PRECISION,
    frobenius_norm,
    gram,
    matmul,
    matvec,
    normalize,
    transpose,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.sketching import (  # noqa: F401
    countsketch_apply,
)
