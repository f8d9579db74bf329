"""Primitive operations, single-device and sharded (`primitives`), and
sparse sign embeddings (`sketching`)."""

from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (  # noqa: F401
    DOT_PRECISION,
    frobenius_norm,
    generate_gaussian_sharded,
    gram,
    gram_sharded,
    matmul,
    matmul_reduce_scatter,
    matmul_sharded,
    matvec,
    matvec_sharded,
    norm_sharded,
    normalize,
    normalize_sharded,
    ring_shift_rows,
    transpose,
    transpose_sharded,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.sketching import (  # noqa: F401
    countsketch_apply,
)
