"""Factorizations: CholeskyQR family, the SVD engine and the Hopper
kernels."""

from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import (  # noqa: F401
    cholesky_qr,
    cholesky_qr1,
    cholesky_qr2,
    cholesky_qr3,
    orthonormal_basis,
    qr_full,
    qr_reduced,
    robust_cholesky_qr2,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.svd import (  # noqa: F401
    SVDMethod,
    svd,
)
