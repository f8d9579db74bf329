"""Factorizations: CholeskyQR family, Newton--Schulz polar, the SVD
engine and the Hopper kernels."""

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
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.polar import (  # noqa: F401
    ns_schedule,
    polar_orthonormalize,
    polar_qr,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.kernels import (  # noqa: F401
    polar_qr_fused,
)
