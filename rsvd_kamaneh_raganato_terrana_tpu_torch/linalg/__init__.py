"""Factorizations: CholeskyQR family, Newton--Schulz polar, the Jacobi
and power SVD engines, the SVD dispatch and the Hopper kernels."""

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
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.jacobi import (  # noqa: F401
    givens_rotation,
    jacobi_svd,
    make_jacobi,
    round_robin_schedule,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.power import (  # noqa: F401
    PowerSVDResult,
    power_svd,
    power_triplet,
    theoretical_iterations,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.svd import (  # noqa: F401
    SVD,
    SVDMethod,
    svd,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.polar import (  # noqa: F401
    ns_schedule,
    polar_orthonormalize,
    polar_qr,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.kernels import (  # noqa: F401
    eigh_small,
    fused_sketch_matmul,
    polar_qr_fused,
    quantize_uint8,
)
