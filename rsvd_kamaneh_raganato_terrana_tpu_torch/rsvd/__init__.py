"""Randomized SVD driver, serving preset, diagnostics, UTV and Frequent
Directions."""

from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.diagnostics import (  # noqa: F401
    factor_health,
    principal_angles,
    subspace_distance,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (  # noqa: F401
    Int8Stored,
    generate_omega,
    quantize_int8_rows,
    power_refine,
    reconstruct,
    reconstruction_error,
    adaptive_work_ratio,
    rsvd,
    rsvd_adaptive,
    rsvd_batched,
    rsvd_core,
    rsvd_image_preset,
    rsvd_onepass,
    rsvd_warm,
    rsvd_with_omega,
    subspace_iteration,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.fd import (  # noqa: F401
    FrequentDirections,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.serving import (  # noqa: F401
    prepare_operand,
    rsvd_serving,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.utv import (  # noqa: F401
    rutv,
    rutv_reconstruct,
    utv_rescore,
)
