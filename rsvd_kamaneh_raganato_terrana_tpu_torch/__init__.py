"""PyTorch/CUDA port of the randomized low-rank factorization engine.

The JAX package ``rsvd_kamaneh_raganato_terrana_tpu`` is the reference;
this package mirrors its layout and names with PyTorch idiom inside:
plain functions on tensors, the device taken from the input tensor (or
passed explicitly), random numbers from an explicit ``torch.Generator``.
It imports ``torch`` and never ``jax``.

Layer map (the ported part so far):

- ``core``   -- precision map and storage modes (``device``), seeded
               sketch RNG on the card (``rng``), numpy <-> tensor
               hand-over (``convert``), FLOP counts (``profiling``).
- ``ops``    -- the primitive products the QR/SVD/driver layers use.
- ``linalg`` -- CholeskyQR family and ``qr_reduced``, Newton--Schulz
               polar (``polar``), the SVD engines (tournament Jacobi
               ``jacobi``, power iteration ``power``, the dispatch
               ``svd``) and the hand-written Hopper kernels
               (``kernels``: K1 ``fused_cholqr1``, K2 ``polar_qr_fused``,
               K3 ``eigh_small``, K4 ``fused_sketch_matmul``, K5
               ``quantize_uint8``; sources in ``csrc/``, built by
               ``linalg/_build.py``).
- ``rsvd``   -- the randomized SVD driver (finishes 'project',
               'rowspace', 'utv', 'rowspace_utv'; bf16 and int8
               storage), the serving preset (``serving``), the health
               check and subspace angles (``diagnostics``), UTV
               (``utv``), and the batched, warm-started, one-pass and
               adaptive-rank modes.
- ``apps``   -- the image codec (``image``, its CLI ``image_main``;
               ``python -m rsvd_kamaneh_raganato_terrana_tpu_torch
               image <img>``), on the host codec of ``native/``.
"""

__version__ = "0.1.0"

from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import (  # noqa: F401
    SVD,
    SVDMethod,
    cholesky_qr2,
    jacobi_svd,
    power_svd,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.diagnostics import (  # noqa: F401
    factor_health,
    principal_angles,
    subspace_distance,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (  # noqa: F401
    Int8Stored,
    generate_omega,
    quantize_int8_rows,
    rsvd,
    rsvd_adaptive,
    rsvd_batched,
    rsvd_image_preset,
    rsvd_onepass,
    rsvd_warm,
    rsvd_with_omega,
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
