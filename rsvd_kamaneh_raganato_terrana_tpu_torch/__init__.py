"""PyTorch/CUDA port of the randomized low-rank factorization engine.

The JAX package ``rsvd_kamaneh_raganato_terrana_tpu`` is the reference;
this package mirrors its layout and names with PyTorch idiom inside:
plain functions on tensors, the device taken from the input tensor (or
passed explicitly), random numbers from an explicit ``torch.Generator``.
It imports ``torch`` and never ``jax``.

Layer map (the ported part so far):

- ``core``   -- precision map and storage modes (``device``), device
               meshes (``mesh``), the process group and the sharded
               operand (``distributed``), the counted collectives
               (``collectives``), seeded
               sketch RNG on the card (``rng``), numpy <-> tensor
               hand-over (``convert``), MatrixMarket and dataset I/O on
               the host library of ``native/`` (``io``), the
               configuration dataclasses and parsers (``config``), FLOP
               counts (``profiling``).
- ``ops``    -- the primitive operations, single-device and sharded.
- ``linalg`` -- CholeskyQR family and ``qr_reduced``, Newton--Schulz
               polar (``polar``), the SVD engines (tournament Jacobi
               ``jacobi`` with its block engine, power iteration
               ``power``, the dispatch ``svd``), the incremental SVD
               (``incremental``) and the hand-written Hopper kernels
               (``kernels``: K1 ``fused_cholqr1``, K2 ``polar_qr_fused``,
               K3 ``eigh_small``, K4 ``fused_sketch_matmul``, K5
               ``quantize_uint8``; sources in ``csrc/``, built by
               ``linalg/_build.py``).
- ``rsvd``   -- the randomized SVD driver (finishes 'project',
               'rowspace', 'utv', 'rowspace_utv'; bf16 and int8
               storage), the serving preset (``serving``), the health
               check and subspace angles (``diagnostics``), UTV
               (``utv``), Frequent Directions (``fd``), interpolative and
               CUR decompositions (``interp``), DEIM (``deim``), and the
               batched, warm-started, one-pass and adaptive-rank modes.
- ``apps``   -- PCA (``pca``, its CLI ``pca_main``), the rSVD CLI over
               MatrixMarket files (``rsvd_main``), the image codec
               (``image``, its CLI ``image_main``) and POD/ROM (the
               advection-diffusion FOM ``advdiff``, the POD algorithms
               ``pod``, the Galerkin and DEIM ROMs and their drivers
               ``rom``, its CLI ``pod_main``); ``python -m
               rsvd_kamaneh_raganato_terrana_tpu_torch rsvd|pca|image|pod``.
"""

__version__ = "0.1.0"

from rsvd_kamaneh_raganato_terrana_tpu_torch.core import (  # noqa: F401
    make_mesh,
    read_matrix_market,
    write_matrix_market,
)
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
