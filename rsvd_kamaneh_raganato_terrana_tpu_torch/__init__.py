"""PyTorch/CUDA port of the randomized low-rank factorization engine.

The JAX package ``rsvd_kamaneh_raganato_terrana_tpu`` is the reference;
this package mirrors its layout and names with PyTorch idiom inside:
plain functions on tensors, the device taken from the input tensor (or
passed explicitly), random numbers from an explicit ``torch.Generator``.
It imports ``torch`` and never ``jax``.

Layer map (the ported part so far):

- ``core``   -- precision map (``device``), seeded sketch RNG (``rng``),
               numpy <-> tensor hand-over (``convert``).
- ``ops``    -- the primitive products the QR/SVD/driver layers use.
- ``linalg`` -- CholeskyQR family and ``qr_reduced``, the Gram-eigh SVD
               tail, and the hand-written Hopper kernels (``kernels``,
               sources in ``csrc/``, built by ``linalg/_build.py``).
- ``rsvd``   -- the randomized SVD driver (``finish='project'``).
"""

__version__ = "0.1.0"

from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.svd import SVDMethod  # noqa: F401
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (  # noqa: F401
    generate_omega,
    rsvd,
    rsvd_with_omega,
)
