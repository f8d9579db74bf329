"""Randomized SVD driver."""

from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (  # noqa: F401
    generate_omega,
    reconstruct,
    reconstruction_error,
    rsvd,
    rsvd_core,
    rsvd_with_omega,
)
