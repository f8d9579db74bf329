"""Entry point of the port's main path: the counterpart of
``__graft_entry__.py::entry()`` with this package's configuration.

A rank-64 randomized SVD (k=64, p=16, q=2): Gaussian sketch -> q power
rounds with reorth='half' -> every orthonormalization by the fused
CholeskyQR1 kernel (K1) -> B = Q^T A -> Gram-eigh tail -> U = Q U_tilde,
with bf16-operand / f32-accumulation stage-A GEMMs (precision='default').
"""

from __future__ import annotations

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import from_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    generate_omega,
    rsvd_with_omega,
)

K, P, Q = 64, 16, 2
CONFIG = dict(q=Q, k=K, method="eigh", qr_method="cholqr1_fused",
              interior_qr="cholqr1_fused", reorth="half", finish="project")


def entry(device="cuda", m: int = 1024, n: int = 1024,
          precision: str = "default"):
    """(forward, example_args): the main-path forward step and an m x n
    f32 operand made from seed 0 on ``device``."""

    def forward(a):
        omega = generate_omega(0, a.shape[1], K + P, a.dtype,
                               device=a.device)
        return rsvd_with_omega(a, omega, precision=precision, **CONFIG)

    a = from_numpy(np.random.default_rng(0).standard_normal((m, n)),
                   device=device, dtype=torch.float32)
    return forward, (a,)
