"""The serving preset: the low-latency factorization stack in one call
(the JAX package's ``rsvd/serving.py``).

finish='rowspace_utv' with 'cholqr1' QRs and reorth='half' on int8
stage-A storage (pre-quantized), with its guard rails:

- the operand is quantized ONCE (:func:`prepare_operand`) and reused
  across calls -- quantizing per call re-reads the f32 A;
- every factorization is checked post-hoc by
  :func:`rsvd.diagnostics.factor_health` (the serving configurations
  have NO rank-deficiency fallback: cholqr1 NaNs) -- one 5-element
  fetch;
- monitoring that needs true singular values calls
  :func:`rsvd.utv.utv_rescore` on the returned factors.

``interior_qr='polar_fused'`` runs every interior orthonormalization on
the hand-written Hopper kernel K2 (two launches per call at q = 2).
Use the plain :func:`rsvd.driver.rsvd` (robust QR, project finish)
whenever full accuracy contracts matter more than latency.
"""

from __future__ import annotations

import warnings

from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.diagnostics import (
    factor_health,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    Int8Stored,
    quantize_int8_rows,
    rsvd,
)

#: quantize A once for repeated serving calls
prepare_operand = quantize_int8_rows


def rsvd_serving(a, k: int, p: int = 16, q: int = 2, seed: int = 0,
                 interior_qr: str = "cholqr1", storage: str = "int8",
                 on_unhealthy: str = "raise", health_tol: float = 1e-2):
    """Factor A with the serving stack; returns (U, s, V, health).

    ``a``: a dense tensor (a non-tensor array goes to the card) or a
    pre-quantized :class:`Int8Stored` from :func:`prepare_operand`.
    ``storage``: 'int8' (default) | 'bf16' | 'default' -- the stage-A
    read mode (an :class:`Int8Stored` is read as int8 under any of them).
    ``interior_qr``: 'cholqr1' (default) | 'none' (flat spectra only) |
    any ``qr_reduced`` method, e.g. 'polar_fused' (kernel K2).
    ``on_unhealthy``: 'raise' | 'warn' | 'ignore' -- what to do when
    :func:`factor_health` trips; the health dict is returned either way
    (None when 'ignore' skips the check).

    s are decomposition WEIGHTS (exact energy; sigma-tracking needs
    gapped spectra -- :func:`rsvd.utv.utv_rescore` recovers sigma), U is
    unit-column, V orthonormal."""
    if on_unhealthy not in ("raise", "warn", "ignore"):
        raise ValueError(f"unknown on_unhealthy {on_unhealthy!r}")
    operand = a
    if storage == "int8" and not isinstance(a, Int8Stored):
        operand = quantize_int8_rows(a)
    u, s, v = rsvd(operand, k=k, p=p, q=q, seed=seed, method="eigh",
                   precision=storage, reorth="half", qr_method="cholqr1",
                   interior_qr=interior_qr, finish="rowspace_utv")
    health = None
    if on_unhealthy != "ignore":
        health = factor_health(u, s, v, tol=health_tol)
        if not health["ok"]:
            msg = ("rsvd_serving produced unhealthy factors "
                   f"({health}): the serving stack has no "
                   "rank-deficiency fallback -- use rsvd(..., "
                   "qr_method='robust') for this operand")
            if on_unhealthy == "raise":
                raise FloatingPointError(msg)
            warnings.warn(msg, stacklevel=2)
    return u, s, v, health
