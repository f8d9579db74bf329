"""Power-method SVD with deflation (the JAX package's ``linalg/power.py``).

Each triplet iterates x <- normalize(A^T (A x)) without forming A^T A,
then deflates A <- A - sigma u v^T.  JAX's ``fori_loop`` and ``scan``
become Python loops with no host sync; all k triplets are computed and
those with sigma below the deflation cutoff are zeroed, so
``effective_rank`` carries the truncation.  The iteration count is the
theoretical bound s = ceil(log(4 log(2n/delta) / (eps delta)) /
(2 lambda)) with eps = 1e-10, delta = 0.05, lambda = 0.1.

The start vectors x0 are drawn from a ``torch.Generator`` seeded from
``seed`` on A's device (``core/rng.py``): a seed selects a stream, and
does not reproduce JAX's values.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import matmul_at
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
    gaussian,
    key_from_seed,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION,
)

DEFLATION_CUTOFF = 1e-12


def theoretical_iterations(n: int, eps: float = 1e-10, delta: float = 0.05,
                           lam: float = 0.1) -> int:
    """The iteration bound: ~148 for n = 100."""
    return int(math.ceil(
        math.log(4.0 * math.log(2.0 * n / delta) / (eps * delta)) / (2.0 * lam)
    ))


def _matvec(a, x):
    return matmul_at(a, x[:, None], DOT_PRECISION)[:, 0]


def power_triplet(a, x0, num_iters: int):
    """Dominant singular triplet (sigma, u, v) of ``a`` by power iteration
    on the Gram operator, A^T A never formed."""
    v = x0 / torch.linalg.norm(x0)
    for _ in range(num_iters):
        z = _matvec(a.T, _matvec(a, v))
        v = z / torch.linalg.norm(z)
    av = _matvec(a, v)
    sigma = torch.linalg.norm(av)
    u = av / torch.clamp(sigma, min=torch.finfo(a.dtype).tiny)
    return sigma, u, v


class PowerSVDResult(NamedTuple):
    u: torch.Tensor
    s: torch.Tensor
    v: torch.Tensor
    effective_rank: torch.Tensor  # number of sigma_i above the cutoff


def power_svd(a, k: Optional[int] = None, num_iters: Optional[int] = None,
              seed: int = 0,
              deflation_cutoff: float = DEFLATION_CUTOFF) -> PowerSVDResult:
    """Truncated SVD by repeated power iteration and deflation: U m x k,
    s (k,), V n x k in the standard orientation."""
    m, n = a.shape
    if k is None:
        k = min(m, n)
    if num_iters is None:
        num_iters = theoretical_iterations(n)
    x0s = gaussian(key_from_seed(seed, a.device), (k, n), a.dtype)
    a_res = a
    us, ss, vs = [], [], []
    for x0 in x0s:
        sigma, u, v = power_triplet(a_res, x0, num_iters)
        keep = sigma > deflation_cutoff
        sigma = torch.where(keep, sigma, torch.zeros_like(sigma))
        u = torch.where(keep, u, torch.zeros_like(u))
        v = torch.where(keep, v, torch.zeros_like(v))
        a_res = a_res - sigma * torch.outer(u, v)
        us.append(u)
        ss.append(sigma)
        vs.append(v)
    s = torch.stack(ss) if ss else a.new_zeros((0,))
    u_mat = torch.stack(us, dim=1) if us else a.new_zeros((m, 0))
    v_mat = torch.stack(vs, dim=1) if vs else a.new_zeros((n, 0))
    return PowerSVDResult(u_mat, s, v_mat,
                          torch.sum(s > 0).to(torch.int32))
