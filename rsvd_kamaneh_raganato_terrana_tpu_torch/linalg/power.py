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

from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import matmul_at
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    Sharded,
    row_sharded_api,
)
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


def _av(a, x):
    """A x: for a row-split A (:class:`Sharded`), this rank's rows."""
    if isinstance(a, Sharded):
        return _matvec(a.local, x)
    return _matvec(a, x)


def _atv(a, y):
    """A^T y: for a row-split A and y its rows, the local products summed
    over the rows (a counted all-reduce), replicated."""
    if isinstance(a, Sharded):
        return collectives.all_reduce(_matvec(a.local.T, y), a.rows.group)
    return _matvec(a.T, y)


def _vec_norm(a, u):
    """||u|| of A's m-vector u (this rank's rows of it where A is split:
    the local norms combined over the ranks, ``rsvd/_sharded.py::_norm``)."""
    if isinstance(a, Sharded):
        from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
            _norm,
        )

        return _norm(a.with_local(u[:, None]))
    return torch.linalg.norm(u)


def _power_triplet(a, x0, num_iters: int):
    v = x0 / torch.linalg.norm(x0)
    for _ in range(num_iters):
        z = _atv(a, _av(a, v))
        v = z / torch.linalg.norm(z)
    av = _av(a, v)
    sigma = _vec_norm(a, av)
    u = av / torch.clamp(sigma, min=torch.finfo(a.dtype).tiny)
    return sigma, u, v


@row_sharded_api
def power_triplet(a, x0, num_iters: int):
    """Dominant singular triplet (sigma, u, v) of ``a`` by power iteration
    on the Gram operator, A^T A never formed.  A DTensor whose rows are
    sharded runs each step as split products (A v on the local rows,
    A^T (A v) all-reduced, ||A v|| completed over the rows): u comes back
    row-sharded, sigma and v replicated."""
    sigma, u, v = _power_triplet(a, x0, num_iters)
    if isinstance(a, Sharded):
        u = Sharded(u, (a.shape[0],), a.mesh, a.rows)
    return sigma, u, v


class PowerSVDResult(NamedTuple):
    u: torch.Tensor
    s: torch.Tensor
    v: torch.Tensor
    effective_rank: torch.Tensor  # number of sigma_i above the cutoff


@row_sharded_api
def power_svd(a, k: Optional[int] = None, num_iters: Optional[int] = None,
              seed: int = 0,
              deflation_cutoff: float = DEFLATION_CUTOFF) -> PowerSVDResult:
    """Truncated SVD by repeated power iteration and deflation: U m x k,
    s (k,), V n x k in the standard orientation.  A DTensor whose rows
    are sharded is deflated block by block (:func:`power_triplet`'s
    split steps): U comes back row-sharded, s and V replicated."""
    m, n = a.shape
    if k is None:
        k = min(m, n)
    if num_iters is None:
        num_iters = theoretical_iterations(n)
    x0s = gaussian(key_from_seed(seed, a.device), (k, n), a.dtype)
    a_res = a
    us, ss, vs = [], [], []
    split = isinstance(a, Sharded)
    a_res = a.local if split else a
    for x0 in x0s:
        sigma, u, v = _power_triplet(a.with_local(a_res) if split
                                     else a_res, x0, num_iters)
        keep = sigma > deflation_cutoff
        sigma = torch.where(keep, sigma, torch.zeros_like(sigma))
        u = torch.where(keep, u, torch.zeros_like(u))
        v = torch.where(keep, v, torch.zeros_like(v))
        a_res = a_res - sigma * torch.outer(u, v)
        us.append(u)
        ss.append(sigma)
        vs.append(v)
    rows = a_res.shape[0]
    s = torch.stack(ss) if ss else a_res.new_zeros((0,))
    u_mat = torch.stack(us, dim=1) if us else a_res.new_zeros((rows, 0))
    v_mat = torch.stack(vs, dim=1) if vs else a_res.new_zeros((n, 0))
    if split:
        u_mat = a.with_local(u_mat)
    return PowerSVDResult(u_mat, s, v_mat,
                          torch.sum(s > 0).to(torch.int32))
