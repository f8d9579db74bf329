"""Stochastic Lanczos quadrature: tr(f(A)) for symmetric A without f(A)
(the JAX package's ``rsvd/slq.py``; Ubaru, Chen & Saad 2017):

    tr(f(A)) ~ (n/m) sum_i  sum_j (e_1^T u_j^{(i)})^2 f(theta_j^{(i)})

with (theta, u) the eigenpairs of the steps x steps tridiagonal T_i that
Lanczos builds from the Rademacher probe v_i.

Lanczos keeps FULL reorthogonalization, twice, against a fixed
(steps, n) basis whose rows past the current step are zero, as the JAX
scan does.  The probes run together: each step is one product of A with
the n x m block of current vectors (the JAX package vmaps one probe's
Lanczos over the probes), and the m small tridiagonal eigenproblems are
one batched ``torch.linalg.eigh`` (``core/device.py::eigh_nan``).  A matrix-free operator
``apply_a(v, *operands)`` on single vectors is batched the same way by
``torch.func.vmap``.  The probes come from ``rademacher`` on a generator
seeded from ``seed`` (torch Philox draws, not JAX's values).

A DTensor whose rows are sharded is read block by block.  In
``slq_trace`` each step's A V is the local rows' product, gathered (one
counted all-gather of the n x m block a step), and the Lanczos
recurrence, its vectors and the quadrature run replicated on every rank,
the probes drawn whole, as on one card.  ``lanczos_tridiag`` keeps its
vector row-split instead (its docstring).
"""

from __future__ import annotations

from typing import Callable

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    eigh_nan,
    ieee_fp32,
    matmul_at,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
    key_from_seed,
    rademacher,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import Sharded
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _like,
    _norm,
    _reduce,
    _row_block,
    _row_split,
    _sharded_view,
    _whole,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import _mm

_EPS = 1e-30


def _mv(a, v):
    return matmul_at(a, v, "highest")


def _lanczos_block(apply_a, v0, steps: int, rows=None):
    """``steps`` Lanczos iterations from each column of the (unnormalized)
    n x m block v0, with full reorthogonalization against every stored
    vector of its own probe, twice.  Returns (alpha: steps x m,
    beta: (steps - 1) x m).

    With ``rows`` a row split (:class:`Sharded`), v0 and every vector are
    this rank's rows of them: the dot products and the norms are
    completed over the rows (counted all-reduces, the norms' partials
    combined as ``rsvd/_sharded.py::_norm`` does), and ``apply_a`` maps
    this rank's rows of v to its rows of A v.

    An early (invariant-subspace) breakdown gives beta ~ 0, and the later
    quadrature weights vanish."""
    n, m = v0.shape

    def col_norm(x):
        return _norm(_like(rows, x), dim=0)

    v = v0 / torch.clamp(col_norm(v0), min=_EPS)
    basis = v0.new_zeros((steps, n, m))
    basis[0] = v
    alphas = v0.new_zeros((steps, m))
    betas = v0.new_zeros((steps, m))
    for i in range(steps):
        w = apply_a(v)
        alpha = _reduce(torch.sum(v * w, dim=0), rows)
        w = w - alpha * v
        # rows past i are zero, so the products over the whole (steps, n)
        # basis are exact
        with ieee_fp32():
            for _ in range(2):
                coeff = _reduce(torch.einsum("snm,nm->sm", basis, w), rows)
                w = w - torch.einsum("snm,sm->nm", basis, coeff)
        beta = col_norm(w)
        v = w / torch.clamp(beta, min=_EPS)
        if i + 1 < steps:
            basis[i + 1] = v
        alphas[i] = alpha
        betas[i] = beta
    return alphas, betas[:-1]


def lanczos_tridiag(a, v0, steps: int):
    """``steps`` Lanczos iterations on the dense symmetric ``a`` from the
    (unnormalized) vector v0, fully reorthogonalized.  Returns
    (alpha: steps, beta: steps - 1) of the tridiagonal T.

    A DTensor whose rows are sharded takes v0 row-sharded alike or whole
    (each rank keeps its rows): the Lanczos vectors stay row-split, each
    step gathers the n-vector v once (a counted all-gather) for the local
    rows' A v, and its dot products and norms are all-reduced."""
    a = _row_split(a)
    v0 = _sharded_view(v0)
    if not isinstance(v0, Sharded):
        v0 = as_tensor(v0, device=a.device, dtype=a.dtype)
    if isinstance(a, Sharded):
        mine = v0.local if isinstance(v0, Sharded) else _row_block(a, v0)
        al, be = _lanczos_block(
            lambda x: _mv(a.local, _whole(a.with_local(x))),
            mine[:, None].to(a.dtype), steps, rows=a)
    else:
        al, be = _lanczos_block(lambda x: _mv(a, x), v0[:, None], steps)
    return al[:, 0], be[:, 0]


def _quadrature(alphas, betas, fn):
    """Gauss quadrature of each probe's tridiagonal (columns of alphas,
    betas): sum_j w_j^2 f(theta_j), one batched eigh."""
    t = (torch.diag_embed(alphas.T) + torch.diag_embed(betas.T, 1)
         + torch.diag_embed(betas.T, -1))
    theta, u = eigh_nan(t)
    w2 = u[:, 0, :] ** 2
    return torch.sum(w2 * fn(theta), dim=-1)


def _tensors(xs):
    """The tensors in ``xs``, nested tuples (a ``HodlrMatrix``) walked."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (tuple, list)):
            yield from _tensors(x)


def slq_trace(a, fn: Callable, seed=0, num_probes: int = 16,
              steps: int = 30, n: int = None, dtype=torch.float32,
              operands=()):
    """tr(f(A)) for symmetric A, f applied to Ritz values only.

    ``a``: a square matrix or a matrix-free operator
    ``apply_a(v, *operands) -> A v`` on single vectors (pass ``n``; the
    probes are drawn on the device of the first tensor in ``operands``,
    nested tuples included, the card when there is none); a matrix may
    be a row-sharded DTensor (the module docstring).  ``fn`` is an elementwise torch
    function (e.g. ``torch.log``, ``lambda x: 1 / (x + mu)``)."""
    if callable(a):
        if n is None:
            raise ValueError("matrix-free slq_trace needs n")
        n = int(n)
        dev = next((t.device for t in _tensors(operands)),
                   torch.device("cuda"))
        batched = torch.func.vmap(lambda v: a(v, *operands), in_dims=1,
                                  out_dims=1)
        apply_a = batched
    else:
        a = _row_split(a)
        n, dtype, dev = a.shape[0], a.dtype, a.device

        def apply_a(x):
            return _whole(_mm(a, x, "highest"))
    return slq_block(apply_a, n, dtype, dev, fn, seed, num_probes, steps)


def slq_block(apply_a, n: int, dtype, device, fn: Callable, seed=0,
              num_probes: int = 16, steps: int = 30):
    """tr(f(A)) by SLQ with ``apply_a`` taking the n x m block of Lanczos
    vectors to A times it (every rank's whole block, for an operator
    that gathers its product): the body of :func:`slq_trace`."""
    probes = rademacher(key_from_seed(seed, device), (num_probes, n), dtype)
    al, be = _lanczos_block(apply_a, probes.T, steps)
    return float(n) * torch.mean(_quadrature(al, be, fn))


def _logdet_fn(shift: float) -> Callable:
    """log(x + shift), floored at the dtype's tiny (a literal floor such
    as 1e-300 underflows to 0 in f32 and lets log(0) = -inf in for a
    numerically singular A)."""

    def fn(x):
        return torch.log(torch.clamp(x + shift,
                                     min=torch.finfo(x.dtype).tiny))

    return fn


def logdet_psd(a, seed=0, num_probes: int = 16, steps: int = 30,
               shift: float = 0.0, n: int = None, dtype=torch.float32,
               operands=()):
    """log det(A + shift I) for symmetric positive-definite A by SLQ: no
    Cholesky of A, ``steps`` products per probe.  ``a`` may be a
    matrix-free operator (pass ``n``/``operands``, see
    :func:`slq_trace`)."""
    return slq_trace(a, _logdet_fn(float(shift)), seed=seed,
                     num_probes=num_probes, steps=steps, n=n, dtype=dtype,
                     operands=operands)
