"""Randomized trace and diagonal estimation (the JAX package's
``rsvd/trace.py``):

  hutchinson     tr(A) ~ (1/m) sum_j g_j^T A g_j           Var ~ ||A||_F^2/m
  hutchpp        the dominant range's trace exactly from a sketch,
                 Hutchinson only on the deflated residual
                 (Meyer-Musco-Musco-Woodruff 2021)
  diag_estimate  diag(A) ~ E[g * (A g)] for Rademacher g (Bekas et al.
                 2007)

Each estimator is one to three products against A and a column-wise
contraction, in full precision.  The probes come from ``sketch_matrix``
on a generator seeded from ``seed`` (torch Philox draws, not the JAX
package's threefry values); Hutch++'s two sketches come from the seed's
generator folded with 0 and 1.

A DTensor whose rows are sharded is read block by block: A G stays
row-split, each quadratic form is summed over the local rows and
all-reduced, and the probes are drawn whole, as the one-card call draws
them, so the estimate does not depend on the split; the diagonal comes
back row-sharded.

Matrix-free calling convention, shared with ``rsvd/slq.py``:
``estimator(apply_a, n=..., operands=(op1, op2, ...))`` where
``apply_a(X, *operands)`` returns A X.  The probes are drawn on the
device of the first tensor in ``operands`` (the card when there is
none).
"""

from __future__ import annotations

import math

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    Sharded,
    row_dtensor,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
    fold_in_shard,
    key_from_seed,
    sketch_matrix,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import (
    orthonormal_basis,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION as _HI,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _like,
    _local,
    _reduce,
    _row_block,
    _row_split,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import _mm


def _quad_forms(apply_a, g):
    """g_j^T (A g_j) for every column j: one product and a contraction
    (over the local rows, all-reduced, where A G is row-split)."""
    y = apply_a(g)
    return _reduce(torch.sum(_row_block(y, g) * _local(y), dim=0), y)


def _operator(a, n, dtype, operands, who):
    """(apply_a, n, dtype, device) of a dense matrix or a matrix-free
    operator."""
    if callable(a):
        if n is None:
            raise ValueError(f"matrix-free {who} needs n")
        dev = next((o.device for o in operands
                    if isinstance(o, torch.Tensor)), torch.device("cuda"))
        return (lambda x: a(x, *operands)), int(n), dtype, dev
    a = _row_split(a)
    return (lambda x: _mm(a, x, _HI)), a.shape[0], a.dtype, a.device


def _std_err(x, dim, samples):
    return torch.std(x, dim=dim, correction=1) / math.sqrt(float(samples))


def hutchinson(a, seed=0, num_samples: int = 64, kind: str = "rademacher",
               n: int = None, dtype=torch.float32, operands=()):
    """Girard-Hutchinson trace estimator.  Returns ``(estimate,
    stderr)``, stderr the sample standard error of the ``num_samples``
    quadratic forms.  Rademacher probes (default) have a smaller
    variance than Gaussian ones for the same m.

    ``a`` is a square matrix OR a matrix-free operator
    ``apply_a(X, *operands) -> A X``, in which case ``n`` (and
    optionally ``dtype``) must be given and the operator's data passed
    in ``operands``."""
    apply_a, n, dtype, dev = _operator(a, n, dtype, operands, "hutchinson")
    g = sketch_matrix(key_from_seed(seed, dev), n, num_samples, dtype, kind)
    quad = _quad_forms(apply_a, g)
    return torch.mean(quad), _std_err(quad, 0, num_samples)


def hutchpp(a, seed=0, budget: int = 96, kind: str = "rademacher",
            n: int = None, dtype=torch.float32, operands=()):
    """Hutch++: with m = budget // 3, Q = orth(A S) for an n x m sketch S
    carries the dominant range, whose trace tr(Q^T A Q) is exact, and
    Hutchinson runs with m probes on (I - QQ^T) A (I - QQ^T).  Total
    products against A: budget.  ``a``: a square matrix or a
    matrix-free operator (see :func:`hutchinson`)."""
    apply_a, n, dtype, dev = _operator(a, n, dtype, operands, "hutchpp")
    m = max(budget // 3, 1)
    key = key_from_seed(seed, dev)
    s = sketch_matrix(fold_in_shard(key, 0), n, m, dtype, kind)
    g = sketch_matrix(fold_in_shard(key, 1), n, m, dtype, kind)
    q = orthonormal_basis(apply_a(s), "robust")
    t_range = torch.trace(_mm(q.T, apply_a(q), _HI))
    # (I - QQ^T) g deflates both sides of each residual quadratic form
    qq = _mm(q, _mm(q.T, g, _HI), _HI)
    gp = _like(qq, _row_block(qq, g) - _local(qq))
    return t_range + torch.mean(_quad_forms(apply_a, gp))


def diag_estimate(a, seed=0, num_samples: int = 128, n: int = None,
                  dtype=torch.float32, operands=()):
    """Stochastic diagonal estimation (Bekas-Kokiopoulou-Saad 2007):
    diag(A) = E[g * (A g)] for Rademacher g.  Returns ``(diag_est,
    stderr)`` with per-entry standard errors.  ``a``: a square matrix
    or a matrix-free operator (see :func:`hutchinson`)."""
    apply_a, n, dtype, dev = _operator(a, n, dtype, operands,
                                       "diag_estimate")
    g = sketch_matrix(key_from_seed(seed, dev), n, num_samples, dtype,
                      "rademacher")
    y = apply_a(g)
    prod = _row_block(y, g) * _local(y)            # n x m, row i -> a_ii
    out = torch.mean(prod, dim=1), _std_err(prod, 1, num_samples)
    if isinstance(y, Sharded):                     # row-sharded, as A
        return tuple(row_dtensor(t, y.mesh, y.rows, n) for t in out)
    return out
