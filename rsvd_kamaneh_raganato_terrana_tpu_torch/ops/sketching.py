"""Sparse sign embeddings (CountSketch / OSNAP): S x in O(t m n) (the
JAX package's ``ops/sketching.py``).

S (s x m) has exactly t nonzeros, +-1/sqrt(t), in each column, so S x is
t scaled, sign-flipped scatter-adds of x's rows into s buckets: no
s*m*n GEMM.  Each round j is one ``index_add_`` over the rows.  Its
buckets and signs come from a generator of its own, the seed's key
folded with j (``core/rng.py::fold_in_shard``), never from a global
stream: the same seed gives the same S on every call.  They are torch
Philox draws and do not reproduce the JAX package's threefry values.
On CUDA ``index_add_`` adds with atomics, so S x is not bitwise the
same from run to run; it agrees with the same S applied on the CPU to
rounding.
"""

from __future__ import annotations

import math

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
    fold_in_shard,
    key_from_seed,
)


def _buckets_and_signs(key: torch.Generator, m: int, sketch_size: int,
                       t: int):
    """Round j's (bucket ids (m,) int64, signs (m,) bool: True = +) for
    j = 0 .. t-1, each drawn from ``fold_in_shard(key, j)``."""
    out = []
    for j in range(t):
        gen = fold_in_shard(key, j)
        bucket = torch.randint(0, sketch_size, (m,), generator=gen,
                               device=gen.device)
        sign = torch.rand((m,), generator=gen, device=gen.device) < 0.5
        out.append((bucket, sign))
    return out


def countsketch_apply(key_or_seed, x, sketch_size: int,
                      nnz_per_row: int = 8):
    """S x for a sparse sign embedding S (sketch_size x m) defined by the
    key or seed; x: (m,) or (m, n).  ``nnz_per_row`` is OSNAP's t
    (nonzeros per column of S); t = 1 is CountSketch.

    E[S^T S] = I, so E||S x||_F^2 = ||x||_F^2 for any fixed x, and for an
    orthonormal-column Q the spectrum of S Q concentrates around 1.  An
    int seed draws on x's device; a generator must live there."""
    return countsketch_rows(key_or_seed, x, sketch_size, nnz_per_row)


def countsketch_rows(key_or_seed, x, sketch_size: int, nnz_per_row: int = 8,
                     start: int = 0, total: int | None = None):
    """S[:, start:start + len(x)] x: the columns of the embedding of
    :func:`countsketch_apply` over ``total`` rows (default len(x)) that
    meet rows ``start`` onwards, applied to ``x``.  The buckets and signs
    are drawn for all ``total`` rows, so a row block's sketches summed
    over the blocks are S applied to the whole."""
    key = key_from_seed(key_or_seed, x.device)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    m = x.shape[0]
    total = m if total is None else total
    t = int(nnz_per_row)
    out = x.new_zeros((sketch_size,) + tuple(x.shape[1:]))
    scale = 1.0 / math.sqrt(float(t))
    for bucket, sign in _buckets_and_signs(key, total, sketch_size, t):
        bucket, sign = bucket[start:start + m], sign[start:start + m]
        mag = torch.full((m,), scale, dtype=x.dtype, device=x.device)
        signed = torch.where(sign, mag, -mag)
        out.index_add_(0, bucket, signed[:, None] * x)
    return out[:, 0] if squeeze else out
