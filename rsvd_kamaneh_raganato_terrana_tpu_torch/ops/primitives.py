"""Primitive operations (the JAX package's ``ops/primitives.py``):
single-device ones, and the ``*_sharded`` and ring variants with their
collectives spelled out (the JAX ``shard_map`` forms; the reference's
MPI gallery).

A sharded argument is a DTensor, or the full tensor, which every rank
holds and whose block each rank takes (``core/mesh.py``).  A result the
JAX variant returns replicated (``out_specs=P()``) is a plain tensor,
the same on every rank; a row-sharded one is a DTensor.  Every
collective goes through ``core/collectives.py``, which counts it.
"""

from __future__ import annotations

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import matmul_at
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    is_dtensor,
    mesh_axis,
    row_dtensor,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.mesh import ROWS_AXIS

# Linear-algebra accuracy (QR/Gram conditioning) needs full fp32
# products: no TF32, no bf16 operand rounding.
DOT_PRECISION = "highest"


def matmul(a, b):
    """C = A @ B at full precision, in A's dtype."""
    return matmul_at(a, b, DOT_PRECISION)


def matvec(a, x):
    """y = A @ x at full precision, in A's dtype."""
    if x.dim() == 1:
        return matmul_at(a, x[:, None], DOT_PRECISION)[:, 0]
    return matmul_at(a, x, DOT_PRECISION)


def frobenius_norm(a):
    """||A||_F as the square root of the sum of squares."""
    return torch.sqrt(torch.sum(torch.square(a)))


def normalize(x, eps=0.0):
    """x / (||x||_2 + eps), the 2-norm of x flattened."""
    return x / (torch.linalg.vector_norm(x) + eps)


def transpose(a):
    """A^T over the last two axes."""
    return torch.swapaxes(a, -1, -2)


def gram(a):
    """G = A^T A at full precision."""
    return matmul_at(transpose(a), a, DOT_PRECISION)


# ---------------------------------------------------------------------------
# Sharded variants (communication contracts spelled out).
# ---------------------------------------------------------------------------


def local_block(x, ax, dim: int = 0):
    """This rank's block of ``x`` along ``dim``: a DTensor's local block,
    or the rank's slice of a full tensor."""
    if is_dtensor(x):
        return x.to_local()
    step = x.shape[dim] // ax.size
    return x.narrow(dim, ax.index * step, step)


def _full(x):
    """A replicated argument as a plain tensor."""
    return x.full_tensor() if is_dtensor(x) else x


def matvec_sharded(mesh, a, x, axis=ROWS_AXIS):
    """Row-sharded mat-vec whose result every rank gets whole: the local
    product, then one all-gather (the reference's Gatherv + Bcast pair,
    PM.cpp:60-68)."""
    ax = mesh_axis(mesh, axis)
    y = matvec(local_block(a, ax), _full(x))
    return collectives.all_gather(y, ax.group)


def matmul_sharded(mesh, a, b, axis=ROWS_AXIS):
    """Row-sharded GEMM: the local block GEMM; C stays row-sharded."""
    ax = mesh_axis(mesh, axis)
    return row_dtensor(matmul(local_block(a, ax), _full(b)), mesh, ax,
                         a.shape[0])


def norm_sharded(mesh, a, axis=ROWS_AXIS):
    """Frobenius norm: the local sum of squares, all-reduced."""
    ax = mesh_axis(mesh, axis)
    blk = local_block(a, ax)
    return torch.sqrt(collectives.all_reduce(torch.sum(torch.square(blk)),
                                             ax.group))


def normalize_sharded(mesh, x, axis=ROWS_AXIS):
    """A row-sharded vector over its 2-norm: the norm all-reduced, the
    scaling local (no gather and re-scatter)."""
    ax = mesh_axis(mesh, axis)
    blk = local_block(x, ax)
    nrm = torch.sqrt(collectives.all_reduce(torch.sum(torch.square(blk)),
                                            ax.group))
    return row_dtensor(blk / nrm, mesh, ax, x.shape[0])


def transpose_sharded(mesh, a, axis=ROWS_AXIS):
    """Row-sharded A (m x n) -> row-sharded A^T by one all-to-all: rank d
    gets the d-th column strip of every rank's rows."""
    ax = mesh_axis(mesh, axis)
    blk = local_block(a, ax)
    rows, cols = blk.shape
    strips = blk.reshape(rows, ax.size, cols // ax.size).transpose(0, 1)
    swapped = collectives.all_to_all(strips, ax.group)
    # swapped[d] is rank d's rows x (cols / P) strip of our columns
    return row_dtensor(torch.cat([s.T for s in swapped], dim=1), mesh, ax,
                         a.shape[1])


def gram_sharded(mesh, a, axis=ROWS_AXIS):
    """A^T A: the local Gram, all-reduced."""
    ax = mesh_axis(mesh, axis)
    return collectives.all_reduce(gram(local_block(a, ax)), ax.group)


def matmul_reduce_scatter(mesh, a, b, axis=ROWS_AXIS):
    """C = A B with A column-sharded and B row-sharded over ``axis``: each
    rank's full-size partial product, reduce-scattered, so C comes back
    row-sharded."""
    ax = mesh_axis(mesh, axis)
    partial = matmul(local_block(a, ax, dim=1), local_block(b, ax))
    return row_dtensor(collectives.reduce_scatter(partial, ax.group),
                         mesh, ax, a.shape[0])


def ring_shift_rows(mesh, a, shift: int = 1, axis=ROWS_AXIS):
    """Move each row block ``shift`` ranks around the ring (one
    point-to-point exchange a rank, MPI's Sendrecv)."""
    ax = mesh_axis(mesh, axis)
    blk = local_block(a, ax)
    p, n = ax.index, ax.size
    out = collectives.exchange(blk, (p + shift) % n, (p - shift) % n,
                               ax.group).wait()
    return row_dtensor(out, mesh, ax, a.shape[0])


def generate_gaussian_sharded(mesh, key, shape, dtype=torch.float32,
                              axis=ROWS_AXIS):
    """Row-sharded Gaussian draw whose values equal the unsharded draw
    (``core/rng.py::gaussian`` from ``key``, a seed or a generator, on
    the mesh's device): every rank draws the whole and keeps its rows."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
        gaussian,
        key_from_seed,
    )

    ax = mesh_axis(mesh, axis)
    full = gaussian(key_from_seed(key, mesh.device_type), shape, dtype)
    return row_dtensor(local_block(full, ax), mesh, ax, shape[0])


def _ring_panels(n: int, ax) -> int:
    if n % ax.size:
        raise ValueError(f"cols={n} not divisible by {ax.size} ring ranks")
    return n // ax.size


def sketch_ring_local(a_blk, om_blk, ax):
    """This rank's rows of Y = A Omega, A's rows and Omega's rows split
    over ``ax``: Omega's row blocks travel around the ring (rank p sends
    to p - 1) while each rank multiplies the matching column panel of
    its rows; the transfer of each hop overlaps the panel's GEMM.  P - 1
    hops of n l / P elements; the last block needs no send."""
    p, size = ax.index, ax.size
    n_per = _ring_panels(a_blk.shape[1], ax)

    def col_panel(step):
        # after ``step`` hops rank p holds the block born on rank p + step
        j = (p + step) % size
        return a_blk[:, j * n_per:(j + 1) * n_per]

    y = torch.zeros((a_blk.shape[0], om_blk.shape[1]), dtype=a_blk.dtype,
                    device=a_blk.device)
    om = om_blk
    for step in range(size - 1):
        hop = collectives.exchange(om, (p - 1) % size, (p + 1) % size,
                                   ax.group)
        y = y + matmul(col_panel(step), om)
        om = hop.wait()
    return y + matmul(col_panel(size - 1), om)


def power_zt_ring_local(a_blk, q_blk, ax):
    """This rank's row panel of Z = A^T Q, A's and Q's rows split over
    ``ax``, as a ring reduce-scatter: the partial sum of Z's panel j is
    born on rank j + 1 and travels forward (p sends to p + 1), each rank
    adding its contribution A_blk[:, panel]^T Q_blk while the next hop
    is in flight; after P - 1 hops panel p lands on rank p, summed."""
    p, size = ax.index, ax.size
    n_per = _ring_panels(a_blk.shape[1], ax)

    def partial_panel(step):
        # at step s rank p contributes to panel (p - s - 1) mod P
        j = (p - step - 1) % size
        return matmul(a_blk[:, j * n_per:(j + 1) * n_per].T, q_blk)

    acc = partial_panel(0)
    for step in range(1, size):
        hop = collectives.exchange(acc, (p + 1) % size, (p - 1) % size,
                                   ax.group)
        part = partial_panel(step)
        acc = hop.wait() + part
    return acc


def sketch_ring_pipelined(mesh, a, omega, axis=ROWS_AXIS):
    """Y = A Omega with A and Omega both row-sharded, by the ring of
    :func:`sketch_ring_local` (neighbour traffic only, where the default
    would all-gather Omega).  Y comes back row-sharded like A."""
    ax = mesh_axis(mesh, axis)
    y = sketch_ring_local(local_block(a, ax), local_block(omega, ax), ax)
    return row_dtensor(y, mesh, ax, a.shape[0])


def power_zt_ring(mesh, a, q_mat, axis=ROWS_AXIS):
    """Z = A^T Q with A and Q row-sharded, by the ring reduce-scatter of
    :func:`power_zt_ring_local`.  Z (n x l) comes back row-sharded."""
    ax = mesh_axis(mesh, axis)
    z = power_zt_ring_local(local_block(a, ax), local_block(q_mat, ax), ax)
    return row_dtensor(z, mesh, ax, a.shape[1])
