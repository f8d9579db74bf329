"""Ring-pipelined rSVD for bandwidth-limited meshes (the JAX package's
``rsvd/ring.py``).

The sharded driver (``rsvd`` on a row-sharded A) all-reduces an n x l
partial sum for every Z = A^T Q: fine inside a host, expensive where the
mesh axis crosses hosts.  This driver keeps every large transfer
neighbour-only:

  sketch   Y = A Omega       Omega's row blocks travel the ring
  Z pass   Z = A^T Q         ring reduce-scatter of Z's row panels
  QR       Gram + Cholesky   l x l all-reduce only
  tail     B = Q^T A         kept as Z's row split; its Gram all-reduced

Per power round each rank exchanges 2 n l / P elements with its ring
neighbours instead of joining an n l all-reduce: the reference's
Gatherv-to-root + Bcast (src/PM.cpp:60-68) done as neighbour traffic.
The point-to-point exchanges and all-reduces go through
``core/collectives.py``, which counts them.
"""

from __future__ import annotations

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    Sharded,
    mesh_axis,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.mesh import ROWS_AXIS
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import (
    orthonormal_basis,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.svd import (
    SVDMethod,
    svd as small_svd,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    local_block,
    matmul,
    power_zt_ring_local,
    sketch_ring_local,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver


def rsvd_ring(mesh, a, k: int = 0, p: int = 10, q: int = 2,
              method="eigh", qr_method: str = "robust", seed: int = 0,
              axis=ROWS_AXIS):
    """Rank-k rSVD of a row-sharded A (a DTensor, or the full tensor on
    every rank) with neighbour-only large transfers.

    Both the m-sized and the n-sized intermediates stay row-sharded over
    ``axis``; m and n must divide its ranks.  Omega is
    ``driver.generate_omega(seed)`` on A's device, each rank keeping its
    rows, so the sketch equals the single-card one.  Returns (U, s, V):
    U (m x k) and V (n x k) row-sharded DTensors, s replicated.  With a
    Gram engine ('eigh', 'eigh_pallas') the tail's only collective is
    the l x l Gram all-reduce; other engines gather B."""
    method = SVDMethod.parse(method)
    ax = mesh_axis(mesh, axis)
    m, n = a.shape
    l = min(k + p if k > 0 else p, min(m, n))
    a_blk = local_block(a, ax)
    omega = driver.generate_omega(seed, n, l, a_blk.dtype,
                                  device=a_blk.device)

    def basis(panel, rows):
        """Orthonormal basis of a row-split panel, still row-split."""
        return orthonormal_basis(Sharded(panel, (rows, l), mesh, ax),
                                 qr_method).local

    q_blk = basis(sketch_ring_local(a_blk, local_block(omega, ax), ax), m)
    for _ in range(q):
        z_q = basis(power_zt_ring_local(a_blk, q_blk, ax), n)
        q_blk = basis(sketch_ring_local(a_blk, z_q, ax), m)
    b_t = Sharded(power_zt_ring_local(a_blk, q_blk, ax), (n, l), mesh, ax)
    u_t, s, v = small_svd(b_t.T, method)                # V row-split
    u = Sharded(matmul(q_blk, u_t), (m, l), mesh, ax)
    if k > 0:
        u, s = u.with_local(u.local[:, :k]), s[:k]
        v = v.with_local(v.local[:, :k])
    return u.to_dtensor(), s, v.to_dtensor()
