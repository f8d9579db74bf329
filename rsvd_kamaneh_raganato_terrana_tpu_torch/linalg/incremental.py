"""Incremental (updatable) SVD: Brand's column-append algorithm (the JAX
package's ``linalg/incremental.py``).

Given a rank-r factorization A ~= U diag(s) V^T, append new columns C and
produce the factorization of [A | C] without touching A again:
O((m + n) r^2 + m r c) work, all GEMMs plus one small SVD.  The
reference kept this as commented-out code in its POD class
(POD.cpp:464-799); here it backs the streaming POD
(``apps/pod.py::incremental_pod``).

Every product runs at full precision (``ops.primitives.DOT_PRECISION``),
every symmetric eigendecomposition through ``core/device.py::eigh``, and
the small SVD through ``linalg/svd.py::svd`` with any of its methods
('eigh_pallas' runs its eigh as kernel K3 on the card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core import device as _device
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    Sharded,
    is_dtensor,
    row_view,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import qr_reduced
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.svd import (
    SVDMethod,
    svd as small_svd,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION,
    matmul as _mm,
)


def svd_append_columns(
    u,
    s,
    v,
    c,
    rank: Optional[int] = None,
    method=SVDMethod.GramEigh,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Update U diag(s) V^T (m x n, rank r) with new columns C (m x c).

    Returns (U', s', V') of shape (m x r'), (r',), ((n + c) x r') with
    r' = ``rank`` (default r + c, i.e. exact update).

    Brand (2002): with L = U^T C, H = C - U L, (Q_h, R_h) = qr(H),
        [A | C] = [U Q_h] K [[V, 0], [0, I]]^T,
        K = [[diag(s), L], [0, R_h]]  ((r+c) x (r+c), small),
    so one small dense SVD of K rotates the bases.

    U may be a DTensor whose rows are sharded, C row-sharded alike (or
    whole: each rank keeps its rows): the products with U and C's rows
    are all-reduced, the residual's QR goes by rows (``qr_reduced`` of
    a row split), K's SVD runs replicated, and U' comes back
    row-sharded.
    """
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
        _like,
        _local,
        _t_mm_split,
    )

    def tmm(x, y):                          # X^T Y, replicated
        return _t_mm_split(x, y, DOT_PRECISION) if isinstance(x, Sharded) \
            else _mm(x.T, y)

    api = is_dtensor(u)
    u = row_view(u) if api else as_tensor(u)
    dev = _local(u).device
    s = as_tensor(s, dev)
    v = as_tensor(v, dev)
    c = row_view(c)
    if isinstance(u, Sharded) and not isinstance(c, Sharded):
        c = u.with_local(as_tensor(c, dev, u.dtype)[
            u.row_start:u.row_start + u.local.shape[0]])
    elif not isinstance(c, Sharded):
        c = as_tensor(c, dev, u.dtype)
    r = u.shape[1]
    cc = c.shape[1]

    l = tmm(u, c)                                            # r x c
    h = _like(c, _local(c) - _mm(_local(u), l))              # m x c
    q_h, r_h = qr_reduced(h, "robust")     # m x c, c x c

    k = s.new_zeros((r + cc, r + cc))
    k[:r, :r] = torch.diag(s)
    k[:r, r:] = l
    k[r:, r:] = r_h

    # Whitening correction: sigma(K) equals sigma([A|C]) only if the side
    # factors W = [U Q_h] and M = blockdiag(V, I) are orthonormal.  The
    # engines emit zero columns for null singular directions, which breaks
    # that and would inflate the spectrum; correct on the small side with
    # Gram square roots:
    #   [A|C] = (W Gw^-1/2) (Gw^1/2 K Gm^1/2) (M Gm^-1/2)^T.
    w = _like(u, torch.cat([_local(u), _local(q_h)], dim=1))  # m x (r+c)
    gw = tmm(w, w)
    gm = torch.zeros_like(k)
    gm[:r, :r] = _mm(v.T, v)
    gm[r:, r:] = torch.eye(cc, dtype=k.dtype, device=k.device)
    gw_h, gw_ih = _spd_half_pinvhalf(gw)
    gm_h, gm_ih = _spd_half_pinvhalf(gm)
    k_corr = _mm(gw_h, _mm(k, gm_h))

    uk, sk, vk = small_svd(k_corr, method)
    uk = _mm(gw_ih, uk)
    vk = _mm(gm_ih, vk)

    u_new = _mm(_local(w), uk)                               # m x (r+c)
    v_top = _mm(v, vk[:r, :])                                # n x (r+c)
    v_new = torch.cat([v_top, vk[r:, :]], dim=0)

    if rank is not None and rank < r + cc:
        u_new, sk, v_new = u_new[:, :rank], sk[:rank], v_new[:, :rank]
    u_new = _like(u, u_new)
    return (u_new.to_dtensor() if api else u_new), sk, v_new


def _spd_half_pinvhalf(g):
    """(G^1/2, G^+1/2) by eigh with the relative zero-eigenvalue cutoff
    max(lambda) eps n."""
    lam, q = _device.eigh(g)
    lam = torch.clamp(lam, min=0.0)
    cutoff = torch.max(lam) * torch.finfo(g.dtype).eps * g.shape[-1]
    root = torch.sqrt(lam)
    inv_root = torch.where(lam > cutoff, 1.0 / torch.clamp(root, min=1e-300),
                           torch.zeros_like(root))
    return (_mm(q * root[None, :], q.T), _mm(q * inv_root[None, :], q.T))


class IncrementalSVD:
    """Stateful wrapper: feed column batches, keep a rank-capped
    factorization (the streaming-POD use).  The first batch fixes the
    device and dtype: a tensor keeps its own, any other array goes to
    the card.  Batches may be DTensors whose rows are sharded, all alike:
    U is then kept row-sharded (:func:`svd_append_columns`)."""

    def __init__(self, rank: int, method=SVDMethod.GramEigh):
        self.rank = int(rank)
        self.method = method
        self.u = self.s = self.v = None

    def update(self, c) -> "IncrementalSVD":
        if self.u is None:
            c = row_view(c)
            u, s, v = small_svd(c if isinstance(c, Sharded)
                                else as_tensor(c), self.method)
            keep = min(self.rank, s.shape[0])
            if isinstance(u, Sharded):
                u = u.with_local(u.local[:, :keep]).to_dtensor()
            else:
                u = u[:, :keep]
            self.u, self.s, self.v = u, s[:keep], v[:, :keep]
            return self
        self.u, self.s, self.v = svd_append_columns(
            self.u, self.s, self.v, c, rank=self.rank, method=self.method
        )
        return self

    @property
    def n_seen(self) -> int:
        return 0 if self.v is None else self.v.shape[0]

    def factors(self):
        return self.u, self.s, self.v
