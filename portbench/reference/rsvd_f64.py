"""The plain rSVD in f64, given the sketch Omega: the semantics of the
port's ``rsvd`` for the finishes the cells run.

- ``project`` (2q + 2 passes): Y = A Omega, q power rounds, B = Q^T A,
  B = U_t S V^T, U = Q U_t.  It depends on range(Q) alone, so any
  orthonormal basis serves: Householder QR here.
- ``rowspace_utv`` (2q + 1 passes, the serving finish): the basis of
  every step is the thin QR with a positive diagonal of R (the unique
  one, which CholeskyQR computes), since each later step reads the basis
  itself and not only its range.  Z = A^T Q, Z_q = qr(Z), C = A Z_q,
  s = column norms of C (C = Q_c T), U = C diag(1/s), V = Z_q, sorted by
  s descending.

With ``comm`` joining ranks, every tall panel is whole on every rank and
each QR and small SVD runs on rank 0 and is broadcast.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def draw_omega(sketch_seed: int, n: int, l: int, device) -> torch.Tensor:
    """The port's documented Gaussian draw (``generate_omega``): an
    n x l f32 ``torch.randn`` from a generator on ``device`` seeded with
    the sketch seed."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(sketch_seed))
    return torch.randn((n, l), generator=gen, device=device,
                       dtype=torch.float32)


def qr_pos(x: torch.Tensor):
    """Thin QR with R's diagonal made non-negative."""
    q, r = torch.linalg.qr(x, mode="reduced")
    d = torch.sign(torch.diagonal(r))
    d = torch.where(d == 0, torch.ones_like(d), d)
    return q * d[None, :], r * d[:, None]


def _on_root(comm, fn, *xs):
    """fn(*xs) on rank 0, its tensors broadcast to every rank."""
    outs = fn(*xs)
    return tuple(comm.bcast(o) for o in outs)


def rsvd(op, omega: torch.Tensor, q: int, finish: str):
    """(U m x l, s l, V n x l) in f64 of the operand view ``op``
    (``operand.DenseRef`` / ``SparseRef``) for the f32 sketch ``omega``:
    all l components, sorted; the caller keeps the first k."""
    comm = op.comm
    basis = lambda y: _on_root(comm, qr_pos, y)[0]      # noqa: E731
    y = op.mm(omega.to(F64))
    q_mat = basis(y)
    rounds = q if finish == "project" else q - 1
    for _ in range(rounds):
        q_mat = basis(op.mm(op.tmm(q_mat)))
    if finish == "project":
        bt = op.tmm(q_mat)                             # B^T, n x l

        def small(bt):
            qb, rb = torch.linalg.qr(bt, mode="reduced")
            us, s, wh = torch.linalg.svd(rb.T)
            return us, s, qb @ wh.T
        us, s, v = _on_root(comm, small, bt)
        u = q_mat @ us
    elif finish == "rowspace_utv":
        z_q = basis(op.tmm(q_mat))
        c = op.mm(z_q)
        s = torch.linalg.norm(c, dim=0)
        order = torch.argsort(-s, stable=True)
        u = (c / torch.clamp(s, min=torch.finfo(F64).tiny)[None, :])[:, order]
        s, v = s[order], z_q[:, order]
    else:
        raise ValueError(f"unknown finish {finish!r}")
    return u, s, v
