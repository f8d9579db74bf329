"""Multi-host streaming rSVD: each process streams its own row shard
(the JAX package's ``rsvd/multihost.py``).

Each process (one a card) owns a contiguous ROW SHARD of A as a host
array (ndarray, ``np.memmap``, CPU tensor or :class:`SynthesizedMatrix`)
and streams it through its card with ``rsvd/streaming.py``'s panel
passes; nothing the size of A crosses between processes.  The only
collectives are what the algorithm needs, each one all-reduce over the
process group (``core/collectives.py``):

- the l x l Grams of the distributed CholeskyQR of the row-split basis
  (the reference's Gatherv -> root -> Bcast of QR state,
  image_compression/src/QR.cpp:138-149),
- the n x l co-range blocks Z = A^T Q of each power round,
- the n x l projection Z_b = A^T Q (= B^T).

The panel GEMMs are local, so processes with different shard sizes or
panel counts meet only at the collectives; every process issues the
same collectives in the same order.  The replicated n x l and l x l
work runs on every process: with ``qr_method='cholqr1_fused'`` each one
runs kernel K1 on the replicated Z, and with ``method='eigh_pallas'``
kernel K3 on the tail, as single-card streaming does.

The reference's row-partitioned MPI pipeline (src/PM.cpp:31-68) at
out-of-core scale: MPI rank -> process, the rank's row block -> the
process's host shard, Gatherv + Bcast -> all-reduce.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    eigh,
    eigh_nan,
    matmul_at,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import (
    _chol_maybe_shifted,
    _gram,
    _solve_right_upper,
    qr_reduced,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.svd import SVDMethod
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import _fold_weights
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.streaming import (
    _data_fingerprint,
    _default_panel_rows,
    _dtype_name,
    _stream_left_t_multiply,
    _stream_right_multiply,
    _StreamCheckpoint,
    _tail_svd,
)


def _procs() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every process (a collective: every process calls
    it the same number of times, in the same order); ``x`` itself on one
    process."""
    if _procs() == 1:
        return x
    return collectives.all_reduce(x.clone(), None)


def _global_min_scalar(x: int, device) -> int:
    """The least of every process's integer ``x`` (a collective)."""
    if _procs() == 1:
        return int(x)
    t = torch.tensor([float(x)], dtype=torch.float64, device=device)
    return int(collectives.all_reduce(t, None, "min")[0])


def _finish_chol_qr(y_local, g_global, m_global: int):
    """The local half of one distributed CholeskyQR pass: factor the
    summed Gram (shifted retry, ``linalg/qr.py``) and apply R^{-1} to the
    local rows.  Returns (Q_local, R), R replicated."""
    c, _ = _chol_maybe_shifted(g_global, m_global)
    return _solve_right_upper(y_local, c.T), c.T


def _cholqr_distributed_r(y_local, m_global: int, passes: int = 2):
    """Distributed CholeskyQR of a row-split tall matrix: ``passes``
    rounds of local Gram -> all-reduce -> replicated Cholesky -> local
    triangular apply.  Returns (Q_local, R) with R = R_2 R_1 replicated;
    ``passes=1`` is cholqr1's depth (one collective)."""
    q_local, r = _finish_chol_qr(y_local, _global_sum(_gram(y_local)),
                                 m_global)
    for _ in range(passes - 1):
        q_local, r2 = _finish_chol_qr(q_local, _global_sum(_gram(q_local)),
                                      m_global)
        r = matmul_at(r2, r, DOT_PRECISION)
    return q_local, r


def _utv_fold_local(factor_local, tri):
    """The local half of a UTV serving tail: fold the replicated middle
    factor into weights and this process's rows of U (s are
    decomposition weights, U unit-column once assembled over the
    processes).  Returns (U_local, s, order)."""
    s, safe = _fold_weights(tri)
    u_local = matmul_at(factor_local, tri / safe[None, :], DOT_PRECISION)
    order = torch.argsort(-s, stable=True)
    return u_local[:, order], s[order], order


def _rowspace_tail(c_local, g, z_q):
    """The rowspace end-game: C = U diag(s) W^T with G = C^T C =
    W diag(s^2) W^T, so U = C W / s and V = Z_q W.  Columns whose Gram
    eigenvalue sits at or below eps lambda_max are zeroed rather than
    normalized noise (scale-free: relative to lambda_max, with only a
    finfo.tiny guard for the all-zero matrix).  The eigh is
    ``core/device.py``'s ``eigh`` for f32 (one Newton--Schulz step) and
    torch's for wider dtypes, as in ``linalg/svd.py``."""
    dtype = c_local.dtype
    lam, w = (eigh if dtype == torch.float32 else eigh_nan)(g)  # ascending
    lam = torch.clamp(lam.flip(0), min=0.0)
    w = w.flip(1)
    s = torch.sqrt(lam)
    safe = torch.clamp(s, min=torch.finfo(dtype).tiny)
    u_local = matmul_at(c_local, w / safe[None, :], DOT_PRECISION)
    floor = max(torch.finfo(dtype).eps * float(lam[0]),
                torch.finfo(dtype).tiny)
    u_local = torch.where((lam > floor)[None, :], u_local,
                          torch.zeros_like(u_local))
    return u_local, s, matmul_at(z_q, w, DOT_PRECISION)


def _checkpoint(checkpoint_dir, meta, device):
    """This process's checkpoint store under ``host<rank>``, or None
    where the directory cannot be written (the run then starts from the
    top and reports stage 0, so the processes' collectives stay in
    step)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        return _StreamCheckpoint(os.path.join(checkpoint_dir, f"host{rank}"),
                                 meta, device)
    except OSError:
        return None


def rsvd_streaming_multihost(
    a_local,
    k: int,
    p: int = 16,
    q: int = 2,
    method="eigh",
    panel_rows: Optional[int] = None,
    seed: int = 0,
    dtype=torch.float32,
    precision: str = "highest",
    panel_dtype: Optional[str] = None,
    finish: str = "project",
    checkpoint_dir: Optional[str] = None,
    qr_method: str = "robust",
    device=None,
):
    """Rank-k rSVD of a matrix whose row shards live one a process.

    ``a_local``: THIS process's contiguous row block (m_local x n) as a
    host array; processes may hold different row counts.  Returns
    (U_local, s, V) on ``device`` (the card unless named): U_local is
    this process's rows of U (m_local x k); s and V are the same on every
    process.  ``panel_dtype`` ('bfloat16' | 'int8') compresses this
    process's host-to-card panels (local: processes may disagree on it).
    ``finish='rowspace'`` (q >= 1) ends at the last co-range block and
    factors C = A Z_q: one fewer streamed pass and one fewer n x l
    all-reduce.  ``finish='utv'`` / ``'rowspace_utv'`` are the serving
    tails (a thin-QR fold instead of the eigh/SVD tail; s are weights, U
    unit-column), with 'project''s / 'rowspace''s passes and
    collectives.  ``qr_method`` is every QR's variant; the distributed
    basis QRs run CholeskyQR2, or ONE pass for the 'cholqr1' family
    ('cholqr1', 'cholqr1_fused', 'robust1').  ``finish`` and
    ``qr_method`` change the collectives, so every process passes the
    same values.  ``checkpoint_dir`` enables pass-level resume: each
    process stores its stages under ``host<rank>`` (a shared file system
    is fine), and on restart the processes agree on the LEAST completed
    stage by one all-reduce, which runs on every multi-process run
    whatever ``checkpoint_dir`` says, so processes that disagree on it
    (some None, some unwritable) still issue the same collectives.

    Omega is ``driver.generate_omega(seed)`` on ``device``: the same on
    every process.  One process: :func:`rsvd.streaming.rsvd_streaming`'s
    passes, with the CholeskyQR2 basis."""
    method = SVDMethod.parse(method)
    device = torch.device(device or "cuda")
    m_local, n = a_local.shape
    m_global = int(_global_sum(torch.tensor(
        [float(m_local)], dtype=torch.float64, device=device))[0])
    l = min(k + p, min(m_global, n))
    if panel_rows is None:
        panel_rows = _default_panel_rows(m_local, n, dtype)
    if finish not in ("project", "rowspace", "utv", "rowspace_utv"):
        raise ValueError(f"unknown finish {finish!r}")
    rowspace_like = finish in ("rowspace", "rowspace_utv")
    if rowspace_like and q < 1:
        raise ValueError(f"finish={finish!r} needs q >= 1")
    qr_passes = 1 if qr_method in ("cholqr1", "cholqr1_fused",
                                   "robust1") else 2
    omega = driver.generate_omega(seed, n, l, dtype, device=device)

    rounds = q - 1 if rowspace_like else q
    stages = (["q0"] + [f"round{i}" for i in range(rounds)]
              + (["zq_final", "c_final"] if rowspace_like
                 else ["b_final"]))
    ckpt = None
    local_done = 0
    if checkpoint_dir is not None:
        ckpt = _checkpoint(checkpoint_dir, {
            "m_global": m_global, "m_local": m_local, "n": n, "k": k,
            "p": p, "q": q, "seed": seed, "dtype": _dtype_name(dtype),
            "precision": precision, "panel_dtype": panel_dtype,
            "finish": finish, "method": method.value,
            "qr_method": qr_method, "data": _data_fingerprint(a_local),
            "procs": _procs()}, device)
        if ckpt is not None:
            for st in stages:
                if not ckpt.has(st):
                    break
                local_done += 1
    done = _global_min_scalar(local_done, device)
    if ckpt is None:
        done = 0

    def right(b):
        return _stream_right_multiply(a_local, b, panel_rows, dtype,
                                      precision, panel_dtype)

    def left_t(q_loc):
        return _global_sum(_stream_left_t_multiply(
            a_local, q_loc, panel_rows, dtype, precision, panel_dtype))

    if done > 0:
        q_local = ckpt.load("q0")
    else:
        q_local = _cholqr_distributed_r(right(omega), m_global,
                                        qr_passes)[0]
        if ckpt:
            ckpt.save("q0", q_local)
    for i in range(rounds):
        if 1 + i < done:
            q_local = ckpt.load(f"round{i}")
            continue
        z_q, _ = qr_reduced(left_t(q_local), qr_method)     # replicated
        q_local = _cholqr_distributed_r(right(z_q), m_global, qr_passes)[0]
        if ckpt:
            ckpt.save(f"round{i}", q_local)

    if rowspace_like:
        # the final half-round: one all-reduced co-range block, its QR
        # replicated, the LAST streamed pass C = A Z_q; then only l x l
        # Gram all-reduces
        if 1 + rounds < done:
            z_q = ckpt.load("zq_final")
        else:
            z_q, _ = qr_reduced(left_t(q_local), qr_method)
            if ckpt:
                ckpt.save("zq_final", z_q)
        if 2 + rounds < done:
            c_local = ckpt.load("c_final")
        else:
            c_local = right(z_q)
            if ckpt:
                ckpt.save("c_final", c_local)
        if finish == "rowspace_utv":
            q_c_local, t = _cholqr_distributed_r(c_local, m_global,
                                                 qr_passes)
            u_local, s, order = _utv_fold_local(q_c_local, t)
            return u_local[:, :k], s[:k], z_q[:, order][:, :k]
        u_local, s, v = _rowspace_tail(c_local,
                                       _global_sum(_gram(c_local)), z_q)
        return u_local[:, :k], s[:k], v[:, :k]

    if 1 + rounds < done:
        zb = ckpt.load("b_final")
    else:
        zb = left_t(q_local)
        if ckpt:
            ckpt.save("b_final", zb)
    if finish == "utv":
        # B = Q^T A = L V^T by a thin QR of the replicated Z_b = B^T; the
        # fold against the row-split Q is local
        v, r = qr_reduced(zb, qr_method)
        u_local, s, order = _utv_fold_local(q_local, r.T)
        return u_local[:, :k], s[:k], v[:, order][:, :k]
    u_local, s, v = _tail_svd(zb.T, q_local, method.value)
    return u_local[:, :k], s[:k], v[:, :k]
