"""Hand-written Hopper kernels of the rSVD path and their plain PyTorch
versions (the counterpart of the JAX package's
``linalg/pallas_kernels.py``).

Each kernel has:

- a wrapper that launches it on a CUDA tensor (or raises) and counts its
  launches in a plain integer attribute; on a CPU tensor it calls the
  plain version, and counts nothing;
- a plain PyTorch version of the same arithmetic (``*_reference``),
  which the CPU tests hold against the JAX kernel and ``chip_smoke.py``
  holds the CUDA kernel against on the card.

Sources live in ``csrc/`` and build with ``nvcc`` at first use
(``linalg/_build.py``).
"""

from __future__ import annotations

import ctypes

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import ieee_fp32
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import _build


def fused_cholqr1_reference(y):
    """CholeskyQR1 of Y (m x l) by the augmented elimination of the JAX
    kernel ``_cholqr_kernel``, in plain torch ops: G = Y^T Y, then l
    steps on M = [G | I] (pivot rsqrt, normalized pivot row, rank-1
    update of the rows below) leave R = L^T on the left and L^{-1} on the
    right; Q = Y (L^{-1})^T.  Computed in f32, returned in ``y.dtype``.
    Rank-deficient Y gives non-finite output (no clamp)."""
    y32 = y.to(torch.float32)
    l = y32.shape[1]
    with ieee_fp32():
        g = y32.T @ y32
    mw = torch.cat([g, torch.eye(l, dtype=torch.float32, device=y.device)],
                   dim=1)
    for j in range(l):
        d = torch.rsqrt(mw[j, j])
        row_n = mw[j] * d
        mult = mw[j + 1:, j] * d
        mw[j + 1:] -= mult[:, None] * row_n[None, :]
        mw[j] = row_n
    r = torch.triu(mw[:, :l])
    l_inv = torch.tril(mw[:, l:])
    with ieee_fp32():
        q = y32 @ l_inv.T
    return q.to(y.dtype), r.to(y.dtype)


def _cholqr1_lib():
    lib = _build.library("cholqr1")
    if not getattr(lib, "typed", False):
        lib.rsvd_cholqr1_workspace_floats.restype = ctypes.c_size_t
        lib.rsvd_cholqr1_workspace_floats.argtypes = [ctypes.c_int] * 2
        lib.rsvd_cholqr1_f32.restype = ctypes.c_int
        lib.rsvd_cholqr1_f32.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.rsvd_cuda_error_string.restype = ctypes.c_char_p
        lib.rsvd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.typed = True
    return lib


def _check_launch(lib, err: int, name: str):
    if err != 0:
        msg = lib.rsvd_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def fused_cholqr1(y):
    """CholeskyQR1 of Y (m x l): (Q, R) with R upper-triangular, the
    contract of ``linalg.qr.cholesky_qr1`` (NaNs on rank-deficient input,
    no fallback).  On a CUDA tensor it launches ``csrc/cholqr1.cu``
    (plain fp32 FMA, no TF32) on the current stream; on a CPU tensor it
    runs :func:`fused_cholqr1_reference`.  Computed in f32, returned in
    ``y.dtype``.  Any m and l are accepted: Y is streamed from device
    memory, so there is no size guard."""
    if y.ndim != 2:
        raise ValueError(f"fused_cholqr1 takes a 2-D panel, got {y.shape}")
    if y.device.type == "cpu":
        return fused_cholqr1_reference(y)
    if y.device.type != "cuda":
        raise ValueError(f"fused_cholqr1 has no kernel for {y.device}")
    m, l = y.shape
    if max(m, l) >= 2 ** 31:
        raise ValueError(f"fused_cholqr1: {y.shape} exceeds the kernel's "
                         "32-bit dimensions")
    y32 = y.to(torch.float32).contiguous()
    q = torch.empty((m, l), dtype=torch.float32, device=y.device)
    r = torch.empty((l, l), dtype=torch.float32, device=y.device)
    if m == 0 or l == 0:
        return q.to(y.dtype), r.to(y.dtype)
    lib = _cholqr1_lib()
    # y32 and work may be freed when this returns, before the kernel ends:
    # the caching allocator hands their blocks out again only to work
    # queued after it on the same stream
    work = torch.empty(lib.rsvd_cholqr1_workspace_floats(m, l),
                       dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rsvd_cholqr1_f32(y32.data_ptr(), q.data_ptr(),
                                   r.data_ptr(), work.data_ptr(), m, l,
                                   stream)
    _check_launch(lib, err, "fused_cholqr1")
    fused_cholqr1.launches += 1
    return q.to(y.dtype), r.to(y.dtype)


fused_cholqr1.launches = 0
