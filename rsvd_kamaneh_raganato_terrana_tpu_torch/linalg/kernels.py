"""Hand-written Hopper kernels of the rSVD path and their plain PyTorch
versions (the counterpart of the JAX package's
``linalg/pallas_kernels.py`` and of ``linalg/polar.py::polar_qr_fused``):

- K1 ``fused_cholqr1`` (``csrc/cholqr1.cu``): CholeskyQR1;
- K2 ``polar_qr_fused`` (``csrc/polar.cu``): Newton--Schulz polar
  orthonormalization, with a ``stage`` probe of its intermediates.

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
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.polar import ns_schedule


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


_POLAR_MAX_ITERS = 16     # kMaxIters in csrc/polar.cu


def _polar_stage_code(stage, iters: int) -> int:
    """The kernel's ``stage`` argument: -1 for the full factorization, or
    the intermediate to stop at -- 'gram' (G), 'gt' (G~ = G / alpha),
    'w1' (W_1) or 'h<k>' (H after step k, 1 <= k <= iters)."""
    if stage is None:
        return -1
    names = ["gram", "gt", "w1"] + [f"h{k}" for k in range(1, iters + 1)]
    if stage not in names:
        raise ValueError(f"unknown polar stage {stage!r} (use one of "
                         f"{names})")
    return names.index(stage)


def polar_qr_fused_reference(y, iters: int = 8, mu_min: float = 1e-6,
                             stage=None):
    """Newton--Schulz polar factorization of Y (m x l) with the arithmetic
    of the JAX kernel ``_polar_kernel``, in plain torch ops at full fp32:
    G = Y^T Y, alpha = max row sum of |G| + 1e-30, G~ = G (1/alpha), the
    ``ns_schedule(iters, mu_min)`` steps W <- W (a I + b H + c H^2) with
    H = sym(W^T G~ W), W_s = W rsqrt(alpha); returns Q = Y W_s and
    R = W_s G (symmetric, not triangular).  With ``stage`` set it returns
    only that l x l intermediate (see :func:`_polar_stage_code`).
    Computed in f32, returned in ``y.dtype``.  Rank-deficient Y is out
    of domain (NaN or garbage, no clamp and no shift)."""
    code = _polar_stage_code(stage, iters)
    coeffs, _ = ns_schedule(iters, mu_min)
    y32 = y.to(torch.float32)
    l = y32.shape[1]
    eye = torch.eye(l, dtype=torch.float32, device=y.device)
    with ieee_fp32():
        g = y32.T @ y32
        alpha = torch.max(torch.sum(torch.abs(g), dim=1)) + 1e-30
        gt = g * (1.0 / alpha)

        def actual_h(w):
            h = w.T @ (gt @ w)
            return 0.5 * (h + h.T)

        a0, b0, c0 = coeffs[0]
        w = a0 * eye + b0 * gt + c0 * (gt @ gt)
        h = actual_h(w)
        stages = [g, gt, w, h]
        for a, b, c in coeffs[1:]:
            if code >= 0 and code < len(stages):
                break
            p = a * eye + b * h + c * (h @ h)
            w = w @ p
            h = actual_h(w)
            stages.append(h)
        if code >= 0:
            return stages[code].to(y.dtype)
        w_s = w * torch.rsqrt(alpha)
        q = y32 @ w_s
        r = w_s @ g
    return q.to(y.dtype), r.to(y.dtype)


def _polar_lib():
    lib = _build.library("polar")
    if not getattr(lib, "typed", False):
        lib.rsvd_polar_workspace_floats.restype = ctypes.c_size_t
        lib.rsvd_polar_workspace_floats.argtypes = [ctypes.c_int] * 2
        lib.rsvd_polar_f32.restype = ctypes.c_int
        lib.rsvd_polar_f32.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.rsvd_cuda_error_string.restype = ctypes.c_char_p
        lib.rsvd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.typed = True
    return lib


def polar_qr_fused(y, iters: int = 8, mu_min: float = 1e-6, stage=None):
    """Newton--Schulz polar factorization of Y (m x l): (Q, R) with Q
    orthonormal and R = Q^T Y symmetric, the contract of
    ``linalg.polar.polar_qr``.  On a CUDA tensor it launches
    ``csrc/polar.cu`` (plain fp32 FMA, no TF32) on the current stream; on
    a CPU tensor it runs :func:`polar_qr_fused_reference`.  With
    ``stage`` set it returns only that l x l intermediate.  Computed in
    f32, returned in ``y.dtype``; Y is streamed from device memory, so
    there is no size guard."""
    if y.ndim != 2:
        raise ValueError(f"polar_qr_fused takes a 2-D panel, got {y.shape}")
    code = _polar_stage_code(stage, iters)
    if y.device.type == "cpu":
        return polar_qr_fused_reference(y, iters, mu_min, stage)
    if y.device.type != "cuda":
        raise ValueError(f"polar_qr_fused has no kernel for {y.device}")
    if not 1 <= iters <= _POLAR_MAX_ITERS:
        raise ValueError(f"polar_qr_fused: iters={iters} outside the "
                         f"kernel's 1..{_POLAR_MAX_ITERS}")
    m, l = y.shape
    if max(m, l) >= 2 ** 31:
        raise ValueError(f"polar_qr_fused: {y.shape} exceeds the kernel's "
                         "32-bit dimensions")
    y32 = y.to(torch.float32).contiguous()
    q = torch.empty((m, l) if code < 0 else (0,), dtype=torch.float32,
                    device=y.device)
    r = torch.empty((l, l), dtype=torch.float32, device=y.device)
    if m == 0 or l == 0:
        return r.to(y.dtype) if code >= 0 else (q.to(y.dtype),
                                                r.to(y.dtype))
    coeffs, _ = ns_schedule(iters, mu_min)
    flat = (ctypes.c_float * (3 * iters))(*(x for abc in coeffs
                                             for x in abc))
    lib = _polar_lib()
    # as in fused_cholqr1: the allocator reuses y32's and work's blocks
    # only for work queued after the kernel on this stream
    work = torch.empty(lib.rsvd_polar_workspace_floats(m, l),
                       dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rsvd_polar_f32(y32.data_ptr(), q.data_ptr(), r.data_ptr(),
                                 work.data_ptr(), m, l, flat, iters, code,
                                 stream)
    _check_launch(lib, err, "polar_qr_fused")
    polar_qr_fused.launches += 1
    if code >= 0:
        return r.to(y.dtype)
    return q.to(y.dtype), r.to(y.dtype)


polar_qr_fused.launches = 0
