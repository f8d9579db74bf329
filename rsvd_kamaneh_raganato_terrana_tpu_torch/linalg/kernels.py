"""Hand-written Hopper kernels of the rSVD path and their plain PyTorch
versions (the counterpart of the JAX package's
``linalg/pallas_kernels.py`` and of ``linalg/polar.py::polar_qr_fused``):

- K1 ``fused_cholqr1`` (``csrc/cholqr1.cu``): CholeskyQR1;
- K2 ``polar_qr_fused`` (``csrc/polar.cu``): Newton--Schulz polar
  orthonormalization, with a ``stage`` probe of its intermediates;
- K3 ``eigh_small`` (``csrc/eigh.cu``): eigendecomposition of a small
  symmetric matrix by fixed-sweep two-sided Jacobi (the rSVD tail's
  ``method='eigh_pallas'``);
- K4 ``fused_sketch_matmul`` (``csrc/sketch.cu``): the sketch Y = A Omega
  with the Gaussian Omega drawn inside the kernel (``sketch='fused'``);
- K5 ``quantize_uint8`` (``csrc/quantize.cu``): affine uint8
  quantization, deterministic (K5a) or with stochastic rounding (K5b);
- K6 ``cast_sketch`` (``csrc/cast_sketch.cu``): bf16(A) and the sketch
  Y = bf16(A) Omega in one pass over A, for the driver's first product
  over a 'default' operand (it replaces no TPU kernel).

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
import functools
import math

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


def _library(name: str, signatures: dict):
    """The kernel library of ``csrc/<name>.cu`` with its C functions
    typed: ``signatures`` maps each name to (restype, argtypes)."""
    lib = _build.library(name)
    if not getattr(lib, "typed", False):
        signatures = dict(signatures, rsvd_cuda_error_string=(
            ctypes.c_char_p, [ctypes.c_int]))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        lib.typed = True
    return lib


def _cholqr1_lib():
    return _library("cholqr1", {
        "rsvd_cholqr1_workspace_floats": (ctypes.c_size_t,
                                          [ctypes.c_int] * 2),
        "rsvd_cholqr1_f32": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p])})


def _check_launch(lib, err: int, name: str):
    if err != 0:
        msg = lib.rsvd_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def _panel_buffers(device, work_floats: int, *shapes):
    """f32 tensors of ``shapes`` followed by ``work_floats`` of workspace,
    as views of ONE device allocation, each starting 16-byte aligned: K1's
    and K2's kernels are short enough that the host's work around a
    launch shows in their call time.  The workspace is the last view."""
    sizes = [math.prod(shape) for shape in shapes]
    offsets = [0]
    for n in sizes:
        offsets.append(offsets[-1] + -(-n // 4) * 4)   # 16-byte aligned
    buf = torch.empty(offsets[-1] + work_floats, dtype=torch.float32,
                      device=device)
    views = [buf[o:o + n].view(shape)
             for o, n, shape in zip(offsets, sizes, shapes)]
    return views + [buf[offsets[-1]:]]


def _on_card(device, launch):
    """``launch(stream)`` with ``device`` current and its current stream's
    handle; the device is switched only when it is not the current one."""
    if device.index == torch.cuda.current_device():
        return launch(torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return launch(torch.cuda.current_stream().cuda_stream)


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
    if m == 0 or l == 0:
        q = torch.empty((m, l), dtype=torch.float32, device=y.device)
        r = torch.empty((l, l), dtype=torch.float32, device=y.device)
        return q.to(y.dtype), r.to(y.dtype)
    lib = _cholqr1_lib()
    # y32 may be freed when this returns, before the kernel ends: the
    # caching allocator hands its block out again only to work queued after
    # it on the same stream; the workspace shares q's and r's allocation
    q, r, work = _panel_buffers(y.device,
                                lib.rsvd_cholqr1_workspace_floats(m, l),
                                (m, l), (l, l))
    err = _on_card(y.device, lambda stream: lib.rsvd_cholqr1_f32(
        y32.data_ptr(), q.data_ptr(), r.data_ptr(), work.data_ptr(), m, l,
        stream))
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


@functools.lru_cache(maxsize=None)
def _polar_coeffs(iters: int, mu_min: float):
    """The ``ns_schedule(iters, mu_min)`` coefficients as the kernel's
    ctypes float array (3 a step)."""
    coeffs, _ = ns_schedule(iters, mu_min)
    return (ctypes.c_float * (3 * iters))(*(x for abc in coeffs
                                            for x in abc))


def _polar_lib():
    return _library("polar", {
        "rsvd_polar_workspace_floats": (ctypes.c_size_t, [ctypes.c_int] * 2),
        "rsvd_polar_f32": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p])})


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
    q_shape = (m, l) if code < 0 else (0,)
    if m == 0 or l == 0:
        q = torch.empty(q_shape, dtype=torch.float32, device=y.device)
        r = torch.empty((l, l), dtype=torch.float32, device=y.device)
        return r.to(y.dtype) if code >= 0 else (q.to(y.dtype),
                                                r.to(y.dtype))
    flat = _polar_coeffs(iters, mu_min)
    lib = _polar_lib()
    # as in fused_cholqr1: the allocator reuses y32's block only for work
    # queued after the kernel on this stream
    q, r, work = _panel_buffers(y.device,
                                lib.rsvd_polar_workspace_floats(m, l),
                                q_shape, (l, l))
    err = _on_card(y.device, lambda stream: lib.rsvd_polar_f32(
        y32.data_ptr(), q.data_ptr(), r.data_ptr(), work.data_ptr(), m, l,
        flat, iters, code, stream))
    _check_launch(lib, err, "polar_qr_fused")
    polar_qr_fused.launches += 1
    if code >= 0:
        return r.to(y.dtype)
    return q.to(y.dtype), r.to(y.dtype)


polar_qr_fused.launches = 0


_F32_EPS = float(torch.finfo(torch.float32).eps)


def eigh_small_reference(g, sweeps: int = 8):
    """Eigendecomposition of a small symmetric matrix G (n x n,
    indefinite allowed) by the arithmetic of the JAX kernel
    ``_eigh_kernel`` in plain torch ops, at f32: (eigenvalues ascending,
    V with eigenvectors in columns), like ``torch.linalg.eigh``.

    G is padded to an even n_pad with pad diagonal -(||G||_F + 1), then
    ``sweeps * (n_pad - 1)`` rounds rotate the mirror pairs
    (i, n_pad - 1 - i) -- J = I c + anti s, G <- J^T G J, V <- V J, each
    a sum of two rounded products -- and apply the circle permutation Pi.
    Where a pair's diagonal entries are equal (tau = 0), the lower index
    takes t = +1 and its mirror t = -1: the JAX kernel gives both +1 there,
    a singular J that wrecks G (a constant matrix's Gram, every diagonal
    entry equal, came back with every eigenvalue 2.8e19).
    The ascending stable sort drops the pad eigenpair.  Computed in f32,
    returned in ``g.dtype``."""
    n = g.shape[-1]
    n_pad = n + n % 2
    g32 = g.to(torch.float32)
    if n_pad != n:
        g32 = torch.nn.functional.pad(g32, (0, 1, 0, 1))
        g32[n, n] = -(torch.linalg.norm(g32) + 1.0)
    v = torch.eye(n_pad, dtype=torch.float32, device=g.device)
    # the circle permutation, Pi = eye[:, perm]: perm[0] = 0,
    # perm[1] = n_pad - 1, perm[a] = a - 1 for a >= 2
    perm = torch.arange(-1, n_pad - 1, device=g.device)
    perm[:2] = torch.tensor([0, n_pad - 1])
    idx = torch.arange(n_pad, device=g.device)
    # tau = 0 (equal diagonal entries): +1 at the lower index of the pair
    # and -1 at its mirror, so that the pair's (s, -s) stays a rotation
    tie = torch.where(idx < idx.flip(0), 1.0, -1.0).to(torch.float32)
    for _ in range(sweeps * (n_pad - 1)):
        d = torch.diagonal(g32)
        r = g32[idx, idx.flip(0)]                     # G[i, n_pad - 1 - i]
        rev_d = d.flip(0)
        do = r * r > (_F32_EPS * _F32_EPS) * torch.abs(d * rev_d)
        g_safe = torch.where(do, r, torch.ones_like(r))
        tau = (rev_d - d) / (2.0 * g_safe)
        sgn = torch.where(tau > 0, 1.0, torch.where(tau < 0, -1.0, tie))
        t = torch.where(do, sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau)),
                        torch.zeros_like(tau))
        c = torch.rsqrt(1.0 + t * t)
        s_rev = (t * c).flip(0)                       # s of each mirror
        x = g32 * c[None, :] + g32.flip(1) * s_rev[None, :]        # G J
        g32 = x * c[:, None] + x.flip(0) * s_rev[:, None]          # J^T G J
        v = v * c[None, :] + v.flip(1) * s_rev[None, :]
        g32 = g32[perm][:, perm]
        v = v[:, perm]
    lam = torch.diagonal(g32)
    order = torch.argsort(lam, stable=True)[n_pad - n:]
    return lam[order].to(g.dtype), v[:n, order].to(g.dtype)


def _eigh_lib():
    return _library("eigh", {
        "rsvd_eigh_workspace_floats": (ctypes.c_size_t, [ctypes.c_int]),
        "rsvd_eigh_plan": (None, [ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_longlong)]),
        "rsvd_eigh_set_route": (ctypes.c_int, [ctypes.c_int] * 2),
        "rsvd_eigh_small_f32": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p])})


_EIGH_ROUTES = ("one block", "cluster", "one block, workspace")


def eigh_small_plan(n: int) -> dict:
    """K3's plan at n on the current card (``rsvd_eigh_plan``): the route
    (one block of shared memory, a thread-block cluster, or one block with
    a device workspace), the blocks, threads and dynamic shared memory of
    the launch, block barriers a round and tournament pairs a block owns.
    Needs the card: the cluster size depends on what it runs."""
    out = (ctypes.c_longlong * 7)()
    _eigh_lib().rsvd_eigh_plan(n, out)
    return dict(route=_EIGH_ROUTES[out[0]], blocks=out[1], threads=out[2],
                smem_bytes=out[3], barriers_per_round=out[4],
                pairs_per_block=out[5], n_pad=out[6])


def eigh_small(g, sweeps: int = 8):
    """Eigendecomposition of a small symmetric matrix G (n x n,
    indefinite allowed): (eigenvalues ascending, V), the contract of
    ``torch.linalg.eigh``, at ~f32 eps relative to the dominant
    eigenvalue after ``sweeps`` Jacobi sweeps.  On a CUDA tensor it
    launches ``csrc/eigh.cu`` (one launch, no host sync) on
    the current stream; on a CPU tensor it runs
    :func:`eigh_small_reference`.  Computed in f32, returned in
    ``g.dtype`` (the JAX kernel returns f32).  The route follows n
    (:func:`eigh_small_plan`): one block with G and V in its shared memory
    up to n = 40, one thread-block cluster of 16 blocks (8 where the card
    runs no such cluster) with G and V spread over the blocks' shared
    memory above, and one block with a device workspace past the
    cluster's reach (n ~ 670).  Every route is bitwise the plain version
    at even n."""
    if g.ndim != 2 or g.shape[0] != g.shape[1]:
        raise ValueError(f"eigh_small takes a square matrix, got {g.shape}")
    if sweeps < 0:
        raise ValueError(f"eigh_small: sweeps={sweeps} < 0")
    n = g.shape[0]
    if n == 0:
        return g.new_zeros((0,)), g.new_zeros((0, 0))
    if g.device.type == "cpu":
        return eigh_small_reference(g, sweeps)
    if g.device.type != "cuda":
        raise ValueError(f"eigh_small has no kernel for {g.device}")
    if torch._C._are_functorch_transforms_active():
        return _EighSmallBatched.apply(g, sweeps)
    if sweeps * (n + 1) >= 2 ** 31:
        raise ValueError(f"eigh_small: {sweeps} sweeps at n = {n} exceed "
                         "the kernel's 32-bit round count")
    g32 = g.to(torch.float32).contiguous()
    lam = torch.empty((n,), dtype=torch.float32, device=g.device)
    v = torch.empty((n, n), dtype=torch.float32, device=g.device)
    lib = _eigh_lib()
    # as in fused_cholqr1: the allocator reuses g32's and work's blocks
    # only for work queued after the kernel on this stream
    work = torch.empty(lib.rsvd_eigh_workspace_floats(n),
                       dtype=torch.float32, device=g.device)
    err = _on_card(g.device, lambda stream: lib.rsvd_eigh_small_f32(
        g32.data_ptr(), lam.data_ptr(), v.data_ptr(), work.data_ptr(), n,
        sweeps, stream))
    _check_launch(lib, err, "eigh_small")
    eigh_small.launches += 1
    return lam.to(g.dtype), v.to(g.dtype)


eigh_small.launches = 0


class _EighSmallBatched(torch.autograd.Function):
    """:func:`eigh_small` under ``torch.func.vmap`` (``rsvd_batched``'s
    'vmap' mode): a kernel reads raw pointers, which a batched tensor does
    not have, so the vmap rule launches the kernel once an element of the
    batch, each launch counted.  No backward: the kernel has none."""

    @staticmethod
    def forward(g, sweeps):
        return eigh_small(g, sweeps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, g, sweeps):
        if in_dims[0] is None:
            return eigh_small(g, sweeps), (None, None)
        outs = [eigh_small(gi, sweeps) for gi in g.movedim(in_dims[0], 0)]
        return tuple(torch.stack(parts) for parts in zip(*outs)), (0, 0)


_M32 = 0xFFFFFFFF
_SKETCH_SALT = 0x68BC21EB
_TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))


def _mul32(h, c: int):
    """(h * c) mod 2^32 for 0 <= h < 2^32 held in int64 (or a Python
    int), with no product above 2^48: c is split into 16-bit halves."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix(h):
    """The murmur3 finalizer of ``pallas_kernels._mix`` on uint32 values
    held in int64 (torch has no ``>>`` for uint32 on the CPU)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _unit_floats(bits):
    """Top 24 bits -> f32 in (0, 1), floored at 1e-12
    (``pallas_kernels._bits_to_unit_floats``)."""
    return torch.clamp((bits >> 8).to(torch.float32) * (1.0 / (1 << 24)),
                       min=1e-12)


def fused_sketch_omega(n: int, l: int, seed: int = 0, device=None):
    """The n x l Gaussian Omega that ``fused_sketch_matmul`` multiplies:
    entry (row, col) hashed from (seed, row * l_pad + col) with
    l_pad = max(128, l rounded up to 128), then Box--Muller at f32
    (``pallas_kernels._gaussian_tile``).  On ``device`` (the card unless
    the caller names another)."""
    device = torch.device(device or "cuda")
    l_pad = max(128, -(-l // 128) * 128)
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(l, dtype=torch.int64, device=device)[None, :]
    h0 = _mix(((rows * l_pad + cols) & _M32) ^ _mix(seed & _M32))
    h1 = _mix(h0 ^ _SKETCH_SALT)
    u1, u2 = _unit_floats(h0), _unit_floats(h1)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI_F32 * u2)


def fused_sketch_matmul_reference(a, l: int, seed: int = 0):
    """Y = A Omega with Omega = :func:`fused_sketch_omega` (n, l, seed)
    materialized, in plain torch ops: A cast to f32, an IEEE fp32
    product, Y returned in ``a.dtype``."""
    omega = fused_sketch_omega(a.shape[1], l, seed, a.device)
    with ieee_fp32():
        y = a.to(torch.float32) @ omega
    return y.to(a.dtype)


def _sketch_lib():
    return _library("sketch", {
        "rsvd_sketch_workspace_floats": (ctypes.c_size_t,
                                         [ctypes.c_int] * 3),
        "rsvd_sketch_f32": (ctypes.c_int, [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 3 + [ctypes.c_uint32, ctypes.c_void_p])})


def fused_sketch_matmul(a, l: int, seed: int = 0, block_m: int = 512,
                        block_k: int = 512):
    """Y = A Omega (m x l) with Omega ~ N(0, 1)^(n x l) drawn from
    (seed, index) and never stored: the draw of the JAX kernel, so both
    packages sketch with the same Omega.  On a CUDA tensor it launches
    ``csrc/sketch.cu`` (plain fp32 FMA, no TF32) on the current stream;
    on a CPU tensor it runs :func:`fused_sketch_matmul_reference`.  A is
    read in f32 and Y returned in ``a.dtype``.  ``block_m`` and
    ``block_k`` keep the JAX signature; the result does not depend on
    them, and the CUDA kernel's tiling is its own (256-row tiles of Y as
    wide as l rounded up to 16, each Omega entry drawn once per cluster
    of 2 row tiles, the contraction split for occupancy)."""
    if not isinstance(a, torch.Tensor) or a.ndim != 2:
        raise TypeError("fused_sketch_matmul takes a dense 2-D tensor, got "
                        f"{type(a).__name__}")
    if l < 0:
        raise ValueError(f"fused_sketch_matmul: l={l} < 0")
    if a.device.type == "cpu":
        return fused_sketch_matmul_reference(a, l, seed)
    if a.device.type != "cuda":
        raise ValueError(f"fused_sketch_matmul has no kernel for {a.device}")
    m, n = a.shape
    if max(m, n, l) >= 2 ** 31:
        raise ValueError(f"fused_sketch_matmul: {a.shape} x {l} exceeds "
                         "the kernel's 32-bit dimensions")
    if m == 0 or n == 0 or l == 0:
        return torch.zeros((m, l), dtype=a.dtype, device=a.device)
    a32 = a.to(torch.float32).contiguous()
    y = torch.empty((m, l), dtype=torch.float32, device=a.device)
    lib = _sketch_lib()
    # as in fused_cholqr1: the allocator reuses a32's and work's blocks
    # only for work queued after the kernel on this stream
    work = torch.empty(lib.rsvd_sketch_workspace_floats(m, n, l),
                       dtype=torch.float32, device=a.device)
    err = _on_card(a.device, lambda stream: lib.rsvd_sketch_f32(
        a32.data_ptr(), y.data_ptr(), work.data_ptr(), m, n, l, seed & _M32,
        stream))
    _check_launch(lib, err, "fused_sketch_matmul")
    fused_sketch_matmul.launches += 1
    return y.to(a.dtype)


fused_sketch_matmul.launches = 0


_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _quantize_range(x32):
    """(lo, scale) of the affine uint8 grid as 0-dim f32 tensors on x's
    device, with no host sync: lo = min(x), scale = max((max(x) - lo) /
    255, f32 tiny)."""
    lo, hi = torch.aminmax(x32)
    return lo, torch.clamp((hi - lo) / 255.0, min=_F32_TINY)


def quantize_sr_uniforms(numel: int, seed: int = 0, device=None):
    """The uniforms in [0, 1) that stochastic rounding compares with the
    fractional parts: element i draws u = (h >> 8) 2^-24, h = mix((i mod
    2^32) ^ mix(seed)), the murmur3 index hash of
    ``pallas_kernels._gaussian_tile``.  f32, flat, on ``device`` (the
    card unless the caller names another)."""
    device = torch.device(device or "cuda")
    idx = torch.arange(numel, dtype=torch.int64, device=device) & _M32
    h = _mix(idx ^ _mix(seed & _M32))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def quantize_uint8_reference(x, stochastic: bool = False, seed: int = 0,
                             interpret=None):
    """Affine uint8 quantization with the arithmetic of kernel K5 in
    plain torch ops, at f32: (q, scale, lo).  x is cast to f32; lo and
    scale as :func:`_quantize_range` gives them; s = (x - lo) * (1 /
    scale), each operation rounded alone; q = clamp(round(s), 0, 255)
    (half to even), or with ``stochastic`` clamp(floor(s) + (u < s -
    floor(s)), 0, 255), u from :func:`quantize_sr_uniforms` over the
    flat index.  ``interpret`` is accepted for the JAX signature and
    ignored."""
    del interpret
    x32 = x.to(torch.float32)
    lo, scale = _quantize_range(x32)
    scaled = (x32 - lo) * torch.reciprocal(scale)
    if stochastic:
        fl = torch.floor(scaled)
        u = quantize_sr_uniforms(x32.numel(), seed, x32.device)
        q = fl + (u.reshape(x32.shape) < scaled - fl).to(torch.float32)
    else:
        q = torch.round(scaled)
    return torch.clamp(q, 0.0, 255.0).to(torch.uint8), scale, lo


def _quantize_lib():
    return _library("quantize", {
        "rsvd_quantize_u8_f32": (ctypes.c_int, [ctypes.c_void_p] * 2 + [
            ctypes.c_longlong] + [ctypes.c_void_p] * 2 + [
            ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p])})


def quantize_uint8(x, stochastic: bool = False, seed: int = 0,
                   interpret=None):
    """Affine uint8 quantization of a float tensor of any shape (the image
    codec's device-side twin): (q, scale, lo) with q uint8 of x's shape
    and scale, lo 0-dim f32 tensors on x's device; x ~ q * scale + lo.

    x is cast to f32; lo = min(x), scale = max((max(x) - lo) / 255, f32
    tiny), reduced by ``torch.aminmax`` with no host sync.  Deterministic
    rounding is half to even; ``stochastic=True`` rounds up with
    probability equal to the fractional part, from a hash of (``seed``,
    flat index), so E[q * scale + lo] = x and the bytes do not depend on
    x's shape.  Both multiply by 1 / scale, as the TPU kernel does
    (JAX's CPU branch of the stochastic path divides and draws from
    ``jax.random``; its bits cannot be matched, nor can the TPU PRNG's).
    On a CUDA tensor it launches ``csrc/quantize.cu`` (K5a, or K5b when
    stochastic) on the current stream; on a CPU tensor it runs
    :func:`quantize_uint8_reference`.  ``interpret`` is accepted for the
    JAX signature and ignored: there is no interpret mode here."""
    del interpret
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        raise TypeError("quantize_uint8 takes a float tensor, got "
                        f"{getattr(x, 'dtype', type(x).__name__)}")
    if x.numel() == 0:
        raise ValueError("quantize_uint8 of an empty tensor has no range")
    if x.device.type == "cpu":
        return quantize_uint8_reference(x, stochastic, seed)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_uint8 has no kernel for {x.device}")
    x32 = x.to(torch.float32).contiguous()
    if x32.data_ptr() % 16:
        x32 = x32.clone()               # the kernel reads float4 groups
    lo, scale = _quantize_range(x32)
    q = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    lib = _quantize_lib()
    # as in fused_cholqr1: the allocator reuses x32's block only for work
    # queued after the kernel on this stream
    err = _on_card(x.device, lambda stream: lib.rsvd_quantize_u8_f32(
        x32.data_ptr(), q.data_ptr(), x32.numel(), lo.data_ptr(),
        scale.data_ptr(), int(stochastic), seed & _M32, stream))
    _check_launch(lib, err, "quantize_uint8")
    if stochastic:
        quantize_uint8.launches_stochastic += 1
    else:
        quantize_uint8.launches += 1
    return q, scale, lo


quantize_uint8.launches = 0              # K5a
quantize_uint8.launches_stochastic = 0   # K5b


#: the widest sketch K6 takes (its one wgmma tile width)
CAST_SKETCH_MAX_WIDTH = 144


def cast_sketch_reference(a, omega):
    """(bf16(A), Y = bf16(A) @ Omega) in plain torch ops: A rounded to
    bf16 as ``a.to(torch.bfloat16)`` does, then both bf16 operands
    widened to f32 (exact) and multiplied at IEEE f32, Y returned in
    f32."""
    a16 = a.to(torch.bfloat16)
    with ieee_fp32():
        y = a16.to(torch.float32) @ omega.to(torch.float32)
    return a16, y


def _cast_sketch_lib():
    return _library("cast_sketch", {
        "rsvd_cast_sketch_bf16": (ctypes.c_int, [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p])})


def cast_sketch(a, omega):
    """(a16, Y): a16 = bf16(A), bitwise ``a.to(torch.bfloat16)``, and Y =
    a16 @ Omega accumulated and returned in f32, in one pass over A
    (K6).  A is f32, m x n, row-major and contiguous, with n % 8 == 0;
    Omega is bf16, n x l with 1 <= l <= ``CAST_SKETCH_MAX_WIDTH``, best
    held column-major (Omega^T contiguous, as the driver casts it; else
    it is copied so).  On a CUDA tensor it launches
    ``csrc/cast_sketch.cu`` on the current stream; on a CPU tensor it
    runs :func:`cast_sketch_reference`.  Y's sums run in another order
    than ``torch.mm(a16, omega, out_dtype=torch.float32)``'s."""
    if not isinstance(a, torch.Tensor) or a.ndim != 2 or omega.ndim != 2:
        raise TypeError("cast_sketch takes two 2-D tensors")
    if a.dtype != torch.float32 or omega.dtype != torch.bfloat16:
        raise TypeError("cast_sketch takes an f32 A and a bf16 Omega, got "
                        f"{a.dtype} and {omega.dtype}")
    m, n = a.shape
    l = omega.shape[1]
    if omega.shape[0] != n:
        raise ValueError(f"cast_sketch: A {tuple(a.shape)} and Omega "
                         f"{tuple(omega.shape)} do not chain")
    if a.device.type == "cpu":
        return cast_sketch_reference(a, omega)
    if a.device.type != "cuda":
        raise ValueError(f"cast_sketch has no kernel for {a.device}")
    if not 1 <= l <= CAST_SKETCH_MAX_WIDTH or n % 8 or max(m, n) >= 2 ** 31:
        raise ValueError(f"cast_sketch takes n % 8 == 0 and 1 <= l <= "
                         f"{CAST_SKETCH_MAX_WIDTH}, got {tuple(a.shape)} x "
                         f"{l}")
    if not a.is_contiguous() or a.data_ptr() % 16:
        raise ValueError("cast_sketch reads a contiguous, 16-byte aligned A")
    omega_t = omega.T.contiguous()   # no copy where Omega is column-major
    if omega_t.data_ptr() % 16:
        omega_t = omega_t.clone()
    a16 = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    y = torch.empty((m, l), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return a16, y.zero_()
    lib = _cast_sketch_lib()
    # as in fused_cholqr1: the allocator reuses omega_t's block only for
    # work queued after the kernel on this stream
    err = _on_card(a.device, lambda stream: lib.rsvd_cast_sketch_bf16(
        a.data_ptr(), a16.data_ptr(), omega_t.data_ptr(), y.data_ptr(), m, n,
        l, stream))
    _check_launch(lib, err, "cast_sketch")
    cast_sketch.launches += 1
    return a16, y


cast_sketch.launches = 0
