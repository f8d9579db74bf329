"""Matmul precision policy: the counterpart of the JAX driver's
``_PRECISIONS`` map (rsvd/driver.py:65-74).

- ``'highest'``: IEEE fp32 products.  TF32 is switched off for the
  duration of each product and the previous setting restored after it,
  so no global flag is left changed.
- ``'default'``: on CUDA, f32 operands are rounded to bf16 and the
  product accumulates and returns in f32 (``torch.mm(...,
  out_dtype=torch.float32)``) -- the numerics of one bf16 MXU pass on
  the TPU.  On the CPU it runs in f32, which is what JAX's DEFAULT
  precision gives on the CPU.  A product is never returned rounded to
  bf16.  The driver's stage-A operand is rounded once a call instead of
  once a product (``rsvd/driver.py::Bf16OnFirstUse``), to the same bits.
- ``'bf16'``/``'bfloat16'`` and ``'int8'`` are storage modes of the
  driver (A cast once to bf16, or quantized to row-scaled int8); their
  dense products get the numerics of ``'default'``, as the JAX
  ``_PRECISIONS`` map gives them (rsvd/driver.py:65-74).
- ``'high'``: on CUDA, one TF32 tensor-core product (10 mantissa bits
  an operand, f32 accumulation; :func:`tf32_product`).  JAX's
  ``Precision.HIGH`` is bf16_3x on the TPU (three bf16 passes, about 16
  bits); on an H100 that took 2.7 times the time of 'highest' for the
  main path's 4096 x 4096 x 80 product (the operand splits cost more
  passes over A than the three bf16 GEMMs), so a precision meant to be
  cheaper than 'highest' would cost more.  TF32 takes under half of it
  (PERF.md).  On the CPU 'high' runs in full precision, which is what
  JAX's HIGH gives on the CPU.
"""

from __future__ import annotations

import contextlib

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.profiling import span

#: the storage modes, read by the driver; their dense products run at
#: 'default'
STORAGE_BF16 = ("bf16", "bfloat16")
STORAGE_INT8 = ("int8",)
PRECISIONS = ("highest", "high", "default") + STORAGE_BF16 + STORAGE_INT8


def resolve_precision(precision) -> str:
    """The numerics of ``precision``: 'highest', 'high' or 'default' (the
    storage modes map to 'default')."""
    name = str(precision).lower()
    if name in STORAGE_BF16 + STORAGE_INT8:
        return "default"
    if name in PRECISIONS:
        return name
    raise ValueError(f"unknown precision {precision!r}")


@contextlib.contextmanager
def _allow_tf32(allow: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def ieee_fp32():
    """Full fp32 matmuls (TF32 off) inside the block; the caller's
    setting is restored on exit."""
    return _allow_tf32(False)


def tf32_product(a, b):
    """``a @ b`` of two f32 CUDA matrices as one TF32 tensor-core product
    (the 'high' precision); the caller's TF32 setting is restored."""
    with _allow_tf32(True):
        return torch.matmul(a, b)


def _bf16_product(a, b, out_dtype):
    """Product of two bf16 matrices accumulated and returned in
    ``out_dtype``.  On the CPU the operands are widened first, which is
    exact: a product of two bf16 values fits an f32 mantissa."""
    if a.is_cuda and out_dtype == torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.to(out_dtype), b.to(out_dtype))


def matmul_at(a, b, precision="highest", out_dtype=None):
    """``a @ b`` for 2-D tensors at ``precision``, returned in
    ``out_dtype`` (default: ``a.dtype``).  Operands must share a dtype;
    the driver's ``_mm`` applies the mixed-dtype rules first."""
    prec = resolve_precision(precision)
    out_dtype = a.dtype if out_dtype is None else out_dtype
    if a.dtype == torch.bfloat16:
        return _bf16_product(a, b, out_dtype)
    if prec == "default" and a.is_cuda and a.dtype == torch.float32:
        with span("cast"):
            a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
        return _bf16_product(a, b, out_dtype)
    if prec == "high" and a.is_cuda and a.dtype == torch.float32:
        return tf32_product(a, b).to(out_dtype)
    with ieee_fp32():
        return torch.matmul(a, b).to(out_dtype)


def eigh_nan(g):
    """``torch.linalg.eigh`` (ascending eigenvalues, eigenvectors in
    columns, batched over leading axes) with XLA's contract on a matrix
    that holds a non-finite entry: NaN eigenvalues and vectors, where
    torch's raises (or not, as LAPACK and cuSOLVER happen to report).
    Such a matrix is factored as the identity and its results
    overwritten, with no host sync, so that a failed Cholesky or QR
    upstream surfaces as NaN, not as an exception.  Finite matrices get
    ``torch.linalg.eigh``'s results bit for bit."""
    bad = ~torch.isfinite(g).flatten(-2).all(-1)
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    lam, q = torch.linalg.eigh(torch.where(bad[..., None, None], eye, g))
    nan = float("nan")
    return (torch.where(bad[..., None], nan, lam),
            torch.where(bad[..., None, None], nan, q))


def svd_nan(a):
    """``torch.linalg.svd(a, full_matrices=False)`` with XLA's contract on
    a matrix that holds a non-finite entry: NaN factors, where torch's
    raises.  As in :func:`eigh_nan`, no host sync; finite matrices get
    torch's results bit for bit."""
    bad = ~torch.isfinite(a).all()
    u, s, vh = torch.linalg.svd(torch.where(bad, torch.zeros_like(a), a),
                                full_matrices=False)
    nan = float("nan")
    return (torch.where(bad, nan, u), torch.where(bad, nan, s),
            torch.where(bad, nan, vh))


def eigh(g):
    """:func:`eigh_nan` with the eigenvectors made orthonormal to working
    precision by one Newton--Schulz step, Q <- Q (3I - Q^T Q) / 2.
    ``jnp.linalg.eigh``, which the JAX package calls, returns them so;
    torch's f32 eigh on CUDA runs cuSOLVER's Jacobi solver at its default
    tolerance, whose eigenvectors are orthogonal only to some 1e-5
    (chip_smoke.py's phase 7 measures it on the block engine's pair
    Grams), and every rotation built from them carries that error."""
    lam, q = eigh_nan(g)
    qtq = matmul_at(q.transpose(-1, -2), q, "highest")
    return lam, 1.5 * q - 0.5 * matmul_at(q, qtq, "highest")


def cholesky(g):
    """Lower Cholesky factor of ``g`` (batched over leading axes) with
    XLA's failure contract: where the factorization fails, the factor
    is NaN on and below its diagonal (zero above, as XLA returns it).
    ``torch.linalg.cholesky`` raises there and ``torch.linalg.
    cholesky_ex`` returns a finite partial factor with ``info > 0``;
    ``info`` is read on the device, with no host sync."""
    c, info = torch.linalg.cholesky_ex(g)
    return torch.where((info == 0)[..., None, None], c,
                       torch.tril(torch.full_like(c, float("nan"))))
