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
  bf16.
- ``'bf16'``/``'bfloat16'`` and ``'int8'`` are storage modes of the
  driver (A cast once to bf16, or quantized to row-scaled int8); their
  dense products get the numerics of ``'default'``, as the JAX
  ``_PRECISIONS`` map gives them (rsvd/driver.py:65-74).
- ``'high'`` is not ported yet (ROADMAP.md, queue 1) and raises
  ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib

import torch

#: the storage modes, read by the driver; their dense products run at
#: 'default'
STORAGE_BF16 = ("bf16", "bfloat16")
STORAGE_INT8 = ("int8",)
PORTED_PRECISIONS = ("highest", "default") + STORAGE_BF16 + STORAGE_INT8
_UNPORTED_PRECISIONS = ("high",)


def resolve_precision(precision) -> str:
    """The numerics of ``precision``: 'highest' or 'default' (the storage
    modes map to 'default'); raises for names not ported yet."""
    name = str(precision).lower()
    if name in STORAGE_BF16 + STORAGE_INT8:
        return "default"
    if name in PORTED_PRECISIONS:
        return name
    if name in _UNPORTED_PRECISIONS:
        raise NotImplementedError(
            f"precision={precision!r} is not ported to the PyTorch package "
            "yet (ROADMAP.md, queue 1); use 'highest', 'default', 'bf16' "
            "or 'int8'")
    raise ValueError(f"unknown precision {precision!r}")


@contextlib.contextmanager
def ieee_fp32():
    """Full fp32 matmuls (TF32 off) inside the block; the caller's
    setting is restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


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
        return _bf16_product(a.to(torch.bfloat16), b.to(torch.bfloat16),
                             out_dtype)
    with ieee_fp32():
        return torch.matmul(a, b).to(out_dtype)
