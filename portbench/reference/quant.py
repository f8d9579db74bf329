"""Frozen copies of the rounding rules the references need.

- :func:`int8_rows`: the port's documented serving storage rule
  (``quantize_int8_rows``): scale = max(|A_i,:|, tiny_f32) / 127,
  Q8 = round(A / scale), rounding half to even, computed in f32.
- :func:`rows_codes` / :func:`cols_rounded`: the same rule with L levels
  each side (127 for int8, 7 for int4), for the controls.
- :func:`tf32`: an f32 value rounded to TF32's 10 mantissa bits (to
  nearest, ties to even), as a TF32 tensor-core operand is.
"""

from __future__ import annotations

import torch

TINY32 = torch.finfo(torch.float32).tiny


def rows_codes(blk: torch.Tensor, levels: int):
    """(codes f32, scale f32 (rows,)) of an f32 row block at ``levels``."""
    absmax = torch.amax(torch.abs(blk), dim=1, keepdim=True)
    scale = torch.clamp(absmax, min=TINY32) / float(levels)
    codes = torch.clamp(torch.round(blk / scale), -levels, levels)
    return codes, scale[:, 0]


def int8_rows(blk: torch.Tensor):
    """The serving rule: (int8 codes, f32 scales) of an f32 row block."""
    codes, scale = rows_codes(blk, 127)
    return codes.to(torch.int8), scale


def cols_rounded(x: torch.Tensor, levels: int) -> torch.Tensor:
    """x with each column rounded to ``levels`` levels a side of its
    absmax (per-column quantization, returned dequantized, x's dtype)."""
    amax = torch.amax(torch.abs(x), dim=0, keepdim=True)
    t = torch.clamp(amax, min=TINY32) / float(levels)
    return torch.clamp(torch.round(x / t), -levels, levels) * t


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 explicit mantissa bits)."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)
