"""Operands made on the device from the seed.  The harness hands the same
operand to the program and, after the window, to the plain reference;
each side rebuilds what it needs from these functions alone.

- ``planted``: a dense f32 matrix, a decaying planted spectrum plus
  Gaussian noise, made part by part (a part is one rank's rows) in
  fixed row blocks, so that any part or block can be made again bit for
  bit.
- ``ml20m``: a synthetic interaction matrix of MovieLens-20M's shape
  (frozen copy of ``chip_smoke.py::zipf_draw`` / ``ml20m_operand``).
"""

from __future__ import annotations

import contextlib
import math

import torch

_M64 = (1 << 64) - 1


def mix(seed: int, index: int) -> int:
    """A 63-bit seed from ``seed`` and a stream index (splitmix64)."""
    z = (int(seed) + (int(index) + 1) * 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return gen


def call_seed(seed: int, i: int) -> int:
    """The sketch seed of call ``i`` of a run (warm-up calls: i < 0)."""
    return mix(seed, 1_000_000 + i)


@contextlib.contextmanager
def ieee_f32():
    """f32 matmuls without TF32 inside the block, whatever was set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# -- planted dense operand ------------------------------------------------

def part_rows(op: dict) -> int:
    return op["rows"] // op.get("parts", 1)


def planted_right(op: dict, seed: int, device) -> torch.Tensor:
    """diag(sigma) V0^T (rank x cols), shared by every part."""
    gen = generator(mix(seed, 0), device)
    r, n = op["rank"], op["cols"]
    sigma = op["sigma_1"] * torch.exp(
        -torch.arange(r, device=device, dtype=torch.float32) / op["decay"])
    v0 = torch.randn(n, r, generator=gen, device=device) / math.sqrt(n)
    return (v0 * sigma).T.contiguous()


def planted_blocks(op: dict, seed: int, part: int, device, scratch=None):
    """Yield (first row, block) over part ``part``'s rows, in blocks of
    ``block_rows``: block = U0_block diag(sigma) V0^T + noise * G.  A
    block is written into ``scratch`` (a (block_rows, cols) f32 tensor)
    when given, else into a new tensor; the caller copies it before the
    next one is made."""
    rows, n, r = part_rows(op), op["cols"], op["rank"]
    w = planted_right(op, seed, device)
    gen = generator(mix(seed, part + 1), device)
    step = op["block_rows"]
    with ieee_f32():
        for r0 in range(0, rows, step):
            b = min(step, rows - r0)
            u = torch.randn(b, r, generator=gen, device=device) \
                / math.sqrt(op["rows"])
            blk = (scratch[:b] if scratch is not None
                   else torch.empty(b, n, device=device))
            blk.normal_(generator=gen)
            if op["noise"] != 1.0:
                blk.mul_(op["noise"])
            blk.addmm_(u, w)
            yield r0, blk


def planted_part(op: dict, seed: int, part: int, device) -> torch.Tensor:
    """Part ``part``'s rows of the planted operand, whole (rows x cols)."""
    out = torch.empty(part_rows(op), op["cols"], device=device)
    step = op["block_rows"]
    for r0, blk in planted_blocks(op, seed, part, device,
                                  scratch=torch.empty(step, op["cols"],
                                                      device=device)):
        out[r0:r0 + blk.shape[0]] = blk
    return out


# -- MovieLens-20M-shaped interactions (frozen copy of chip_smoke.py) -----

def zipf_draw(n, exponent, size, gen, device):
    """``size`` indices in [0, n) with P(i) ~ (i + 1)^-exponent, by
    inverse-CDF sampling on the device."""
    w = (torch.arange(n, device=device, dtype=torch.float64) + 1.0) \
        ** -exponent
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(size, device=device, dtype=torch.float64, generator=gen)
    return torch.clamp(torch.searchsorted(cdf, u), max=n - 1)


def ml20m(op: dict, seed: int, device):
    """(indices 2 x nnz int64, values f32, shape): distinct (user, item)
    pairs in row-major order, drawn from power laws of user activity and
    item popularity, ratings from a rank-``factors`` preference model
    plus noise, rounded to half stars in [0.5, 5]."""
    users, items, nnz = op["users"], op["items"], op["ratings"]
    gen = generator(mix(seed, 0), device)
    draw = nnz + nnz // 10
    keys = zipf_draw(users, op["zipf"][0], draw, gen, device) * items \
        + zipf_draw(items, op["zipf"][1], draw, gen, device)
    keys = torch.unique(keys)
    if keys.numel() < nnz:
        raise RuntimeError(f"ml20m: {keys.numel()} distinct pairs < {nnz}")
    keys = torch.sort(keys[torch.randperm(keys.numel(), device=device,
                                          generator=gen)[:nnz]]).values
    u, i = keys // items, keys % items
    del keys
    f = op["factors"]
    fu = torch.randn(users, f, device=device, generator=gen)
    fi = torch.randn(items, f, device=device, generator=gen)
    score = 3.5 + 0.3 * torch.sum(fu[u] * fi[i], dim=1) + 0.5 * torch.randn(
        nnz, device=device, generator=gen)
    r = torch.clamp(torch.round(2.0 * score) / 2.0, 0.5, 5.0)
    return torch.stack([u, i]), r, (users, items)
