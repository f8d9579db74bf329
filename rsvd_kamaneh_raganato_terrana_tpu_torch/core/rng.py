"""Seeded random test matrices on a ``torch.Generator``.

The counterpart of the JAX package's ``core/rng.py``.  A ``key`` here is
a ``torch.Generator`` that lives on the target device, seeded from an
integer; the values follow from the seed alone.  Torch's Philox streams
do not reproduce JAX's threefry values, so parity tests hand the same
explicit Omega (made with numpy) to both packages.
"""

from __future__ import annotations

import torch

_M64 = (1 << 64) - 1


def key_from_seed(seed, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (the card, ``"cuda"``, unless
    the caller names another) seeded from an int ``seed``; an existing
    generator is returned as it is."""
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=torch.device(device or "cuda"))
    gen.manual_seed(int(seed))
    return gen


def fold_in_shard(key: torch.Generator, shard_index) -> torch.Generator:
    """An independent stream for one shard or tile (JAX ``fold_in_shard``):
    a new generator on the key's device, seeded from a fixed integer mix
    (splitmix64) of ``key.initial_seed()`` and ``shard_index``.
    Deterministic; it does not reproduce JAX's threefry values."""
    z = (key.initial_seed() + (int(shard_index) + 1)
         * 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    gen = torch.Generator(device=key.device)
    gen.manual_seed(z ^ (z >> 31))
    return gen


def gaussian(key: torch.Generator, shape, dtype=torch.float32):
    """Standard-normal tensor on the generator's device."""
    return torch.randn(tuple(shape), generator=key, device=key.device,
                       dtype=dtype)


def rademacher(key: torch.Generator, shape, dtype=torch.float32):
    """Rademacher +-1 tensor on the generator's device."""
    bits = torch.randint(0, 2, tuple(shape), generator=key,
                         device=key.device)
    return (2 * bits - 1).to(dtype)


def sketch_matrix(key: torch.Generator, n: int, l: int,
                  dtype=torch.float32, kind: str = "gaussian"):
    """The n x l random test matrix Omega of rSVD stage A."""
    if kind == "gaussian":
        return gaussian(key, (n, l), dtype)
    if kind == "rademacher":
        return rademacher(key, (n, l), dtype)
    raise ValueError(f"unknown sketch kind {kind!r}")
