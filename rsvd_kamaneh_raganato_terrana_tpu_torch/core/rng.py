"""Seeded random test matrices on a ``torch.Generator``.

The counterpart of the JAX package's ``core/rng.py``.  A ``key`` here is
a ``torch.Generator`` that lives on the target device, seeded from an
integer; the values follow from the seed alone.  Torch's Philox streams
do not reproduce JAX's threefry values, so parity tests hand the same
explicit Omega (made with numpy) to both packages.
"""

from __future__ import annotations

import torch


def key_from_seed(seed, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (the card, ``"cuda"``, unless
    the caller names another) seeded from an int ``seed``; an existing
    generator is returned as it is."""
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=torch.device(device or "cuda"))
    gen.manual_seed(int(seed))
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
