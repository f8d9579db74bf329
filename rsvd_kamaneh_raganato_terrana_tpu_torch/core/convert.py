"""Hand-over of state between numpy (or any ``__array__`` object) and
tensors.

This system has no weights: its state is the operand A and the sketch
Omega.  Tests and ``chip_smoke.py`` make both with numpy and pass the
same arrays to the JAX package and to this one.  A JAX array converts
through its ``__array__``; jax itself is never imported here.
"""

from __future__ import annotations

import numpy as np
import torch


def from_numpy(x, device=None, dtype=None) -> torch.Tensor:
    """Tensor copy of ``x`` (anything with ``__array__``) on ``device``
    (the card unless the caller names another), cast to ``dtype`` when
    given."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bf16 (ml_dtypes supplies it): widen exactly,
        # then narrow on the torch side
        arr = arr.astype(np.float32)
        dtype = torch.bfloat16 if dtype is None else dtype
    t = torch.from_numpy(np.array(arr, order="C"))   # always a copy
    return t.to(device=device or "cuda", dtype=dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a tensor; bf16 widens exactly to f32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
