"""Hand-over of state between numpy (or any ``__array__`` object) and
tensors.

This system has no weights: its state is the operand A and the sketch
Omega.  Tests and ``chip_smoke.py`` make both with numpy and pass the
same arrays to the JAX package and to this one.  A JAX array converts
through its ``__array__``; jax itself is never imported here.  Fitted
state (a ``POD`` of modes and singular values, a DEIM model, randomized
LU factors, a CCA fit, a HODLR matrix, tensor-format factors, embedding
tables, a kernel PCA fit) crosses over field by field
(:func:`pod_from_jax`, :func:`deim_from_jax`, :func:`rlu_from_jax`,
:func:`cca_from_jax`, :func:`hodlr_from_jax`, :func:`tucker_from_numpy`,
:func:`tt_from_numpy`, :func:`cp_from_numpy`, :func:`tables_from_jax`,
:func:`kpca_from_jax`), so a downstream stage can be compared apart from
the random draws that made the state.  A JAX BCOO sparse matrix crosses
as its (indices, data, shape) (:func:`bcoo_from_jax`).
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


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays on its own device unless
    ``device`` names another; any other array or number goes to
    ``device``, the card when None."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=dtype or x.dtype)
    return from_numpy(x, device=device, dtype=dtype)


def pod_from_jax(pod, device=None):
    """The port's ``apps.pod.POD`` holding the modes, singular values,
    retained rank and algorithm name of a JAX ``POD`` (or any object with
    those four fields), read as numpy."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.pod import POD

    return POD(from_numpy(pod.modes, device), from_numpy(pod.sigma, device),
               int(pod.rank), str(pod.algorithm))


def deim_from_jax(deim, device=None):
    """The port's ``rsvd.deim.Deim`` holding the basis, interpolation
    indices (int64) and oblique projector of a JAX ``Deim``, read as
    numpy."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.deim import Deim

    return Deim(from_numpy(deim.basis, device),
                from_numpy(deim.indices, device, torch.int64),
                from_numpy(deim.proj, device))


def rlu_from_jax(res, device=None):
    """The port's ``rsvd.rlu.RluResult`` holding a JAX ``RluResult``'s
    fields, read as numpy, its two permutations widened to int64."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.rlu import RluResult

    return RluResult(from_numpy(res.perm_rows, device, torch.int64),
                     from_numpy(res.perm_cols, device, torch.int64),
                     *(from_numpy(x, device) for x in res[2:]))


def cca_from_jax(res, device=None):
    """The port's ``rsvd.cca.CcaResult`` holding a JAX ``CcaResult``'s
    fields, read as numpy."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.cca import CcaResult

    return CcaResult(*(from_numpy(x, device) for x in res))


def hodlr_from_jax(h, device=None):
    """The port's ``rsvd.hodlr.HodlrMatrix`` holding a JAX
    ``HodlrMatrix``'s per-level factor stacks and leaves, read as numpy,
    and its ``n`` and ``k``."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.hodlr import (
        HodlrMatrix,
    )

    def stacks(xs):
        return tuple(from_numpy(x, device) for x in xs)

    return HodlrMatrix(stacks(h.u_upper), stacks(h.v_upper),
                       stacks(h.u_lower), stacks(h.v_lower),
                       from_numpy(h.leaves, device), n=int(h.n), k=int(h.k))


def tucker_from_numpy(core, factors, device=None):
    """(core, factors) of a Tucker decomposition as tensors."""
    return from_numpy(core, device), tuple(from_numpy(f, device)
                                           for f in factors)


def tt_from_numpy(cores, device=None):
    """The cores of a tensor train as tensors."""
    return tuple(from_numpy(c, device) for c in cores)


def cp_from_numpy(weights, factors, device=None):
    """(weights, factors) of a CP decomposition as tensors."""
    return from_numpy(weights, device), tuple(from_numpy(f, device)
                                              for f in factors)


def bcoo_from_jax(indices, data, shape, device=None):
    """A torch sparse COO tensor holding a JAX BCOO matrix's entries: its
    ``indices`` (nnz x 2), ``data`` (nnz,) and ``shape``, read as numpy.
    Duplicate entries stay as they are (the driver sums them, as
    BCOO's ``sum_duplicates`` does)."""
    idx = torch.from_numpy(np.array(indices, dtype=np.int64).T)
    t = torch.sparse_coo_tensor(idx, from_numpy(data, "cpu"),
                                tuple(int(d) for d in shape),
                                check_invariants=False)
    return t.to(device or "cuda")


def tables_from_jax(tables, device=None):
    """The port's ``apps.retrieval.EmbeddingTables`` or
    ``QuantizedTables`` holding a JAX fit's tables, read as numpy."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import retrieval

    cls = (retrieval.QuantizedTables if hasattr(tables, "users_q")
           else retrieval.EmbeddingTables)
    return cls(*(from_numpy(x, device) for x in tables))


def kpca_from_jax(kp, device=None):
    """The port's ``apps.kpca.KernelPCA`` holding a fitted JAX
    ``KernelPCA``'s parameters and state (training rows, centring means,
    eigenvalues, alphas, projection scales, scores), read as numpy: its
    ``transform`` then runs on the JAX fit."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.kpca import KernelPCA

    out = KernelPCA(kp.k, kernel=kp.kernel, gamma=kp.gamma,
                    degree=kp.degree, coef0=kp.coef0, solver=kp.solver,
                    p=kp.p, seed=kp.seed, device=device)
    out._x = from_numpy(kp._x, device)
    out._d = int(kp._d)
    out._col_means = from_numpy(kp._col_means, device)
    out._tot = from_numpy(kp._tot, device)
    out.eigenvalues_ = from_numpy(kp.eigenvalues_, device)
    out.alphas_ = from_numpy(kp.alphas_, device)
    out._inv_sqrt = from_numpy(kp._inv_sqrt, device)
    out.scores_ = from_numpy(kp.scores_, device)
    return out


def shard_block(x, index: int, parts: int, dim: int = 0) -> np.ndarray:
    """Block ``index`` of ``x`` cut into ``parts`` equal blocks along
    ``dim`` (a JAX sharded result read as numpy): what rank ``index`` of
    a split over ``parts`` ranks holds."""
    arr = np.asarray(x)
    step = arr.shape[dim] // parts
    return np.take(arr, np.arange(index * step, (index + 1) * step),
                   axis=dim)


def unshard_blocks(blocks, dim: int = 0) -> np.ndarray:
    """The whole array from the ranks' blocks (numpy or tensors), in
    rank order: the reverse of :func:`shard_block`."""
    return np.concatenate([to_numpy(b) if isinstance(b, torch.Tensor)
                           else np.asarray(b) for b in blocks], axis=dim)
