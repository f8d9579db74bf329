"""Randomized SVD driver (Halko-Martinsson-Tropp stage A/B), the JAX
package's ``rsvd/driver.py``:

  stage A:  Y = A Omega  ->  Q = orth(Y)  ->  q rounds of power-iteration
            subspace refinement with re-orthonormalization,
  stage B:  B = Q^T A  ->  small SVD of B  ->  U = Q U_tilde,

with the finishes 'project', 'rowspace', 'utv' and 'rowspace_utv', and
the stage-A storage modes 'bf16' (A cast once) and 'int8' (row-scaled
int8, :class:`Int8Stored`, products on ``torch._int_mm``).

The dense stage-A GEMMs go to ``torch.matmul``/``torch.mm`` at the
requested precision (``core/device.py``); the orthonormalizations go
through ``linalg.qr.qr_reduced``, whose ``cholqr1_fused`` and
``polar_fused`` methods are the hand-written Hopper kernels K1 and K2;
``sketch='fused'`` draws Omega inside kernel K4 and ``method=
'eigh_pallas'`` runs the tail's eigh as kernel K3 (``linalg/kernels.py``).

The other modes: ``rsvd_batched`` (a stack, one sketch per element),
``rsvd_warm`` (from a previous basis), ``rsvd_onepass`` (two-sided
sketch, one pass over A), ``rsvd_adaptive`` (rank for an accuracy
target) and the image preset ``rsvd_image_preset``.

Not ported yet (ROADMAP.md): sparse operands, which raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    STORAGE_BF16,
    STORAGE_INT8,
    matmul_at,
    resolve_precision,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.profiling import rsvd_flops
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
    gaussian,
    key_from_seed,
    sketch_matrix,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import kernels
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import (
    orthonormal_basis,
    qr_reduced,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.svd import (
    SVDMethod,
    svd as small_svd,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION,
)

_FINISHES = ("project", "rowspace", "utv", "rowspace_utv")
# The longest contraction whose int32 sums cannot wrap: each product of
# two int8 values is at most 127^2 in magnitude.  Kept a multiple of 16,
# so that every chunk of an aligned operand stays aligned.
_INT8_CHUNK = (2 ** 31 - 1) // (127 * 127) // 16 * 16


def generate_omega(key_or_seed, n: int, l: int, dtype=torch.float32,
                   kind: str = "gaussian", device=None):
    """The n x l Gaussian test matrix, drawn from a ``torch.Generator``
    seeded from ``key_or_seed`` on ``device`` (the card unless the caller
    names another; a generator passed in draws on its own device)."""
    key = key_from_seed(key_or_seed, device)
    return sketch_matrix(key, n, l, dtype, kind)


class Int8Stored:
    """Row-scaled int8 storage of the stage-A operand: A ~ diag(s) Q8.

    Every stage-A pass reads one byte per element and contracts on the
    int8 path (``torch._int_mm``, int32 accumulation), with the scales
    folded into the small operands:

        A B   ~ diag(s) (Q8 B8) diag(t),   B ~ B8 diag(t)  (per-column)
        A^T C ~ Q8^T quant(diag(s) C) diag(t')

    cuBLASLt runs the int8 product fast only with the big operand in
    row-major order and the small one column-major (on an H100 the five
    int8 products of a 4096^2 serving call took 0.72 ms of device time
    with Q8^T read column-major, 0.06 ms row-major), and takes int8
    operands only at aligned shapes.  So the operand is held in both
    layouts, made once when it is built: ``layouts`` = (Q8, Q8^T), each
    row-major and zero-padded as :func:`_int8_layouts` says.  It takes
    two bytes per element, where the JAX package's takes one; each pass
    reads one.  ``q8`` is the unpadded m x n view of the first layout.
    A plain holder (no autograd: quantization is not differentiable);
    ``.T`` flips a flag and copies nothing, and ``_mm`` dispatches on
    it."""

    def __init__(self, q8, row_scale, transposed: bool = False,
                 layouts=None):
        if layouts is None:
            layouts = _int8_layouts(q8)
        self.layouts = layouts
        self.q8 = layouts[0][:q8.shape[0], :q8.shape[1]]
        self.row_scale = row_scale
        self.transposed = transposed

    @property
    def T(self):
        return Int8Stored(self.q8, self.row_scale, not self.transposed,
                          self.layouts)

    @property
    def shape(self):
        m, n = self.q8.shape
        return (n, m) if self.transposed else (m, n)

    @property
    def dtype(self):          # logical compute dtype of the products
        return self.row_scale.dtype

    @property
    def device(self):
        return self.q8.device


def _as_operand(a):
    """A tensor or :class:`Int8Stored` stays where it is; anything else
    (a numpy array, a list) becomes a tensor on the card."""
    if isinstance(a, (torch.Tensor, Int8Stored)):
        return a
    return torch.as_tensor(a, device="cuda")


def quantize_int8_rows(a) -> Int8Stored:
    """Per-row absmax int8 quantization of A (the serving storage mode):
    scale = max(|A_i,:|, tiny) / 127, Q8 = round(A / scale), rounding
    half to even as ``jnp.round`` does.  Builds both stored layouts of
    Q8 here (:class:`Int8Stored`), so no served call transposes or pads
    the operand."""
    a = _as_operand(a)
    out_dtype = torch.promote_types(a.dtype, torch.float32)
    absmax = torch.amax(torch.abs(a), dim=1, keepdim=True)
    scale = torch.clamp(absmax, min=torch.finfo(out_dtype).tiny) / 127.0
    q8 = torch.round(a / scale).to(torch.int8)
    return Int8Stored(q8, scale[:, 0].to(out_dtype))


def _quant_cols(b):
    """(B8, t): per-column int8 quantization of a small dense operand."""
    t = torch.clamp(torch.amax(torch.abs(b), dim=0, keepdim=True),
                    min=torch.finfo(b.dtype).tiny) / 127.0
    return torch.round(b / t).to(torch.int8), t


def _int8_width(d: int) -> int:
    """A padded int8 dimension: a multiple of 16 (16-byte rows), and more
    than 16 (``_int_mm``'s least row count on CUDA)."""
    return max(32, -(-d // 16) * 16)


def _int8_layouts(q8):
    """(Q8, Q8^T), each row-major and zero-padded to ``_int8_width`` in
    both dimensions, so that either is a left operand cuBLASLt's int8
    product takes as it is.  Zero rows and columns leave every product
    exact.  An aligned, contiguous Q8 is used as it is."""
    m, n = q8.shape
    shape = (_int8_width(m), _int8_width(n))
    if shape == (m, n) and q8.is_contiguous() and q8.data_ptr() % 16 == 0:
        fwd = q8
    else:
        fwd = q8.new_zeros(shape)
        fwd[:m, :n] = q8
    return fwd, fwd.T.contiguous()


def _int8_product(x8, y8):
    """The exact integer product x8 @ y8[:x8.shape[1]] of a left operand
    laid out by :func:`_int8_layouts` and a small int8 matrix with at most
    x8.shape[1] rows: int32, or int64 where the contraction is chunked.

    y8 is copied column-major (cuBLASLt is fast with x8 row-major and y8
    column-major), with zero rows up to x8's width and zero columns up to
    a multiple of 8 (``_int_mm``'s rule on CUDA); the big operand is read
    as it is.  ``torch._int_mm`` accumulates in int32, which wraps for
    contractions longer than ``_INT8_CHUNK`` (~133,000); such a
    contraction is cut into chunks of at most that length, summed in
    int64.  The same code runs on the CPU, where ``_int_mm`` has no shape
    rules."""
    k = x8.shape[1]
    cols = y8.shape[1]
    y8 = torch.nn.functional.pad(y8, (0, -cols % 8, 0, k - y8.shape[0]))
    y8 = y8.T.contiguous().T                     # column-major
    if k <= _INT8_CHUNK:
        return torch._int_mm(x8, y8)[:, :cols]
    out = torch.zeros((x8.shape[0], y8.shape[1]), dtype=torch.int64,
                      device=x8.device)
    for k0 in range(0, k, _INT8_CHUNK):
        k1 = min(k0 + _INT8_CHUNK, k)
        out += torch._int_mm(x8[:, k0:k1], y8[k0:k1])
    return out[:, :cols]


def _int8_mm(a: Int8Stored, b):
    """A @ B (or A^T @ B when ``a.transposed``) on the int8 path; the
    result in b's dtype widened to at least f32.  For contractions up to
    ``_INT8_CHUNK`` the integer sums are the JAX int32 ``dot_general``'s
    to the bit."""
    out_dtype = torch.promote_types(b.dtype, torch.float32)
    m, n = a.q8.shape
    fwd, bwd = a.layouts
    if a.transposed:
        # A^T B = Q8^T (diag(s) B): fold the row scales into the small
        # operand BEFORE quantizing it
        b8, t = _quant_cols(b * a.row_scale[:, None].to(b.dtype))
        z = _int8_product(bwd, b8)[:n]
        return z.to(out_dtype) * t.to(out_dtype)
    b8, t = _quant_cols(b)
    y = _int8_product(fwd, b8)[:m]
    return (y.to(out_dtype) * a.row_scale[:, None].to(out_dtype)
            * t.to(out_dtype))


def _check_dense(x):
    if x.layout != torch.strided:
        raise NotImplementedError(
            "sparse operands are not ported to the PyTorch package yet "
            "(ROADMAP.md, queue 1)")


def _mm(a, b, precision=DOT_PRECISION):
    """A @ B with the JAX driver's dtype rules: an :class:`Int8Stored`
    operand takes the int8 path (precision does not apply); same dtype ->
    product in that dtype; a bf16 operand mixed with a wider one -> the
    SMALL side is rounded to bf16 and the product accumulates and returns
    in the wide dtype (never widening the big operand); any other mix
    promotes."""
    if isinstance(a, Int8Stored):
        return _int8_mm(a, b)
    if isinstance(b, Int8Stored):
        # X @ A = (A^T @ X^T)^T: one transposed int8 product
        return _int8_mm(b.T, a.T).T
    _check_dense(a)
    _check_dense(b)
    if a.dtype != b.dtype:
        lo, out = ((a.dtype, b.dtype) if a.dtype.itemsize < b.dtype.itemsize
                   else (b.dtype, a.dtype))
        if lo == torch.bfloat16:
            return matmul_at(a.to(lo), b.to(lo), precision, out_dtype=out)
        wide = torch.promote_types(a.dtype, b.dtype)
        return matmul_at(a.to(wide), b.to(wide), precision)
    return matmul_at(a, b, precision)


def _colnormalize(y):
    """Diagonal column scaling to unit norms (``interior_qr='none'``)."""
    acc = torch.promote_types(y.dtype, torch.float32)
    norms = torch.sqrt(torch.sum(torch.square(y.to(acc)), dim=0))
    scale = 1.0 / torch.clamp(norms, min=torch.finfo(acc).tiny)
    return y * scale.to(y.dtype)[None, :]


def _interior_basis(y, method: str):
    return _colnormalize(y) if method == "none" else \
        orthonormal_basis(y, method)


def power_refine(a, q_mat, q: int, qr_method: str = "robust",
                 precision=DOT_PRECISION, reorth: str = "full",
                 interior_qr: Optional[str] = None):
    """q rounds of power-iteration subspace refinement.  ``reorth='full'``
    orthonormalizes both the Z and Y sides each round; ``'half'`` skips
    the Z-side QR.  ``interior_qr`` (default: ``qr_method``) is used for
    every orthonormalization except the final one; ``'none'`` only
    column-normalizes."""
    inner = qr_method if interior_qr is None else interior_qr
    for i in range(q):
        last = i == q - 1
        z = _mm(a.T, q_mat, precision)
        if reorth == "full" and inner != "none":
            z = orthonormal_basis(z, inner)
        y = _mm(a, z, precision)
        q_mat = (_interior_basis(y, qr_method) if last
                 else _interior_basis(y, inner))
    return q_mat


def subspace_iteration(a, omega, q: int, qr_method: str = "robust",
                       precision=DOT_PRECISION, reorth: str = "full",
                       interior_qr: Optional[str] = None):
    """Stage A: range finder with q power-iteration refinements."""
    y = _mm(a, omega, precision)
    inner = qr_method if interior_qr is None or q == 0 else interior_qr
    q_mat = _interior_basis(y, inner)
    return power_refine(a, q_mat, q, qr_method, precision, reorth,
                        interior_qr)


def _fold_weights(tri):
    """Column norms of a triangular (or, from polar, symmetric) middle
    factor -- the UTV finishes' decomposition weights -- and their
    divide-safe floor.  Norms accumulate in at least f32, never narrower
    than the input."""
    acc = torch.promote_types(tri.dtype, torch.float32)
    s = torch.linalg.norm(tri.to(acc), dim=0).to(tri.dtype)
    return s, torch.clamp(s, min=torch.finfo(acc).tiny)


def _check_options(method, precision, finish):
    """Refuse unknown options before any work is done."""
    SVDMethod.parse(method)
    resolve_precision(precision)
    if finish not in _FINISHES:
        raise ValueError(f"unknown finish {finish!r} (use 'project', "
                         "'rowspace', 'utv' or 'rowspace_utv')")


def _stage_operand(a, precision):
    """The operand stage A reads: A cast once to bf16 for the 'bf16'
    storage mode, quantized to :class:`Int8Stored` for 'int8', else A.
    An :class:`Int8Stored` is read as it is under any precision."""
    if isinstance(a, Int8Stored):
        return a
    if precision in STORAGE_BF16 and a.dtype.itemsize > 2:
        return a.to(torch.bfloat16)
    if precision in STORAGE_INT8:
        return quantize_int8_rows(a)
    return a


def _sorted_by_weight(u, s, v):
    order = torch.argsort(-s, stable=True)    # weights are near-sorted
    return u[:, order], s[order], v[:, order]


def rsvd_with_omega(a, omega, q: int = 2, k: int = 0,
                    method: str = "jacobi", qr_method: str = "robust",
                    precision: str = "highest",
                    reorth: str = "full", interior_qr: Optional[str] = None,
                    finish: str = "project"):
    """rSVD given an explicit sketch matrix Omega (n x l).  Returns
    (U, s, V) truncated to k (all l when k = 0).

    ``precision``: 'highest' | 'high' | 'default' | 'bf16' (A cast once
    to bf16, 'default' numerics) | 'int8' (A quantized once to row-scaled
    int8).
    ``a`` may be a pre-quantized :class:`Int8Stored` under any precision
    (the JAX package raises for one under 'bf16').

    ``finish``:
    - ``'project'`` (reference semantics): 2q+2 passes over A -- sketch,
      q power rounds, projection B = Q^T A -- then the small SVD of B by
      ``method`` and U = Q U_tilde.
    - ``'rowspace'`` (q >= 1): stop stage A at the co-range block
      Z = A^T Q, orthonormalize it and factor C = A Z_q directly: 2q+1
      passes, half a power iteration behind 'project'.
    - ``'utv'``: 'project''s passes, but B^T = V R by a thin QR instead
      of the Gram eigh; A ~ (Q L / ||L_col||) diag(||L_col||) V^T with
      L = R^T.  s are decomposition WEIGHTS, not singular values; U has
      unit columns, V is orthonormal.
    - ``'rowspace_utv'`` (q >= 1): the rowspace stage A ending in one
      thin QR of C; the same weight / unit-column contract as 'utv'.

    ``method`` is the small-SVD engine of the tail (``linalg/svd.py``);
    the default 'jacobi' is the JAX signature's."""
    _check_options(method, precision, finish)
    a_stage = _stage_operand(a, precision)
    if finish in ("rowspace", "rowspace_utv"):
        if q < 1:
            raise ValueError(f"finish={finish!r} needs q >= 1 (its final "
                             "half-round IS a power iteration)")
        inner = qr_method if interior_qr is None else interior_qr
        y = _mm(a_stage, omega, precision)
        q_mat = _interior_basis(y, inner)
        # q-1 full rounds, every basis interior (the tail re-orthonormalizes)
        q_mat = power_refine(a_stage, q_mat, q - 1, inner, precision, reorth,
                             interior_qr)
        z = _mm(a_stage.T, q_mat, precision)            # n x l co-range
        z_q = orthonormal_basis(z, qr_method)           # final (full) QR
        c = _mm(a_stage, z_q, precision)                # m x l: LAST pass
        if finish == "rowspace_utv":
            q_c, t = qr_reduced(c, qr_method)
            s, safe = _fold_weights(t)
            u, s, v = _sorted_by_weight(_mm(q_c, t / safe[None, :]), s, z_q)
        else:
            u_t, s, v_small = small_svd(c.T, method)    # c = v_small s u_t^T
            u, v = v_small, _mm(z_q, u_t)
    else:
        q_mat = subspace_iteration(a_stage, omega, q, qr_method, precision,
                                   reorth, interior_qr)      # m x l
        b = _mm(q_mat.T, a_stage, precision)                 # l x n
        if finish == "utv":
            v, r = qr_reduced(b.T, qr_method)                # B^T = V R
            el = r.T                                         # B = L V^T
            s, safe = _fold_weights(el)
            u, s, v = _sorted_by_weight(_mm(q_mat, el / safe[None, :]), s, v)
        else:
            u_t, s, v = small_svd(b, method)
            u = _mm(q_mat, u_t)
    if k > 0:
        u, s, v = u[:, :k], s[:k], v[:, :k]
    return u, s, v


def rsvd_core(a, seed, *, k, p, q, method, sketch, qr_method, precision,
              reorth, interior_qr, finish="project"):
    """Core of :func:`rsvd`: l = k + p (p when k = 0), Omega drawn from
    ``seed`` on A's device, then :func:`rsvd_with_omega`.

    ``sketch='fused'`` (finish='project' only) takes Y = A Omega from
    kernel K4, whose Omega is hashed from ``seed`` inside the kernel, and
    runs the stage-A refinement on A as it is: as in the JAX package, the
    storage modes 'bf16' and 'int8' then neither cast nor quantize A
    (their products keep 'default' numerics), and an
    :class:`Int8Stored` operand raises ``TypeError``."""
    m, n = a.shape
    l = min(k + p if k > 0 else p, min(m, n))
    if sketch == "fused":
        if finish != "project":
            raise ValueError("sketch='fused' (a documented negative-"
                             "result experiment) only supports "
                             "finish='project'")
        _check_options(method, precision, finish)
        y = kernels.fused_sketch_matmul(a, l, seed)
        inner = qr_method if interior_qr is None or q == 0 else interior_qr
        q_mat = _interior_basis(y, inner)
        q_mat = power_refine(a, q_mat, q, qr_method, precision, reorth,
                             interior_qr)
        b = _mm(q_mat.T, a, precision)
        u_t, s, v = small_svd(b, method)
        u = _mm(q_mat, u_t)
        if k > 0:
            u, s, v = u[:, :k], s[:k], v[:, :k]
        return u, s, v
    omega = generate_omega(seed, n, l, a.dtype, sketch, device=a.device)
    return rsvd_with_omega(a, omega, q, k, method, qr_method, precision,
                           reorth, interior_qr, finish)


def rsvd(
    a,
    k: int = 0,
    p: int = 10,
    q: int = 2,
    method=SVDMethod.Jacobi,
    sketch: str = "gaussian",
    qr_method: str = "robust",
    seed: int = 0,
    precision: str = "highest",
    reorth: str = "full",
    interior_qr: Optional[str] = None,
    finish: str = "project",
):
    """Randomized truncated SVD of a dense real tensor or an
    :class:`Int8Stored` operand: (U, s, V).

    k: target rank (0 = all l = p components); p: oversampling; q: power
    iterations; method: small-SVD engine for the l x n tail; precision:
    'highest' (IEEE fp32 GEMMs), 'default' (bf16 operands, f32
    accumulation on CUDA), 'bf16' ('default' numerics with A cast once to
    bf16) or 'int8' (row-scaled int8 storage; pre-quantize with
    :func:`quantize_int8_rows` when factoring the same A repeatedly);
    sketch: 'gaussian', 'rademacher' or 'fused' (kernel K4, see
    :func:`rsvd_core`).  A tensor stays on its device; any other array
    goes to the card."""
    method = SVDMethod.parse(method)
    a = _as_operand(a)
    if not isinstance(a, Int8Stored) and a.is_complex():
        raise TypeError("rsvd supports real dtypes only (the Gram/"
                        "projection chain uses plain transposes)")
    return rsvd_core(a, seed, k=k, p=p, q=q, method=method.value,
                     sketch=sketch, qr_method=qr_method, precision=precision,
                     reorth=reorth, interior_qr=interior_qr, finish=finish)


def reconstruct(u, s, v):
    """A_k = U diag(s) V^T."""
    return _mm(u * s[None, :], v.T)


def reconstruction_error(a, u, s, v):
    """||A - U diag(s) V^T||_F."""
    return torch.linalg.norm(a - reconstruct(u, s, v))


def rsvd_image_preset(a, k: int = -1, seed: int = 0):
    """The image-compression stack's preset: default k = min(m, n) / 4,
    p = 10, q = 1."""
    m, n = a.shape
    if k is None or k < 0:
        k = min(m, n) // 4
    return rsvd(a, k=k, p=10, q=1, seed=seed)


def _grow_basis_block(a, q_prev, omega_new, q: int,
                      qr_method: str = "robust"):
    """Orthonormal extension of an existing range basis: power-iterate the
    new sketch block against the deflated operator (I - Q Q^T) A, so the
    block converges to the next singular directions instead of re-finding
    the subspace Q already spans (Halko et al. sec. 4.4, blocked adaptive
    range finder)."""

    def deflate(y):
        return y - _mm(q_prev, _mm(q_prev.T, y))

    y = deflate(_mm(a, omega_new))
    y = orthonormal_basis(y, qr_method)
    for _ in range(q):
        y = _mm(a, _mm(a.T, y))
        y = deflate(y)
        y = orthonormal_basis(y, qr_method)
    # second-pass deflation ("twice is enough") for numerical cleanliness
    y = deflate(y)
    return orthonormal_basis(y, qr_method)


def _predict_rank(s64: np.ndarray, a_norm_sq: float, target_sq: float,
                  l: int, k_cap: int) -> int:
    """Log-linear extrapolation of the computed spectrum tail: the next
    sketch size that should meet the energy target, with a 15% margin.
    Falls back to doubling on flat or non-decaying tails.  Host f64, as
    in the JAX package."""
    resid_now = max(a_norm_sq - float(np.sum(s64 * s64)), 0.0)
    fit_lo = max(l // 2, 1)
    tail = s64[fit_lo:l]
    if tail.size >= 2 and np.all(tail > 0):
        idx = np.arange(fit_lo, l, dtype=np.float64)
        slope, intercept = np.polyfit(idx, np.log(tail), 1)
        if slope < -1e-6:
            # sum_{j>=l} s_j^2 ~ geometric with ratio r = exp(2*slope)
            r = float(np.exp(2.0 * slope))
            need = l
            acc = resid_now
            sj_sq = float(np.exp(2.0 * (intercept + slope * l)))
            while acc > target_sq and need < k_cap:
                acc -= sj_sq
                sj_sq *= r
                need += 1
            return min(k_cap, max(int(np.ceil(1.15 * need)), l + 8))
    return min(k_cap, 2 * l)


def adaptive_work_ratio(m: int, n: int, block_sizes, q: int) -> float:
    """GEMM-work ratio of an incremental adaptive run over the single
    right-sized run it converged to: (sum of per-block pipeline FLOPs +
    deflation projections) / flops(final l)."""
    total = 0.0
    l_prev = 0
    for dl in block_sizes:
        total += rsvd_flops(m, n, dl, q)
        if l_prev:
            # deflation (I - QQ^T) applied q+2 times per grown block:
            # two GEMMs of 2*m*l_prev*dl each per application
            total += (q + 2) * 2 * (2.0 * m * l_prev * dl)
        l_prev += dl
    return total / rsvd_flops(m, n, l_prev, q)


def rsvd_adaptive(a, tol: float, k0: int = 16, k_max: Optional[int] = None,
                  q: int = 2, method="eigh", seed: int = 0,
                  return_stats: bool = False):
    """Adaptive-rank rSVD: the smallest rank k (within sketch-growth
    granularity) with ||A - A_k||_F <= tol ||A||_F.

    Returns (U[:, :k], s[:k], V[:, :k], k), plus a stats dict
    (block_sizes, rounds, work_ratio against a single right-sized run)
    when ``return_stats`` is set.  The error estimate is free: for the
    projection A_l = Q Q^T A, ||A - A_l||_F^2 = ||A||_F^2 - sum_i s_i^2,
    read on the host in f64 from the computed spectrum (one fetch of s
    per round).  The basis grows incrementally: each round draws a new
    sketch block from ``seed + 7919 * round``, power-iterates it against
    the deflated operator (:func:`_grow_basis_block`) and appends its
    columns to Q and its rows to B = Q^T A; the block size comes from
    :func:`_predict_rank`.  Dense operands only (sparse ones are not
    ported, ROADMAP.md queue 1)."""
    a = _as_operand(a)
    if isinstance(a, Int8Stored):
        raise TypeError("rsvd_adaptive takes a dense tensor")
    _check_dense(a)
    a_norm_sq = float(torch.sum(torch.square(a)))
    m, n = a.shape
    min_dim = min(m, n)
    k_cap = min(k_max or min_dim, min_dim)
    target_sq = (tol * tol) * a_norm_sq

    l = min(k0, k_cap)
    omega = generate_omega(seed, n, l, a.dtype, device=a.device)
    q_mat = subspace_iteration(a, omega, q)          # m x l
    b = _mm(q_mat.T, a)                              # l x n
    round_no = 0
    blocks = [l]
    method_v = SVDMethod.parse(method).value
    while True:
        u_t, s, v = small_svd(b, method_v)
        s64 = s.detach().cpu().numpy().astype(np.float64)
        energy = np.cumsum(s64 * s64)
        resid_sq = np.maximum(a_norm_sq - energy, 0.0)
        ok = np.nonzero(resid_sq <= target_sq)[0]
        if ok.size or l >= k_cap:
            k = int(ok[0]) + 1 if ok.size else int(s.shape[0])
            u = _mm(q_mat, u_t)
            out = (u[:, :k], s[:k], v[:, :k], k)
            if return_stats:
                return out + ({"block_sizes": tuple(blocks),
                               "rounds": round_no,
                               "work_ratio": adaptive_work_ratio(
                                   m, n, blocks, q)},)
            return out
        l_next = _predict_rank(s64, a_norm_sq, target_sq, l, k_cap)
        dl = max(l_next - l, 1)
        round_no += 1
        omega_new = generate_omega(seed + 7919 * round_no, n, dl, a.dtype,
                                   device=a.device)
        q_blk = _grow_basis_block(a, q_mat, omega_new, q)
        q_mat = torch.cat([q_mat, q_blk], dim=1)
        b = torch.cat([b, _mm(q_blk.T, a)], dim=0)
        l += dl
        blocks.append(dl)


def rsvd_onepass(a, k: int, p: int = 16, s_factor: int = 2,
                 method: str = "eigh", seed: int = 0,
                 precision: str = "highest"):
    """Rank-k rSVD in a single pass over A (the two-sided sketch of
    Tropp, Yurtsever, Udell & Cevher 2017): the range sketch Y = A Omega
    and the co-range sketch W = Psi^T A, then A ~ Q (Psi^T Q)^+ W with a
    small SVD finishing the l x n core.  The two sketches are two GEMMs,
    so the card reads A twice.  Accuracy is a constant factor behind one
    power iteration.  Omega (n x l) and Psi (m x s, s = s_factor l + 1)
    come, in that order, from one generator seeded with ``seed`` on A's
    device.  Composes with the int8 storage mode: pass an
    :class:`Int8Stored` (or ``precision='int8'``) and each sketch reads
    one byte per element.  Returns (U, s, V) truncated to k."""
    a = _as_operand(a)
    resolve_precision(precision)
    m, n = a.shape
    dtype = a.dtype
    l = min(k + p, min(m, n))
    s_cols = min(s_factor * l + 1, m)
    a_stage = a
    if precision in STORAGE_INT8 and not isinstance(a, Int8Stored):
        a_stage = quantize_int8_rows(a)
    key = key_from_seed(seed, a.device)
    omega = gaussian(key, (n, l), dtype)
    psi = gaussian(key, (m, s_cols), dtype)
    y = _mm(a_stage, omega, precision)                 # m x l
    w = _mm(psi.T, a_stage, precision)                 # s x n
    q_mat = orthonormal_basis(y, "robust")
    p_mat = _mm(psi.T, q_mat)                          # s x l
    qp, rp = qr_reduced(p_mat, "householder")
    x = torch.linalg.solve_triangular(rp, _mm(qp.T, w), upper=True)  # l x n
    u_t, sv, v = small_svd(x, method)
    u = _mm(q_mat, u_t)
    return u[:, :k], sv[:k], v[:, :k]


def rsvd_warm(a, q_prev, k: int = 0, q: int = 1, method: str = "eigh",
              qr_method: str = "robust", precision: str = "highest",
              reorth: str = "full"):
    """rSVD warm-started from an existing range basis: for a sweep of
    slowly varying matrices, power-iterating the previous factorization's
    Q reaches a cold start's accuracy with fewer passes over A.
    ``q_prev`` is any m x l orthonormal(ish) basis, e.g. U from the
    previous step.  Returns (U, s, V) truncated to k (all l when k = 0)."""
    a = _as_operand(a)
    resolve_precision(precision)
    if not isinstance(q_prev, torch.Tensor):
        q_prev = torch.as_tensor(q_prev, device=a.device)
    q_mat = orthonormal_basis(q_prev, qr_method)
    q_mat = power_refine(a, q_mat, q, qr_method, precision, reorth)
    b = _mm(q_mat.T, a, precision)
    u_t, s, v = small_svd(b, method)
    u = _mm(q_mat, u_t)
    if k > 0:
        u, s, v = u[:, :k], s[:k], v[:, :k]
    return u, s, v


def rsvd_batched(a_batch, k: int, p: int = 10, q: int = 2,
                 method: str = "eigh", seed: int = 0,
                 precision: str = "highest", reorth: str = "full",
                 finish: str = "project", mode: str = "scan"):
    """Batched rSVD of a stacked (b, m, n) operand: element i draws its own
    sketch from ``seed + i`` and runs :func:`rsvd_with_omega`, one element
    after the other on A's device.

    ``mode='scan'`` runs the exact single-matrix pipeline ('robust' QR);
    ``mode='vmap'`` gives the numbers of the JAX package's vmapped mode,
    whose QR is 'cholqr2' (a ``lax.cond`` under vmap would run both
    branches).  Sharding the batch over several cards waits for the
    distributed slice (ROADMAP.md queue 1).

    Returns (U, s, V) with shapes (b, m, k), (b, k), (b, n, k)."""
    if mode not in ("scan", "vmap"):
        raise ValueError(f"unknown mode {mode!r} (use 'scan' or 'vmap')")
    a_batch = _as_operand(a_batch)
    if a_batch.ndim != 3:
        raise ValueError(f"rsvd_batched takes a (b, m, n) stack, got "
                         f"{tuple(a_batch.shape)}")
    if k <= 0:
        raise ValueError("rsvd_batched needs an explicit k > 0")
    b, m, n = a_batch.shape
    l = min(k + p, min(m, n))
    qr_method = "robust" if mode == "scan" else "cholqr2"
    outs = [rsvd_with_omega(a_batch[i], generate_omega(
                seed + i, n, l, a_batch.dtype, device=a_batch.device),
                q=q, k=k, method=method, qr_method=qr_method,
                precision=precision, reorth=reorth, finish=finish)
            for i in range(b)]
    return tuple(torch.stack(parts) for parts in zip(*outs))
