"""Randomized SVD driver (Halko-Martinsson-Tropp stage A/B), the JAX
package's ``rsvd/driver.py``:

  stage A:  Y = A Omega  ->  Q = orth(Y)  ->  q rounds of power-iteration
            subspace refinement with re-orthonormalization,
  stage B:  B = Q^T A  ->  small SVD of B  ->  U = Q U_tilde,

with the finishes 'project', 'rowspace', 'utv' and 'rowspace_utv', and
the stage-A storage modes 'bf16' (A cast once) and 'int8' (row-scaled
int8, :class:`Int8Stored`, products on ``torch._int_mm``).  At
'default' an f32 operand on the card is rounded to bf16 once a call, by
its first product (:class:`Bf16OnFirstUse`; where that is the sketch of
a tall A, kernel K6 makes the copy as it computes Y = A Omega), and the
copy dropped after the last pass over A.

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

Sharded operands: a DTensor whose rows (and optionally columns) are
sharded over a ``DeviceMesh``, or an :class:`Int8Stored` of row-sharded
DTensors, goes through ``rsvd``/``rsvd_core``/``rsvd_with_omega`` (and,
rows sharded, through ``rsvd_adaptive``, ``rsvd_onepass`` and
``rsvd_warm``) by the helpers of ``rsvd/_sharded.py``, with
the numerics XLA's partitioner gives the JAX package: Y = A Omega and
every m-sized panel stay row-sharded, Z = A^T Q and B = Q^T A are local
products all-reduced over the rows (and gathered over a column split),
the l x l work is replicated on every rank (``linalg/qr.py`` and
``linalg/svd.py`` say how a row-split panel is factored).  U comes back
as a row-sharded DTensor, s and V as replicated tensors.  Every
collective is counted by ``core/collectives.py``.  :func:`rsvd_sharded`
pads ragged rows and crops them.

Sparse operands (a torch sparse tensor of any layout, the counterpart of
the JAX package's BCOO) are held as :class:`SparseStored`: A and A^T as
two CSR tensors built once, so every stage-A product is a forward CSR
product (cuSPARSE SpMM on the card).  Precision flags do not apply to
them, and the storage modes neither cast nor quantize them.  A sparse
operand split by its entries over the ranks (``core/mesh.py::
shard_rows`` of a sparse tensor, an ``EntrySplit``: JAX's BCOO placed
with the row sharding) goes through ``rsvd``, ``rsvd_with_omega``,
``rsvd_adaptive``, ``rsvd_onepass``, ``rsvd_warm``, ``power_refine`` and
``subspace_iteration``: each product is the rank's run of entries
times a whole panel, all-reduced (``rsvd/_sharded.py::_entry_mm``), so
every panel, and U, is replicated, as JAX's are.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    STORAGE_BF16,
    STORAGE_INT8,
    matmul_at,
    resolve_precision,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    EntrySplit,
    Sharded,
    from_dtensor,
    is_dtensor,
    mesh_axis,
    row_dtensor,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.mesh import (
    pad_rows_for_mesh,
    shard_rows,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.profiling import (
    call_span,
    rsvd_flops,
    span,
)
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
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _cat_cols,
    _cols,
    _entry_mm,
    _like,
    _local,
    _norm,
    _reduce,
    _row_block,
    _sharded_mm,
    _sharded_view,
    _to_api,
    _whole,
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
    it.  Q8 and the scales may be DTensors sharded by rows (the
    multi-card serving layout); the driver then reads each rank's
    block."""

    def __init__(self, q8, row_scale, transposed: bool = False,
                 layouts=None):
        if is_dtensor(q8):
            # row-sharded: the driver reads each rank's block
            # (_sharded_view), which builds its own layouts
            self.q8, self.row_scale = q8, row_scale
            self.transposed, self.layouts = transposed, None
            return
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


class SparseStored:
    """A sparse stage-A operand: A and A^T, each a CSR tensor with its
    duplicate entries summed, built once by :func:`sparse_operand`.

    A^T Q through A's CSR is a transposed product, 4.8x the time of a
    forward one on an H100 at MovieLens-20M's shape (PERF.md); holding
    A^T as its own CSR makes every product of the driver a forward CSR x
    dense product.  It costs a second copy of the values and column
    indices: nnz (itemsize + 4) + 4 (m + n + 2) bytes for the two, with
    int32 indices (used where nnz and both sides are below 2^31).  CSR
    rather than COO: COO products convert to CSR on every call.  On the
    card neither layout's product (cuSPARSE SpMM) is bitwise from run to
    run.  ``.T`` swaps the two and copies nothing, as
    :class:`Int8Stored`'s does; ``_mm`` dispatches on it."""

    def __init__(self, fwd, bwd):
        self.fwd, self.bwd = fwd, bwd

    @property
    def T(self):
        return SparseStored(self.bwd, self.fwd)

    @property
    def shape(self):
        return tuple(self.fwd.shape)

    @property
    def dtype(self):
        return self.fwd.dtype

    @property
    def device(self):
        return self.fwd.device

    def values(self):
        """The stored entries of A (duplicates summed)."""
        return self.fwd.values()


# casts, reuses and K6-made copies of Bf16OnFirstUse since the last reset
_stage_counts = [0, 0, 0]


def stage_tally() -> dict:
    """{casts, reuses, fused} since the last :func:`reset_stage_tally`:
    how often a :class:`Bf16OnFirstUse` operand was rounded to bf16, how
    often a product read the copy already made, and how many of the
    copies K6 made in the first product (:func:`_cast_in_sketch`; each
    counts among the casts too).  The fit's settings (q = 2, 'project')
    read one cast and 2q + 1 = 5 reuses a call, and one fused on the
    card at the fit's shape."""
    return dict(zip(("casts", "reuses", "fused"), _stage_counts))


def reset_stage_tally() -> None:
    """Zero :func:`stage_tally`."""
    _stage_counts[:] = [0, 0, 0]


class Bf16OnFirstUse:
    """The stage-A operand of a 'default' call on an f32 CUDA tensor: A,
    rounded to bf16 once a call, by the first product that reads it.

    A 'default' product of f32 operands rounds both to bf16
    (``core/device.py::matmul_at``); A rounds to the same copy in every
    pass, so one copy serves all 2q + 2 of a call's products, in both
    orientations.  The copy is ``a.to(torch.bfloat16)``, with A's
    strides, and ``.T`` reads it transposed, with the strides of
    ``a.T.to(torch.bfloat16)``: every GEMM gets the operands, layouts and
    f32 accumulation of the per-product cast, so the factors are those
    of a cast in each product, bit for bit.  The copy takes half of A's
    bytes while the call runs: :func:`_factor` releases it after the last
    pass over A, and nothing keeps it between calls.  ``.T`` shares the
    copy and flips a flag, as :class:`Int8Stored`'s does; ``_product``
    dispatches on it."""

    def __init__(self, a, transposed: bool = False, held=None):
        self.a, self.transposed = a, transposed
        self._held = [None] if held is None else held

    @property
    def T(self):
        return Bf16OnFirstUse(self.a, not self.transposed, self._held)

    @property
    def shape(self):
        m, n = self.a.shape
        return (n, m) if self.transposed else (m, n)

    @property
    def dtype(self):          # logical compute dtype of the products
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    def plain(self):
        """A (or A^T) as the caller gave it."""
        return self.a.T if self.transposed else self.a

    def bf16(self):
        """bf16(A) (or its transpose), made by the first call; called
        under the ``rsvd/cast`` span."""
        copy = self._held[0]
        if copy is None:
            copy = self._held[0] = self.a.to(torch.bfloat16)
            _stage_counts[0] += 1
        else:
            _stage_counts[1] += 1
        return copy.T if self.transposed else copy

    def bf16_times(self, x16):
        """A @ x16 in f32 by K6 (``kernels.cast_sketch``), which makes
        the copy as it reads A: the first product, where
        :func:`_cast_in_sketch` routes it.  The copy is the bytes, strides
        and lifetime :meth:`bf16` gives it."""
        self._held[0], y = kernels.cast_sketch(self.a, x16)
        _stage_counts[0] += 1
        _stage_counts[2] += 1
        return y

    def release(self):
        """Drop the copy; a later product would make it again."""
        self._held[0] = None


def _csr(coo):
    """CSR of a coalesced COO tensor, int32 indices where they fit."""
    with warnings.catch_warnings():      # torch's "CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = coo.to_sparse_csr()
    if coo._nnz() < 2 ** 31 and max(coo.shape) < 2 ** 31:
        csr = torch.sparse_csr_tensor(
            csr.crow_indices().to(torch.int32),
            csr.col_indices().to(torch.int32), csr.values(), csr.shape,
            check_invariants=False)
    return csr


def is_sparse(x) -> bool:
    """A :class:`SparseStored`, an entry-split one (``EntrySplit``) or a
    torch sparse tensor of any layout."""
    return isinstance(x, (SparseStored, EntrySplit)) or (
        isinstance(x, torch.Tensor) and x.layout != torch.strided)


def sparse_operand(a) -> SparseStored:
    """:class:`SparseStored` of a sparse tensor (COO, CSR, CSC, BSR or
    BSC): duplicates summed (JAX's ``sum_duplicates``), then the CSR of A
    and of A^T.  A :class:`SparseStored` is returned as it is."""
    if isinstance(a, SparseStored):
        return a
    coo = a if a.layout == torch.sparse_coo else a.to_sparse_coo()
    coo = coo.coalesce()
    return SparseStored(_csr(coo), _csr(coo.t().coalesce()))


def _as_operand(a):
    """An :class:`Int8Stored` or :class:`SparseStored` (entry-split too)
    stays as it is, a sparse tensor becomes a :class:`SparseStored` on
    its device, a dense tensor stays where it is; anything else (a numpy
    array, a list) becomes a tensor on the card."""
    if isinstance(a, (Int8Stored, SparseStored, Sharded, EntrySplit)):
        return a
    if isinstance(a, torch.Tensor):
        return sparse_operand(a) if is_sparse(a) else a
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


def _quant_cols(b, amax=None):
    """(B8, t): per-column int8 quantization of a small dense operand;
    ``amax`` (1 x columns) stands in for its column absmax (a row-split
    operand's, all-reduced)."""
    with span("cast"):
        if amax is None:
            amax = torch.amax(torch.abs(b), dim=0, keepdim=True)
        t = torch.clamp(amax, min=torch.finfo(b.dtype).tiny) / 127.0
        return torch.round(b / t).to(torch.int8), t


def _int8_width(d: int) -> int:
    """A padded int8 dimension: a multiple of 16 (16-byte rows), and more
    than 16 (``_int_mm``'s least row count on CUDA)."""
    return max(32, -(-d // 16) * 16)


def _int8_padded(q8):
    """Q8 row-major and zero-padded to ``_int8_width`` in both
    dimensions: a left operand cuBLASLt's int8 product takes as it is.
    Zero rows and columns leave every product exact.  An aligned,
    contiguous Q8 is used as it is."""
    m, n = q8.shape
    shape = (_int8_width(m), _int8_width(n))
    if shape == (m, n) and q8.is_contiguous() and q8.data_ptr() % 16 == 0:
        return q8
    fwd = q8.new_zeros(shape)
    fwd[:m, :n] = q8
    return fwd


def _int8_layouts(q8):
    """(Q8, Q8^T), each laid out by :func:`_int8_padded`."""
    fwd = _int8_padded(q8)
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


def _mm(a, b, precision=DOT_PRECISION):
    """A stage-A product, :func:`_product` under the ``rsvd/product``
    span."""
    with span("product"):
        return _product(a, b, precision)


def _product(a, b, precision=DOT_PRECISION):
    """A @ B with the JAX driver's dtype rules: an :class:`Int8Stored`
    operand takes the int8 path (precision does not apply); a sparse one
    a sparse x dense product (precision does not apply either, JAX
    driver.py:174-177); same dtype -> product in that dtype; a bf16
    operand mixed with a wider one -> the SMALL side is rounded to bf16
    and the product accumulates and returns in the wide dtype (never
    widening the big operand); any other mix promotes."""
    if isinstance(a, EntrySplit) or isinstance(b, EntrySplit):
        return _entry_mm(a, b, precision)
    if isinstance(a, Sharded) or isinstance(b, Sharded):
        return _sharded_mm(a, b, precision)
    if isinstance(a, Int8Stored):
        return _int8_mm(a, b)
    if isinstance(b, Int8Stored):
        # X @ A = (A^T @ X^T)^T: one transposed int8 product
        return _int8_mm(b.T, a.T).T
    if isinstance(a, Bf16OnFirstUse) or isinstance(b, Bf16OnFirstUse):
        return _staged_mm(a, b, precision)
    if isinstance(a, SparseStored):
        # a column-major dense operand costs cuSPARSE ~11x (PERF.md)
        return a.fwd @ b.contiguous()
    if isinstance(b, SparseStored):
        # X @ A = (A^T @ X^T)^T: a forward product of A^T's CSR
        return (b.bwd @ a.T.contiguous()).T
    if is_sparse(a) or is_sparse(b):
        return a @ b
    if a.dtype != b.dtype:
        lo, out = ((a.dtype, b.dtype) if a.dtype.itemsize < b.dtype.itemsize
                   else (b.dtype, a.dtype))
        if lo == torch.bfloat16:
            with span("cast"):
                a, b = a.to(lo), b.to(lo)
            return matmul_at(a, b, precision, out_dtype=out)
        wide = torch.promote_types(a.dtype, b.dtype)
        return matmul_at(a.to(wide), b.to(wide), precision)
    return matmul_at(a, b, precision)


def _staged_mm(a, b, precision):
    """A product with a :class:`Bf16OnFirstUse` operand: A read from its
    one bf16 copy, the other side rounded to bf16, accumulated and
    returned in f32, under one ``rsvd/cast`` span as ``matmul_at``'s
    casts are.  Beside a wider operand (f64) A is promoted unrounded, as
    it would be unstaged.  Where :func:`_cast_in_sketch` routes the first
    product to K6, the copy is made by the product itself, and only the
    other side's cast is under ``rsvd/cast``."""
    other = b if isinstance(a, Bf16OnFirstUse) else a
    if other.dtype.itemsize > 4:
        a, b = (x.plain() if isinstance(x, Bf16OnFirstUse) else x
                for x in (a, b))
        return _product(a, b, precision)
    if (isinstance(a, Bf16OnFirstUse) and a._held[0] is None
            and a.device.type == "cuda"
            and _cast_in_sketch(a, b.shape[1], _sm_count(a.device))):
        with span("cast"):          # K6 reads Omega^T contiguous
            b16 = b.T.to(torch.bfloat16,
                         memory_format=torch.contiguous_format).T
        return a.bf16_times(b16)
    with span("cast"):
        a, b = (x.bf16() if isinstance(x, Bf16OnFirstUse)
                else x.to(torch.bfloat16) for x in (a, b))
    return matmul_at(a, b, precision, out_dtype=torch.float32)


#: K6 takes a first product only where A has at least this many 128-row
#: tiles an SM of the card (K6 runs one block a tile, at most one an SM).
#: The row sweep on an H100 (PERF.md, K6's row) at l = 144, n = 100000 and
#: 16384: 3.1-3.7x the cast and GEMM's time at 8 tiles, 1.7-1.9x at 16,
#: 0.95-0.99x at 32, 0.77-0.81x at 48 and 0.79-0.83x from 64 up
_CAST_SKETCH_WAVES = 0.25


def _cast_in_sketch(stage, width: int, sms: int) -> bool:
    """Whether the first product over the staged operand ``stage`` (a
    :class:`Bf16OnFirstUse`), times a panel ``width`` columns wide, is
    K6 (``kernels.cast_sketch``) on a card of ``sms`` SMs: A read
    untransposed as the left factor; A f32, row-major, contiguous and
    16-byte aligned with n a multiple of 8 (TMA's 16-byte rows of the
    copy); the panel at most ``kernels.CAST_SKETCH_MAX_WIDTH`` wide; and
    at least ``_CAST_SKETCH_WAVES`` of a 128-row tile of A an SM, so
    that enough SMs stream A to keep the card's memory busy.
    Every other first use is ``a.to(torch.bfloat16)`` and ``torch.mm``."""
    a = stage.a
    m, n = a.shape
    return (not stage.transposed and a.dtype == torch.float32
            and a.is_contiguous() and a.data_ptr() % 16 == 0 and n % 8 == 0
            and 1 <= width <= kernels.CAST_SKETCH_MAX_WIDTH
            and -(-m // 128) >= _CAST_SKETCH_WAVES * sms)


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _colnormalize(y):
    """Diagonal column scaling to unit norms (``interior_qr='none'``)."""
    acc = torch.promote_types(y.dtype, torch.float32)
    with span("ortho"):
        if isinstance(y, Sharded):
            scale = 1.0 / torch.clamp(torch.sqrt(y.col_sumsq()),
                                      min=torch.finfo(acc).tiny)
            return y.with_local(y.local * scale.to(y.dtype)[None, :])
        norms = torch.sqrt(torch.sum(torch.square(y.to(acc)), dim=0))
        scale = 1.0 / torch.clamp(norms, min=torch.finfo(acc).tiny)
        return y * scale.to(y.dtype)[None, :]


def _interior_basis(y, method: str):
    return _colnormalize(y) if method == "none" else \
        orthonormal_basis(y, method)


def _at_api(*xs) -> bool:
    """Whether a public function was handed a sharded operand (a DTensor,
    or an :class:`Int8Stored` of DTensors): its m-row results then go
    back as row-sharded DTensors."""
    return any(is_dtensor(x) or (isinstance(x, Int8Stored)
                                 and is_dtensor(x.q8)) for x in xs)


def power_refine(a, q_mat, q: int, qr_method: str = "robust",
                 precision=DOT_PRECISION, reorth: str = "full",
                 interior_qr: Optional[str] = None):
    """q rounds of power-iteration subspace refinement.  ``reorth='full'``
    orthonormalizes both the Z and Y sides each round; ``'half'`` skips
    the Z-side QR.  ``interior_qr`` (default: ``qr_method``) is used for
    every orthonormalization except the final one; ``'none'`` only
    column-normalizes.  A sharded A (the module docstring) takes Q
    row-sharded alike, or whole on every rank (each rank keeps its
    rows), and gives it back row-sharded; an entry-split sparse A
    gathers a row-sharded Q and gives it back whole."""
    api = _at_api(a, q_mat)
    a, q_mat = _sharded_view(a), _sharded_view(q_mat)
    if isinstance(a, Sharded) and not a.transposed \
            and not isinstance(q_mat, Sharded):
        q_mat = a.with_local(_row_block(a, q_mat))
    if isinstance(a, EntrySplit):
        q_mat, api = _whole(q_mat), False       # replicated, as JAX's
    q_mat = _power_rounds(a, q_mat, q, qr_method, precision, reorth,
                          interior_qr)
    return _to_api(q_mat) if api else q_mat


def _power_rounds(a, q_mat, q, qr_method, precision, reorth, interior_qr):
    inner = qr_method if interior_qr is None else interior_qr
    for i in range(q):
        with span("power"):
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
    """Stage A: range finder with q power-iteration refinements.  A
    sharded A (the module docstring) with Omega whole on every rank gives
    Q row-sharded."""
    api = _at_api(a)
    q_mat = _range_finder(_sharded_view(a), omega, q, qr_method, precision,
                          reorth, interior_qr)
    return _to_api(q_mat) if api else q_mat


def _sketch(a, omega, inner, precision):
    """The first basis, of Y = A Omega, under the ``rsvd/sketch`` span;
    ``omega`` is the test matrix or a function that draws it (timed in
    the span)."""
    with span("sketch"):
        if callable(omega):
            omega = omega()
        return _interior_basis(_mm(a, omega, precision), inner)


def _range_finder(a, omega, q, qr_method, precision, reorth, interior_qr):
    inner = qr_method if interior_qr is None or q == 0 else interior_qr
    q_mat = _sketch(a, omega, inner, precision)
    return _power_rounds(a, q_mat, q, qr_method, precision, reorth,
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
    storage mode, quantized to :class:`Int8Stored` for 'int8', held as
    :class:`Bf16OnFirstUse` where 'default' products would round it to
    bf16 in each pass (an f32 CUDA tensor), else A.  An
    :class:`Int8Stored` is read as it is under any precision; a sparse
    operand becomes a :class:`SparseStored`, neither cast nor quantized
    (JAX driver.py:333-343).  A row-split operand is cast, quantized or
    held block by block (the scales are per row)."""
    if isinstance(a, Sharded) and not isinstance(a.local, Int8Stored):
        if precision in STORAGE_INT8:
            if a.cols is not None:
                raise ValueError("int8 storage takes a row-sharded operand")
            return Sharded(quantize_int8_rows(a.local), a.shape, a.mesh,
                           a.rows)
        if precision in STORAGE_BF16 and a.dtype.itemsize > 2:
            return a.to(torch.bfloat16)
        if _rounded_each_pass(a.local, precision):
            return a.with_block(Bf16OnFirstUse(a.local))
        return a
    if isinstance(a, (Int8Stored, Sharded, EntrySplit, Bf16OnFirstUse)):
        return a
    if is_sparse(a):
        return sparse_operand(a)
    if precision in STORAGE_BF16 and a.dtype.itemsize > 2:
        return a.to(torch.bfloat16)
    if precision in STORAGE_INT8:
        return quantize_int8_rows(a)
    if _rounded_each_pass(a, precision):
        return Bf16OnFirstUse(a)
    return a


def _rounded_each_pass(a, precision) -> bool:
    """Whether each 'default' product would round ``a`` to bf16: the
    condition of ``matmul_at``'s cast, an f32 CUDA tensor at 'default'
    (the storage modes are staged before this is asked)."""
    return (str(precision).lower() == "default"
            and isinstance(a, torch.Tensor) and a.is_cuda
            and a.dtype == torch.float32)


def _release(a_stage):
    """Drop a :class:`Bf16OnFirstUse` copy once the call's last pass over
    A has run."""
    stage = _local(a_stage)
    if isinstance(stage, Bf16OnFirstUse):
        stage.release()


def _sorted_by_weight(u, s, v):
    order = torch.argsort(-s, stable=True)    # weights are near-sorted
    return _cols(u, order), s[order], v[:, order]


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
    the default 'jacobi' is the JAX signature's.

    ``a`` may be sharded (the module docstring), Omega the same tensor on
    every rank: U is then a row-sharded DTensor, s and V replicated
    tensors.

    ``omega`` may also be a function of no arguments that returns it
    (``rsvd`` passes its draw so): it is then drawn inside the
    ``rsvd/sketch`` span (``core/profiling.py``)."""
    with call_span():
        return _factor(a, omega, q, k, method, qr_method, precision, reorth,
                       interior_qr, finish)


def _factor(a, omega, q, k, method, qr_method, precision, reorth,
            interior_qr, finish):
    """:func:`rsvd_with_omega`'s pipeline, each stage under its span.  The
    finish's small products (U = Q U~, the UTV fold) are no stage-A
    products: they go to :func:`_product` directly."""
    _check_options(method, precision, finish)
    a = _sharded_view(a)
    with span("stage"):
        a_stage = _stage_operand(a, precision)
    rowspace = finish in ("rowspace", "rowspace_utv")
    if rowspace:
        if q < 1:
            raise ValueError(f"finish={finish!r} needs q >= 1 (its final "
                             "half-round IS a power iteration)")
        inner = qr_method if interior_qr is None else interior_qr
        q_mat = _sketch(a_stage, omega, inner, precision)
        # q-1 full rounds, every basis interior (the tail re-orthonormalizes)
        q_mat = power_refine(a_stage, q_mat, q - 1, inner, precision, reorth,
                             interior_qr)
    else:
        q_mat = _range_finder(a_stage, omega, q, qr_method, precision,
                              reorth, interior_qr)            # m x l
    with span("finish"):
        if rowspace:
            z = _mm(a_stage.T, q_mat, precision)        # n x l co-range
            z_q = orthonormal_basis(z, qr_method)       # final (full) QR
            c = _mm(a_stage, z_q, precision)            # m x l: LAST pass
            _release(a_stage)
            if finish == "rowspace_utv":
                q_c, t = qr_reduced(c, qr_method)
                s, safe = _fold_weights(t)
                u, s, v = _sorted_by_weight(
                    _product(q_c, t / safe[None, :]), s, z_q)
            else:
                u_t, s, v_small = small_svd(c.T, method)  # c = v_small s u_t^T
                u, v = v_small, _product(z_q, u_t)
        else:
            b = _mm(q_mat.T, a_stage, precision)        # l x n: LAST pass
            _release(a_stage)
            if finish == "utv":
                v, r = qr_reduced(b.T, qr_method)       # B^T = V R
                el = r.T                                # B = L V^T
                s, safe = _fold_weights(el)
                u, s, v = _sorted_by_weight(
                    _product(q_mat, el / safe[None, :]), s, v)
            else:
                u_t, s, v = small_svd(b, method)
                u = _product(q_mat, u_t)
        if k > 0:
            u, s, v = _cols(u, slice(None, k)), s[:k], v[:, :k]
        if isinstance(u, Sharded):
            u = u.to_dtensor()
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
    :class:`Int8Stored` operand raises ``TypeError``; so does a sharded
    one."""
    a = _sharded_view(a)
    m, n = a.shape
    l = min(k + p if k > 0 else p, min(m, n))
    if sketch == "fused":
        if finish != "project":
            raise ValueError("sketch='fused' (a documented negative-"
                             "result experiment) only supports "
                             "finish='project'")
        if is_sparse(a) or isinstance(a, Sharded):
            raise TypeError("sketch='fused' reads a dense single-card "
                            "operand (kernel K4); use sketch='gaussian'")
        _check_options(method, precision, finish)
        with span("sketch"):
            y = kernels.fused_sketch_matmul(a, l, seed)
            inner = qr_method if interior_qr is None or q == 0 \
                else interior_qr
            q_mat = _interior_basis(y, inner)
        q_mat = power_refine(a, q_mat, q, qr_method, precision, reorth,
                             interior_qr)
        with span("finish"):
            b = _mm(q_mat.T, a, precision)
            u_t, s, v = small_svd(b, method)
            u = _product(q_mat, u_t)
            if k > 0:
                u, s, v = u[:, :k], s[:k], v[:, :k]
        return u, s, v
    # Omega is drawn in the sketch's span
    return rsvd_with_omega(
        a, lambda: generate_omega(seed, n, l, a.dtype, sketch,
                                  device=a.device),
        q, k, method, qr_method, precision, reorth, interior_qr, finish)


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
    """Randomized truncated SVD of a real tensor (dense or sparse) or an
    :class:`Int8Stored` operand: (U, s, V).

    k: target rank (0 = all l = p components); p: oversampling; q: power
    iterations; method: small-SVD engine for the l x n tail; precision:
    'highest' (IEEE fp32 GEMMs), 'default' (bf16 operands, f32
    accumulation on CUDA), 'bf16' ('default' numerics with A cast once to
    bf16) or 'int8' (row-scaled int8 storage; pre-quantize with
    :func:`quantize_int8_rows` when factoring the same A repeatedly);
    sketch: 'gaussian', 'rademacher' or 'fused' (kernel K4, see
    :func:`rsvd_core`).  A tensor stays on its device (a sparse one as
    :class:`SparseStored`), a sharded one (a DTensor) where it lies;
    any other array goes to the card."""
    method = SVDMethod.parse(method)
    a = _sharded_view(_as_operand(a))
    if a.dtype.is_complex:
        raise TypeError("rsvd supports real dtypes only (the Gram/"
                        "projection chain uses plain transposes)")
    with call_span():
        return rsvd_core(a, seed, k=k, p=p, q=q, method=method.value,
                         sketch=sketch, qr_method=qr_method,
                         precision=precision, reorth=reorth,
                         interior_qr=interior_qr, finish=finish)


def reconstruct(u, s, v):
    """A_k = U diag(s) V^T; a row-sharded U gives A_k row-sharded."""
    api = _at_api(u)
    u = _sharded_view(u)
    a_k = _mm(_like(u, _local(u) * s[None, :]), v.T)
    return _to_api(a_k) if api else a_k


def reconstruction_error(a, u, s, v):
    """||A - U diag(s) V^T||_F.  A row-sharded A takes U row-sharded
    alike or whole; the squares are summed by rank and combined
    (``rsvd/_sharded.py::_norm``)."""
    a, u = _sharded_view(a), _sharded_view(u)
    if not isinstance(a, Sharded) and not isinstance(u, Sharded):
        return torch.linalg.norm(a - reconstruct(u, s, v))
    x = a if isinstance(a, Sharded) else u
    a_k = _local(reconstruct(x.with_local(_row_block(x, u)), s, v))
    return _norm(x.with_local(_row_block(x, a) - a_k))


def rsvd_sharded(a, mesh, k: int = 0, row_axis="rows", **kwargs):
    """``rsvd`` on a device mesh with ragged rows held for the caller.

    The reference balanced non-dividing row counts with its
    rows_per_proc/rows_remainder idiom (src/PM.cpp:31-35).  Here zero rows
    are appended once so that dim 0 divides the ``row_axis`` ranks, the
    padded matrix is row-sharded, and the zero rows' factor rows are
    cropped from U: exact, because rsvd([A; 0]) = ([U; 0], s, V).  ``a``
    is the full matrix on every rank (a tensor, or an array, which goes
    to the card), or a pre-quantized :class:`Int8Stored`, whose int8
    values pad with zero rows and row scales with ones (both exact).

    Accepts every ``rsvd`` keyword.  Returns (U, s, V): U a DTensor
    row-sharded over ``row_axis`` whose ``full_tensor()`` is the m x k U
    of the single-card call; its ragged rows are held as DTensor holds an
    uneven split (``torch.chunk``'s: ceil(m / P) rows a rank, the last
    ranks fewer, or none).  s and V are replicated tensors."""
    if isinstance(a, Int8Stored):
        if a.transposed:
            raise ValueError("rsvd_sharded shards ROWS: pass the "
                             "untransposed Int8Stored")
        q_pad, rows = pad_rows_for_mesh(a.q8, mesh, row_axis)
        scale = torch.cat([a.row_scale, a.row_scale.new_ones(
            q_pad.shape[0] - rows)])
        ax = mesh_axis(mesh, row_axis)
        step = q_pad.shape[0] // ax.size
        part = slice(ax.index * step, (ax.index + 1) * step)
        a_sh = Sharded(Int8Stored(q_pad[part], scale[part]), q_pad.shape,
                       mesh, ax)
        kwargs.setdefault("precision", "int8")
    else:
        a_pad, rows = pad_rows_for_mesh(_as_operand(a), mesh, row_axis)
        a_sh = shard_rows(a_pad, mesh, row_axis)
    u, s, v = rsvd(a_sh, k=k, **kwargs)
    return from_dtensor(u).to_dtensor(rows), s, v


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
        return _like(y, _local(y) - _local(_mm(q_prev, _mm(q_prev.T, y))))

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
    :func:`_predict_rank`.  A sparse A stays sparse throughout: its
    duplicate entries are summed first (:func:`sparse_operand`), so
    ||A||_F^2 is the sum of its stored values' squares.  A DTensor
    whose rows are sharded runs on its blocks: ||A||_F^2 and the
    products are all-reduced, every block's Omega is drawn whole, U comes
    back row-sharded.  An entry-split sparse A sums its runs' squares
    and products over the ranks; U comes back whole."""
    a = _sharded_view(_as_operand(a))
    if isinstance(_local(a), Int8Stored):
        raise TypeError("rsvd_adaptive takes a dense or sparse tensor")
    vals = a.values() if isinstance(a, (SparseStored, EntrySplit)) \
        else _local(a)
    a_norm_sq = float(_reduce(torch.sum(torch.square(vals)), a))
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
            out = (_to_api(_cols(u, slice(None, k))), s[:k], v[:, :k], k)
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
        q_mat = _cat_cols([q_mat, q_blk])
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
    one byte per element.  Returns (U, s, V) truncated to k.

    A DTensor whose rows are sharded (or an :class:`Int8Stored` of
    row-sharded DTensors) is read block by block: Omega and Psi are drawn
    whole, Psi^T A is the local rows' product all-reduced, the small
    factors are replicated and U comes back row-sharded.  An entry-split
    sparse A all-reduces both sketches' products; U comes back whole."""
    a = _sharded_view(_as_operand(a))
    resolve_precision(precision)
    m, n = a.shape
    dtype = a.dtype
    l = min(k + p, min(m, n))
    s_cols = min(s_factor * l + 1, m)
    a_stage = a
    if isinstance(a, Sharded) and precision in STORAGE_INT8 \
            and not isinstance(a.local, Int8Stored):
        a_stage = Sharded(quantize_int8_rows(a.local), a.shape, a.mesh,
                          a.rows)
    elif precision in STORAGE_INT8 and not isinstance(
            a, (Int8Stored, SparseStored, Sharded, EntrySplit)):
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
    return _to_api(_cols(u, slice(None, k))), sv[:k], v[:, :k]


def rsvd_warm(a, q_prev, k: int = 0, q: int = 1, method: str = "eigh",
              qr_method: str = "robust", precision: str = "highest",
              reorth: str = "full"):
    """rSVD warm-started from an existing range basis: for a sweep of
    slowly varying matrices, power-iterating the previous factorization's
    Q reaches a cold start's accuracy with fewer passes over A.
    ``q_prev`` is any m x l orthonormal(ish) basis, e.g. U from the
    previous step.  Returns (U, s, V) truncated to k (all l when k = 0).

    A DTensor whose rows are sharded takes ``q_prev`` row-sharded alike
    (the U of a previous sharded call) or whole on every rank (each rank
    keeps its rows); U comes back row-sharded.  An entry-split sparse A
    takes ``q_prev`` either way and gives U whole."""
    a = _sharded_view(_as_operand(a))
    resolve_precision(precision)
    q_prev = _sharded_view(q_prev)
    if not isinstance(q_prev, (torch.Tensor, Sharded)):
        q_prev = torch.as_tensor(q_prev, device=a.device)
    if isinstance(a, Sharded) and not isinstance(q_prev, Sharded):
        q_prev = a.with_local(_row_block(a, q_prev))
    if isinstance(a, EntrySplit):
        q_prev = _whole(q_prev)
    q_mat = orthonormal_basis(q_prev, qr_method)
    q_mat = power_refine(a, q_mat, q, qr_method, precision, reorth)
    b = _mm(q_mat.T, a, precision)
    u_t, s, v = small_svd(b, method)
    u = _mm(q_mat, u_t)
    if k > 0:
        u, s, v = _cols(u, slice(None, k)), s[:k], v[:, :k]
    return _to_api(u), s, v


def _batch_split(a_batch):
    """(local stack, the ``Axis`` its batch dim is split over, index of
    its first element) of a stack sharded on its batch dim over the
    mesh's first axis (``Shard(0)`` there, replicated on any other
    axis); (the stack, None, 0) for a tensor."""
    if not is_dtensor(a_batch):
        return _as_operand(a_batch), None, 0
    from torch.distributed.tensor import Replicate, Shard

    mesh, placements = a_batch.device_mesh, tuple(a_batch.placements)
    if not (placements[0] == Shard(0) and all(
            isinstance(pl, Replicate) for pl in placements[1:])):
        raise ValueError("a sharded stack is split on its batch dim over "
                         f"the mesh's first axis, not {placements}")
    axis = mesh_axis(mesh, mesh.mesh_dim_names[0])
    if a_batch.shape[0] % axis.size:
        raise ValueError(f"a batch of {a_batch.shape[0]} does not divide "
                         f"over {axis.size} ranks")
    local = a_batch.to_local()
    return local, axis, axis.index * local.shape[0]


def rsvd_batched(a_batch, k: int, p: int = 10, q: int = 2,
                 method: str = "eigh", seed: int = 0,
                 precision: str = "highest", reorth: str = "full",
                 finish: str = "project", mode: str = "scan"):
    """Batched rSVD of a stacked (b, m, n) operand: element i draws its own
    sketch from ``seed + i`` and runs :func:`rsvd_with_omega`.

    ``mode='scan'`` runs the exact single-matrix pipeline ('robust' QR)
    element after element; ``mode='vmap'`` is one ``torch.func.vmap``
    program over the stack and the stacked Omegas, with the JAX package's
    vmap-safe 'cholqr2' QR (a ``lax.cond`` under vmap would run both
    branches).  ``method='eigh_pallas'`` launches kernel K3 once an
    element in either mode.

    A DTensor stack sharded on its batch dim over the mesh's first axis
    (the image tile path's embarrassing parallelism) runs each rank's
    elements with their global seeds, so every Omega is the one-card
    call's, and issues no collective; U, s and V come back as DTensors
    sharded the same way, as the JAX package's outputs stay partitioned.

    Returns (U, s, V) with shapes (b, m, k), (b, k), (b, n, k)."""
    if mode not in ("scan", "vmap"):
        raise ValueError(f"unknown mode {mode!r} (use 'scan' or 'vmap')")
    local, axis, first = _batch_split(a_batch)
    if local.ndim != 3:
        raise ValueError(f"rsvd_batched takes a (b, m, n) stack, got "
                         f"{tuple(local.shape)}")
    if k <= 0:
        raise ValueError("rsvd_batched needs an explicit k > 0")
    b, m, n = local.shape
    l = min(k + p, min(m, n))
    omegas = [generate_omega(seed + first + i, n, l, local.dtype,
                             device=local.device) for i in range(b)]
    opts = dict(q=q, k=k, method=method, precision=precision, reorth=reorth,
                finish=finish)
    if mode == "scan":
        outs = [rsvd_with_omega(x, om, qr_method="robust", **opts)
                for x, om in zip(local, omegas)]
        out = tuple(torch.stack(parts) for parts in zip(*outs))
    else:
        out = torch.func.vmap(lambda x, om: rsvd_with_omega(
            x, om, qr_method="cholqr2", **opts))(local, torch.stack(omegas))
    if axis is None:
        return out
    return tuple(row_dtensor(t, a_batch.device_mesh, axis, a_batch.shape[0])
                 for t in out)
