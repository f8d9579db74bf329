"""The sharded-operand helpers of the driver and the extensions: the
products, reductions and layouts through which a row-sharded operand
(``core/distributed.py::Sharded``) goes, with every collective counted by
``core/collectives.py``.

A function that takes a sharded operand reads it as its :class:`Sharded`
view (:func:`_row_split`, :func:`_sharded_view`), works on the local
block through these helpers (never DTensor arithmetic), and hands an
m-row result back as a row-sharded DTensor (:func:`_to_api`).  A sparse
operand split by its entries (``core/distributed.py::EntrySplit``)
passes through both as it is: its products (:func:`_entry_mm`) and
reductions (:func:`_reduce`) come back replicated, so every panel of a
call on it is a whole tensor, as JAX's are on such an operand.  On one
rank every helper computes the single-card operation: a reduction of one
partial is that partial, so a one-rank call is the single call to the
bit.

The products (:func:`_sharded_mm`) and the int8 transposed product call
back into ``rsvd/driver.py`` (``_product``, the local product inside the
driver's spanned ``_mm``, and the int8 layouts), which imports this
module.
"""

from __future__ import annotations

import functools

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    cholesky,
    matmul_at,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    EntrySplit,
    Sharded,
    from_dtensor,
    is_dtensor,
    row_view,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver


def _sharded_view(a):
    """A DTensor operand, or an :class:`Int8Stored` of row-sharded
    DTensors, as :class:`Sharded` (``core/distributed.py``); anything else
    (an :class:`EntrySplit` too) as it is."""
    if is_dtensor(a):
        return from_dtensor(a)
    if isinstance(a, driver.Int8Stored) and is_dtensor(a.q8):
        if a.transposed:
            raise ValueError("a sharded Int8Stored is read by rows: pass "
                             "the untransposed operand")
        view = from_dtensor(a.q8, driver.Int8Stored(
            a.q8.to_local(), a.row_scale.to_local()))
        if view.cols is not None:
            raise ValueError("int8 storage takes a row-sharded operand")
        return view
    return a


def _cols(u, idx):
    """Columns ``idx`` of a tensor or a row-split panel."""
    if isinstance(u, Sharded):
        return u.with_local(u.local[:, idx])
    return u[:, idx]


def _int8_t_mm_split(x: Sharded, q):
    """A^T Q for a row-split :class:`Int8Stored` A and Q's local rows:
    ``_int8_mm``'s transposed product with the column scales taken from
    the all-reduced column absmax and the int32 partial products summed
    over the rows, so the integers equal the single-card ones."""
    a8 = x.local
    bs = q * a8.row_scale[:, None].to(q.dtype)
    amax = collectives.all_reduce(
        torch.amax(torch.abs(bs), dim=0, keepdim=True), x.rows.group, "max")
    b8, t = driver._quant_cols(bs, amax)
    z = collectives.all_reduce(
        driver._int8_product(a8.layouts[1], b8)[:a8.q8.shape[1]],
        x.rows.group)
    out_dtype = torch.promote_types(q.dtype, torch.float32)
    return z.to(out_dtype) * t.to(out_dtype)


def _t_mm_split(x: Sharded, y: Sharded, precision):
    """X^T Y for X and Y split by the same rows: the local products
    summed over the rows, then gathered over a column split (A^T Q's rows
    lie over A's columns, Q^T A's columns do); replicated."""
    if isinstance(y.local, driver.Int8Stored):
        return _t_mm_split(y, x, precision).T          # Q^T A = (A^T Q)^T
    if isinstance(x.local, driver.Int8Stored):
        z = _int8_t_mm_split(x, y.local)
    else:
        z = collectives.all_reduce(
            driver._product(x.local.T, y.local, precision), x.rows.group)
    if x.cols is not None:
        z = collectives.all_gather(z, x.cols.group)
    if y.cols is not None:
        z = collectives.all_gather(z.T, y.cols.group).T
    return z


def _entry_mm(a, b, precision):
    """A product with an entry-split sparse operand (:class:`EntrySplit`)
    and a whole one: the local run's product, a forward CSR product as on
    one card, summed over the ranks by one counted all-reduce;
    replicated.  On one rank the run is all of A, and this is the single
    call's product."""
    if isinstance(a, EntrySplit):
        return a.reduce(driver._product(a.local, b, precision))
    return b.reduce(driver._product(a, b.local, precision))


def _sharded_mm(a, b, precision):
    """A product with a row-split operand (:class:`Sharded`), with the
    collectives XLA's partitioner inserts for it:

    - A B (B replicated) is the local rows' product, its partial sums
      all-reduced where A's columns are split, and stays row-split;
    - X^T Y of two row-split operands is :func:`_t_mm_split`
      (replicated), and so is A^T B with B replicated: B's rows are cut
      by A's split first;
    - A B with B row-split too (B's rows are A's columns) gathers B;
    - with a replicated left operand, X A is X's columns cut by A's row
      split, the local products all-reduced (replicated), and X A^T is
      this rank's columns of the product, a transposed row split.  Each
      local product has the one-card product's orientation, so one rank
      computes the one-card call's GEMMs; a column-split or int8 A takes
      the transposes of the rules above."""
    if isinstance(b, Sharded) and not isinstance(a, Sharded):
        if b.cols is not None or isinstance(b.local, driver.Int8Stored):
            return _sharded_mm(b.T, a.T, precision).T
        if b.transposed:
            bt = b.T
            return bt.with_local(
                driver._product(a, bt.local.T, precision).T).T
        cols = slice(b.row_start, b.row_start + b.local.shape[0])
        return collectives.all_reduce(
            driver._product(a[:, cols], b.local, precision), b.rows.group)
    if isinstance(a, Sharded) and a.transposed and not isinstance(b, Sharded):
        at = a.T
        b = at.with_local(_row_block(at, b))
    if isinstance(a, Sharded) and isinstance(b, Sharded) \
            and a.transposed and not b.transposed:
        return _t_mm_split(a.T, b, precision)
    if isinstance(a, Sharded) and isinstance(b, Sharded) \
            and not a.transposed and not b.transposed:
        b = b.gather()
    if not isinstance(a, Sharded) or a.transposed or isinstance(b, Sharded):
        raise TypeError("a sharded product is A B or A^T B with B "
                        "replicated, X^T Y with both split by rows, or "
                        "their transposes")
    if a.cols is not None:
        b = b[a.col_start:a.col_start + a.local.shape[1]]
    y = driver._product(a.local, b, precision)
    if a.cols is not None:
        y = collectives.all_reduce(y, a.cols.group)
    return Sharded(y, (a.shape[0], y.shape[1]), a.mesh, a.rows)


def _local(x):
    """This rank's block of a row-split panel, or ``x`` itself."""
    return x.local if isinstance(x, Sharded) else x


def _like(x, local):
    """``local``, a block of this rank's rows of ``x``, split as ``x`` is
    (a :class:`Sharded` of its width), or ``local`` itself where ``x`` is
    not split."""
    return x.with_local(local) if isinstance(x, Sharded) else local


def _row_block(x, full):
    """The rows of ``full`` (a tensor every rank holds whole, with the
    rows of ``x``) that this rank holds of the row-split ``x``; ``full``
    itself where ``x`` is not split, its local block where ``full`` is a
    row-split panel already."""
    if isinstance(full, Sharded):
        return full.local
    if not isinstance(x, Sharded):
        return full
    return full[x.row_start:x.row_start + x.local.shape[0]]


def _whole(x):
    """A row-split panel gathered whole on every rank (a counted
    all-gather: where XLA's partitioner gathers an operand of an op it
    cannot split), or ``x`` itself."""
    return x.gather() if isinstance(x, Sharded) else x


def _reduce(t, x, op: str = "sum"):
    """``t``, a reduction ('sum', 'max' or 'min') over this rank's rows of
    ``x`` (or its entries, for an :class:`EntrySplit`), completed over x's
    row group by a counted all-reduce where x is split: the
    partitioner's reduction of a row-sharded operand."""
    if isinstance(x, EntrySplit):
        return x.reduce(t, op)
    if isinstance(x, Sharded):
        return collectives.all_reduce(t, x.rows.group, op)
    return t


def _to_api(x):
    """A row-split panel as its row-sharded DTensor (JAX's layout of an
    m-row result), anything else as it is."""
    return x.to_dtensor() if isinstance(x, Sharded) else x


def _row_split(a, device=None, dtype=None):
    """An extension's operand: a DTensor as its :class:`Sharded` view,
    rows split and columns whole; any other operand as a tensor
    (``as_tensor(a, device, dtype)``: an array goes to the card unless
    ``device`` names another); a view, a ``SparseStored`` or an
    :class:`EntrySplit` as it is."""
    if isinstance(a, (EntrySplit, driver.SparseStored)):
        return a
    if isinstance(a, Sharded) or is_dtensor(a):
        return row_view(a)
    return as_tensor(a, device, dtype)


def _cat_cols(parts):
    """Tensors or row-split panels (split alike) side by side."""
    if isinstance(parts[0], Sharded):
        return parts[0].with_local(torch.cat([p.local for p in parts],
                                             dim=1))
    return torch.cat(parts, dim=1)


def _append_rows(x: Sharded, new) -> Sharded:
    """[x; new] of a row-split panel ``x`` and rows ``new`` of its width
    (a panel split by the same rows, or a tensor every rank holds whole),
    split evenly over x's ranks in that global order, as
    ``jnp.concatenate`` of two row-sharded arrays is.  Each rank's rows
    arrive by one counted all-to-all of uneven blocks (rank r sends each
    rank the rows of its blocks that land there; rows held whole are not
    sent, each rank takes its own from its copy).  Nothing is gathered."""
    p, me = x.rows.size, x.rows.index
    m0, m1 = x.shape[0], new.shape[0]
    if (m0 + m1) % p:
        raise ValueError(f"{m0} + {m1} rows do not divide over {p} ranks")
    b = (m0 + m1) // p
    split_new = isinstance(new, Sharded)

    def runs(r):
        """(first global row, row count) of each block rank r sends."""
        return [(r * (m0 // p), m0 // p)] + (
            [(m0 + r * (m1 // p), m1 // p)] if split_new else [])

    def cut(run, dest):
        lo = max(run[0], dest * b)
        return lo, max(lo, min(run[0] + run[1], (dest + 1) * b))

    blocks = [x.local] + ([new.local] if split_new else [])
    parts, send_rows = [], []
    for dest in range(p):
        cuts = [cut(run, dest) for run in runs(me)]
        parts += [blk[lo - run[0]:hi - run[0]]
                  for (lo, hi), run, blk in zip(cuts, runs(me), blocks)]
        send_rows.append(sum(hi - lo for lo, hi in cuts))
    pieces, recv_rows = [], []          # (first global row, rows) received
    for src in range(p):
        cuts = [cut(run, me) for run in runs(src)]
        pieces += [(lo, hi - lo) for lo, hi in cuts if hi > lo]
        recv_rows.append(sum(hi - lo for lo, hi in cuts))
    got = collectives.all_to_all(torch.cat(parts), x.rows.group, send_rows,
                                 recv_rows)
    if pieces != sorted(pieces):        # received by rank, not by row
        chunks = got.split([n for _, n in pieces])
        got = torch.cat([c for _, c in sorted(
            zip((lo for lo, _ in pieces), chunks), key=lambda t: t[0])])
    if not split_new:
        lo = max(me * b - m0, 0)
        got = torch.cat([got, new[lo:max(lo, (me + 1) * b - m0)]])
    return Sharded(got, (m0 + m1, x.shape[1]), x.mesh, x.rows)


def _partials(t, x):
    """This rank's partial result ``t`` of a reduction over the rows of a
    row-split ``x``, beside every other rank's (a counted all-gather of
    the small ``t``): a list in rank order; ``[t]`` where x is not
    split."""
    if not isinstance(x, Sharded):
        return [t]
    return list(collectives.all_gather(t[None], x.rows.group).unbind(0))


def _norm(x, dim=None):
    """``torch.linalg.norm(x, dim=dim)`` of a tensor, or of a row-split
    panel over all its rows: the local norms combined by ``hypot``, so
    one rank's norm is the local norm itself.  ``dim`` None (the whole
    panel) or 0 (each column)."""
    parts = _partials(torch.linalg.norm(_local(x), dim=dim), x)
    return functools.reduce(torch.hypot, parts)


def _merge_moments(a, b, correction: int):
    """Chan, Golub & LeVeque's pairwise merge of (count, mean, variance)
    of two row blocks; the variance's divisor is count - correction."""
    na, ma, va = a
    nb, mb, vb = b
    n = na + nb
    delta = mb - ma
    mean = ma + delta * (nb / n)
    m2 = (va * (na - correction) + vb * (nb - correction)
          + delta * delta * (na * nb / n))
    return n, mean, m2 / (n - correction)


def _mean(x, dim=0):
    """``torch.mean(x, dim)`` of a tensor or of a row-split panel, whose
    rows are reduced over the group (``dim`` 0, or None for every entry):
    the local means merged pairwise by their counts, so one rank's mean
    is the local mean itself."""
    local = _local(x)
    mean = torch.mean(local, dim=dim)
    if not isinstance(x, Sharded):
        return mean
    count = local.shape[0] if dim == 0 else local.numel()
    parts = [(count, m, torch.zeros_like(m)) for m in _partials(mean, x)]
    return functools.reduce(
        lambda a, b: _merge_moments(a, b, 0), parts)[1]


def _spread(x, correction: int = 1, std: bool = False):
    """``torch.var`` (or, with ``std``, ``torch.std``) over the rows of a
    tensor, or of a row-split panel: (count, mean, spread) of each rank's
    rows merged pairwise, so one rank's result is the local one itself."""
    local = _local(x)
    fn = torch.std if std else torch.var
    value = fn(local, dim=0, correction=correction)
    if not isinstance(x, Sharded):
        return value
    stats = _partials(torch.stack([torch.mean(local, dim=0), value]), x)

    def merge(a, b):
        def sq(v):
            return v * v if std else v
        n, mean, var = _merge_moments((a[0], a[1], sq(a[2])),
                                      (b[0], b[1], sq(b[2])), correction)
        return n, mean, torch.sqrt(var) if std else var

    return functools.reduce(
        merge, [(local.shape[0], st[0], st[1]) for st in stats])[2]


def _take_rows(x, idx):
    """Rows ``idx`` (global indices, any order) of a tensor or of a
    row-split panel, replicated: each rank fills the rows it holds into
    zeros and a counted all-reduce completes them."""
    if not isinstance(x, Sharded):
        return x.index_select(0, idx)
    start, rows = x.row_start, x.local.shape[0]
    mine = (idx >= start) & (idx < start + rows)
    out = x.local.new_zeros((idx.shape[0],) + tuple(x.local.shape[1:]))
    out[mine] = x.local.index_select(0, idx[mine] - start)
    return collectives.all_reduce(out, x.rows.group)


def _argmax(t, x):
    """The index of the first largest entry of ``t``, a vector over the
    rows of ``x``: for a row-split x, ``t`` is this rank's entries and
    the index is global (the local argmax, then the ranks' (value, global
    index) pairs summed into place by one counted all-reduce, in f64 so
    that both are exact; the largest value wins, a tie the lower index,
    as ``argmax`` takes the first).  A 0-d int64 tensor; no host sync."""
    j = torch.argmax(t)
    if not isinstance(x, Sharded):
        return j
    pairs = t.new_zeros((x.rows.size, 2), dtype=torch.float64)
    pairs[x.rows.index, 0] = t[j].to(torch.float64)
    pairs[x.rows.index, 1] = (j + x.row_start).to(torch.float64)
    pairs = collectives.all_reduce(pairs, x.rows.group)
    return pairs[torch.argmax(pairs[:, 0]), 1].to(torch.int64)


def _transpose(x):
    """The transpose of a square row-split matrix, row-split the same way
    (a counted all-to-all of its blocks: rank r's rows of X^T are the
    columns of X that fall to rank r); a tensor's ``.T``."""
    if not isinstance(x, Sharded):
        return x.T
    p, b = x.rows.size, x.local.shape[0]
    blocks = x.local.reshape(b, p, b).permute(1, 2, 0).reshape(p * b, b)
    got = collectives.all_to_all(blocks, x.rows.group)
    return x.with_local(got.reshape(p, b, b).permute(1, 0, 2).reshape(b, -1))


def _broadcast_block(t, x, owner: int):
    """``t`` from rank ``owner`` of x's row group on every rank (a counted
    all-reduce of it beside the others' zeros)."""
    if x.rows.index != owner:
        t = torch.zeros_like(t)
    return collectives.all_reduce(t, x.rows.group)


def _cholesky(b):
    """The lower Cholesky factor L of a symmetric positive definite
    tensor, or of a square row-split one, row-split the same way, by a
    right-looking block Cholesky over the ranks' diagonal blocks: rank j
    factors its diagonal block, the ranks below solve for their blocks of
    column j, and the column panel (n x b) is gathered for their Schur
    updates.  A failed block gives NaN (``core/device.py::cholesky``).
    The factor is row-major either way (the solver's own is
    column-major), so the triangular solves see one layout and one rank
    solves as one card does."""
    if not isinstance(b, Sharded):
        return cholesky(b).contiguous()
    p, me, bs = b.rows.size, b.rows.index, b.local.shape[0]
    s = b.local.clone()                     # this rank's Schur rows
    lower = torch.zeros_like(s)
    for j in range(p):
        cols = slice(j * bs, (j + 1) * bs)
        d = _broadcast_block(cholesky(s[:, cols]) if me == j
                             else s[:, cols], b, j)
        if me == j:
            lower[:, cols] = d
        elif me > j:
            lower[:, cols] = torch.linalg.solve_triangular(
                d.T, s[:, cols], upper=True, left=False)
        if j == p - 1:
            break
        panel = collectives.all_gather(
            lower[:, cols] if me > j else torch.zeros_like(d),
            b.rows.group)
        if me > j:
            rest = slice((j + 1) * bs, None)
            s[:, rest] -= matmul_at(lower[:, cols], panel[rest].T,
                                    "highest")
    return b.with_local(lower)


def _solve_lower(lower, x):
    """L^{-1} x for the lower factor of :func:`_cholesky`; for a row-split
    L, ``x`` and the result are this rank's rows (block forward
    substitution, each solved block broadcast to the ranks below)."""
    if not isinstance(lower, Sharded):
        return torch.linalg.solve_triangular(lower, x, upper=False)
    p, me, bs = lower.rows.size, lower.rows.index, lower.local.shape[0]
    acc = torch.zeros_like(x)               # sum_{j < me} L_me,j y_j
    mine = None
    for j in range(p):
        cols = slice(j * bs, (j + 1) * bs)
        if me == j:
            mine = torch.linalg.solve_triangular(lower.local[:, cols],
                                                 x - acc, upper=False)
        if j == p - 1:
            break
        y = _broadcast_block(mine if me == j else x, lower, j)
        if me > j:
            acc = acc + matmul_at(lower.local[:, cols], y, "highest")
    return mine


def _solve_upper_t(lower, x):
    """L^{-T} x for the lower factor of :func:`_cholesky`; for a row-split
    L, ``x`` and the result are this rank's rows (block back
    substitution, the last rank first, each solved block's products
    with the blocks of L^T above it all-reduced)."""
    if not isinstance(lower, Sharded):
        return torch.linalg.solve_triangular(lower.T, x, upper=True)
    p, me, bs = lower.rows.size, lower.rows.index, lower.local.shape[0]
    acc = torch.zeros_like(x)               # sum_{i > me} L_i,me^T y_i
    mine = None
    for j in reversed(range(p)):
        cols = slice(j * bs, (j + 1) * bs)
        if me == j:
            mine = torch.linalg.solve_triangular(lower.local[:, cols].T,
                                                 x - acc, upper=True)
        if j == 0:
            break
        above = slice(0, j * bs)
        part = (matmul_at(lower.local[:, above].T, mine, "highest")
                if me == j else x.new_zeros((j * bs,) + tuple(x.shape[1:])))
        part = collectives.all_reduce(part, lower.rows.group)
        if me < j:
            acc = acc + part[me * bs:(me + 1) * bs]
    return mine
