"""The process group, pod meshes and the sharded operand (the JAX
package's ``core/distributed.py``, and what the port uses in place of
XLA's partitioner).

- :func:`initialize` wraps ``torch.distributed.init_process_group``, one
  call per process (one process a card), the counterpart of
  ``jax.distributed.initialize``.
- :func:`make_pod_mesh` is the 2-D ``('dcn_rows', 'rows')`` mesh with the
  inner axis inside one host (torchrun numbers ranks host by host), so a
  row sharding over both axes keeps the heavy collectives on the host's
  own links and sends only the small ones between hosts.
- :class:`Sharded` is the driver's view of a sharded operand or panel:
  this rank's block and the groups its rows and columns are split over.
  A ``DTensor`` is the sharded operand's type at the API
  (:func:`from_dtensor`, :meth:`Sharded.to_dtensor`); inside, the
  driver works on the local block and spells its collectives out
  (``core/collectives.py``), as the JAX ``*_sharded`` variants do:
  DTensor's op dispatch has no rules for Cholesky, eigh or the
  triangular solve, and cannot carry the hand-written kernels.
- :class:`EntrySplit` is a sparse operand whose stored entries are split
  over the ranks (:func:`shard_entries`), JAX's BCOO placed with the row
  sharding; DTensor holds no sparse tensor.

One process and no launcher: the same API with nothing to do.
"""

from __future__ import annotations

import functools
import os
import sys
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import matmul_at
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.mesh import (
    ROWS_AXIS,
    make_mesh,
)

DCN_AXIS = "dcn_rows"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Start the process group of this process.

    ``coordinator_address`` is ``host:port``; without it torchrun's
    ``MASTER_ADDR``/``MASTER_PORT`` are read, and ``WORLD_SIZE``/``RANK``
    stand in for ``num_processes``/``process_id``.  With neither
    arguments nor those variables this does nothing (one process), and a
    group that is already up is left as it is.  ``backend`` defaults to
    'nccl' where a card is visible, else 'gloo'.  NCCL takes one card a
    rank: the rank's card is ``LOCAL_RANK`` (else the process id) modulo
    the visible cards, and more NCCL ranks on one host than cards raise.
    Ranks that share a card run 'gloo', which the caller names."""
    env = os.environ
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in env:
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if addr is None and num_processes is None:
        return                                   # one process
    if dist.is_initialized():
        return                                   # a launcher started it
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    num_processes = 1 if num_processes is None else num_processes
    process_id = 0 if process_id is None else process_id
    kwargs = {}
    if backend == "nccl":
        local = int(env.get("LOCAL_WORLD_SIZE", num_processes))
        cards = torch.cuda.device_count()
        if local > cards:
            raise RuntimeError(
                f"NCCL takes one card a rank: {local} ranks on this host, "
                f"{cards} card(s); ranks that share a card need "
                "backend='gloo'")
        card = torch.device(
            "cuda", int(env.get("LOCAL_RANK", process_id)) % cards)
        torch.cuda.set_device(card)
        kwargs["device_id"] = card
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=num_processes, rank=process_id,
                            **kwargs)


def make_pod_mesh(ici_axis: str = ROWS_AXIS, dcn_axis: str = DCN_AXIS,
                  device=None) -> DeviceMesh:
    """Hybrid (hosts x ranks a host) mesh over every rank.  The hosts are
    ``WORLD_SIZE / LOCAL_WORLD_SIZE`` (torchrun sets both; one host when
    ``LOCAL_WORLD_SIZE`` is unset); on one host this is the plain 1-D
    :func:`make_mesh`.  Shard rows over both axes (:func:`row_spec_for`)
    to keep the bandwidth-heavy collectives inside a host."""
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{per_host}")
    hosts = world // per_host
    if hosts <= 1:
        return make_mesh(axis_names=(ici_axis,), device=device)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device or "cuda").type,
                            (hosts, per_host),
                            mesh_dim_names=(dcn_axis, ici_axis))


def row_spec_for(mesh: DeviceMesh) -> tuple:
    """Placements sharding matrix rows over every axis of ``mesh`` (the
    outer axis first), for the 1-D and the hybrid mesh alike."""
    from torch.distributed.tensor import Shard

    return tuple(Shard(0) for _ in mesh.mesh_dim_names)


class Axis(NamedTuple):
    """How one matrix dimension is split: over ``group``'s ``size``
    ranks, this rank holding block ``index``; ``dims`` are the mesh
    dimensions it spans."""

    group: object
    index: int
    size: int
    dims: tuple


def _group(mesh: DeviceMesh, dims: tuple):
    """The process group over mesh dimensions ``dims``: one dimension's,
    or the whole group where ``dims`` are every dimension of a mesh that
    numbers the ranks in order."""
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    ranks = mesh.mesh.flatten().tolist()
    if tuple(dims) == tuple(range(mesh.ndim)) \
            and ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    raise ValueError("a matrix dimension is split over one mesh axis or "
                     f"over all of them, not over mesh dims {dims}")


def mesh_axis(mesh: DeviceMesh, axis) -> Axis:
    """The :class:`Axis` of a row or column split over ``axis`` (a name
    or a tuple of names, the outer one first)."""
    names = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    dims = tuple(mesh.mesh_dim_names.index(a) for a in names)
    index, size = 0, 1
    for d in dims:
        index = index * mesh.size(d) + mesh.get_local_rank(d)
        size *= mesh.size(d)
    return Axis(_group(mesh, dims), index, size, dims)


class Sharded:
    """A matrix (or a tensor, by its first dimension) split over a mesh:
    ``local`` is this rank's block of the ``shape`` matrix, its rows
    split over the ``rows`` :class:`Axis` and,
    for a 2-D split, its columns over ``cols`` (None: every rank holds
    all columns).  ``local`` is a tensor, an ``Int8Stored`` block or a
    ``Bf16OnFirstUse`` one.
    ``.T`` flips a flag and moves nothing, as ``Int8Stored.T`` does; the
    driver's ``_mm`` dispatches on it.  ``start`` gives this rank's first
    row where the blocks are not even (rows appended to the last rank's
    block, as the augmented rows of a damped least-squares operand);
    by default the blocks are even."""

    def __init__(self, local, shape, mesh: DeviceMesh, rows: Axis,
                 cols: Optional[Axis] = None, transposed: bool = False,
                 start: Optional[int] = None):
        self.local, self.mesh = local, mesh
        self.rows, self.cols = rows, cols
        self._shape = tuple(shape)
        self.transposed = transposed
        self._start = start

    @property
    def T(self):
        return Sharded(self.local, self._shape, self.mesh, self.rows,
                       self.cols, not self.transposed, self._start)

    @property
    def shape(self):
        return self._shape[::-1] if self.transposed else self._shape

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    @property
    def row_start(self) -> int:
        if self._start is not None:
            return self._start
        return self.rows.index * (self._shape[0] // self.rows.size)

    @property
    def col_start(self) -> int:
        if self.cols is None:
            return 0
        return self.cols.index * (self._shape[1] // self.cols.size)

    def with_local(self, local) -> "Sharded":
        """The same row split holding ``local`` (a row block of another
        width, never column-split)."""
        return Sharded(local, (self._shape[0], local.shape[1]), self.mesh,
                       self.rows, start=self._start)

    def with_block(self, local) -> "Sharded":
        """The same split and orientation holding ``local``, another
        form of this rank's block (a cast or staged copy of it)."""
        return Sharded(local, self._shape, self.mesh, self.rows, self.cols,
                       self.transposed, self._start)

    def to(self, dtype) -> "Sharded":
        return self.with_block(self.local.to(dtype))

    def gram(self) -> torch.Tensor:
        """A^T A of a row-split panel: the local Gram at full precision,
        summed over the row group (replicated)."""
        return collectives.all_reduce(
            matmul_at(self.local.T, self.local, "highest"), self.rows.group)

    def col_sumsq(self) -> torch.Tensor:
        """Sum of squares of each column of a row-split panel, in at
        least f32 (replicated)."""
        acc = torch.promote_types(self.local.dtype, torch.float32)
        return collectives.all_reduce(
            torch.sum(torch.square(self.local.to(acc)), dim=0),
            self.rows.group)

    def gather(self) -> torch.Tensor:
        """The whole row-split panel on every rank (an all-gather)."""
        return collectives.all_gather(self.local, self.rows.group)

    def keep_rows(self, full: torch.Tensor) -> "Sharded":
        """This rank's rows of a replicated ``full`` panel."""
        rows = self._shape[0] // self.rows.size
        return self.with_local(full[self.row_start:self.row_start + rows])

    def to_dtensor(self, rows: Optional[int] = None) -> "DTensor":
        """The row-split panel as a DTensor (rows sharded, every other
        mesh dimension replicated).  ``rows`` crops zero-padded rows from
        the end: each rank keeps its rows below ``rows``, which is
        ``torch.chunk``'s uneven split, DTensor's own."""
        local, m = self.local, self._shape[0]
        if rows is not None and rows < m:
            keep = max(0, min(local.shape[0], rows - self.row_start))
            local, m = local[:keep], rows
        return row_dtensor(local, self.mesh, self.rows, m)


class EntrySplit:
    """A sparse matrix whose stored entries are split over a mesh axis,
    the counterpart of a BCOO placed by ``jax.device_put(a,
    NamedSharding(mesh, P('rows')))``: JAX applies the placement to the
    BCOO's data and indices, so each device holds a run of the nonzero
    list, not a block of rows.  ``local`` is this rank's run held at A's
    whole m x n shape, as the driver's ``SparseStored`` (the run's CSR
    and its transpose's); ``entries`` is the :class:`Axis` the list is
    split over.  A is the sum of the ranks' runs, so a product with A is
    the local product summed over the axis (one counted all-reduce), and
    replicated, as JAX's is.  ``.T`` swaps the local CSRs and moves
    nothing.  Made by :func:`shard_entries`."""

    def __init__(self, local, mesh: DeviceMesh, entries: Axis):
        self.local, self.mesh, self.entries = local, mesh, entries

    @property
    def T(self):
        return EntrySplit(self.local.T, self.mesh, self.entries)

    @property
    def shape(self):
        return self.local.shape

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    def values(self):
        """This rank's stored entries (duplicates summed)."""
        return self.local.values()

    def reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t``, this rank's part of a sum (or 'max', 'min') over A's
        entries, completed over the axis by a counted all-reduce."""
        return collectives.all_reduce(t, self.entries.group, op)


def shard_entries(a, mesh: DeviceMesh, axis=ROWS_AXIS) -> EntrySplit:
    """A torch sparse tensor (any layout, the same on every rank) split by
    its stored entries over ``axis``: duplicates summed, the row-major
    entry list cut into as many runs of near-equal length as the axis
    has ranks (run r is entries [r nse / P, (r + 1) nse / P)), and this
    rank's run kept as an :class:`EntrySplit`.  Nothing is sent.  Any
    nse is taken; JAX's placement needs nse to divide the devices, a
    rule of ``device_put``, not of the products."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
        sparse_operand,
    )

    ax = mesh_axis(mesh, axis)
    coo = a if a.layout == torch.sparse_coo else a.to_sparse_coo()
    coo = coo.coalesce()
    nse = coo._nnz()
    lo, hi = ax.index * nse // ax.size, (ax.index + 1) * nse // ax.size
    run = torch.sparse_coo_tensor(coo.indices()[:, lo:hi],
                                  coo.values()[lo:hi], coo.shape,
                                  check_invariants=False, is_coalesced=True)
    return EntrySplit(sparse_operand(run), mesh, ax)


def row_dtensor(local: torch.Tensor, mesh: DeviceMesh, rows: Axis,
                m: int) -> "DTensor":
    """The DTensor of an ``m``-row tensor whose rows are split over
    ``rows``, this rank holding ``local`` (every other mesh dimension
    replicated); nothing is sent."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    local = local.contiguous()
    shape = (m,) + tuple(local.shape[1:])
    placements = tuple(Shard(0) if d in rows.dims else Replicate()
                       for d in range(mesh.ndim))
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (never one while the DTensor module is
    not imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def from_dtensor(x: "DTensor", local=None) -> Sharded:
    """The :class:`Sharded` view of a 2-D DTensor whose rows (and
    optionally columns) are sharded, every other mesh dimension
    replicated.  ``local`` replaces the DTensor's local block (an
    ``Int8Stored`` holding it, say)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    row_dims, col_dims = [], []
    for d, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            row_dims.append(d)
        elif isinstance(pl, Shard) and pl.dim == 1:
            col_dims.append(d)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl} of a sharded operand: "
                             "shard its rows or columns, or replicate")
    if not row_dims:
        raise ValueError("the operand's rows must be sharded (placements "
                         f"{x.placements})")
    names = mesh.mesh_dim_names
    rows = mesh_axis(mesh, tuple(names[d] for d in row_dims))
    cols = (mesh_axis(mesh, tuple(names[d] for d in col_dims))
            if col_dims else None)
    for axis, size in ((rows, x.shape[0]),
                       (cols, x.shape[1] if cols else 0)):
        if axis is not None and size % axis.size:
            raise ValueError(f"a dimension of {size} does not divide over "
                             f"{axis.size} ranks")
    return Sharded(x.to_local() if local is None else local,
                   tuple(x.shape), mesh, rows, cols)


def row_view(x):
    """A DTensor whose rows are sharded (columns whole) as its
    :class:`Sharded` view; anything else as it is.  A column split
    raises, and so does a row count that does not divide the ranks."""
    if not is_dtensor(x):
        return x
    view = from_dtensor(x)
    if view.cols is not None:
        raise ValueError("this function takes an operand whose rows are "
                         f"sharded, not its columns (placements "
                         f"{x.placements})")
    return view


def _api_results(x):
    """A result with every :class:`Sharded` in it (tuples walked) as its
    row-sharded DTensor."""
    if isinstance(x, Sharded):
        return x.to_dtensor()
    if isinstance(x, tuple):
        items = [_api_results(v) for v in x]
        return type(x)._make(items) if hasattr(x, "_fields") \
            else tuple(items)
    return x


def row_sharded_api(fn):
    """``fn``, written for :class:`Sharded` views, at the API: where an
    argument is a row-sharded DTensor, every DTensor argument is read as
    its view (:func:`row_view`) and every :class:`Sharded` result goes
    back as its row-sharded DTensor; other calls (internal ones passing
    views among them) go to ``fn`` as they are."""

    @functools.wraps(fn)
    def api(*args, **kwargs):
        if not any(is_dtensor(v) for v in args + tuple(kwargs.values())):
            return fn(*args, **kwargs)
        return _api_results(fn(*(row_view(v) for v in args),
                               **{k: row_view(v)
                                  for k, v in kwargs.items()}))

    return api
