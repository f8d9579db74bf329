"""Device meshes and sharded operands (the JAX package's ``core/mesh.py``).

The counterpart of ``jax.sharding.Mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group (one rank a card), with the JAX axis names: a 1-D
``('rows',)`` mesh for the row partition of the reference's MPI code,
``('rows', 'cols')`` for both matrix dimensions and ``('bx', 'by')`` for
independent tiles.  The counterpart of a ``NamedSharding`` is a
placement tuple (``Shard``/``Replicate``, one per mesh dimension), and a
sharded array is a ``torch.distributed.tensor.DTensor``.

Placing a tensor (:func:`shard_rows`, :func:`replicate`) takes the
rank's block of a tensor every rank holds in full, as ``jax.device_put``
of a host array does: no communication.  A mesh's device type is the
caller's device, the card unless the caller asks for the CPU.
``torch.distributed``'s mesh and DTensor modules are imported where
they are used, so that importing the package stays as quick as it was.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

ROWS_AXIS = "rows"
COLS_AXIS = "cols"
TILE_AXES = ("bx", "by")


def _device_type(device) -> str:
    return torch.device(device or "cuda").type


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (ROWS_AXIS,),
              device=None) -> DeviceMesh:
    """A device mesh over every rank of the process group.

    With no arguments, a 1-D mesh named ``rows`` over the world: the
    reference's ``MPI_COMM_WORLD`` row partition.  ``device`` is the
    ranks' device type (the card, ``"cuda"``, unless named)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover "
                         f"{world} ranks")
    return init_device_mesh(_device_type(device), tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_tile_mesh(device=None) -> DeviceMesh:
    """2-D ``('bx', 'by')`` mesh for independent tiles: square when the
    rank count is, else P x 1 (where the reference aborted)."""
    n = dist.get_world_size()
    side = math.isqrt(n)
    return make_mesh((side, side) if side * side == n else (n, 1),
                     TILE_AXES, device)


def _axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _placements(mesh: DeviceMesh, axis, dim: int) -> tuple:
    """``Shard(dim)`` on the mesh dimensions named by ``axis`` (a name or
    a tuple of names), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    axes = _axes(axis)
    unknown = set(axes) - set(mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"mesh has no axis {sorted(unknown)} "
                         f"(axes {mesh.mesh_dim_names})")
    return tuple(Shard(dim) if name in axes else Replicate()
                 for name in mesh.mesh_dim_names)


def row_sharding(mesh: DeviceMesh, axis=ROWS_AXIS) -> tuple:
    """Placements that block-partition dim 0 over ``axis``."""
    return _placements(mesh, axis, 0)


def col_sharding(mesh: DeviceMesh, axis=ROWS_AXIS) -> tuple:
    """Placements that block-partition dim 1 over ``axis``."""
    return _placements(mesh, axis, 1)


def replicated(mesh: DeviceMesh) -> tuple:
    """Every mesh dimension replicated (the reference's post-Bcast
    state)."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def axis_size(mesh: DeviceMesh, axis) -> int:
    """Ranks along ``axis`` (a name or a tuple of names)."""
    axes = _axes(axis)
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)


def distribute(x: torch.Tensor, mesh: DeviceMesh, placements) -> DTensor:
    """A DTensor of ``x`` (the full tensor, the same on every rank) with
    ``placements``: each rank keeps its own block, nothing is sent.
    Every sharded dimension must divide its ranks."""
    from torch.distributed.tensor import DTensor, Shard

    local = x
    for mesh_dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            parts = mesh.size(mesh_dim)
            size = local.shape[pl.dim]
            if size % parts:
                raise ValueError(
                    f"dim {pl.dim} of size {x.shape[pl.dim]} does not "
                    f"divide over {parts} ranks")
            step = size // parts
            local = local.narrow(pl.dim, mesh.get_local_rank(mesh_dim) * step,
                                 step)
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def shard_rows(x, mesh: DeviceMesh, axis=ROWS_AXIS) -> DTensor:
    """``x`` row-sharded over ``axis`` as a DTensor.  The row count must
    divide the axis' ranks (the JAX contract); zero-pad remainder shapes
    first with :func:`pad_rows_for_mesh` and crop the results.

    A torch sparse tensor (any layout) is placed as JAX places a BCOO
    given the row sharding: split by its stored entries
    (``core/distributed.py::shard_entries``), any nse."""
    if isinstance(x, torch.Tensor) and x.layout != torch.strided:
        from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
            shard_entries,
        )

        return shard_entries(x, mesh, axis)
    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"rows={x.shape[0]} not divisible by {n} ranks on "
                         f"axis {axis!r}; use pad_rows_for_mesh(x, mesh) "
                         "first")
    return distribute(torch.as_tensor(x), mesh, row_sharding(mesh, axis))


def pad_rows_for_mesh(x, mesh: DeviceMesh, axis=ROWS_AXIS):
    """Zero-pad dim 0 up to a multiple of the axis' rank count.  Returns
    (padded, original_rows)."""
    rows = x.shape[0]
    pad = (-rows) % axis_size(mesh, axis)
    if pad == 0:
        return x, rows
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]), rows


def replicate(x, mesh: DeviceMesh) -> DTensor:
    """``x`` replicated over the mesh."""
    return distribute(torch.as_tensor(x), mesh, replicated(mesh))


def local_mesh_or_none(device=None) -> Optional[DeviceMesh]:
    """A 1-D mesh over the process group, or None on one rank (or with
    no process group)."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return None
    return make_mesh(device=device)
