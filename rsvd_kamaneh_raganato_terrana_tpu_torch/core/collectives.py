"""Every collective the port issues, counted.

The JAX package's collectives are inserted by XLA's partitioner or
spelled out in ``shard_map`` (``psum``, ``all_gather``,
``psum_scatter``, ``all_to_all``, ``ppermute``); its tests read them
from the compiled HLO.  Here each one is a ``torch.distributed`` call
made through this module, which tallies it by kind: calls, bytes this
rank handed in, and calls staged through host memory (:func:`tally`,
:func:`reset`), and opens the span ``rsvd/collective/<kind>`` around it
(``core/profiling.py``), under which its NCCL kernels lie on the
profiler's timeline: their time is read there, not from a host clock
around an asynchronous call.  The tests and ``chip_smoke.py`` read the
tally where the JAX tests read the HLO.  A one-rank group's
collectives are issued too (NCCL's and gloo's handle one rank), so that
a one-rank run drives the same transport.

The transport follows the group's backend by name: NCCL takes CUDA
tensors; gloo takes CPU tensors and, for the collectives, CUDA tensors
too, but its point-to-point transfers of a CUDA tensor fail (gloo's TCP
pair writes from the device pointer: "writev ... Bad address", and the
group is broken after it; torch 2.11 on an H100 machine).  So with gloo
a CUDA tensor's point-to-point exchange is copied to
pinned host memory, sent from there and copied back: the case of several
ranks sharing one card, where NCCL refuses to run ("Duplicate GPU
detected").  Nothing is chosen by catching an error, and no backend is
ever swapped for another.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.profiling import span

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "send_recv")

_tally = {kind: [0, 0, 0] for kind in KINDS}


def reset() -> None:
    """Zero the tally."""
    for rec in _tally.values():
        rec[:] = [0, 0, 0]


def tally() -> dict:
    """{kind: {calls, bytes, staged}} since the last reset, for every
    kind issued at least once; ``bytes`` counts what this rank handed in
    (the send side of a point-to-point exchange)."""
    return {kind: dict(zip(("calls", "bytes", "staged"), rec))
            for kind, rec in _tally.items() if rec[0]}


class _Record:
    """Adds one collective to the tally when it is done."""

    def __init__(self, kind: str, t: torch.Tensor, staged: bool = False):
        self.rec = _tally[kind]
        self.nbytes = t.numel() * t.element_size()
        self.staged = staged

    def done(self):
        self.rec[0] += 1
        self.rec[1] += self.nbytes
        self.rec[2] += int(self.staged)


def _group(group):
    return dist.group.WORLD if group is None else group


def all_reduce(t: torch.Tensor, group=None, op: str = "sum"):
    """``t`` reduced over ``group`` ('sum', 'max' or 'min'), in place;
    returns it.  A non-contiguous ``t`` (a view with padding cropped) is
    reduced as a contiguous copy, which is returned: the backends reduce
    a tensor's storage as one dense run."""
    with span("collective/all_reduce"):
        t = t.contiguous()
        rec = _Record("all_reduce", t)
        dist.all_reduce(t, op=_OPS[op], group=group)
        rec.done()
    return t


_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_scatter_from = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The blocks of ``group``'s ranks, in rank order, stacked along
    dim 0 (every block of ``t``'s shape)."""
    with span("collective/all_gather"):
        n = dist.get_world_size(group)
        t = t.contiguous()
        rec = _Record("all_gather", t)
        out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
        _gather_into(out, t, group=group)
        rec.done()
    return out


def reduce_scatter(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over ``group``; rank r keeps block r of dim 0."""
    with span("collective/reduce_scatter"):
        n = dist.get_world_size(group)
        t = t.contiguous()
        rec = _Record("reduce_scatter", t)
        out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
        _scatter_from(out, t, group=group)
        rec.done()
    return out


def all_to_all(t: torch.Tensor, group=None, send_rows=None,
               recv_rows=None) -> torch.Tensor:
    """Block r of ``t``'s dim 0 goes to rank r; the received blocks are
    stacked in rank order.  The blocks are even, or ``send_rows[r]`` rows
    go to rank r and ``recv_rows[r]`` come from it (both lists given)."""
    with span("collective/all_to_all"):
        t = t.contiguous()
        rec = _Record("all_to_all", t)
        if send_rows is None:
            out = torch.empty_like(t)
            dist.all_to_all_single(out, t, group=group)
        else:
            out = t.new_empty((sum(recv_rows),) + tuple(t.shape[1:]))
            dist.all_to_all_single(out, t, list(recv_rows),
                                   list(send_rows), group=group)
        rec.done()
    return out


class Exchange:
    """A point-to-point exchange in flight: ``wait()`` returns the
    received tensor, on the device of the tensor sent."""

    def __init__(self, works, recv, device, record):
        self._works, self._recv, self._device = works, recv, device
        self._record = record

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        self._record.done()
        return self._recv.to(self._device)


def exchange(send: torch.Tensor, dst: int, src: int, group=None) -> Exchange:
    """Start sending ``send`` to group rank ``dst`` while receiving a
    tensor of its shape from group rank ``src`` (``batch_isend_irecv``);
    work issued before ``wait()`` overlaps the transfer.  With gloo a
    CUDA tensor goes through pinned host memory (the module docstring).
    On a one-rank group the tensor is its own neighbour: nothing is
    sent."""
    with span("collective/send_recv"):
        return _exchange(send, dst, src, _group(group))


def _exchange(send, dst, src, group):
    if dist.get_world_size(group) == 1:
        return Exchange([], send.clone(), send.device, _Record("send_recv",
                                                               send))
    send, device = send.contiguous(), send.device
    staged = send.is_cuda and dist.get_backend(group) == "gloo"
    record = _Record("send_recv", send, staged)
    if staged:
        host = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        send = host.copy_(send)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst),
                      group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src),
                      group)]
    return Exchange(dist.batch_isend_irecv(ops), recv, device, record)
