"""A group of P gloo ranks on the CPU for the port's distributed tests.

``RankGroup`` (used by the test files) starts P processes running this
file, each a rank of one ``torch.distributed`` gloo group, and sends
them tasks: the name of a function below and its keyword arguments,
NumPy arrays and plain values.  Every rank runs the task and sends its
result back.  Every wait has its own time limit: on a timeout the group
is killed (the next task starts a new one) and the test fails.

The ranks import torch, NumPy and the PyTorch port only, never JAX.
Run as ``python tests/_torch_ranks.py <address> <authkey> <rank>
<world> <port>`` by ``RankGroup``.
"""

import os
import secrets
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from multiprocessing.connection import Client, Listener

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START_TIMEOUT = 90.0


class RankGroup:
    """P rank processes, started at the first task and after a kill."""

    def __init__(self, world: int = 4):
        self.world = world
        self.procs, self.conns = [], []

    def _start(self):
        key = secrets.token_bytes(16)
        listener = Listener(("127.0.0.1", 0), authkey=key)
        with listener:
            port = _free_port()
            env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1",
                       JAX_PLATFORMS="cpu", TORCH_CPP_LOG_LEVEL="ERROR")
            env.pop("XLA_FLAGS", None)
            for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                         "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
                env.pop(name, None)
            addr = f"{listener.address[0]}:{listener.address[1]}"
            self.procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), addr, key.hex(),
                 str(r), str(self.world), str(port)], env=env)
                for r in range(self.world)]
            conns = {}

            def accept():
                for _ in range(self.world):
                    conn = listener.accept()
                    conns[conn.recv()] = conn

            t = threading.Thread(target=accept, daemon=True)
            t.start()
            t.join(START_TIMEOUT)
            if len(conns) < self.world:
                self.kill()
                raise TimeoutError(f"{len(conns)} of {self.world} ranks "
                                   f"started in {START_TIMEOUT} s")
            self.conns = [conns[r] for r in range(self.world)]

    def run(self, task: str, timeout: float = 60.0, **kwargs):
        """Every rank's result of ``task(**kwargs)``, in rank order."""
        if not self.conns:
            self._start()
        for conn in self.conns:
            conn.send((task, kwargs))
        out = []
        deadline = time.monotonic() + timeout
        for r, conn in enumerate(self.conns):
            if not conn.poll(max(0.0, deadline - time.monotonic())):
                self.kill()
                raise TimeoutError(f"rank {r} gave no result for {task!r} "
                                   f"in {timeout} s; the group was killed")
            status, value = conn.recv()
            if status != "ok":
                self.kill()
                raise AssertionError(f"rank {r} failed {task!r}:\n{value}")
            out.append(value)
        return out

    def kill(self):
        for p in self.procs:
            p.kill()
        for p in self.procs:
            p.wait(timeout=30)
        for c in self.conns:
            c.close()
        self.procs, self.conns = [], []

    def close(self):
        for conn in self.conns:
            conn.send(None)
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for c in self.conns:
            c.close()
        self.procs, self.conns = [], []


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextmanager
def one_rank_group():
    """A one-rank gloo group in this process (world 1), destroyed on
    exit."""
    import torch.distributed as dist

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
        initialize,
    )

    initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend="gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Rank side: tasks.  Each returns NumPy arrays and plain values.
# ---------------------------------------------------------------------------

def _np(t):
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy

    return to_numpy(t)


def _t(x):
    import torch

    return torch.from_numpy(np.array(x))


def _full(x):
    """A DTensor's whole tensor (DTensor's own gather, not counted), or a
    tensor as it is, as NumPy."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
        is_dtensor,
    )

    return _np(x.full_tensor() if is_dtensor(x) else x)


_MESHES = {}


def _mesh(kind: str):
    """The group's mesh of ``kind``: 'rows' (1-D), 'rows_cols' (2 x 2),
    'pod' (``make_pod_mesh``), 'tile' or 'batch' (1-D, named 'batch');
    made once a process."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import mesh as cm
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
        make_pod_mesh,
    )

    key = (kind, os.environ.get("LOCAL_WORLD_SIZE"))
    if key not in _MESHES:
        _MESHES[key] = {
            "rows": lambda: cm.make_mesh(device="cpu"),
            "rows_cols": lambda: cm.make_mesh((2, 2), ("rows", "cols"),
                                              device="cpu"),
            "pod": lambda: make_pod_mesh(device="cpu"),
            "tile": lambda: cm.make_tile_mesh(device="cpu"),
            "batch": lambda: cm.make_mesh(axis_names=("batch",),
                                          device="cpu"),
        }[kind]()
    return _MESHES[key]


@contextmanager
def _omega_patched(omega):
    """``driver.generate_omega`` returning ``omega`` (the JAX draw)."""
    from unittest import mock

    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver

    if omega is None:
        yield
        return
    om = _t(omega)
    with mock.patch.object(driver, "generate_omega",
                           lambda *a, **k: om.clone()):
        yield


@contextmanager
def _draws_patched(draws):
    """Each 'module:name' of ``draws`` (under the package) answering with
    its list of arrays in order, one a call: the JAX draws a test sends
    in place of the port's own."""
    import importlib
    from contextlib import ExitStack
    from unittest import mock

    with ExitStack() as stack:
        for target, values in (draws or {}).items():
            module, name = target.split(":")
            queue = [_t(v) for v in values]
            stack.enter_context(mock.patch.object(
                importlib.import_module(
                    "rsvd_kamaneh_raganato_terrana_tpu_torch." + module),
                name, lambda *a, _q=queue, **k: _q.pop(0)))
        yield


def _placed(a, layout):
    """``a`` (NumPy) as the sharded operand of ``layout``: 'rows' and
    'pod' (rows over every mesh axis), 'rows_cols' (a 2-D split) or
    'int8' (an Int8Stored of row-sharded DTensors)."""
    from torch.distributed.tensor import Shard

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import mesh as cm
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
        row_spec_for,
    )
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
        Int8Stored,
        quantize_int8_rows,
    )

    t = _t(a)
    if layout == "rows":
        return cm.shard_rows(t, _mesh("rows"))
    if layout == "pod":
        mesh = _mesh("pod")
        return cm.distribute(t, mesh, row_spec_for(mesh))
    if layout == "rows_cols":
        return cm.distribute(t, _mesh("rows_cols"), (Shard(0), Shard(1)))
    st = quantize_int8_rows(t)
    mesh = _mesh("rows")
    return Int8Stored(cm.shard_rows(st.q8, mesh),
                      cm.distribute(st.row_scale, mesh,
                                    cm.row_sharding(mesh)))


def task_rsvd(a, layout, call="rsvd_with_omega", omega=None, **kwargs):
    """(U whole, s, V, the tally, U's local rows) of one sharded call:
    ``rsvd_with_omega`` / ``rsvd`` on ``a`` placed by ``layout``, or
    ``rsvd_sharded`` on the whole ``a`` (``layout`` names the mesh)."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver

    collectives.reset()
    with _omega_patched(omega if call != "rsvd_with_omega" else None):
        if call == "rsvd_with_omega":
            u, s, v = driver.rsvd_with_omega(_placed(a, layout), _t(omega),
                                             **kwargs)
        elif call == "rsvd":
            u, s, v = driver.rsvd(_placed(a, layout), **kwargs)
        else:
            operand = _t(a)
            if kwargs.pop("int8", False):
                operand = driver.quantize_int8_rows(operand)
            u, s, v = driver.rsvd_sharded(operand, _mesh(layout), **kwargs)
    tally = collectives.tally()
    return dict(u=_full(u), u_local=_np(u.to_local()), s=_np(s), v=_np(v),
                tally=tally)


def task_spans(a, omega, **kwargs):
    """``rsvd_with_omega`` on ``a`` row-sharded over the 1-D mesh, under a
    CPU profiler with the program's spans off, then on: the count of
    each span name and the tally of each traced call, and whether the
    factors of the two calls are bitwise equal."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import (
        collectives,
        profiling,
    )
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver

    out = {}
    for on in (False, True):
        collectives.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof, \
                profiling.spans(on):
            u, s, v = driver.rsvd_with_omega(_placed(a, "rows"), _t(omega),
                                             **kwargs)
        out[on] = dict(
            factors=(u.to_local(), s, v), tally=collectives.tally(),
            spans=dict(collections.Counter(
                e.name() for e in prof.profiler.kineto_results.events()
                if e.name().startswith(profiling.PREFIX))))
    same = all(torch.equal(x, y) for x, y in zip(out[False]["factors"],
                                                 out[True]["factors"]))
    return dict(same=same, off=out[False]["spans"], on=out[True]["spans"],
                tally=out[True]["tally"], tally_off=out[False]["tally"])


def task_dcp(ckdir, a=None, omega=None, **kwargs):
    """The factor checkpoint on the group: with ``a``, ``rsvd_with_omega``
    of ``a`` row-sharded over the 1-D mesh, saved to ``ckdir`` by
    ``save_factors_dcp`` (each rank its rows of U); then ``ckdir`` loaded
    on the mesh and loaded whole by this rank alone.  The saved U's local
    rows and whole (None without ``a``), and both loads."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import checkpoint
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver

    out = dict(saved_local=None, saved=None)
    if a is not None:
        u, s, v = driver.rsvd_with_omega(_placed(a, "rows"), _t(omega),
                                         **kwargs)
        checkpoint.save_factors_dcp(ckdir, u, s, v,
                                    meta={"k": int(s.shape[0])})
        out.update(saved_local=_np(u.to_local()), saved=_full(u),
                   s=_np(s), v=_np(v))
    u, s, v, meta = checkpoint.load_factors_dcp(ckdir, mesh=_mesh("rows"))
    out["mesh"] = dict(u=_pack(u), s=_np(s), v=_np(v), meta=meta)
    u, s, v, meta = checkpoint.load_factors_dcp(ckdir, device="cpu")
    out["plain"] = dict(u=_np(u), s=_np(s), v=_np(v), meta=meta)
    return out


def _pack(x):
    """A result as NumPy: a DTensor as {"whole", "local", "placements"}
    (its whole tensor by DTensor's own gather, not counted), a tensor as
    an array, a tuple (NamedTuples too) as a list, a dataclass (a POD) as
    a dict of its fields, anything else as it is."""
    import dataclasses

    import torch

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
        is_dtensor,
    )

    if is_dtensor(x):
        return dict(whole=_full(x), local=_np(x.to_local()),
                    placements=[str(p) for p in x.placements])
    if isinstance(x, torch.Tensor):
        return _np(x)
    if isinstance(x, tuple):
        return [_pack(v) for v in x]
    if dataclasses.is_dataclass(x):
        return {f.name: _pack(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x


def _placed_as(x, layout):
    """``x`` (NumPy) placed by ``layout``: 'rows' (dim 0 over the 1-D
    mesh), 'cols' (dim 1 over it), 'batch' (dim 0 over a ('batch',)
    mesh), 'ragged' (dim 0 over the 1-D mesh in DTensor's own uneven
    split), 'sparse' or 'sparse_nse' (a sparse COO tensor split by its
    entries over the 1-D mesh, ``shard_rows``'s placement of a sparse
    tensor) or None (a tensor every rank holds whole; anything but
    an array stays as it is)."""
    from torch.distributed.tensor import Shard

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import mesh as cm

    if layout is None:
        return _t(x) if isinstance(x, np.ndarray) else x
    t = _t(x)
    if layout == "batch":
        return cm.distribute(t, _mesh("batch"), (Shard(0),))
    if layout == "ragged":
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t, _mesh("rows"), (Shard(0),))
    if layout.startswith("sparse"):
        return cm.shard_rows(t.to_sparse(), _mesh("rows"))
    return cm.distribute(t, _mesh("rows"), (Shard(0 if layout == "rows"
                                                    else 1),))


def task_call(fn, args=(), layouts=(), draws=None, **kwargs):
    """The port's ``fn`` ('module:name' under the package) on ``args``,
    each placed by its entry of ``layouts`` (None past its end), with
    ``draws`` patched in (``_draws_patched``): the packed result and the
    collectives it issued."""
    import importlib

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives

    module, name = fn.split(":")
    func = getattr(importlib.import_module(
        "rsvd_kamaneh_raganato_terrana_tpu_torch." + module), name)
    layouts = tuple(layouts) + (None,) * (len(args) - len(layouts))
    placed = [_placed_as(x, lay) for x, lay in zip(args, layouts)]
    collectives.reset()
    with _draws_patched(draws):
        out = func(*placed, **kwargs)
    return dict(out=_pack(out), tally=collectives.tally())


def task_entries(a, layout="sparse"):
    """This rank's run of a sparse ``a`` split by its entries over the
    1-D mesh (``shard_rows`` of a COO, CSR or CSC tensor, ``layout``
    'sparse', 'csr' or 'csc'): the run as a dense array, its stored
    entries in row-major order as (row, col) pairs, and the operand's
    shape."""
    import torch

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import mesh as cm

    t = _t(a).to_sparse() if layout == "sparse" else {
        "csr": _t(a).to_sparse_csr, "csc": _t(a).to_sparse_csc}[layout]()
    run = cm.shard_rows(t, _mesh("rows")).local.fwd
    rows = torch.repeat_interleave(
        torch.arange(run.shape[0]), torch.diff(run.crow_indices().long()))
    return dict(dense=_np(run.to_dense()), shape=tuple(run.shape),
                entries=np.stack([_np(rows), _np(run.col_indices().long())],
                                 axis=1))


def task_fit(cls, args=(), layouts=(), init=None, method=None, attrs=(),
             then=(), draws=None):
    """The port's class ``cls`` ('module:Name' under the package), made
    with the ``init`` keywords: without ``method`` made on ``args`` (as
    ``PCA(data)``), else ``obj.method(*args)``; each of ``attrs`` read
    (a method called without arguments), then each of ``then``'s
    (method, args, layouts[, keywords]) called (a method returning the
    object gives None).  Placed as ``task_call`` places them, ``draws``
    patched in throughout; ``tally`` covers the making and ``method``,
    ``then_tally`` each later step."""
    import importlib

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives

    module, name = cls.split(":")
    klass = getattr(importlib.import_module(
        "rsvd_kamaneh_raganato_terrana_tpu_torch." + module), name)

    def placed(xs, lays):
        lays = tuple(lays) + (None,) * (len(xs) - len(lays))
        return [_placed_as(x, lay) for x, lay in zip(xs, lays)]

    collectives.reset()
    with _draws_patched(draws):
        if method is None:
            obj, out = klass(*placed(args, layouts), **(init or {})), None
        else:
            obj = klass(**(init or {}))
            out = getattr(obj, method)(*placed(args, layouts))
            out = None if out is obj else out
        tally = collectives.tally()
        got = {}
        for attr in attrs:
            value = getattr(obj, attr)
            got[attr] = _pack(value() if callable(value) else value)
        later, tallies = [], []
        for step in then:
            collectives.reset()
            res = getattr(obj, step[0])(*placed(step[1], step[2]),
                                        **(step[3] if len(step) > 3 else {}))
            tallies.append(collectives.tally())
            later.append(None if res is obj else _pack(res))
    return dict(out=_pack(out), attrs=got, then=later, tally=tally,
                then_tally=tallies)


def task_chain(fn, args=(), layouts=(), then=(), **kwargs):
    """The port's ``fn`` on ``args`` placed by ``layouts`` (as
    ``task_call``), then each (fn2, args2, layouts2, keywords2) of
    ``then`` called on that first result and its own placed args: every
    result packed beside the tally of its own call."""
    import importlib

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives

    def func(name):
        module, attr = name.split(":")
        return getattr(importlib.import_module(
            "rsvd_kamaneh_raganato_terrana_tpu_torch." + module), attr)

    def placed(xs, lays):
        lays = tuple(lays) + (None,) * (len(xs) - len(lays))
        return [_placed_as(x, lay) for x, lay in zip(xs, lays)]

    collectives.reset()
    first = func(fn)(*placed(args, layouts), **kwargs)
    out = [dict(out=_pack(first), tally=collectives.tally())]
    for fn2, args2, lays2, kw2 in then:
        collectives.reset()
        res = func(fn2)(first, *placed(args2, lays2), **kw2)
        out.append(dict(out=_pack(res), tally=collectives.tally()))
    return out


def task_raises(fn, args=(), layouts=(), cls_init=None, cls_method=None,
                then=None, **kwargs):
    """The exception type and message the port's ``fn`` raises on
    ``args`` placed by ``layouts`` ('ragged': rows over the 1-D mesh in
    DTensor's own uneven split), or None; with ``cls_method``, ``fn`` is
    a class made with the ``cls_init`` keywords and ``cls_method`` is
    called on the placed args; with ``then`` (method, args, layouts), that
    method of the result is called on its own placed args."""
    import importlib

    module, name = fn.split(":")
    func = getattr(importlib.import_module(
        "rsvd_kamaneh_raganato_terrana_tpu_torch." + module), name)
    if cls_method is not None:
        func = getattr(func(**(cls_init or {})), cls_method)
    layouts = tuple(layouts) + (None,) * (len(args) - len(layouts))
    try:
        out = func(*(_placed_as(x, lay) for x, lay in zip(args, layouts)),
                   **kwargs)
        if then is not None:
            lays = tuple(then[2]) + (None,) * (len(then[1]) - len(then[2]))
            getattr(out, then[0])(*(_placed_as(x, lay)
                                    for x, lay in zip(then[1], lays)))
    except Exception as exc:  # noqa: BLE001 -- the result under test
        return dict(type=type(exc).__name__, message=str(exc)[:200])
    return None


def task_fd(a, n_cols, l, batch):
    """FrequentDirections with its 2l x n buffer column-sharded over the
    1-D mesh, fed ``a`` ``batch`` rows at a time: the sketch, the top-4
    ``eigh_estimate`` (V packed) and the tally of the updates."""
    import torch

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import mesh as cm
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.fd import (
        FrequentDirections,
    )

    fd = FrequentDirections(n_cols, l, dtype=torch.float64, device="cpu")
    fd._buf = cm.distribute(fd._buf, _mesh("rows"),
                            cm.col_sharding(_mesh("rows")))
    collectives.reset()
    for i in range(0, a.shape[0], batch):
        fd.update(a[i:i + batch])
    tally = collectives.tally()
    w, v = fd.eigh_estimate(4)
    return dict(sketch=_pack(fd.sketch()), w=_np(w), v=_pack(v),
                tally=tally)


def task_tiled(data, k, grid, mesh="rows"):
    """``Image.compress_tiled(mesh=)`` on the CPU: the tile factors, the
    recorded layout and the tally."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.image import Image
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives

    collectives.reset()
    im = Image(data).compress_tiled(k=k, grid=tuple(grid), mesh=_mesh(mesh),
                                    device="cpu", dtype=_f64())
    tf = im.tile_factors
    return dict(u=tf.u, s=tf.s, v=tf.v, rec=im.reconstruct(),
                sharding=[str(p) for p in im.last_tile_sharding or ()],
                tally=collectives.tally())


def task_video(frames, k, p, mesh="rows"):
    """``compress_video(mesh=)`` on the CPU: (U, S, V) and the tally."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.image import (
        compress_video,
    )
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives

    collectives.reset()
    u, s, v = compress_video(frames, k=k, p=p, mesh=_mesh(mesh),
                             device="cpu", dtype=_f64())
    return dict(u=u, s=s, v=v, tally=collectives.tally())


def _f64():
    import torch

    return torch.float64


def task_ring(a, omega, **kwargs):
    """``rsvd_ring`` on the 1-D mesh, Omega patched: (U, s, V, tally)."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.ring import rsvd_ring

    collectives.reset()
    with _omega_patched(omega):
        u, s, v = rsvd_ring(_mesh("rows"), _t(a), **kwargs)
    tally = collectives.tally()
    return dict(u=_full(u), s=_np(s), v=_full(v), tally=tally)


def task_primitive(name, args, **kwargs):
    """One ``ops.primitives`` sharded function on the 1-D mesh: the whole
    result and the tally.  ``args`` are whole arrays (each rank takes its
    block); 'generate_gaussian_sharded' takes a seed."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
    from rsvd_kamaneh_raganato_terrana_tpu_torch.ops import primitives

    collectives.reset()
    fn = getattr(primitives, name)
    if name == "generate_gaussian_sharded":
        out = fn(_mesh("rows"), *args, **kwargs)
    else:
        out = fn(_mesh("rows"), *(_t(x) for x in args), **kwargs)
    tally = collectives.tally()
    return dict(out=_full(out), tally=tally)


def task_top_k(items, users, k):
    """``top_k_items_sharded`` over the 1-D mesh: (values, ids, tally)."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import retrieval
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives

    collectives.reset()
    tables = retrieval.EmbeddingTables(None, _t(items), None)
    vals, ids = retrieval.top_k_items_sharded(_mesh("rows"), tables,
                                              _t(users), k)
    return dict(vals=_np(vals), ids=_np(ids), tally=collectives.tally())


def task_mesh_facts(rows: int):
    """What the mesh helpers give on this group, ``rows`` a row count
    that does not divide the ranks."""
    import torch
    import torch.distributed as dist

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import mesh as cm
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
        initialize,
        row_spec_for,
    )

    initialize()                          # a group that is up: left alone
    mesh = _mesh("rows")
    x = torch.arange(float(rows * 3)).reshape(rows, 3)
    try:
        cm.shard_rows(x, mesh)
        ragged_raises = False
    except ValueError:
        ragged_raises = True
    padded, orig = cm.pad_rows_for_mesh(x, mesh)
    sh = cm.shard_rows(padded, mesh)
    rep = cm.replicate(x, mesh)
    pod = _mesh("pod")
    tile = _mesh("tile")
    return dict(
        world=dist.get_world_size(), mesh_shape=tuple(mesh.shape),
        mesh_names=mesh.mesh_dim_names, tile_shape=tuple(tile.shape),
        tile_names=tile.mesh_dim_names, pod_shape=tuple(pod.shape),
        pod_names=pod.mesh_dim_names, pod_ranks=pod.mesh.tolist(),
        pod_placements=[str(p) for p in row_spec_for(pod)],
        ragged_raises=ragged_raises, padded_rows=padded.shape[0],
        orig_rows=orig, pad_zero=bool((padded[orig:] == 0).all()),
        local=_np(sh.to_local()), whole=_np(sh.full_tensor()),
        row_placements=[str(p) for p in cm.row_sharding(mesh)],
        col_placements=[str(p) for p in cm.col_sharding(mesh)],
        rep_local=_np(rep.to_local()),
        local_mesh=cm.local_mesh_or_none("cpu") is not None)


def task_multihost(a, sizes, omega=None, **kwargs):
    """``rsvd_streaming_multihost`` with rank r streaming rows
    [sum(sizes[:r]), sum(sizes[:r + 1])) of ``a`` in f64 on the CPU:
    (U_local, s, V, tally)."""
    import torch
    import torch.distributed as dist

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.multihost import (
        rsvd_streaming_multihost,
    )

    r = dist.get_rank()
    start = sum(sizes[:r])
    a_local = np.ascontiguousarray(a[start:start + sizes[r]])
    kwargs.setdefault("dtype", torch.float64)
    collectives.reset()
    with _omega_patched(omega):
        u, s, v = rsvd_streaming_multihost(a_local, device="cpu", **kwargs)
    return dict(u=_np(u), s=_np(s), v=_np(v), tally=collectives.tally())


def task_pod_worker(ckdir):
    """The multi-host checks of tests/_multihost_worker.py on this group
    seen as hosts of LOCAL_WORLD_SIZE ranks: the pod mesh, rsvd on rows
    sharded over both of its axes, the ring over every rank, multi-host
    streaming of uneven shards (memmap, int8 panels, rowspace,
    rowspace_utv + cholqr1) and a checkpointed run resumed after rank 1
    lost two stages.  Numbers only; the test holds them to the bars."""
    import tempfile

    import torch
    import torch.distributed as dist

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import mesh as cm
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
        row_spec_for,
    )
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.multihost import (
        rsvd_streaming_multihost,
    )
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.ring import rsvd_ring

    rank = dist.get_rank()
    mesh = _mesh("pod")
    out = dict(shape=tuple(mesh.shape), names=mesh.mesh_dim_names,
               ranks=mesh.mesh.tolist())
    m = n = 256
    k, p, q = 16, 8, 2
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((m, 16)) @ rng.standard_normal((16, n))
         + 0.01 * rng.standard_normal((m, n))).astype(np.float32)
    omega = driver.generate_omega(0, n, k + p, torch.float32, device="cpu")
    a_sh = cm.distribute(torch.from_numpy(a), mesh, row_spec_for(mesh))
    _, s, _ = driver.rsvd_with_omega(a_sh, omega, q=q, k=k, method="eigh")
    _, s1, _ = driver.rsvd_with_omega(torch.from_numpy(a), omega, q=q, k=k,
                                      method="eigh")
    out.update(a=a, s=_np(s), s_single=_np(s1))
    _, s_r, _ = rsvd_ring(_mesh("rows"), torch.from_numpy(a), k=k, p=p, q=1,
                          method="eigh")
    out["s_ring"] = _np(s_r)

    sizes = [90, 90, 120, 120]                    # uneven, 420 rows
    full = (rng.standard_normal((420, n)) * 0.01
            + rng.standard_normal((420, 16)) @ rng.standard_normal((16, n))
            ).astype(np.float32)
    start = sum(sizes[:rank])
    mine = full[start:start + sizes[rank]]
    kw = dict(k=k, p=8, q=2, panel_rows=64, device="cpu")
    with tempfile.NamedTemporaryFile(suffix=".bin") as f:
        mm = np.memmap(f.name, dtype=np.float32, mode="w+", shape=mine.shape)
        mm[:] = mine
        mm.flush()
        runs = {"memmap": rsvd_streaming_multihost(
            np.memmap(f.name, dtype=np.float32, mode="r", shape=mine.shape),
            **kw)}
    runs["int8"] = rsvd_streaming_multihost(mine, panel_dtype="int8", **kw)
    runs["rowspace"] = rsvd_streaming_multihost(mine, finish="rowspace",
                                                **kw)
    runs["rowspace_utv"] = rsvd_streaming_multihost(
        mine, finish="rowspace_utv", qr_method="cholqr1", **kw)
    out.update(full=full, mine=mine, runs={
        name: tuple(_np(x) for x in r) for name, r in runs.items()})

    u1, s_c1, _ = rsvd_streaming_multihost(mine, checkpoint_dir=ckdir, **kw)
    if rank == 1:                   # rank 1 loses its round-1 state
        os.remove(os.path.join(ckdir, "host1", "round1.npy"))
        os.remove(os.path.join(ckdir, "host1", "b_final.npy"))
    dist.barrier()
    _, s_c2, _ = rsvd_streaming_multihost(mine, checkpoint_dir=ckdir, **kw)
    out.update(s_ckpt=_np(s_c1), s_resumed=_np(s_c2))
    return out


def _rank_main(addr, key, rank, world, port):
    import torch

    torch.set_num_threads(1)
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
        initialize,
    )

    host, cport = addr.rsplit(":", 1)
    conn = Client((host, int(cport)), authkey=bytes.fromhex(key))
    conn.send(rank)
    initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    tasks = {name[5:]: fn for name, fn in globals().items()
             if name.startswith("task_")}
    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, kwargs = msg
        local_world = kwargs.pop("local_world", None)
        if local_world is not None:
            os.environ["LOCAL_WORLD_SIZE"] = str(local_world)
        try:
            conn.send(("ok", tasks[name](**kwargs)))
        except Exception:  # noqa: BLE001 -- reported to the test, which fails
            import traceback

            conn.send(("error", traceback.format_exc()))
        finally:
            os.environ.pop("LOCAL_WORLD_SIZE", None)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
               int(sys.argv[5]))
