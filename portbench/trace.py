"""Reduction of a ``torch.profiler`` trace of the window to per-layer
numbers.

Layers.  The harness opens ``record_function`` spans named
``portbench/<layer>`` around the program's functions that
``layers.json`` lists, and those the cell's kind adds (``SPANS``), only
in a traced run, and ``portbench/call`` around each call.  A device
operation belongs to the innermost layer span open on the host when it
was launched (found through the profiler's correlation ids); an NCCL
kernel always belongs to ``collectives``; an operation launched outside
every layer span is filed by name (:data:`KERNEL_GROUPS`, a repaired copy of
``chip_smoke.py``'s, with cuSPARSE added).

Repairs against ``chip_smoke.py::profile_call``: the busy time is the
union of the device intervals (kernels on two streams are not counted
twice), and a host wait is counted once, by the runtime call that waits
(``cud*Synchronize``, or a blocking ``cudaMemcpy``): an ``.item()`` or a
device-to-host ``.cpu()`` is one ``aten::_local_scalar_dense`` /
``aten::copy_`` around one ``cudaStreamSynchronize``, so counting the op
as well counted it twice.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import json
from pathlib import Path

SPAN = "portbench/"
CALL = SPAN + "call"

# device kernels by name: (substrings, group, layer), first match wins
KERNEL_GROUPS = (
    (("nccl",), "NCCL collectives", "collectives"),
    (("jacobi_eigh", "eigh_cluster"), "K3 jacobi_eigh / eigh_cluster",
     "tail"),
    (("sketch_cluster", "sum_splits"), "K4 sketch_cluster / sum_splits",
     "products"),
    (("ns_cluster", "ns_iterate"), "K2 ns_cluster / ns_iterate", "ortho"),
    (("quantize_u8",), "K5 quantize_u8", "other"),
    (("eliminate",), "K1 eliminate_cluster / eliminate_wide", "ortho"),
    (("gram_cluster", "gram_partials"),
     "K1/K2 Gram (gram_cluster, gram_partials)", "ortho"),
    (("apply_rows", "apply_right"), "K1/K2 apply (apply_rows, apply_right)",
     "ortho"),
    (("syevj", "syevbj", "row_rotate", "column_rotate", "syevd", "sytrd",
      "stedc", "ormtr", "orgtr"), "cuSOLVER eigh", "tail"),
    (("cusparse", "csrmm", "spmm", "csr_"), "cuSPARSE", "products"),
    (("i8", "s8", "imma", "int8"), "int8 GEMMs", "products"),
    (("potrf", "getrf", "trsm", "trtri", "cholesky", "syrk"),
     "cholqr1 factor and solve", "ortho"),
    (("gemm", "nvjet", "xmma", "cutlass"), "other GEMMs", "products"),
)


def kernel_group(name: str):
    """(group, layer) of a device operation by its name."""
    low = name.lower()
    for keys, group, layer in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return group, layer
    return "other kernels", "other"


# -- spans ------------------------------------------------------------------

def _spec(root: Path) -> dict:
    return json.loads((root / "layers.json").read_text())


def span_targets(root: Path, extra=None) -> dict:
    """{layer: [module:attribute, ...]}: ``layers.json``'s, with a kind's
    own ``SPANS`` (``extra``) added in the cells of that kind."""
    targets = {k: list(v) for k, v in _spec(root)["spans"].items()}
    for layer, more in (extra or {}).items():
        have = targets.setdefault(layer, [])
        have += [t for t in more if t not in have]
    return targets


@contextlib.contextmanager
def layer_spans(root: Path, extra=None):
    """Wrap the functions :func:`span_targets` names in
    ``portbench/<layer>`` spans for the duration of the block, which is
    given the (layer, target) pairs wrapped; names the program does not
    have are left alone (their kernels are then filed by name)."""
    from torch.profiler import record_function

    undo, wrapped_targets = [], []
    for layer, targets in span_targets(root, extra).items():
        for target in targets:
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr, None)
            if fn is None:
                continue

            def wrapped(*a, _fn=fn, _name=SPAN + layer, **kw):
                with record_function(_name):
                    return _fn(*a, **kw)
            functools.update_wrapper(wrapped, fn)
            setattr(mod, attr, wrapped)
            undo.append((mod, attr, fn))
            wrapped_targets.append((layer, target))
    try:
        yield wrapped_targets
    finally:
        for mod, attr, fn in reversed(undo):
            setattr(mod, attr, fn)


# -- events -----------------------------------------------------------------

def events_from_profiler(prof):
    """(cpu, gpu) event tuples of a finished ``torch.profiler.profile``:
    cpu (name, start_ns, end_ns, correlation, thread); gpu (name,
    start_ns, end_ns, linked correlation, correlation)."""
    from torch.autograd import DeviceType

    cpu, gpu = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            cpu.append((e.name(), start, end, e.correlation_id(),
                        e.start_thread_id()))
        else:
            gpu.append((e.name(), start, end, e.linked_correlation_id(),
                        e.correlation_id()))
    return cpu, gpu


def _annotation(name: str) -> bool:
    """A host span's copy on the device timeline (``portbench/...``, or
    torch's ``nccl:<op>`` around each collective), not an operation."""
    return name.startswith(SPAN) or name.startswith("nccl:")


class Nested:
    """Innermost interval containing a point, for properly nested
    intervals (those of one host thread)."""

    def __init__(self, intervals):
        self.items = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
        self.starts = [iv[0] for iv in self.items]
        self.parent = []
        stack = []
        for i, (s, e, _) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][1] < t:
            i = self.parent[i]
        return self.items[i][2] if i >= 0 else None


def _union(intervals, lo, hi):
    """Merged [start, end] intervals clipped to [lo, hi]."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver API call (cudaLaunchKernel, cuLaunchKernel)."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def _is_wait(name: str) -> bool:
    return "Synchronize" in name or name == "cudaMemcpy"


def reduce(cpu, gpu, top: int = 10) -> dict:
    """The per-layer numbers of one rank's trace (see the module
    docstring): calls, window_s, busy_s, seconds by layer over the
    traced calls, host waits inside calls, and the breakdown's longest
    device operations and idle gaps (seconds over the window)."""
    calls = [(s, e) for n, s, e, _, _ in cpu if n == CALL]
    if not calls:
        return {"calls": 0}
    tid = next(t for n, _, _, _, t in cpu if n == CALL)
    w0, w1 = min(s for s, _ in calls), max(e for _, e in calls)
    in_call = Nested([(s, e, True) for s, e in calls])
    layers = Nested([(s, e, n[len(SPAN):]) for n, s, e, _, t in cpu
                     if n.startswith(SPAN) and n != CALL and t == tid])
    runtime = {c: s for n, s, _, c, _ in cpu if _is_runtime(n)}
    ops = {c: s for n, s, _, c, _ in cpu if not _is_runtime(n)}

    layer_s, by_name, resolved, busy = {}, {}, 0, []
    for name, s, e, linked, corr in gpu:
        if _annotation(name):
            continue
        launch = runtime.get(corr, ops.get(linked))
        resolved += launch is not None
        when = launch if launch is not None else s
        if not in_call.at(when):
            continue
        busy.append((s, e))
        group, layer = kernel_group(name)
        if layer != "collectives":
            layer = (layers.at(launch) if launch is not None else None) \
                or layer
        layer_s[layer] = layer_s.get(layer, 0.0) + (e - s) * 1e-9
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
    merged = _union(busy, w0, w1)
    busy_s = sum(e - s for s, e in merged) * 1e-9

    host = Nested([(s, e, n) for n, s, e, _, t in cpu
                   if t == tid and n != CALL])
    gaps, prev = {}, w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            label = host.at((prev + s) // 2) or "host (no traced op)"
            gaps[label] = gaps.get(label, 0.0) + (s - prev) * 1e-9
        prev = max(prev, e)
    syncs = sum(1 for n, s, _, _, _ in cpu
                if _is_runtime(n) and _is_wait(n) and in_call.at(s))
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa
    return {
        "calls": len(calls), "window_s": (w1 - w0) * 1e-9, "busy_s": busy_s,
        "layer_s": layer_s, "syncs": syncs, "device_ops_n": len(busy),
        "resolved": resolved,
        "device_ops": [[n, v] for n, v in rank(by_name)],
        "idle_gaps": [[n, v] for n, v in rank(gaps)],
    }


class Reading:
    """What a per-layer metric reads: rank 0's trace reduction, the mean
    busy seconds over the ranks, the least product time of one call and
    the collectives' bytes over the traced calls."""

    def __init__(self, red: dict, busy_mean_s: float, least_products_s,
                 collective_bytes=None):
        self.calls = red.get("calls", 0)
        self.window_s = red.get("window_s", 0.0)
        self.busy_s = busy_mean_s
        self.layer_s = red.get("layer_s", {})
        self.syncs = red.get("syncs", 0)
        self.least_products_s = least_products_s
        self.collective_bytes = collective_bytes

    def layer_ms(self, layer: str):
        """Device ms a call in ``layer``; None where it ran nothing."""
        t = self.layer_s.get(layer)
        return None if not t or not self.calls else 1e3 * t / self.calls
