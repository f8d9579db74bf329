"""Timing and profiling harness (the JAX package's
``core/profiling.py``, on torch: that module imports jax).

A timer that waits for the card (``torch.cuda.synchronize`` where the
JAX package blocks on its arrays), a phase-timer registry that exports
the reference's CSV timing protocol, a ``torch.profiler`` trace written
as a chrome trace under ``log_dir``, the program's own spans, and FLOP
counts.

Spans.  The driver, linalg, serving and collectives modules open
:func:`span` where their work happens; :func:`spans` switches them on for
a block (:func:`trace` does so for its own).  A span on is a
``torch.profiler.record_function`` named ``rsvd/<name>``: a host event
on the profiler's clock, which is the clock of the card's kernel events,
and every launch inside it is tied to its kernel by correlation id.  A
span off is one test of a boolean and returns one shared no-op context.
The tree of one call (parents by nesting on the host thread):

  rsvd/call                  the root, once a call (:func:`call_span`)
    rsvd/stage               the operand cast or quantized for stage A
    rsvd/sketch              Omega, Y = A Omega, its first basis
    rsvd/power               one power round
    rsvd/finish              B = Q^T A (or the rowspace Z, C) to (U, s, V)
    rsvd/health              ``factor_health``
    rsvd/mode                one mode of a Tucker call (``rsvd/tucker.py``),
                             around its own stages
      rsvd/unfold            the mode's unfolding (no device work where
                             it is a view)
  below the stages:
    rsvd/product             a stage-A product (the driver's ``_mm``)
      rsvd/cast              an operand narrowed to bf16 or int8 for it
    rsvd/ortho               ``qr_reduced`` / ``orthonormal_basis`` /
                             the column normalization
    rsvd/tail                the small SVD (``linalg/svd.py::svd``)
    rsvd/collective/<kind>   each ``core/collectives.py`` call
    rsvd/read/<cause>        a deliberate device-to-host read

A span's self time is its interval less its children's.  Spans stay off
under a ``torch.func`` transform (a profiler op has no batching rule).
The switch is one flag of this module, so it holds for every thread.
"""

from __future__ import annotations

import contextlib
import csv
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


def _cuda_devices(x, found):
    """The CUDA devices of the tensors in ``x`` (nested tuples, lists and
    dicts walked)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            found.add(x.device)
    elif isinstance(x, (tuple, list)):
        for item in x:
            _cuda_devices(item, found)
    elif isinstance(x, dict):
        for item in x.values():
            _cuda_devices(item, found)
    return found


def _sync(x):
    """Wait for the work that produces ``x`` on every card it lies on."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)
    return x


def timeit(fn, *args, iters: int = 1, warmup: int = 1, **kwargs):
    """Time ``fn`` after ``warmup`` calls; returns (best_seconds,
    result).  Each call is waited for on the cards its result lies on."""
    result = None
    for _ in range(max(warmup, 0)):
        result = _sync(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        result = _sync(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return best, result


@dataclass
class PhaseTimer:
    """Accumulates named phase timings; exports the reference CSV schema."""

    phases: Dict[str, List[float]] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            self.phases.setdefault(name, []).append(time.perf_counter() - t0)

    def total_ms(self, name: str) -> float:
        return 1e3 * sum(self.phases.get(name, []))

    def avg_us(self, name: str) -> float:
        xs = self.phases.get(name, [])
        return 1e6 * sum(xs) / len(xs) if xs else 0.0

    def write_csv(self, path: str, extra_rows: Optional[List[dict]] = None):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["phase", "total_ms", "avg_us", "count"])
            for name, xs in self.phases.items():
                w.writerow([name, f"{1e3 * sum(xs):.3f}",
                            f"{1e6 * sum(xs) / len(xs):.3f}", len(xs)])
            if extra_rows:
                w.writerow([])
                keys = list(extra_rows[0].keys())
                w.writerow(keys)
                for row in extra_rows:
                    w.writerow([row[k] for k in keys])


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the block (the card's
    kernels too when there is one), with the program's spans on, and
    write it as a chrome trace, ``rsvd_<pid>_<ns>.pt.trace.json`` under
    ``log_dir`` (default: ``rsvd_trace`` in the temporary directory),
    viewable in Perfetto.  Yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "rsvd_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof, spans():
        try:
            yield log_dir
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"rsvd_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


#: the prefix of every span's name ('/' begins no C++ kernel name)
PREFIX = "rsvd/"
_OFF = contextlib.nullcontext()
_on = False          # the switch (:func:`spans`)
_in_call = False     # a root span is open


@contextlib.contextmanager
def spans(on: bool = True):
    """Spans on (or off) for the block; the previous setting after it."""
    global _on
    prev, _on = _on, on
    try:
        yield
    finally:
        _on = prev


def span(name: str):
    """The span ``rsvd/<name>`` around a block where spans are on, else
    one shared no-op context.  ``name`` is a constant string: nothing is
    built while spans are off."""
    if not _on or torch._C._are_functorch_transforms_active():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def _root():
    global _in_call
    _in_call = True
    try:
        with torch.profiler.record_function(PREFIX + "call"):
            yield
    finally:
        _in_call = False


def call_span():
    """The root span ``rsvd/call`` of a public entry, where spans are on
    and no root is open yet (an entry called by another opens none)."""
    if not _on or _in_call or torch._C._are_functorch_transforms_active():
        return _OFF
    return _root()


def matmul_gflops(m: int, n: int, k: int, seconds: float) -> float:
    return 2.0 * m * n * k / seconds / 1e9


def rsvd_flops(m: int, n: int, l: int, q: int) -> float:
    """FLOP count of the dense rSVD pipeline (sketch + q power rounds +
    B-projection + QR work), used for the GFLOP/s benchmark metrics."""
    sketch = 2.0 * m * n * l
    power = q * 2 * (2.0 * m * n * l)     # A^T Q and A Z per round
    proj = 2.0 * m * n * l                # B = Q^T A
    qr = (2 * q + 1) * 2.0 * m * l * l    # CholeskyQR-ish cost per orthonormalization
    return sketch + power + proj + qr
