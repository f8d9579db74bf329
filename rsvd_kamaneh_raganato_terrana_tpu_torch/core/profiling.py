"""Timing and profiling harness (the JAX package's
``core/profiling.py``, on torch: that module imports jax).

A timer that waits for the card (``torch.cuda.synchronize`` where the
JAX package blocks on its arrays), a phase-timer registry that exports
the reference's CSV timing protocol, a ``torch.profiler`` trace written
as a chrome trace under ``log_dir``, and FLOP counts.
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
    kernels too when there is one) and write it as a chrome trace,
    ``rsvd_<pid>_<ns>.pt.trace.json`` under ``log_dir`` (default:
    ``rsvd_trace`` in the temporary directory), viewable in Perfetto.
    Yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "rsvd_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"rsvd_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


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
