"""Shared pieces of the benchmark's CPU tests.

The ``card`` marker marks a test that needs a CUDA card; the ``card``
fixture decides inside the test whether one is there.  ``tiny_root`` is
a copy of the benchmark's data files (configurations, workloads, metric
readers, ``layers.json``) beside a copy of ``BENCHMARK.json``, with each
configuration cut to a size the CPU runs in a second; the harness runs
it on the CPU with the port's plain kernel versions."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parent.parent
REPO = PORTBENCH.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {
    "dense_100k": {"operand": {"rows": 600, "cols": 500, "rank": 48,
                               "sigma_1": 20 * (600 ** .5 + 500 ** .5),
                               "block_rows": 128},
                   "settings": {"k": 16, "p": 8, "q": 2}},
    "dense_400k_rows": {"operand": {"rows": 1200, "cols": 500, "parts": 4,
                                    "rank": 48,
                                    "sigma_1": 20 * (1200 ** .5 + 500 ** .5),
                                    "block_rows": 128},
                        "settings": {"k": 16, "p": 8, "q": 2}},
    "recsys_ml20m": {"operand": {"users": 3000, "items": 800,
                                 "ratings": 40000},
                     "settings": {"k": 16, "p": 8, "q": 2}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    return "cuda"


def make_tiny_root(dst: Path) -> Path:
    shutil.copytree(PORTBENCH, dst / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for name, cut in TINY.items():
        path = dst / "portbench" / "configs" / f"{name}.json"
        if not path.exists():
            continue
        cfg = json.loads(path.read_text())
        cfg["operand"].update(cut["operand"])
        cfg["settings"].update(cut["settings"])
        path.write_text(json.dumps(cfg))
    return dst / "portbench"


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


def run_tiny(root: Path, workload: str, seed: int = 3_000_000_019,
             seconds: float = 0.5, trace: int = 0) -> dict:
    """One run of ``workload`` from ``root`` on the CPU: the result line."""
    import io
    from portbench import run
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)])
    out = io.StringIO()
    result = run.run_rank(0, 1, args, None, device="cpu", backend="gloo",
                          root=root, out=out)
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == result
    return result
