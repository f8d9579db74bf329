"""Finds a cell's pieces by name: ``workloads/<cell>.json`` (the entry,
the loop, chips, why, the reference and the limits),
``configs/<config>.json`` (the operand and the settings),
``metrics/<metric>.py`` (a per-layer metric's reader) and the cell's
metrics in ``BENCHMARK.json``.  Adding a cell, a configuration or a
metric adds files and edits none."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent          # portbench/
REPO = ROOT.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name: str) -> str:
    if not NAME.fullmatch(name or ""):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    return json.loads(path.read_text())


def workload(name: str, root: Path = ROOT) -> dict:
    return _json(root / "workloads" / f"{_checked(name)}.json")


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root / "configs" / f"{_checked(name)}.json")


def metric(name: str, root: Path = ROOT):
    """The reader module of per-layer metric ``name``: ``UNIT``,
    ``MOVES`` and ``read(reading) -> float | None``."""
    path = root / "metrics" / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(repo: Path = REPO) -> dict:
    return _json(repo / "BENCHMARK.json")


def cell_metrics(name: str, bench: dict):
    """(end-to-end, per-layer) metric entries of cell ``name``: those
    that list it under ``workloads``, or list no cells; a per-layer
    metric without the key goes with every cell that reports its
    ``moves``."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def cell(name: str, root: Path = ROOT, repo: Path = REPO):
    """(workload, config, end-to-end entries, per-layer entries)."""
    wl = workload(name, root)
    if wl.get("name") != name:
        raise ValueError(f"{name}.json names {wl.get('name')!r}")
    cfg = config(wl["config"], root)
    e2e, layer = cell_metrics(name, benchmark(repo))
    return wl, cfg, e2e, layer
