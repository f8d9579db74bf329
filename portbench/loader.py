"""Finds a cell's pieces by name: ``workloads/<cell>.json`` (the entry,
the loop, chips, why, the reference and the limits),
``configs/<config>.json`` (the operand and the settings),
``kinds/<kind>.py`` (the workload's ``kind``, ``rsvd`` where it names
none: how its operand is built, its output sampled, held to its plain
reference and its least time counted), ``metrics/<metric>.py`` (a
per-layer metric's reader) and the cell's metrics in
``BENCHMARK.json``.  Adding a cell, a configuration, a kind or a metric
adds files and edits none."""

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


def _module(folder: str, name: str, root: Path):
    path = root / folder / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, root: Path = ROOT):
    """The reader module of per-layer metric ``name``: ``UNIT``,
    ``MOVES`` and ``read(reading) -> float | None``."""
    return _module("metrics", name, root)


DEFAULT_KIND = "rsvd"


def kind(wl: dict, root: Path = ROOT):
    """The kind module of workload ``wl`` (its ``kind``, else
    :data:`DEFAULT_KIND`):

    - ``build(wl, cfg, seed, device, rank, mesh) -> (operand, held)``:
      the program's operand made from the seed with the program's own
      functions, and what the reference may read again (or None);
    - ``sample(out) -> (kept, nonfinite, unhealthy)``: of one call's
      output, the tensors the check needs (this rank's part), a 0-d
      device tensor that is nonzero where the output is not finite (no
      host wait in the window), and whether the program's own health
      verdict tripped;
    - ``readings(wl, cfg, samples, held, seed, device, comm,
      control=None) -> {name: float}``: the sampled calls held to the
      kind's plain reference; with ``control`` (the cell's control
      numerics) (program, control), the control's readings those of the
      reference computed at that numerics in the program's place;
    - ``least(wl, cfg, world) -> (seconds, bound_by)``: the least time of
      one call's products on one card, for ``products_roofline``;
    - ``SPANS`` (optional): {layer: ["module:attribute", ...]}, span
      targets added to ``layers.json``'s in cells of this kind only."""
    return _module("kinds", wl.get("kind", DEFAULT_KIND), root)


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
