"""The loader finds every piece of a cell by its name, and a cell, a
configuration and a metric added as new files alone are run."""

from __future__ import annotations

import json

import pytest

from portbench import loader
from portbench.tests.conftest import run_tiny


def test_pieces_found_by_name():
    bench = loader.benchmark()
    for cell in bench["workloads"]:
        wl, cfg, e2e, layer = loader.cell(cell["name"])
        assert wl["config"] == cfg["name"] == cell["config"]
        assert wl["chips"] == cell["chips"] and wl["why"] == cell["why"]
        assert {"call_ms", "setup_s"} <= {m["name"] for m in e2e}
        assert layer, cell["name"]
        for m in layer:
            reader = loader.metric(m["name"])
            assert reader.UNIT == m["unit"] and reader.MOVES == m["moves"]
            assert reader.LAYER == m["layer"]
    for c in bench["configs"]:
        assert loader.config(c["name"])["source"] == c["source"]


def test_bad_names_refused():
    for bad in ("../x", "a/b", "", "a b", "x" * 65):
        with pytest.raises(ValueError):
            loader.workload(bad)
    with pytest.raises(FileNotFoundError):
        loader.workload("no_such_cell")


def test_new_files_make_a_new_cell(tiny_root):
    """A configuration, a workload and a per-layer metric dropped in as
    new files, and their entries in BENCHMARK.json, are a new cell that
    runs: no existing file of the harness is edited."""
    cfg = json.loads((tiny_root / "configs" / "dense_100k.json").read_text())
    cfg.update(name="dense_tall", operand=dict(cfg["operand"], rows=900))
    (tiny_root / "configs" / "dense_tall.json").write_text(json.dumps(cfg))
    wl = json.loads((tiny_root / "workloads" / "dense_100k.fit.json")
                    .read_text())
    wl.update(name="dense_tall.fit", config="dense_tall")
    (tiny_root / "workloads" / "dense_tall.fit.json").write_text(
        json.dumps(wl))
    (tiny_root / "metrics" / "calls_traced.py").write_text(
        'LAYER = "driver"\nUNIT = "1"\nMOVES = "call_ms"\n\n\n'
        'def read(r):\n    return float(r.calls) if r.calls else None\n')
    bench_path = tiny_root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "dense_tall", "source": "s",
                             "file": "portbench/configs/dense_tall.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "dense_tall.fit",
                               "config": "dense_tall", "traffic": "fit",
                               "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "1",
                               "better": "higher", "source": "device_trace",
                               "layer": "driver", "moves": "call_ms",
                               "workloads": ["dense_tall.fit"]})
    bench_path.write_text(json.dumps(bench))

    _, _, _, layer = loader.cell("dense_tall.fit", tiny_root,
                                 tiny_root.parent)
    assert "calls_traced" in {m["name"] for m in layer}
    _, _, _, other = loader.cell("dense_100k.fit", tiny_root,
                                 tiny_root.parent)
    assert "calls_traced" not in {m["name"] for m in other}
    res = run_tiny(tiny_root, "dense_tall.fit", trace=1)
    assert res["correct"] is True
    assert res["metrics"]["calls_traced"]["value"] > 0
