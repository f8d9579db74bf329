"""The ``tucker`` kind as files (``kinds/tucker.py``, ``configs/
tucker_hcci.json``, ``workloads/tucker_hcci.compress.json``): a tiny
cut of the cell runs on the CPU and is judged correct under the cell's
own limits, not correct with its core scaled by 1.1 or a factor's
leading column made 10% longer where the program makes them, and
``control.py`` runs through the kind."""

from __future__ import annotations

import importlib
import io
import json

import pytest

from portbench import check, control, loader
from portbench.tests.conftest import run_tiny

PKG = "rsvd_kamaneh_raganato_terrana_tpu_torch"
CELL = "tucker_hcci.compress"
# the cell's configuration cut to a size the CPU runs in a second; every
# other value (decays, scale, noise, p, q) as in the cell
TINY_OPERAND = {"shape": [20, 16, 6, 18], "core_rank": [10, 8, 6, 10],
                "decay": [4.0, 4.0, 1.5, 4.0], "scale": 3000.0, "block": 8}
TINY_RANKS = [5, 4, 3, 5]


def _cut(root):
    path = root / "configs" / "tucker_hcci.json"
    cfg = json.loads(path.read_text())
    cfg["operand"].update(TINY_OPERAND)
    cfg["settings"]["ranks"] = TINY_RANKS
    path.write_text(json.dumps(cfg))
    return cfg


def _core_scaled(core, factors):
    return core * 1.1, factors


def _column_off(core, factors):
    factors = list(factors)
    factors[1] = factors[1].clone()
    factors[1][:, 0] *= 1.1
    return core, tuple(factors)


@pytest.mark.parametrize("trace_on", [0, 1])
@pytest.mark.parametrize("fault", [_core_scaled, _column_off])
def test_tucker_cell_runs_and_is_judged(tiny_root, monkeypatch, trace_on,
                                        fault):
    """Correct as the program stands, with every compared number read;
    not correct with the core scaled by 1.1, or with a factor's leading
    column made 10% longer (the core untouched), where ``tucker`` makes
    them."""
    _cut(tiny_root)
    wl = loader.workload(CELL, tiny_root)
    res = run_tiny(tiny_root, CELL, trace=trace_on)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert list(res["checks"]) == list(wl["limits"])
    if trace_on:
        assert res["metrics"]["unfold_gb_per_call"]["value"] > 0
    else:
        assert {"call_ms", "call_ms_p95", "setup_s"} <= set(res["metrics"])

    tucker = importlib.import_module(PKG + ".rsvd.tucker")
    impl = tucker._tucker_impl
    monkeypatch.setattr(tucker, "_tucker_impl",
                        lambda *a, **kw: fault(*impl(*a, **kw)))
    bad = run_tiny(tiny_root, CELL, trace=trace_on)
    assert bad["correct"] is False


def test_tucker_control_runs_through_the_kind(tiny_root):
    """control.py on the kind: one line a seed with the program's and the
    TF32 control's readings of every number, then the summary; the
    program passes the cell's limits on every seed."""
    _cut(tiny_root)
    wl = loader.workload(CELL, tiny_root)
    out = io.StringIO()
    control.main(["--workload", CELL, "--seeds", "3000000019,3000000020",
                  "--calls", "1"], root=tiny_root, device="cpu", out=out)
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert len(lines) == 3
    for row in lines[:-1]:
        assert set(wl["limits"]) <= set(row["program"])
        assert set(wl["limits"]) <= set(row["control"])
        assert check.verdict(wl["limits"], row["program"])[0]
    assert set(lines[-1]["program_max"]) == set(lines[0]["program"])


def test_least_counts_the_passes():
    """At the cell's size: mode 0 sketched first, a view; about 1.1e13
    operations a call, bound by operations at the f32 peak."""
    kind = loader.kind(loader.workload(CELL))
    cfg = loader.config("tucker_hcci")
    s, op = cfg["settings"], cfg["operand"]
    passes = kind.mode_passes(op["shape"], s["ranks"], s["p"])
    assert [m for m, *_ in passes] == [0, 1, 3, 2]
    assert passes[0] == (0, 672, 672 * 33 * 627, 106, 96)
    ops, nbytes = kind.products_work(op["shape"], s["ranks"], s["p"],
                                     s["q"])
    t, by = kind.least(loader.workload(CELL), cfg, 1)
    assert by == "operations" and 0.15 < t < 0.2
    assert ops / 67e12 == pytest.approx(t)
    assert nbytes / 3.35e12 < 0.5 * t
