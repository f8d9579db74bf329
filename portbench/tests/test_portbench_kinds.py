"""A cell's kind (``kinds/<kind>.py``) as files: a kind whose entry returns
one tensor, not (U, s, V), dropped in beside its configuration and
workload, runs and is judged by its own reference, and a kind's spans
stay in its own cells."""

from __future__ import annotations

import json

import pytest

from portbench import check, control, loader, trace
from portbench.tests.conftest import run_tiny

PKG = "rsvd_kamaneh_raganato_terrana_tpu_torch"
TOY = "norm2"
TOY_CELL = "dense_norm2.power"

# the whole kind: the port's spectral_norm_estimate against the exact
# f64 norm of the same operand, its least time that of 2 num_iters + 1
# f32 passes over A
TOY_KIND = '''
import torch

from portbench import operands, roofline

SPANS = {"products": [
    "rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.diagnostics:power_triplet"]}


def build(wl, cfg, seed, device, rank=0, mesh=None):
    a = operands.planted_part(cfg["operand"], seed, 0, device)
    return a, a


def sample(out):
    sigma = out.reshape(1)
    return dict(sigma=sigma), ~torch.isfinite(sigma[0]), False


def _norm(a):
    return float(torch.linalg.matrix_norm(a.to(torch.float64), ord=2))


def readings(wl, cfg, samples, held, seed, device, comm, control=None):
    ref = _norm(held)
    prog = {"sigma_gap": max(abs(float(s["sigma"][0]) - ref) / ref
                             for s in samples)}
    if control is None:
        return prog
    low = _norm(held.to(getattr(torch, control)))
    return prog, {"sigma_gap": abs(low - ref) / ref}


def least(wl, cfg, world):
    op, it = cfg["operand"], cfg["settings"]["num_iters"]
    passes = 2 * it + 1
    return roofline.bound(2.0 * op["rows"] * op["cols"] * passes,
                          4.0 * op["rows"] * op["cols"] * passes, "fp32")
'''


def _add_toy(root):
    """The toy kind, its configuration and its workload as new files, and
    their entries in the copy's BENCHMARK.json."""
    (root / "kinds" / f"{TOY}.py").write_text(TOY_KIND)
    cfg = json.loads((root / "configs" / "dense_100k.json").read_text())
    cfg.update(name="dense_norm2", settings={"num_iters": 30},
               operand=dict(cfg["operand"], decay=2.0))
    (root / "configs" / "dense_norm2.json").write_text(json.dumps(cfg))
    wl = json.loads((root / "workloads" / "dense_100k.fit.json").read_text())
    wl.update(name=TOY_CELL, config="dense_norm2", traffic="power",
              kind=TOY, kwargs={},
              entry=PKG + ".rsvd.diagnostics:spectral_norm_estimate",
              reference={"control": "bfloat16"},
              limits={"sigma_gap": 1e-4})
    for key in ("form", "products"):
        del wl[key]
    (root / "workloads" / f"{TOY_CELL}.json").write_text(json.dumps(wl))
    bench_path = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "dense_norm2", "source": "s",
                             "file": "portbench/configs/dense_norm2.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": TOY_CELL, "config": "dense_norm2",
                               "traffic": "power", "chips": 1, "why": "w"})
    bench_path.write_text(json.dumps(bench))


@pytest.mark.parametrize("trace_on", [0, 1])
def test_toy_kind_runs_and_is_judged(tiny_root, monkeypatch, trace_on):
    """A kind whose entry returns one tensor runs from new files alone:
    correct as the program stands, not correct with its answer altered
    by 10% where it is produced."""
    import importlib
    _add_toy(tiny_root)
    res = run_tiny(tiny_root, TOY_CELL, trace=trace_on)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert list(res["checks"]) == ["sigma_gap"]
    if not trace_on:
        assert {"call_ms", "setup_s"} <= set(res["metrics"])

    diag = importlib.import_module(PKG + ".rsvd.diagnostics")
    est = diag.spectral_norm_estimate
    monkeypatch.setattr(diag, "spectral_norm_estimate",
                        lambda *a, **kw: est(*a, **kw) * 1.1)
    bad = run_tiny(tiny_root, TOY_CELL, trace=trace_on)
    assert bad["correct"] is False
    assert bad["checks"]["sigma_gap"]["value"] > 0.05


def test_toy_kind_control(tiny_root, capsys):
    """control.py runs through the kind: the program passes the limit on
    every seed, the reference at the control's precision fails it."""
    _add_toy(tiny_root)
    control.main(["--workload", TOY_CELL, "--seeds", "21,22,23",
                  "--calls", "1"], root=tiny_root, device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    for row in lines[:-1]:
        assert check.verdict({"sigma_gap": 1e-4}, row["program"])[0]
        assert not check.verdict({"sigma_gap": 1e-4}, row["control"])[0]


def test_kind_spans_stay_in_their_cells(tiny_root):
    """A kind's SPANS are wrapped in its own cells only: an ``rsvd`` cell
    wraps exactly the targets of ``layers.json``, the toy cell those and
    its own, and every wrapped function is put back after the block."""
    import importlib
    _add_toy(tiny_root)
    spec = json.loads((tiny_root / "layers.json").read_text())["spans"]
    want = sorted((layer, t) for layer, ts in spec.items() for t in ts)
    diag = importlib.import_module(PKG + ".rsvd.diagnostics")
    before = diag.power_triplet
    for cell, extra in (("dense_100k.fit", []),
                        (TOY_CELL, [("products", PKG + ".rsvd.diagnostics:"
                                     "power_triplet")])):
        wl = loader.workload(cell, tiny_root)
        kind = loader.kind(wl, tiny_root)
        with trace.layer_spans(tiny_root, getattr(kind, "SPANS", None)) \
                as wrapped:
            assert sorted(wrapped) == sorted(want + extra)
            assert (diag.power_triplet is not before) == bool(extra)
        assert diag.power_triplet is before
    assert loader.kind({"name": "x"}, tiny_root).__file__.endswith(
        "kinds/rsvd.py")
    with pytest.raises(ValueError):
        loader.kind({"kind": "../rsvd"}, tiny_root)

