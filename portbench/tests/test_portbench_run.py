"""Runs of the harness: no card, no result; nothing of JAX loaded; and a
run with the timed path broken underneath comes out not correct, once
for each fault a one-card cell can have, as does the control."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import check, control, run
from portbench.tests.conftest import REPO, run_tiny

ONE_CARD = ("dense_100k.fit", "recsys_ml20m.embed", "dense_100k.serve_int8")
PKG = "rsvd_kamaneh_raganato_terrana_tpu_torch"


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints nothing on
    standard output: it never falls back to the CPU."""
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "dense_100k.fit",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_nothing_of_jax_is_loaded():
    """After the harness, the references and the port are imported, no
    top-level module name (before the first dot, whole) is JAX's or the
    JAX package's: the port's own name begins with the latter's."""
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.run as r, portbench.check, portbench.control,"
            " portbench.forms, portbench.trace;"
            f" import {PKG}.rsvd.driver, {PKG}.rsvd.serving;"
            " print(r.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    assert run.forbidden_modules({PKG: 1, PKG + ".rsvd": 1}) == []
    assert run.forbidden_modules({"jax.numpy": 1, "os": 1}) == ["jax"]
    assert run.forbidden_modules({PKG[:-6] + ".core": 1}) == [PKG[:-6]]


@pytest.mark.parametrize("workload", ONE_CARD)
def test_sound_run_is_correct(tiny_root, workload):
    res = run_tiny(tiny_root, workload)
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"call_ms", "call_ms_p95", "peak_mem_gib",
                                   "setup_s"}


def _unchanged_state(monkeypatch, driver):
    """Every power round returns the basis it was given."""
    monkeypatch.setattr(driver, "_power_rounds",
                        lambda a, q_mat, *args, **kw: q_mat)


def _half_left_out(monkeypatch, driver):
    """Each product contracts half of its panel's rows, the other half
    left out and the rest doubled: the mean over the rest."""
    mm = driver._mm

    def half(a, b, *args, **kw):
        if isinstance(b, torch.Tensor) and b.dim() == 2 and b.shape[0] > 1:
            b = b.clone()
            b[b.shape[0] // 2:] = 0
            b[:b.shape[0] // 2] *= 2
        return mm(a, b, *args, **kw)
    monkeypatch.setattr(driver, "_mm", half)


def _answer_altered(monkeypatch, driver):
    """The factors' first value altered by 10% where they are made."""
    fn = driver.rsvd_with_omega

    def altered(*args, **kw):
        u, s, v = fn(*args, **kw)
        return u, torch.cat([s[:1] * 1.1, s[1:]]), v
    monkeypatch.setattr(driver, "rsvd_with_omega", altered)


FAULTS = {"state_unchanged": _unchanged_state,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ONE_CARD)
def test_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    import importlib
    driver = importlib.import_module(PKG + ".rsvd.driver")
    FAULTS[fault](monkeypatch, driver)
    res = run_tiny(tiny_root, workload)
    assert res["correct"] is False
    assert res["failed"] > 0 or any(
        c["value"] is None or c["value"] > c["limit"]
        for c in res["checks"].values())


@pytest.mark.parametrize("workload", ONE_CARD)
def test_control_is_not_correct(tiny_root, workload, capsys):
    """The reference computed one precision lower in the program's place
    fails a limit on every seed, while the program passes them."""
    summary = control.main(["--workload", workload, "--seeds", "11,12,13",
                            "--calls", "1"], root=tiny_root, device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    limits = json.loads((tiny_root / "workloads" / f"{workload}.json")
                        .read_text())["limits"]
    for row in lines[:-1]:
        assert check.verdict(limits, row["program"])[0] is True
        assert check.verdict(limits, row["control"])[0] is False
    assert summary["workload"] == workload


@pytest.mark.card
@pytest.mark.parametrize("workload", ONE_CARD)
def test_cell_on_the_card(card, workload):
    """The committed cell, run as the driver runs it, is correct."""
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "2147484001", "--seconds", "2", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
