"""The port's ``tucker`` against a plain f64 ST-HOSVD (``_tucker_ref.py``)
on small planted tensors, with the readings that hold its core and
factors to it; faults that the readings must catch; the unfolding
counter and the spans of a Tucker call; and Omega drawn inside the
sketch, freed before the power rounds, leaving the factors bitwise as
they were.  CPU, f32 tensors, seeded.
"""

from __future__ import annotations

import importlib
import math
import weakref

import pytest
import torch

import _tucker_ref as ref_f64

PKG = "rsvd_kamaneh_raganato_terrana_tpu_torch"
tucker = importlib.import_module(PKG + ".rsvd.tucker")
profiling = importlib.import_module(PKG + ".core.profiling")

P, Q = 10, 1
# the largest mode second (its unfolding copies the whole tensor), and
# first (a view)
SHAPES = {"largest_second": ([14, 24, 6, 18], [8, 12, 6, 10], [4, 6, 3, 5]),
          "largest_first": ([24, 14, 6, 18], [12, 8, 6, 10], [6, 4, 3, 5])}
# f32 roundoff (2^-24 ~ 6e-8 a product) grown by each mode's relative
# eigenvalue gap (~2 / decay = 0.5 at the leading cut) and by the
# sketch, power round and contraction that carry it on.  Over these
# shapes and eight seeds the port reads at most 3.1e-6 in err_gap,
# 2.6e-7 in orth_gap and 7.1e-7 in lead_gap; the reference at TF32
# (10-bit mantissa) at least 4.7e-5, 3.4e-4 and 4.7e-4.  fit_gap, the
# true error of core and factors together, moves only at second order
# in the roundoff: the port reads at most 4.8e-9, TF32 (its factors
# rounded) at least 3.0e-6.  Each tolerance lies between
TOL = {"err_gap": 1e-4, "fit_gap": 1e-6, "orth_gap": 1e-5,
       "lead_gap": 1e-4}


def _operand(shape, core_rank, seed):
    return ref_f64.planted(shape, core_rank, [4.0, 4.0, 1.5, 4.0], 3000.0,
                           seed)


def _readings(a, ranks, out, seed, numerics="exact"):
    core, factors = out
    ref = ref_f64.sthosvd(a, ranks, P, Q, seed, gauge=factors)
    found = ref_f64.readings(a, core, factors, ref)
    if numerics == "exact":
        return found
    low = ref_f64.sthosvd(a, ranks, P, Q, seed, numerics, ref[1])
    return found, ref_f64.readings(a, low[0], low[1], ref)


@pytest.mark.parametrize("layout", sorted(SHAPES))
@pytest.mark.parametrize("seed", [3_000_000_019, 2 ** 31 + 12_345])
def test_tucker_matches_the_f64_reference(layout, seed):
    """Every reading under its tolerance; the TF32 control of the same
    reference over at least one, so the tolerance tells f32 from it."""
    shape, core_rank, ranks = SHAPES[layout]
    a = _operand(shape, core_rank, seed)
    out = tucker.tucker(a, ranks, p=P, q=Q, seed=seed + 1)
    found, control = _readings(a, ranks, out, seed + 1, "tf32")
    for name, tol in TOL.items():
        assert found[name] <= tol, (name, found)
    assert any(control[name] > tol for name, tol in TOL.items()), control
    assert tuple(out[0].shape) == tuple(ranks)


def _fault_contraction_skipped(monkeypatch):
    """The first mode's contraction left out: its first r rows of the
    unfolding go on in place of U^T X."""
    real, seen = tucker.tighten_contract, []

    def skipped(unf, q_mat, r, prec):
        u, contracted = real(unf, q_mat, r, prec)
        seen.append(r)
        return u, (unf[:r].contiguous() if len(seen) == 1 else contracted)
    monkeypatch.setattr(tucker, "tighten_contract", skipped)


@pytest.mark.parametrize("fault", ["contraction_skipped", "column_off"])
def test_faults_fail_the_readings(monkeypatch, fault):
    """A left-out contraction, or a factor's leading column made 10%
    longer, reads over the true error's tolerance and another."""
    shape, core_rank, ranks = SHAPES["largest_second"]
    seed = 3_000_000_019
    a = _operand(shape, core_rank, seed)
    if fault == "contraction_skipped":
        _fault_contraction_skipped(monkeypatch)
    core, factors = tucker.tucker(a, ranks, p=P, q=Q, seed=seed + 1)
    if fault == "column_off":
        factors = list(factors)
        factors[1] = factors[1].clone()
        factors[1][:, 0] *= 1.1
    found = _readings(a, ranks, (core, factors), seed + 1)
    over = {name for name, tol in TOL.items() if found[name] > tol}
    assert "fit_gap" in over and len(over) >= 2, found


@pytest.mark.parametrize("layout", sorted(SHAPES))
def test_unfold_tally_counts_copies_only(layout, monkeypatch):
    """An unfolding that is a view of the core (the tensor's mode 0 taken
    first; a last axis, read transposed) counts no bytes, one that
    copies counts its bytes: the tally matches what each unfolding
    shared with its input, over two calls."""
    shape, core_rank, ranks = SHAPES[layout]
    a = _operand(shape, core_rank, 7)
    real, seen = tucker._unfold, []

    def watched(t, mode):
        out = real(t, mode)
        shared = (out.untyped_storage().data_ptr()
                  == t.untyped_storage().data_ptr())
        seen.append((mode, 0 if shared else out.numel() * 4))
        return out
    monkeypatch.setattr(tucker, "_unfold", watched)
    tucker.reset_unfold_tally()
    tucker.tucker(a, ranks, p=P, q=Q, seed=5)
    tucker.tucker(a, ranks, p=P, q=Q, seed=6)
    copied = [b for _, b in seen if b]
    assert tucker.unfold_tally() == {"calls": 2, "copies": len(copied),
                                     "bytes": sum(copied)}
    first_mode, first_bytes = seen[0]
    if layout == "largest_first":
        assert (first_mode, first_bytes) == (0, 0)
    else:
        assert (first_mode, first_bytes) == (1, a.numel() * 4)
    assert 2 <= len(copied) // 2 <= 4
    tucker.reset_unfold_tally()
    assert tucker.unfold_tally() == {"calls": 0, "copies": 0, "bytes": 0}


def _span_names(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith("rsvd/")]


@pytest.mark.parametrize("entry", ["tucker", "tucker_adaptive"])
def test_tucker_spans(entry):
    """Under ``profiling.spans()``: one ``rsvd/call``, one ``rsvd/mode``
    a mode, ``rsvd/unfold`` for each unfolding, ``rsvd/tail``
    for each mode's eigh, and the driver's spans below them; none with
    spans off."""
    shape, core_rank, ranks = SHAPES["largest_second"]
    a = _operand(shape, core_rank, 11)
    if entry == "tucker":
        call = lambda: tucker.tucker(a, ranks, p=P, q=Q, seed=3)  # noqa
    else:
        call = lambda: tucker.tucker_adaptive(a, 0.5, p=P, q=Q,  # noqa
                                              seed=3)
    with profiling.spans():
        names = _span_names(call)
    assert names.count("rsvd/call") == 1
    assert names.count("rsvd/mode") == 4
    assert names.count("rsvd/unfold") == 4
    assert names.count("rsvd/tail") == 4
    assert {"rsvd/sketch", "rsvd/power", "rsvd/product",
            "rsvd/ortho"} <= set(names)
    assert _span_names(call) == []


def _tucker_omega_held(a, ranks, p, q, seed):
    """The loop as it was: each mode's Omega drawn before the range
    finder and held through it (single tensor, 'highest')."""
    driver = importlib.import_module(PKG + ".rsvd.driver")
    modewise = importlib.import_module(PKG + ".rsvd._modewise")
    core, shape = a, list(a.shape)
    factors = [None] * len(shape)
    for mode in tucker._order(a.shape):
        unf = tucker._unfold(core, mode)
        rest = math.prod(shape) // shape[mode]
        l = min(ranks[mode] + p, shape[mode], rest)
        omega = driver.generate_omega(seed + 7919 * mode, rest, l,
                                      core.dtype, device=core.device)
        q_mat = driver.subspace_iteration(unf, omega, q,
                                          precision="highest")
        u, contracted = modewise.tighten_contract(unf, q_mat, ranks[mode],
                                                  "highest")
        factors[mode] = u
        shape[mode] = ranks[mode]
        core = tucker._fold(contracted, mode, shape)
    return core, factors


@pytest.mark.parametrize("layout", sorted(SHAPES))
def test_omega_in_the_sketch_is_bitwise_and_freed(layout, monkeypatch):
    """Drawn inside the sketch, each mode's Omega gives the factors and
    core of the draw made before it, bit for bit, and is gone before the
    mode's tightening."""
    shape, core_rank, ranks = SHAPES[layout]
    a = _operand(shape, core_rank, 13)
    want_core, want = _tucker_omega_held(a, ranks, P, Q, 17)

    drawn, alive = [], []
    draw, tighten = tucker.generate_omega, tucker.tighten_contract

    def watched_draw(*args, **kw):
        omega = draw(*args, **kw)
        drawn.append(weakref.ref(omega))
        return omega

    def watched_tighten(*args):
        alive.append(drawn[-1]() is not None)
        return tighten(*args)
    monkeypatch.setattr(tucker, "generate_omega", watched_draw)
    monkeypatch.setattr(tucker, "tighten_contract", watched_tighten)
    core, factors = tucker.tucker(a, ranks, p=P, q=Q, seed=17)
    assert torch.equal(core, want_core)
    for got, ref in zip(factors, want):
        assert torch.equal(got, ref)
    assert len(drawn) == 4 and alive == [False] * 4
