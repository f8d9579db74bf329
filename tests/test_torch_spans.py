"""The port's own spans (``core/profiling.py``: ``span``, ``spans()``,
``call_span``) on the CPU: the tree one call opens, nothing with spans
off, the same factors either way, one collective span for each tallied
collective on four gloo ranks, and ``rsvd_batched(mode='vmap')`` under
spans on.  Each test traces small operands with a CPU-only
``torch.profiler``."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rsvd_kamaneh_raganato_terrana_tpu_torch.core import profiling
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.serving import (
    prepare_operand,
    rsvd_serving,
)

from _torch_ranks import RankGroup

# the main path's settings (entry.py; the benchmark's dense fit)
MAIN = dict(method="eigh", qr_method="cholqr1_fused",
            interior_qr="cholqr1_fused", reorth="half", precision="default")
STAGES = ("rsvd/stage", "rsvd/sketch", "rsvd/power", "rsvd/finish",
          "rsvd/health")
UNDER_STAGES = ("rsvd/sketch", "rsvd/power", "rsvd/finish")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _operand(m=160, n=96, seed=0):
    r = np.random.default_rng(seed)
    u, _ = np.linalg.qr(r.standard_normal((m, n)))
    v, _ = np.linalg.qr(r.standard_normal((n, n)))
    return torch.from_numpy(((u * np.geomspace(1.0, 1e-3, n)) @ v.T)
                            .astype(np.float32))


def _traced(fn, on=True):
    """(fn's result, its ``rsvd/`` spans as (name, start, end, parent),
    parents by nesting, in start order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            profiling.spans(on):
        out = fn()
    evs = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(profiling.PREFIX)),
                 key=lambda e: (e[1], -e[2]))
    tree, stack = [], []
    for name, s, e in evs:
        while stack and stack[-1][2] < e:
            stack.pop()
        tree.append((name, s, e, stack[-1][0] if stack else None))
        stack.append((name, s, e))
    return out, tree


def _counts(tree):
    return collections.Counter(name for name, *_ in tree)


def _same(x, y):
    return all(torch.equal(a, b) for a, b in zip(x, y))


def test_project_call_opens_one_tree():
    a = _operand()
    q = 2
    _, tree = _traced(lambda: driver.rsvd(a, k=8, p=8, q=q, seed=5, **MAIN))
    n = _counts(tree)
    assert n["rsvd/call"] == 1 and n["rsvd/sketch"] == 1
    assert n["rsvd/power"] == q and n["rsvd/product"] == 2 * q + 2
    assert n["rsvd/tail"] == 1 and n["rsvd/finish"] == 1
    assert n["rsvd/stage"] == 1
    parent = {"rsvd/product": UNDER_STAGES, "rsvd/ortho": UNDER_STAGES,
              "rsvd/tail": ("rsvd/finish",), "rsvd/cast": ("rsvd/product",)}
    for name, _, _, up in tree:
        if name == "rsvd/call":
            assert up is None
        elif name in STAGES:
            assert up == "rsvd/call", name
        else:
            assert up in parent[name], (name, up)


def test_rowspace_utv_opens_no_tail():
    a = _operand()
    q = 2
    _, tree = _traced(lambda: driver.rsvd(
        a, k=8, p=8, q=q, seed=5, **{**MAIN, "finish": "rowspace_utv"}))
    n = _counts(tree)
    assert n["rsvd/product"] == 2 * q + 1
    assert n["rsvd/power"] == q - 1
    assert "rsvd/tail" not in n
    assert n["rsvd/call"] == n["rsvd/sketch"] == n["rsvd/finish"] == 1


def test_serving_opens_one_root_and_its_health():
    a8 = prepare_operand(_operand())
    _, tree = _traced(lambda: rsvd_serving(a8, k=8, p=8, q=2, seed=9))
    n = _counts(tree)
    assert n["rsvd/call"] == 1
    assert n["rsvd/health"] == 1 and n["rsvd/read/health_fetch"] == 1
    # the int8 path narrows each stage-A product's panel: 2q + 1 of them
    assert n["rsvd/cast"] == 5 and n["rsvd/product"] >= 5
    (fetch,) = [up for name, _, _, up in tree
                if name == "rsvd/read/health_fetch"]
    assert fetch == "rsvd/health"


def test_robust_qr_reads_its_flag_once_each():
    a = _operand()
    _, tree = _traced(lambda: driver.rsvd(a, k=8, p=8, q=2, seed=5,
                                          method="eigh", qr_method="robust"))
    n = _counts(tree)
    # the sketch's basis and both sides of each of two full rounds
    assert n["rsvd/ortho"] == 5
    assert n["rsvd/read/qr_degraded"] == n["rsvd/ortho"]


def test_spans_off_open_nothing_and_change_no_bit():
    a = _operand()
    a8 = prepare_operand(a)
    calls = {
        "rsvd": lambda: driver.rsvd(a, k=8, p=8, q=2, seed=5, **MAIN),
        "serving": lambda: rsvd_serving(a8, k=8, p=8, q=2, seed=9)[:3],
        "robust": lambda: driver.rsvd(a, k=8, p=8, q=2, seed=5,
                                      qr_method="robust"),
    }
    for name, fn in calls.items():
        off, tree = _traced(fn, on=False)
        assert tree == [], name
        on, tree = _traced(fn)
        assert tree and _same(off, on), name


def test_vmap_batch_runs_with_spans_on():
    x = torch.stack([_operand(64, 48, seed=i) for i in range(3)])
    kw = dict(k=6, p=4, q=1, seed=2, mode="vmap")
    off = driver.rsvd_batched(x, **kw)
    on, tree = _traced(lambda: driver.rsvd_batched(x, **kw))
    assert _same(off, on)
    assert tree == []          # spans stay off under the transform


def test_sharded_collective_spans_match_the_tally():
    a = _operand(256, 64, seed=3).numpy().astype(np.float64)
    omega = np.random.default_rng(4).standard_normal((64, 16))
    group = RankGroup(4)
    try:
        res = group.run("spans", a=a, omega=omega, q=2, k=8, method="eigh",
                        qr_method="cholqr1_fused", reorth="half",
                        timeout=120.0)
    finally:
        group.close()
    for r in res:
        assert r["same"] and r["off"] == {}
        assert r["tally"] == r["tally_off"] and r["tally"]
        got = {name[len("rsvd/collective/"):]: n
               for name, n in r["on"].items()
               if name.startswith("rsvd/collective/")}
        assert got == {kind: t["calls"] for kind, t in r["tally"].items()}
        assert r["on"]["rsvd/call"] == 1
