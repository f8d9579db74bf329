"""The reading of the program's own ``rsvd/`` spans (``portbench/
spans.py``): by hand on synthetic events, a tiny traced run on the CPU
with spans on, and (``-m card``) the launches of a traced 4096^2 call
inside the spans they are filed under."""

from __future__ import annotations

import pytest

from portbench import spans, trace
from portbench.tests.conftest import run_tiny

SKEW_NS = 50_000


def _synthetic():
    """One call on thread 7: a product span holding a cast span (one
    elementwise kernel) and a GEMM, a tail span with a stream sync inside
    ``aten::linalg_eigh``, a health read under the root's health span;
    the program spans' device copies; a second thread's wait."""
    cpu = [
        ("portbench/call", 0, 200, 1, 7),
        ("rsvd/call", 1, 199, 2, 7),
        ("rsvd/sketch", 2, 60, 3, 7),
        ("rsvd/product", 3, 50, 4, 7),
        ("rsvd/cast", 4, 20, 5, 7),
        ("cudaLaunchKernel", 5, 6, 1001, 7),
        ("aten::mm", 21, 40, 6, 7),
        ("cudaLaunchKernel", 22, 23, 1002, 7),
        ("rsvd/finish", 70, 150, 7, 7),
        ("rsvd/tail", 80, 140, 8, 7),
        ("aten::linalg_eigh", 81, 130, 9, 7),
        ("cudaLaunchKernel", 82, 83, 1003, 7),
        ("cudaStreamSynchronize", 90, 120, 1004, 7),
        ("rsvd/health", 160, 195, 10, 7),
        ("rsvd/read/health_fetch", 170, 190, 11, 7),
        ("aten::_local_scalar_dense", 171, 189, 12, 7),
        ("cudaMemcpy", 172, 188, 1005, 7),
        ("cudaStreamSynchronize", 100, 101, 1006, 8),
    ]
    gpu = [
        ("elementwise_kernel_bf16", 10, 30, 0, 1001),
        ("nvjet_gemm", 30, 60, 6, 1002),
        ("syevj_kernel", 85, 95, 0, 1003),
        ("rsvd/product", 10, 60, 0, 0),            # device copies of
        ("rsvd/call", 10, 199, 0, 0),              # the spans
    ]
    return cpu, gpu


def test_span_annotations_are_not_device_work():
    cpu, gpu = _synthetic()
    bare = [g for g in gpu if not g[0].startswith("rsvd/")]
    want = trace.reduce(cpu, bare)
    got = spans.harness_reduce(cpu, gpu)
    for key in ("busy_s", "layer_s", "syncs", "device_ops_n"):
        assert got[key] == want[key], key
    # read as they are, the copies would fill the call
    assert trace.reduce(cpu, gpu)["busy_s"] > want["busy_s"]


def test_span_reading_by_hand():
    red = spans.reduce(*_synthetic())
    assert red["calls"] == 1
    assert red["span_s"] == {"rsvd/cast": pytest.approx(20e-9),
                             "rsvd/product": pytest.approx(30e-9),
                             "rsvd/tail": pytest.approx(10e-9)}
    incl = red["span_incl_s"]
    assert incl["rsvd/product"] == pytest.approx(50e-9)
    assert incl["rsvd/sketch"] == pytest.approx(50e-9)
    assert incl["rsvd/call"] == pytest.approx(60e-9)
    assert spans.span_ms(red, "cast") == pytest.approx(20e-6)
    assert spans.span_ms(red, "product", inclusive=True) == \
        pytest.approx(50e-6)
    assert spans.span_ms(red, "health") is None
    # two waits on the call's thread, one on another thread
    assert red["host_waits"] == [
        ["rsvd/tail / aten::linalg_eigh / cudaStreamSynchronize", 1.0],
        ["rsvd/read/health_fetch / aten::_local_scalar_dense / cudaMemcpy",
         1.0],
        ["(no program span) / - / cudaStreamSynchronize", 1.0]]
    assert red["waits_outside_stages"] == 1
    # busy [10, 60] and [85, 95] in the window [0, 200]: the gaps'
    # midpoints 5 (in the cast), 72.5 and 147.5 (in the finish)
    idle = dict(red["idle_by_span"])
    assert idle == {"rsvd/finish": pytest.approx(130e-9),
                    "rsvd/cast": pytest.approx(10e-9)}


def test_tiny_traced_run_with_spans_on(tiny_root, monkeypatch):
    """The harness's traced run, on the CPU, with the program's spans on
    and read: the result line is the one a run without them prints, but
    for the numbers of the window."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import profiling

    found = {}
    monkeypatch.setattr(trace, "reduce", spans.reading_into(found))
    with profiling.spans():
        result = run_tiny(tiny_root, "dense_100k.serve_int8", trace=1)
    assert result["correct"]
    assert found["calls"] >= 1
    assert found["waits_outside_stages"] == 0


@pytest.mark.card
def test_launches_lie_inside_their_spans(card):
    """A traced 4096^2 main-path call on the card: each kernel's launch
    lies inside the program span it is filed under, and starts on the
    device no earlier than its launch (one clock for both)."""
    import bisect

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import profiling
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver

    gen = torch.Generator(device=card).manual_seed(5)
    a = torch.randn(4096, 4096, device=card, generator=gen)
    kw = dict(k=64, p=16, q=2, method="eigh", qr_method="cholqr1_fused",
              interior_qr="cholqr1_fused", reorth="half",
              precision="default")
    driver.rsvd(a, seed=1, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            profiling.spans():
        for s in (2, 3):
            with record_function(trace.CALL):
                driver.rsvd(a, seed=s, **kw)
            torch.cuda.synchronize()
    cpu, gpu = trace.events_from_profiler(prof)
    mine = sorted(((s, e, n) for n, s, e, _, _ in cpu
                   if n.startswith(spans.PREFIX)),
                  key=lambda iv: (iv[0], -iv[1]))
    nested = trace.Nested(mine)
    launches = {c: (s, e) for n, s, e, c, _ in cpu if trace._is_runtime(n)}
    kernels = [g for g in gpu if not trace._annotation(g[0])
               and not spans.program_span(g[0])]
    assert kernels
    filed, skew = 0, 0
    for name, ks, _, _, corr in kernels:
        if corr not in launches:
            continue
        ls, le = launches[corr]
        skew = max(skew, ls - ks)
        i = bisect.bisect_right(nested.starts, ls) - 1
        while i >= 0 and nested.items[i][1] < ls:
            i = nested.parent[i]
        if i < 0:
            continue                  # launched outside the calls
        ss, se, _ = nested.items[i]
        assert ss <= ls and le <= se, name
        filed += 1
    # the two calls' kernels, each under its spans
    assert filed >= 2 * 6
    # CUPTI puts the device's timestamps on the host clock: a kernel
    # starts after its launch, to within the conversion's error (an H100
    # read one up to 7.3 us before its launch began)
    print(f"kernels filed {filed}; device start before launch at most "
          f"{skew / 1e3:.1f} us")
    assert skew < SKEW_NS
