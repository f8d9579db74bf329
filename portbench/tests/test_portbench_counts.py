"""The window's statistics, the roofline's counts and the trace's
reduction against numbers worked out by hand."""

from __future__ import annotations

import pytest

from portbench import roofline, stats, trace


def test_percentile_nearest_rank():
    xs = list(range(1, 101))                      # 1 .. 100
    assert stats.percentile(xs, 95.0) == 95
    assert stats.percentile(list(reversed(xs)), 95.0) == 95
    assert stats.percentile([7.0], 95.0) == 7.0
    assert stats.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                             15, 16, 17, 18, 19, 100], 95.0) == 19
    with pytest.raises(ValueError):
        stats.percentile([], 95.0)


def test_windowed_rate():
    assert stats.per_call_ms(30.0, 200) == 150.0
    with pytest.raises(ValueError):
        stats.per_call_ms(30.0, 0)


def test_dense_default_bytes_are_14mn():
    m, n, l = 100_000, 100_000, 144
    work = {"passes": 6, "a_first": 4, "a_other": 2, "panel": 2,
            "peak": "bf16"}
    t, by, ops, nbytes = roofline.products_least(work, m, n, l)
    panels = 3 * (n * l * 2 + m * l * 4) + 3 * (m * l * 2 + n * l * 4)
    assert nbytes == 14 * m * n + panels
    assert ops == 12.0 * m * n * l
    assert by == "bytes"
    assert t == pytest.approx(nbytes / 3.35e12)
    assert t == pytest.approx(0.0419, rel=0.01)          # ~41.8 ms + panels


def test_int8_bytes_are_one_byte_a_pass():
    m = n = 100_000
    l = 144
    six = {"passes": 6, "a_first": 1, "a_other": 1, "panel": 1,
           "peak": "int8"}
    _, _, _, nbytes = roofline.products_least(six, m, n, l)
    assert nbytes - 6 * m * n == 6 * (n * l * 1 + m * l * 4)
    five = dict(six, passes=5)
    _, by, ops, nbytes = roofline.products_least(five, m, n, l)
    assert nbytes - 5 * m * n == 3 * (n * l + m * l * 4) + 2 * (
        m * l + n * l * 4)
    assert by == "bytes" and ops == 10.0 * m * n * l


def test_sparse_bytes_are_spmm_bytes_a_pass():
    rows, cols, nnz, l = 138_493, 26_744, 20_000_263, 80
    assert roofline.spmm_bytes(rows, cols, nnz, l) == (
        nnz * 8 + 4 * (rows + 1) + 4 * l * (rows + cols))
    work = {"passes": 6, "sparse": True, "peak": "fp32"}
    t, by, ops, nbytes = roofline.products_least(work, rows, cols, l, nnz)
    assert nbytes == 3 * roofline.spmm_bytes(rows, cols, nnz, l) \
        + 3 * roofline.spmm_bytes(cols, rows, nnz, l)
    assert ops == 2.0 * nnz * l * 6
    assert by == "bytes"


def test_bound_takes_the_precisions_peak():
    assert roofline.bound(989e12, 1.0, "bf16") == (1.0, "operations")
    assert roofline.bound(1.0, 3.35e12, "int8") == (1.0, "bytes")
    t, _ = roofline.bound(1979e12, 0.0, "int8")
    assert t == pytest.approx(1.0)


def _synthetic():
    """Two calls on one thread; call 1 launches a GEMM inside a products
    span and a K1 kernel inside an ortho span, call 2 an NCCL kernel and
    an elementwise kernel outside every span; two kernels overlap on two
    streams; one launch after the calls (not counted)."""
    cpu = [
        ("portbench/call", 0, 100, 1, 7),
        ("portbench/products", 10, 40, 2, 7),
        ("aten::mm", 11, 39, 3, 7),
        ("cudaLaunchKernel", 12, 13, 1001, 7),
        ("portbench/ortho", 50, 60, 4, 7),
        ("cudaLaunchKernelExC", 51, 52, 1002, 7),
        ("aten::_local_scalar_dense", 70, 90, 5, 7),
        ("cudaStreamSynchronize", 72, 89, 1003, 7),
        ("portbench/call", 200, 300, 6, 7),
        ("cudaLaunchKernel", 210, 211, 1004, 7),
        ("cudaLaunchKernel", 220, 221, 1005, 7),
        ("cudaMemcpy", 230, 231, 1006, 7),
        ("cudaLaunchKernel", 400, 401, 1007, 7),
    ]
    gpu = [
        ("nvjet_hsh_gemm", 20, 60, 3, 1001),
        ("gram_cluster<80>", 55, 65, 0, 1002),       # overlaps the GEMM
        ("ncclDevKernel_AllReduce", 220, 240, 0, 1004),
        ("elementwise_kernel", 230, 250, 0, 1005),
        ("late_kernel", 400, 410, 0, 1007),
        ("portbench/products", 15, 70, 0, 0),        # a span's device copy
        ("nccl:all_reduce", 215, 245, 0, 0),         # torch's, likewise
    ]
    return cpu, gpu


def test_reduce_by_hand():
    red = trace.reduce(*_synthetic())
    assert red["calls"] == 2
    assert red["window_s"] == pytest.approx(300e-9)
    # union: [20, 65] and [220, 250]
    assert red["busy_s"] == pytest.approx(75e-9)
    ls = red["layer_s"]
    assert ls["products"] == pytest.approx(40e-9)
    assert ls["ortho"] == pytest.approx(10e-9)
    assert ls["collectives"] == pytest.approx(20e-9)
    assert ls["other"] == pytest.approx(20e-9)
    assert red["syncs"] == 2           # one stream sync, one cudaMemcpy
    assert red["resolved"] == 5
    assert sum(v for _, v in red["idle_gaps"]) == pytest.approx(225e-9)
    r = trace.Reading(red, red["busy_s"], 10e-9, 4e6)
    assert r.layer_ms("products") == pytest.approx(1e3 * 20e-9)
    assert r.layer_ms("tail") is None


def test_kernel_groups_file_by_name():
    assert trace.kernel_group("ncclDevKernel_AllReduce_Sum_f32")[1] == \
        "collectives"
    assert trace.kernel_group("eigh_cluster<256>")[1] == "tail"
    assert trace.kernel_group("cusparse::csrmm_v2_kernel")[1] == "products"
    assert trace.kernel_group("sm90_xmma_gemm_bf16")[1] == "products"
    assert trace.kernel_group("eliminate_cluster")[1] == "ortho"
    assert trace.kernel_group("vectorized_elementwise_kernel") == (
        "other kernels", "other")


class _Event:
    """The methods of a profiler event that ``events_from_profiler``
    reads, and nothing more."""

    def __init__(self, name, dev, start, dur, corr, linked=0, tid=1):
        self._v = (name, dev, start, dur, corr, linked, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def test_events_from_profiler_reads_both_sides():
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    evs = [_Event("portbench/call", DeviceType.CPU, 0, 100, 1),
           _Event("cudaLaunchKernel", DeviceType.CPU, 5, 1, 9),
           _Event("gemm", DeviceType.CUDA, 10, 20, 9, 0)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    cpu, gpu = trace.events_from_profiler(prof)
    assert cpu == [("portbench/call", 0, 100, 1, 1),
                   ("cudaLaunchKernel", 5, 6, 9, 1)]
    assert gpu == [("gemm", 10, 30, 0, 9)]
    red = trace.reduce(cpu, gpu)
    assert red["layer_s"] == {"products": pytest.approx(20e-9)}
