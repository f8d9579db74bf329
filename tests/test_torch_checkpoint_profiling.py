"""The port's factor checkpoints (``core/checkpoint.py``) and profiling
harness (``core/profiling.py``) against the JAX package's, on the CPU.

Each case of ``tests/test_checkpoint.py`` runs here on the port (the
orbax one beside the port's ``torch.distributed.checkpoint`` pair, on
the same arrays, both bitwise), and the ``.npz`` files are held to the
JAX package's: what one package writes, the other reads back bit for
bit (``.npz`` keys and arrays alike), and a model the JAX package saved
loads as the port's type.
Models are compared through what they compute (``deim_interpolate``,
``hodlr_matvec``) to 1e-12 absolute, the arrays themselves exactly."""

import csv
import functools
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.core import checkpoint as jck
from rsvd_kamaneh_raganato_terrana_tpu.core import profiling as jprof
from rsvd_kamaneh_raganato_terrana_tpu.core.io import (
    read_matrix_market as jax_read_matrix_market,
)
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import deim as jdeim
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import hodlr as jhodlr
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import checkpoint as tck
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import profiling as tprof
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.io import (
    read_matrix_market,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import deim as tdeim
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import hodlr as thodlr

from_numpy = functools.partial(convert.from_numpy, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _triple(rng, dtype=np.float64):
    return (rng.standard_normal((20, 5)).astype(dtype),
            rng.random(5).astype(dtype),
            rng.standard_normal((15, 5)).astype(dtype))


@pytest.mark.parametrize("as_tensors", [False, True])
def test_factor_roundtrip(tmp_path, rng, as_tensors):
    u, s, v = _triple(rng)
    args = tuple(from_numpy(x) for x in (u, s, v)) if as_tensors \
        else (u, s, v)
    path = str(tmp_path / "ck.npz")
    tck.save_factors(path, *args, meta={"k": 5, "source": "test"})
    u2, s2, v2, meta = tck.load_factors(path)
    for got, want in ((u2, u), (s2, s), (v2, v)):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
    assert meta == {"k": 5, "source": "test"}


def test_factor_files_cross_load_with_jax(tmp_path, rng):
    u, s, v = _triple(rng, np.float32)
    tck.save_factors(str(tmp_path / "port"), from_numpy(u), from_numpy(s),
                     from_numpy(v), meta={"k": 5})
    jck.save_factors(str(tmp_path / "jax"), u, s, v, meta={"k": 5})
    for src, reader in (("port", jck.load_factors),
                        ("jax", tck.load_factors)):
        u2, s2, v2, meta = reader(str(tmp_path / src))
        for got, want in ((u2, u), (s2, s), (v2, v)):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        assert meta == {"k": 5}
    with np.load(tmp_path / "port.npz") as zp, \
            np.load(tmp_path / "jax.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files)


def _dcp_triple(rng):
    """tests/test_checkpoint.py:52-54's arrays."""
    return (rng.standard_normal((16, 4)).astype(np.float32),
            rng.random(4).astype(np.float32),
            rng.standard_normal((12, 4)).astype(np.float32))


def test_orbax_and_dcp_roundtrips_agree(tmp_path, rng):
    """JAX's orbax case (tests/test_checkpoint.py:45-62) on the same
    arrays, beside the port's DCP pair: both round trips give the input
    bitwise (so each other), and ``meta`` back."""
    u, s, v = _dcp_triple(rng)
    jck.save_factors_orbax(str(tmp_path / "orbax"), jnp.asarray(u),
                           jnp.asarray(s), jnp.asarray(v), meta={"k": 4})
    jax_back = jck.load_factors_orbax(str(tmp_path / "orbax"))
    tck.save_factors_dcp(str(tmp_path / "dcp"), from_numpy(u),
                         from_numpy(s), from_numpy(v), meta={"k": 4})
    port_back = tck.load_factors_dcp(str(tmp_path / "dcp"), device="cpu")
    for want, got_jax, got in zip((u, s, v), jax_back[:3], port_back[:3]):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(got_jax), want)
        np.testing.assert_array_equal(to_numpy(got), want)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(got_jax))
    assert jax_back[3] == port_back[3] == {"k": 4}
    files = set(os.listdir(tmp_path / "dcp"))
    assert {".metadata", "factor_meta.json"} <= files
    assert any(f.endswith(".distcp") for f in files)


def test_dcp_keeps_bf16(tmp_path, rng):
    u, s, v = _dcp_triple(rng)
    u16 = from_numpy(u).to(torch.bfloat16)
    tck.save_factors_dcp(str(tmp_path / "ck"), u16, from_numpy(s),
                         from_numpy(v))
    u2, s2, v2, meta = tck.load_factors_dcp(str(tmp_path / "ck"),
                                            device="cpu")
    assert u2.dtype == torch.bfloat16 and s2.dtype == torch.float32
    assert torch.equal(u2, u16) and torch.equal(v2, from_numpy(v))
    assert meta == {}


def test_dcp_replaces_an_existing_checkpoint(tmp_path, rng):
    """A second save over the same path replaces it, as orbax's
    ``force=True`` does: other shapes, other dtype, no meta file left."""
    path = str(tmp_path / "ck")
    u, s, v = _dcp_triple(rng)
    tck.save_factors_dcp(path, from_numpy(u), from_numpy(s), from_numpy(v),
                         meta={"k": 4})
    u2, s2, v2 = _triple(rng)                      # f64, 20 x 5, 15 x 5
    tck.save_factors_dcp(path, from_numpy(u2), from_numpy(s2),
                         from_numpy(v2))
    got = tck.load_factors_dcp(path, device="cpu")
    for g, want in zip(got[:3], (u2, s2, v2)):
        assert g.dtype == torch.float64
        np.testing.assert_array_equal(to_numpy(g), want)
    assert got[3] == {}
    assert not os.path.exists(os.path.join(path, "factor_meta.json"))


def test_dcp_without_meta_file_gives_empty_meta(tmp_path, rng):
    path = str(tmp_path / "ck")
    u, s, v = _dcp_triple(rng)
    tck.save_factors_dcp(path, from_numpy(u), from_numpy(s), from_numpy(v),
                         meta={"k": 4})
    os.remove(os.path.join(path, "factor_meta.json"))
    u2, _, _, meta = tck.load_factors_dcp(path, device="cpu")
    assert meta == {}
    np.testing.assert_array_equal(to_numpy(u2), u)


def test_export_matrix_market_layout(tmp_path, rng):
    u = rng.standard_normal((10, 3))
    s = rng.random(3)
    v = rng.standard_normal((8, 3))
    tck.export_matrix_market(str(tmp_path / "port"), "case",
                             from_numpy(u), from_numpy(s), from_numpy(v))
    jck.export_matrix_market(str(tmp_path / "jax"), "case", u, s, v)
    for suffix, ref in (("U", u), ("S", s[:, None]), ("V", v)):
        name = f"case_{suffix}.mtx"
        back = read_matrix_market(str(tmp_path / "port" / name))
        np.testing.assert_allclose(back, ref, atol=1e-15)
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
        np.testing.assert_array_equal(
            jax_read_matrix_market(str(tmp_path / "port" / name)), back)


def test_phase_timer_csv(tmp_path):
    pt = tprof.PhaseTimer()
    for name in ("alpha", "alpha", "beta"):
        with pt.phase(name, sync=from_numpy(np.ones(2))):
            pass
    assert pt.total_ms("alpha") >= 0
    assert pt.avg_us("beta") >= 0
    assert pt.avg_us("missing") == 0.0
    out = tmp_path / "t.csv"
    pt.write_csv(str(out), extra_rows=[{"rank": 4, "err": 0.1}])
    text = out.read_text()
    assert "alpha" in text and "rank" in text
    # the JAX package's CSV for the same phase times, row for row
    jt = jprof.PhaseTimer(phases={k: list(v) for k, v in pt.phases.items()})
    jt.write_csv(str(tmp_path / "j.csv"), extra_rows=[{"rank": 4,
                                                        "err": 0.1}])
    assert (tmp_path / "j.csv").read_text() == text
    rows = list(csv.reader(text.splitlines()))
    assert rows[0] == ["phase", "total_ms", "avg_us", "count"]
    assert [r[0] for r in rows[1:3]] == ["alpha", "beta"]
    assert rows[1][3] == "2"


def test_flop_counters():
    assert tprof.matmul_gflops(100, 100, 100, 1.0) == 2e-3
    assert tprof.rsvd_flops(1000, 1000, 64, 2) < tprof.rsvd_flops(
        1000, 1000, 128, 2)
    for args in ((64, 48, 32, 0.25), (1, 2, 3, 1e-3)):
        assert tprof.matmul_gflops(*args) == jprof.matmul_gflops(*args)
    assert tprof.rsvd_flops(4096, 4096, 80, 2) == \
        jprof.rsvd_flops(4096, 4096, 80, 2)


def test_timeit_returns_result():
    secs, out = tprof.timeit(lambda: torch.ones(4).sum(), iters=2, warmup=1)
    assert secs >= 0 and float(out) == 4.0
    calls = []
    secs, out = tprof.timeit(lambda x: calls.append(x) or (x, [x]), 3,
                             iters=3, warmup=2)
    assert calls == [3] * 5 and out == (3, [3])


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir) as where:
        assert where == log_dir
        a = torch.randn(64, 64)
        torch.linalg.qr(a @ a.T)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("qr" in n for n in names)


def test_tensor_factor_roundtrips(tmp_path, rng):
    core = rng.standard_normal((3, 4, 2))
    factors = [rng.standard_normal((10, 3)), rng.standard_normal((8, 4)),
               rng.standard_normal((6, 2))]
    p = str(tmp_path / "tuck")
    tck.save_tensor_factors(p, "tucker", core=from_numpy(core),
                            factors=(from_numpy(f) for f in factors),
                            meta={"tol": 1e-3})
    for reader in (tck.load_tensor_factors, jck.load_tensor_factors):
        out = reader(p)
        assert out["kind"] == "tucker" and out["meta"] == {"tol": 1e-3}
        np.testing.assert_array_equal(out["core"], core)
        for a, b in zip(out["factors"], factors):
            np.testing.assert_array_equal(a, b)

    cores = [rng.standard_normal((1, 5, 2)), rng.standard_normal((2, 4, 1))]
    p = str(tmp_path / "tt.npz")
    jck.save_tensor_factors(p, "tt", cores=cores)
    out = tck.load_tensor_factors(p)
    assert out["kind"] == "tt"
    for a, b in zip(out["cores"], cores):
        np.testing.assert_array_equal(a, b)
    core_t, factors_t = convert.tucker_from_numpy(core, factors, "cpu")
    assert torch.equal(core_t, from_numpy(core))
    assert all(torch.equal(a, from_numpy(b))
               for a, b in zip(convert.tt_from_numpy(cores, "cpu"), cores))

    w = np.array([2.0, 1.0])
    p = str(tmp_path / "cp")
    tck.save_tensor_factors(p, "cp", weights=from_numpy(w),
                            factors=[from_numpy(f) for f in factors[:2]])
    out = tck.load_tensor_factors(p)
    np.testing.assert_array_equal(out["weights"], w)
    w_t, f_t = convert.cp_from_numpy(out["weights"], out["factors"], "cpu")
    assert torch.equal(w_t, from_numpy(w)) and len(f_t) == 2


def test_tensor_factor_validation(tmp_path):
    with pytest.raises(ValueError):
        tck.save_tensor_factors(str(tmp_path / "x"), "magic", cores=[])
    with pytest.raises(ValueError):
        tck.save_tensor_factors(str(tmp_path / "x"), "tt")
    with pytest.raises(ValueError):
        tck.save_tensor_factors(str(tmp_path / "x"), "tucker", factors=[])
    with pytest.raises(ValueError):
        tck.save_tensor_factors(str(tmp_path / "x"), "cp", factors=[])
    assert not list(tmp_path.iterdir())          # nothing half-written


def test_model_deim_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    snaps = rng.standard_normal((60, 12))
    d = tdeim.deim_fit(from_numpy(snaps), m=5)
    p = str(tmp_path / "deim")
    tck.save_model(p, d, meta={"m": 5})
    d2, meta = tck.load_model(p, device="cpu")
    assert isinstance(d2, tdeim.Deim) and meta == {"m": 5}
    assert d2.indices.dtype == torch.int64
    for a, b in zip(d2, d):
        assert torch.equal(a, b)
    f = from_numpy(snaps[:, 0])
    np.testing.assert_allclose(to_numpy(tdeim.deim_interpolate(d2, f)),
                               to_numpy(tdeim.deim_interpolate(d, f)),
                               atol=1e-12)


def test_model_saved_by_jax_loads_as_the_ports_type(tmp_path):
    rng = np.random.default_rng(0)
    snaps = rng.standard_normal((60, 12))
    dj = jdeim.deim_fit(jnp.asarray(snaps), m=5)
    p = str(tmp_path / "deim_jax")
    jck.save_model(p, dj, meta={"m": 5})
    d2, meta = tck.load_model(p, device="cpu")
    assert type(d2) is tdeim.Deim and meta == {"m": 5}
    f = snaps[:, 0]
    np.testing.assert_allclose(
        to_numpy(tdeim.deim_interpolate(d2, from_numpy(f))),
        np.asarray(jdeim.deim_interpolate(dj, jnp.asarray(f))), atol=1e-12)
    # the port's file records the port's module and the same arrays
    tck.save_model(str(tmp_path / "deim_port"), d2)
    with np.load(tmp_path / "deim_port.npz") as z:
        header = json.loads(str(z["__model__"]))
        assert header["class_module"].endswith("_torch.rsvd.deim")
        np.testing.assert_array_equal(z["basis"], np.asarray(dj.basis))


def _rbf128():
    x = np.linspace(0, 1, 128)
    return np.exp(-((x[:, None] - x[None, :]) ** 2) / 0.02) + 0.1 * np.eye(
        128)


def test_model_hodlr_roundtrip(tmp_path):
    h = thodlr.hodlr_build(from_numpy(_rbf128()), levels=2, k=8)
    p = str(tmp_path / "hodlr.npz")
    tck.save_model(p, h)
    h2, _ = tck.load_model(p, device="cpu")
    assert isinstance(h2, thodlr.HodlrMatrix)
    assert h2.n == 128 and h2.k == 8
    assert len(h2.u_upper) == 2 and all(
        torch.equal(a, b) for a, b in zip(h2.v_lower, h.v_lower))
    v = from_numpy(np.random.default_rng(1).standard_normal(128))
    np.testing.assert_allclose(to_numpy(thodlr.hodlr_matvec(h2, v)),
                               to_numpy(thodlr.hodlr_matvec(h, v)),
                               atol=1e-10)


def test_model_hodlr_from_jax_file(tmp_path):
    hj = jhodlr.hodlr_build(jnp.asarray(_rbf128()), levels=2, k=8)
    jck.save_model(str(tmp_path / "h"), hj)
    h2, _ = tck.load_model(str(tmp_path / "h"), device="cpu")
    h3 = convert.hodlr_from_jax(hj, "cpu")
    assert type(h2) is type(h3) is thodlr.HodlrMatrix
    for a, b in zip(h2[:4], h3[:4]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    v = np.random.default_rng(1).standard_normal(128)
    want = np.asarray(jhodlr.hodlr_matvec(hj, jnp.asarray(v)))
    np.testing.assert_allclose(
        to_numpy(thodlr.hodlr_matvec(h2, from_numpy(v))), want, atol=1e-12)


def test_model_rejects_non_namedtuple(tmp_path):
    with pytest.raises(TypeError):
        tck.save_model(str(tmp_path / "x"), {"not": "a namedtuple"})
