"""The port's out-of-core streaming rSVD (``rsvd/streaming.py``) against
the JAX package's, on the CPU.

JAX's Omega (``generate_omega``) and the one-pass driver's (Omega, Psi)
are patched into the port's draws, drawn in the dtype of the call.  Then:
- in f64 the singular values equal JAX's to ``RTOL64`` = 1e-10 relative
  and the factors' reconstruction to 1e-9 of ||A|| (the same algorithm;
  LAPACK/BLAS summation order differs);
- in f32 the singular values agree to ``RTOL32`` = 1e-4 of sigma_1
  (f32 roundoff through q power rounds and the tail's eigh);
- with wire-compressed panels ('bfloat16', 'int8') the host encodes
  equal the JAX encodes bit for bit, and the singular values agree to
  ``RTOL32``.
Each JAX test's own bar (tests/test_streaming.py) is held on the port
too; the checkpoint cases count the port's streamed passes and hold a
resumed run bitwise to the uninterrupted one."""

import functools
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.core.rng import (
    key_from_seed as jax_key_from_seed,
)
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import streaming as js
from rsvd_kamaneh_raganato_terrana_tpu.rsvd.driver import (
    generate_omega as jax_generate_omega,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdriver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import streaming as ts

RTOL64 = 1e-10
RTOL32 = 1e-4
JNP = {torch.float32: jnp.float32, torch.float64: jnp.float64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def jax_draws(monkeypatch):
    """JAX's Omega and one-pass (Omega, Psi) in the port."""
    def omega(key_or_seed, n, l, dtype=torch.float32, kind="gaussian",
              device=None):
        return torch.from_numpy(np.array(jax_generate_omega(
            key_or_seed, n, l, JNP[dtype], kind)))

    def onepass(seed, n, l, m, s, dtype, device):
        k_om, k_psi = jax.random.split(jax_key_from_seed(seed))
        return (torch.from_numpy(np.array(jax.random.normal(
                    k_om, (n, l), JNP[dtype]))),
                torch.from_numpy(np.array(jax.random.normal(
                    k_psi, (m, s), JNP[dtype]))))

    monkeypatch.setattr(tdriver, "generate_omega", omega)
    monkeypatch.setattr(ts, "_onepass_draws", onepass)


def _lowrank(rng, m, n, r):
    return rng.standard_normal((m, r)) @ rng.standard_normal((r, n))


def _gapped(rng, m, n, s_lo=1e-4):
    u, _ = np.linalg.qr(rng.standard_normal((m, min(m, n))))
    v, _ = np.linalg.qr(rng.standard_normal((n, min(m, n))))
    s = np.geomspace(1.0, s_lo, min(m, n))
    return (u * s) @ v.T


def both(a, dtype=torch.float64, onepass=False, **kw):
    """(JAX's (U, s, V), the port's (U, s, V)) as numpy, same call."""
    jfn = js.rsvd_streaming_onepass if onepass else js.rsvd_streaming
    tfn = ts.rsvd_streaming_onepass if onepass else ts.rsvd_streaming
    got_j = tuple(np.asarray(x) for x in jfn(a, dtype=JNP[dtype], **kw))
    got_t = tuple(to_numpy(x) for x in tfn(a, dtype=dtype, device="cpu",
                                           **kw))
    return got_j, got_t


def rec(u, s, v):
    return (u * s[None, :]) @ v.T


def assert_same(got_j, got_t, a, rtol):
    """Singular values and reconstruction of the port against JAX's."""
    sj, st = got_j[1], got_t[1]
    assert st.shape == sj.shape and got_t[0].shape == got_j[0].shape
    assert np.abs(st - sj).max() <= rtol * abs(sj[0])
    scale = np.linalg.norm(a)
    tol = 1e-9 if rtol == RTOL64 else RTOL32
    assert np.linalg.norm(rec(*got_t) - rec(*got_j)) <= tol * scale


def test_streaming_matches_optimal(rng):
    a = _lowrank(rng, 300, 200, 7)
    got_j, got_t = both(a, k=10, p=6, q=2, panel_rows=64)
    assert_same(got_j, got_t, a, RTOL64)
    assert np.linalg.norm(rec(*got_t) - a) < 1e-8 * np.linalg.norm(a)
    s_np = np.linalg.svd(a, compute_uv=False)
    np.testing.assert_allclose(got_t[1][:7], s_np[:7], rtol=1e-8)


def test_streaming_panel_invariance(rng):
    a = rng.standard_normal((257, 96))           # panels don't divide m
    outs = []
    for panel in (64, 97, 257):
        got_j, got_t = both(a, k=8, p=8, q=1, panel_rows=panel)
        assert_same(got_j, got_t, a, RTOL64)
        outs.append(got_t[1])
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-10)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-10)


def test_streaming_memmap(tmp_path, rng):
    a = _lowrank(rng, 200, 120, 5).astype(np.float32)
    path = str(tmp_path / "a.dat")
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=a.shape)
    mm[:] = a
    mm.flush()
    ro = np.memmap(path, dtype=np.float32, mode="r", shape=a.shape)
    got_j, got_t = both(ro, torch.float32, k=6, p=6, q=1, panel_rows=50)
    assert_same(got_j, got_t, a, RTOL32)
    assert np.linalg.norm(rec(*got_t) - a) < 1e-3 * np.linalg.norm(a)


def test_streaming_shapes_and_torch_source(rng):
    a = rng.standard_normal((100, 60))
    got_j, got_t = both(a, k=9, p=4, q=0, panel_rows=32)
    assert got_t[0].shape == (100, 9) and got_t[1].shape == (9,)
    assert got_t[2].shape == (60, 9)
    assert_same(got_j, got_t, a, RTOL64)
    # a CPU tensor streams like the array it holds
    u, s, v = ts.rsvd_streaming(torch.from_numpy(a), k=9, p=4, q=0,
                                panel_rows=32, dtype=torch.float64,
                                device="cpu")
    np.testing.assert_array_equal(to_numpy(s), got_t[1])


def test_synthesized_matrix_streams_like_its_array(rng):
    a = _lowrank(rng, 150, 90, 6)
    synth = ts.SynthesizedMatrix(
        a.shape, lambda start, rows: torch.from_numpy(a[start:start + rows]))
    u, s, v = ts.rsvd_streaming(synth, k=6, p=4, q=1, panel_rows=40,
                                dtype=torch.float64, device="cpu")
    u2, s2, v2 = ts.rsvd_streaming(a, k=6, p=4, q=1, panel_rows=40,
                                   dtype=torch.float64, device="cpu")
    assert torch.equal(s, s2) and torch.equal(u, u2) and torch.equal(v, v2)


def test_onepass_low_rank_recovery(rng):
    a = (rng.standard_normal((200, 150))
         @ rng.standard_normal((12, 150)).T
         @ rng.standard_normal((12, 150)))
    a = a / np.linalg.norm(a)
    got_j, got_t = both(a, onepass=True, k=12, p=8, panel_rows=64)
    assert_same(got_j, got_t, a, RTOL64)
    assert np.linalg.norm(a - rec(*got_t)) / np.linalg.norm(a) < 1e-8
    u = got_t[0]
    assert np.abs(u.T @ u - np.eye(12)).max() < 1e-8


def test_onepass_matches_full_svd_on_decaying_spectrum(rng):
    m = n = 120
    u0, _ = np.linalg.qr(rng.standard_normal((m, m)))
    v0, _ = np.linalg.qr(rng.standard_normal((n, n)))
    sig = 2.0 ** -np.arange(min(m, n), dtype=np.float64)
    a = (u0 * sig[None, :]) @ v0.T
    k = 10
    got_j, got_t = both(a, onepass=True, k=k, p=10, panel_rows=50)
    np.testing.assert_allclose(got_t[1], got_j[1], rtol=1e-8)
    err = np.linalg.norm(a - rec(*got_t))
    assert err < 10 * np.linalg.norm(sig[k:])


def test_onepass_panel_invariance(rng):
    a = rng.standard_normal((120, 90)) @ rng.standard_normal((90, 90))
    outs = []
    for pr in (30, 50, 120):
        got_j, got_t = both(a, onepass=True, k=8, p=6, panel_rows=pr)
        assert_same(got_j, got_t, a, RTOL64)
        outs.append(got_t)
    for u, s, v in outs[1:]:
        np.testing.assert_allclose(s, outs[0][1], rtol=1e-9)
        np.testing.assert_allclose(np.abs(u), np.abs(outs[0][0]), atol=1e-8)


@pytest.mark.parametrize("panel_dtype", ["bfloat16", "int8"])
def test_encode_panel_matches_jax(rng, panel_dtype):
    """The host wire encodes equal the JAX module's bit for bit (f32 and
    f64 panels)."""
    for dt in (np.float32, np.float64):
        x = (rng.standard_normal((37, 29)) * 10.0 ** rng.uniform(
            -3, 3, size=(37, 1))).astype(dt)
        x[5] = 0.0                                   # an all-zero row
        pj, sj = js._encode_panel(x, panel_dtype)
        pt, st = ts._encode_panel(x, panel_dtype)
        np.testing.assert_array_equal(
            to_numpy(pt), np.asarray(pj).astype(np.float32))
        if panel_dtype == "int8":
            assert pt.dtype == torch.int8
            np.testing.assert_array_equal(to_numpy(st), sj)
        else:
            assert pt.dtype == torch.bfloat16 and st is None


@pytest.mark.parametrize("panel_dtype", ["bfloat16", "int8"])
def test_streaming_compressed_panels(rng, panel_dtype):
    m, n, r = 300, 200, 8
    a = (10.0 * rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
         + 1e-3 * rng.standard_normal((m, n)))
    got_j, got_t = both(a, torch.float32, k=r, p=8, q=2, panel_rows=64,
                        panel_dtype=panel_dtype)
    assert_same(got_j, got_t, a, RTOL32)
    u0, s0, v0 = (to_numpy(x) for x in ts.rsvd_streaming(
        a, k=r, p=8, q=2, panel_rows=64, dtype=torch.float32,
        device="cpu"))
    tol = 2e-3 if panel_dtype == "bfloat16" else 6e-3
    err0 = np.linalg.norm(rec(u0, s0, v0) - a) / np.linalg.norm(a)
    assert np.linalg.norm(rec(*got_t) - a) / np.linalg.norm(a) < tol + err0
    np.testing.assert_allclose(got_t[1], s0, rtol=2e-2)


@pytest.mark.parametrize("panel_dtype", ["bfloat16", "int8"])
def test_onepass_compressed_panels(rng, panel_dtype):
    m, n, r = 200, 150, 8
    a = (5.0 * rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
         + 1e-3 * rng.standard_normal((m, n)))
    got_j, got_t = both(a, torch.float32, onepass=True, k=r, p=8,
                        panel_rows=64, panel_dtype=panel_dtype)
    assert_same(got_j, got_t, a, RTOL32)
    assert np.linalg.norm(rec(*got_t) - a) < 2e-2 * np.linalg.norm(a)


def test_int8_panel_row_scale_invariance(rng):
    m, n, r = 128, 96, 4
    base = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    a = base * 10.0 ** rng.uniform(-4, 4, size=(m, 1))
    got_j, got_t = both(a, torch.float32, k=r, p=8, q=2, panel_rows=48,
                        panel_dtype="int8")
    np.testing.assert_allclose(got_t[1], got_j[1], rtol=RTOL32)
    row_err = (np.linalg.norm(rec(*got_t) - a, axis=1)
               / np.maximum(np.linalg.norm(a, axis=1), 1e-30))
    assert np.percentile(row_err, 95) < 5e-2


def test_streaming_rowspace_finish(rng):
    a = _lowrank(rng, 280, 180, 6) + 1e-7 * rng.standard_normal((280, 180))
    got_j, got_t = both(a, k=8, p=6, q=2, panel_rows=64, finish="rowspace")
    assert_same(got_j, got_t, a, RTOL64)
    u, s, v = got_t
    assert u.shape == (280, 8) and v.shape == (180, 8)
    assert np.linalg.norm(rec(u, s, v) - a) < 1e-5 * np.linalg.norm(a)
    assert np.abs(u.T @ u - np.eye(8)).max() < 1e-10
    assert np.abs(v.T @ v - np.eye(8)).max() < 1e-10
    _, s2, _ = ts.rsvd_streaming(a, k=8, p=6, q=2, panel_rows=280,
                                 dtype=torch.float64, finish="rowspace",
                                 device="cpu")
    np.testing.assert_allclose(s, to_numpy(s2), rtol=1e-9)
    with pytest.raises(ValueError):
        ts.rsvd_streaming(a, k=8, q=0, finish="rowspace", device="cpu")
    with pytest.raises(ValueError):
        ts.rsvd_streaming(a, k=8, finish="sideways", device="cpu")


class TestStreamCheckpoint:
    """Pass-level checkpoint/resume: a resumed run replays only the
    missing passes and never reuses state from other parameters or
    data."""

    @pytest.fixture
    def calls(self, monkeypatch):
        calls = {"passes": 0}
        orig_r, orig_l = ts._stream_right_multiply, ts._stream_left_t_multiply

        def right(*a, **kw):
            calls["passes"] += 1
            return orig_r(*a, **kw)

        def left(*a, **kw):
            calls["passes"] += 1
            return orig_l(*a, **kw)

        monkeypatch.setattr(ts, "_stream_right_multiply", right)
        monkeypatch.setattr(ts, "_stream_left_t_multiply", left)
        return calls

    @staticmethod
    def run(a, **kw):
        return tuple(to_numpy(x) for x in ts.rsvd_streaming(
            a, device="cpu", **kw))

    def test_resume_skips_completed_passes(self, tmp_path, rng, calls):
        a = _lowrank(rng, 200, 150, 6).astype(np.float32)
        ck = str(tmp_path / "ck")
        kw = dict(k=6, p=6, q=2, panel_rows=64, checkpoint_dir=ck)
        u1, s1, v1 = self.run(a, **kw)
        assert calls["passes"] == 6                  # 2q + 2
        calls["passes"] = 0
        u2, s2, v2 = self.run(a, **kw)
        assert calls["passes"] == 0                  # everything resumed
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(u1, u2)
        sj = np.asarray(js.rsvd_streaming(a, k=6, p=6, q=2,
                                          panel_rows=64)[1])
        assert np.abs(s1 - sj).max() <= RTOL32 * sj[0]

    def test_partial_state_resumes_midway_bitwise(self, tmp_path, rng,
                                                  calls):
        a = _lowrank(rng, 180, 120, 5).astype(np.float32)
        ck = str(tmp_path / "ck")
        kw = dict(k=5, p=5, q=2, panel_rows=50, checkpoint_dir=ck)
        u1, s1, v1 = self.run(a, **kw)
        for st in ("round1", "zb_final"):   # a crash after round 0
            os.remove(os.path.join(ck, f"{st}.npy"))
        calls["passes"] = 0
        u2, s2, v2 = self.run(a, **kw)
        assert calls["passes"] == 3       # round1 (2 passes) + projection
        for x, y in ((u1, u2), (s1, s2), (v1, v2)):
            np.testing.assert_array_equal(x, y)

    def test_param_mismatch_invalidates(self, tmp_path, rng, calls):
        a = _lowrank(rng, 150, 100, 4).astype(np.float32)
        ck = str(tmp_path / "ck")
        self.run(a, k=4, p=4, q=1, panel_rows=50, checkpoint_dir=ck)
        calls["passes"] = 0
        u, s, v = self.run(a, k=4, p=4, q=1, panel_rows=50, seed=9,
                           checkpoint_dir=ck)
        assert calls["passes"] == 4                  # full 2q + 2
        assert np.linalg.norm(rec(u, s, v) - a) < 1e-3 * np.linalg.norm(a)

    def test_data_mismatch_invalidates(self, tmp_path, rng, calls):
        a = _lowrank(rng, 150, 100, 4).astype(np.float32)
        b = _lowrank(rng, 150, 100, 4).astype(np.float32)
        ck = str(tmp_path / "ck")
        self.run(a, k=4, p=4, q=1, panel_rows=50, checkpoint_dir=ck)
        calls["passes"] = 0
        u, s, v = self.run(b, k=4, p=4, q=1, panel_rows=50,
                           checkpoint_dir=ck)
        assert calls["passes"] == 4                  # stale factors wiped
        assert np.linalg.norm(rec(u, s, v) - b) < 1e-3 * np.linalg.norm(b)
        # the sampled fingerprint is the JAX module's
        assert ts._data_fingerprint(b) == js._data_fingerprint(b)

    def test_memmap_rewrite_invalidates(self, tmp_path, rng, calls):
        path = tmp_path / "a.bin"
        m, n = 150, 100
        mm = np.memmap(path, dtype=np.float32, mode="w+", shape=(m, n))
        mm[:] = _lowrank(rng, m, n, 4).astype(np.float32)
        mm.flush()
        ck = str(tmp_path / "ck")
        ro = np.memmap(path, dtype=np.float32, mode="r", shape=(m, n))
        self.run(ro, k=4, p=4, q=1, panel_rows=50, checkpoint_dir=ck)
        b = _lowrank(rng, m, n, 4).astype(np.float32)
        mm[:] = b
        mm.flush()
        os.utime(path, ns=(time.time_ns(), time.time_ns() + 1))
        calls["passes"] = 0
        ro2 = np.memmap(path, dtype=np.float32, mode="r", shape=(m, n))
        u, s, v = self.run(ro2, k=4, p=4, q=1, panel_rows=50,
                           checkpoint_dir=ck)
        assert calls["passes"] == 4
        assert np.linalg.norm(rec(u, s, v) - b) < 1e-3 * np.linalg.norm(b)
        assert ts._data_fingerprint(ro2) == js._data_fingerprint(ro2)

    def test_rowspace_checkpoint(self, tmp_path, rng, calls):
        a = _lowrank(rng, 160, 110, 4).astype(np.float32)
        ck = str(tmp_path / "ck")
        kw = dict(k=4, p=4, q=2, panel_rows=40, finish="rowspace",
                  checkpoint_dir=ck)
        u1, s1, v1 = self.run(a, **kw)
        assert calls["passes"] == 5                  # 2q + 1
        calls["passes"] = 0
        u2, s2, v2 = self.run(a, **kw)
        assert calls["passes"] == 0
        np.testing.assert_array_equal(s1, s2)


class TestStreamingUtvFinishes:
    """The streamed serving tails: thin-QR folds, s are decomposition
    weights, U has unit columns, V is orthonormal."""

    def test_utv_full_rank_matches_streamed_project(self, rng):
        a = _gapped(rng, 150, 90, 1e-3)
        got_j, got_t = both(a, k=16, p=0, q=2, panel_rows=50, finish="utv")
        assert_same(got_j, got_t, a, RTOL64)
        _, got_p = both(a, k=16, p=0, q=2, panel_rows=50, method="eigh",
                        finish="project")
        np.testing.assert_allclose(rec(*got_t), rec(*got_p), atol=1e-10)

    def test_utv_contract_and_energy_identity(self, rng):
        a = _gapped(rng, 140, 80, 1e-5)
        l = 20
        got_j, (u, s, v) = both(a, k=l, p=0, q=2, panel_rows=64,
                                finish="utv")
        np.testing.assert_allclose(s, got_j[1], rtol=RTOL64)
        np.testing.assert_allclose(v.T @ v, np.eye(l), atol=1e-9)
        np.testing.assert_allclose(np.linalg.norm(u, axis=0), np.ones(l),
                                   atol=1e-9)
        assert np.all(np.diff(s) <= 1e-12)
        _, s_proj, _ = ts.rsvd_streaming(a, k=l, p=0, q=2, panel_rows=64,
                                         dtype=torch.float64, method="eigh",
                                         finish="project", device="cpu")
        np.testing.assert_allclose(float((s ** 2).sum()),
                                   float((to_numpy(s_proj) ** 2).sum()),
                                   rtol=1e-11)

    def test_rowspace_utv_truncation_near_optimal(self, rng):
        a = _gapped(rng, 160, 100, 1e-4)
        k = 10
        got_j, got_t = both(a, k=k, p=8, q=2, panel_rows=48,
                            finish="rowspace_utv")
        assert_same(got_j, got_t, a, RTOL64)
        s_true = np.linalg.svd(a, compute_uv=False)
        opt = np.sqrt((s_true[k:] ** 2).sum())
        assert np.linalg.norm(a - rec(*got_t)) < 1.3 * opt

    def test_rowspace_utv_pass_count_and_serving_qr(self, monkeypatch):
        calls = {"passes": 0}
        orig_r, orig_l = ts._stream_right_multiply, ts._stream_left_t_multiply

        def counted(fn):
            def wrapped(*a, **kw):
                calls["passes"] += 1
                return fn(*a, **kw)
            return wrapped

        monkeypatch.setattr(ts, "_stream_right_multiply", counted(orig_r))
        monkeypatch.setattr(ts, "_stream_left_t_multiply", counted(orig_l))
        a = _gapped(np.random.default_rng(3), 150, 90, 1e-3
                    ).astype(np.float32)
        kw = dict(k=8, p=8, q=2, panel_rows=50, finish="rowspace_utv",
                  qr_method="cholqr1")
        got_j, got_t = both(a, torch.float32, **kw)
        assert calls["passes"] == 5                  # 2q + 1
        assert_same(got_j, got_t, a, RTOL32)
        s_true = np.linalg.svd(a.astype(np.float64), compute_uv=False)
        opt = np.sqrt((s_true[8:] ** 2).sum())
        assert np.linalg.norm(rec(*got_t) - a) < 1.35 * opt

    @pytest.mark.parametrize("qr_method, method", [
        ("robust", "jacobi"), ("cholqr1_fused", "eigh_pallas")])
    def test_utv_checkpoint_resume_bitwise(self, tmp_path, rng,
                                           monkeypatch, qr_method, method):
        """A second run from checkpoints reproduces the factors BITWISE,
        also through the kernels' wrappers (their plain versions here)."""
        calls = {"passes": 0}
        orig_r, orig_l = ts._stream_right_multiply, ts._stream_left_t_multiply

        def counted(fn):
            def wrapped(*a, **kw):
                calls["passes"] += 1
                return fn(*a, **kw)
            return wrapped

        monkeypatch.setattr(ts, "_stream_right_multiply", counted(orig_r))
        monkeypatch.setattr(ts, "_stream_left_t_multiply", counted(orig_l))
        # full rank: K1 (CholeskyQR1, no fallback) needs a full-rank Y
        a = _gapped(rng, 160, 110, 1e-2).astype(np.float32)
        for finish in ("utv", "rowspace_utv", "project"):
            ck = str(tmp_path / f"ck_{finish}")
            kw = dict(k=5, p=5, q=2, panel_rows=40, finish=finish,
                      checkpoint_dir=ck, qr_method=qr_method,
                      method=method, device="cpu")
            first = ts.rsvd_streaming(a, **kw)
            calls["passes"] = 0
            second = ts.rsvd_streaming(a, **kw)
            assert calls["passes"] == 0, finish
            for x, y in zip(first, second):
                assert torch.equal(x, y), finish
            final = "c_final" if finish == "rowspace_utv" else "zb_final"
            os.remove(os.path.join(ck, f"{final}.npy"))
            calls["passes"] = 0
            third = ts.rsvd_streaming(a, **kw)
            assert calls["passes"] == 1, finish
            for x, y in zip(first, third):
                assert torch.equal(x, y), finish
