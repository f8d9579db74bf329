"""The port's multi-host streaming rSVD (``rsvd/multihost.py``) and pod
mesh against the JAX package on the CPU.

- tests/test_multihost_streaming.py's ten cases at world 1, as JAX runs
  them: the port in this process with no process group, JAX's Omega
  (``jax.random.normal(key_from_seed(seed), (n, l))``, the JAX driver's
  draw) patched into the port's ``generate_omega``;
- the same driver at world 4 (one P = 4 gloo group for the file,
  ``tests/_torch_ranks.py``), each rank streaming an uneven row shard,
  against JAX's world-1 run on the whole matrix;
- tests/test_multihost.py's two-host pod mesh as 2 hosts x 2 ranks
  (``LOCAL_WORLD_SIZE=2``): the checks of tests/_multihost_worker.py.

Tolerances, the JAX tests': in f64 sigma rtol 1e-8 (atol 1e-10) and the
reconstruction norms rtol 1e-6 (test_multihost_streaming.py:34-40); f32
cases at their own bars, and sigma within 1e-4 of sigma_1 of JAX's.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.core.rng import (
    key_from_seed as jax_key_from_seed,
)
from rsvd_kamaneh_raganato_terrana_tpu.rsvd.multihost import (
    rsvd_streaming_multihost as jax_mh,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import (
    to_numpy,
    unshard_blocks,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdriver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import multihost as tmh
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.streaming import (
    rsvd_streaming,
)

from _torch_ranks import RankGroup

JNP = {torch.float32: jnp.float32, torch.float64: jnp.float64}
RTOL32 = 1e-4


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_draw(seed, n, l, dtype):
    return np.array(jax.random.normal(jax_key_from_seed(seed), (n, l),
                                      JNP[dtype]))


@pytest.fixture(autouse=True)
def jax_omega(monkeypatch):
    def omega(key_or_seed, n, l, dtype=torch.float32, kind="gaussian",
              device=None):
        return torch.from_numpy(jax_draw(key_or_seed, n, l, dtype))

    monkeypatch.setattr(tdriver, "generate_omega", omega)


def port(a, dtype=torch.float32, **kw):
    return tuple(to_numpy(x) for x in tmh.rsvd_streaming_multihost(
        a, dtype=dtype, device="cpu", **kw))


def jax_run(a, dtype=torch.float32, **kw):
    return tuple(np.asarray(x) for x in jax_mh(a, dtype=JNP[dtype], **kw))


def rec(u, s, v):
    return (u * s[None, :]) @ v.T


def assert_close_to_jax(got, want, a, f64):
    """sigma and the reconstruction against JAX's run."""
    if f64:
        np.testing.assert_allclose(got[1], want[1], rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(np.linalg.norm(a - rec(*got)),
                                   np.linalg.norm(a - rec(*want)),
                                   rtol=1e-6, atol=1e-8)
    else:
        assert np.abs(got[1] - want[1]).max() <= RTOL32 * want[1][0]


@pytest.fixture
def lowrank(rng):
    m, n, r = 300, 220, 24
    a = (rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
         + 1e-3 * rng.standard_normal((m, n)))
    return a.astype(np.float64)


# --- tests/test_multihost_streaming.py at world 1 ----------------------------


def test_single_process_matches_streaming(lowrank):
    k = 24
    kw = dict(k=k, p=8, q=2, panel_rows=64)
    got = port(lowrank, torch.float64, **kw)
    assert_close_to_jax(got, jax_run(lowrank, torch.float64, **kw), lowrank,
                        True)
    u_s, s_s, v_s = (to_numpy(x) for x in rsvd_streaming(
        lowrank, method="eigh", dtype=torch.float64, device="cpu", **kw))
    np.testing.assert_allclose(got[1], s_s, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.linalg.norm(lowrank - rec(*got)),
                               np.linalg.norm(lowrank - rec(u_s, s_s, v_s)),
                               rtol=1e-6, atol=1e-8)


def test_factor_contract(lowrank):
    k = 16
    kw = dict(k=k, p=8, q=1, panel_rows=100)
    u, s, v = got = port(lowrank, torch.float64, **kw)
    assert_close_to_jax(got, jax_run(lowrank, torch.float64, **kw), lowrank,
                        True)
    assert u.shape == (lowrank.shape[0], k) and s.shape == (k,)
    assert v.shape == (lowrank.shape[1], k)
    assert np.all(np.diff(s) <= 1e-12)
    assert np.linalg.norm(u.T @ u - np.eye(k)) < 1e-8
    assert np.linalg.norm(v.T @ v - np.eye(k)) < 1e-8


def test_memmap_shard_source(tmp_path, rng):
    m, n, k = 256, 180, 12
    a = (rng.standard_normal((m, 12)) @ rng.standard_normal((12, n))
         ).astype(np.float32)
    path = tmp_path / "shard.bin"
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=(m, n))
    mm[:] = a
    mm.flush()
    ro = np.memmap(path, dtype=np.float32, mode="r", shape=(m, n))
    kw = dict(k=k, p=8, q=1, panel_rows=90)
    got = port(ro, **kw)
    assert_close_to_jax(got, jax_run(ro, **kw), a, False)
    assert np.linalg.norm(a - rec(*got)) / np.linalg.norm(a) < 1e-4


def test_single_process_rowspace_matches_project(rng):
    a = (rng.standard_normal((220, 6)) @ rng.standard_normal((6, 140))
         + 1e-7 * rng.standard_normal((220, 140))).astype(np.float32)
    kw = dict(k=8, p=6, q=2, panel_rows=64)
    u, s, v = got = port(a, finish="rowspace", **kw)
    assert_close_to_jax(got, jax_run(a, finish="rowspace", **kw), a, False)
    assert np.linalg.norm(rec(u, s, v) - a) < 1e-4 * np.linalg.norm(a)
    un = u[:, :6]
    assert np.abs(un.T @ un - np.eye(6)).max() < 1e-4
    assert np.linalg.norm(u[:, 6:]) < 1e-6
    s2 = port(a, **kw)[1]
    np.testing.assert_allclose(s[:6], s2[:6], rtol=1e-3)
    with pytest.raises(ValueError):
        tmh.rsvd_streaming_multihost(a, k=8, q=0, finish="rowspace",
                                     device="cpu")


def test_rowspace_small_norm_keeps_directions(rng):
    svals = np.array([1e-2, 5e-3, 1e-3, 1e-4], np.float32)
    qm, _ = np.linalg.qr(rng.standard_normal((180, 4)))
    qn, _ = np.linalg.qr(rng.standard_normal((120, 4)))
    a = ((qm * svals[None, :]) @ qn.T).astype(np.float32)
    kw = dict(k=4, p=4, q=2, panel_rows=64, finish="rowspace")
    u, s, v = got = port(a, **kw)
    assert_close_to_jax(got, jax_run(a, **kw), a, False)
    np.testing.assert_allclose(s, svals, rtol=5e-2)
    assert np.abs(u.T @ u - np.eye(4)).max() < 1e-3
    assert np.linalg.norm(u, axis=0).min() > 0.99


@pytest.fixture
def passes(monkeypatch):
    """The port's streamed passes, counted."""
    calls = {"passes": 0}

    def counted(fn):
        def wrapped(*a, **kw):
            calls["passes"] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tmh, "_stream_right_multiply",
                        counted(tmh._stream_right_multiply))
    monkeypatch.setattr(tmh, "_stream_left_t_multiply",
                        counted(tmh._stream_left_t_multiply))
    return calls


def test_multihost_checkpoint_resume(tmp_path, rng, passes):
    a = (rng.standard_normal((200, 5)) @ rng.standard_normal((5, 130))
         ).astype(np.float32)
    ck = str(tmp_path / "mh")
    kw = dict(k=5, p=5, q=2, panel_rows=64, checkpoint_dir=ck)
    u1, s1, v1 = port(a, **kw)
    assert passes["passes"] == 6
    passes["passes"] = 0
    u2, s2, v2 = port(a, **kw)
    assert passes["passes"] == 0
    np.testing.assert_array_equal(s1, s2)
    os.remove(os.path.join(ck, "host0", "round1.npy"))
    os.remove(os.path.join(ck, "host0", "b_final.npy"))
    passes["passes"] = 0
    u3, s3, v3 = port(a, **kw)
    assert passes["passes"] == 3
    np.testing.assert_allclose(s3, s1, rtol=1e-6)
    assert_close_to_jax((u1, s1, v1), jax_run(a, **{
        k: v for k, v in kw.items() if k != "checkpoint_dir"}), a, False)


def test_unwritable_checkpoint_dir_degrades(rng):
    a = (rng.standard_normal((120, 5)) @ rng.standard_normal((5, 80))
         ).astype(np.float32)
    u, s, v = port(a, k=5, p=5, q=1, panel_rows=64,
                   checkpoint_dir="/proc/definitely-not-writable")
    assert np.linalg.norm(rec(u, s, v) - a) < 1e-3 * np.linalg.norm(a)


def _gapped64(rng, m, n, lo=1e-4):
    u, _ = np.linalg.qr(rng.standard_normal((m, min(m, n))))
    v, _ = np.linalg.qr(rng.standard_normal((n, min(m, n))))
    s = np.geomspace(1.0, lo, min(m, n))
    return ((u * s) @ v.T).astype(np.float64)


class TestMultihostUtvFinishes:

    def test_utv_full_rank_matches_project(self, rng):
        a = _gapped64(rng, 200, 120, 1e-3)
        k = 16
        kw = dict(k=k, p=0, q=2, panel_rows=64)
        u1, s1, v1 = got = port(a, torch.float64, finish="utv", **kw)
        u2, s2, v2 = port(a, torch.float64, finish="project", **kw)
        assert_close_to_jax(got, jax_run(a, torch.float64, finish="utv",
                                         **kw), a, True)
        np.testing.assert_allclose(rec(u1, s1, v1), rec(u2, s2, v2),
                                   atol=1e-10)
        np.testing.assert_allclose(v1.T @ v1, np.eye(k), atol=1e-9)
        np.testing.assert_allclose(np.linalg.norm(u1, axis=0), np.ones(k),
                                   atol=1e-9)
        assert np.all(np.diff(s1) <= 1e-12)

    def test_rowspace_utv_serving_config(self, rng):
        a = _gapped64(rng, 220, 140, 1e-4).astype(np.float32)
        k = 12
        kw = dict(k=k, p=10, q=2, panel_rows=80, finish="rowspace_utv",
                  qr_method="cholqr1")
        u, s, v = got = port(a, **kw)
        assert_close_to_jax(got, jax_run(a, **kw), a, False)
        s_true = np.linalg.svd(a.astype(np.float64), compute_uv=False)
        opt = np.sqrt((s_true[k:] ** 2).sum())
        assert np.linalg.norm(rec(u, s, v) - a) < 1.35 * opt
        assert np.abs(v.T @ v - np.eye(k)).max() < 1e-3

    def test_utv_checkpoint_resume(self, tmp_path, rng, passes):
        a = (rng.standard_normal((200, 5)) @ rng.standard_normal((5, 130))
             ).astype(np.float32)
        ck = str(tmp_path / "mh_utv")
        kw = dict(k=5, p=5, q=2, panel_rows=64, finish="utv",
                  checkpoint_dir=ck)
        u1, s1, v1 = port(a, **kw)
        assert passes["passes"] == 6
        passes["passes"] = 0
        u2, s2, v2 = port(a, **kw)
        assert passes["passes"] == 0
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(u1, u2)
        os.remove(os.path.join(ck, "host0", "b_final.npy"))
        passes["passes"] = 0
        u3, s3, v3 = port(a, **kw)
        assert passes["passes"] == 1
        np.testing.assert_allclose(s3, s1, rtol=1e-6)


# --- world 4: uneven shards, one a rank --------------------------------------


@pytest.mark.parametrize("kw", [
    dict(), dict(finish="rowspace"), dict(finish="utv"),
    dict(finish="rowspace_utv", qr_method="cholqr1"),
    dict(panel_dtype="int8")], ids=lambda kw: "-".join(kw.values()) or
    "project")
def test_world4_matches_world1(kw, lowrank, ranks):
    """Four ranks streaming 60/80/70/90 rows of A give JAX's world-1
    factors (f64); every collective is an all-reduce, l x l or n x l."""
    sizes = [60, 80, 70, 90]
    opts = dict(k=24, p=8, q=2, panel_rows=32, **kw)
    res = ranks.run("multihost", a=lowrank, sizes=sizes,
                    omega=jax_draw(0, 220, 32, torch.float64), **opts)
    for r in res[1:]:
        np.testing.assert_array_equal(r["s"], res[0]["s"])
        np.testing.assert_array_equal(r["v"], res[0]["v"])
    got = (unshard_blocks([r["u"] for r in res]), res[0]["s"], res[0]["v"])
    assert got[0].shape == (300, 24)
    assert_close_to_jax(got, jax_run(lowrank, torch.float64, **opts),
                        lowrank, True)
    tally = res[0]["tally"]
    assert set(tally) == {"all_reduce"}
    assert tally["all_reduce"]["bytes"] % 8 == 0


# --- tests/test_multihost.py: two hosts of two ranks -------------------------


def test_two_host_pod_mesh(tmp_path, ranks):
    """LOCAL_WORLD_SIZE=2 on 4 ranks: a (2, 2) ('dcn_rows', 'rows') mesh
    whose inner axis stays inside a host; the sharded rsvd, the ring and
    multi-host streaming across it at tests/_multihost_worker.py's bars."""
    res = ranks.run("pod_worker", timeout=120, local_world=2,
                    ckdir=str(tmp_path / "ck"))
    r0 = res[0]
    assert r0["shape"] == (2, 2) and r0["names"] == ("dcn_rows", "rows")
    for row in r0["ranks"]:                    # inner axis inside a host
        assert len({rk // 2 for rk in row}) == 1
    s0 = np.linalg.svd(r0["a"].astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(r0["s"][:4], s0[:4], rtol=2e-2)
    np.testing.assert_allclose(r0["s"], r0["s_single"], rtol=1e-5)
    np.testing.assert_allclose(r0["s_ring"][:4], s0[:4], rtol=2e-2)
    s_full = np.linalg.svd(r0["full"].astype(np.float64), compute_uv=False)
    for r in res:
        mine = r["mine"]
        for name, (u, s, v) in r["runs"].items():
            assert u.shape == (mine.shape[0], 16)
            rel = np.linalg.norm(mine - rec(u, s, v)) / np.linalg.norm(mine)
            if name == "rowspace_utv":       # s are weights: the energy
                np.testing.assert_allclose(float((s ** 2).sum()),
                                           float((s_full[:16] ** 2).sum()),
                                           rtol=2e-2)
            else:
                np.testing.assert_allclose(s[:8], s_full[:8], rtol=2e-2)
            assert rel < (0.05 if name == "memmap" else 0.06), (name, rel)
        np.testing.assert_allclose(r["s_resumed"], r["s_ckpt"], rtol=1e-5)
