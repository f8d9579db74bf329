"""Sharded operands beyond the rSVD driver in the port, against the JAX
package on the CPU: the shard invariance of the extensions
(tests/test_distributed_extensions.py, the mesh cases of
tests/test_nystrom.py and tests/test_rlu.py), the image codecs' ``mesh=``
(tests/test_image.py) and ``rsvd_batched`` on a batch-sharded stack
(the JAX dry run's batched stage).

Each case holds two things, at the JAX tests' sizes:

(i) the port's sharded call, on P = 4 gloo ranks (``tests/_torch_ranks.py``,
    one group for the file; the ranks import the port only, every wait
    has its own time limit) with its own draws, against the port's
    single-rank call on the same input, at the JAX test's tolerance
    (stated in each case; DEIM and rLU indices equal);
(ii) the port's single-rank call with the JAX package's draws patched in,
    as the single-card parity tests patch them, against the JAX function
    on a row-sharded (or batch-sharded) array of conftest's 8-device
    mesh, at those tests' tolerances (``RTOL`` = 1e-10 for the
    estimators, least squares, Nystrom and rLU; ``TUCKER_RTOL`` = 1e-9
    with JAX's eigenvector signs; ``ITER_RTOL`` = 1e-8 for RPCA and
    completion; 1e-9 for the codecs and the batched driver).

Where the JAX tests read the HLO, these read the port's collectives
tally: a sharded extension never gathers a block as large as A's
(``no_whole_gather``), the batch-sharded driver issues none, and the
codecs only gather their factors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from rsvd_kamaneh_raganato_terrana_tpu.apps import image as jimage
from rsvd_kamaneh_raganato_terrana_tpu.core.rng import (
    fold_in_shard as jax_fold_in_shard,
    key_from_seed as jax_key_from_seed,
    rademacher as jax_rademacher,
    sketch_matrix as jax_sketch_matrix,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import image as timage
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdriver

from _torch_sharded import (  # noqa: F401 -- fixtures by name
    ITER_RTOL,
    RANKS,
    RTOL,
    TUCKER_RTOL,
    _jax,
    _jax_omega,
    _jax_signed_eigh,
    _one_torch_thread,
    _port,
    _queue,
    _rel,
    no_whole_gather,
    ranks,
    shard_rows8,
    sharded,
    single,
    whole,
)

CODEC_RTOL = 1e-9


# --- tests/test_distributed_extensions.py -----------------------------------


def test_hutchinson_shard_invariant(mesh8, rng, ranks, monkeypatch):
    """Estimate and standard error: (i) rtol 1e-9 (the JAX test's)."""
    a = rng.standard_normal((256, 256))
    a = (a + a.T) / 2
    kw = dict(seed=0, num_samples=32)
    out, tally = sharded(ranks, "rsvd.trace:hutchinson", a, **kw)
    assert set(tally) == {"all_reduce"}
    np.testing.assert_allclose(out, single("rsvd.trace:hutchinson", a, **kw),
                               rtol=1e-9)
    _queue(monkeypatch, _port("rsvd.trace"), "sketch_matrix", [
        jax_sketch_matrix(jax_key_from_seed(0), 256, 32, jnp.float64,
                          "rademacher")])
    want = _jax("rsvd.trace").hutchinson(shard_rows8(mesh8, a), **kw)
    np.testing.assert_allclose(single("rsvd.trace:hutchinson", a, **kw),
                               [float(w) for w in want], rtol=RTOL)


def test_hutchpp_shard_invariant(mesh8, rng, ranks, monkeypatch):
    """(i) rtol 1e-8 (the JAX test's); Q is row-split, A Q gathers Q."""
    b = rng.standard_normal((256, 16))
    a = b @ b.T
    kw = dict(seed=0, budget=48)
    out, tally = sharded(ranks, "rsvd.trace:hutchpp", a, **kw)
    no_whole_gather(tally, a)
    np.testing.assert_allclose(out, single("rsvd.trace:hutchpp", a, **kw),
                               rtol=1e-8)
    ks, kg = jax.random.split(jax_key_from_seed(0))
    _queue(monkeypatch, _port("rsvd.trace"), "sketch_matrix", [
        jax_sketch_matrix(k, 256, 16, jnp.float64, "rademacher")
        for k in (ks, kg)])
    want = _jax("rsvd.trace").hutchpp(shard_rows8(mesh8, a), **kw)
    np.testing.assert_allclose(single("rsvd.trace:hutchpp", a, **kw),
                               float(want), rtol=RTOL)


def test_slq_logdet_shard_invariant(mesh8, rng, ranks, monkeypatch):
    """(i) rtol 1e-7 (the JAX test's); one gather of A V a step."""
    q, _ = np.linalg.qr(rng.standard_normal((128, 128)))
    a = (q * np.linspace(1.0, 2.0, 128)[None, :]) @ q.T
    kw = dict(seed=0, num_probes=4, steps=12)
    out, tally = sharded(ranks, "rsvd.slq:logdet_psd", a, **kw)
    assert tally["all_gather"]["calls"] == 12
    no_whole_gather(tally, a)
    np.testing.assert_allclose(out, single("rsvd.slq:logdet_psd", a, **kw),
                               rtol=1e-7)
    _queue(monkeypatch, _port("rsvd.slq"), "rademacher", [jax_rademacher(
        jax_key_from_seed(0), (4, 128), jnp.float64)])
    want = _jax("rsvd.slq").logdet_psd(shard_rows8(mesh8, a), **kw)
    np.testing.assert_allclose(single("rsvd.slq:logdet_psd", a, **kw),
                               float(want), rtol=RTOL)


def test_sketch_lstsq_shard_invariant(mesh8, rng, ranks, monkeypatch):
    """A row-sharded, b whole on every rank: (i) atol 1e-8 (the JAX
    test's); two small all-reduces a step, A never gathered."""
    a = rng.standard_normal((512, 24))
    b = rng.standard_normal(512)
    out, tally = sharded(ranks, "rsvd.lstsq:sketch_lstsq", a, b,
                         layouts=("rows", None), seed=0)
    assert set(tally) == {"all_reduce"}
    assert tally["all_reduce"]["calls"] == 3 + 2 * 40
    np.testing.assert_allclose(
        out, single("rsvd.lstsq:sketch_lstsq", a, b, seed=0), atol=1e-8)
    _queue(monkeypatch, _port("rsvd.lstsq"), "sketch_matrix", [
        jax_sketch_matrix(jax_key_from_seed(0), 96, 512, jnp.float64)])
    want = np.asarray(_jax("rsvd.lstsq").sketch_lstsq(
        shard_rows8(mesh8, a), jnp.asarray(b), seed=0))
    assert _rel(single("rsvd.lstsq:sketch_lstsq", a, b, seed=0),
                want) <= RTOL


@pytest.mark.parametrize("shape", [(256, 16, 12), (16, 64, 12)])
def test_tucker_shard_invariant_first_mode(mesh8, rng, ranks, monkeypatch,
                                           shape):
    """Sharded on mode 0, contracted first (the JAX test's shape) or
    after mode 1: (i) core and factors atol 1e-8 (the JAX test's); U_0
    comes back row-sharded."""
    t = rng.standard_normal(shape)
    kw = dict(seed=0)
    out, tally = sharded(ranks, "rsvd.tucker:tucker", t, (4, 4, 4), **kw)
    no_whole_gather(tally, t)
    assert out[1][0]["placements"] == ["S(0)"]
    want = single("rsvd.tucker:tucker", t, (4, 4, 4), **kw)
    np.testing.assert_allclose(out[0], want[0], atol=1e-8)
    for got, ref in zip(out[1], want[1]):
        np.testing.assert_allclose(whole(got), ref, atol=1e-8)
    for module in ("rsvd.tucker", "rsvd._modewise"):
        monkeypatch.setattr(_port(module), "generate_omega", _jax_omega)
    monkeypatch.setattr(_port("rsvd._modewise"), "eigh", _jax_signed_eigh)
    core_j, f_j = _jax("rsvd.tucker").tucker(shard_rows8(mesh8, t),
                                             (4, 4, 4), **kw)
    core_t, f_t = single("rsvd.tucker:tucker", t, (4, 4, 4), **kw)
    assert _rel(core_t, core_j) <= TUCKER_RTOL
    for got, ref in zip(f_t, f_j):
        assert _rel(got, ref) <= TUCKER_RTOL


@pytest.mark.parametrize("qr_method", ["robust", "cholqr1_fused"])
def test_rutv_shard_invariant(mesh8, rng, ranks, monkeypatch, qr_method):
    """(i) U, T, V atol 1e-8 (the JAX test's); 'cholqr1_fused' (K1's
    plain version here) factors the gathered m x l panels."""
    a = rng.standard_normal((256, 96))
    kw = dict(k=8, p=8, qr_method=qr_method)
    out, tally = sharded(ranks, "rsvd.utv:rutv", a, **kw)
    no_whole_gather(tally, a)
    assert out[0]["placements"] == ["S(0)"]
    for got, ref in zip(out, single("rsvd.utv:rutv", a, **kw)):
        np.testing.assert_allclose(whole(got), ref, atol=1e-8)
    monkeypatch.setattr(_port("rsvd.utv"), "generate_omega", _jax_omega)
    want = _jax("rsvd.utv").rutv(shard_rows8(mesh8, a), **kw)
    for got, ref in zip(single("rsvd.utv:rutv", a, **kw), want):
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-10)


def _jax_sketches(monkeypatch, module, seed, draws):
    """``module.sketch_matrix`` answering with JAX's sketches for
    (fold-in tag, n, l) in order (tests/test_torch_rpca_completion.py)."""
    key = jax.random.PRNGKey(seed)
    return _queue(monkeypatch, _port(module), "sketch_matrix", [
        jax_sketch_matrix(jax.random.fold_in(key, tag), n, l, jnp.float64)
        for tag, n, l in draws])


def test_completion_shard_invariant(mesh8, rng, ranks, monkeypatch):
    """Operand and mask row-sharded: (i) s rtol 1e-8, the RMSE trace
    rtol 1e-7 (the JAX test's)."""
    a = (rng.standard_normal((128, 64))[:, :4]
         @ rng.standard_normal((4, 64)))
    mask = rng.random((128, 64)) < 0.6
    kw = dict(k=4, iters=10)
    fn = "rsvd.completion:complete_lowrank"
    out, tally = sharded(ranks, fn, a, mask, layouts=("rows", "rows"), **kw)
    no_whole_gather(tally, a)
    assert out[0]["placements"] == ["S(0)"]
    want = single(fn, a, mask, **kw)
    np.testing.assert_allclose(out[1], want[1], rtol=1e-8)
    np.testing.assert_allclose(out[3], want[3], rtol=1e-7)
    _jax_sketches(monkeypatch, "rsvd.completion", 0,
                  [(i, 64, 14) for i in range(10)])
    res_j = _jax("rsvd.completion").complete_lowrank(
        shard_rows8(mesh8, a), shard_rows8(mesh8, mask), **kw)
    got = single(fn, a, mask, **kw)
    assert _rel(got[1], res_j.s) <= ITER_RTOL
    assert _rel((got[0] * got[1]) @ got[2].T,
                (np.asarray(res_j.u) * np.asarray(res_j.s))
                @ np.asarray(res_j.v).T) <= ITER_RTOL


def test_rpca_shard_invariant(mesh8, rng, ranks, monkeypatch):
    """(i) L atol 1e-6, the residual trace atol 1e-9 (the JAX test's);
    L and S come back row-sharded."""
    low = (rng.standard_normal((128, 64))[:, :3]
           @ rng.standard_normal((3, 64)))
    sp = np.where(rng.random((128, 64)) < 0.05,
                  5.0 * rng.standard_normal((128, 64)), 0.0)
    m = low + sp
    kw = dict(k_max=6, iters=20)
    out, tally = sharded(ranks, "rsvd.rpca:rpca", m, **kw)
    no_whole_gather(tally, m)
    assert out[0]["placements"] == out[1]["placements"] == ["S(0)"]
    want = single("rsvd.rpca:rpca", m, **kw)
    np.testing.assert_allclose(whole(out[0]), want[0], atol=1e-6)
    np.testing.assert_allclose(out[3], want[3], atol=1e-9)
    _jax_sketches(monkeypatch, "rsvd.rpca", 0, [(0x51e17, 64, 1)]
                  + [(i, 64, 16) for i in range(21)])
    res_j = _jax("rsvd.rpca").rpca(shard_rows8(mesh8, m), **kw)
    got = single("rsvd.rpca:rpca", m, **kw)
    for g, name in zip(got[:2], ("low_rank", "sparse")):
        assert _rel(g, getattr(res_j, name)) <= ITER_RTOL
    assert int(got[2]) == int(res_j.rank)


def test_deim_fit_shard_invariant(mesh8, rng, ranks, monkeypatch):
    """(i) indices equal, projector atol 1e-8 (the JAX test's)."""
    snaps = rng.standard_normal((256, 24))
    out, tally = sharded(ranks, "rsvd.deim:deim_fit", snaps, m=6)
    no_whole_gather(tally, snaps)
    want = single("rsvd.deim:deim_fit", snaps, m=6)
    np.testing.assert_array_equal(out[1], want[1])
    np.testing.assert_allclose(whole(out[2]), want[2], atol=1e-8)
    assert out[0]["placements"] == out[2]["placements"] == ["S(0)"]
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    d_j = _jax("rsvd.deim").deim_fit(shard_rows8(mesh8, snaps), m=6)
    got = single("rsvd.deim:deim_fit", snaps, m=6)
    np.testing.assert_array_equal(got[1], np.asarray(d_j.indices))
    assert _rel(got[2], d_j.proj) <= 1e-8


def test_frequent_directions_shard_invariant_columns(mesh8, rng, ranks):
    """The 2l x n buffer column-sharded: (i) S^T S atol 1e-4 of its max
    (the JAX test's), one 2l x 2l all-reduce a shrink (5), the top-4
    ``eigh_estimate`` eigenvalues to 1e-9 relative with V row-sharded;
    (ii) against JAX's column-sharded buffer at tests/test_torch_pca.py's
    1e-10 of max |A^T A|."""
    a = rng.standard_normal((100, 256))
    res = ranks.run("fd", a=a, n_cols=256, l=16, batch=25)[0]
    assert res["sketch"]["placements"] == ["S(1)"]
    assert res["v"]["placements"] == ["S(0)"]
    assert set(res["tally"]) == {"all_reduce"}
    assert res["tally"]["all_reduce"]["calls"] == 5
    fd1 = _port("rsvd.fd").FrequentDirections(256, 16, dtype=torch.float64,
                                              device="cpu")
    for i in range(0, 100, 25):
        fd1.update(a[i:i + 25])
    s1, s4 = to_numpy(fd1.sketch()), res["sketch"]["whole"]
    np.testing.assert_allclose(s4.T @ s4, s1.T @ s1,
                               atol=1e-4 * np.abs(s1.T @ s1).max())
    np.testing.assert_allclose(res["w"], to_numpy(fd1.eigh_estimate(4)[0]),
                               rtol=1e-9)
    fd8 = _jax("rsvd.fd").FrequentDirections(256, 16, dtype=jnp.float64)
    fd8._buf = jax.device_put(fd8._buf,
                              NamedSharding(mesh8, P(None, "rows")))
    for i in range(0, 100, 25):
        fd8.update(a[i:i + 25])
    s8 = np.asarray(fd8.sketch())
    assert np.abs(s1.T @ s1 - s8.T @ s8).max() <= \
        RTOL * np.abs(a.T @ a).max()


# --- tests/test_nystrom.py:76-85, tests/test_rlu.py:81-92 -------------------


def _psd(n, seed, decay=0.5):
    """tests/test_nystrom.py's PSD operand: eigenvalues decay^i."""
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((n, n)))
    return (q * decay ** np.arange(n)[None, :]) @ q.T


def _sines(x, y):
    """Sines of the principal angles between the column spans
    (tests/test_torch_lstsq_nystrom.py's)."""
    qx, _ = np.linalg.qr(x)
    qy, _ = np.linalg.qr(y)
    return np.linalg.svd(qy - qx @ (qx.T @ qy), compute_uv=False)


def test_nystrom_sharded_input_matches_replicated(mesh8, ranks,
                                                  monkeypatch):
    """(i) lam rtol 1e-10, U atol 1e-10 (the JAX test's); (ii) lam RTOL,
    the span within 1e-8 rad (tests/test_torch_lstsq_nystrom.py)."""
    a = _psd(64, seed=5)
    out, tally = sharded(ranks, "rsvd.nystrom:nystrom_psd", a, k=6)
    assert set(tally) == {"all_reduce"}
    want = single("rsvd.nystrom:nystrom_psd", a, k=6)
    np.testing.assert_allclose(out[1], want[1], rtol=1e-10)
    np.testing.assert_allclose(whole(out[0]), want[0], atol=1e-10)
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    u_j, w_j = _jax("rsvd.nystrom").nystrom_psd(shard_rows8(mesh8, a), k=6)
    u_t, w_t = single("rsvd.nystrom:nystrom_psd", a, k=6)
    np.testing.assert_allclose(w_t, np.asarray(w_j), rtol=RTOL)
    assert _sines(u_t, np.asarray(u_j)).max() <= 1e-8


def _decaying(m, n, seed, decay=0.5):
    """tests/test_rlu.py's operand: sigma_i = decay^i."""
    g = np.random.default_rng(seed)
    q, _ = np.linalg.qr(g.standard_normal((m, m)))
    w, _ = np.linalg.qr(g.standard_normal((n, n)))
    r = min(m, n)
    return (q[:, :r] * decay ** np.arange(r)) @ w[:r, :]


def test_rlu_sharded_input_matches_replicated(mesh8, ranks, monkeypatch):
    """(i) both permutations equal, L and U atol 1e-10 (the JAX test's);
    the range panel gathered once, A never."""
    a = _decaying(96, 64, seed=7)
    kw = dict(k=12, p=6)
    out, tally = sharded(ranks, "rsvd.rlu:rlu", a, **kw)
    assert tally["all_gather"]["calls"] == 1
    no_whole_gather(tally, a)
    want = single("rsvd.rlu:rlu", a, **kw)
    np.testing.assert_array_equal(out[0], want[0])
    np.testing.assert_array_equal(out[1], want[1])
    np.testing.assert_allclose(whole(out[2]), want[2], atol=1e-10)
    np.testing.assert_allclose(out[3], want[3], atol=1e-10)
    assert out[2]["placements"] == ["S(0)"]
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    res_j = _jax("rsvd.rlu").rlu(shard_rows8(mesh8, a), **kw)
    got = single("rsvd.rlu:rlu", a, **kw)
    np.testing.assert_array_equal(got[0], np.asarray(res_j.perm_rows))
    np.testing.assert_array_equal(got[1], np.asarray(res_j.perm_cols))
    for g, name in zip(got[2:], ("l_factor", "u_factor", "l_ortho", "u2")):
        assert _rel(g, getattr(res_j, name)) <= RTOL


# --- tests/test_image.py:72-80 and :247-262 ---------------------------------


def _lowrank(rng, m, n, r, scale=255.0):
    """tests/test_image.py's image: rank r, scaled to [0, scale]."""
    a = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    return (a - a.min()) / (a.max() - a.min()) * scale


@pytest.mark.parametrize("mesh", ["rows", "tile"])
def test_compress_tiled_on_mesh(mesh8, rng, ranks, mesh):
    """Grid (2, 4) over the four ranks (a (4,) mesh: 2 tiles a rank; the
    (2, 2) tile mesh: 4 tiles on each rank of its first axis): the JAX
    test's bar, reconstruction within 1e-3 of the image; (i) the tile
    factors' reconstruction within CODEC_RTOL of the one-rank call's;
    no collective but the three factor gathers; (ii) the one-rank call
    against JAX's sharded call on the mesh, JAX's tile sketches."""
    a = _lowrank(rng, 128, 256, 6)
    res = ranks.run("tiled", data=a, k=8, grid=(2, 4), mesh=mesh)[0]
    assert res["sharding"][0] == "S(0)"
    assert set(res["tally"]) == {"all_gather"}
    assert res["tally"]["all_gather"]["calls"] == 3
    assert _rel(res["rec"], a) < 1e-3
    one = timage.Image(a).compress_tiled(k=8, grid=(2, 4), device="cpu",
                                         dtype=torch.float64)
    assert one.last_tile_sharding is None
    assert _rel(res["rec"], one.reconstruct()) <= CODEC_RTOL
    jim = jimage.Image(a).compress_tiled(k=8, grid=(2, 4), mesh=mesh8,
                                         dtype=jnp.float64)
    assert not jim.last_tile_sharding.is_fully_replicated
    assert _rel(jim.reconstruct(), a) < 1e-3
    key = jax.random.PRNGKey(0)
    omegas = [jax_sketch_matrix(jax_fold_in_shard(key, i), 64, 18,
                                jnp.float64) for i in range(8)]
    with pytest.MonkeyPatch.context() as mp:
        _queue(mp, timage, "sketch_matrix", omegas)
        tim = timage.Image(a).compress_tiled(k=8, grid=(2, 4), device="cpu",
                                             dtype=torch.float64)
    assert _rel(tim.reconstruct(), jim.reconstruct()) <= CODEC_RTOL
    top = slice(0, 6)                      # the tiles' rank: sigma above 0
    assert _rel(tim.tile_factors.s[:, top],
                jim.tile_factors.s[:, top]) <= CODEC_RTOL


def test_video_batch_compression(mesh8, rng, ranks, monkeypatch):
    """Eight frames over the four ranks: the JAX test's shapes and bar
    (reconstruction within 1e-4); (i) within CODEC_RTOL of the one-rank
    call's; (ii) the one-rank call against JAX's on mesh8."""
    t, h, w, r = 8, 48, 64, 6
    frames = np.stack([rng.standard_normal((h, r))
                       @ rng.standard_normal((r, w)) for _ in range(t)])
    res = ranks.run("video", frames=frames, k=r, p=4)[0]
    assert set(res["tally"]) == {"all_gather"}
    u, s, v = res["u"], res["s"], res["v"]
    assert u.shape == (t, h, r) and s.shape == (t, r) and v.shape == (t, w, r)
    rec = timage.reconstruct_video(u, s, v)
    assert _rel(rec, frames) < 1e-4
    one = timage.compress_video(frames, k=r, p=4, device="cpu",
                                dtype=torch.float64)
    assert _rel(rec, timage.reconstruct_video(*one)) <= CODEC_RTOL
    ju, js, jv = jimage.compress_video(frames, k=r, p=4, mesh=mesh8,
                                       dtype=jnp.float64)
    _queue(monkeypatch, timage, "sketch_matrix", [jax_sketch_matrix(
        jax.random.PRNGKey(0), w, r + 4, jnp.float64)])
    tu, ts, tv = timage.compress_video(frames, k=r, p=4, device="cpu",
                                       dtype=torch.float64)
    assert _rel(ts, js) <= CODEC_RTOL
    assert _rel(timage.reconstruct_video(tu, ts, tv),
                jimage.reconstruct_video(ju, js, jv)) <= CODEC_RTOL


# --- rsvd_batched on a batch-sharded stack (__graft_entry__.py:238-275) -----


@pytest.mark.parametrize("mode", ["scan", "vmap"])
def test_rsvd_batched_batch_sharded(mesh8, ranks, monkeypatch, mode):
    """2P x 64^2, k 8: no collective, U, s and V sharded on the batch
    dim with two elements a rank, (i) equal to the one-rank call to
    1e-12 of each element's sigma_1; (ii) the one-rank call against JAX's
    on a batch-sharded mesh8 array at 1e-9 (tests/test_torch_driver_modes.py)."""
    stack = np.random.default_rng(2).standard_normal((2 * RANKS, 64, 64))
    kw = dict(k=8, q=1, mode=mode)
    out, tally = sharded(ranks, "rsvd.driver:rsvd_batched", stack,
                         layouts=("batch",), **kw)
    assert tally == {}
    for part in out:
        assert part["placements"] == ["S(0)"]
        assert part["local"].shape[0] == 2
    want = single("rsvd.driver:rsvd_batched", stack, **kw)
    s1 = want[1]
    assert (np.abs(out[1]["whole"] - s1) / s1[:, :1]).max() <= 1e-12
    monkeypatch.setattr(tdriver, "generate_omega", _jax_omega)
    u_j, s_j, v_j = _jax("rsvd.driver").rsvd_batched(
        jax.device_put(jnp.asarray(stack), NamedSharding(mesh8, P("rows"))),
        **kw)
    if mode == "vmap":                     # lax.map's outputs are whole
        assert not s_j.sharding.is_fully_replicated
    u_t, s_t, v_t = single("rsvd.driver:rsvd_batched", stack, **kw)
    assert _rel(s_t, s_j) <= CODEC_RTOL
    rec_t = (u_t * s_t[:, None, :]) @ np.swapaxes(v_t, 1, 2)
    rec_j = (np.asarray(u_j) * np.asarray(s_j)[:, None, :]) @ np.swapaxes(
        np.asarray(v_j), 1, 2)
    assert _rel(rec_t, rec_j) <= CODEC_RTOL
