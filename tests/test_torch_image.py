"""The image codec of the PyTorch port (``apps/image.py``, its CLI, the
host codec of ``native/`` and ``core/rng.py::fold_in_shard``) against
the JAX package's ``apps/image.py``.

Torch's generators cannot reproduce JAX's threefry draws, so each parity
test hands the JAX package's sketch matrices to the port by patching the
port's draw.  The JAX side runs in float64 (tests/conftest.py turns x64
on), the port in ``torch.float64``, both on the CPU.  Factor files are
compared byte for byte: the port builds its own copy of ``codec.cpp``
with the JAX package's flags."""

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.apps import image as jimage
from rsvd_kamaneh_raganato_terrana_tpu.core.rng import (
    fold_in_shard as jax_fold_in_shard,
    sketch_matrix as jax_sketch_matrix,
)
from rsvd_kamaneh_raganato_terrana_tpu import native as jax_native
from rsvd_kamaneh_raganato_terrana_tpu.rsvd.driver import (
    generate_omega as jax_generate_omega,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch import __main__ as tmain
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import image as timage
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.image_main import (
    main as image_cli,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
    fold_in_shard,
    key_from_seed,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.native import get_codec
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdriver

from conftest import DATA_DIR

# the port's entry points default to the card; these tests run on the CPU
from_numpy = functools.partial(convert.from_numpy, device="cpu")
CPU = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _photo(shape, seed=0):
    """A smooth low-rank-ish 'photo' in [0, 255] with a little noise."""
    rng = np.random.default_rng(seed)
    m, n = shape[:2]
    y, x = np.mgrid[0:m, 0:n] / max(m, n)
    img = 120 + 80 * np.sin(3 * x + 2 * y) * np.cos(2 * x - y)
    if len(shape) == 3:
        img = np.stack([img * (0.8 + 0.1 * c) for c in range(shape[2])], 2)
    return np.clip(img + rng.normal(0, 2, shape), 0, 255)


def _rel(a, b):
    return np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max()


# -- fold_in_shard ----------------------------------------------------------

def test_fold_in_shard_streams():
    key = key_from_seed(3, "cpu")
    draws = [torch.randn(4, generator=fold_in_shard(key, i))
             for i in range(4)]
    again = torch.randn(4, generator=fold_in_shard(key_from_seed(3, "cpu"),
                                                   2))
    assert torch.equal(draws[2], again)                   # deterministic
    assert len({tuple(d.tolist()) for d in draws}) == 4   # one per index
    other = torch.randn(4, generator=fold_in_shard(key_from_seed(4, "cpu"),
                                                   2))
    assert not torch.equal(draws[2], other)               # keyed on the seed
    assert fold_in_shard(key, 0).device == key.device
    # folding does not draw from (or advance) the key
    assert torch.equal(torch.randn(3, generator=key),
                       torch.randn(3, generator=key_from_seed(3, "cpu")))


# -- the host codec ---------------------------------------------------------

@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's native library, built from its sources with its
    Makefile's flags into a directory of this module's own: the in-tree
    library may be half-written by another test worker's build, and the
    JAX package falls back to numpy without one."""
    src = Path(jax_native.__file__).parent
    out = tmp_path_factory.mktemp("jax_native") / "librsvd_native.so"
    cxx = shutil.which("g++") or shutil.which("c++")
    subprocess.run([cxx, "-O3", "-fPIC", "-Wall", "-Wextra", "-std=c++17",
                    "-shared", "-o", str(out), str(src / "mmio.cpp"),
                    str(src / "codec.cpp")], check=True, capture_output=True)
    return jax_native.NativeLib(ctypes.CDLL(str(out)))


@pytest.mark.parametrize("kind", ["gauss", "constant", "factor_range"])
def test_codec_bytes_equal_jax_native(kind, jax_lib):
    rng = np.random.default_rng(1)
    x = {"gauss": rng.standard_normal((37, 11)),
         "constant": np.full(50, 0.25),
         "factor_range": rng.uniform(-300, 300, 997)}[kind]
    codec = get_codec()
    q, scale, offset = codec.quantize_affine(x)
    qj, scale_j, offset_j = jax_lib.quantize_affine(x)
    assert q.tobytes() == qj.tobytes()
    assert (scale, offset) == (scale_j, offset_j)
    np.testing.assert_array_equal(codec.dequantize_affine(q, scale, offset),
                                  jax_lib.dequantize_affine(q, scale, offset))
    np.testing.assert_array_equal(codec.quantize_truncate(x),
                                  jax_lib.quantize_truncate(x))
    np.testing.assert_array_equal(codec.dequantize_truncate(q),
                                  jax_lib.dequantize_truncate(q))


def test_numpy_stand_in_differs_by_at_most_one_level():
    """The JAX fallback divides by scale where the codec multiplies by
    1 / scale: at most one level apart."""
    x = np.random.default_rng(2).standard_normal(20000)
    q, scale, offset = get_codec().quantize_affine(x)
    q_np, scale_np, offset_np = timage._quantize_affine_np(x)
    assert (scale, offset) == (scale_np, offset_np)
    assert np.abs(q.astype(int) - q_np.astype(int)).max() <= 1


# -- compression parity -----------------------------------------------------

def _patched_draws(omegas):
    """Patch the port's per-tile, per-channel or per-video draw with the
    JAX package's Omegas, in call order."""
    return mock.patch.object(timage, "sketch_matrix",
                             side_effect=[from_numpy(np.asarray(o))
                                          for o in omegas])


def _jax_tile_omegas(seed, tiles, tw, l):
    key = jax.random.PRNGKey(seed)
    return [jax_sketch_matrix(jax_fold_in_shard(key, i), tw, l, jnp.float64)
            for i in range(tiles)]


@pytest.mark.parametrize("shape,grid", [((48, 40), (2, 2)),
                                        ((50, 43), (2, 3))])
def test_compress_tiled_matches_jax(shape, grid):
    data = _photo(shape)
    k, seed = 6, 5
    jim = jimage.Image(data).normalize().compress_tiled(
        k=k, grid=grid, seed=seed, dtype=jnp.float64)
    gy, gx = grid
    th, tw = -(-shape[0] // gy), -(-shape[1] // gx)
    l = min(k + 10, th, tw)
    with _patched_draws(_jax_tile_omegas(seed, gy * gx, tw, l)) as draw:
        tim = timage.Image(data).normalize().compress_tiled(
            k=k, grid=grid, seed=seed, **CPU)
    assert draw.call_count == gy * gx
    jt, tt = jim.tile_factors, tim.tile_factors
    assert (tt.grid, tt.shape) == (jt.grid, jt.shape)
    assert tt.u.shape == jt.u.shape and tt.v.shape == jt.v.shape
    assert _rel(tt.s, jt.s) <= RTOL
    # per tile, then the cropped assembly
    per_tile = np.einsum("bik,bk,bjk->bij", tt.u, tt.s, tt.v)
    per_tile_j = np.einsum("bik,bk,bjk->bij", jt.u, jt.s, jt.v)
    for i in range(gy * gx):
        assert _rel(per_tile[i], per_tile_j[i]) <= RTOL
    assert tim.reconstruct().shape == shape
    assert _rel(tim.reconstruct(), jim.reconstruct()) <= RTOL
    assert tim.compression_ratio() == jim.compression_ratio()
    assert tim.psnr() == pytest.approx(jim.psnr(), rel=1e-9)


def test_compress_tiled_draws_one_stream_per_tile():
    """Unpatched, tile i sketches with fold_in_shard(key, i)."""
    data = _photo((32, 32))
    tim = timage.Image(data).compress_tiled(k=3, grid=(2, 2), seed=2, **CPU)
    seen = []
    real = timage.sketch_matrix

    def spy(key, n, l, dtype):
        out = real(key, n, l, dtype)
        seen.append(out)
        return out
    with mock.patch.object(timage, "sketch_matrix", spy):
        again = timage.Image(data).compress_tiled(k=3, grid=(2, 2), seed=2,
                                                  **CPU)
    key = key_from_seed(2, "cpu")
    for i, om in enumerate(seen):
        want = torch.randn(16, 13, generator=fold_in_shard(key, i),
                           dtype=torch.float64)
        assert torch.equal(om, want)
    np.testing.assert_array_equal(tim.tile_factors.s, again.tile_factors.s)


def test_last_tile_sharding_is_none_on_one_device():
    """Both packages set it to None at construction; after a tiled run on
    one device the port has no sharded layout to record."""
    data = _photo((32, 32))
    assert jimage.Image(data).last_tile_sharding is None
    tim = timage.Image(data)
    assert tim.last_tile_sharding is None
    tim.compress_tiled(k=3, grid=(2, 2), seed=2, **CPU)
    assert tim.tile_factors is not None
    assert tim.last_tile_sharding is None


@pytest.fixture(scope="module")
def gray_pair():
    data = _photo((64, 56))
    seed = 3
    jim = jimage.Image(data).normalize().compress(seed=seed,
                                                  dtype=jnp.float64)

    def draw(key_or_seed, n, l, dtype=None, kind="gaussian", device=None):
        assert key_or_seed == seed and kind == "gaussian"
        return from_numpy(np.asarray(jax_generate_omega(seed, n, l,
                                                        jnp.float64)))
    with mock.patch.object(tdriver, "generate_omega", draw):
        tim = timage.Image(data).normalize().compress(seed=seed, **CPU)
    return jim, tim


def test_compress_gray_matches_jax(gray_pair):
    jim, tim = gray_pair
    assert tim.S.shape == (14,) == jim.S.shape     # k = min(m, n) / 4
    assert _rel(tim.S, jim.S) <= RTOL
    assert _rel(tim.reconstruct(), jim.reconstruct()) <= RTOL


def test_ratio_and_psnr_match_jax(gray_pair):
    jim, tim = gray_pair
    assert tim.compression_ratio() == jim.compression_ratio()
    assert tim.psnr() == pytest.approx(jim.psnr(), rel=1e-9)
    other = _photo((64, 56), seed=9) / 255.0
    assert tim.psnr(other) == pytest.approx(jim.psnr(other), rel=1e-9)


def test_compress_color_matches_jax():
    data = _photo((40, 36, 3))
    k, seed = 5, 4
    jim = jimage.Image(data).compress(k=k, seed=seed, dtype=jnp.float64)
    omega = jax_sketch_matrix(jax.random.PRNGKey(seed), 36, k + 10,
                              jnp.float64)
    with _patched_draws([omega]):
        tim = timage.Image(data).compress(k=k, seed=seed, **CPU)
    assert tim.U.shape == (3, 40, k) and tim.V.shape == (3, 36, k)
    assert _rel(tim.S, jim.S) <= RTOL
    rec = tim.reconstruct()
    assert rec.shape == (40, 36, 3)
    assert _rel(rec, jim.reconstruct()) <= RTOL
    assert tim.compression_ratio() == jim.compression_ratio()


def test_compress_video_matches_jax():
    frames = np.stack([_photo((30, 26), seed=s) for s in range(3)])
    k, seed = 4, 6
    ju, js, jv = jimage.compress_video(frames, k=k, seed=seed,
                                       dtype=jnp.float64)
    omega = jax_sketch_matrix(jax.random.PRNGKey(seed), 26, k + 10,
                              jnp.float64)
    with _patched_draws([omega]):
        tu, ts, tv = timage.compress_video(frames, k=k, seed=seed, **CPU)
    assert tu.shape == (3, 30, k) and ts.shape == (3, k)
    assert _rel(ts, np.asarray(js)) <= RTOL
    assert _rel(timage.reconstruct_video(tu, ts, tv),
                jimage.reconstruct_video(ju, js, jv)) <= RTOL


def test_mesh_must_be_a_device_mesh_and_tucker_runs():
    """``mesh=`` takes a torch ``DeviceMesh`` (the sharded runs are held
    in tests/test_torch_distributed_extensions.py): anything else raises
    ``TypeError``, and ``mesh=None`` is the one-card run.  The Tucker
    video codec (item 8) runs: on a stack of exact multilinear rank both
    packages' codecs give the stack back."""
    im = timage.Image(_photo((16, 16)))
    with pytest.raises(TypeError, match="DeviceMesh"):
        im.compress_tiled(k=2, mesh=object(), **CPU)
    with pytest.raises(TypeError, match="DeviceMesh"):
        timage.compress_video(np.zeros((2, 8, 8)), k=2, mesh=object(), **CPU)
    one = timage.Image(_photo((16, 16))).compress_tiled(k=2, **CPU)
    none = timage.Image(_photo((16, 16))).compress_tiled(k=2, mesh=None,
                                                         **CPU)
    for got, want in zip((none.tile_factors.u, none.tile_factors.s,
                          none.tile_factors.v),
                         (one.tile_factors.u, one.tile_factors.s,
                          one.tile_factors.v)):
        np.testing.assert_array_equal(got, want)
    assert none.last_tile_sharding is None
    frames = np.stack([_photo((12, 10), seed=s) for s in range(2)])
    for got, want in zip(timage.compress_video(frames, k=2, mesh=None, **CPU),
                         timage.compress_video(frames, k=2, **CPU)):
        np.testing.assert_array_equal(got, want)
    g = np.random.default_rng(5)
    frames = np.einsum("ta,ib,jc,abc->tij", g.standard_normal((3, 1)),
                       g.standard_normal((8, 2)), g.standard_normal((9, 2)),
                       g.standard_normal((1, 2, 2)))  # multilinear (1, 2, 2)
    ranks = (1, 2, 2)
    core_j, f_j = jimage.compress_video_tucker(frames, ranks,
                                               dtype=jnp.float64)
    core, factors = timage.compress_video_tucker(frames, ranks, **CPU)
    assert core.shape == ranks and isinstance(core, np.ndarray)
    rec = timage.reconstruct_video_tucker(core, factors, device="cpu")
    assert _rel(rec, jimage.reconstruct_video_tucker(core_j, f_j)) <= RTOL
    assert _rel(rec, frames) <= RTOL


# -- factor files -----------------------------------------------------------

def _factor_pair(tiled):
    """A JAX and a port Image holding the same factors."""
    rng = np.random.default_rng(8)
    data = rng.uniform(0, 255, (20, 18))
    jim, tim = jimage.Image(data), timage.Image(data)
    if tiled:
        u, s, v = (rng.standard_normal(sh).astype(np.float32)
                   for sh in ((6, 10, 4), (6, 4), (6, 6, 4)))
        s = np.abs(s) * 30
        jim.tile_factors = jimage.TileFactors(u, s, v, (2, 3), (20, 18))
        tim.tile_factors = timage.TileFactors(u, s, v, (2, 3), (20, 18))
    else:
        u, s, v = (rng.standard_normal(sh).astype(np.float32)
                   for sh in ((20, 5), (5,), (18, 5)))
        s = np.abs(s) * 300                     # past one byte: truncation
        jim.U, jim.S, jim.V = u, s, v
        tim.U, tim.S, tim.V = u, s, v
    return jim, tim


def _factors(im):
    if im.tile_factors is not None:
        tf = im.tile_factors
        return [tf.u, tf.s, tf.v], (tf.grid, tf.shape)
    return [im.U, im.S, im.V], None


@pytest.mark.parametrize("mode", ["affine", "truncate"])
@pytest.mark.parametrize("tiled", [False, True])
def test_save_compressed_bytes_equal_jax(mode, tiled, tmp_path, jax_lib):
    jim, tim = _factor_pair(tiled)
    tim.save_compressed(str(tmp_path / "port.rsv"), mode=mode)
    with mock.patch.object(jimage, "get_native_lib", return_value=jax_lib):
        jim.save_compressed(str(tmp_path / "jax.rsv"), mode=mode)
        jback = jimage.Image().load_compressed(str(tmp_path / "port.rsv"))
    assert (tmp_path / "port.rsv").read_bytes() == \
        (tmp_path / "jax.rsv").read_bytes()
    # each package loads the other's file to the same factors
    tback = timage.Image().load_compressed(str(tmp_path / "jax.rsv"))
    (tf, tmeta), (jf, jmeta) = _factors(tback), _factors(jback)
    assert tmeta == jmeta
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a, b)
    if mode == "affine":                      # within half a level
        for a, orig in zip(tf, _factors(tim)[0]):
            step = (orig.max() - orig.min()) / 255.0
            assert np.abs(a - orig).max() <= step / 2 * (1 + 1e-6)


def test_save_compressed_rejects_unknown_mode(tmp_path):
    _, tim = _factor_pair(False)
    with pytest.raises(ValueError):
        tim.save_compressed(str(tmp_path / "x.rsv"), mode="zstd")


def test_reference_dat_bytes_equal_jax(tmp_path):
    jim, tim = _factor_pair(False)
    jim.save_compressed_reference(str(tmp_path / "jax.dat"))
    tim.save_compressed_reference(str(tmp_path / "port.dat"))
    assert (tmp_path / "port.dat").read_bytes() == \
        (tmp_path / "jax.dat").read_bytes()
    tback = timage.Image().load_compressed_reference(str(tmp_path /
                                                         "jax.dat"))
    jback = jimage.Image().load_compressed_reference(str(tmp_path /
                                                         "jax.dat"))
    for a, b in zip(_factors(tback)[0], _factors(jback)[0]):
        np.testing.assert_array_equal(a, b)
    tiled = _factor_pair(True)[1]
    with pytest.raises(ValueError):
        tiled.save_compressed_reference(str(tmp_path / "t.dat"))


# -- the CLI ----------------------------------------------------------------

def test_cli_writes_png_and_factor_file(tmp_path, capsys):
    img = os.path.join(DATA_DIR, "img", "256_01.jpg")
    rc = tmain.main(["image", img, "--k", "12", "--out-dir", str(tmp_path),
                     "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "compression ratio:" in out and "loaded" in out
    png = tmp_path / "256_01_compressed.png"
    rsv = tmp_path / "256_01_factors.rsv"
    assert png.exists() and rsv.exists()
    back = timage.Image.load(str(png))
    assert back.shape == (256, 256)
    loaded = timage.Image(np.zeros((128, 128))).load_compressed(str(rsv))
    tf = loaded.tile_factors
    assert tf.grid == (2, 2) and tf.shape == (128, 128)
    assert tf.u.shape == (4, 64, 12) and tf.s.shape == (4, 12)
    assert np.isfinite(loaded.reconstruct()).all()


def test_cli_direct_call_and_unported_apps(tmp_path, capsys):
    img = os.path.join(DATA_DIR, "img", "256_01.jpg")
    image_cli([img, "--k", "6", "--no-tile", "--downscale", "4",
               "--out-dir", str(tmp_path), "--device", "cpu"])
    assert (tmp_path / "256_01_factors.rsv").exists()
    # every app of the JAX dispatcher is ported: pod parses its own
    # arguments (a missing .prm is argparse's usage error), and an
    # unknown app lists the four
    with pytest.raises(SystemExit) as exc:
        tmain.main(["pod", "x"])
    assert exc.value.code == 2
    assert "prm_file" in capsys.readouterr().err
    assert tmain.main(["video"]) == 1
    assert "expected rsvd|image|pca|pod" in capsys.readouterr().out
    assert tmain.main([]) == 0
