"""Kernel K5 (``quantize_uint8``) of the PyTorch port against the JAX
Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
kernel runs in Pallas interpret mode, as tests/test_pallas.py runs it.
The deterministic plain version must be bitwise JAX's (q, scale, lo).
The stochastic one cannot match the TPU PRNG's bits (nor JAX's CPU
branch, which draws from ``jax.random``): it is held to the statistical
tests of tests/test_pallas.py and to a numpy model of its own hash.  The
CUDA kernel is held to the plain version on the card by
``chip_smoke.py``."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.linalg.pallas_kernels import (
    quantize_uint8 as jax_quantize_uint8,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import kernels

# the port's entry points default to the card; these tests run on the CPU
from_numpy = functools.partial(convert.from_numpy, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _input(kind):
    """(numpy array, jnp dtype): tests/test_pallas.py:81-96's shapes and
    the edge cases of the affine grid."""
    rng = np.random.default_rng(7)
    if kind in ("37x53", "1000", "3x5x7"):
        shape = tuple(int(d) for d in kind.split("x"))
        return rng.standard_normal(shape).astype(np.float32) * 3.0, None
    if kind == "64x128":
        return rng.standard_normal((64, 128)).astype(np.float32) * 5.0, None
    if kind == "constant":                   # hi == lo: scale = f32 tiny
        return np.full((9, 11), -2.75, np.float32), None
    if kind == "grid":                       # every level exactly
        return np.linspace(0, 255, 256, dtype=np.float32), None
    if kind == "half_levels":                # (x - lo) / scale = j + 1/2
        x = np.concatenate([[0.0, 255.0], np.arange(255) + 0.5])
        return x.astype(np.float32), None
    if kind == "bf16":
        return rng.standard_normal((33, 40)).astype(np.float32), jnp.bfloat16
    if kind == "f64":
        return rng.standard_normal((25, 31)) * 1e3, jnp.float64
    raise ValueError(kind)


KINDS = ["37x53", "1000", "3x5x7", "64x128", "constant", "grid",
         "half_levels", "bf16", "f64"]


@pytest.mark.parametrize("kind", KINDS)
def test_reference_bitwise_equals_jax(kind):
    x, dtype = _input(kind)
    xj = jnp.asarray(x) if dtype is None else jnp.asarray(x, dtype=dtype)
    qj, scale_j, lo_j = jax_quantize_uint8(xj, interpret=True)
    xt = from_numpy(np.asarray(xj))          # the same values, bf16 too
    assert xt.dtype == {None: torch.float32, jnp.bfloat16: torch.bfloat16,
                        jnp.float64: torch.float64}[dtype]
    qt, scale_t, lo_t = kernels.quantize_uint8_reference(xt)
    assert qt.dtype == torch.uint8 and tuple(qt.shape) == x.shape
    assert scale_t.shape == () and scale_t.dtype == torch.float32
    assert lo_t.shape == () and lo_t.dtype == torch.float32
    np.testing.assert_array_equal(to_numpy(qt), np.asarray(qj))
    assert to_numpy(scale_t).tobytes() == np.asarray(scale_j,
                                                     np.float32).tobytes()
    assert to_numpy(lo_t).tobytes() == np.asarray(lo_j, np.float32).tobytes()


def test_reference_edge_values():
    """The constant input's scale is f32 tiny and its bytes 0; the grid
    reproduces itself; half-levels round to even."""
    _, scale, _ = kernels.quantize_uint8_reference(
        from_numpy(_input("constant")[0]))
    assert float(scale) == float(torch.finfo(torch.float32).tiny)
    q, scale, lo = kernels.quantize_uint8_reference(
        from_numpy(_input("grid")[0]))
    assert float(scale) == 1.0 and float(lo) == 0.0
    np.testing.assert_array_equal(to_numpy(q), np.arange(256))
    q, _, _ = kernels.quantize_uint8_reference(
        from_numpy(_input("half_levels")[0]))
    half = np.arange(255)                    # j + 1/2 -> the even neighbour
    np.testing.assert_array_equal(to_numpy(q)[2:], half + half % 2)


def test_wrapper_on_cpu_is_the_reference_and_counts_nothing():
    x = from_numpy(_input("37x53")[0])
    before = (kernels.quantize_uint8.launches,
              kernels.quantize_uint8.launches_stochastic)
    for stochastic in (False, True):
        got = kernels.quantize_uint8(x, stochastic=stochastic, seed=5,
                                     interpret=True)
        want = kernels.quantize_uint8_reference(x, stochastic, 5)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert (kernels.quantize_uint8.launches,
            kernels.quantize_uint8.launches_stochastic) == before


@pytest.mark.parametrize("bad", ["int", "empty"])
def test_wrapper_rejects_bad_input(bad):
    if bad == "int":
        with pytest.raises(TypeError):
            kernels.quantize_uint8(torch.arange(6))
    else:
        with pytest.raises(ValueError):
            kernels.quantize_uint8(torch.zeros((0, 3)))


def _np_mix(h):
    """pallas_kernels._mix in numpy's wrapping uint32."""
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


@pytest.mark.parametrize("seed", [0, 1, 12345, -3, 2 ** 32 + 9])
def test_sr_uniforms_match_numpy_uint32_hash(seed):
    n = 5000
    with np.errstate(over="ignore"):
        idx = np.arange(n, dtype=np.uint32)
        h = _np_mix(idx ^ _np_mix(np.uint32(seed & 0xFFFFFFFF)))
    want = (h >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)
    got = to_numpy(kernels.quantize_sr_uniforms(n, seed, device="cpu"))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() < 1.0


def test_stochastic_reference_matches_numpy_model():
    """floor(s) + (u < s - floor(s)) with s = (x - lo) * (1 / scale), every
    operation in f32, the kernel's own arithmetic."""
    x = _input("64x128")[0]
    q, scale, lo = kernels.quantize_uint8_reference(from_numpy(x), True, 11)
    lo_np = np.float32(x.min())
    scale_np = (np.float32(x.max()) - lo_np) / np.float32(255.0)
    s = (x - lo_np) * (np.float32(1.0) / scale_np)
    fl = np.floor(s)
    u = to_numpy(kernels.quantize_sr_uniforms(x.size, 11, "cpu"))
    want = np.clip(fl + (u.reshape(x.shape) < s - fl), 0, 255).astype(
        np.uint8)
    assert float(scale) == scale_np and float(lo) == lo_np
    np.testing.assert_array_equal(to_numpy(q), want)


def test_stochastic_bytes_do_not_depend_on_shape():
    x = _input("64x128")[0]
    q2, _, _ = kernels.quantize_uint8_reference(from_numpy(x), True, 4)
    for shape in ((8192,), (16, 8, 64), (128, 64)):
        q, _, _ = kernels.quantize_uint8_reference(
            from_numpy(x.reshape(shape)), True, 4)
        np.testing.assert_array_equal(to_numpy(q).ravel(),
                                      to_numpy(q2).ravel())


# tests/test_pallas.py:134-184, on the plain version


def test_stochastic_within_one_step_of_deterministic():
    rng = np.random.default_rng(0)
    x = from_numpy(rng.random((30, 20)).astype(np.float32))
    qd, sc, lo = kernels.quantize_uint8_reference(x)
    qs, sc2, lo2 = kernels.quantize_uint8_reference(x, stochastic=True,
                                                    seed=1)
    assert float(sc) == float(sc2) and float(lo) == float(lo2)
    diff = np.abs(to_numpy(qs).astype(np.int32) - to_numpy(qd).astype(
        np.int32))
    assert diff.max() <= 1 and diff.max() == 1


def test_stochastic_mean_unbiased():
    rng = np.random.default_rng(1)
    x_np = rng.random((20, 16)).astype(np.float32)
    x = from_numpy(x_np)
    n = 200
    acc = np.zeros(x_np.shape, np.float64)
    for s in range(n):
        q, sc, lo = kernels.quantize_uint8_reference(x, stochastic=True,
                                                     seed=s)
        acc += to_numpy(q).astype(np.float64) * float(sc) + float(lo)
    bias = np.abs(acc / n - x_np)
    # per-entry stderr = scale/2/sqrt(n); allow 6 sigma on the max
    assert bias.max() < 6.0 * float(sc) / 2.0 / np.sqrt(n)


def test_stochastic_grid_values_exact():
    x_np = np.linspace(0, 255, 256, dtype=np.float32)
    q, sc, lo = kernels.quantize_uint8_reference(from_numpy(x_np),
                                                 stochastic=True, seed=3)
    np.testing.assert_allclose(
        to_numpy(q).astype(np.float64) * float(sc) + float(lo), x_np,
        atol=1e-5)
