"""The port's precision policy (``core/device.py``): 'high' against the
JAX package's 'high' on the CPU, the TF32 switch around its product,
and ``eigh``'s orthonormal eigenvectors."""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.rsvd import driver as jdrv
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert, device
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdrv

# the port's entry points default to the card; these tests run on the CPU
from_numpy = functools.partial(convert.from_numpy, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _operands(dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((96, 200)) * np.logspace(0, -3, 200)[None, :]
    b = rng.standard_normal((200, 24))
    return a.astype(dtype), b.astype(dtype)


def test_high_is_a_precision_of_its_own():
    assert device.resolve_precision("high") == "high"
    assert device.resolve_precision("HIGH") == "high"
    assert "high" in device.PRECISIONS
    with pytest.raises(ValueError, match="unknown precision"):
        device.resolve_precision("higher")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_high_on_the_cpu_is_full_precision(dtype):
    """JAX's HIGH computes in full precision on the CPU; so does the
    port's 'high', bitwise its 'highest'."""
    a, b = (from_numpy(x) for x in _operands(dtype))
    assert torch.equal(device.matmul_at(a, b, "high"),
                       device.matmul_at(a, b, "highest"))


def test_rsvd_at_high_matches_jax_at_high():
    """rsvd at 'high' on the same Omega, JAX (x64, CPU) against the port
    at f64: singular values and the reconstruction within 1e-12."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((120, 90)) * 0.9 ** np.arange(90)[None, :])
    omega = rng.standard_normal((90, 20))
    kw = dict(q=2, k=12, method="eigh", qr_method="robust")
    ju, js, jv = (np.asarray(x) for x in jdrv.rsvd_with_omega(
        jnp.asarray(a), jnp.asarray(omega), precision="high", **kw))
    tu, ts, tv = (x.numpy() for x in tdrv.rsvd_with_omega(
        from_numpy(a), from_numpy(omega), precision="high", **kw))
    assert np.abs(ts - js).max() <= 1e-12 * js[0]
    rec_t, rec_j = (tu * ts) @ tv.T, (ju * js) @ jv.T
    assert np.linalg.norm(rec_t - rec_j) <= 1e-12 * np.linalg.norm(a)


@pytest.mark.parametrize("allow", [False, True])
def test_tf32_product_restores_the_callers_setting(allow):
    """'high''s TF32 product and 'highest''s IEEE product switch TF32 for
    the duration of the product only."""
    a, b = (from_numpy(x) for x in _operands())
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        assert torch.equal(device.tf32_product(a, b), a @ b)
        assert torch.backends.cuda.matmul.allow_tf32 is allow
        device.matmul_at(a, b, "highest")
        assert torch.backends.cuda.matmul.allow_tf32 is allow
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eigh_matches_torch_eigh(dtype):
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 40, 40)))
    g = (g @ g.transpose(1, 2)).to(dtype)
    lam, q = device.eigh(g)
    lam0, q0 = torch.linalg.eigh(g)
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    assert torch.allclose(lam, lam0, rtol=0, atol=tol * float(lam0.max()))
    assert torch.allclose(q.abs(), q0.abs(), rtol=0, atol=tol * 10)
    eye = torch.eye(40, dtype=dtype)
    assert float((q.transpose(1, 2) @ q - eye).abs().max()) <= tol


def test_eigh_restores_orthonormal_eigenvectors():
    """A solver whose eigenvectors are orthogonal only to 4e-5 (what
    torch's f32 eigh gives on the card) comes back orthonormal to
    rounding after the Newton--Schulz step."""
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 64, 64)))
    g = g @ g.transpose(1, 2)
    lam0, q0 = torch.linalg.eigh(g)
    noise = 5e-6 * torch.from_numpy(
        np.random.default_rng(4).standard_normal(q0.shape))

    def sloppy(x):
        return lam0, q0 + noise
    with mock.patch.object(torch.linalg, "eigh", sloppy):
        lam, q = device.eigh(g)
    eye = torch.eye(64, dtype=torch.float64)
    assert float((q0 + noise).transpose(1, 2).matmul(q0 + noise)
                 .sub(eye).abs().max()) > 1e-5
    assert float((q.transpose(1, 2) @ q - eye).abs().max()) <= 1e-8
    assert float((q - q0).abs().max()) <= 1e-4
