"""Differentiability of the port's factorization pipeline
(``torch.autograd`` and ``torch.func``) against the JAX package's
(``tests/test_autodiff.py``), on the CPU in f64.

Each of the JAX test's eight cases runs here with the JAX package's Omega
patched into the port's ``generate_omega``, so that both packages
differentiate the same function: where the JAX test only asks for a
finite gradient, the port's gradient (or tangent) is held to JAX's at
``RTOL`` = 1e-8 relative -- gradients run through an eigh and two
CholeskyQR2 passes, whose backward amplifies the forward's 1e-15
differences by the inverse eigenvalue gaps.  ``torch.func.vmap`` runs
with ``randomness='same'``: JAX's vmap reuses one key for the stack.
The Jacobi tails are forward-only in both packages."""

import functools

import numpy as np
import pytest
import torch
from torch.func import grad, jvp, vmap

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.rsvd import (
    deim_fit as jax_deim_fit,
    deim_interpolate as jax_deim_interpolate,
    nystrom_psd as jax_nystrom_psd,
    reconstruct as jax_reconstruct,
    rsvd as jax_rsvd,
)
from rsvd_kamaneh_raganato_terrana_tpu.rsvd.driver import (
    generate_omega as jax_generate_omega,
    rsvd_with_omega as jax_rsvd_with_omega,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdriver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.deim import (
    deim_fit,
    deim_interpolate,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    reconstruct,
    rsvd,
    rsvd_with_omega,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.nystrom import nystrom_psd

from_numpy = functools.partial(convert.from_numpy, device="cpu")
RTOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_draws(monkeypatch):
    def draw(seed, n, l, dtype=torch.float64, kind="gaussian", device=None):
        return from_numpy(np.asarray(jax_generate_omega(
            int(seed), n, l, jnp.float64, kind)))
    monkeypatch.setattr(tdriver, "generate_omega", draw)


def _rel(got, want):
    got = to_numpy(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def _well_separated(m, n, seed=0, lo=1e-2):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, min(m, n))))
    v, _ = np.linalg.qr(rng.standard_normal((n, min(m, n))))
    return u @ np.diag(np.geomspace(1.0, lo, min(m, n))) @ v.T


def test_grad_matches_finite_difference(jax_draws):
    a = _well_separated(60, 40, seed=0)

    def loss(x):
        u, s, v = rsvd(x, k=8, p=8, q=2, method="eigh")
        return torch.sum(s * s) + 0.1 * torch.sum(reconstruct(u, s, v) ** 2)

    def jloss(x):
        u, s, v = jax_rsvd(x, k=8, p=8, q=2, method="eigh")
        return jnp.sum(s * s) + 0.1 * jnp.sum(jax_reconstruct(u, s, v) ** 2)

    at = from_numpy(a).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(at), at)
    assert torch.isfinite(g).all()
    assert _rel(g, jax.grad(jloss)(jnp.asarray(a))) <= RTOL
    d = from_numpy(np.random.default_rng(1).standard_normal(a.shape))
    eps = 1e-6
    with torch.no_grad():
        fd = (loss(at + eps * d) - loss(at - eps * d)) / (2 * eps)
    np.testing.assert_allclose(float(torch.sum(g * d)), float(fd), rtol=1e-6)


def test_singular_value_gradient_is_rank_one(jax_draws):
    rng = np.random.default_rng(2)
    u, _ = np.linalg.qr(rng.standard_normal((50, 30)))
    v, _ = np.linalg.qr(rng.standard_normal((30, 30)))
    s = np.concatenate([[1.0, 0.7, 0.5, 0.3], np.full(26, 1e-5)])
    a = u @ np.diag(s) @ v.T

    g = grad(lambda x: rsvd(x, k=4, p=6, q=2, method="eigh")[1][0])(
        from_numpy(a))
    u0, _, v0t = np.linalg.svd(a)
    np.testing.assert_allclose(to_numpy(g), np.outer(u0[:, 0], v0t[0]),
                               atol=1e-6)
    want = jax.grad(lambda x: jax_rsvd(x, k=4, p=6, q=2,
                                       method="eigh")[1][0])(jnp.asarray(a))
    assert _rel(g, want) <= RTOL


def test_compression_aware_loss_descends(jax_draws):
    a = np.random.default_rng(3).standard_normal((40, 40))

    def resid(x):
        u, s, v = rsvd(x, k=5, p=5, q=1, method="eigh")
        return torch.sum((x - reconstruct(u, s, v)) ** 2)

    at = from_numpy(a).requires_grad_(True)
    val = resid(at)
    (g,) = torch.autograd.grad(val, at)
    with torch.no_grad():
        assert float(resid(at - 1e-2 * g)) < float(val)
    want = jax.grad(lambda x: jnp.sum((x - jax_reconstruct(*jax_rsvd(
        x, k=5, p=5, q=1, method="eigh"))) ** 2))(jnp.asarray(a))
    assert _rel(g, want) <= RTOL


def test_grad_through_explicit_omega():
    a = _well_separated(40, 30, seed=4)
    omega = np.random.default_rng(5).standard_normal((30, 10))
    at = from_numpy(a)

    def loss(om):
        u, s, v = rsvd_with_omega(at, om, q=1, k=6, method="eigh")
        return torch.sum((at - reconstruct(u, s, v)) ** 2)

    g = grad(loss)(from_numpy(omega))
    assert g.shape == omega.shape and torch.isfinite(g).all()
    want = jax.grad(lambda om: jnp.sum((jnp.asarray(a) - jax_reconstruct(
        *jax_rsvd_with_omega(jnp.asarray(a), om, q=1, k=6,
                             method="eigh"))) ** 2))(jnp.asarray(omega))
    assert _rel(g, want) <= RTOL


def _stack():
    return np.stack([_well_separated(24, 16, seed=s) for s in (6, 7)])


def test_vmapped_grad(jax_draws):
    """vmap(grad(.)) over rsvd's default 'robust' QR: under the transform
    the fallback is a select of both branches, as under jax.vmap."""
    stack = _stack()

    def loss(x):
        return torch.sum(rsvd(x, k=3, p=5, q=1, method="eigh")[1])

    gs = vmap(grad(loss), randomness="same")(from_numpy(stack))
    assert gs.shape == stack.shape and torch.isfinite(gs).all()
    want = jax.vmap(jax.grad(lambda x: jnp.sum(jax_rsvd(
        x, k=3, p=5, q=1, method="eigh")[1])))(jnp.asarray(stack))
    assert _rel(gs, want) <= RTOL
    # each slice is the plain gradient of that matrix
    for i in range(2):
        assert _rel(gs[i], to_numpy(grad(loss)(from_numpy(stack[i])))) \
            <= 1e-12


def test_vmapped_grad_on_its_own_draws_and_explicit_omega():
    stack = from_numpy(_stack())
    omega = from_numpy(np.random.default_rng(8).standard_normal((16, 8)))

    def loss_omega(x):
        return torch.sum(rsvd_with_omega(x, omega, q=1, k=3,
                                         method="eigh")[1])

    gs = vmap(grad(loss_omega))(stack)
    want = jax.vmap(jax.grad(lambda x: jnp.sum(jax_rsvd_with_omega(
        x, jnp.asarray(to_numpy(omega)), q=1, k=3, method="eigh")[1])))(
        jnp.asarray(to_numpy(stack)))
    assert _rel(gs, want) <= RTOL
    gs_own = vmap(grad(lambda x: torch.sum(rsvd(x, k=3, p=5, q=1,
                                                method="eigh")[1])),
                  randomness="same")(stack)
    assert torch.isfinite(gs_own).all()


def test_jvp_forward_mode(jax_draws):
    a = _well_separated(30, 20, seed=8)
    d = np.random.default_rng(9).standard_normal(a.shape)

    def sigmas(x):
        return rsvd(x, k=4, p=4, q=1, method="eigh")[1]

    _, tangent = jvp(sigmas, (from_numpy(a),), (from_numpy(d),))
    assert tangent.shape == (4,) and torch.isfinite(tangent).all()
    _, want = jax.jvp(lambda x: jax_rsvd(x, k=4, p=4, q=1, method="eigh")[1],
                      (jnp.asarray(a),), (jnp.asarray(d),))
    assert _rel(tangent, want) <= RTOL


def test_grad_through_nystrom(jax_draws):
    b = np.random.default_rng(10).standard_normal((30, 30))
    a = b @ b.T + 30 * np.eye(30)
    g = grad(lambda x: torch.sum(nystrom_psd(x, k=6)[1]))(from_numpy(a))
    assert torch.isfinite(g).all()
    want = jax.grad(lambda x: jnp.sum(jax_nystrom_psd(x, k=6)[1]))(
        jnp.asarray(a))
    assert _rel(g, want) <= RTOL


def test_grad_through_deim_interpolation(jax_draws):
    snaps = np.random.default_rng(11).standard_normal((50, 4))
    d = deim_fit(from_numpy(snaps), m=4, p=0)
    dj = jax_deim_fit(jnp.asarray(snaps), m=4, p=0)
    np.testing.assert_array_equal(to_numpy(d.indices), np.asarray(dj.indices))

    g = grad(lambda f: torch.sum(deim_interpolate(d, f) ** 2))(
        from_numpy(snaps[:, 0]))
    assert torch.isfinite(g).all()
    nz = np.nonzero(to_numpy(g))[0]
    assert set(nz).issubset(set(to_numpy(d.indices)))
    want = jax.grad(lambda f: jnp.sum(jax_deim_interpolate(dj, f) ** 2))(
        jnp.asarray(snaps[:, 0]))
    assert _rel(g, want) <= RTOL
