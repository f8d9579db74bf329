"""Kernels K3 (``eigh_small``) and K4 (``fused_sketch_matmul``) of the
PyTorch port against the JAX Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as tests/test_pallas.py runs them
(K3 pads to an even n there, the schedule the plain version follows).
The CUDA kernels are held to the plain versions on the card by
``chip_smoke.py``."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.linalg.pallas_kernels import (
    eigh_small as jax_eigh_small,
    fused_sketch_matmul as jax_fused_sketch_matmul,
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


def _symmetric(kind):
    """tests/test_pallas.py:99-131's inputs and three more."""
    rng = np.random.default_rng(0)
    if kind == "psd24":
        b = rng.standard_normal((24, 72)).astype(np.float32)
        return b @ b.T, True
    if kind == "rank6_n21":                  # odd: padded; rank 6 < n
        b = rng.standard_normal((21, 6)).astype(np.float32)
        return b @ b.T, False
    if kind == "indefinite17":
        x = rng.standard_normal((17, 17)).astype(np.float32)
        return x + x.T, True
    if kind == "n1":
        return np.array([[2.5]], np.float32), True
    if kind == "n2":
        x = rng.standard_normal((2, 2)).astype(np.float32)
        return x + x.T, True
    raise ValueError(kind)


def _sines(x, y):
    """Sines of the principal angles between span(x) and span(y)."""
    qx, _ = np.linalg.qr(x.astype(np.float64))
    qy, _ = np.linalg.qr(y.astype(np.float64))
    return np.linalg.svd(qy - qx @ (qx.T @ qy), compute_uv=False)


@pytest.mark.parametrize("kind", ["psd24", "rank6_n21", "indefinite17",
                                  "n1", "n2"])
def test_eigh_reference_matches_jax_eigh_small(kind):
    g, full_rank = _symmetric(kind)
    lam_j, v_j = (np.asarray(x) for x in jax_eigh_small(jnp.asarray(g)))
    lam_t, v_t = (to_numpy(x) for x in
                  kernels.eigh_small_reference(from_numpy(g)))
    n = g.shape[0]
    assert lam_t.shape == (n,) and v_t.shape == (n, n)
    assert lam_t.dtype == np.float32 and v_t.dtype == np.float32
    scale = np.abs(lam_j).max()
    # the same rotations in the same order; JAX's f32 matmuls and the
    # plain version's elementwise updates round differently (1e-6 seen)
    assert np.abs(lam_t - lam_j).max() <= 1e-5 * scale
    assert np.all(np.diff(lam_t) >= 0)
    if full_rank:
        rec = (v_t * lam_t) @ v_t.T
        # both kernels reach ~1e-5 here (the JAX suite allows 1e-4)
        assert np.linalg.norm(rec - g) / np.linalg.norm(g) <= 1e-4
        assert np.abs(v_t.T @ v_t - np.eye(n)).max() <= 1e-4
        # eigenvector by eigenvector, signs free.  Davis-Kahan: a
        # perturbation of 1e-5 |lambda|max turns eigenvector i by at most
        # 1e-5 |lambda|max / gap_i; twice that is allowed (psd24's
        # smallest gap is 2.5e-3 |lambda|max)
        for i in range(n if n > 1 else 0):
            gap = np.abs(np.delete(lam_j, i) - lam_j[i]).min()
            sine = _sines(v_t[:, i:i + 1], v_j[:, i:i + 1])[0]
            assert sine * gap <= 2e-5 * scale
    else:
        # tests/test_pallas.py:128-131: no pad eigenvalue leaks in, and
        # the spectrum is the f64 one; the null-space rotations of the
        # TPU kernel's arithmetic are far from orthogonal, in JAX too
        assert lam_t.min() > -1e-3
        ref = np.linalg.eigvalsh(g.astype(np.float64))
        assert np.abs(lam_t - ref).max() / ref.max() <= 1e-4
        # the range (eigenvalues above 1e-3 |lambda|max): the null-space
        # rotations leak into it, so both kernels land 5e-4 .. 1.1e-3 from
        # the exact range, which way depending on roundoff
        top_t = v_t[:, lam_t > 1e-3 * scale]
        top_j = v_j[:, lam_j > 1e-3 * scale]
        assert top_t.shape[1] == top_j.shape[1] == 6
        exact = np.linalg.eigh(g.astype(np.float64))[1][:, -6:]
        assert max(_sines(top_t, exact).max(),
                   _sines(top_j, exact).max()) <= 3e-3


# max |V^T V - I| of the plain version's V: chip_smoke.py's K3_ORTH_TOL,
# the JAX suite's orthogonality bound (tests/test_pallas.py:112)
K3_ORTH_TOL = 1e-3


@pytest.mark.parametrize("n", [144, 240])
def test_eigh_reference_matches_f64_eigh_at_cluster_route_sizes(n):
    """The plain version at the streaming and sharded tails' n = 144 and
    the block-Krylov tail's n = 240, where the card runs K3's cluster
    route, against numpy's f64 eigh on a Wishart matrix.  JAX's
    interpret-mode kernel is not run at these sizes (minutes a call)."""
    rng = np.random.default_rng(n)
    b = rng.standard_normal((n, 2 * n)).astype(np.float32)
    g = b @ b.T / (2 * n)
    lam, v = (to_numpy(x) for x in
              kernels.eigh_small_reference(from_numpy(g)))
    ref = np.linalg.eigvalsh(g.astype(np.float64))
    assert lam.shape == (n,) and v.shape == (n, n)
    assert np.all(np.diff(lam) >= 0)
    # the JAX suite's spectrum bar (tests/test_pallas.py:128-131), relative
    # to the largest eigenvalue: the fixed-sweep arithmetic's rotations
    # drift from orthogonal as rounds add up, so the plain version lands
    # 2.7e-5 (n = 144) and 5.8e-5 (n = 240) from the f64 spectrum here
    assert np.abs(lam - ref).max() <= 1e-4 * np.abs(ref).max()
    orth = np.abs(v.T.astype(np.float64) @ v - np.eye(n)).max()
    assert orth <= K3_ORTH_TOL


def test_eigh_wrapper_runs_reference_on_cpu_and_counts_no_launch():
    g = from_numpy(_symmetric("psd24")[0])
    before = kernels.eigh_small.launches
    lam, v = kernels.eigh_small(g, sweeps=3)
    lam0, v0 = kernels.eigh_small_reference(g, sweeps=3)
    assert torch.equal(lam, lam0) and torch.equal(v, v0)
    assert kernels.eigh_small.launches == before


def test_eigh_wrapper_computes_in_f32_and_returns_input_dtype():
    g = from_numpy(_symmetric("indefinite17")[0])
    lam, v = kernels.eigh_small(g.double())
    lam32, v32 = kernels.eigh_small_reference(g)
    assert lam.dtype == v.dtype == torch.float64
    assert torch.equal(lam, lam32.double()) and torch.equal(v, v32.double())


def test_eigh_wrapper_refuses_bad_input():
    lam, v = kernels.eigh_small(torch.zeros((0, 0)))
    assert lam.shape == (0,) and v.shape == (0, 0)
    with pytest.raises(ValueError, match="square"):
        kernels.eigh_small(torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="no kernel"):
        kernels.eigh_small(torch.empty((4, 4), device="meta"))


def test_hash_multiply_wraps_like_uint32():
    """The plain version's uint32 arithmetic in int64 (torch has no >>
    for uint32 on the CPU) against numpy's wrapping uint32."""
    rng = np.random.default_rng(1)
    h = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    h[:3] = [0, 1, 2 ** 32 - 1]
    for c in (0x85EBCA6B, 0xC2B2AE35):
        want = (h.astype(np.uint32) * np.uint32(c)).astype(np.int64)
        got = kernels._mul32(torch.from_numpy(h.astype(np.int64)), c)
        assert np.array_equal(got.numpy(), want)
    assert kernels._mul32(0xFFFFFFFF, 0x85EBCA6B) == 2048144789


def _jax_omega(n, l, seed):
    """JAX's Omega, recovered as tests/test_pallas.py:13-30 does."""
    return np.asarray(jax_fused_sketch_matmul(
        jnp.eye(n, dtype=jnp.float32), l, seed=seed, block_m=128,
        block_k=128, interpret=True))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("l", [8, 16, 130])
def test_sketch_omega_matches_jax(l, seed):
    """130 crosses l_pad = 256, which enters the hash index.  A wrong bit
    in the hash changes an entry by O(1), so 1e-5 shows that the bits
    agree; the rest is libm's log and cos at f32 (a few ulp)."""
    n = 160
    om_j = _jax_omega(n, l, seed)
    om_t = to_numpy(kernels.fused_sketch_omega(n, l, seed, device="cpu"))
    assert om_t.shape == (n, l) and om_t.dtype == np.float32
    assert np.abs(om_t - om_j).max() <= 1e-5
    # and the wrapper recovers it through A = I
    eye = torch.eye(n)
    assert torch.equal(kernels.fused_sketch_matmul(eye, l, seed),
                       from_numpy(om_t))


def test_sketch_y_matches_jax_on_a_ragged_operand():
    a = np.random.default_rng(2).standard_normal((200, 300)).astype(
        np.float32)
    y_j = np.asarray(jax_fused_sketch_matmul(jnp.asarray(a), 24, seed=3,
                                             block_m=128, block_k=128,
                                             interpret=True))
    y_t = to_numpy(kernels.fused_sketch_matmul(from_numpy(a), 24, seed=3))
    assert y_t.shape == (200, 24)
    # Omega to a few ulp, f32 sums of 300 products in another order
    assert np.abs(y_t - y_j).max() <= 1e-5 * np.abs(y_j).max()


def test_sketch_wrapper_runs_reference_on_cpu_and_counts_no_launch():
    a = from_numpy(np.random.default_rng(3).standard_normal((40, 50)))
    before = kernels.fused_sketch_matmul.launches
    y = kernels.fused_sketch_matmul(a, 6, seed=-1)
    assert y.dtype == torch.float64            # a's dtype, computed in f32
    assert torch.equal(y, kernels.fused_sketch_matmul_reference(a, 6, -1))
    assert kernels.fused_sketch_matmul.launches == before
    # a negative seed is its two's-complement uint32
    assert torch.equal(y, kernels.fused_sketch_matmul(a, 6, 2 ** 32 - 1))
    # block sizes keep the JAX signature and change nothing
    assert torch.equal(y, kernels.fused_sketch_matmul(a, 6, -1, 8, 8))


def test_sketch_wrapper_refuses_bad_input():
    with pytest.raises(TypeError, match="dense 2-D tensor"):
        kernels.fused_sketch_matmul(np.zeros((4, 4), np.float32), 2)
    with pytest.raises(ValueError, match="no kernel"):
        kernels.fused_sketch_matmul(torch.empty((4, 4), device="meta"), 2)
