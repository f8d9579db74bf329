"""Newton--Schulz polar orthonormalization of the PyTorch port
(``linalg/polar.py``) and kernel K2's plain version
(``linalg/kernels.py::polar_qr_fused_reference``) against the JAX
package.

The same numpy panels go to both packages.  The JAX ``polar_qr_fused``
runs its Pallas kernel in interpret mode on the CPU, as
tests/test_polar.py runs it; the port's wrapper runs its plain version on
a CPU tensor.  The CUDA kernel itself is held to the plain version on the
card by ``chip_smoke.py``."""

import functools
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.linalg import polar as jpolar
from rsvd_kamaneh_raganato_terrana_tpu.linalg import qr as jqr
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import diagnostics as jdiag
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import kernels
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import polar as tpolar
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import qr as tqr
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import diagnostics as tdiag

STAGES = ("gram", "gt", "w1", "h1", "h2", "h4", "h8")

# the port's entry points default to the card; these tests run on the CPU
from_numpy = functools.partial(convert.from_numpy, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tall(m=300, l=24, cond=100.0, seed=0, dtype=np.float32):
    """As tests/test_polar.py:28-33: singular values geomspace(cond, 1)."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, l)))
    v, _ = np.linalg.qr(rng.standard_normal((l, l)))
    s = np.geomspace(cond, 1.0, l)
    return ((u * s) @ v.T).astype(dtype)


@pytest.mark.parametrize("iters,mu_min", [(8, 1e-6), (4, 1e-4), (12, 1e-8)])
def test_ns_schedule_is_bitwise_jax(iters, mu_min):
    c_t, lo_t = tpolar.ns_schedule(iters, mu_min)
    c_j, lo_j = jpolar.ns_schedule(iters, mu_min)
    assert c_t == c_j and lo_t == lo_j


@pytest.mark.parametrize("m,l,cond,seed", [(300, 24, 200.0, 0),
                                           (264, 40, 100.0, 7),
                                           (160, 16, 10.0, 3)])
def test_polar_qr_matches_jax_f64(m, l, cond, seed):
    y = _tall(m, l, cond, seed, np.float64)
    q_j, r_j = (np.asarray(x) for x in jpolar.polar_qr(jnp.asarray(y)))
    q_t, r_t = (to_numpy(x) for x in tpolar.polar_qr(from_numpy(y)))
    assert q_t.dtype == np.float64
    # the same f64 arithmetic; BLAS summation order only, through 31
    # l x l products: ~1e-13 measured, 1e-9 is the bound
    assert np.abs(q_t - q_j).max() <= 1e-9
    assert np.abs(r_t - r_j).max() <= 1e-9 * np.abs(r_j).max()
    q_o = to_numpy(tpolar.polar_orthonormalize(from_numpy(y)))
    assert np.abs(q_o - q_t).max() <= 1e-12
    # the contract: orthonormal Q, Y = Q R, R symmetric
    assert np.abs(q_t.T @ q_t - np.eye(l)).max() <= 1e-6
    assert np.linalg.norm(q_t @ r_t - y) <= 1e-6 * np.linalg.norm(y)
    assert np.abs(r_t - r_t.T).max() <= 1e-9 * np.abs(r_t).max()


# the last two sit at the CUDA kernel's boundaries: l = 80 with m not a
# multiple of its 32-row tiles, and l = 129 past its 128-wide one-tile path
@pytest.mark.parametrize("m,l,cond,seed", [(264, 40, 100.0, 7),
                                           (320, 17, 30.0, 5),
                                           (203, 80, 30.0, 13),
                                           (300, 129, 30.0, 17)])
def test_fused_reference_matches_jax_kernel(m, l, cond, seed):
    """The plain K2 against the Pallas K2 (interpret mode), with
    tests/test_polar.py:114-134's tolerances: Q to 2e-4, R through its
    serving contract (reconstruction and column norms)."""
    y = _tall(m, l, cond, seed)
    q_j, r_j = (np.asarray(x) for x in jpolar.polar_qr_fused(jnp.asarray(y)))
    q_t, r_t = (to_numpy(x) for x in
                kernels.polar_qr_fused_reference(from_numpy(y)))
    assert q_t.dtype == np.float32 and r_t.shape == (l, l)
    np.testing.assert_allclose(q_t, q_j, atol=2e-4)
    # O(eps cond^2) reconstruction for a single-pass method
    assert np.linalg.norm(q_t @ r_t - y) < 6e-3 * np.linalg.norm(y)
    np.testing.assert_allclose(np.linalg.norm(r_t, axis=0),
                               np.linalg.norm(r_j, axis=0), rtol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(r_t, axis=0),
                               np.linalg.norm(y, axis=0), rtol=1e-3)
    # the polar contract: 4e-5 to 1e-4 at f32 over cond 100-1000
    # (linalg/polar.py docstring); 1.01e-4 measured here at cond 100
    assert np.abs(q_t.T @ q_t - np.eye(l)).max() <= 3e-4


def _f64_stages(y, iters=8, mu_min=1e-6):
    """The kernel's intermediates in numpy f64, from JAX's schedule."""
    coeffs, _ = jpolar.ns_schedule(iters, mu_min)
    y = y.astype(np.float64)
    g = y.T @ y
    gt = g / (np.abs(g).sum(axis=1).max() + 1e-30)
    eye = np.eye(g.shape[0])

    def sym_h(w):
        h = w.T @ gt @ w
        return 0.5 * (h + h.T)

    a0, b0, c0 = coeffs[0]
    w = a0 * eye + b0 * gt + c0 * gt @ gt
    out = {"gram": g, "gt": gt, "w1": w, "h1": sym_h(w)}
    h = out["h1"]
    for k, (a, b, c) in enumerate(coeffs[1:], start=2):
        w = w @ (a * eye + b * h + c * h @ h)
        h = out[f"h{k}"] = sym_h(w)
    return out


@pytest.mark.parametrize("stage", STAGES)
def test_reference_stages_match_f64(stage):
    """The stage probe (benchmarks/diagnostics/polar_tpu_debug2.py's
    make_probe, for the row-sum algorithm): each intermediate of the
    plain K2 against the same step in f64."""
    y = _tall(288, 32, 50.0, 11)
    want = _f64_stages(y)[stage]
    got = to_numpy(kernels.polar_qr_fused_reference(from_numpy(y),
                                                    stage=stage))
    assert got.shape == (32, 32) and got.dtype == np.float32
    # f32 roundoff of G (~1e-6 relative) grows through the early steps,
    # whose coefficients are O(1/sqrt(mu_min)); H_8 converges to I
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    if stage == "h8":
        assert np.abs(got - np.eye(32)).max() <= 1e-4


def test_unknown_stage_raises():
    y = from_numpy(_tall(64, 8, 2.0, 1))
    with pytest.raises(ValueError, match="unknown polar stage"):
        kernels.polar_qr_fused(y, stage="h9")


def test_wrapper_runs_reference_on_cpu_and_counts_no_launch():
    y = from_numpy(_tall(128, 16, 10.0, 1))
    before = kernels.polar_qr_fused.launches
    q, r = kernels.polar_qr_fused(y)
    q_ref, r_ref = kernels.polar_qr_fused_reference(y)
    assert torch.equal(q, q_ref) and torch.equal(r, r_ref)
    g = kernels.polar_qr_fused(y, stage="gram")
    assert torch.equal(g, kernels.polar_qr_fused_reference(y, stage="gram"))
    assert kernels.polar_qr_fused.launches == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_wrapper_computes_in_f32_and_returns_input_dtype(dtype):
    """Like polar.py:271,285: cast to f32, return y.dtype."""
    y = from_numpy(_tall(96, 12, 5.0, 2)).to(dtype)
    q, r = kernels.polar_qr_fused(y)
    q32, r32 = kernels.polar_qr_fused_reference(y.to(torch.float32))
    assert q.dtype == dtype and r.dtype == dtype
    assert torch.equal(q, q32.to(dtype)) and torch.equal(r, r32.to(dtype))


def test_wrapper_refuses_a_device_without_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        kernels.polar_qr_fused(torch.empty((8, 4), device="meta"))


@pytest.mark.parametrize("method,dtype", [("polar", np.float64),
                                          ("polar_fused", np.float64),
                                          ("polar", np.float32),
                                          ("polar_fused", np.float32)])
def test_qr_reduced_polar_matches_jax(method, dtype):
    """f64 panels take polar_qr in both packages (the dtype guard);
    f32 'polar_fused' takes K2 in both (interpret mode / plain version)."""
    y = _tall(240, 20, 40.0, 4, dtype)
    q_j, r_j = (np.asarray(x) for x in jqr.qr_reduced(jnp.asarray(y),
                                                      method))
    q_t, r_t = (to_numpy(x) for x in tqr.qr_reduced(from_numpy(y), method))
    assert q_t.dtype == dtype
    tol = 1e-9 if dtype == np.float64 else 2e-4
    np.testing.assert_allclose(q_t, q_j, atol=tol)
    np.testing.assert_allclose(np.linalg.norm(r_t, axis=0),
                               np.linalg.norm(r_j, axis=0), rtol=max(tol, 1e-4))


def test_polar_same_subspace_as_cholqr1():
    y = from_numpy(_tall(seed=3))
    q_p = to_numpy(tpolar.polar_orthonormalize(y))
    q_c = to_numpy(tqr.cholesky_qr1(y)[0])
    assert np.abs(q_p @ q_p.T - q_c @ q_c.T).max() < 1e-4


@pytest.mark.parametrize("fn", ["polar_qr", "polar_qr_fused"])
def test_rank_deficient_is_flagged_like_jax(fn):
    """Rank deficiency is out of domain (linalg/polar.py contract): the
    factors may be NaN or garbage, and factor_health flags them, as in
    tests/test_polar.py::test_rank_deficient_is_flagged_out_of_domain."""
    y = _tall(l=16)
    y[:, -1] = y[:, 0]                      # exactly dependent column
    torch_mod = tpolar if fn == "polar_qr" else kernels
    for pkg, diag, conv in ((torch_mod, tdiag, from_numpy),
                            (jpolar, jdiag, jnp.asarray)):
        q, r = getattr(pkg, fn)(conv(y))
        s = conv(np.sort(np.linalg.norm(np.asarray(to_numpy(r) if pkg is
                                                   torch_mod else r),
                                        axis=0))[::-1].copy())
        h = diag.factor_health(q, s, q[:, :16])
        assert not h["ok"], (pkg.__name__, fn, h)
