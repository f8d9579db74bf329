"""The port's main-path slice as a whole against the JAX package, plus
its precision map, sketch RNG and numpy hand-over.

The same numpy A and Omega go to ``rsvd_with_omega`` in both packages
(torch's Philox and JAX's threefry streams cannot match).  In f32 the
JAX side runs the Pallas ``fused_cholqr1`` in interpret mode and the
port runs its plain PyTorch version, as each does on the CPU."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.rsvd import driver as jdrv
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert, device, rng
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.entry import CONFIG, entry
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import kernels
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import power as tpower
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.svd import (
    SVDMethod,
    svd,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdrv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the port's entry points default to the card; these tests run on the CPU
from_numpy = functools.partial(convert.from_numpy, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gapped_operator(m=384, n=256, seed=0, dtype=np.float32):
    """As tests/test_polar.py:158-163, rectangular: geometric spectrum
    1 .. 1e-3 with random singular vectors."""
    r = np.random.default_rng(seed)
    u, _ = np.linalg.qr(r.standard_normal((m, n)))
    v, _ = np.linalg.qr(r.standard_normal((n, n)))
    s = np.geomspace(1.0, 1e-3, n)
    return ((u * s) @ v.T).astype(dtype)


def _omega(n, l, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((n, l)).astype(dtype)


def _sines(x, y):
    """Sines of the principal angles between span(x) and span(y)."""
    qx, _ = np.linalg.qr(x.astype(np.float64))
    qy, _ = np.linalg.qr(y.astype(np.float64))
    # from the residual (I - Qx Qx^T) Qy, not sqrt(1 - cos^2), which
    # cannot resolve a sine below sqrt(eps) ~ 1.5e-8
    return np.linalg.svd(qy - qx @ (qx.T @ qy), compute_uv=False)


def _both(a, omega, **kw):
    out_j = jdrv.rsvd_with_omega(jnp.asarray(a), jnp.asarray(omega), **kw)
    out_t = tdrv.rsvd_with_omega(from_numpy(a), from_numpy(omega), **kw)
    return ([np.asarray(x) for x in out_j], [to_numpy(x) for x in out_t])


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_slice_f32_matches_jax(precision):
    """(i) The slice's configuration (K1 everywhere) in f32, k=16, l=24."""
    a = _gapped_operator()
    k = 16
    omega = _omega(a.shape[1], k + 8)
    kw = dict(CONFIG, k=k, precision=precision)
    (u_j, s_j, v_j), (u_t, s_t, v_t) = _both(a, omega, **kw)
    assert u_t.shape == (384, k) and s_t.shape == (k,) and v_t.shape == (
        256, k)
    assert u_t.dtype == np.float32
    # f32 roundoff through q=2 power rounds of two differently ordered
    # eliminations: 3e-7 relative measured; 1e-4 is the slice bound
    assert np.max(np.abs(s_t - s_j)) / s_j[0] <= 1e-4
    e_j = np.linalg.norm(a - (u_j * s_j) @ v_j.T)
    e_t = np.linalg.norm(a - (u_t * s_t) @ v_t.T)
    assert abs(e_t / e_j - 1.0) <= 1e-3
    # sigma_16 / sigma_17 ~ 1.03 on this spectrum: roundoff / gap ~ 1e-5
    assert _sines(u_t, u_j).max() <= 1e-3
    assert _sines(v_t, v_j).max() <= 1e-3


def test_slice_f64_production_config_matches_jax():
    """(ii) entry()'s production configuration of the JAX package
    (robust / robust1, reorth='half', eigh tail) in f64."""
    a = _gapped_operator(dtype=np.float64)
    k = 16
    omega = _omega(a.shape[1], k + 8, dtype=np.float64)
    kw = dict(q=2, k=k, method="eigh", qr_method="robust",
              interior_qr="robust1", reorth="half", precision="highest")
    (u_j, s_j, v_j), (u_t, s_t, v_t) = _both(a, omega, **kw)
    assert s_t.dtype == np.float64
    # same f64 algorithm: LAPACK/BLAS summation order only
    np.testing.assert_allclose(s_t, s_j, rtol=1e-10)
    assert _sines(u_t, u_j).max() <= 1e-8
    assert _sines(v_t, v_j).max() <= 1e-8


def test_slice_runs_kernel_path_once_per_orthonormalization(monkeypatch):
    """q=2 with reorth='half' orthonormalizes q + 1 = 3 times, each one a
    call of the K1 wrapper."""
    calls = []
    real = kernels.fused_cholqr1

    def counting(y):
        calls.append(tuple(y.shape))
        return real(y)

    monkeypatch.setattr(kernels, "fused_cholqr1", counting)
    a = _gapped_operator()
    tdrv.rsvd_with_omega(from_numpy(a), from_numpy(_omega(256, 24)),
                         **dict(CONFIG, k=16, precision="highest"))
    assert calls == [(384, 24)] * 3


def test_import_leaves_jax_out():
    """(iii) The port imports torch and never jax."""
    code = ("import sys\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.entry\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.kernels\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.jacobi\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.power\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.apps.pca\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.apps.pca_main\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.apps.rsvd_main\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.fd\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.core.config\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.incremental\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.apps.advdiff\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.apps.pod\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.apps.rom\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.apps.pod_main\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.interp\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.deim\n"
            "import rsvd_kamaneh_raganato_terrana_tpu_torch.__main__\n"
            "print('jax' in sys.modules, 'torch' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "True"]


@pytest.mark.parametrize("kwargs", [
    dict(precision="high"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_options_raise(kwargs):
    """(iv) 'high', unported before, now runs; on the CPU it computes in
    full precision, as JAX's HIGH does there, so it equals 'highest'
    bitwise.  An unknown precision still raises before any work."""
    a = from_numpy(_gapped_operator(48, 32))
    omega = from_numpy(_omega(32, 8))
    kw = dict(method="eigh", qr_method="robust")
    got = tdrv.rsvd_with_omega(a, omega, q=1, **dict(kw, **kwargs))
    want = tdrv.rsvd_with_omega(a, omega, q=1, precision="highest", **kw)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="unknown precision"):
        tdrv.rsvd_with_omega(a, omega, q=1, precision="higher", **kw)


def test_rsvd_runs_at_its_defaults():
    """rsvd(A, k) with no other argument: the Jacobi tail, p=10, q=2,
    'robust' QR, reorth 'full', 'highest'."""
    a = from_numpy(_gapped_operator(48, 32))
    u, s, v = tdrv.rsvd(a, k=4)
    assert u.shape == (48, 4) and s.shape == (4,) and v.shape == (32, 4)
    assert torch.all(s[:-1] >= s[1:]) and torch.isfinite(u).all()
    # the same as the Jacobi tail on the seeded sketch
    omega = tdrv.generate_omega(0, 32, 14, device="cpu")
    _, s2, _ = tdrv.rsvd_with_omega(a, omega, k=4, method="jacobi")
    assert torch.equal(s, s2)


@pytest.mark.parametrize("method", ["jacobi", "parallel_jacobi", "power"])
def test_rsvd_with_omega_at_jax_defaults_matches_jax(method, monkeypatch):
    """rsvd()'s defaults (qr 'robust', reorth 'full', 'highest') with the
    Jacobi tail and the other two engines, f64, on the same Omega; the
    power tail gets JAX's start vectors."""
    a = _gapped_operator(dtype=np.float64)
    omega = _omega(256, 24, dtype=np.float64)
    x0s = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (24, 256),
                                       jnp.float64))
    monkeypatch.setattr(tpower, "gaussian",
                        lambda key, shape, dt: from_numpy(x0s).to(dt))
    (u_j, s_j, v_j), (u_t, s_t, v_t) = _both(a, omega, k=16, method=method)
    assert s_t.dtype == np.float64 and u_t.shape == (384, 16)
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-10 * s_j[0])
    # sigma_16 / sigma_17 ~ 1.03: subspaces to roundoff / gap
    assert _sines(u_t, u_j).max() <= 1e-8
    assert _sines(v_t, v_j).max() <= 1e-8


@pytest.mark.parametrize("seed", [0, 11])
def test_three_kernel_rsvd_matches_jax_on_the_same_seed(seed):
    """sketch='fused' (K4) -> cholqr1_fused (K1) -> eigh_pallas (K3) in
    f32: the hashed Omega is the same in both packages, so the same call
    with the same seed is compared, no Omega handed over."""
    a = _gapped_operator()
    kw = dict(k=16, p=8, q=2, method="eigh_pallas", sketch="fused",
              seed=seed, qr_method="cholqr1_fused",
              interior_qr="cholqr1_fused", reorth="half")
    u_j, s_j, v_j = (np.asarray(x) for x in jdrv.rsvd(jnp.asarray(a), **kw))
    u_t, s_t, v_t = (to_numpy(x) for x in tdrv.rsvd(from_numpy(a), **kw))
    assert u_t.shape == (384, 16) and u_t.dtype == np.float32
    # f32 roundoff through the sketch, 3 eliminations and 8 Jacobi
    # sweeps: 1.3e-6 relative measured
    assert np.max(np.abs(s_t - s_j)) / s_j[0] <= 1e-4
    e_j = np.linalg.norm(a - (u_j * s_j) @ v_j.T)
    e_t = np.linalg.norm(a - (u_t * s_t) @ v_t.T)
    assert abs(e_t / e_j - 1.0) <= 1e-3
    assert _sines(u_t, u_j).max() <= 1e-3
    assert _sines(v_t, v_j).max() <= 1e-3


def test_fused_sketch_is_the_kernel_sketch(monkeypatch):
    """The fused branch takes Y from K4's wrapper: once per call, at
    l = k + p, with the call's seed."""
    calls = []
    real = kernels.fused_sketch_matmul

    def counting(a, l, seed=0):
        calls.append((tuple(a.shape), l, seed))
        return real(a, l, seed)

    monkeypatch.setattr(kernels, "fused_sketch_matmul", counting)
    tdrv.rsvd(from_numpy(_gapped_operator(96, 64)), k=8, p=6, seed=5,
              method="eigh", sketch="fused")
    assert calls == [((96, 64), 14, 5)]


@pytest.mark.parametrize("finish", ["rowspace", "utv", "rowspace_utv"])
def test_fused_sketch_supports_project_only(finish):
    a = _gapped_operator(48, 32)
    for rsvd, arr in ((jdrv.rsvd, jnp.asarray), (tdrv.rsvd, from_numpy)):
        with pytest.raises(ValueError, match="only supports finish"):
            rsvd(arr(a), k=4, method="eigh", sketch="fused", finish=finish)


@pytest.mark.parametrize("storage", ["bf16", "int8", "Int8Stored"])
def test_fused_sketch_storage_modes_do_what_jax_does(storage):
    """JAX's fused branch reads A as it is: 'bf16' and 'int8' neither
    cast nor quantize (products at 'default' numerics, f32 on the CPU),
    and a pre-quantized Int8Stored raises TypeError."""
    a = _gapped_operator(96, 64)
    kw = dict(k=8, p=6, seed=2, method="eigh", sketch="fused")
    if storage == "Int8Stored":
        with pytest.raises(TypeError):
            jdrv.rsvd(jdrv.quantize_int8_rows(jnp.asarray(a)), **kw)
        with pytest.raises(TypeError):
            tdrv.rsvd(tdrv.quantize_int8_rows(from_numpy(a)), **kw)
        return
    s_j = np.asarray(jdrv.rsvd(jnp.asarray(a), precision=storage, **kw)[1])
    _, s_t, _ = tdrv.rsvd(from_numpy(a), precision=storage, **kw)
    _, s_hi, _ = tdrv.rsvd(from_numpy(a), precision="highest", **kw)
    assert torch.equal(s_t, s_hi)
    np.testing.assert_allclose(to_numpy(s_t), s_j, rtol=1e-5)


def test_sparse_operand_raises():
    """A sparse operand (the name is from when the port refused one) runs
    the sparse path and matches the JAX package's dense call on the same
    Omega: singular values to 1e-5 relative (f32), the subspaces to
    sines of 1e-3."""
    x = _gapped_operator(48, 32)
    x[np.abs(x) < np.median(np.abs(x))] = 0.0
    omega = _omega(32, 8)
    u, s, v = tdrv.rsvd_with_omega(from_numpy(x).to_sparse(),
                                   from_numpy(omega), q=1, method="eigh")
    uj, sj, vj = (np.asarray(t) for t in jdrv.rsvd_with_omega(
        jnp.asarray(x), jnp.asarray(omega), q=1, method="eigh"))
    np.testing.assert_allclose(to_numpy(s), sj, rtol=1e-5)
    assert _sines(to_numpy(u), uj).max() <= 1e-3
    assert _sines(to_numpy(v), vj).max() <= 1e-3


def test_unknown_finish_raises_value_error():
    with pytest.raises(ValueError, match="unknown finish"):
        tdrv.rsvd_with_omega(from_numpy(_gapped_operator(48, 32)),
                             from_numpy(_omega(32, 8)), method="eigh",
                             finish="sideways")


def test_rsvd_is_rsvd_with_omega_on_the_seeded_sketch():
    """rsvd() = rsvd_core() = rsvd_with_omega(generate_omega(seed))."""
    a = from_numpy(_gapped_operator(96, 64))
    kw = dict(q=1, method="eigh", qr_method="cholqr1_fused",
              interior_qr="cholqr1_fused", reorth="half")
    u, s, v = tdrv.rsvd(a, k=8, p=6, seed=5, **kw)
    omega = tdrv.generate_omega(5, 64, 14, device="cpu")
    u2, s2, v2 = tdrv.rsvd_with_omega(a, omega, k=8, **kw)
    assert torch.equal(s, s2) and torch.equal(u, u2) and torch.equal(v, v2)
    # and it is a good rank-8 approximation: within 2% of the SVD optimum
    # on this gapped spectrum (q=1 power round)
    s_all = np.linalg.svd(to_numpy(a), compute_uv=False)
    best = np.sqrt(np.sum(s_all[8:] ** 2))
    err = float(tdrv.reconstruction_error(a, u, s, v))
    assert err <= 1.02 * best


def test_rsvd_refuses_complex_input():
    with pytest.raises(TypeError, match="real"):
        tdrv.rsvd(torch.zeros((8, 8), dtype=torch.complex64), k=2,
                  method="eigh")


def test_entry_runs_the_slice_on_cpu():
    fn, (a,) = entry(device="cpu", m=160, n=128)
    u, s, v = fn(a)
    assert u.shape == (160, 64) and s.shape == (64,) and v.shape == (128, 64)
    assert torch.isfinite(u).all() and torch.isfinite(s).all()
    assert torch.all(s[:-1] >= s[1:])
    # Q orthonormal at f32 cholqr1 accuracy (Gaussian A: cond(Y) ~ 3)
    assert (u.T @ u - torch.eye(64)).abs().max() <= 1e-4


@pytest.mark.parametrize("method", ["eigh", "xla"])
def test_small_svd_matches_numpy(method):
    b = _gapped_operator(80, 24, seed=3, dtype=np.float64).T
    u, s, v = (to_numpy(x) for x in svd(from_numpy(b), method))
    s_ref = np.linalg.svd(b, compute_uv=False)
    # Gram-eigh: sigma_i to eps * (sigma_1 / sigma_i)^2; spectrum spans
    # ~1e-3 here, so 1e-9 relative to sigma_1 bounds both engines
    np.testing.assert_allclose(s, s_ref, atol=1e-9 * s_ref[0])
    np.testing.assert_allclose((u * s) @ v.T, b, atol=1e-9)


def test_svd_method_keeps_every_member():
    assert {m.value for m in SVDMethod} == {
        "jacobi", "power", "parallel_jacobi", "eigh", "eigh_pallas",
        "xla", "auto"}
    u, s, v = svd(torch.eye(4, dtype=torch.float64), "auto")
    assert torch.allclose(s, torch.ones(4, dtype=torch.float64))
    assert torch.allclose((u * s) @ v.T, torch.eye(4, dtype=torch.float64))


def test_precision_map_restores_tf32_setting():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with device.ieee_fp32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_default_precision_is_f32_on_cpu():
    """JAX's DEFAULT precision is f32 on the CPU, and so is the port's."""
    r = np.random.default_rng(4)
    a = from_numpy(r.standard_normal((32, 16)).astype(np.float32))
    b = from_numpy(r.standard_normal((16, 8)).astype(np.float32))
    out = device.matmul_at(a, b, "default")
    assert out.dtype == torch.float32
    assert torch.equal(out, device.matmul_at(a, b, "highest"))


def test_mixed_bf16_product_accumulates_in_f32():
    """The JAX _mm rule: bf16 A x f32 small operand -> the small side is
    rounded to bf16 and the product returns in f32, never in bf16."""
    r = np.random.default_rng(5)
    a = from_numpy(r.standard_normal((32, 16)), dtype=torch.bfloat16)
    b = from_numpy(r.standard_normal((16, 8)).astype(np.float32))
    out = tdrv._mm(a, b, "default")
    assert out.dtype == torch.float32
    ref = a.double() @ b.to(torch.bfloat16).double()
    # exact bf16 products, f32 accumulation over 16 terms
    assert (out.double() - ref).abs().max() <= 1e-5


def test_sketch_rng_is_seeded_and_on_the_generator_device():
    g1, g2 = rng.key_from_seed(7, "cpu"), rng.key_from_seed(7, "cpu")
    x1 = rng.sketch_matrix(g1, 400, 50)
    x2 = rng.sketch_matrix(g2, 400, 50)
    assert torch.equal(x1, x2) and x1.device == g1.device
    assert not torch.equal(x1, rng.sketch_matrix(
        rng.key_from_seed(8, "cpu"), 400, 50))
    # standard normal: mean 0, variance 1 over 20000 draws (5 sigma)
    assert abs(float(x1.mean())) <= 5 / np.sqrt(2e4)
    assert abs(float(x1.var()) - 1.0) <= 5 * np.sqrt(2 / 2e4)
    rad = rng.sketch_matrix(rng.key_from_seed(7, "cpu"), 40, 5,
                            torch.float64, "rademacher")
    assert rad.dtype == torch.float64
    assert set(rad.unique().tolist()) == {-1.0, 1.0}
    with pytest.raises(ValueError, match="unknown sketch"):
        rng.sketch_matrix(rng.key_from_seed(0, "cpu"), 4, 2, kind="sobol")


def test_from_numpy_defaults_to_the_card():
    """Like every other entry point of the port: the card unless the
    caller names another device."""
    x = np.ones((2, 3), np.float32)
    if torch.cuda.is_available():
        assert convert.from_numpy(x).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            convert.from_numpy(x)
    assert convert.from_numpy(x, device="cpu").device.type == "cpu"


def test_convert_round_trips_numpy_and_jax_arrays():
    x = np.random.default_rng(6).standard_normal((5, 3)).astype(np.float32)
    t = from_numpy(jnp.asarray(x))
    assert t.dtype == torch.float32 and np.array_equal(to_numpy(t), x)
    tb = from_numpy(jnp.asarray(x, dtype=jnp.bfloat16))
    assert tb.dtype == torch.bfloat16
    assert np.array_equal(to_numpy(tb),
                          np.asarray(jnp.asarray(x, jnp.bfloat16),
                                     np.float32))
    assert from_numpy(x, dtype=torch.float64).dtype == torch.float64
