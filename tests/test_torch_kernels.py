"""Kernel K1 (fused CholeskyQR1) of the PyTorch port against the JAX
Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version
(``fused_cholqr1_reference``); the JAX kernel runs in Pallas interpret
mode, as tests/test_polar.py runs it.  The CUDA kernel itself is held to
the plain version on the card by ``chip_smoke.py``."""

import functools
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.linalg.pallas_kernels import (
    fused_cholqr1 as jax_fused_cholqr1,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import _build, kernels

# the port's entry points default to the card; these tests run on the CPU
from_numpy = functools.partial(convert.from_numpy, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tall(m, l, cond, seed):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, l)))
    v, _ = np.linalg.qr(rng.standard_normal((l, l)))
    s = np.geomspace(cond, 1.0, l)
    return ((u * s) @ v.T).astype(np.float32)


def _rank_deficient(seed=3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((100, 60)).astype(np.float32)
    a[:, 30:] = a[:, :30]            # exact rank 30 < l = 60
    return a


# the last two sit at the CUDA kernel's boundaries: l = 80 with m not a
# multiple of its 32-row tiles, and l = 129 past its 128-wide one-tile path
@pytest.mark.parametrize("m,l,cond,seed", [(264, 40, 50.0, 9),
                                           (520, 33, 30.0, 11),
                                           (203, 80, 20.0, 13),
                                           (300, 129, 20.0, 17)])
def test_reference_matches_jax_fused_cholqr1(m, l, cond, seed):
    y = _tall(m, l, cond, seed)
    q_j, r_j = (np.asarray(x) for x in jax_fused_cholqr1(jnp.asarray(y)))
    q_t, r_t = (to_numpy(x) for x in
                kernels.fused_cholqr1_reference(from_numpy(y)))
    assert q_t.dtype == np.float32 and r_t.dtype == np.float32
    # the JAX suite's own bounds for fused vs XLA CholeskyQR1 in f32
    # (tests/test_polar.py::test_fused_cholqr_matches_cholesky_qr1): both
    # sides are f32 eliminations whose sums run in different orders
    np.testing.assert_allclose(r_t, r_j, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(q_t, q_j, atol=2e-3)
    # Q orthonormal to f32 cond^2 accuracy (cond <= 50: ~3e-4 worst case)
    assert np.abs(q_t.T @ q_t - np.eye(l)).max() <= 1e-3
    # R exactly upper-triangular (the port zeroes the eliminated half)
    assert np.all(np.tril(r_t, -1) == 0.0)


def test_rank_deficient_input_is_non_finite_in_both():
    """cholqr1 contract: no clamp, no fallback -- NaN/inf on rank
    deficiency (tests/test_diagnostics.py pins 'nan' for cholqr1_fused)."""
    y = _rank_deficient()
    q_j, r_j = (np.asarray(x) for x in jax_fused_cholqr1(jnp.asarray(y)))
    q_t, r_t = (to_numpy(x) for x in
                kernels.fused_cholqr1_reference(from_numpy(y)))
    assert not (np.isfinite(q_j).all() and np.isfinite(r_j).all())
    assert not (np.isfinite(q_t).all() and np.isfinite(r_t).all())


def test_wrapper_runs_reference_on_cpu_and_counts_no_launch():
    y = from_numpy(_tall(128, 16, 10.0, 1))
    before = kernels.fused_cholqr1.launches
    q, r = kernels.fused_cholqr1(y)
    q_ref, r_ref = kernels.fused_cholqr1_reference(y)
    assert torch.equal(q, q_ref) and torch.equal(r, r_ref)
    assert kernels.fused_cholqr1.launches == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_wrapper_computes_in_f32_and_returns_input_dtype(dtype):
    """Like pallas_kernels.py:333,346: cast to f32, return y.dtype."""
    y32 = from_numpy(_tall(96, 12, 5.0, 2))
    q, r = kernels.fused_cholqr1(y32.to(dtype))
    q32, r32 = kernels.fused_cholqr1_reference(y32.to(dtype).to(
        torch.float32))
    assert q.dtype == dtype and r.dtype == dtype
    assert torch.equal(q, q32.to(dtype)) and torch.equal(r, r32.to(dtype))


def test_panel_buffers_are_aligned_views_of_one_allocation():
    """K1's and K2's outputs and workspace come from one allocation, each
    view contiguous and 16-byte aligned within it."""
    q, r, work = kernels._panel_buffers(torch.device("cpu"), 37, (5, 3),
                                        (3, 3))
    assert (q.shape, r.shape, work.shape) == ((5, 3), (3, 3), (37,))
    base = q.untyped_storage().data_ptr()
    for t in (q, r, work):
        assert t.is_contiguous() and t.dtype == torch.float32
        assert t.untyped_storage().data_ptr() == base
        assert (t.data_ptr() - base) % 16 == 0
    assert r.data_ptr() - q.data_ptr() >= 4 * q.numel()
    assert work.data_ptr() - r.data_ptr() >= 4 * r.numel()
    empty_q, _, _ = kernels._panel_buffers(torch.device("cpu"), 1, (0,),
                                           (2, 2))
    assert empty_q.shape == (0,)


def test_wrapper_refuses_a_device_without_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        kernels.fused_cholqr1(torch.empty((8, 4), device="meta"))


def test_build_names_sm90a_and_only_package_sources():
    srcs = _build.sources()
    assert [s.name for s in srcs] == ["cholqr1.cu", "eigh.cu", "polar.cu",
                                      "quantize.cu", "sketch.cu"]
    assert [h.name for h in _build.headers()] == ["hash.cuh", "panel.cuh"]
    for src in srcs:
        cmd = _build.nvcc_command("nvcc", src, _build.library_path(src))
        assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
        path = _build.library_path(src)
        assert path.parent == _build.BUILD_DIR
        # the library name carries a hash of the sources and flags
        assert path.name.startswith(f"lib{src.stem}-")
        assert len(path.stem) == len(src.stem) + 20


def test_library_hash_covers_the_shared_headers(monkeypatch, tmp_path):
    """An edited csrc/*.cuh must rebuild every library, not reuse a
    stale one."""
    for f in _build.sources() + _build.headers():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    before = {s.name: _build.library_path(s) for s in _build.sources()}
    header = tmp_path / "panel.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s.name: _build.library_path(s) for s in _build.sources()}
    assert all(before[n] != after[n] for n in before)
    # and an unchanged tree names the same libraries
    assert after == {s.name: _build.library_path(s)
                     for s in _build.sources()}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
