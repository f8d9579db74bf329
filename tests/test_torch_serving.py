"""The serving path of the PyTorch port against the JAX package: int8 and
bf16 storage, the finishes 'rowspace', 'utv' and 'rowspace_utv', the
polar interiors (kernel K2's plain version), ``factor_health``,
``utv_rescore``, ``rutv`` and ``rsvd_serving``.

The same numpy A and Omega go to ``rsvd_with_omega`` in both packages
(torch's Philox and JAX's threefry streams cannot match)."""

import functools
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.rsvd import diagnostics as jdiag
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import driver as jdrv
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import utv as jutv
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert, rng
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import kernels
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import diagnostics as tdiag
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdrv
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import serving as tsrv
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import utv as tutv

FINISHES = ("project", "rowspace", "utv", "rowspace_utv")
QR = ("cholqr1", "cholqr1_fused", "polar", "polar_fused")
STORAGE = ("highest", "bf16", "int8")

# the port's entry points default to the card; these tests run on the CPU
from_numpy = functools.partial(convert.from_numpy, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gapped(m=192, n=128, seed=0, dtype=np.float32):
    """Geometric spectrum 1 .. 1e-3 with random singular vectors."""
    r = np.random.default_rng(seed)
    u, _ = np.linalg.qr(r.standard_normal((m, n)))
    v, _ = np.linalg.qr(r.standard_normal((n, n)))
    return ((u * np.geomspace(1.0, 1e-3, n)) @ v.T).astype(dtype)


def _omega(n, l, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((n, l)).astype(dtype)


def _err(a, u, s, v):
    return float(np.linalg.norm(a - (u * s) @ v.T))


# ---------------------------------------------------------------- int8


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quantize_int8_rows_is_jax_to_the_bit(dtype):
    a = np.random.default_rng(2).standard_normal((70, 45)).astype(dtype)
    a[3] = 0.0                               # a zero row: the tiny floor
    a[5, 7] = 2.5 * np.abs(a[5]).max()       # a row ruled by one entry
    j = jdrv.quantize_int8_rows(jnp.asarray(a))
    t = tdrv.quantize_int8_rows(from_numpy(a))
    assert t.q8.dtype == torch.int8 and t.shape == (70, 45)
    assert t.row_scale.dtype == (torch.float64 if dtype == np.float64
                                 else torch.float32)
    # both divide in the same dtype and round half to even
    np.testing.assert_array_equal(to_numpy(t.q8), np.asarray(j.q8))
    live = np.arange(70) != 3
    np.testing.assert_array_equal(to_numpy(t.row_scale)[live],
                                  np.asarray(j.row_scale)[live])
    # the zero row's scale is the floor tiny / 127, a subnormal, which
    # XLA on the CPU flushes to 0; both give a zero row of Q8
    tiny = np.finfo(dtype).tiny
    assert to_numpy(t.row_scale)[3] == np.asarray(tiny / 127, dtype)
    assert not to_numpy(t.q8)[3].any()
    assert t.T.shape == (45, 70) and t.T.T.transposed is False
    # both layouts are made here, zero-padded to 80 x 48, shared by A.T
    fwd, bwd = t.layouts
    assert t.T.layouts is t.layouts
    assert fwd.shape == (80, 48) and torch.equal(fwd[:70, :45], t.q8)
    assert not fwd[70:].any() and not fwd[:, 45:].any()
    assert bwd.is_contiguous() and torch.equal(bwd, fwd.T)


@pytest.mark.parametrize("side", ["forward", "transposed", "right"])
def test_int8_mm_matches_jax(side):
    r = np.random.default_rng(3)
    a = r.standard_normal((96, 64)).astype(np.float32)
    j8, t8 = jdrv.quantize_int8_rows(jnp.asarray(a)), \
        tdrv.quantize_int8_rows(from_numpy(a))
    if side == "forward":
        b = r.standard_normal((64, 12)).astype(np.float32)
        want = jdrv._mm(j8, jnp.asarray(b))
        got = tdrv._mm(t8, from_numpy(b))
    elif side == "transposed":
        b = r.standard_normal((96, 12)).astype(np.float32)
        want = jdrv._mm(j8.T, jnp.asarray(b))
        got = tdrv._mm(t8.T, from_numpy(b))
    else:
        b = r.standard_normal((12, 96)).astype(np.float32)
        want = jdrv._mm(jnp.asarray(b), j8)
        got = tdrv._mm(from_numpy(b), t8)
    assert got.dtype == torch.float32
    # identical integer sums; the f32 scale products round the same way
    # up to the order torch and XLA fuse them: 2 ulp
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=3e-7,
                               atol=1e-30)


@pytest.mark.parametrize("rows,k,cols", [(10, 9, 3), (40, 12, 5),
                                         (33, 100, 17)])
def test_int8_product_pads_exactly(rows, k, cols):
    """The CUDA shape rules (> 16 rows, aligned widths) are met by zero
    padding -- of the stored layouts once, of the small operand per
    product -- which must not change the integer product; the code runs
    the same on the CPU."""
    r = np.random.default_rng(rows)
    x = r.integers(-127, 128, (rows, k)).astype(np.int8)
    y = r.integers(-127, 128, (k, cols)).astype(np.int8)
    want = x.astype(np.int64) @ y.astype(np.int64)
    fwd, bwd = tdrv._int8_layouts(torch.from_numpy(x))
    for layout in (fwd, bwd):
        assert layout.is_contiguous() and layout.shape[0] > 16
        assert layout.shape[1] % 16 == 0
    got = tdrv._int8_product(fwd, torch.from_numpy(y))[:rows]
    assert got.dtype == torch.int32          # one chunk: _int_mm's int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and through the stored Q8^T, as _int8_mm passes it for A^T
    z = r.integers(-127, 128, (rows, cols)).astype(np.int8)
    got_t = tdrv._int8_product(bwd, torch.from_numpy(z))[:k]
    np.testing.assert_array_equal(got_t.numpy(),
                                  x.T.astype(np.int64) @ z.astype(np.int64))


def test_int8_long_contraction_does_not_wrap():
    """Trap 5: a contraction of 140,000 int8 products of 127 x 127 sums
    to 2.26e9 > 2^31 and wraps an int32 accumulator; the port chunks."""
    k = 140_000
    x = torch.full((17, k), 127, dtype=torch.int8)
    y = torch.full((k, 2), 127, dtype=torch.int8)
    got = tdrv._int8_product(x, y)
    assert got.dtype == torch.int64
    assert int(got[0, 0]) == k * 127 * 127 > 2 ** 31


def test_int8_chunking_changes_nothing(monkeypatch):
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.integers(-127, 128, (24, 200)).astype(np.int8))
    y = torch.from_numpy(r.integers(-127, 128, (200, 9)).astype(np.int8))
    whole = tdrv._int8_product(x, y)
    monkeypatch.setattr(tdrv, "_INT8_CHUNK", 32)
    assert torch.equal(tdrv._int8_product(x, y), whole)


# --------------------------------------------- the slice against JAX


@pytest.mark.parametrize("storage", STORAGE)
@pytest.mark.parametrize("qr", QR)
@pytest.mark.parametrize("finish", FINISHES)
def test_rsvd_with_omega_matches_jax(finish, qr, storage):
    """Every finish x QR method x storage, k=16, l=24, q=2,
    reorth='half'.  The polar methods run as interiors (their measured
    truncation penalty keeps them out of the final QRs, as in
    tests/test_polar.py); the fused ones run K1 / K2 in Pallas interpret
    mode in JAX and as plain versions in the port."""
    a = _gapped()
    omega = _omega(128, 24)
    final = "cholqr1" if qr.startswith("polar") else qr
    kw = dict(q=2, k=16, method="eigh", qr_method=final, interior_qr=qr,
              reorth="half", precision=storage, finish=finish)
    u_j, s_j, v_j = (np.asarray(x) for x in
                     jdrv.rsvd_with_omega(jnp.asarray(a), jnp.asarray(omega),
                                          **kw))
    u_t, s_t, v_t = (to_numpy(x) for x in
                     tdrv.rsvd_with_omega(from_numpy(a), from_numpy(omega),
                                          **kw))
    assert u_t.shape == (192, 16) and s_t.shape == (16,) and \
        v_t.shape == (128, 16)
    assert u_t.dtype == np.float32
    # f32 roundoff: <= 5e-6 of s_1 measured.  Under 'bf16' an f32-level
    # difference in Q can flip the bf16 rounding of single operands
    # (eps 3.9e-3): <= 3e-4 measured, through the polar interiors
    tol = 2e-3 if storage == "bf16" else 1e-4
    assert np.abs(s_t - s_j).max() / s_j[0] <= tol
    assert abs(_err(a, u_t, s_t, v_t) / _err(a, u_j, s_j, v_j) - 1.0) <= 1e-4


def test_rsvd_accepts_int8stored_under_bf16():
    """Trap 6: JAX raises AttributeError for rsvd(Int8Stored,
    precision='bf16'); the port reads the int8 operand as it is, which is
    JAX's precision='int8' result."""
    a = _gapped()
    omega = _omega(128, 24)
    kw = dict(q=2, k=16, method="eigh", qr_method="cholqr1",
              interior_qr="cholqr1", reorth="half", finish="rowspace_utv")
    t8 = tdrv.quantize_int8_rows(from_numpy(a))
    u_t, s_t, v_t = (to_numpy(x) for x in tdrv.rsvd_with_omega(
        t8, from_numpy(omega), precision="bf16", **kw))
    u_j, s_j, v_j = (np.asarray(x) for x in jdrv.rsvd_with_omega(
        jnp.asarray(a), jnp.asarray(omega), precision="int8", **kw))
    assert np.abs(s_t - s_j).max() / s_j[0] <= 1e-4
    # and rsvd() takes the Int8Stored too
    _, s_r, _ = tdrv.rsvd(t8, k=16, p=8, q=2, method="eigh",
                          precision="bf16", qr_method="cholqr1",
                          finish="rowspace_utv")
    assert s_r.shape == (16,) and torch.isfinite(s_r).all()


@pytest.mark.parametrize("finish", ["rowspace", "rowspace_utv"])
def test_rowspace_finishes_need_a_power_round(finish):
    a = from_numpy(_gapped(48, 32))
    with pytest.raises(ValueError, match="q >= 1"):
        tdrv.rsvd_with_omega(a, from_numpy(_omega(32, 8)), q=0,
                             method="eigh", finish=finish)


# ------------------------------------------------ rank deficiency


_EXPECT = {
    "robust": "clean", "robust1": "clean", "householder": "clean",
    "cholqr1": "nan", "cholqr1_fused": "nan",
    "cholqr2": "graceful", "cholqr3": "graceful",
    "polar": "unsafe", "polar_fused": "unsafe",
}


def _classify(h):
    if not h["finite"]:
        return "nan"
    return "clean" if h["ok"] else "graceful"


@pytest.mark.parametrize("qr_method", list(_EXPECT))
@pytest.mark.parametrize("finish", ["project", "utv", "rowspace_utv"])
def test_rank_deficiency_contract(finish, qr_method):
    """tests/test_diagnostics.py:202-281 for the port: on an exactly
    rank-30 operand with l = 36, cholqr1 and its fused twin give NaN
    factors, cholqr2/3 finite ones, the robust methods never NaN, and
    polar is out of domain (factor_health classifies whatever comes)."""
    r = np.random.default_rng(3)
    a = r.standard_normal((100, 60)).astype(np.float32)
    a[:, 30:] = a[:, :30]
    a = from_numpy(a)
    omega = from_numpy(_omega(60, 36, seed=4))
    u, s, v = tdrv.rsvd_with_omega(a, omega, q=1, k=30, method="eigh",
                                   qr_method=qr_method,
                                   interior_qr=qr_method, finish=finish)
    got = _classify(tdiag.factor_health(u, s, v))
    expect = _EXPECT[qr_method]
    if expect == "nan":
        assert got == "nan"
    elif expect == "clean":
        assert got != "nan"
    elif expect == "graceful":
        assert got in ("graceful", "clean")
    else:
        assert got in ("nan", "graceful", "clean")


# ------------------------------------------ diagnostics and UTV


def _triples():
    r = np.random.default_rng(1)
    u, _ = np.linalg.qr(r.standard_normal((60, 8)))
    v, _ = np.linalg.qr(r.standard_normal((40, 8)))
    s = np.linspace(8.0, 1.0, 8)
    short = u.copy()
    short[:, -1] *= 0.1
    nan_u = np.full((60, 8), np.nan)
    asc = s.copy()
    asc[1] = 9.0
    return {"healthy": (u, s, v), "short": (short, s, v),
            "nan": (nan_u, s, v), "ascending": (u, asc, v)}


@pytest.mark.parametrize("name", ["healthy", "short", "nan", "ascending"])
def test_factor_health_matches_jax(name):
    u, s, v = _triples()[name]
    h_j = jdiag.factor_health(*(jnp.asarray(x) for x in (u, s, v)))
    h_t = tdiag.factor_health(*(from_numpy(x) for x in (u, s, v)))
    assert h_t["ok"] == h_j["ok"] and h_t["finite"] == h_j["finite"]
    assert h_t["ok"] == (name == "healthy")
    for key in ("u_col_err", "v_orth_err", "s_ascending_violation",
                "s_min"):
        # the same f64 sums: roundoff only (inf where not finite)
        np.testing.assert_allclose(h_t[key], h_j[key], rtol=1e-12,
                                   atol=1e-14)


def test_principal_angles_match_jax():
    r = np.random.default_rng(5)
    x = r.standard_normal((50, 6))
    y = x + 0.1 * r.standard_normal((50, 6))
    ang_j, cos_j = jdiag.principal_angles(jnp.asarray(x), jnp.asarray(y))
    ang_t, cos_t = tdiag.principal_angles(from_numpy(x), from_numpy(y))
    np.testing.assert_allclose(to_numpy(cos_t), np.asarray(cos_j),
                               atol=1e-12)
    np.testing.assert_allclose(to_numpy(ang_t), np.asarray(ang_j),
                               atol=1e-7)
    d_j = float(jdiag.subspace_distance(jnp.asarray(x), jnp.asarray(y)))
    d_t = float(tdiag.subspace_distance(from_numpy(x), from_numpy(y)))
    assert abs(d_t - d_j) <= 1e-7 and 0.0 < d_t < 1.0


@pytest.mark.parametrize("finish", ["utv", "rowspace_utv"])
def test_utv_rescore_matches_jax(finish):
    """The exact SVD of a UTV approximant, on the same factors, in f64."""
    a = _gapped(dtype=np.float64)
    omega = _omega(128, 24, dtype=np.float64)
    u, s, v = (np.asarray(x) for x in jdrv.rsvd_with_omega(
        jnp.asarray(a), jnp.asarray(omega), q=2, k=16, method="eigh",
        qr_method="cholqr1", reorth="half", finish=finish))
    u_j, s_j, v_j = (np.asarray(x) for x in
                     jutv.utv_rescore(*(jnp.asarray(x) for x in (u, s, v))))
    u_t, s_t, v_t = (to_numpy(x) for x in
                     tutv.utv_rescore(*(from_numpy(x) for x in (u, s, v))))
    np.testing.assert_allclose(s_t, s_j, rtol=1e-10)
    # the same approximant, exactly factored by both
    m_in = (u * s) @ v.T
    assert np.linalg.norm((u_t * s_t) @ v_t.T - m_in) <= \
        1e-10 * np.linalg.norm(m_in)
    np.testing.assert_allclose(np.abs(u_t.T @ u_j), np.eye(16), atol=1e-6)


def test_rutv_matches_jax_on_the_same_omega(monkeypatch):
    """rutv draws Omega (m x l) from its seed; both packages are handed
    the same numpy Omega instead."""
    a = _gapped(96, 64, seed=6, dtype=np.float64)
    omega = _omega(96, 14, seed=7, dtype=np.float64)
    monkeypatch.setattr(jutv, "generate_omega",
                        lambda *args, **kw: jnp.asarray(omega))
    monkeypatch.setattr(tutv, "generate_omega",
                        lambda *args, **kw: from_numpy(omega))
    kw = dict(k=8, p=6, q=1, seed=123, qr_method="robust")
    u_j, t_j, v_j = (np.asarray(x) for x in jutv.rutv(jnp.asarray(a), **kw))
    u_t, t_t, v_t = (to_numpy(x) for x in tutv.rutv(from_numpy(a), **kw))
    np.testing.assert_allclose(t_t, t_j, atol=1e-10)
    assert np.all(np.diag(t_t) > 0) and np.allclose(np.tril(t_t, -1), 0)
    rec_t = to_numpy(tutv.rutv_reconstruct(*(from_numpy(x) for x in
                                             (u_t, t_t, v_t)), k=8))
    rec_j = np.asarray(jutv.rutv_reconstruct(
        *(jnp.asarray(x) for x in (u_j, t_j, v_j)), k=8))
    np.testing.assert_allclose(rec_t, rec_j, atol=1e-10)


# ------------------------------------------------------ serving


@pytest.mark.parametrize("interior", ["cholqr1", "polar_fused"])
@pytest.mark.parametrize("storage", ["int8", "bf16", "default"])
def test_rsvd_serving_is_rsvd_with_omega(storage, interior):
    a = from_numpy(_gapped())
    operand = tsrv.prepare_operand(a) if storage == "int8" else a
    u, s, v, health = tsrv.rsvd_serving(operand, k=16, p=8, q=2, seed=3,
                                        interior_qr=interior,
                                        storage=storage)
    omega = tdrv.generate_omega(3, 128, 24, device="cpu")
    u2, s2, v2 = tdrv.rsvd_with_omega(
        a, omega, q=2, k=16, method="eigh", qr_method="cholqr1",
        interior_qr=interior, reorth="half", precision=storage,
        finish="rowspace_utv")
    assert torch.equal(s, s2) and torch.equal(u, u2) and torch.equal(v, v2)
    assert health["ok"] and health["finite"]
    # a good rank-16 approximation (gapped spectrum, q=2); polar
    # interiors carry a bounded truncation penalty under the UTV finishes
    # on gapped spectra (tests/test_polar.py:193-220: < 1.2x cholqr1's)
    a_np = to_numpy(a)
    err = _err(a_np, *(to_numpy(x) for x in (u, s, v)))
    best = np.sqrt(np.sum(np.geomspace(1.0, 1e-3, 128)[16:] ** 2))
    if interior == "cholqr1":
        assert err <= 1.1 * best
    else:
        base = tsrv.rsvd_serving(operand, k=16, p=8, q=2, seed=3,
                                 storage=storage)
        assert err < 1.2 * _err(a_np, *(to_numpy(x) for x in base[:3]))


def test_serving_polar_interiors_launch_k2_twice(monkeypatch):
    """q = 2 rowspace_utv: the sketch basis and one interior round are
    the interiors, each one call of the K2 wrapper."""
    calls = []
    real = kernels.polar_qr_fused

    def counting(y, *args):
        calls.append(tuple(y.shape))
        return real(y, *args)

    monkeypatch.setattr(kernels, "polar_qr_fused", counting)
    tsrv.rsvd_serving(from_numpy(_gapped()), k=16, p=8,
                      interior_qr="polar_fused")
    assert calls == [(192, 24)] * 2


def _rank_deficient():
    a = np.random.default_rng(3).standard_normal((100, 60)).astype(
        np.float32)
    a[:, 30:] = a[:, :30]
    return from_numpy(a)


def test_serving_on_unhealthy_raise():
    with pytest.raises(FloatingPointError, match="unhealthy"):
        tsrv.rsvd_serving(_rank_deficient(), k=30, p=6, q=1)


def test_serving_on_unhealthy_warn():
    with pytest.warns(UserWarning, match="unhealthy"):
        *_, health = tsrv.rsvd_serving(_rank_deficient(), k=30, p=6, q=1,
                                       on_unhealthy="warn")
    assert health is not None and not health["ok"]


def test_serving_on_unhealthy_ignore():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        u, s, v, health = tsrv.rsvd_serving(_rank_deficient(), k=30, p=6,
                                            q=1, on_unhealthy="ignore")
    assert health is None and u.shape == (100, 30)
    with pytest.raises(ValueError, match="on_unhealthy"):
        tsrv.rsvd_serving(_rank_deficient(), k=30, on_unhealthy="skip")


# -------------------------------------------- entry points, devices


def test_entry_points_default_to_the_card():
    """key_from_seed / generate_omega draw on "cuda" unless the caller
    names a device, and a non-tensor operand goes to the card: on this
    CPU-only torch each of them fails for want of CUDA."""
    no_cuda = (RuntimeError, AssertionError)
    with pytest.raises(no_cuda):
        rng.key_from_seed(0)
    with pytest.raises(no_cuda):
        tdrv.generate_omega(0, 4, 2)
    with pytest.raises(no_cuda):
        tdrv.quantize_int8_rows(np.ones((4, 4), np.float32))
    assert tdrv.generate_omega(0, 4, 2, device="cpu").device.type == "cpu"
    assert rng.key_from_seed(0, "cpu").device.type == "cpu"


def test_bf16_storage_casts_a_once():
    a = from_numpy(_gapped())
    staged = tdrv._stage_operand(a, "bf16")
    assert staged.dtype == torch.bfloat16
    assert tdrv._stage_operand(staged, "bf16") is staged
    assert isinstance(tdrv._stage_operand(a, "int8"), tdrv.Int8Stored)
    assert tdrv._stage_operand(a, "highest") is a


# --- tests/test_serving_preset.py:25-46, at the JAX cases' bars on the
# port's own draws ------------------------------------------------------


def _decaying(m, n, lo=1e-2, seed=0):
    rng_ = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng_.standard_normal((m, min(m, n))))
    v, _ = np.linalg.qr(rng_.standard_normal((n, min(m, n))))
    s = np.geomspace(1.0, lo, min(m, n))
    return ((u * s) @ v.T).astype(np.float32)


def test_healthy_serving_run_matches_reference_quality():
    a = from_numpy(_decaying(220, 160))
    k = 12
    u, s, v, health = tsrv.rsvd_serving(a, k=k)
    assert health is not None and health["ok"]
    e = float(tdrv.reconstruction_error(a, u, s, v))
    uf, sf, vf = tdrv.rsvd(a, k=k, p=16, q=2, method="eigh")
    ef = float(tdrv.reconstruction_error(a, uf, sf, vf))
    assert e < 1.1 * ef + 1e-6


def test_prepared_operand_reused_bitwise():
    a = from_numpy(_decaying(180, 140, seed=1))
    st = tsrv.prepare_operand(a)
    u1, s1, v1, _ = tsrv.rsvd_serving(st, k=10)
    u2, s2, v2, _ = tsrv.rsvd_serving(st, k=10)
    assert torch.equal(s1, s2) and torch.equal(u1, u2)
    # and the prepared operand path equals the quantize-inside path
    u3, s3, v3, _ = tsrv.rsvd_serving(a, k=10)
    assert torch.equal(s1, s3)
