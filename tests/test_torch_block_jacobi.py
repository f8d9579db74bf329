"""The port's block Jacobi engine (``jacobi_svd(apply='block')``, 'auto'
above n = 512 and ``jacobi_svd_chunked``) against the JAX package's, on
the same numpy inputs at f64 (tests/conftest.py turns x64 on), mirroring
tests/test_jacobi.py's block cases.

The pair Grams' eigenvectors are free inside degenerate blocks (the zero
pad columns give exact zero eigenvalues), and LAPACK under torch and
under JAX may pick different ones, so W and V are not compared round by
round.  The finished factors are: sigma by its error relative to
sigma_1, U and V by principal angles on separated singular values, and
the reconstruction by its relative Frobenius error."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.linalg import jacobi as jjac
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import jacobi as tjac

# the port's entry points default to the card; these tests run on the CPU
from_numpy = functools.partial(convert.from_numpy, device="cpu")

SIGMA_TOL = 1e-10        # max |s - s_jax| / s_1
ANGLE_TOL = 1e-8         # principal angles on separated singular values
RECON_TOL = 1e-12        # ||A - U S V^T||_F / ||A||_F
GAP = 1e-6               # 'separated': both neighbour gaps >= GAP * s_1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spectrum_matrix(rng, m, n, sig):
    u0, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v0, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (u0 * sig[None, :]) @ v0.T


def _matrix(kind):
    """tests/test_jacobi.py's block inputs, with its block size."""
    rng = np.random.default_rng(0)
    if kind == "square":
        return rng.standard_normal((96, 96)), 16
    if kind == "nondividing":                # 50 columns, block 16: padded
        return rng.standard_normal((70, 50)), 16
    if kind == "wide_dynamic_range":         # cond 1e6 with a cluster
        sig = np.logspace(0, -6, 96)
        sig[30:36] = sig[33]
        return _spectrum_matrix(rng, 96, 96, sig), 16
    if kind == "rank_deficient":
        return (rng.standard_normal((80, 6))
                @ rng.standard_normal((6, 60))), 16
    if kind == "tall":                       # the QR precondition
        return rng.standard_normal((300, 128)), 32
    if kind == "wide":                       # factored transposed
        return rng.standard_normal((80, 150)), 16
    raise ValueError(kind)


def _separated(s):
    """Indices of singular values whose gaps to both neighbours are at
    least GAP * s_1 (and which are themselves above it)."""
    gaps = np.abs(np.diff(s))
    lo = np.concatenate([[np.inf], gaps])
    hi = np.concatenate([gaps, [np.inf]])
    return np.flatnonzero((np.minimum(lo, hi) >= GAP * s[0])
                          & (s >= GAP * s[0]))


def _max_angle(x, y):
    """The largest principal angle between span(x) and span(y), both with
    orthonormal columns, from its sine ||(I - X X^T) Y||_2 (its cosine
    cannot resolve angles below sqrt(eps))."""
    sine = np.linalg.norm(y - x @ (x.T @ y), 2)
    return float(np.arcsin(min(sine, 1.0)))


def _assert_matches_jax(a, got, want):
    tu, ts, tv = (convert.to_numpy(x) for x in got)
    ju, js, jv = (np.asarray(x) for x in want)
    assert tu.shape == ju.shape and ts.shape == js.shape \
        and tv.shape == jv.shape
    assert np.abs(ts - js).max() <= SIGMA_TOL * js[0]
    assert np.all(ts[:-1] >= ts[1:])
    for i in _separated(js):
        assert _max_angle(tu[:, [i]], ju[:, [i]]) <= ANGLE_TOL, i
        assert _max_angle(tv[:, [i]], jv[:, [i]]) <= ANGLE_TOL, i
    rec = (tu * ts[None, :]) @ tv.T
    assert np.linalg.norm(a - rec) <= RECON_TOL * np.linalg.norm(a)


@pytest.mark.parametrize("kind", ["square", "nondividing",
                                  "wide_dynamic_range", "rank_deficient",
                                  "tall", "wide"])
def test_block_engine_matches_jax(kind):
    a, b = _matrix(kind)
    got = tjac.jacobi_svd(from_numpy(a), apply="block", block_size=b)
    want = jjac.jacobi_svd(jnp.asarray(a), apply="block", block_size=b)
    _assert_matches_jax(a, got, want)


def test_wide_dynamic_range_orthogonality():
    """The gated scalar polish recovers full orthogonality where the pair
    eigh cannot (tests/test_jacobi.py:80-93)."""
    a, b = _matrix("wide_dynamic_range")
    u, _, v = tjac.jacobi_svd(from_numpy(a), apply="block", block_size=b)
    eye = torch.eye(a.shape[1], dtype=torch.float64)
    assert torch.linalg.norm(u.T @ u - eye) < 1e-10
    assert torch.linalg.norm(v.T @ v - eye) < 1e-10


def test_auto_above_512_reaches_the_block_engine():
    """n = 520: 'auto' picks the block engine in both packages (b = 64,
    9 blocks padded to 10).  Kept cheap: the columns are orthogonal up to
    rounding, so neither phase needs a sweep, but the presort, the zero
    padding and the finish all run."""
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.standard_normal((520, 520)))
    a = q * rng.permutation(np.linspace(1.0, 2.0, 520))[None, :]
    assert tjac._auto_apply(520) == jjac._auto_apply(520) == "block"
    sweeps = []
    real = tjac._block_jacobi_core

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        sweeps.append(out[3])
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjac, "_block_jacobi_core", spy)
        got = tjac.jacobi_svd(from_numpy(a))
    assert sweeps == [0]
    _assert_matches_jax(a, got, jjac.jacobi_svd(jnp.asarray(a)))


@pytest.mark.parametrize("kind", ["wide_dynamic_range", "tall"])
def test_chunked_matches_single_dispatch_and_jax(kind):
    """The chunked driver runs the block engine's stages with the same
    stopping rules: its factors equal the single-dispatch engine's, and
    its progress calls (phase and sweep) are JAX's chunked driver's, with
    the block phase's measures above 1e-6 within 1e-4 of JAX's (below,
    the mass ratio is a difference of sums that cancels to rounding).  Both inputs fill
    their blocks: zero pad columns leave rounding-level columns whose
    normalized inner products are noise, so in both packages the polish
    then runs to ``max_sweeps`` and its measures are not comparable."""
    a, b = _matrix(kind)
    seen, seen_jax = [], []
    got = tjac.jacobi_svd_chunked(
        from_numpy(a), block_size=b,
        progress=lambda *call: seen.append(call))
    want = jjac.jacobi_svd_chunked(
        jnp.asarray(a), block_size=b,
        progress=lambda *call: seen_jax.append(call))
    single = tjac.jacobi_svd(from_numpy(a), apply="block", block_size=b)
    for x, y in zip(got, single):
        assert torch.equal(x, y)
    assert [c[:2] for c in seen] == [c[:2] for c in seen_jax]
    assert any(phase == "block" for phase, _, _ in seen)
    for (phase, _, off), (_, _, off_jax) in zip(seen, seen_jax):
        if phase == "block" and off_jax >= 1e-6:
            assert abs(off - off_jax) <= 1e-4 * off_jax
    _assert_matches_jax(a, got, want)


def test_chunked_wide_input_transposes():
    a, b = _matrix("wide")
    got = tjac.jacobi_svd_chunked(from_numpy(a), block_size=b)
    _assert_matches_jax(a, got, jjac.jacobi_svd_chunked(jnp.asarray(a),
                                                        block_size=b))


def test_block_engine_f32():
    """The card's dtype: the port at f32 against JAX at f32."""
    a = np.random.default_rng(3).standard_normal((96, 64)).astype(np.float32)
    tu, ts, tv = tjac.jacobi_svd(from_numpy(a), apply="block", block_size=16)
    js = np.asarray(jjac.jacobi_svd(jnp.asarray(a), apply="block",
                                    block_size=16)[1])
    assert ts.dtype == torch.float32 and tu.dtype == torch.float32
    s64 = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    assert np.abs(ts.numpy() - js).max() <= 1e-5 * js[0]
    assert np.abs(ts.numpy() - s64).max() <= 1e-5 * s64[0]
    eye = torch.eye(64)
    assert torch.linalg.norm(tv.T @ tv - eye) < 1e-4


def _apply_round_plain(w, v, p_idx, q_idx, c, s):
    """The rotation in its plain form (c x_p - s x_q, s x_p + c x_q)."""
    for x in (w, v):
        xp, xq = x[:, p_idx], x[:, q_idx]
        x[:, p_idx] = c * xp - s * xq
        x[:, q_idx] = s * xp + c * xq
    return w, v


def test_polish_rotation_keeps_norms_at_small_angles():
    """The engines apply their rotations in Rutishauser's form: equal to
    the plain (c x_p - s x_q, s x_p + c x_q) to rounding, and in f32 a
    thousand small-angle rotations leave the column norms where the plain
    form lets them grow."""
    rng = np.random.default_rng(6)
    x64 = np.linalg.qr(rng.standard_normal((64, 2)))[0]
    t = np.float64(2e-4)       # 1 + t^2 rounds to 1 in f32: c = 1
    c, s = 1.0 / np.sqrt(1.0 + t * t), t / np.sqrt(1.0 + t * t)
    p, q = torch.tensor([0]), torch.tensor([1])
    cs64 = torch.tensor([c]), torch.tensor([s])
    w, plain = torch.from_numpy(x64.copy()), torch.from_numpy(x64.copy())
    eye = torch.eye(2, dtype=torch.float64)
    tjac._apply_round_rutishauser(w, eye.clone(), p, q, *cs64)
    _apply_round_plain(plain, eye.clone(), p, q, *cs64)
    assert float((w - plain).abs().max()) <= 1e-15
    w32 = torch.from_numpy(x64.astype(np.float32))
    plain32 = w32.clone()
    cs32 = torch.tensor([c], dtype=torch.float32), \
        torch.tensor([s], dtype=torch.float32)
    for _ in range(1000):
        tjac._apply_round_rutishauser(w32, torch.eye(2), p, q, *cs32)
        _apply_round_plain(plain32, torch.eye(2), p, q, *cs32)
    drift = float((torch.linalg.norm(w32, dim=0) - 1.0).abs().max())
    drift_plain = float((torch.linalg.norm(plain32, dim=0) - 1.0).abs().max())
    assert drift <= 1e-6 < 1e-5 <= drift_plain
