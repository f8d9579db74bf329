"""The port's PCA (``apps/pca.py``), Frequent Directions (``rsvd/fd.py``)
and ``StreamingPCA`` against the JAX package's, on the same numpy inputs
at f64 (tests/conftest.py turns x64 on).

Singular vectors are compared after aligning each column's sign with
JAX's.  The randomized path (``use_rsvd``) gets the JAX package's sketch
by patching the port's draw, as tests/test_torch_image.py does.  FD's
sketch rows are defined up to sign, so sketches are compared through
S^T S."""

import functools
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.apps import pca as jpca
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import fd as jfd
from rsvd_kamaneh_raganato_terrana_tpu.rsvd.driver import (
    generate_omega as jax_generate_omega,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import pca as tpca
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdriver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import fd as tfd

from conftest import DATA_DIR

# the port's entry points default to the card; these tests run on the CPU
from_numpy = functools.partial(convert.from_numpy, device="cpu")
RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _dataset(name):
    if name == "tourists":
        return tpca.load_tourists_dataset(
            os.path.join(DATA_DIR, "pca", "tourists.txt"))[0]
    if name == "athletic":
        return tpca.load_athletic_dataset(
            os.path.join(DATA_DIR, "pca", "dataset_athletic.txt"))[0]
    rng = np.random.default_rng(0)               # 'factor': 200 x 40
    x = rng.standard_normal((200, 40)) * 0.8 ** np.arange(40)[None, :]
    return x + rng.standard_normal(40)[None, :]


def _np(x):
    return convert.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _signs(v_port, v_jax):
    return np.where(np.sum(v_port * v_jax, axis=0) < 0, -1.0, 1.0)


def _rel(a, b):
    return np.abs(_np(a) - _np(b)).max() / max(np.abs(_np(b)).max(), 1e-300)


def _pair(name, **kw):
    data = _dataset(name)
    return data, jpca.PCA(jnp.asarray(data), **kw), \
        tpca.PCA(data, device="cpu", **kw)


def _assert_pca_equal(jp, tp):
    js, ts = np.asarray(jp.getS()), _np(tp.getS())
    assert _rel(ts, js) <= RTOL
    sign = _signs(_np(tp.getV()), np.asarray(jp.getV()))
    assert _rel(_np(tp.loadings()) * sign, jp.loadings()) <= RTOL
    assert _rel(_np(tp.scores()) * sign, jp.scores()) <= RTOL
    assert _rel(tp.explained_variance(), jp.explained_variance()) <= RTOL
    assert _rel(tp.explained_variance_ratio(),
                jp.explained_variance_ratio()) <= RTOL
    assert _rel(tp.mean, jp.mean) <= RTOL
    return sign


@pytest.mark.parametrize("name", ["tourists", "athletic"])
@pytest.mark.parametrize("normalize", [False, True])
def test_pca_matches_jax(name, normalize):
    data, jp, tp = _pair(name, normalize=normalize)
    sign = _assert_pca_equal(jp, tp)
    rows = data[:5] + 0.5
    assert _rel(_np(tp.project(rows)) * sign,
                jp.project(jnp.asarray(rows))) <= RTOL
    assert _rel(_np(tp.project(rows, n_components=2)) * sign[:2],
                jp.project(jnp.asarray(rows), n_components=2)) <= RTOL
    scores = np.asarray(jp.project(jnp.asarray(rows), 3))
    assert _rel(tp.reconstruct(scores * sign[:3], 3),
                jp.reconstruct(jnp.asarray(scores), 3)) <= RTOL
    assert tp.check_orthogonality() < 1e-12
    assert tp.getU().shape == tuple(jp.getU().shape)


@pytest.mark.parametrize("name", ["tourists", "athletic"])
def test_summary_prints_jax_numbers(name):
    """The table is JAX's to the digits printed; the loadings block
    prints signed vectors, so there the numbers agree up to sign."""
    _, jp, tp = _pair(name, normalize=True)
    assert tp.summary() == jp.summary()
    assert tp.summary().startswith("Importance of components:")
    names = [f"feature{i}" for i in range(tp.getV().shape[0])]
    assert _abs_numbers(tp.summary(names)) == _abs_numbers(jp.summary(names))


def _abs_numbers(text):
    out = []
    for token in text.split():
        try:
            out.append(abs(float(token)))
        except ValueError:
            pass
    return out


def test_add_data_and_save_results(tmp_path):
    data, jp, tp = _pair("athletic")
    extra = data[:4] * 1.1
    jp.add_data(jnp.asarray(extra))
    tp.add_data(extra)
    assert tp._raw.shape == (data.shape[0] + 4, data.shape[1])
    _assert_pca_equal(jp, tp)
    tp.save_results(str(tmp_path / "port.txt"))
    jp.save_results(str(tmp_path / "jax.txt"))
    port_lines = (tmp_path / "port.txt").read_text().splitlines()
    jax_lines = (tmp_path / "jax.txt").read_text().splitlines()
    assert len(port_lines) == len(jax_lines)
    for pl, jl in zip(port_lines, jax_lines):
        if pl.startswith("#"):
            assert pl == jl
        else:
            np.testing.assert_allclose(np.abs(np.array(pl.split(), float)),
                                       np.abs(np.array(jl.split(), float)),
                                       rtol=1e-9, atol=1e-12)


def test_use_rsvd_matches_jax_on_its_sketch():
    """The randomized path (k = 5, p = 10: l = 15 of 40 features) on
    JAX's own Omega, patched into the port's draw."""
    data = _dataset("factor")
    jp = jpca.PCA(jnp.asarray(data), use_rsvd=True, rank=5)
    drawn = []

    def draw(key_or_seed, n, l, dtype=None, kind="gaussian", device=None):
        drawn.append((key_or_seed, n, l))
        return from_numpy(np.asarray(jax_generate_omega(
            key_or_seed, n, l, jnp.float64, kind)))
    with mock.patch.object(tdriver, "generate_omega", draw):
        tp = tpca.PCA(data, use_rsvd=True, rank=5, device="cpu")
    assert drawn == [(0, 40, 15)]
    assert tp.getS().shape == (5,)
    _assert_pca_equal(jp, tp)


def test_pca_rejects_small_data_and_keeps_a_tensors_device():
    with pytest.raises(ValueError, match="2 x 2"):
        tpca.PCA(np.zeros((1, 3)), device="cpu")
    x = from_numpy(_dataset("athletic"))
    assert tpca.PCA(x).getV().device.type == "cpu"


# -- Frequent Directions and StreamingPCA ------------------------------------
BATCHES = (37, 1, 100, 16, 90, 56)        # 300 rows in uneven batches


def _stream(n_cols=40, seed=1):
    rng = np.random.default_rng(seed)
    rows = sum(BATCHES)
    a = rng.standard_normal((rows, n_cols)) * 0.85 ** np.arange(n_cols)
    a += 2.0 * rng.standard_normal(n_cols)[None, :]
    cuts = np.cumsum(BATCHES)[:-1]
    return a, np.split(a, cuts)


def test_frequent_directions_matches_jax():
    a, batches = _stream()
    l = 8
    jf = jfd.FrequentDirections(a.shape[1], l, dtype=jnp.float64)
    tf = tfd.FrequentDirections(a.shape[1], l, dtype=torch.float64,
                                device="cpu")
    for b in batches:
        jf.update(b)
        tf.update(b)
    assert tf.rows_seen == jf.rows_seen == a.shape[0]
    s_t, s_j = _np(tf.sketch()), np.asarray(jf.sketch())
    assert s_t.shape == s_j.shape
    gram = a.T @ a
    assert np.abs(s_t.T @ s_t - s_j.T @ s_j).max() <= \
        RTOL * np.abs(gram).max()
    lt, vt = tf.eigh_estimate(k=4)
    lj, vj = jf.eigh_estimate(k=4)
    assert _rel(lt, lj) <= RTOL
    assert _rel(np.abs(_np(vt)), np.abs(np.asarray(vj))) <= 1e-8
    # FD's guarantee: never over A^T A, under it by at most
    # ||A - A_k||_F^2 / (l - k)
    true = np.linalg.eigvalsh(gram)[::-1]
    sv = np.linalg.svd(a, compute_uv=False)
    assert np.all(_np(lt) <= true[:4] * (1 + 1e-12))
    for k in range(1, l):
        bound = np.sum(sv[k:] ** 2) / (l - k)
        assert np.all(true[:4] - _np(lt) <= bound * (1 + 1e-12))


def test_shrink_matches_jax():
    buf = np.random.default_rng(2).standard_normal((12, 30))
    got = _np(tfd._shrink(from_numpy(buf), 6))
    want = np.asarray(jfd._shrink(jnp.asarray(buf), 6))
    assert np.all(got[6:] == 0.0) and np.all(want[6:] == 0.0)
    assert np.abs(got.T @ got - want.T @ want).max() <= \
        RTOL * np.abs(buf.T @ buf).max()


def test_frequent_directions_rejects_bad_input():
    with pytest.raises(ValueError, match="l must be"):
        tfd.FrequentDirections(4, 0, device="cpu")
    fd = tfd.FrequentDirections(4, 2, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="expected 4 columns"):
        fd.update(np.zeros((3, 5)))
    fd.update(np.ones(4))                          # one row as a vector
    assert fd.rows_seen == 1 and fd.sketch().shape == (1, 4)


def test_streaming_pca_matches_jax_and_never_overestimates():
    a, batches = _stream(seed=3)
    js = jpca.StreamingPCA(a.shape[1], l=10, dtype=jnp.float64)
    ts = tpca.StreamingPCA(a.shape[1], l=10, dtype=torch.float64,
                           device="cpu")
    for b in batches:
        js.update(b)
        ts.update(from_numpy(b) if len(b) == 1 else b)   # tensor or array
    assert ts.n_seen == js.n_seen == a.shape[0]
    np.testing.assert_allclose(ts.mean, js.mean, rtol=1e-14)
    lt, vt = ts.finalize(k=5)
    lj, vj = js.finalize(k=5)
    assert _rel(lt, lj) <= RTOL
    sign = _signs(vt, vj)
    assert _rel(vt * sign, vj) <= 1e-8
    rows = a[:3]
    assert _rel(ts.project(rows, k=5) * sign, js.project(rows, k=5)) <= 1e-8
    cov = np.cov(a, rowvar=False)
    true = np.linalg.eigvalsh(cov)[::-1][:5]
    assert np.all(lt <= true * (1 + 1e-12))
    with pytest.raises(ValueError, match="2 rows"):
        tpca.StreamingPCA(4, l=2, device="cpu").finalize()


def test_streaming_pca_f32_keeps_fd_bound_where_jax_leaves_it():
    """f32 on an uncentred stream whose mean carries most of ||X||^2
    (chip_smoke.py's phase-7 model at 8192 x 512, a larger mean): the
    JAX package's f32 shrink leaves FD's bound there; the port shrinks in
    f64 and stores f32 rows, so its estimate stays under the true
    covariance eigenvalues, inside the bound, and with its f64 stream's
    to a small part of the bound."""
    d, l, k, rows = 512, 64, 32, 8192
    rng = np.random.default_rng(0)
    w = np.linalg.qr(rng.standard_normal((d, d)))[0]
    x = (rng.standard_normal((rows, d)) * 0.97 ** np.arange(d)) @ w.T
    x += 0.01 * rng.standard_normal((rows, d)) + 40.0 * rng.standard_normal(d)
    x = x.astype(np.float32)
    js = jpca.StreamingPCA(d, l=l, dtype=jnp.float32)
    ts = tpca.StreamingPCA(d, l=l, dtype=torch.float32, device="cpu")
    t64 = tpca.StreamingPCA(d, l=l, dtype=torch.float64, device="cpu")
    for i in range(0, rows, 4096):
        for sp in (js, ts, t64):
            sp.update(x[i:i + 4096])
    lj, lt, l64 = (sp.finalize(k)[0] for sp in (js, ts, t64))
    true = np.linalg.eigvalsh(np.cov(x.astype(np.float64), rowvar=False))
    true = true[::-1]
    bound = np.sum(true[k:]) / (l - k)
    assert np.max(true[:k] - lj) > bound
    assert np.all(lt <= true[:k] * (1 + 1e-4))
    assert np.all(true[:k] - lt <= bound)
    assert np.abs(lt - l64).max() <= 0.1 * bound
