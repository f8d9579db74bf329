"""The port's HODLR compression (``rsvd/hodlr.py``) and GP regression
(``apps/gp.py``) against the JAX package's, on the CPU in f64.

The JAX package's Omega for each level (``seed + ell``) is patched into
the port's ``generate_omega``, and its SLQ probes into the port's
``rademacher``; the compressed operator, the CG solve, the GP's weights,
posterior mean and variance and its log-marginal-likelihood must then
equal JAX's to ``RTOL`` = 1e-9 relative.  Factors are compared through
the operator they build (``hodlr_reconstruct``, ``hodlr_matvec``): the
sign of each singular pair is the LAPACK build's choice and cancels in
the products.  CG is held to ``jax.scipy.sparse.linalg.cg`` iterate by
iterate on one operator (``convert.hodlr_from_jax``), and a block of
right-hand sides to JAX's ``vmap`` of it, column by column.  The cases
``tests/test_hodlr.py`` and ``test_gp.py`` mark slow run here on the
port alone, against the same dense references, at the JAX tests' sizes.
f32 cases hold the port to JAX at 1e-4 relative (f32 roundoff through a
q = 1 range finder and CG).  A GP's weights come out of CG on K + 0.05^2
I (condition ~1e3), which amplifies the two builds' 1e-15 summation
differences: the HODLR GP's weights and mean are held at ``CG_RTOL`` =
1e-8, its variance at 1e-8 absolute, of the prior variance 1 (the
posterior variance ~2.6e-3 is 1 - k*^T K^-1 k*, a 400-fold
cancellation)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.apps import gp as jgp
from rsvd_kamaneh_raganato_terrana_tpu.core.rng import (
    key_from_seed as jax_key_from_seed,
    rademacher as jax_rademacher,
)
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import hodlr as jhodlr
from rsvd_kamaneh_raganato_terrana_tpu.rsvd.driver import (
    generate_omega as jax_generate_omega,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import gp as tgp
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import hodlr as thodlr
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import slq as tslq
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    rsvd_with_omega,
)

from_numpy = functools.partial(convert.from_numpy, device="cpu")
RTOL = 1e-9
CG_RTOL = 1e-8
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_omega(seed, n, l, dtype=torch.float64, kind="gaussian",
               device=None):
    """The JAX package's generate_omega(seed, n, l) in ``dtype``."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    return from_numpy(np.asarray(jax_generate_omega(int(seed), n, l, jdt)))


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(thodlr, "generate_omega", _jax_omega)


def _rel(got, want):
    got = to_numpy(got) if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def _rbf_kernel(n, ell=0.1):
    x = np.linspace(0, 1, n)
    k = np.exp(-((x[:, None] - x[None, :]) ** 2) / (2 * ell * ell))
    return k + 0.1 * np.eye(n)


def _spd_kernel_matrix(n, ell=0.1, ridge=0.1):
    x = np.linspace(0, 1, n)
    k = np.exp(-((x[:, None] - x[None, :]) ** 2) / (2 * ell * ell))
    return k + ridge * np.eye(n)


def _both(a, **kw):
    """(port HODLR, JAX HODLR) of ``a``, the port's reconstruction held
    to JAX's."""
    hj = jhodlr.hodlr_build(jnp.asarray(a), **kw)
    ht = thodlr.hodlr_build(from_numpy(a), **kw)
    assert (ht.n, ht.k) == (hj.n, hj.k)
    assert [tuple(x.shape) for x in ht.u_upper] == \
        [tuple(x.shape) for x in hj.u_upper]
    assert _rel(thodlr.hodlr_reconstruct(ht),
                jhodlr.hodlr_reconstruct(hj)) <= RTOL
    return ht, hj


# -- HODLR --------------------------------------------------------------------

def test_hodlr_reconstruction_accuracy(jax_draws):
    a = _rbf_kernel(256)
    h, _ = _both(a, levels=3, k=16)
    rec = to_numpy(thodlr.hodlr_reconstruct(h))
    assert np.linalg.norm(rec - a) < 1e-6 * np.linalg.norm(a)


def test_hodlr_matvec_matches_dense():
    a = _rbf_kernel(512, ell=0.05)
    h = thodlr.hodlr_build(from_numpy(a), levels=4, k=20)
    x = np.random.default_rng(1).standard_normal(512)
    y_h = to_numpy(thodlr.hodlr_matvec(h, from_numpy(x)))
    y_d = a @ x
    assert np.linalg.norm(y_h - y_d) < 1e-6 * np.linalg.norm(y_d)


def test_hodlr_matvec_consistent_with_reconstruction(jax_draws):
    a = _rbf_kernel(128)
    h, hj = _both(a, levels=2, k=12)
    x = np.random.default_rng(2).standard_normal(128)
    y_h = to_numpy(thodlr.hodlr_matvec(h, from_numpy(x)))
    y_r = to_numpy(thodlr.hodlr_reconstruct(h)) @ x
    np.testing.assert_allclose(y_h, y_r, atol=1e-8 * np.abs(y_r).max())
    assert _rel(y_h, jhodlr.hodlr_matvec(hj, jnp.asarray(x))) <= RTOL
    # a block of columns is the columns' matvecs
    xs = np.random.default_rng(3).standard_normal((128, 5))
    ys = to_numpy(thodlr.hodlr_matvec(h, from_numpy(xs)))
    for j in range(5):
        np.testing.assert_allclose(
            ys[:, j], to_numpy(thodlr.hodlr_matvec(h, from_numpy(xs[:, j]))),
            rtol=0, atol=1e-13)


def test_hodlr_compression_ratio():
    a = _rbf_kernel(1024, ell=0.2)
    h = thodlr.hodlr_build(from_numpy(a), levels=5, k=8)
    assert thodlr.hodlr_compression_ratio(h) > 4.0
    x = np.random.default_rng(3).standard_normal(1024)
    y_h = to_numpy(thodlr.hodlr_matvec(h, from_numpy(x)))
    assert np.linalg.norm(y_h - a @ x) < 1e-5 * np.linalg.norm(a @ x)


def test_hodlr_compression_ratio_counts_as_jax(jax_draws):
    h, hj = _both(_rbf_kernel(128), levels=3, k=4)
    assert thodlr.hodlr_compression_ratio(h) == \
        jhodlr.hodlr_compression_ratio(hj)


def test_hodlr_full_rank_diagonal_is_exact(jax_draws):
    rng = np.random.default_rng(4)
    a = np.zeros((128, 128))
    for i in range(4):
        a[i * 32:(i + 1) * 32, i * 32:(i + 1) * 32] = rng.standard_normal(
            (32, 32))
    h, _ = _both(a, levels=2, k=2)
    np.testing.assert_allclose(to_numpy(thodlr.hodlr_reconstruct(h)), a,
                               atol=1e-10)


def test_hodlr_invalid_inputs_raise():
    with pytest.raises(ValueError):
        thodlr.hodlr_build(torch.zeros((10, 12), dtype=torch.float64),
                           levels=1)
    with pytest.raises(ValueError):
        thodlr.hodlr_build(torch.zeros((100, 100), dtype=torch.float64),
                           levels=3)


def test_hodlr_deterministic():
    a = from_numpy(_rbf_kernel(128))
    h1 = thodlr.hodlr_build(a, levels=2, k=8, seed=7)
    h2 = thodlr.hodlr_build(a, levels=2, k=8, seed=7)
    assert torch.equal(h1.u_upper[0], h2.u_upper[0])


def test_hodlr_vmapped_levels_equal_a_loop_over_blocks():
    """The vmapped per-level rSVD (the 'robust' QR as a select) gives
    each block the numbers of a plain call on that block."""
    a = from_numpy(_rbf_kernel(256, ell=0.05))
    h = thodlr.hodlr_build(a, levels=2, k=6, seed=3)
    omega = thodlr.generate_omega(3 + 1, 64, 16, torch.float64, device=CPU)
    for i in range(2):
        blk = a[i * 128 + 64:(i + 1) * 128, i * 128:i * 128 + 64]
        u, s, v = rsvd_with_omega(blk, omega, q=1, k=16, method="eigh",
                                  reorth="half")
        np.testing.assert_allclose(to_numpy(h.u_lower[1][i]),
                                   to_numpy(u * s)[:, :6], rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(to_numpy(h.v_lower[1][i]),
                                   to_numpy(v)[:, :6], rtol=0, atol=1e-12)


def test_implicit_matches_dense_build_reconstruction(jax_draws):
    n = 256
    x = np.linspace(0.0, 1.0, n)
    a_np = np.exp(-8.0 * np.abs(x[:, None] - x[None, :])).astype(np.float32)

    def block_fn(i0, j0, rows, cols):
        return a_np[i0:i0 + rows, j0:j0 + cols]

    hi = thodlr.hodlr_build_implicit(block_fn, n, levels=3, k=8, device=CPU)
    hd = thodlr.hodlr_build(from_numpy(a_np), levels=3, k=8)
    assert hi.leaves.dtype == torch.float32
    err_i = _rel(thodlr.hodlr_reconstruct(hi), a_np)
    err_d = _rel(thodlr.hodlr_reconstruct(hd), a_np)
    assert err_i < 1e-4 and err_d < 1e-4
    v = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    y_i = to_numpy(thodlr.hodlr_matvec(hi, from_numpy(v)))
    np.testing.assert_allclose(y_i, to_numpy(thodlr.hodlr_matvec(
        hd, from_numpy(v))), rtol=1e-3, atol=1e-3)
    hj = jhodlr.hodlr_build_implicit(block_fn, n, levels=3, k=8)
    assert _rel(y_i, jhodlr.hodlr_matvec(hj, jnp.asarray(v))) <= 1e-4


def test_implicit_device_block_fn_and_validation():
    n = 128
    xs = torch.linspace(0.0, 1.0, n, dtype=torch.float32)

    def block_fn(i0, j0, rows, cols):
        xi, xj = xs[i0:i0 + rows], xs[j0:j0 + cols]
        return torch.exp(-4.0 * torch.abs(xi[:, None] - xj[None, :]))

    h = thodlr.hodlr_build_implicit(block_fn, n, levels=2, k=8)
    assert h.leaves.device == xs.device
    y = thodlr.hodlr_matvec(h, torch.ones(n, dtype=torch.float32))
    x_np = xs.numpy()
    a_np = np.exp(-4.0 * np.abs(x_np[:, None] - x_np[None, :]))
    np.testing.assert_allclose(to_numpy(y), a_np.sum(axis=1), rtol=1e-3)
    with pytest.raises(ValueError):
        thodlr.hodlr_build_implicit(block_fn, 130, levels=2, k=8)


def test_implicit_build_is_dtype_agnostic(jax_draws):
    n = 128
    x = np.linspace(0.0, 1.0, n)
    a_np = np.exp(-8.0 * np.abs(x[:, None] - x[None, :]))

    def block_fn(i0, j0, rows, cols):
        return a_np[i0:i0 + rows, j0:j0 + cols]

    hi = thodlr.hodlr_build_implicit(block_fn, n, levels=2, k=8, device=CPU)
    hd, hj = _both(a_np, levels=2, k=8)
    assert hi.u_upper[0].dtype == hd.u_upper[0].dtype == torch.float64
    for fi, fd in zip(hi.u_upper + hi.v_lower, hd.u_upper + hd.v_lower):
        assert torch.equal(fi, fd)
    hij = jhodlr.hodlr_build_implicit(block_fn, n, levels=2, k=8)
    assert _rel(thodlr.hodlr_reconstruct(hi),
                jhodlr.hodlr_reconstruct(hij)) <= RTOL


# -- hodlr_solve: CG ------------------------------------------------------------

def test_hodlr_solve_matches_dense_solve():
    a = _spd_kernel_matrix(512)
    h = thodlr.hodlr_build(from_numpy(a), levels=4, k=20)
    b = np.random.default_rng(0).standard_normal(512)
    x_h = to_numpy(thodlr.hodlr_solve(h, from_numpy(b)))
    x_d = np.linalg.solve(a, b)
    assert np.linalg.norm(x_h - x_d) < 1e-5 * np.linalg.norm(x_d)


def test_hodlr_solve_residual_small(jax_draws):
    a = _spd_kernel_matrix(256, ell=0.05)
    h, hj = _both(a, levels=3, k=16)
    b = np.random.default_rng(1).standard_normal(256)
    x = to_numpy(thodlr.hodlr_solve(h, from_numpy(b)))
    assert np.linalg.norm(a @ x - b) < 1e-6 * np.linalg.norm(b)
    assert _rel(x, jhodlr.hodlr_solve(hj, jnp.asarray(b))) <= RTOL


@pytest.fixture(scope="module")
def one_operator():
    """One HODLR operator in both packages (the JAX build carried over)."""
    hj = jhodlr.hodlr_build(jnp.asarray(_spd_kernel_matrix(256, ell=0.05)),
                            levels=3, k=16)
    return hj, convert.hodlr_from_jax(hj, CPU)


@pytest.mark.parametrize("maxiter", [1, 2, 3, 5, 8, 200])
def test_cg_iterates_equal_jax_cg(one_operator, maxiter):
    hj, ht = one_operator
    b = np.random.default_rng(2).standard_normal(256)
    want = jhodlr.hodlr_solve(hj, jnp.asarray(b), maxiter=maxiter)
    x, steps = thodlr.hodlr_solve(ht, from_numpy(b), maxiter=maxiter,
                                  return_steps=True)
    assert _rel(x, want) <= RTOL
    assert int(steps[0]) <= maxiter


def test_cg_block_of_columns_equals_jax_vmap(one_operator):
    """Columns scaled over 8 decades stop at different steps; each keeps
    its own step sizes and freezes, as the JAX while_loop under vmap."""
    hj, ht = one_operator
    rng = np.random.default_rng(3)
    bs = rng.standard_normal((256, 6)) * np.logspace(-4, 4, 6)
    bs[:, 3] = _spd_kernel_matrix(256, ell=0.05) @ rng.standard_normal(256)
    for tol in (1e-8, 1e-3):
        want = jax.vmap(lambda c: jhodlr.hodlr_solve(hj, c, tol=tol),
                        in_axes=1, out_axes=1)(jnp.asarray(bs))
        x, steps = thodlr.hodlr_solve(ht, from_numpy(bs), tol=tol,
                                      return_steps=True)
        for j in range(6):
            assert _rel(x[:, j], np.asarray(want)[:, j]) <= RTOL
        x1 = thodlr.hodlr_solve(ht, from_numpy(bs[:, 0]), tol=tol)
        assert torch.equal(x1, x[:, 0]) or _rel(x1, to_numpy(x[:, 0])) \
            <= 1e-13
    assert len(set(steps.tolist())) > 1


def test_cg_indefinite_operator_gives_non_finite(one_operator):
    """A leaf whose Cholesky fails is NaN, so CG returns NaN: the
    contract the GP's jitter escalation reads."""
    _, ht = one_operator
    bad = ht._replace(leaves=ht.leaves - 10.0 * torch.eye(
        ht.leaves.shape[1], dtype=ht.leaves.dtype))
    x = thodlr.hodlr_solve(bad, from_numpy(np.ones(256)))
    assert not torch.isfinite(x).all()


# -- GP ---------------------------------------------------------------------------

def _toy_data(n=1024, noise=0.02, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.random(n))
    y = np.sin(2 * np.pi * x) + 0.3 * np.sin(9 * np.pi * x)
    return x[:, None], y + noise * rng.standard_normal(n)


KERN_T = functools.partial(tgp.rbf_kernel, lengthscale=0.05)
KERN_J = functools.partial(jgp.rbf_kernel, lengthscale=0.05)


def test_rbf_kernel_matches_jax():
    rng = np.random.default_rng(0)
    x1, x2 = rng.random((7, 2)), rng.random((5, 2))
    assert _rel(tgp.rbf_kernel(from_numpy(x1), from_numpy(x2), 0.3, 2.0),
                jgp.rbf_kernel(x1, x2, 0.3, 2.0)) <= RTOL


def test_gp_hodlr_matches_dense_posterior():
    x, y = _toy_data(n=1024)
    xt = from_numpy(np.linspace(0.05, 0.95, 40)[:, None])
    gp_d = tgp.GP(noise=0.05, solver="dense", device=CPU).fit(x, y)
    gp_h = tgp.GP(noise=0.05, solver="hodlr", levels=3, rank=32,
                  device=CPU).fit(x, y)
    assert gp_h.solver_used_.startswith("hodlr")
    m_d = to_numpy(gp_d.predict(xt))
    m_h = to_numpy(gp_h.predict(xt))
    np.testing.assert_allclose(m_h, m_d, atol=1e-4 * np.abs(m_d).max())


def test_gp_predicts_smooth_function():
    x, y = _toy_data(n=600, noise=0.01)
    gp = tgp.GP(kernel=KERN_T, noise=0.03, solver="auto", device=CPU)
    gp.fit(x, y)
    xt = np.linspace(0.1, 0.9, 50)[:, None]
    pred = to_numpy(gp.predict(from_numpy(xt)))
    truth = np.sin(2 * np.pi * xt[:, 0]) + 0.3 * np.sin(9 * np.pi * xt[:, 0])
    assert np.sqrt(np.mean((pred - truth) ** 2)) < 0.05


def test_gp_variance_shrinks_near_data_and_matches_jax():
    x, y = _toy_data(n=300)
    xt = np.array([[0.5], [1.8]])
    gp = tgp.GP(noise=0.05, solver="dense", device=CPU).fit(x, y)
    m, v = gp.predict(from_numpy(xt), return_var=True)
    v = to_numpy(v)
    assert v[0] < v[1] and np.all(v >= 0)
    mj, vj = jgp.GP(noise=0.05, solver="dense").fit(x, y).predict(
        jnp.asarray(xt), return_var=True)
    assert _rel(m, mj) <= RTOL and _rel(v, vj) <= RTOL


def test_gp_hodlr_fit_predict_match_jax(jax_draws):
    x, y = _toy_data(n=256, noise=0.05, seed=3)
    xt = np.linspace(0.05, 0.95, 9)[:, None]
    kw = dict(noise=0.05, solver="hodlr", levels=2, rank=16)
    gp_j = jgp.GP(**kw).fit(x, y)
    gp_t = tgp.GP(**kw, device=CPU).fit(x, y)
    assert gp_t.solver_used_ == gp_j.solver_used_
    assert _rel(gp_t.alpha_, gp_j.alpha_) <= CG_RTOL
    m_j, v_j = gp_j.predict(jnp.asarray(xt), return_var=True)
    m_t, v_t = gp_t.predict(from_numpy(xt), return_var=True)
    assert _rel(m_t, m_j) <= CG_RTOL
    np.testing.assert_allclose(to_numpy(v_t), np.asarray(v_j), rtol=0,
                               atol=CG_RTOL)


def _patch_probes(monkeypatch, seed, probes, n):
    queue = [from_numpy(np.asarray(jax_rademacher(
        jax_key_from_seed(seed), (probes, n), jnp.float64)))]
    monkeypatch.setattr(tslq, "rademacher", lambda *a, **k: queue.pop(0))
    return queue


def test_gp_log_marginal_likelihood_prefers_true_noise(monkeypatch):
    x, y = _toy_data(n=256, noise=0.05, seed=2)
    lmls = []
    for s in (0.005, 0.05, 0.5):
        queue = _patch_probes(monkeypatch, 0, 8, 256)
        got = tgp.GP(kernel=KERN_T, noise=s, solver="dense",
                     device=CPU).fit(x, y).log_marginal_likelihood()
        assert not queue
        want = jgp.GP(kernel=KERN_J, noise=s, solver="dense").fit(
            x, y).log_marginal_likelihood()
        np.testing.assert_allclose(got, want, rtol=RTOL)
        lmls.append(got)
    assert lmls[1] > lmls[0] and lmls[1] > lmls[2]


def test_gp_implicit_fit_and_lml_match_jax(monkeypatch, jax_draws):
    x, y = _toy_data(n=256, noise=0.05, seed=4)
    kw = dict(noise=0.05, solver="hodlr", levels=2, rank=16,
              implicit_threshold=128)
    gp_j = jgp.GP(**kw).fit(x, y)
    gp_t = tgp.GP(**kw, device=CPU).fit(x, y)
    assert gp_t.solver_used_ == gp_j.solver_used_
    assert gp_t.solver_used_.endswith("implicit)")
    assert _rel(gp_t.alpha_, gp_j.alpha_) <= CG_RTOL
    queue = _patch_probes(monkeypatch, 1, 4, 256)
    got = gp_t.log_marginal_likelihood(num_probes=4, steps=12, seed=1)
    assert not queue
    want = gp_j.log_marginal_likelihood(num_probes=4, steps=12, seed=1)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_gp_auto_small_uses_dense():
    x, y = _toy_data(n=128)
    gp = tgp.GP(solver="auto", device=CPU).fit(x, y)
    assert gp.solver_used_ == "dense"
    assert not hasattr(gp, "_hodlr")


def test_gp_lambda_max_matches_jax(one_operator):
    hj, ht = one_operator
    np.testing.assert_allclose(tgp.GP._hodlr_lambda_max(ht, 256),
                               jgp.GP._hodlr_lambda_max(hj, 256),
                               rtol=RTOL)


def test_gp_exhausted_jitter_escalation_raises(monkeypatch):
    x, y = _toy_data(n=256)
    calls = []

    def nan_solve(h, b, **kw):
        calls.append(float(h.leaves[0, 0, 0]))
        return torch.full((256,), float("nan"), dtype=torch.float64)

    monkeypatch.setattr(tgp, "hodlr_solve", nan_solve)
    with pytest.raises(FloatingPointError, match="jitter escalation"):
        tgp.GP(noise=0.05, solver="hodlr", levels=2, rank=16,
               device=CPU).fit(x, y)
    # the un-jittered solve, then five escalations with growing leaves
    assert len(calls) == 6 and calls == sorted(calls)


def test_gp_jitter_retry_recovers(monkeypatch):
    """A first non-finite solve escalates once and stores the jittered
    operator, as JAX's fit does."""
    x, y = _toy_data(n=256)
    real = tgp.hodlr_solve
    calls = []

    def flaky(h, b, **kw):
        calls.append(1)
        out = real(h, b, **kw)
        return out * float("nan") if len(calls) == 1 else out

    monkeypatch.setattr(tgp, "hodlr_solve", flaky)
    gp = tgp.GP(noise=0.05, solver="hodlr", levels=2, rank=16,
                device=CPU).fit(x, y)
    assert len(calls) == 2 and "jitter=" in gp.solver_used_
    assert torch.isfinite(gp.alpha_).all()


def test_gp_implicit_fit_matches_dense_hodlr():
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0, 6, 1024))
    y = np.sin(2 * x) + 0.05 * rng.standard_normal(1024)
    xt = np.linspace(0.2, 5.8, 40)
    gp_d = tgp.GP(noise=0.05, device=CPU).fit(x, y)
    gp_i = tgp.GP(noise=0.05, implicit_threshold=256, device=CPU).fit(x, y)
    assert gp_i.solver_used_.endswith("implicit)")
    assert not gp_d.solver_used_.endswith("implicit)")
    m_d, v_d = gp_d.predict(xt, return_var=True)
    m_i, v_i = gp_i.predict(xt, return_var=True)
    np.testing.assert_allclose(to_numpy(m_i), to_numpy(m_d), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(to_numpy(v_i), to_numpy(v_d), rtol=1e-2,
                               atol=1e-3)
    lml_d = gp_d.log_marginal_likelihood(num_probes=16, steps=40)
    lml_i = gp_i.log_marginal_likelihood(num_probes=16, steps=40)
    assert abs(lml_i - lml_d) < 0.05 * abs(lml_d) + 5.0
