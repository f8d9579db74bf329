"""The port's advection-diffusion FOM (``apps/advdiff.py``) against the
JAX package's, on the CPU in f64 (tests/conftest.py turns x64 on).

Every function of the module is held to its JAX twin for the four
manufactured families (u0_choice 0-3) and theta in {1, 0.5}, at
``RTOL`` = 1e-10 relative (Frobenius) unless a test says otherwise:
the two packages build the same dense operators and solve with LAPACK
LU on the CPU, so they agree to rounding.  Pivots are never compared
(JAX returns 0-based, torch LAPACK's 1-based): solutions are.  The mesh
is small (N = 39, 41 nodes; 20 steps), one JAX compile per case."""

import functools
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jax.scipy.linalg as jsl

from rsvd_kamaneh_raganato_terrana_tpu.apps import advdiff as jadv
from rsvd_kamaneh_raganato_terrana_tpu.core.config import (
    AdvDiffConfig as JaxAdvDiffConfig,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import advdiff as tadv
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.config import AdvDiffConfig

from_numpy = functools.partial(convert.from_numpy, device="cpu")
RTOL = 1e-10
CHOICES = (0, 1, 2, 3)
THETAS = (1.0, 0.5)
BASE = dict(beta=0.2, u0_choice=0, amplitude=1.0, N=39, T=0.02,
            deltat=1e-3, theta=1.0, sample_every=3)
MU = 0.03


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(**kw):
    args = dict(BASE, **kw)
    return JaxAdvDiffConfig(**args), AdvDiffConfig(**args)


def _np(x):
    return convert.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("choice", CHOICES + (7,))
def test_manufactured_families_match_jax(choice):
    """u0, exact solution, exact gradient and forcing (choice 7: the
    fallback branch) on a grid, at t = 0.3, amplitude 2: to 1e-13."""
    x = np.linspace(0.0, 1.0, 33)
    xt = from_numpy(x)
    for jfn, tfn in ((lambda: jadv.initial_condition(jnp.asarray(x), choice, 2.0),
                      lambda: tadv.initial_condition(xt, choice, 2.0)),
                     (lambda: jadv.exact_solution(jnp.asarray(x), 0.3, choice, 2.0),
                      lambda: tadv.exact_solution(xt, 0.3, choice, 2.0)),
                     (lambda: jadv.exact_gradient(jnp.asarray(x), 0.3, choice, 2.0),
                      lambda: tadv.exact_gradient(xt, 0.3, choice, 2.0)),
                     (lambda: jadv.forcing(jnp.asarray(x), 0.3, MU, 0.2, choice, 2.0),
                      lambda: tadv.forcing(xt, 0.3, MU, 0.2, choice, 2.0))):
        want, got = _np(jfn()), _np(tfn())
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("theta", THETAS)
def test_build_operators_match_jax(theta):
    jcfg, tcfg = _cfgs(theta=theta)
    jops = jadv.build_operators(jcfg, MU)
    tops = tadv.build_operators(tcfg, MU, device="cpu")
    assert _rel(tops.lhs, jops.lhs) <= 1e-14
    assert _rel(tops.rhs_mat, jops.rhs_mat) <= 1e-14
    assert _rel(tops.nodes, jops.nodes) <= 1e-15
    assert tops.h == jops.h
    b = np.random.default_rng(0).standard_normal(tcfg.n_nodes)
    want = jsl.lu_solve(jops.lu, jnp.asarray(b))
    assert _rel(tadv.lu_solve(tops.lu, from_numpy(b)), want) <= RTOL


def test_build_operators_batched_equals_single():
    """B values of mu give a (B, n, n) stack whose slices are bitwise the
    single builds, factored in one call."""
    _, tcfg = _cfgs(theta=0.5)
    mus = [0.01, 0.03, 0.05]
    stack = tadv.build_operators(tcfg, from_numpy(np.asarray(mus)))
    assert stack.lhs.shape == (3, tcfg.n_nodes, tcfg.n_nodes)
    for i, mu in enumerate(mus):
        one = tadv.build_operators(tcfg, mu, device="cpu")
        assert torch.equal(stack.lhs[i], one.lhs)
        assert torch.equal(stack.rhs_mat[i], one.rhs_mat)
        assert torch.equal(stack.lu[0][i], one.lu[0])
    unfactored = tadv.build_operators(tcfg, MU, device="cpu", factor=False)
    assert unfactored.lu is None


def test_lu_factor_raises_on_a_singular_operator():
    """torch's LU returns a finite factor with info > 0 where XLA's gives
    inf/NaN; the port reads info on the host and raises."""
    a = torch.zeros((2, 4, 4), dtype=torch.float64)
    a[0] = torch.eye(4)
    with pytest.raises(RuntimeError, match="LU factorization failed"):
        tadv.lu_factor(a)


def test_mass_matrix_and_reaction_match_jax():
    np.testing.assert_allclose(_np(tadv.mass_matrix(9, device="cpu")),
                               _np(jadv.mass_matrix(9)), rtol=1e-15)
    u = np.linspace(-1.0, 1.5, 17)
    for kind in ("cubic", "expm1"):
        np.testing.assert_allclose(
            _np(tadv.reaction(from_numpy(u), kind, 0.7)),
            _np(jadv.reaction(jnp.asarray(u), kind, 0.7)), rtol=1e-14)
    with pytest.raises(ValueError, match="unknown reaction kind"):
        tadv.reaction(from_numpy(u), "quartic", 1.0)


@pytest.mark.parametrize("choice", CHOICES)
def test_load_vector_and_assemble_rhs_match_jax(choice):
    jcfg, tcfg = _cfgs(u0_choice=choice, theta=0.5)
    jops = jadv.build_operators(jcfg, MU)
    tops = tadv.build_operators(tcfg, MU, device="cpu")
    want = jadv.load_vector(0.007, MU, jcfg, jops.nodes)
    assert _rel(tadv.load_vector(0.007, MU, tcfg, tops.nodes), want) <= 1e-13
    # a batch of times and of mu broadcast like the JAX vmap of the call
    times = np.asarray([0.0, 0.004, 0.011])
    got = tadv.load_vector(from_numpy(times)[None, :],
                           from_numpy(np.asarray([0.01, 0.05]))[:, None],
                           tcfg, tops.nodes)
    assert got.shape == (2, 3, tcfg.n_nodes)
    for i, mu in enumerate((0.01, 0.05)):
        for j, t in enumerate(times):
            assert _rel(got[i, j], jadv.load_vector(t, mu, jcfg,
                                                    jops.nodes)) <= 1e-13
    u = np.random.default_rng(choice).standard_normal(tcfg.n_nodes)
    want = jadv.assemble_rhs(jnp.asarray(u), 0.006, 0.005, MU, jcfg, jops)
    got = tadv.assemble_rhs(from_numpy(u), 0.006, 0.005, MU, tcfg, tops)
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("theta", THETAS)
@pytest.mark.parametrize("choice", CHOICES)
def test_solve_fom_matches_jax(choice, theta):
    jcfg, tcfg = _cfgs(u0_choice=choice, theta=theta,
                       amplitude=2.0 if choice == 2 else 1.0)
    jres = jadv.solve_fom(jcfg, MU)
    tres = tadv.solve_fom(tcfg, MU, device="cpu")
    assert tres.snapshots.shape == (tcfg.n_nodes, tcfg.n_steps // 3)
    assert _rel(tres.solution, jres.solution) <= RTOL
    assert _rel(tres.snapshots, jres.snapshots) <= RTOL
    assert _rel(tres.times, jres.times) <= 1e-15
    assert tres.solution.dtype == torch.float64


def test_solve_fom_include_initial_and_sampling():
    """``include_initial`` prepends u0; snapshots are steps se, 2 se, ...
    of the trajectory (traj[se-1::se])."""
    jcfg, tcfg = _cfgs(sample_every=4)
    jres = jadv.solve_fom(jcfg, MU, include_initial=True)
    tres = tadv.solve_fom(tcfg, MU, include_initial=True, device="cpu")
    assert tres.snapshots.shape == (tcfg.n_nodes, 1 + tcfg.n_steps // 4)
    assert _rel(tres.snapshots, jres.snapshots) <= RTOL
    every = tadv.solve_fom(replace(tcfg, sample_every=1), MU, device="cpu")
    assert torch.equal(tres.snapshots[:, 1:], every.snapshots[:, 3::4])


@pytest.mark.parametrize("kind", ("cubic", "expm1"))
def test_solve_fom_reaction_matches_jax(kind):
    jcfg, tcfg = _cfgs(u0_choice=1, theta=0.5)
    jres = jadv.solve_fom_reaction(jcfg, MU, 2.0, kind=kind)
    tres = tadv.solve_fom_reaction(tcfg, MU, 2.0, kind=kind, device="cpu")
    assert _rel(tres.solution, jres.solution) <= RTOL
    assert _rel(tres.snapshots, jres.snapshots) <= RTOL


def test_solve_fom_sweep_and_snapshot_matrix_match_jax():
    """The batched sweep (one operator stack, one batched lu_solve a
    step) equals JAX's vmap, and each of its rows the single solve."""
    jcfg, tcfg = _cfgs(u0_choice=3, theta=0.5)
    mus = np.asarray([0.01, 0.03, 0.05])
    jres = jadv.solve_fom_sweep(jcfg, mus)
    tres = tadv.solve_fom_sweep(tcfg, mus, device="cpu")
    for field in ("solution", "snapshots", "times"):
        assert _rel(getattr(tres, field), getattr(jres, field)) <= RTOL
    one = tadv.solve_fom(tcfg, 0.03, device="cpu")
    assert _rel(tres.solution[1], one.solution) <= 1e-14
    s = tadv.snapshot_matrix(tcfg, mus, device="cpu")
    assert s.shape == (tcfg.n_nodes, 3 * (tcfg.n_steps // 3))
    assert _rel(s, jadv.snapshot_matrix(jcfg, mus)) <= RTOL


@pytest.mark.parametrize("choice", CHOICES)
def test_error_norms_match_jax(choice):
    jcfg, tcfg = _cfgs(u0_choice=choice, amplitude=2.0)
    u = np.sin(np.linspace(0.0, 3.0, tcfg.n_nodes))
    jl2, jh1 = jadv.error_norms(jnp.asarray(u), 0.02, jcfg)
    tl2, th1 = tadv.error_norms(from_numpy(u), 0.02, tcfg)
    np.testing.assert_allclose([float(tl2), float(th1)],
                               [float(jl2), float(jh1)], rtol=1e-13)


def test_default_fem_dtype_is_f64_on_every_device():
    assert tadv.default_fem_dtype() == torch.float64


# --- the bars of tests/test_advdiff.py:23-143 -------------------------------
# Each case holds the port to the JAX case's own bar at its sizes, and
# every FOM solve it makes to the JAX package's solve of the same
# configuration at RTOL (the FOM is deterministic in its input).

JAX_CFG = dict(beta=0.2, u0_choice=0, amplitude=1.0, N=119, T=0.05,
               deltat=1e-3, theta=1.0, sample_every=1)


def _fom(mu, **kw):
    """The port's ``solve_fom`` of JAX_CFG updated by ``kw``, held to the
    JAX package's solve at RTOL (solution and snapshots); returns (the
    port's result, its config)."""
    jcfg, tcfg = (cls(**dict(JAX_CFG, **kw))
                  for cls in (JaxAdvDiffConfig, AdvDiffConfig))
    jres = jadv.solve_fom(jcfg, mu)
    tres = tadv.solve_fom(tcfg, mu, device="cpu")
    assert _rel(tres.solution, jres.solution) <= RTOL
    assert _rel(tres.snapshots, jres.snapshots) <= RTOL
    return tres, tcfg


def test_fom_matches_exact_solution():
    res, cfg = _fom(0.01)
    l2, h1 = tadv.error_norms(res.solution, cfg.T, cfg)
    # implicit Euler, dt=1e-3, fine mesh: small error
    assert float(l2) < 5e-4
    assert float(h1) < 5e-2


def test_snapshot_protocol():
    res, cfg = _fom(0.01, sample_every=5)
    assert res.snapshots.shape == (cfg.n_nodes, cfg.n_steps // 5)
    full, _ = _fom(0.01)
    # sampled columns = steps 5, 10, ... of the full run
    np.testing.assert_allclose(_np(res.snapshots[:, 0]),
                               _np(full.snapshots[:, 4]), rtol=1e-12)


def test_boundary_conditions():
    res, _ = _fom(0.03)
    snaps = _np(res.snapshots)
    assert np.abs(snaps[0]).max() < 1e-14
    assert np.abs(snaps[-1]).max() < 1e-14


def test_temporal_convergence_first_order():
    """Implicit Euler (theta=1) shows order ~1 in dt against the exact
    solution on a fine mesh (tests/test_advdiff.py:53-67)."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.rom import (
        convergence_order,
    )

    dts = [5e-3, 2.5e-3, 1.25e-3]
    errs = []
    for dt in dts:
        res, cfg = _fom(0.05, N=499, T=0.05, deltat=dt)
        l2, _ = tadv.error_norms(res.solution, cfg.n_steps * dt, cfg)
        errs.append(float(l2))
    orders = convergence_order(errs, dts)
    assert all(0.7 < o < 1.4 for o in orders), (errs, orders)


def _same_mesh_orders(theta):
    """Temporal orders against the same mesh's fine-dt solve (Richardson
    style, tests/test_advdiff.py:70-102)."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.rom import (
        convergence_order,
    )

    dts = [5e-3, 2.5e-3, 1.25e-3]
    ref = _np(_fom(0.05, theta=theta, deltat=1.5625e-4)[0].solution)
    errs = [float(np.linalg.norm(
        _np(_fom(0.05, theta=theta, deltat=dt)[0].solution) - ref))
        for dt in dts]
    return errs, convergence_order(errs, dts)


def test_crank_nicolson_second_order():
    errs, orders = _same_mesh_orders(0.5)
    assert all(1.7 < o < 2.3 for o in orders), (errs, orders)


def test_implicit_euler_first_order_temporal():
    errs, orders = _same_mesh_orders(1.0)
    assert all(0.8 < o < 1.2 for o in orders), (errs, orders)


def test_u0_choice1_exact():
    """Family 1 (two-mode sine), the other consistent manufactured
    solution: the FEM tracks it."""
    res, cfg = _fom(0.02, u0_choice=1, amplitude=3.0, N=199, deltat=5e-4)
    l2, _ = tadv.error_norms(res.solution, cfg.T, cfg)
    assert float(l2) < 2e-2


@pytest.mark.parametrize("choice", [2, 3])
def test_inconsistent_families_stable(choice):
    """Families 2 and 3 carry the reference's inconsistencies (no exact
    solution to compare with): the solve stays stable and keeps the
    imposed boundary values."""
    res, _ = _fom(0.02, u0_choice=choice, N=199, deltat=5e-4)
    sol = _np(res.solution)
    assert np.isfinite(sol).all()
    assert abs(sol[0]) < 1e-14 and abs(sol[-1]) < 1e-14
    assert np.abs(sol).max() < 10.0


def test_snapshot_matrix_layout():
    jcfg, cfg = (cls(**dict(JAX_CFG, sample_every=10))
                 for cls in (JaxAdvDiffConfig, AdvDiffConfig))
    mus = np.linspace(0.01, 0.05, 3)
    s = tadv.snapshot_matrix(cfg, mus, device="cpu")
    n_saved = cfg.n_steps // 10
    assert s.shape == (cfg.n_nodes, 3 * n_saved)
    assert _rel(s, jadv.snapshot_matrix(jcfg, mus)) <= RTOL
    single, _ = _fom(mus[1], sample_every=10)
    np.testing.assert_allclose(_np(s[:, n_saved:2 * n_saved]),
                               _np(single.snapshots), rtol=1e-12)
