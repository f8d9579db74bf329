"""1D advection-diffusion full-order FEM solver (the JAX package's
``apps/advdiff.py``).

The PDE ``u_t - mu u_xx + beta u_x = f`` on (0,1), homogeneous Dirichlet
BCs, P1 elements on a uniform grid, theta-method in time, with the
reference's manufactured forcing/exact-solution families (u0_choice 0-3,
AdvDiff1D.hpp:126-252) and its snapshot protocol (every
``sample_every``-th step, AdvDiff1D.cpp:288-324).

- Assembly is closed-form: the mass/stiffness/advection matrices are the
  tridiagonal stencils h/6 [1 4 1], mu/h [-1 2 -1], beta [-1/2 0 1/2],
  held dense as in the JAX package.
- The constant theta-method operator is LU-factored once
  (``torch.linalg.lu_factor_ex``, its ``info`` read on the host once per
  build); each step is one ``rhs_mat @ u``, one ``lu_solve``.
- A diffusion coefficient ``mu`` may be a number or a 1-D tensor of B
  values: the operators are then one (B, n, n) stack, factored in one
  call, and each step is one batched matvec and one batched
  ``lu_solve`` (the JAX package vmaps ``solve_fom`` over mu).  Every
  step's theta-weighted load vector is evaluated in one pass before the
  loop, which is a Python loop over the steps.

Everything is computed in ``dtype`` (f64 by default, on any device: the
H100 has native FP64, and f64 is what the JAX package computes off a
TPU) on ``device`` (the card when None; a tensor ``mu`` keeps its own
device unless ``device`` names another).

Forcing quirk preserved: for u0_choice 0 the reference forcing omits the
``amplitude`` factor (AdvDiff1D.hpp:126-133) even though the IC and exact
solution carry it, so the manufactured solution is only consistent for
amplitude=1.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.config import AdvDiffConfig
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import matmul

_INV_SQRT3 = 1.0 / math.sqrt(3.0)
_PI = math.pi


# ---------------------------------------------------------------------------
# Manufactured solution families (reference AdvDiff1D.hpp:58-252).
# ---------------------------------------------------------------------------


def initial_condition(x, choice: int, amplitude: float):
    """FunctionU0 (AdvDiff1D.hpp:170-196)."""
    if choice == 0:
        return amplitude * torch.sin(_PI * x)
    if choice == 1:
        return 2.0 * torch.sin(9.0 * _PI * x) - torch.sin(4.0 * _PI * x)
    if choice == 2:
        return torch.sin(amplitude * _PI * x)
    if choice == 3:
        return torch.exp(x) - 1.0
    return amplitude * torch.sin(_PI * x)


def exact_solution(x, t, choice: int, amplitude: float):
    """ExactSolution::value (AdvDiff1D.hpp:202-226)."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    if choice == 0:
        return amplitude * torch.sin(_PI * x) * torch.exp(-t)
    if choice == 1:
        return ((2.0 * torch.sin(9.0 * _PI * x) - torch.sin(4.0 * _PI * x))
                * torch.exp(-t))
    if choice == 2:
        return torch.sin(5.0 * _PI * t) * torch.sin(amplitude * _PI * x)
    if choice == 3:
        return (torch.exp(x) - 1.0) * torch.exp(-t)
    return torch.zeros_like(x)


def exact_gradient(x, t, choice: int, amplitude: float):
    """ExactSolution::gradient (AdvDiff1D.hpp:228-248).  The reference
    has a sign/func slip for choice 1 (it writes -4 pi sin for the
    derivative's -4 pi cos); this is the true derivative, as in the JAX
    package, since it only feeds the H1 error."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    if choice == 0:
        return amplitude * _PI * torch.cos(_PI * x) * torch.exp(-t)
    if choice == 1:
        return (18.0 * _PI * torch.cos(9.0 * _PI * x)
                - 4.0 * _PI * torch.cos(4.0 * _PI * x)) * torch.exp(-t)
    if choice == 2:
        return (amplitude * _PI * torch.sin(5.0 * _PI * t)
                * torch.cos(amplitude * _PI * x))
    if choice == 3:
        return torch.exp(x) * torch.exp(-t)
    return torch.zeros_like(x)


def forcing(x, t, mu, beta: float, choice: int, amplitude: float):
    """ForcingTerm::value (AdvDiff1D.hpp:126-160), formulas reproduced
    verbatim, including the amplitude quirk for choice 0.  ``x``, ``t``
    and ``mu`` broadcast against each other."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    mu = torch.as_tensor(mu, dtype=x.dtype, device=x.device)
    if choice == 0:
        return ((mu * _PI * _PI - 1.0) * torch.sin(_PI * x) * torch.exp(-t)
                + beta * _PI * torch.cos(_PI * x) * torch.exp(-t))
    if choice == 1:
        return torch.exp(-t) * (
            -2.0 * torch.sin(9.0 * _PI * x) + torch.sin(4.0 * _PI * x)
            + mu * (162.0 * _PI * _PI * torch.sin(9.0 * _PI * x)
                    - 16.0 * _PI * _PI * torch.sin(4.0 * _PI * x))
            + beta * (18.0 * _PI * torch.cos(9.0 * _PI * x)
                      - 4.0 * _PI * torch.cos(4.0 * _PI * x))
        )
    if choice == 2:
        return (5.0 * _PI * torch.cos(5.0 * _PI * t)
                * torch.sin(amplitude * _PI * x)
                + mu * amplitude * amplitude * _PI * _PI
                * torch.sin(5.0 * _PI * t) * torch.sin(amplitude * _PI * x)
                + beta * amplitude * _PI
                * torch.sin(5.0 * _PI * t) * torch.cos(amplitude * _PI * x))
    if choice == 3:
        return torch.exp(-t) * (1.0 + torch.exp(x) * (beta - mu - 1.0))
    return torch.zeros(torch.broadcast_shapes(x.shape, t.shape, mu.shape),
                       dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Assembly (closed-form P1 stencils on a uniform grid).
# ---------------------------------------------------------------------------


class Operators(NamedTuple):
    """Dense theta-method operators with Dirichlet rows applied.

    lhs = M/dt + theta L,  rhs_mat = M/dt - (1-theta) L,  L = mu K + beta B
    (reference assemble_matrices, AdvDiff1D.cpp:96-186).  For B values of
    mu, ``lhs`` and ``rhs_mat`` are (B, n, n) stacks.  ``lu`` is the
    (LU, pivots) pair of ``torch.linalg.lu_factor`` (LAPACK's 1-based
    pivots), or None when the build was asked not to factor."""

    lhs: torch.Tensor       # (..., n, n)
    rhs_mat: torch.Tensor   # (..., n, n)
    lu: Tuple               # LU factorization of lhs
    nodes: torch.Tensor     # (n,)
    h: float


def _tridiag(n, lo, mid, hi, dtype, device):
    return (torch.diag(torch.full((n - 1,), lo, dtype=dtype, device=device), -1)
            + torch.diag(torch.full((n,), mid, dtype=dtype, device=device), 0)
            + torch.diag(torch.full((n - 1,), hi, dtype=dtype, device=device), 1))


def lu_factor(a):
    """``torch.linalg.lu_factor_ex`` of a matrix or a stack, its ``info``
    read on the host: a singular factor raises instead of returning
    finite garbage."""
    lu, piv, info = torch.linalg.lu_factor_ex(a)
    if bool((info != 0).any()):
        raise RuntimeError(f"LU factorization failed (info {info.tolist()})")
    return lu, piv


def lu_solve(lu, b):
    """Solve with the (LU, pivots) pair of :func:`lu_factor` for one
    right-hand side a matrix (``b`` of shape (..., n))."""
    return torch.linalg.lu_solve(lu[0], lu[1], b[..., None])[..., 0]


def bmv(a, x):
    """``a @ x`` for a matrix or stack ``a`` (..., n, k) and vectors ``x``
    (..., k), at full precision."""
    return matmul(a, x[..., None])[..., 0]


def build_operators(cfg: AdvDiffConfig, mu, dtype=torch.float64,
                    device=None, factor: bool = True) -> Operators:
    """The theta-method operators for ``mu`` (a number, or B values for a
    (B, n, n) stack), LU-factored unless ``factor`` is False (the ROM
    solvers project ``lhs`` and never factor it)."""
    mu = as_tensor(mu, device, dtype)
    device = mu.device
    n = cfg.n_nodes
    h = 1.0 / (n - 1)
    nodes = torch.linspace(0.0, 1.0, n, dtype=dtype, device=device)
    mass = _tridiag(n, h / 6.0, 4.0 * h / 6.0, h / 6.0, dtype, device)
    # Interior mass rows are exact; boundary rows are overwritten below.
    stiff = _tridiag(n, -1.0 / h, 2.0 / h, -1.0 / h, dtype, device)
    adv = _tridiag(n, -0.5, 0.0, 0.5, dtype, device)
    mass_dt = mass / cfg.deltat
    del mass
    # L = mu K + beta B; each stack is built in place, in the JAX
    # expressions' order of rounding
    lmat = mu[..., None, None] * stiff
    lmat += cfg.beta * adv
    del stiff, adv
    lhs = cfg.theta * lmat
    lhs += mass_dt
    rhs_mat = lmat.mul_(-(1.0 - cfg.theta)).add_(mass_dt)
    del lmat
    # Homogeneous Dirichlet: identity rows at both ends, zero rhs rows.
    for row in (0, -1):
        lhs[..., row, :] = 0.0
        lhs[..., row, row] = 1.0
        rhs_mat[..., row, :] = 0.0
    lu = lu_factor(lhs) if factor else None
    return Operators(lhs, rhs_mat, lu, nodes, h)


def mass_matrix(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """Consistent P1 mass matrix h/6 [1 4 1] on the uniform grid (the
    reference assembles it cell by cell, AdvDiff1D.cpp:96-186)."""
    h = 1.0 / (n - 1)
    return _tridiag(n, h / 6.0, 4.0 * h / 6.0, h / 6.0, dtype,
                    torch.device(device or "cuda"))


def reaction(u, kind: str, c):
    """Pointwise (nodal) reaction nonlinearity g(u) for the
    advection-diffusion-reaction demo (beyond the reference's linear
    PDE): 'cubic' -> c u^3 (Allen-Cahn-type), 'expm1' -> c (e^u - 1)
    (Frank-Kamenetskii-type).  Memoryless and nodewise: the structure
    DEIM point-samples."""
    if kind == "cubic":
        return c * u * u * u
    if kind == "expm1":
        return c * torch.expm1(u)
    raise ValueError(f"unknown reaction kind: {kind!r}")


def load_vector(t, mu, cfg: AdvDiffConfig, nodes, dtype=torch.float64):
    """F_i(t) = int f(x,t) phi_i dx by 2-point Gauss per cell (matching
    deal.II QGauss(degree+1), AdvDiff1D.cpp:189-267).  ``t`` and ``mu``
    broadcast against each other; the result has their shape + (n,)."""
    n = nodes.shape[0]
    h = 1.0 / (n - 1)
    t = torch.as_tensor(t, dtype=dtype, device=nodes.device)[..., None]
    mu = torch.as_tensor(mu, dtype=dtype, device=nodes.device)[..., None]
    x_l = nodes[:-1]
    # Gauss points xi in (0,1) reference cell
    xi = torch.tensor([0.5 - 0.5 * _INV_SQRT3, 0.5 + 0.5 * _INV_SQRT3],
                      dtype=dtype, device=nodes.device)
    w = 0.5 * h
    f_vals = [forcing(x_l + xi[g] * h, t, mu, cfg.beta, cfg.u0_choice,
                      cfg.amplitude) for g in range(2)]
    shape = torch.broadcast_shapes(t.shape, mu.shape)[:-1] + (n,)
    fv = torch.zeros(shape, dtype=dtype, device=nodes.device)
    for g, fg in enumerate(f_vals):
        fv[..., :-1] += w * (1.0 - xi[g]) * fg
        fv[..., 1:] += w * xi[g] * fg
    return fv


def zero_ends(x):
    """x with its first and last entry (along the last axis) set to 0."""
    x[..., 0] = 0.0
    x[..., -1] = 0.0
    return x


def assemble_rhs(u_old, t_new, t_old, mu, cfg: AdvDiffConfig, ops: Operators):
    """theta-weighted forcing + rhs_mat u_old + Dirichlet rows
    (reference assemble_rhs, AdvDiff1D.cpp:189-267)."""
    f_new = load_vector(t_new, mu, cfg, ops.nodes, u_old.dtype)
    f_old = load_vector(t_old, mu, cfg, ops.nodes, u_old.dtype)
    rhs = (bmv(ops.rhs_mat, u_old)
           + cfg.theta * f_new + (1.0 - cfg.theta) * f_old)
    return zero_ends(rhs)


class FOMResult(NamedTuple):
    solution: torch.Tensor     # (..., n_nodes) final-time solution
    snapshots: torch.Tensor    # (..., n_nodes, n_saved) sampled columns
    times: torch.Tensor        # (..., n_steps + 1)


def default_fem_dtype():
    """f64 on every device (the H100 computes FP64 natively)."""
    return torch.float64


def theta_loads(cfg: AdvDiffConfig, mu, nodes, dtype):
    """(times, every step's theta-weighted load vector with zero ends):
    (n_steps + 1,) and (..., n_steps, n) for mu of shape (...).  The
    forcing is known a priori, so it is evaluated in one pass before the
    time loop (the reference re-assembled it by quadrature inside every
    step, AdvDiff1D.cpp:189-267)."""
    times = (torch.arange(cfg.n_steps + 1, dtype=dtype, device=nodes.device)
             * cfg.deltat)
    f_all = load_vector(times, mu[..., None], cfg, nodes, dtype)
    f_theta = cfg.theta * f_all[..., 1:, :] + (1.0 - cfg.theta) * f_all[..., :-1, :]
    return times, zero_ends(f_theta)


def initial_state(cfg: AdvDiffConfig, nodes, dtype):
    """u0 at the nodes, with zero Dirichlet ends."""
    u0 = initial_condition(nodes, cfg.u0_choice, cfg.amplitude).to(dtype)
    return zero_ends(u0)


def _time_loop(cfg: AdvDiffConfig, u0, f_theta, step, include_initial):
    """Run ``u <- step(u, f_t)`` over the steps; (final u, snapshots of
    every ``sample_every``-th step counted from step 1, the columns of an
    (..., n, n_saved) tensor).  Keeps the sampled states only."""
    u = u0
    saved = [u0.expand_as(f_theta[..., 0, :])] if include_initial else []
    for i in range(cfg.n_steps):
        u = step(u, f_theta[..., i, :])
        if (i + 1) % cfg.sample_every == 0:
            saved.append(u)
    if saved:
        snaps = torch.stack(saved, dim=-1)
    else:
        snaps = u0.new_zeros(f_theta.shape[:-2] + (u0.shape[-1], 0))
    return u, snaps


def solve_fom(cfg: AdvDiffConfig, mu, dtype=None,
              include_initial: bool = False, device=None) -> FOMResult:
    """Run the theta-method time loop, collecting every ``sample_every``-th
    solution as a snapshot column (reference solve + snapshot assembly,
    AdvDiff1D.cpp:343-409: snapshots are recorded at steps where
    ``time_step % sample_every == 0`` counting from step 1).

    ``mu`` may hold B values: one (B, n, n) operator stack, one
    ``lu_factor`` of it, and per step one batched matvec and one batched
    ``lu_solve``; the result's fields then lead with B."""
    if dtype is None:
        dtype = default_fem_dtype()
    mu = as_tensor(mu, device, dtype)
    ops = build_operators(cfg, mu, dtype)
    u0 = initial_state(cfg, ops.nodes, dtype)
    times, f_theta = theta_loads(cfg, mu, ops.nodes, dtype)

    u_final, snaps = _time_loop(cfg, u0.expand(mu.shape + u0.shape), f_theta,
                                functools.partial(fom_step, ops),
                                include_initial)
    return FOMResult(u_final, snaps, times.expand(mu.shape + times.shape))


def fom_step(ops: Operators, u, f_t):
    """One theta-method step: the solve of lhs u' = rhs_mat u + f_t with
    zero Dirichlet rows, for one state or a batch.  The ends of u' are
    set to their exact 0: the pivoted solve leaves roundoff there that
    differs between one state and a batch."""
    return zero_ends(lu_solve(ops.lu, zero_ends(bmv(ops.rhs_mat, u) + f_t)))


def solve_fom_reaction(cfg: AdvDiffConfig, mu, c_react, kind: str = "cubic",
                       dtype=None, include_initial: bool = False,
                       device=None) -> FOMResult:
    """Full-order solve of u_t - mu u_xx + beta u_x + g(u) = f with the
    reaction treated semi-implicitly (group-FEM/product approximation:
    the nonlinear load is M g(u_n) with g applied nodewise, lagged one
    step; the linear part stays theta-implicit, so the constant LU still
    amortizes).  Beyond the reference, whose FOM is linear only: the
    testbed for DEIM model reduction."""
    if dtype is None:
        dtype = default_fem_dtype()
    mu = as_tensor(mu, device, dtype)
    c_react = torch.as_tensor(c_react, dtype=dtype, device=mu.device)
    ops = build_operators(cfg, mu, dtype)
    mass_d = zero_rows(mass_matrix(cfg.n_nodes, dtype, mu.device))
    u0 = initial_state(cfg, ops.nodes, dtype)
    times, f_theta = theta_loads(cfg, mu, ops.nodes, dtype)

    def step(u, f_t):
        g = reaction(u, kind, c_react)
        rhs = bmv(ops.rhs_mat, u) + f_t - bmv(mass_d, g)
        return zero_ends(lu_solve(ops.lu, zero_ends(rhs)))

    u_final, snaps = _time_loop(cfg, u0.expand(mu.shape + u0.shape), f_theta,
                                step, include_initial)
    return FOMResult(u_final, snaps, times.expand(mu.shape + times.shape))


def zero_rows(a):
    """``a`` with its first and last row set to 0 (Dirichlet rows)."""
    a[..., 0, :] = 0.0
    a[..., -1, :] = 0.0
    return a


def solve_fom_sweep(cfg: AdvDiffConfig, mus, dtype=None,
                    device=None) -> FOMResult:
    """The parameter sweep (reference Diff1D_openmp parallel snapshot
    loop): :func:`solve_fom` over the 1-D ``mus``, batched.  Snapshot
    matrices can be concatenated column-wise into the global S
    (Diff1D.cpp:122-156)."""
    if dtype is None:
        dtype = default_fem_dtype()
    mus = as_tensor(mus, device, dtype).reshape(-1)
    return solve_fom(cfg, mus, dtype)


def snapshot_matrix(cfg: AdvDiffConfig, mus, dtype=None,
                    device=None) -> torch.Tensor:
    """Global snapshot matrix: Nh x (n_params * n_saved) with parameter
    blocks in sweep order (reference Diff1D.cpp:122-156)."""
    res = solve_fom_sweep(cfg, mus, dtype, device)
    b, n, k = res.snapshots.shape
    return torch.movedim(res.snapshots, 0, 1).reshape(n, b * k)


# ---------------------------------------------------------------------------
# Error norms (reference compute_error, AdvDiff1D.cpp:412-435).
# ---------------------------------------------------------------------------


def _interp_at_gauss(u, xi):
    return (1.0 - xi) * u[:-1] + xi * u[1:]


def error_norms(u, t, cfg: AdvDiffConfig, nodes=None):
    """(L2, H1-seminorm-included) errors of the P1 interpolant vs the exact
    solution at time t, by 2-point Gauss quadrature; 0-d tensors."""
    dtype = u.dtype
    n = u.shape[0]
    h = 1.0 / (n - 1)
    if nodes is None:
        nodes = torch.linspace(0.0, 1.0, n, dtype=dtype, device=u.device)
    xi = torch.tensor([0.5 - 0.5 * _INV_SQRT3, 0.5 + 0.5 * _INV_SQRT3],
                      dtype=dtype, device=u.device)
    w = 0.5 * h
    l2_sq = u.new_zeros(())
    h1_sq = u.new_zeros(())
    du = (u[1:] - u[:-1]) / h
    for g in range(2):
        xg = nodes[:-1] + xi[g] * h
        diff = _interp_at_gauss(u, xi[g]) - exact_solution(
            xg, t, cfg.u0_choice, cfg.amplitude
        )
        l2_sq = l2_sq + w * torch.sum(diff * diff)
        gdiff = du - exact_gradient(xg, t, cfg.u0_choice, cfg.amplitude)
        h1_sq = h1_sq + w * torch.sum(gdiff * gdiff)
    l2 = torch.sqrt(l2_sq)
    h1 = torch.sqrt(l2_sq + h1_sq)
    return l2, h1
