"""Gaussian-process regression with hierarchical kernel compression (the
JAX package's ``apps/gp.py``).

    mean  = K_*  (K + sigma^2 I)^{-1} y
    var   = k_** - diag(K_*  (K + sigma^2 I)^{-1} K_*^T)
    logML = -1/2 [ y^T alpha + logdet(K + sigma^2 I) + n log 2 pi ]

The train-kernel solve runs through ``hodlr_solve`` (CG on the
O(kn log n) hierarchical matvec with leaf-block preconditioning) instead
of an O(n^3) Cholesky, and the log-marginal-likelihood's log-det through
stochastic Lanczos quadrature.  The predictive variance solves its m
right-hand sides as one batched CG.  The dense path's Cholesky is
``core/device.py::cholesky`` (NaN where the factorization fails, as
XLA's).

1D/low-D note: HODLR off-diagonal blocks are numerically low-rank when
the inputs are ordered so that index distance tracks metric distance;
``GP.fit`` sorts 1D inputs.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    cholesky,
    matmul_at,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.hodlr import (
    hodlr_build,
    hodlr_build_implicit,
    hodlr_matvec,
    hodlr_solve,
)


def _hodlr_apply(v, h):
    """Module-level operator for the matrix-free ``logdet_psd``."""
    return hodlr_matvec(h, v)


def rbf_kernel(x1, x2, lengthscale: float = 0.2, variance: float = 1.0):
    """k(x, x') = variance * exp(-||x - x'||^2 / (2 l^2)); x1 (n, d),
    x2 (m, d) -> (n, m).  Squared norms + one GEMM rather than the
    (n, m, d) broadcast difference."""
    x1 = as_tensor(x1)
    x2 = as_tensor(x2, device=x1.device)
    s1 = torch.sum(x1 * x1, dim=1)
    s2 = torch.sum(x2 * x2, dim=1)
    d2 = torch.clamp(s1[:, None] + s2[None, :]
                     - 2.0 * matmul_at(x1, x2.T, "highest"), min=0.0)
    return variance * torch.exp(-0.5 * d2 / (lengthscale * lengthscale))


def _as_rows(x, dev):
    """``x`` as an (n, d) tensor on ``dev`` (jnp.atleast_2d, then a lone
    row of several values read as a column)."""
    x = as_tensor(x, device=dev)
    x = x.reshape(1, -1) if x.dim() < 2 else x
    return x.T if x.shape[0] == 1 and x.numel() > 1 else x


def _cho_solve(c, b):
    """(L L^T)^{-1} b for the lower factor L, b a vector or a block."""
    if b.dim() == 1:
        return torch.cholesky_solve(b[:, None], c)[:, 0]
    return torch.cholesky_solve(b, c)


class GP:
    """GP regression with an optional HODLR-compressed train kernel.

    solver='hodlr' (default above `dense_threshold` points) compresses
    K + sigma^2 I hierarchically and solves by preconditioned CG;
    solver='dense' is the exact Cholesky reference path.  Inputs that
    are not tensors go to ``device`` (the card unless the caller names
    another).
    """

    def __init__(self, kernel: Optional[Callable] = None,
                 noise: float = 1e-2, solver: str = "auto",
                 levels: int = 4, rank: int = 24,
                 dense_threshold: int = 512,
                 implicit_threshold: int = 8192, device=None):
        self.kernel = kernel or rbf_kernel
        self.noise = noise
        self.solver = solver
        self.levels = levels
        self.rank = rank
        self.dense_threshold = dense_threshold
        # above this, the n x n train kernel is NEVER materialized: the
        # HODLR factors build from kernel-slice callbacks and the
        # log-marginal-likelihood's log-det runs SLQ on the hierarchical
        # matvec
        self.implicit_threshold = implicit_threshold
        self.device = device

    @staticmethod
    def _hodlr_lambda_max(h, n: int, iters: int = 8) -> float:
        """Crude power-iteration lambda_max of the compressed operator --
        only sets the SCALE of the NaN-retry jitter."""
        dtype = h.leaves.dtype
        v = torch.ones((n,), dtype=dtype, device=h.leaves.device) / \
            math.sqrt(n)
        nrm = torch.ones((), dtype=dtype, device=h.leaves.device)
        for _ in range(iters):
            w = hodlr_matvec(h, v)
            nrm = torch.linalg.norm(w)
            v = w / torch.clamp(nrm, min=torch.finfo(dtype).tiny)
        return float(nrm)

    def _resolve_solver(self, n: int) -> str:
        if self.solver != "auto":
            return self.solver
        return "hodlr" if n > self.dense_threshold else "dense"

    def _train_kernel(self, x):
        n = x.shape[0]
        return self.kernel(x, x) + self.noise ** 2 * torch.eye(
            n, dtype=x.dtype, device=x.device)

    def _fit_hodlr(self, x, y, levels: int):
        n = x.shape[0]
        if n > self.implicit_threshold:
            # beyond-memory regime: K never materializes -- each HODLR
            # block is a kernel slice computed on demand
            kern, noise2 = self.kernel, self.noise ** 2

            def block_fn(i0, j0, rows, cols):
                blk = kern(x[i0:i0 + rows], x[j0:j0 + cols])
                if i0 == j0 and rows == cols:  # leaf: + sigma^2 I
                    blk = blk + noise2 * torch.eye(
                        rows, dtype=blk.dtype, device=blk.device)
                return blk

            h = hodlr_build_implicit(block_fn, n, levels=levels,
                                     k=self.rank)
            self._implicit = True
        else:
            h = hodlr_build(self._train_kernel(x), levels=levels,
                            k=self.rank)
        self.alpha_ = hodlr_solve(h, y)
        jitter = 0.0
        if not bool(torch.all(torch.isfinite(self.alpha_))):
            # The compressed K + sigma^2 I can be slightly INDEFINITE when
            # the compression floor exceeds sigma^2, which sends CG to
            # NaN.  Retry with escalating diagonal jitter on the LEAVES,
            # from 1/16 of the worst-case bound n * eps * lambda_max.
            lam_max = self._hodlr_lambda_max(h, n)
            base = torch.finfo(x.dtype).eps * n * lam_max
            for mult in (0.0625, 0.25, 1.0, 4.0, 16.0):
                jitter = mult * base
                eye = jitter * torch.eye(h.leaves.shape[1],
                                         dtype=h.leaves.dtype,
                                         device=h.leaves.device)
                h_j = h._replace(leaves=h.leaves + eye[None])
                self.alpha_ = hodlr_solve(h_j, y)
                if bool(torch.all(torch.isfinite(self.alpha_))):
                    h = h_j
                    break
            else:
                # the stored operator would be the UN-jittered h: surface
                # the NaN fit instead of returning silently
                raise FloatingPointError(
                    "GP fit: CG produced non-finite alpha even after "
                    f"jitter escalation to 16*{base:.2e}; the compressed "
                    "kernel is too indefinite -- raise rank, noise, or "
                    "use the dense path")
        self._hodlr = h
        self.solver_used_ = (
            f"hodlr(levels={levels}, k={self.rank}"
            + (", implicit" if self._implicit else "")
            + (f", jitter={jitter:.2e}" if jitter else "") + ")")

    def fit(self, x, y):
        x = _as_rows(x, self.device)
        y = as_tensor(y, device=x.device)
        if x.shape[1] == 1:
            order = torch.argsort(x[:, 0], stable=True)
            x, y = x[order], y[order]
        n = x.shape[0]
        self.x_train_ = x
        self.y_train_ = y
        # clear any previous fit's solver state: predict() dispatches on
        # which attribute exists
        for attr in ("_cho", "_hodlr"):
            if hasattr(self, attr):
                delattr(self, attr)
        self._implicit = False
        if self._resolve_solver(n) == "hodlr":
            levels = self.levels
            while n % (2 ** levels) or n // 2 ** levels < 2 * self.rank:
                levels -= 1
                if levels == 0:
                    break
            if levels >= 1:
                self._fit_hodlr(x, y, levels)
                return self
        # dense: the exact path (also for inputs too small to split)
        c = cholesky(self._train_kernel(x))
        self.alpha_ = _cho_solve(c, y)
        self._cho = c
        self.solver_used_ = "dense"
        return self

    def predict(self, x_test, return_var: bool = False):
        x_test = _as_rows(x_test, self.x_train_.device)
        if x_test.shape[1] != self.x_train_.shape[1]:
            x_test = x_test.T
        k_star = self.kernel(x_test, self.x_train_)      # m x n
        mean = matmul_at(k_star, self.alpha_[:, None], "highest")[:, 0]
        if not return_var:
            return mean
        if hasattr(self, "_cho"):
            w = _cho_solve(self._cho, k_star.T)
        else:
            w = hodlr_solve(self._hodlr, k_star.T)        # n x m, batched
        k_ss = torch.func.vmap(
            lambda xt: self.kernel(xt[None], xt[None])[0, 0])(x_test)
        var = torch.clamp(k_ss - torch.sum(k_star.T * w, dim=0),
                          min=0.0) + self.noise ** 2
        return mean, var

    def log_marginal_likelihood(self, num_probes: int = 8,
                                steps: int = 30, seed: int = 0) -> float:
        """-1/2 [y^T alpha + logdet(K + s^2 I) + n log 2pi]; log-det by
        SLQ -- on the dense train kernel, or matrix-free on the HODLR
        matvec for implicit fits."""
        from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.slq import (
            logdet_psd,
        )

        n = self.x_train_.shape[0]
        if self._implicit:
            ld = float(logdet_psd(_hodlr_apply, seed=seed,
                                  num_probes=num_probes, steps=steps,
                                  n=n, dtype=self.x_train_.dtype,
                                  operands=(self._hodlr,)))
        else:
            ld = float(logdet_psd(self._train_kernel(self.x_train_),
                                  seed=seed, num_probes=num_probes,
                                  steps=steps))
        fit = float(torch.dot(self.y_train_, self.alpha_))
        return -0.5 * (fit + ld + n * math.log(2 * math.pi))
