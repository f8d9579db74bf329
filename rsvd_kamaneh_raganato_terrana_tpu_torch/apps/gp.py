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

Training points may be a DTensor whose rows are sharded (y row-sharded
alike, or whole).  ``fit`` gathers the points once (n x d: each row of K
needs every point, as kernel PCA's fit does) and, for 1-D inputs, sorts
them (and y, n values) and keeps each rank's rows of the sorted order;
each rank builds only its rows of the train kernel.  The HODLR route
goes through the sharded ``hodlr_build`` (the implicit route through its
block callbacks, each rank asking for blocks in its own rows), the dense
route through the block Cholesky of ``rsvd/_sharded.py`` and its
substitutions.  ``x_train_``, ``y_train_`` and ``alpha_`` come back
row-sharded; ``predict`` takes whole test points, all-reduces K_* alpha
and solves the variance's right-hand sides by rows; the
log-marginal-likelihood's SLQ gathers its n x m Lanczos block a step, as
``slq_trace`` of a row-sharded matrix does.
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
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    Sharded,
    row_dtensor,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _cholesky,
    _local,
    _norm,
    _reduce,
    _row_split,
    _sharded_view,
    _solve_lower,
    _solve_upper_t,
    _whole,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.hodlr import (
    _build_split,
    _matvec_local,
    _solve_rows,
    _split_of,
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
    """(L L^T)^{-1} b for the lower factor L, b a vector or a block; for
    a row-split L (``rsvd/_sharded.py::_cholesky``) b and the result are
    this rank's rows."""
    if isinstance(c, Sharded):
        x = _solve_upper_t(c, _solve_lower(c, b[:, None] if b.dim() == 1
                                           else b))
        return x[:, 0] if b.dim() == 1 else x
    if b.dim() == 1:
        return torch.cholesky_solve(b[:, None], c)[:, 0]
    return torch.cholesky_solve(b, c)


def _eye_rows(x):
    """This rank's rows of the n x n identity, for row-split ``x``."""
    rows = x.local.shape[0]
    eye = x.local.new_zeros((rows, x.shape[0]))
    idx = torch.arange(rows, device=eye.device)
    eye[idx, idx + x.row_start] = 1.0
    return eye


def _all_finite(t, x) -> bool:
    """Whether every entry of ``t`` (this rank's rows, for row-split
    ``x``) is finite, on every rank."""
    ok = torch.isfinite(_local(_sharded_view(t))).all().to(torch.int32)
    return bool(_reduce(ok, x, "min"))


def _plus_leaves(leaves, eye):
    """HODLR leaves + ``eye`` on each diagonal block (a DTensor's local
    leaves, kept sharded alike)."""
    view = _sharded_view(leaves)
    if isinstance(view, Sharded):
        return row_dtensor(view.local + eye[None], view.mesh, view.rows,
                           view.shape[0])
    return leaves + eye[None]


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
        split = _split_of(h)
        if split is None:
            dtype = h.leaves.dtype
            v = torch.ones((n,), dtype=dtype, device=h.leaves.device) / \
                math.sqrt(n)
            nrm = torch.ones((), dtype=dtype, device=h.leaves.device)
            for _ in range(iters):
                w = hodlr_matvec(h, v)
                nrm = torch.linalg.norm(w)
                v = w / torch.clamp(nrm, min=torch.finfo(dtype).tiny)
            return float(nrm)
        v = split.local.new_ones((split.local.shape[0], 1)) / math.sqrt(n)
        nrm = v.new_ones(())
        for _ in range(iters):
            w = _matvec_local(h, v, split)
            nrm = _norm(split.with_local(w))
            v = w / torch.clamp(nrm, min=torch.finfo(v.dtype).tiny)
        return float(nrm)

    def _resolve_solver(self, n: int) -> str:
        if self.solver != "auto":
            return self.solver
        return "hodlr" if n > self.dense_threshold else "dense"

    def _train_kernel(self, x):
        """K + sigma^2 I; of row-split points, this rank's rows of it (a
        :class:`Sharded`) against the points ``fit`` gathered."""
        if isinstance(x, Sharded):
            return x.with_local(self.kernel(x.local, self._x_all)
                                + self.noise ** 2 * _eye_rows(x))
        n = x.shape[0]
        return self.kernel(x, x) + self.noise ** 2 * torch.eye(
            n, dtype=x.dtype, device=x.device)

    def _fit_hodlr(self, x, y, levels: int):
        n = x.shape[0]
        if isinstance(x, Sharded) and n > self.implicit_threshold:
            kern, noise2, pts = self.kernel, self.noise ** 2, self._x_all

            def own_block(i0, j0, rows, cols):
                blk = kern(pts[i0:i0 + rows], pts[j0:j0 + cols])
                if i0 == j0 and rows == cols:  # leaf: + sigma^2 I
                    blk = blk + noise2 * torch.eye(
                        rows, dtype=blk.dtype, device=blk.device)
                return blk

            h = _build_split(own_block, x, n, levels, self.rank, 10, 1, 0)
            self._implicit = True
        elif n > self.implicit_threshold:
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
        if not _all_finite(self.alpha_, x):
            # The compressed K + sigma^2 I can be slightly INDEFINITE when
            # the compression floor exceeds sigma^2, which sends CG to
            # NaN.  Retry with escalating diagonal jitter on the LEAVES,
            # from 1/16 of the worst-case bound n * eps * lambda_max.
            lam_max = self._hodlr_lambda_max(h, n)
            base = torch.finfo(x.dtype).eps * n * lam_max
            for mult in (0.0625, 0.25, 1.0, 4.0, 16.0):
                jitter = mult * base
                leaf = _local(_sharded_view(h.leaves))
                eye = jitter * torch.eye(leaf.shape[1], dtype=leaf.dtype,
                                         device=leaf.device)
                h_j = h._replace(leaves=_plus_leaves(h.leaves, eye))
                self.alpha_ = hodlr_solve(h_j, y)
                if _all_finite(self.alpha_, x):
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
        x = _row_split(x, self.device)
        if isinstance(x, Sharded):
            x, y = self._split_points(x, y)
            self.x_train_ = x.to_dtensor()
        else:
            x = _as_rows(x, self.device)
            y = as_tensor(y, device=x.device)
            if x.shape[1] == 1:
                order = torch.argsort(x[:, 0], stable=True)
                x, y = x[order], y[order]
            self.x_train_ = x
        n = x.shape[0]
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
        k = self._train_kernel(x)
        c = _cholesky(k) if isinstance(k, Sharded) else cholesky(k)
        alpha = _cho_solve(c, _local(_sharded_view(y)))
        self.alpha_ = (row_dtensor(alpha, x.mesh, x.rows, n)
                       if isinstance(x, Sharded) else alpha)
        self._cho = c
        self.solver_used_ = "dense"
        return self

    def _split_points(self, x, y):
        """Row-split training points and targets: the points gathered
        once (kept for the kernel's columns) and, for 1-D inputs, sorted
        with y, each rank keeping its rows of the sorted order.  Returns
        (the points' row split, y row-sharded alike)."""
        y = _sharded_view(y)
        pts = _whole(x)
        pts = pts[:, None] if pts.dim() == 1 else pts
        rows = slice(x.row_start, x.row_start + pts.shape[0] // x.rows.size)
        if pts.shape[1] == 1:
            order = torch.argsort(pts[:, 0], stable=True)
            y_all = (_whole(y) if isinstance(y, Sharded)
                     else as_tensor(y, device=pts.device))
            pts, y_mine = pts[order], y_all[order][rows]
        else:
            y_mine = (y.local if isinstance(y, Sharded)
                      else as_tensor(y, device=pts.device)[rows])
        self._x_all = pts
        view = Sharded(pts[rows], tuple(pts.shape), x.mesh, x.rows)
        return view, row_dtensor(y_mine, x.mesh, x.rows, pts.shape[0])

    def predict(self, x_test, return_var: bool = False):
        train = _sharded_view(self.x_train_)
        local = _local(train)
        x_test = _as_rows(_whole(_row_split(x_test, local.device)),
                          local.device)
        if x_test.shape[1] != local.shape[1]:
            x_test = x_test.T
        # m x n; of row-split training points, this rank's columns
        k_star = self.kernel(x_test, local)
        alpha = _local(_sharded_view(self.alpha_))
        mean = _reduce(matmul_at(k_star, alpha[:, None], "highest"),
                       train)[:, 0]
        if not return_var:
            return mean
        if hasattr(self, "_cho"):
            w = _cho_solve(self._cho, k_star.T)
        elif isinstance(train, Sharded):                  # n x m, batched
            w, _ = _solve_rows(self._hodlr, k_star.T,
                               _split_of(self._hodlr), 1e-8, 200)
        else:
            w = hodlr_solve(self._hodlr, k_star.T)
        k_ss = torch.func.vmap(
            lambda xt: self.kernel(xt[None], xt[None])[0, 0])(x_test)
        var = torch.clamp(k_ss - _reduce(torch.sum(k_star.T * w, dim=0),
                                         train), min=0.0) + self.noise ** 2
        return mean, var

    def log_marginal_likelihood(self, num_probes: int = 8,
                                steps: int = 30, seed: int = 0) -> float:
        """-1/2 [y^T alpha + logdet(K + s^2 I) + n log 2pi]; log-det by
        SLQ -- on the dense train kernel, or matrix-free on the HODLR
        matvec for implicit fits."""
        from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.slq import (
            _logdet_fn,
            logdet_psd,
            slq_block,
        )

        train = _sharded_view(self.x_train_)
        n = train.shape[0]
        if isinstance(train, Sharded):
            if self._implicit:
                split = _split_of(self._hodlr)

                def apply_a(v):
                    rows = v[split.row_start:
                             split.row_start + split.local.shape[0]]
                    return _whole(split.with_local(
                        _matvec_local(self._hodlr, rows, split)))

                ld = float(slq_block(apply_a, n, train.dtype, train.device,
                                     _logdet_fn(0.0), seed, num_probes,
                                     steps))
            else:
                ld = float(logdet_psd(
                    self._train_kernel(train).to_dtensor(), seed=seed,
                    num_probes=num_probes, steps=steps))
            fit = float(_reduce(torch.dot(
                _local(_sharded_view(self.y_train_)),
                _local(_sharded_view(self.alpha_))), train))
            return -0.5 * (fit + ld + n * math.log(2 * math.pi))
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
