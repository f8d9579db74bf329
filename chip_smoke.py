#!/usr/bin/env python3
"""Drive the PyTorch port's main path, its three-kernel ``rsvd()``
path, ``rsvd()`` at its defaults, the serving path, the image codec,
the other driver modes, PCA and the rsvd/pca command lines on one CUDA
card, and hold every kernel of those paths to its plain PyTorch version.

Run from the repository root:  python3 chip_smoke.py  [--kernels-only]

Phases (any failure raises; nothing is caught):
1. Build every kernel from ``csrc/`` with nvcc for sm_90a, all at once,
   and log each ptxas report.
2. Each kernel against its plain version on the card, at the paths'
   shapes and at ragged ones (K1 and K2 also on a 4096 x 160 panel, past
   their 128-wide one-tile paths; K1 also on the rsvd command line's
   100/110/140/160 x 16 panels); K2's intermediates (``stage``) against
   the plain ones; two calls of K1 or K2 on one panel must agree bitwise;
   a rank-deficient panel must give non-finite (K1) or unhealthy (K2)
   output from both.  K1 and K2 report their launch plans, a profile of
   their kernels by stage and ptxas registers; K2 is also timed with its
   iteration's cluster set to 4 (the one-block iteration), 8 and 16
   blocks, measured only.  K3 (``eigh_small``) on the
   three-kernel path's l x l tail Gram and at n in {1, 2, 16, 17, 128,
   200} (16: the command line's l)
   (200 runs the workspace route), on an indefinite and on a
   rank-deficient matrix, bitwise at every even n; K4
   (``fused_sketch_matmul``) on the recovered Omega (A = I) and on Y at
   4096^2 x 80, a ragged 4099 x 4001 x 17 and l = 130; its 3xTF32
   tensor-core variant is only measured (time, recovered-Omega ulps, Y
   error), never checked or counted.  K5 (``quantize_uint8``, K5a
   deterministic and K5b stochastic) bitwise against its plain version
   on the image phase's factor shapes, 1-D 1000, 3 x 5 x 7, 4099 x
   4001, a constant, the 256-level grid and 16384^2; K5b within one
   level of K5a, unbiased at 6 sigma over 64 seeds, exact on the grid.
   Kernel, plain version and library yardsticks are timed with CUDA
   events.  ``--kernels-only`` stops here.
3. The main path -- ``entry()``'s rank-64 rSVD (k=64, p=16, q=2) of a
   4096 x 4096 f32 operand made from seed 0, and the same configuration
   through ``rsvd()`` -- for precision 'highest', 'high' and 'default'
   (K1 for every orthonormalization: q + 1 = 3 launches per call); and
   the same
   configuration with ``interior_qr='polar_fused'`` through
   ``rsvd_with_omega`` (2 K2 launches and 1 K1 launch per call), and
   one ``torch.profiler`` pass over ``entry()``'s 'default' call.  Then
   the three-kernel path, ``rsvd(sketch='fused', method='eigh_pallas')``
   with K1 interiors, 'highest' and 'default' (K4, K1, K3 launched 1, 3
   and 1 times per call), with one ``torch.profiler`` pass over the
   'highest' call; and ``rsvd(A, k=64)`` at its defaults (the Jacobi
   tail), then with method 'parallel_jacobi', 'power' and 'auto'.
   Reconstruction errors are compared with a numpy f64 rSVD of the same
   k, p and q (``err_ratio_vs_numpy``, as bench.py computes it; for the
   fused sketch on the same Omega); singular values with the same call
   through the plain versions.
4. The serving path: ``rsvd_serving(prepare_operand(A), k=64, p=16,
   q=2)`` on phase 3's operand, for storage 'int8' (pre-quantized),
   'bf16' and 'default', with 'cholqr1' interiors (no kernel) and
   'polar_fused' interiors (2 K2 launches per call); each must be healthy
   and within 1% of the numpy rSVD's error.  Then int8 serving of two
   operands drawn on the card, each against the port's own 'highest'
   finish='project' rSVD: a ragged 4099 x 4001 (k=64) and the HBM-bound
   16384 x 16384 (k=128).  One ``torch.profiler`` pass over each of
   these two calls, and over the 4096^2 int8 serving call with each
   interior.
5. The image codec (``apps/image.py``) on a seeded 4096^2 grayscale
   photo, no PIL needed: the CLI's steps -- normalize,
   ``compress_tiled(k=80, grid=(2, 2))``, restore, ``save_compressed``
   and ``load_compressed`` -- and K5a/K5b on the factors (3 launches
   each), counted; each tile's error within 1% of a numpy f64 rSVD on the
   same Omega, the factors back within half a codec step, K5's bytes
   within one level of the host codec's.  Then ``compress()`` at its
   default k on a 1024^2 crop (k = 256, Jacobi tail), on a 1024^2 x 3
   color image, and ``compress_video`` of 8 frames of 1080 x 1920 at
   k = 32, each within 1% of numpy on the same Omega.
6. The driver modes, each against a numpy f64 yardstick:
   ``rsvd_batched`` of 16 x 1024^2 (k = 64) in modes 'scan' and 'vmap'
   (per element, same Omega), ``rsvd_warm`` on phase 3's operand from
   the basis of a call on A + 1e-3 noise, ``rsvd_onepass`` (k = 64,
   within 1.5x of a q = 0 rSVD) and ``rsvd_adaptive`` at tol 1e-2 on a
   geometric spectrum (the f64 error within tol).
7. PCA and the command lines.  ``PCA(X)`` at its defaults on a
   262144 x 1024 f32 factor model made on the card (a per-feature offset,
   a 0.97^i spectrum, 1% noise), then with ``normalize=True``: the block
   Jacobi engine on the 1024 x 1024 R of the robust QR, each against the
   eigenvalues of the centred Gram in f64 (singular values, variance
   ratios, ||V^T V - I||_F, ||Xc - U S V^T||_F), with its time split by
   stage and one profiler pass over a block sweep and 128 rounds of a
   polish sweep;
   ``PCA(X, use_rsvd=True, rank=64)`` against an f64 rSVD on its Omega;
   ``jacobi_svd_chunked`` on the R against the engine's singular
   values, logging every sweep; ``StreamingPCA(1024, l=128)`` over X in
   4096-row batches in f64 and in f32, each never over the true
   eigenvalues and within FD's bound.  Then ``python -m
   rsvd_kamaneh_raganato_terrana_tpu_torch rsvd`` over data/input plus a
   2048^2 f32 .mtx written and read back bitwise, and ``pca
   data/pca/tourists.txt yes``, as subprocesses; and in-process
   ``rsvd data/input --method eigh_pallas --qr-method cholqr1_fused``,
   counted: per file one K3 launch and 1 + 2q = 5 K1 launches, each
   call's input kept and its output held to the plain version's on it;
   every file's error within 1e-4 of the default flags' run, and only
   the rank-deficient sparse_matrix non-finite, with the cholqr hint.
8. A ``kernels`` JSON line, the card's name and power limit, and as the
   last line ``{"ok": true, "device": {...}}``.

Exits non-zero with no result line when no CUDA device is visible or
the package is not importable next to this script.
"""

import contextlib
import ctypes
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch import (
    factor_health,
    prepare_operand,
    rsvd,
    rsvd_adaptive,
    rsvd_batched,
    rsvd_onepass,
    rsvd_serving,
    rsvd_warm,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch import __main__ as cli
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import image
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import pca
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import device
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.io import (
    read_matrix_market,
    write_matrix_market,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.entry import CONFIG, entry
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import (
    _build,
    jacobi,
    kernels,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.polar import polar_qr
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import qr_reduced
from rsvd_kamaneh_raganato_terrana_tpu_torch.native import get_codec
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    generate_omega,
    reconstruction_error,
    rsvd_with_omega,
)

M = N = 4096
K, P, Q = 64, 16, 2
BIG, BIG_K = 16384, 128   # the HBM-bound serving point
RAGGED = (4099, 4001)     # widths that are not multiples of 16
ERR_RATIO_MAX = 1.01     # rSVD error within 1% of the f64 numpy rSVD
# max |ds| / s_1, kernel path vs plain path.  'highest' differs by fp32
# roundoff only; under 'default' an fp32-level change in Q can flip the
# bf16 rounding of single GEMM operands (bf16 eps 3.9e-3)
# 'high' is TF32 (10-bit operands): the same flips as bf16's, at 1/4 the
# step
SIGMA_TOL = {"highest": 1e-4, "high": 5e-4, "default": 5e-4}
Q_TOL = 1e-4             # K1: max |dQ| (Q has orthonormal columns)
R_TOL = 1e-4             # K1: max |dR| / max |R|
ORTH_TOL = 1e-4          # max |Q^T Q - I| of a kernel's Q
K2_Q_TOL = 2e-4          # K2: max |dQ|, the JAX fused-vs-composed bound
K2_STAGE_TOL = 1e-4      # K2: max |d stage| / max |stage|
K2_SYM_TOL = 1e-5        # K2: max |R - R^T| / max |R|, cond ~1
K2_NORM_TOL = 1e-3       # K2: column norms of R against Y's, relative
SERVING_PLAIN_TOL = 1e-3  # polar serving, kernel vs plain K2 recon error
# 16: the rsvd command line's l; 200: past shared memory, the workspace
K3_SIZES = (1, 2, 16, 17, 128, 200)
K3_LAM_TOL = 1e-5        # K3: max |d lambda| / max |lambda| vs plain, odd n
# K3: max |V^T V - I| and ||V L V^T - G||_F / ||G||_F of the kernel's own
# factors on full-rank inputs: the JAX suite's orthogonality bound
# (tests/test_pallas.py:112).  The TPU kernel's arithmetic computes c, s
# per row of a G that is not exactly symmetric, so its rotations are not
# exactly orthogonal and the drift grows with the round count: JAX's own
# kernel gives 4.0e-4 / 2.8e-4 on the main path's l = 80 tail Gram
K3_ORTH_TOL = K3_REC_TOL = 1e-3
K4_OMEGA_ULPS = 4        # K4: recovered Omega vs plain, in ulps of |Omega|
K4_Y_TOL = 1e-5          # K4: max |dY| / max |Y| vs plain
DEFAULT_P = 10           # rsvd()'s default oversampling
FUSED = dict(k=K, p=P, q=Q, seed=0, method="eigh_pallas", sketch="fused",
             qr_method="cholqr1_fused", interior_qr="cholqr1_fused",
             reorth="half")
ENGINES = ("jacobi", "parallel_jacobi", "power", "auto")
# the H100 SXM's published peaks: dense fp32 FLOP/s and HBM3 bytes/s
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
POLAR_ITERS = 8
K2_STAGES = ("gram", "gt", "w1", "h1", "h2", "h4", "h8")
K5_SEED = 7
IMG_SIDE, IMG_K, IMG_GRID = 4096, 80, (2, 2)   # the image CLI's defaults
COLOR_SIDE = 1024
VIDEO, VIDEO_K = (8, 1080, 1920), 32
BATCH, BATCH_SIDE = 16, 1024
ONEPASS_RATIO_MAX = 1.5   # "a constant factor behind" a q = 0 rSVD
ADAPTIVE_TOL, ADAPTIVE_RATIO = 1e-2, 0.97    # expected k = 152
PCA_ROWS, PCA_D = 262144, 1024   # X: 1 GiB f32; d > 512: the block engine
PCA_DECAY, PCA_NOISE, PCA_OFFSET = 0.97, 0.01, 5.0
PCA_SIG_TOL = 1e-4        # max |ds| / s_1 against the f64 yardstick
PCA_RATIO_TOL = 1e-4      # explained-variance ratios, absolute
PCA_ORTH_TOL = 1e-3       # check_orthogonality(): ||V^T V - I||_F
PCA_RECON_TOL = 1e-4      # ||Xc - U S V^T||_F / ||Xc||_F
PCA_RANK = 64             # the use_rsvd path
CHUNKED_TOL = 1e-5        # chunked vs single-dispatch, max |ds| / s
POLISH_PROFILE_ROUNDS = 128
STREAM_L, STREAM_K, STREAM_BATCH = 128, 64, 4096
STREAM_OVER_TOL = 1e-4    # relative slack over the true eigenvalues
MTX_SIDE = 2048
CLI_ROWS, CLI_L = (100, 110, 140, 160), 16   # data/input's m; l = k + p
CLI_ERR_TOL = 1e-4        # sparse_matrix's error over ||A||_F, f32
# PC1's variance ratio on tourists.txt, normalized (the JAX CLI: 0.8961)
TOURISTS_PC1, TOURISTS_TOL = 0.896, 1e-3


T_START = time.perf_counter()


def log(msg):
    print(msg, flush=True)


def phase(title):
    """A phase's heading, with the seconds since the script started."""
    log(f"{title} (at {time.perf_counter() - T_START:.1f} s)")


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes):
    """(bound_ms, bound_by): the least time the card could take."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def numpy_rsvd(a, l, q, seed=0, omega=None):
    """The numpy baseline of bench.py:87-99, in f64; ``omega`` replaces
    its Gaussian draw when given."""
    if omega is None:
        omega = np.random.default_rng(seed).standard_normal((a.shape[1], l))
    q_mat, _ = np.linalg.qr(a @ omega)
    for _ in range(q):
        qz, _ = np.linalg.qr(a.T @ q_mat)
        q_mat, _ = np.linalg.qr(a @ qz)
    u_t, s, vt = np.linalg.svd(q_mat.T @ a, full_matrices=False)
    return q_mat @ u_t, s, vt.T


def recon_err(a, u, s, v):
    return float(np.linalg.norm(a - (u[:, :K] * s[:K]) @ v[:, :K].T))


WRAPPERS = ("fused_cholqr1", "polar_qr_fused", "eigh_small",
            "fused_sketch_matmul", "quantize_uint8")   # K1, K2, K3, K4, K5
# (wrapper, count attribute) of each kernel: K5's wrapper launches K5a or
# K5b and counts each apart
COUNTERS = tuple((w, "launches") for w in WRAPPERS) + (
    ("quantize_uint8", "launches_stochastic"),)
NONE = (0,) * len(COUNTERS)


def plain_kernels():
    """Every kernel wrapper swapped for its plain version."""
    return mock.patch.multiple(kernels, **{
        w: getattr(kernels, f"{w}_reference") for w in WRAPPERS})


def reset_counts():
    for w, attr in COUNTERS:
        setattr(getattr(kernels, w), attr, 0)


def counts():
    """(K1, K2, K3, K4, K5a, K5b) launches since the last reset."""
    return tuple(getattr(getattr(kernels, w), attr) for w, attr in COUNTERS)


def launches_of(k1=0, k2=0, k3=0, k4=0, k5a=0, k5b=0):
    return (k1, k2, k3, k4, k5a, k5b)


def panels(a):
    """Phase 2's panels: Y = A Omega at the paths' 4096 x 80, a cond-100
    panel (tests/test_polar.py:28-33), ragged and tall ones."""
    omega = generate_omega(0, N, K + P, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    y_main = device.matmul_at(a, omega, "highest")
    u, _ = torch.linalg.qr(torch.randn(4096, 80, device="cuda",
                                       generator=gen))
    v, _ = torch.linalg.qr(torch.randn(80, 80, device="cuda", generator=gen))
    s = torch.logspace(2, 0, 80, device="cuda")
    with device.ieee_fp32():
        y_cond = (u * s) @ v.T
    return y_main, {
        "main Y = A @ Omega 4096x80": (y_main, True),
        "cond-100 4096x80": (y_cond, False),
        "ragged 4099x17": (torch.randn(4099, 17, device="cuda",
                                       generator=gen), True),
        "ragged 1000x128": (torch.randn(1000, 128, device="cuda",
                                        generator=gen), True),
        "panel 16384x80": (torch.randn(16384, 80, device="cuda",
                                       generator=gen), True),
        # past l = 128: K1's and K2's wide paths (tiled Gram and apply,
        # K1's elimination over the workspace, K2's one-block iteration)
        "wide 4096x160": (torch.randn(4096, 160, device="cuda",
                                      generator=gen), True),
    }


def cli_panels():
    """K1 at the rsvd command line's shapes: an m x 16 panel for each
    m of data/input (100, 110, 140, 160)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    return {f"cli {m}x{CLI_L}": (torch.randn(m, CLI_L, device="cuda",
                                             generator=gen), True)
            for m in CLI_ROWS}


def rank_deficient():
    y = torch.randn(1000, 64, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    y[:, 32:] = y[:, :32]                          # exact rank 32 < l
    return y


def orth_err(q):
    with device.ieee_fp32():
        gram = q.T @ q
    return float((gram - torch.eye(q.shape[1], device="cuda")).abs().max())


def panel_plan(fn, m, l, keys):
    """A panel kernel's launch plan at (m, l) as its library reports it
    (``rsvd_cholqr1_plan``, ``rsvd_polar_plan``)."""
    fn.restype = None
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_longlong)]
    out = (ctypes.c_longlong * len(keys))()
    fn(m, l, out)
    return dict(zip(keys, out))


def k1_plan(m, l):
    return panel_plan(kernels._cholqr1_lib().rsvd_cholqr1_plan, m, l,
                      ("narrow", "gram_blocks", "rows_per_split",
                       "partials", "elim_smem_bytes"))


def k2_plan(m, l):
    return panel_plan(kernels._polar_lib().rsvd_polar_plan, m, l,
                      ("cluster_path", "cluster", "band_rows",
                       "gram_blocks", "partials", "iter_smem_bytes"))


def bitwise_twice(fn, y):
    """Two calls of ``fn`` on the same panel give bitwise equal outputs."""
    first = fn(y)
    second = fn(y)
    torch.cuda.synchronize()
    return all(torch.equal(x, z) for x, z in zip(first, second))


def stage_profile(call):
    """Device ms per call by kernel group and the launch gaps (wall minus
    busy), from one profiler pass over 20 calls."""
    prof = profile_call(call, reps=20)
    return dict(prof["ms_per_call_by_group"],
                wall_ms=prof["wall_ms_per_call"],
                busy_ms=prof["device_busy_ms_per_call"])


def phase_k1(y_main, all_panels):
    """K1 against its plain version; returns its kernels-line fields."""
    worst_q = worst_r = 0.0
    for name, (y, _) in dict(all_panels, **cli_panels()).items():
        if name.startswith("cond"):
            continue
        q, r = kernels.fused_cholqr1(y)
        q0, r0 = kernels.fused_cholqr1_reference(y)
        torch.cuda.synchronize()
        check(q.shape == q0.shape and r.shape == r0.shape, name)
        check(bool(torch.isfinite(q).all() and torch.isfinite(r).all()),
              f"{name}: non-finite output")
        dq = float((q - q0).abs().max())
        dr_rel = float((r - r0).abs().max()) / float(r0.abs().max())
        orth = orth_err(q)
        lower = float(torch.tril(r, -1).abs().max())
        log(f"  K1 {name}: max|dQ|={dq:.3e} max|dR|/max|R|={dr_rel:.3e} "
            f"max|Q^T Q - I|={orth:.3e} max|tril(R)|={lower:.1e}")
        check(dq <= Q_TOL and dr_rel <= R_TOL,
              f"{name}: kernel vs plain dQ={dq} dR/R={dr_rel}")
        check(orth <= ORTH_TOL and lower == 0.0,
              f"{name}: |Q^T Q - I|={orth} |tril(R)|={lower}")
        same = bitwise_twice(kernels.fused_cholqr1, y)
        log(f"  K1 {name}: plan {k1_plan(*y.shape)}, two calls bitwise "
            f"equal: {same}")
        check(same, f"{name}: K1 not deterministic")
        worst_q, worst_r = max(worst_q, dq), max(worst_r, dr_rel)

    y_def = rank_deficient()
    for label, fn in (("kernel", kernels.fused_cholqr1),
                      ("plain", kernels.fused_cholqr1_reference)):
        q, r = fn(y_def)
        finite = bool(torch.isfinite(q).all() and torch.isfinite(r).all())
        log(f"  K1 rank-deficient 1000x64 ({label}): finite={finite}")
        check(not finite, f"rank-deficient panel gave finite {label} output")

    m, l = y_main.shape
    ms = cuda_ms(lambda: kernels.fused_cholqr1(y_main), 50)
    plain_ms = cuda_ms(lambda: kernels.fused_cholqr1_reference(y_main), 10)
    lib_ms = cuda_ms(lambda: torch.linalg.qr(y_main, mode="reduced"), 20)
    # the symmetric Gram ml(l+1), the triangular apply Y (L^-1)^T
    # ml(l+1), Cholesky and triangular inverse (2/3) l^3; Y read, Q and R
    # written.  At 4096 x 80 the two times tie within 1%
    bound_ms, bound_by = bound(2 * m * l * (l + 1) + 2 * l ** 3 / 3,
                               4 * (2 * m * l + l * l))
    nc = -(-l // 16)
    ptxas = {k: ptxas_report("cholqr1", e) for k, e in (
        ("gram", f"gram_clusterILi{nc}E"),
        ("eliminate", f"eliminate_clusterILi{-(-2 * l // 32)}E"),
        ("apply", f"apply_rowsILi{nc}ELb1ELb1E"),
        ("eliminate_wide", "eliminate_wide"))}
    stages = stage_profile(lambda: kernels.fused_cholqr1(y_main))
    log(f"  K1 at {m}x{l}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.linalg.qr {lib_ms:.4f} ms, bound {bound_ms * 1e3:.3f} us "
        f"({bound_by}); stages {json.dumps(stages)}; ptxas {ptxas}")
    return dict(max_abs_err=worst_q, max_rel_err_r=worst_r, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_us=bound_ms * 1e3, bound_by=bound_by,
                stages_ms=stages, ptxas=ptxas)


def k2_unhealthy(q, r):
    """factor_health of a polar factorization as the JAX suite reads it
    (tests/test_polar.py:87-103): U = Q, s = R's sorted column norms."""
    s = torch.sort(torch.linalg.norm(r, dim=0), descending=True).values
    return not factor_health(q, s, q)["ok"]


def phase_k2(y_main, all_panels):
    """K2 and its stages against the plain version; returns its
    kernels-line fields."""
    worst_q = worst_stage = 0.0
    for name, (y, well_conditioned) in all_panels.items():
        q, r = kernels.polar_qr_fused(y)
        q0, r0 = kernels.polar_qr_fused_reference(y)
        torch.cuda.synchronize()
        check(q.shape == q0.shape and r.shape == r0.shape, name)
        check(bool(torch.isfinite(q).all() and torch.isfinite(r).all()),
              f"{name}: non-finite K2 output")
        dq = float((q - q0).abs().max())
        sym = float((r - r.T).abs().max() / r.abs().max())
        sym0 = float((r0 - r0.T).abs().max() / r0.abs().max())
        with device.ieee_fp32():
            norms = torch.linalg.norm(r, dim=0) / torch.linalg.norm(y, dim=0)
        dnorm = float((norms - 1.0).abs().max())
        orth = orth_err(q)
        stage_err = {}
        for st in K2_STAGES:
            got = kernels.polar_qr_fused(y, stage=st)
            want = kernels.polar_qr_fused_reference(y, stage=st)
            stage_err[st] = float((got - want).abs().max()
                                  / want.abs().max())
        log(f"  K2 {name}: max|dQ|={dq:.3e} max|Q^T Q - I|={orth:.3e} "
            f"max|R-R^T|/max|R|={sym:.2e} (plain {sym0:.2e}) "
            f"max|colnorm(R)/colnorm(Y)-1|="
            f"{dnorm:.2e} stages " + " ".join(
                f"{k}={v:.1e}" for k, v in stage_err.items()))
        check(dq <= K2_Q_TOL, f"{name}: K2 vs plain dQ={dq}")
        check(not well_conditioned or orth <= ORTH_TOL,
              f"{name}: K2 |Q^T Q - I|={orth}")
        # R = W_s G is symmetric up to W_s's roundoff, which grows with
        # cond(Y)^2: held to 1e-5 when well-conditioned, else to 4x the
        # plain version's own asymmetry
        check(sym <= max(K2_SYM_TOL, 0.0 if well_conditioned else 4 * sym0)
              and dnorm <= K2_NORM_TOL,
              f"{name}: K2 R symmetry {sym} (plain {sym0}), column norms "
              f"{dnorm}")
        check(max(stage_err.values()) <= K2_STAGE_TOL,
              f"{name}: K2 stages {stage_err}")
        same = bitwise_twice(kernels.polar_qr_fused, y)
        log(f"  K2 {name}: plan {k2_plan(*y.shape)}, two calls bitwise "
            f"equal: {same}")
        check(same, f"{name}: K2 not deterministic")
        worst_q = max(worst_q, dq)
        worst_stage = max(worst_stage, max(stage_err.values()))

    y_def = rank_deficient()
    for label, fn in (("kernel", kernels.polar_qr_fused),
                      ("plain", kernels.polar_qr_fused_reference)):
        bad = k2_unhealthy(*fn(y_def))
        log(f"  K2 rank-deficient 1000x64 ({label}): unhealthy={bad}")
        check(bad, f"rank-deficient panel gave healthy {label} K2 factors")

    m, l = y_main.shape
    ms = cuda_ms(lambda: kernels.polar_qr_fused(y_main), 50)
    plain_ms = cuda_ms(lambda: kernels.polar_qr_fused_reference(y_main), 10)
    lib_ms = cuda_ms(lambda: torch.linalg.qr(y_main, mode="reduced"), 20)
    comp_ms = cuda_ms(lambda: polar_qr(y_main), 20)
    # the symmetric Gram ml(l+1) and the full apply Y W_s 2ml^2; 4 l x l
    # products of 2l^3 per step (3 in the first, plus R = W_s G); Y read,
    # Q and R written
    bound_ms, bound_by = bound(m * l * (l + 1) + 2 * m * l * l
                               + 8 * POLAR_ITERS * l ** 3,
                               4 * (2 * m * l + l * l))
    nc = -(-l // 16)
    band = k2_plan(m, l)["band_rows"]
    ptxas = {k: ptxas_report("polar", e) for k, e in (
        ("gram", f"gram_clusterILi{nc}E"),
        ("iterate", f"ns_clusterILi{band}E"),
        ("apply", f"apply_rowsILi{nc}ELb0ELb0E"),
        ("iterate_one_block", "ns_iterate"))}
    stages = stage_profile(lambda: kernels.polar_qr_fused(y_main))
    clusters = k2_cluster_sizes(y_main)
    log(f"  K2 at {m}x{l}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.linalg.qr {lib_ms:.4f} ms, polar_qr composition "
        f"{comp_ms:.4f} ms, bound {bound_ms * 1e3:.3f} us ({bound_by}); "
        f"stages {json.dumps(stages)}; cluster sizes (measured only) "
        f"{json.dumps(clusters)}; ptxas {ptxas}")
    return dict(max_abs_err=worst_q, max_rel_err_stage=worst_stage, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms,
                polar_qr_composition_ms=comp_ms, bound_ms=bound_ms,
                bound_us=bound_ms * 1e3, bound_by=bound_by,
                stages_ms=stages, cluster_sizes=clusters, ptxas=ptxas)


def k2_cluster_sizes(y):
    """K2 on y with the iteration's cluster set to 4 blocks (too few for
    the bands: the one-block iteration, ``ns_iterate``), 8 and 16
    (``rsvd_polar_set_cluster``; measured only, the default restored):
    each one's time, plan, max |dQ| against the plain version and whether
    its Q and R are bitwise those of the default."""
    set_cluster = kernels._polar_lib().rsvd_polar_set_cluster
    set_cluster.restype = ctypes.c_int
    set_cluster.argtypes = [ctypes.c_int]
    q0, _ = kernels.polar_qr_fused_reference(y)
    q_def, r_def = kernels.polar_qr_fused(y)
    out = {}
    default = set_cluster(8)
    try:
        for size in (4, 8, 16):
            set_cluster(size)
            try:
                q, r = kernels.polar_qr_fused(y)
                torch.cuda.synchronize()
                out[size] = dict(
                    ms=cuda_ms(lambda: kernels.polar_qr_fused(y), 50),
                    max_abs_err=float((q - q0).abs().max()),
                    bitwise_default=torch.equal(q, q_def)
                    and torch.equal(r, r_def),
                    plan=k2_plan(*y.shape))
            except RuntimeError as exc:     # a cluster size the card refuses
                out[size] = dict(error=str(exc))
    finally:
        set_cluster(default)
    return out


def tail_gram(a):
    """The l x l Gram the three-kernel path hands K3 for ``a``, captured
    from one call through the plain versions (no launch counted)."""
    seen = []

    def capture(g, sweeps=8):
        seen.append(g.clone())
        return kernels.eigh_small_reference(g, sweeps)

    with plain_kernels(), mock.patch.object(kernels, "eigh_small", capture):
        rsvd(a, precision="highest", **FUSED)
    return seen[0]


def k3_inputs(g_main):
    """Phase 2's symmetric matrices: the main path's tail Gram, Wishart
    matrices at K3_SIZES, an indefinite and a rank-deficient one.  The
    flag says whether the matrix has full rank."""
    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    out = {f"tail Gram B B^T {g_main.shape[0]}x{g_main.shape[0]}":
           (g_main, True)}
    with device.ieee_fp32():
        for n in K3_SIZES:
            x = randn(n, 2 * n)
            out[f"Wishart {n}x{n}"] = (x @ x.T / (2 * n), True)
        x = randn(80, 80)
        out["indefinite 80x80"] = (x + x.T, True)
        x = randn(80, 20)
        out["rank-20 Gram 80x80"] = (x @ x.T, False)
    return out


def ptxas_report(src, entry):
    """Registers, shared memory and spills that ``nvcc -Xptxas -v``
    reported for the first entry function of ``csrc/<src>.cu`` whose
    mangled name contains ``entry``; None when this process did not build
    it."""
    lines = _build.build_logs.get(src, "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            out = {"entry": line.split("'")[1]}
            for nxt in lines[i + 1:i + 4]:
                for key, pat in (("registers", r"Used (\d+) registers"),
                                 ("smem_bytes", r"(\d+) bytes smem"),
                                 ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads")):
                    hit = re.search(pat, nxt)
                    if hit:
                        out[key] = int(hit.group(1))
            return out
    return None


def phase_k3(g_main):
    """K3 against its plain version; returns its kernels-line fields."""
    worst = 0.0
    bitwise = {}
    for name, (g, full_rank) in k3_inputs(g_main).items():
        lam, v = kernels.eigh_small(g)
        lam0, v0 = kernels.eigh_small_reference(g)
        torch.cuda.synchronize()
        n = g.shape[0]
        check(lam.shape == (n,) and v.shape == (n, n), name)
        check(bool(torch.isfinite(lam).all() and torch.isfinite(v).all()),
              f"{name}: non-finite K3 output")
        if n % 2 == 0:
            # the same rounded operations in the same order as the plain
            # version: bitwise at even n (odd n pads with a norm summed in
            # another order)
            same = torch.equal(lam, lam0) and torch.equal(v, v0)
            bitwise[name] = same
            check(same, f"{name}: K3 not bitwise its plain version at even "
                  f"n: max|dlam|={float((lam - lam0).abs().max())} "
                  f"max|dV|={float((v - v0).abs().max())}")
        scale = float(lam0.abs().max()) or 1.0
        dlam = float((lam - lam0).abs().max()) / scale
        dv = float((v - v0).abs().max())
        orth = orth_err(v)
        with device.ieee_fp32():
            rec = float(torch.linalg.norm((v * lam) @ v.T - g)
                        / torch.linalg.norm(g))
        ascending = bool((lam[1:] >= lam[:-1]).all())
        log(f"  K3 {name}: max|dlam|/max|lam|={dlam:.3e} max|dV|={dv:.3e} "
            f"max|V^T V - I|={orth:.3e} ||V L V^T - G||/||G||={rec:.3e} "
            f"lam in [{float(lam[0]):.4g}, {float(lam[-1]):.4g}]")
        check(dlam <= K3_LAM_TOL and ascending,
              f"{name}: K3 vs plain dlam={dlam}, ascending={ascending}")
        if full_rank:
            check(orth <= K3_ORTH_TOL and rec <= K3_REC_TOL,
                  f"{name}: K3 |V^T V - I|={orth} reconstruction {rec}")
        else:
            # the JAX suite's check (tests/test_pallas.py:128-131): no pad
            # eigenvalue leaks in, the spectrum is the f64 one
            ref = torch.linalg.eigvalsh(g.double())
            dref = float((lam.double() - ref).abs().max() / ref.abs().max())
            log(f"  K3 {name}: vs f64 eigvalsh {dref:.3e}")
            check(float(lam[0]) > -1e-3 * scale and dref <= 1e-4,
                  f"{name}: K3 lambda_min={float(lam[0])}, vs f64 {dref}")
        worst = max(worst, dlam * scale)

    n = g_main.shape[0]
    ms = cuda_ms(lambda: kernels.eigh_small(g_main), 20)
    plain_ms = cuda_ms(lambda: kernels.eigh_small_reference(g_main), 2)
    lib_ms = cuda_ms(lambda: torch.linalg.eigh(g_main), 20)
    n_pad = n + n % 2
    rounds = 8 * (n_pad - 1)
    # per round the rotations of n_pad/2 pairs over G's columns, G's rows
    # and V's columns: ~9 n_pad^2 flops; G read, lambda and V written
    bound_ms, bound_by = bound(9 * rounds * n_pad ** 2,
                               4 * (2 * n * n + n))
    ptxas = ptxas_report("eigh", "jacobi_eigh")
    barriers = kernels._eigh_lib().rsvd_eigh_barriers_per_round()
    log(f"  K3 at n={n}: kernel {ms:.4f} ms ({rounds} rounds, "
        f"{ms * 1e3 / rounds:.3f} us each, {barriers} block barriers per "
        f"round by csrc/eigh.cu), plain {plain_ms:.4f} ms, torch.linalg.eigh "
        f"{lib_ms:.4f} ms, bound {bound_ms * 1e3:.3f} us ({bound_by}); "
        f"bitwise at even n: {bitwise}; ptxas {ptxas}")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms,
                bound_us=bound_ms * 1e3, bound_by=bound_by, rounds=rounds,
                us_per_round=ms * 1e3 / rounds, bitwise_even_n=bitwise,
                ptxas=ptxas)


def ulp(x):
    return (torch.nextafter(x, torch.full_like(x, float("inf"))) - x).abs()


def k4_plan(m, n, l):
    """K4's launch plan at (m, n, l) as ``csrc/sketch.cu`` reports it
    (``rsvd_sketch_plan``), with the draws per n l and the padded
    columns' share of the tiles."""
    lib = kernels._sketch_lib()
    lib.rsvd_sketch_plan.restype = None
    lib.rsvd_sketch_plan.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_longlong)]
    out = (ctypes.c_longlong * 7)()
    lib.rsvd_sketch_plan(m, n, l, out)
    plan = dict(zip(("cluster", "splits", "k_per_split", "blocks",
                     "tile_columns", "padded_columns", "draws"), out))
    plan.update(draws_per_nl=plan["draws"] / (n * l),
                padded_column_share=plan["padded_columns"]
                / plan["tile_columns"])
    return plan


def sketch_3xtf32(a, l, seed):
    """Y = A Omega through ``csrc/sketch.cu``'s 3xTF32 tensor-core variant
    (``rsvd_sketch_f32_3xtf32``): measured beside K4, never called by the
    package, so it has no wrapper and no launch count."""
    lib = kernels._sketch_lib()
    fn = lib.rsvd_sketch_f32_3xtf32
    fn.restype = ctypes.c_int
    fn.argtypes = lib.rsvd_sketch_f32.argtypes
    m, n = a.shape
    y = torch.empty((m, l), dtype=torch.float32, device=a.device)
    work = torch.empty(lib.rsvd_sketch_workspace_floats(m, n, l),
                       dtype=torch.float32, device=a.device)
    err = fn(a.data_ptr(), y.data_ptr(), work.data_ptr(), m, n, l,
             seed & 0xFFFFFFFF, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"3xTF32 sketch: CUDA error {err}")
    return y


def phase_k4(a):
    """K4 against its plain version; returns its kernels-line fields."""
    eye = torch.eye(1024, device="cuda")
    om = kernels.fused_sketch_matmul(eye, K + P, seed=0)
    om0 = kernels.fused_sketch_omega(1024, K + P, seed=0, device="cuda")
    ulps = float(((om - om0).abs() / ulp(om0.abs())).max())
    log(f"  K4 recovered Omega 1024x{K + P}: max |dOmega| = {ulps:.1f} ulp, "
        f"mean {float(om.mean()):+.4f}, std {float(om.std()):.4f}")
    check(ulps <= K4_OMEGA_ULPS, f"K4 Omega differs by {ulps} ulp")
    gen = torch.Generator(device="cuda").manual_seed(5)
    ragged = torch.randn(*RAGGED, device="cuda", generator=gen)
    worst = 0.0
    for name, x, l, seed in (("4096^2 x 80", a, K + P, 0),
                             (f"ragged {RAGGED[0]}x{RAGGED[1]} x 17",
                              ragged, 17, 1),
                             ("4096^2 x 130", a, 130, 2)):
        y = kernels.fused_sketch_matmul(x, l, seed)
        y0 = kernels.fused_sketch_matmul_reference(x, l, seed)
        torch.cuda.synchronize()
        check(y.shape == y0.shape == (x.shape[0], l), name)
        err = float((y - y0).abs().max())
        rel = err / float(y0.abs().max())
        log(f"  K4 {name}: max|dY|/max|Y| = {rel:.3e}")
        check(rel <= K4_Y_TOL, f"K4 {name}: {rel}")
        worst = max(worst, err)
    del ragged
    m, n = a.shape
    l = K + P
    omega = kernels.fused_sketch_omega(n, l, seed=0, device="cuda")
    ms = cuda_ms(lambda: kernels.fused_sketch_matmul(a, l, 0), 20)
    plain_ms = cuda_ms(lambda: kernels.fused_sketch_matmul_reference(a, l, 0),
                       10)
    with device.ieee_fp32():
        lib_ms = cuda_ms(lambda: torch.matmul(a, omega), 20)
    bound_ms, bound_by = bound(2 * m * n * l, 4 * (m * n + m * l))
    # the 3xTF32 variant, measured only: its recovered Omega, its Y at
    # 4096^2 x 80 and its time, beside the fp32 kernel's
    tc_om = sketch_3xtf32(eye, l, 0)
    tc_ulps = float(((tc_om - om0).abs() / ulp(om0.abs())).max())
    y0 = kernels.fused_sketch_matmul_reference(a, l, 0)
    tc_rel = float((sketch_3xtf32(a, l, 0) - y0).abs().max()
                   / y0.abs().max())
    tc_ms = cuda_ms(lambda: sketch_3xtf32(a, l, 0), 20)
    log(f"  K4 3xTF32 variant (measured only) at {m}x{n} x {l}: "
        f"{tc_ms:.4f} ms, recovered Omega {tc_ulps:.1f} ulp, "
        f"max|dY|/max|Y| = {tc_rel:.3e}; ptxas "
        f"{ptxas_report('sketch', 'sketch_clusterILi5ELb1ELb1E')}")
    plan = k4_plan(m, n, l)
    # the tile width l = 80 takes: NC = 5 columns a thread, 16-byte A loads
    ptxas = ptxas_report("sketch",
                         f"sketch_clusterILi{-(-l // 16)}ELb1ELb0E")
    log(f"  K4 at {m}x{n} x {l}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, torch.matmul(A, Omega) fp32 {lib_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.3f} us ({bound_by}); plan {plan}; ptxas {ptxas}")
    return dict(max_abs_err=worst, max_ulps_omega=ulps, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_us=bound_ms * 1e3, bound_by=bound_by, ptxas=ptxas)


def k5_inputs():
    """Phase 2's K5 inputs: the image phase's factor shapes, ragged,
    1-D and 3-D ones, a constant, the 256-level grid and the 1 GiB
    16384^2 tensor."""
    gen = torch.Generator(device="cuda").manual_seed(6)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    th = IMG_SIDE // IMG_GRID[0]
    return {
        f"tile U 4x{th}x{IMG_K}": randn(4, th, IMG_K) * 0.02,
        f"tile s 4x{IMG_K}": randn(4, IMG_K).abs() * 100.0,
        "1-D 1000": randn(1000),
        "3x5x7": randn(3, 5, 7),
        f"ragged {RAGGED[0]}x{RAGGED[1]}": randn(*RAGGED),
        "constant 33x17": torch.full((33, 17), -2.75, device="cuda"),
        "grid 0..255": torch.arange(256, dtype=torch.float32, device="cuda"),
        f"{BIG}^2": randn(BIG, BIG),
    }


def k5_equal(x, stochastic, seed=K5_SEED):
    """K5 and its plain version on x: (q, max |q - q_plain|), after
    checking scale and lo."""
    q, scale, lo = kernels.quantize_uint8(x, stochastic, seed)
    q0, scale0, lo0 = kernels.quantize_uint8_reference(x, stochastic, seed)
    torch.cuda.synchronize()
    check(q.dtype == torch.uint8 and q.shape == x.shape, "K5 output")
    check(torch.equal(scale, scale0) and torch.equal(lo, lo0),
          f"K5 scale/lo {float(scale)}/{float(lo)} vs plain "
          f"{float(scale0)}/{float(lo0)}")
    return q, int((q.int() - q0.int()).abs().max())


def k5_launch_only(x32, stochastic):
    """K5's bare launch on x32 with lo and scale computed once (no
    reduction): for timing the kernel alone."""
    lo, scale = kernels._quantize_range(x32)
    q = torch.empty(x32.shape, dtype=torch.uint8, device="cuda")
    lib = kernels._quantize_lib()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        lib.rsvd_quantize_u8_f32(x32.data_ptr(), q.data_ptr(), x32.numel(),
                                 lo.data_ptr(), scale.data_ptr(),
                                 int(stochastic), K5_SEED, stream)
    return launch


def phase_k5():
    """K5a and K5b against their plain versions (bitwise), K5b's
    statistics; returns the kernels-line fields of K5a and K5b."""
    worst = {False: 0, True: 0}
    inputs = k5_inputs()
    for name, x in inputs.items():
        qd, bad_d = k5_equal(x, False)
        qs, bad_s = k5_equal(x, True)
        step = int((qs.int() - qd.int()).abs().max())
        log(f"  K5 {name}: max |q - q_plain|: K5a {bad_d}, K5b {bad_s}; "
            f"max |K5b - K5a| = {step} level")
        check(bad_d == 0 and bad_s == 0, f"K5 {name}: kernel != plain")
        check(step <= 1, f"K5 {name}: K5b {step} levels from K5a")
        worst = {False: max(worst[False], bad_d), True: max(worst[True],
                                                            bad_s)}
        if name.startswith("grid"):
            for q in (qd, qs):
                check(torch.equal(q.float(), x), "K5 grid values not exact")
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand(256, 256, device="cuda", generator=gen)
    acc = torch.zeros_like(x, dtype=torch.float64)
    for seed in range(64):
        q, scale, lo = kernels.quantize_uint8(x, True, seed)
        acc += q.double() * scale.double() + lo.double()
    bias = float((acc / 64 - x.double()).abs().max())
    limit = 6.0 * float(scale) / 2.0 / 8.0         # 6 sigma over 64 seeds
    log(f"  K5b 256x256 over 64 seeds: max |mean - x| = {bias:.3e} "
        f"(6 sigma {limit:.3e})")
    check(bias < limit, f"K5b biased: {bias} >= {limit}")

    big = inputs[f"{BIG}^2"]
    del inputs
    numel = big.numel()
    aminmax_ms = cuda_ms(lambda: torch.aminmax(big), 20)
    bound_ms, bound_by = bound(0, 5 * numel)       # 4 B read, 1 B written
    out = {}
    for stochastic, key in ((False, "K5a"), (True, "K5b")):
        ms = cuda_ms(lambda: kernels.quantize_uint8(big, stochastic, 7), 20)
        kernel_ms = cuda_ms(k5_launch_only(big, stochastic), 20)
        plain_ms = cuda_ms(
            lambda: kernels.quantize_uint8_reference(big, stochastic, 7), 2)
        log(f"  {key} at {BIG}^2: call {ms:.4f} ms (kernel alone "
            f"{kernel_ms:.4f} ms, torch.aminmax {aminmax_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")
        out[key] = dict(max_abs_err=worst[stochastic], ms=ms,
                        kernel_only_ms=kernel_ms, plain_ms=plain_ms,
                        library_ms=None, aminmax_ms=aminmax_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        bytes_moved=5 * numel)
    del big
    torch.cuda.empty_cache()
    return out


def photo(shape, seed):
    """A seeded grayscale 'photo' in [0, 255] (numpy f64): gradients,
    smooth blobs, a few hard-edged rectangles and N(0, 2) noise."""
    rng = np.random.default_rng(seed)
    m, n = shape
    y = np.linspace(0.0, 1.0, m)[:, None]
    x = np.linspace(0.0, 1.0, n)[None, :]
    img = 60.0 + 90.0 * x + 40.0 * y
    for _ in range(12):
        cy, cx = rng.uniform(0, 1, 2)
        r = rng.uniform(0.03, 0.2)
        img = img + rng.uniform(-60, 60) * np.exp(
            -((y - cy) ** 2 + (x - cx) ** 2) / (2 * r * r))
    for _ in range(4):
        y0, y1 = np.sort(rng.uniform(0, 1, 2))
        x0, x1 = np.sort(rng.uniform(0, 1, 2))
        img = img + rng.uniform(-50, 50) * ((y >= y0) & (y < y1)
                                            & (x >= x0) & (x < x1))
    return np.clip(img + rng.normal(0.0, 2.0, (m, n)), 0.0, 255.0)


def capture(module, name):
    """(patch, seen): a spy on ``module.name`` keeping what it returns."""
    seen = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out)
        return out
    return mock.patch.object(module, name, spy), seen


def recon_err_k(a, u, s, v, k):
    return float(np.linalg.norm(a - (u[:, :k] * s[:k]) @ v[:, :k].T))


def f64(t):
    return to_numpy(t).astype(np.float64) if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float64)


def ratio_vs_numpy(a, factors, omega, q, k):
    """The factorization's error over a numpy f64 rSVD's on the same
    Omega, at rank k."""
    u_n, s_n, v_n = numpy_rsvd(a, omega.shape[1], q, omega=f64(omega))
    return recon_err_k(a, *(f64(x) for x in factors), k) / recon_err_k(
        a, u_n, s_n, v_n, k)


def timed(fn):
    """(result, wall seconds) of fn() ending in a synchronize."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_image():
    """The image codec on the card: the CLI's steps on a 4096^2 photo
    (the counted run, K5 on the factors included), then compress() on a
    1024^2 crop and a 1024^2 x 3 color image, and compress_video."""
    img = photo((IMG_SIDE, IMG_SIDE), seed=11)
    out = {}
    codec = get_codec()
    reset_counts()
    # -- the counted run: normalize, compress_tiled, restore, codec, K5
    im = image.Image(img).normalize()
    draws, omegas = capture(image, "sketch_matrix")
    with draws:
        _, wall = timed(lambda: im.compress_tiled(k=IMG_K, grid=IMG_GRID))
    tf = im.tile_factors
    gy, gx = IMG_GRID
    th, tw = IMG_SIDE // gy, IMG_SIDE // gx
    tiles = (im.data.reshape(gy, th, gx, tw).swapaxes(1, 2)
             .reshape(gy * gx, th, tw))
    ratios = [ratio_vs_numpy(tiles[i], (tf.u[i], tf.s[i], tf.v[i]),
                             omegas[i], 1, IMG_K) for i in range(gy * gx)]
    psnr, cratio = im.psnr(), im.compression_ratio()
    im.restore()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "factors.rsv")
        _, save_s = timed(lambda: im.save_compressed(path))
        back, load_s = timed(lambda: image.Image().load_compressed(path))
        file_bytes = os.path.getsize(path)
    round_trip = 0.0
    for orig, got in zip((tf.u, tf.s, tf.v), (back.tile_factors.u,
                                              back.tile_factors.s,
                                              back.tile_factors.v)):
        step = (float(orig.max()) - float(orig.min())) / 255.0
        round_trip = max(round_trip, float(np.abs(got - orig).max())
                         / (step / 2))
    k5 = {}
    for name, f in (("u", tf.u), ("s", tf.s), ("v", tf.v)):
        t = torch.from_numpy(f).cuda()
        q, bad = k5_equal(t, False)
        qs, bad_s = k5_equal(t, True, seed=1)
        q_host, _, _ = codec.quantize_affine(f)
        diff = (q.cpu().numpy().astype(int) - q_host.astype(int))
        k5[name] = dict(shape=list(f.shape), max_diff_vs_plain=max(bad,
                                                                   bad_s),
                        max_level_diff_vs_host=int(np.abs(diff).max()),
                        share_bytes_ne_host=float(np.mean(diff != 0)),
                        max_k5b_minus_k5a=int((qs.int() - q.int()).abs()
                                              .max()))
    launches = counts()
    tiled = dict(shape=[IMG_SIDE, IMG_SIDE], k=IMG_K, grid=list(IMG_GRID),
                 compress_tiled_s=wall, err_ratio_vs_numpy_per_tile=ratios,
                 psnr_db=psnr, compression_ratio=cratio,
                 save_compressed_s=save_s, load_compressed_s=load_s,
                 file_bytes=file_bytes,
                 round_trip_err_over_half_step=round_trip, k5_on_factors=k5,
                 launches_k1_to_k5b=list(launches))
    log("  image [CLI steps, 4096^2, tiled]: " + json.dumps(tiled))
    check(launches == launches_of(k5a=3, k5b=3),
          f"image path launches {launches}")
    check(max(ratios) <= ERR_RATIO_MAX, f"image tiles: err ratios {ratios}")
    check(round_trip <= 1 + 1e-6, f"codec round trip {round_trip}")
    check(all(v["max_diff_vs_plain"] == 0 and v["max_level_diff_vs_host"] <= 1
              and v["max_k5b_minus_k5a"] <= 1 for v in k5.values()),
          f"K5 on the factors {k5}")
    tiled["profile"] = profile_call(lambda: image.Image(img).normalize()
                                    .compress_tiled(k=IMG_K, grid=IMG_GRID),
                                    reps=1)
    log("  profile [compress_tiled, 4096^2]: " + json.dumps(tiled["profile"]))
    out["tiled"] = tiled

    # -- whole image: a 1024^2 crop at the default k, and color
    side = COLOR_SIDE
    crop = image.Image(img[:side, :side]).normalize()
    draws, omegas = capture(driver, "generate_omega")
    reset_counts()
    with draws:
        _, wall = timed(crop.compress)
    k = side // 4
    ratio = ratio_vs_numpy(crop.data, (crop.U, crop.S, crop.V), omegas[0],
                           1, k)
    out["gray_crop"] = dict(shape=[side, side], k=k, l=omegas[0].shape[1],
                            compress_s=wall, err_ratio_vs_numpy=ratio,
                            psnr_db=crop.psnr(),
                            compression_ratio=crop.compression_ratio(),
                            launches_k1_to_k5b=list(counts()))
    log("  image [compress(), 1024^2 crop]: " + json.dumps(out["gray_crop"]))
    check(counts() == NONE and ratio <= ERR_RATIO_MAX,
          f"gray crop {out['gray_crop']}")

    rng = np.random.default_rng(12)
    base = img[-side:, -side:]
    color = np.clip(np.stack([base * g + o for g, o in
                              ((1.0, 0.0), (0.8, 20.0), (0.6, 40.0))], 2)
                    + rng.normal(0.0, 2.0, (side, side, 3)), 0, 255)
    cim = image.Image(color).normalize()
    draws, omegas = capture(image, "sketch_matrix")
    reset_counts()
    with draws:
        _, wall = timed(cim.compress)
    chans = np.moveaxis(cim.data, 2, 0)
    ratios = [ratio_vs_numpy(chans[c], (cim.U[c], cim.S[c], cim.V[c]),
                             omegas[0], 1, k) for c in range(3)]
    out["color"] = dict(shape=[side, side, 3], k=k, compress_s=wall,
                        err_ratio_vs_numpy_per_channel=ratios,
                        psnr_db=cim.psnr(),
                        compression_ratio=cim.compression_ratio(),
                        launches_k1_to_k5b=list(counts()))
    log("  image [compress(), color 1024^2 x 3]: " + json.dumps(out["color"]))
    check(counts() == NONE and max(ratios) <= ERR_RATIO_MAX,
          f"color {out['color']}")

    # -- video: 8 frames of 1080 x 1920 panning over one photo
    t, h, w = VIDEO
    pan = photo((h, w + 16 * t), seed=13)
    frames = np.stack([pan[:, 16 * i:16 * i + w] + rng.normal(0, 2, (h, w))
                       for i in range(t)])
    draws, omegas = capture(image, "sketch_matrix")
    reset_counts()
    with draws:
        (u, s, v), wall = timed(lambda: image.compress_video(frames,
                                                             k=VIDEO_K))
    ratios = [ratio_vs_numpy(frames[i], (u[i], s[i], v[i]), omegas[0], 1,
                             VIDEO_K) for i in range(t)]
    rec = image.reconstruct_video(u, s, v)
    mse = float(np.mean((rec - frames) ** 2))
    out["video"] = dict(shape=list(VIDEO), k=VIDEO_K, compress_video_s=wall,
                        err_ratio_vs_numpy_per_frame=ratios,
                        psnr_db=10.0 * np.log10(255.0 ** 2 / mse),
                        compression_ratio=frames.size / (u.size + s.size
                                                         + v.size),
                        launches_k1_to_k5b=list(counts()))
    log("  image [compress_video, 8 x 1080 x 1920]: "
        + json.dumps(out["video"]))
    check(counts() == NONE and max(ratios) <= ERR_RATIO_MAX,
          f"video {out['video']}")
    return launches, out


def phase_driver_modes(a, a64, err_np):
    """rsvd_batched (both modes), rsvd_warm, rsvd_onepass and
    rsvd_adaptive, each with its error against a numpy f64 yardstick."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(8)
    stack = torch.randn(BATCH, BATCH_SIDE, BATCH_SIDE, device="cuda",
                        generator=gen)
    stack64 = to_numpy(stack).astype(np.float64)
    err_np_el = None
    for mode in ("scan", "vmap"):
        draws, omegas = capture(driver, "generate_omega")
        reset_counts()
        with draws:
            (u, s, v), wall = timed(lambda: rsvd_batched(stack, k=K,
                                                          mode=mode))
        launches = counts()
        if err_np_el is None:            # the same Omega in both modes
            err_np_el = []
            for i in range(BATCH):
                u_n, s_n, v_n = numpy_rsvd(stack64[i], omegas[i].shape[1], Q,
                                           omega=f64(omegas[i]))
                err_np_el.append(recon_err_k(stack64[i], u_n, s_n, v_n, K))
        ratios = [recon_err_k(stack64[i], f64(u[i]), f64(s[i]), f64(v[i]), K)
                  / err_np_el[i] for i in range(BATCH)]
        res = dict(batch=[BATCH, BATCH_SIDE, BATCH_SIDE], k=K, wall_s=wall,
                   ms=cuda_ms(lambda: rsvd_batched(stack, k=K, mode=mode), 2),
                   max_err_ratio_vs_numpy=max(ratios),
                   launches_k1_to_k5b=list(launches))
        log(f"  rsvd_batched [{mode}]: " + json.dumps(res))
        check(launches == NONE and max(ratios) <= ERR_RATIO_MAX,
              f"rsvd_batched {mode}: {res}")
        out[f"batched_{mode}"] = res
    del stack, stack64

    noise = torch.randn(M, N, device="cuda", generator=gen)
    u_prev, _, _ = rsvd(a + 1e-3 * noise, k=0, p=K + P, method="eigh",
                        seed=1)
    reset_counts()
    (u, s, v), wall = timed(lambda: rsvd_warm(a, u_prev, k=K, q=1))
    launches = counts()
    ratio = recon_err(a64, f64(u), f64(s), f64(v)) / err_np
    res = dict(k=K, l=K + P, q=1, wall_s=wall,
               ms=cuda_ms(lambda: rsvd_warm(a, u_prev, k=K, q=1), 3),
               err_ratio_vs_numpy_q2=ratio, launches_k1_to_k5b=list(launches))
    log("  rsvd_warm: " + json.dumps(res))
    check(launches == NONE and ratio <= ERR_RATIO_MAX, f"rsvd_warm {res}")
    out["warm"] = res

    u_n, s_n, v_n = numpy_rsvd(a64, K + P, 0)
    err_np_q0 = recon_err(a64, u_n, s_n, v_n)
    reset_counts()
    (u, s, v), wall = timed(lambda: rsvd_onepass(a, k=K))
    launches = counts()
    ratio = recon_err(a64, f64(u), f64(s), f64(v)) / err_np_q0
    res = dict(k=K, l=K + 16, wall_s=wall,
               ms=cuda_ms(lambda: rsvd_onepass(a, k=K), 3),
               err_ratio_vs_numpy_q0=ratio, launches_k1_to_k5b=list(launches))
    log("  rsvd_onepass: " + json.dumps(res))
    check(launches == NONE and ratio <= ONEPASS_RATIO_MAX,
          f"rsvd_onepass {res}")
    out["onepass"] = res

    rank = 512
    uq, _ = torch.linalg.qr(torch.randn(M, rank, device="cuda",
                                        generator=gen))
    vq, _ = torch.linalg.qr(torch.randn(N, rank, device="cuda",
                                        generator=gen))
    s_true = ADAPTIVE_RATIO ** torch.arange(rank, device="cuda",
                                            dtype=torch.float64)
    a_geo64 = (uq.double() * s_true) @ vq.double().T
    a_geo = a_geo64.float()
    reset_counts()
    (u, s, v, k, stats), wall = timed(lambda: rsvd_adaptive(
        a_geo, tol=ADAPTIVE_TOL, return_stats=True))
    launches = counts()
    rel = float(torch.linalg.norm(a_geo64 - (u.double() * s.double())
                                  @ v.double().T) / torch.linalg.norm(a_geo64))
    res = dict(spectrum=f"{ADAPTIVE_RATIO}^i, rank {rank}", tol=ADAPTIVE_TOL,
               k=k, stats=stats, wall_s=wall, rel_err_f64=rel,
               launches_k1_to_k5b=list(launches))
    log("  rsvd_adaptive: " + json.dumps(res))
    check(launches == NONE and rel <= ADAPTIVE_TOL, f"rsvd_adaptive {res}")
    out["adaptive"] = res
    return out

def pca_operand(seed=0):
    """X = 1 mu^T + G diag(0.97^i) W^T + 0.01 E on the card: G and E
    Gaussian, W orthogonal, mu a per-feature offset of scale 5."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w, _ = torch.linalg.qr(torch.randn(PCA_D, PCA_D, device="cuda",
                                       generator=gen))
    mu = PCA_OFFSET * torch.randn(PCA_D, device="cuda", generator=gen)
    decay = PCA_DECAY ** torch.arange(PCA_D, device="cuda",
                                      dtype=torch.float32)
    x = torch.randn(PCA_ROWS, PCA_D, device="cuda", generator=gen) * decay
    x = device.matmul_at(x, w.T, "highest")
    x += PCA_NOISE * torch.randn(PCA_ROWS, PCA_D, device="cuda",
                                 generator=gen)
    return x + mu


def centred64(x, normalize=False):
    """X centred (and z-scored) in f64 on the card."""
    x64 = x.double()
    x64 -= x64.mean(dim=0)
    if normalize:
        sd = x64.std(dim=0, correction=1)
        x64 /= torch.where(sd > 0, sd, torch.ones_like(sd))
    return x64


def f64_spectrum(x, normalize=False):
    """(singular values, variance ratios) of the centred X: its Gram
    formed in f64 on the card, eigh in numpy."""
    x64 = centred64(x, normalize)
    g = to_numpy(x64.T @ x64)
    del x64
    lam = np.clip(np.linalg.eigvalsh(g)[::-1], 0.0, None)
    return np.sqrt(lam), lam / np.trace(g)


def stage_timer(stages):
    """patch(module, name, key): ``module.name`` timed into
    ``stages[key]`` (seconds, synchronized)."""
    def patch(module, name, key):
        real = getattr(module, name)

        def spy(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            stages.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return mock.patch.object(module, name, spy)
    return patch


def pca_run(x, normalize, sig_true, ratio_true):
    """One PCA(X) at its defaults, timed by stage, and its checks."""
    stages = {}
    patch = stage_timer(stages)
    with patch(pca, "svd", "svd"), patch(jacobi, "qr_reduced", "qr"), \
            patch(jacobi, "_block_jacobi_core", "core"), \
            patch(jacobi, "_block_sweep", "block"), \
            patch(jacobi, "_polish_sweep", "polish"):
        p, wall = timed(lambda: pca.PCA(x, normalize=normalize))
    s = f64(p.getS())
    dsig = float(np.abs(s - sig_true).max() / sig_true[0])
    dratio = float(np.abs(f64(p.explained_variance_ratio())
                          - ratio_true).max())
    orth = p.check_orthogonality()
    xc = x - p.mean
    if normalize:
        xc /= torch.std(xc, dim=0, correction=1)
    rec = device.matmul_at(p.getU() * p.getS(), p.getV().T, "highest")
    recon = float(torch.linalg.norm(xc - rec) / torch.linalg.norm(xc))
    del xc, rec
    block, polish = sum(stages["block"]), sum(stages["polish"])
    out = dict(
        normalize=normalize, wall_s=wall, max_rel_dsigma_vs_f64=dsig,
        max_abs_dratio_vs_f64=dratio, check_orthogonality=orth,
        recon_rel=recon, block_sweeps=len(stages["block"]),
        polish_sweeps=len(stages["polish"]),
        seconds_by_stage=dict(
            centre=wall - stages["svd"][0], qr_precondition=stages["qr"][0],
            block_sweeps=block, polish_sweeps=polish,
            engine_other=stages["core"][0] - block - polish,
            u_from_q0=stages["svd"][0] - stages["qr"][0]
            - stages["core"][0]),
        block_sweep_s=stages["block"], polish_sweep_s=stages["polish"],
        pc1_ratio=float(p.explained_variance_ratio()[0]))
    log(f"  PCA(X{', normalize=True' if normalize else ''}) "
        f"{PCA_ROWS}x{PCA_D}: " + json.dumps(out))
    check(dsig <= PCA_SIG_TOL and dratio <= PCA_RATIO_TOL
          and orth <= PCA_ORTH_TOL and recon <= PCA_RECON_TOL,
          f"PCA {out}")
    return p, out


def sweep_profile(r):
    """One torch.profiler pass over a block sweep and over the first
    POLISH_PROFILE_ROUNDS rounds of a polish sweep of the engine on R
    (after one of each as warm-up).  A polish round is the same work
    every time; the profiler's own cost grows with the ~53 launches a
    round, so the whole 1023-round sweep is not traced."""
    out = {}
    n = r.shape[1]
    for label, sched, sweep in (
            ("block_sweep", jacobi._schedule(n // 64, "cuda"),
             lambda w, v, sc: jacobi._block_sweep(w, v, sc, 64)),
            ("polish_sweep", jacobi._schedule(n, "cuda")[
                :POLISH_PROFILE_ROUNDS], jacobi._polish_sweep)):
        w, v = r.clone(), torch.eye(n, device="cuda")
        sweep(w, v, sched)
        out[label] = profile_call(lambda: sweep(w, v, sched), reps=1)
        out[label]["rounds"] = int(sched.shape[0])
        log(f"  profile [{label}, n={n}]: " + json.dumps(out[label]))
    return out


def f64_rsvd_err(x64, omega, q, k):
    """||Xc - U_k S_k V_k^T||_F of the numpy_rsvd steps in f64 on the
    card, on the same Omega."""
    qm, _ = torch.linalg.qr(x64 @ omega)
    for _ in range(q):
        qz, _ = torch.linalg.qr(x64.T @ qm)
        qm, _ = torch.linalg.qr(x64 @ qz)
    ut, s, vt = torch.linalg.svd(qm.T @ x64, full_matrices=False)
    u = qm @ ut[:, :k]
    return float(torch.linalg.norm(x64 - (u * s[:k]) @ vt[:k]))


def streaming_run(x, dtype, lam_true, fd_bound):
    """StreamingPCA(1024, l=128) over X in 4096-row batches."""
    sp = pca.StreamingPCA(PCA_D, l=STREAM_L, dtype=dtype)

    def feed():
        for i in range(0, PCA_ROWS, STREAM_BATCH):
            sp.update(x[i:i + STREAM_BATCH])
    _, wall = timed(feed)
    lam, _ = sp.finalize(STREAM_K)
    true = lam_true[:STREAM_K]
    shrinks = PCA_ROWS // STREAM_L - 1
    return dict(dtype=str(dtype), wall_s=wall, shrinks=shrinks,
                ms_per_shrink=1e3 * wall / shrinks,
                max_rel_over_true=float(np.max((lam - true) / true)),
                max_under_true_over_fd_bound=float(
                    np.max(true - lam) / fd_bound))


CLI_LINE = re.compile(r"^(\S+): (\d+)x(\d+) l=(\d+) \|\|A-USV\^T\|\| = "
                      r"(\S+)  \((\S+) ms\)")


def cli_errors(text):
    """{stem: (error, ms)} of the rsvd command line's output."""
    rows = {}
    for line in text.splitlines():
        hit = CLI_LINE.match(line)
        if hit:
            rows[hit.group(1)] = (float(hit.group(5)), float(hit.group(6)))
    return rows


def start_cli(*args):
    """``python -m rsvd_kamaneh_raganato_terrana_tpu_torch <args>`` from
    this script's directory, started; ``finish_cli`` waits for it."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    proc = subprocess.Popen(
        [sys.executable, "-m", "rsvd_kamaneh_raganato_terrana_tpu_torch",
         *args], cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return proc, args, time.perf_counter()


def finish_cli(started):
    """(stdout, seconds) of a CLI ``start_cli`` started; it must exit 0."""
    proc, args, t0 = started
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    check(proc.returncode == 0, f"CLI {args}: rc {proc.returncode}\n"
          f"{out}\n{err}")
    return out, time.perf_counter() - t0


def phase_clis():
    """The rsvd and pca command lines: two subprocesses run together,
    then the kernel flags of the rsvd one in-process, counted."""
    out = {}
    here = os.path.dirname(os.path.abspath(__file__))
    inputs = os.path.join(here, "data", "input")
    names = sorted(f for f in os.listdir(inputs) if f.endswith(".mtx"))
    gen = torch.Generator(device="cuda").manual_seed(21)
    big = to_numpy(torch.randn(MTX_SIDE, MTX_SIDE, device="cuda",
                               generator=gen))
    # both command lines at once, the pca one started first: each spends
    # most of its time starting torch and the card, and the rsvd one
    # waits for the 2048^2 .mtx
    pca_cli = start_cli("pca", os.path.join(here, "data", "pca",
                                            "tourists.txt"), "yes")
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            os.symlink(os.path.join(inputs, name), os.path.join(tmp, name))
        path = os.path.join(tmp, f"dense{MTX_SIDE}.mtx")
        _, write_s = timed(lambda: write_matrix_market(path, big))
        back, read_s = timed(lambda: read_matrix_market(path))
        check(np.array_equal(back, big.astype(np.float64))
              and np.array_equal(back.astype(np.float32), big),
              "the 2048^2 .mtx does not read back bitwise")
        rsvd_cli = start_cli("rsvd", tmp)
        text, wall = finish_cli(rsvd_cli)
        pca_text, pca_wall = finish_cli(pca_cli)
    rows = cli_errors(text)
    norms = {n[:-4]: float(np.linalg.norm(read_matrix_market(
        os.path.join(inputs, n)))) for n in names}
    out["rsvd"] = dict(subprocess_s=wall, write_2048_mtx_s=write_s,
                       read_2048_mtx_s=read_s, errors_ms=rows,
                       sparse_matrix_err_over_norm=rows["sparse_matrix"][0]
                       / norms["sparse_matrix"])
    log("  cli [rsvd data/input + 2048^2 .mtx]: " + json.dumps(out["rsvd"]))
    check(set(rows) == set(norms) | {f"dense{MTX_SIDE}"}
          and all(np.isfinite(e) for e, _ in rows.values())
          and out["rsvd"]["sparse_matrix_err_over_norm"] <= CLI_ERR_TOL,
          f"rsvd CLI {out['rsvd']}")

    ratio_line = next(ln for ln in pca_text.splitlines()
                      if ln.startswith("Proportion of Variance"))
    pc1 = float(ratio_line.split()[3])
    out["pca"] = dict(subprocess_s=pca_wall, pc1_ratio=pc1)
    log("  cli [pca tourists.txt yes]: " + json.dumps(out["pca"]))
    check(abs(pc1 - TOURISTS_PC1) <= TOURISTS_TOL, f"pca CLI {out['pca']}")

    reset_counts()
    buf, err_buf = io.StringIO(), io.StringIO()
    k1_calls, k3_calls = Recorder(kernels.fused_cholqr1), \
        Recorder(kernels.eigh_small)
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(err_buf), \
            mock.patch.object(kernels, "fused_cholqr1", k1_calls), \
            mock.patch.object(kernels, "eigh_small", k3_calls):
        rc = cli.main(["rsvd", inputs, "--method", "eigh_pallas",
                       "--qr-method", "cholqr1_fused"])
    torch.cuda.synchronize()
    launches = counts()
    want = launches_of(k1=(1 + 2 * Q) * len(names), k3=len(names))
    flagged = cli_errors(buf.getvalue())
    hints = err_buf.getvalue().count("hint: cholqr1_fused has no rank")
    nan_stems = sorted(t for t, (e, _) in flagged.items()
                       if not np.isfinite(e))
    vs_default = {t: abs(e - rows[t][0]) / abs(rows[t][0])
                  for t, (e, _) in flagged.items() if np.isfinite(e)}
    out["kernel_flags"] = dict(
        launches_k1_to_k5b=list(launches), expected=list(want),
        errors_ms=flagged, rel_err_vs_default_flags=vs_default,
        nan_files=nan_stems, cholqr_hints=hints,
        k1_vs_plain=recorded_vs_plain(k1_calls, cholqr1_vs_plain),
        k3_vs_plain=recorded_vs_plain(k3_calls, eigh_vs_plain))
    log("  cli [rsvd data/input --method eigh_pallas --qr-method "
        "cholqr1_fused, in-process]: " + json.dumps(out["kernel_flags"]))
    check(rc == 0 and launches == want,
          f"CLI kernel flags: launches {launches}, not {want}")
    check(len(k1_calls.calls) == want[0] and len(k3_calls.calls) == want[2],
          f"CLI kernel flags: {len(k1_calls.calls)} K1 and "
          f"{len(k3_calls.calls)} K3 calls recorded")
    check(set(flagged) == set(norms)
          and all(d <= SIGMA_TOL["highest"] for d in vs_default.values())
          and nan_stems in ([], ["sparse_matrix"])
          and hints == len(nan_stems),
          f"CLI kernel flags: errors against the default flags' "
          f"{out['kernel_flags']}")
    return launches, out


class Recorder:
    """A kernel wrapper that keeps each call's input and output; its
    launch count is the wrapper's own, which the wrapper adds to as it
    launches."""

    def __init__(self, wrapper):
        self.wrapper, self.calls = wrapper, []

    launches = property(lambda self: self.wrapper.launches,
                        lambda self, n: setattr(self.wrapper, "launches", n))

    def __call__(self, x, *args, **kwargs):
        x_in = x.clone()
        out = self.wrapper(x, *args, **kwargs)
        self.calls.append((x_in, args, kwargs, out))
        return out


def finite(*ts):
    return all(bool(torch.isfinite(t).all()) for t in ts)


def cholqr1_vs_plain(y, args, kwargs, out):
    """(shape, max |dQ|, max |dR| / max |R|) of one recorded K1 call
    against its plain version on the same panel; a non-finite plain
    result (a rank-deficient panel) must be non-finite from K1 too."""
    q, r = out
    q0, r0 = kernels.fused_cholqr1_reference(y, *args, **kwargs)
    if not finite(q0, r0):
        check(not finite(q, r), f"K1 {tuple(y.shape)}: finite output where "
              f"the plain version's is not")
        return tuple(y.shape), None, None
    dq = float((q - q0).abs().max())
    dr = float((r - r0).abs().max()) / float(r0.abs().max())
    check(finite(q, r) and dq <= Q_TOL and dr <= R_TOL,
          f"K1 {tuple(y.shape)} in the CLI run: dQ={dq} dR/R={dr}")
    return tuple(y.shape), dq, dr


def eigh_vs_plain(g, args, kwargs, out):
    """(n, bitwise equal, max |dlam| / max |lam|) of one recorded K3 call
    against its plain version on the same matrix: bitwise at even n."""
    lam, v = out
    lam0, v0 = kernels.eigh_small_reference(g, *args, **kwargs)
    n = g.shape[0]
    if not finite(lam0, v0):
        check(not finite(lam, v), f"K3 n={n}: finite output where the "
              f"plain version's is not")
        return n, None, None
    same = torch.equal(lam, lam0) and torch.equal(v, v0)
    dlam = float((lam - lam0).abs().max()) / (float(lam0.abs().max()) or 1.0)
    check(finite(lam, v) and dlam <= K3_LAM_TOL and (same or n % 2),
          f"K3 n={n} in the CLI run: bitwise {same}, dlam={dlam}")
    return n, same, dlam


def recorded_vs_plain(recorder, compare):
    """Every recorded call of a kernel held to its plain version."""
    torch.cuda.synchronize()
    return [compare(*call) for call in recorder.calls]


def phase_pca():
    """Phase 7: PCA, its randomized and streaming paths, the chunked
    engine and the command lines."""
    out = {}
    x, made = timed(pca_operand)
    (sig_true, ratio_true), f64_s = timed(lambda: f64_spectrum(x))
    log(f"  X {PCA_ROWS}x{PCA_D} f32 made in {made:.2f} s; f64 yardstick "
        f"{f64_s:.2f} s: s_1 = {sig_true[0]:.4f}, s_d = {sig_true[-1]:.4f}")
    p, out["default"] = pca_run(x, False, sig_true, ratio_true)
    s_engine = f64(p.getS())
    del p
    sig_n, ratio_n = f64_spectrum(x, normalize=True)
    _, out["normalize"] = pca_run(x, True, sig_n, ratio_n)

    phase("phase 7: the block engine on R (profile, chunked)")
    xc = x - x.mean(dim=0)
    _, r = qr_reduced(xc, "robust")
    del xc
    out["profile"] = sweep_profile(r)
    progress = []

    def report(phase_name, sweep, measure):
        progress.append([phase_name, sweep, measure])
        log(f"    chunked {phase_name} sweep {sweep}: {measure:.3e}")
    (_, s_c, _), wall = timed(lambda: jacobi.jacobi_svd_chunked(
        r, progress=report))
    d_chunked = float(np.max(np.abs(f64(s_c) - s_engine) / s_engine))
    out["chunked"] = dict(wall_s=wall, max_rel_dsigma_vs_engine=d_chunked,
                          progress=progress)
    log("  jacobi_svd_chunked(R): " + json.dumps(out["chunked"]))
    check(d_chunked <= CHUNKED_TOL, f"chunked {out['chunked']}")
    del r

    draws, omegas = capture(driver, "generate_omega")
    with draws:
        p, wall = timed(lambda: pca.PCA(x, use_rsvd=True, rank=PCA_RANK))
    x64 = centred64(x)
    u, s, v = (t.double() for t in (p.getU(), p.getS(), p.getV()))
    err = float(torch.linalg.norm(x64 - (u * s) @ v.T))
    err_f64 = f64_rsvd_err(x64, omegas[0].double(), Q, PCA_RANK)
    del x64, u, v, p
    out["use_rsvd"] = dict(rank=PCA_RANK, l=int(omegas[0].shape[1]),
                           wall_s=wall, err_ratio_vs_f64=err / err_f64)
    log("  PCA(X, use_rsvd=True, rank=64): " + json.dumps(out["use_rsvd"]))
    check(err / err_f64 <= ERR_RATIO_MAX, f"use_rsvd {out['use_rsvd']}")

    phase("phase 7: StreamingPCA")
    lam_true = sig_true ** 2 / (PCA_ROWS - 1)
    fd_bound = float(np.sum(lam_true[STREAM_K:]) / (STREAM_L - STREAM_K))
    out["streaming"] = {}
    for dtype in (torch.float64, torch.float32):
        res = streaming_run(x, dtype, lam_true, fd_bound)
        out["streaming"][str(dtype)] = res
        log(f"  StreamingPCA({PCA_D}, l={STREAM_L}) {dtype}: "
            + json.dumps(res))
        check(res["max_rel_over_true"] <= STREAM_OVER_TOL
              and res["max_under_true_over_fd_bound"] <= 1.0,
              f"StreamingPCA {res}")
    del x
    torch.cuda.empty_cache()
    phase("phase 7: the command lines")
    launches, out["cli"] = phase_clis()
    return launches, out


def phase_main_path(label, forward, a, a64, err_np, prec, want):
    """Phase 3 for one configuration: the counted run, accuracy, the plain
    path, timings.  ``want`` = (K1, K2, K3, K4, K5a, K5b) launches per
    call.  Returns (those launches, summary dict)."""
    reset_counts()
    u, s, v = forward(a)
    torch.cuda.synchronize()
    launches = counts()
    check(launches == want, f"{label}: (K1, K2, K3, K4, K5a, K5b) launches "
          f"{launches}, not {want}")
    check(u.shape == (M, K) and s.shape == (K,) and v.shape == (N, K),
          f"shapes {u.shape} {s.shape} {v.shape}")
    check(all(bool(torch.isfinite(x).all()) for x in (u, s, v)),
          "non-finite factors")
    u_np, s_np, v_np = (to_numpy(x).astype(np.float64) for x in (u, s, v))
    err_ratio = recon_err(a64, u_np, s_np, v_np) / err_np
    orth = float(np.abs(u_np.T @ u_np - np.eye(K)).max())
    with plain_kernels():
        _, s_plain, _ = forward(a)
        plain_ms = cuda_ms(lambda: forward(a), 5)
    dsigma = float((s - s_plain).abs().max() / s_plain[0])
    ms = cuda_ms(lambda: forward(a), 10)
    out = dict(err_ratio_vs_numpy=err_ratio, max_rel_dsigma_vs_plain=dsigma,
               u_orth=orth, ms=ms, plain_ms=plain_ms,
               launches_k1_to_k5b=list(launches))
    check(err_ratio <= ERR_RATIO_MAX, f"err ratio {out}")
    check(dsigma <= SIGMA_TOL[prec], f"sigma vs plain {out}")
    check(orth <= 1e-3, f"U orthogonality {out}")
    return launches, out


def serving_run(label, operand, a64, err_np, interior):
    """One counted serving call and its checks; returns (K2 launches,
    summary dict)."""
    storage = label

    def call():
        return rsvd_serving(operand, k=K, p=P, q=Q, interior_qr=interior,
                            storage=storage)

    reset_counts()
    u, s, v, health = call()
    torch.cuda.synchronize()
    launches = counts()
    k2 = launches[1]
    want = 2 if interior == "polar_fused" else 0
    check(launches == launches_of(k2=want),
          f"serving {label}/{interior}: launches {launches}")
    check(health["ok"], f"serving {label}/{interior}: unhealthy {health}")
    u_np, s_np, v_np = (to_numpy(x).astype(np.float64) for x in (u, s, v))
    err = recon_err(a64, u_np, s_np, v_np)
    out = dict(storage=storage, interior_qr=interior,
               err_ratio_vs_numpy=err / err_np, health=health,
               ms=cuda_ms(call, 10), k2_launches=k2)
    if interior == "polar_fused":
        with plain_kernels():
            u0, s0, v0, _ = call()
            out["plain_ms"] = cuda_ms(call, 5)
        err0 = recon_err(a64, *(to_numpy(x).astype(np.float64)
                                for x in (u0, s0, v0)))
        out["rel_err_diff_vs_plain"] = abs(err / err0 - 1.0)
        check(out["rel_err_diff_vs_plain"] <= SERVING_PLAIN_TOL,
              f"serving {label}: kernel vs plain K2 {out}")
    check(out["err_ratio_vs_numpy"] <= ERR_RATIO_MAX,
          f"serving {label}/{interior}: err ratio {out}")
    return k2, out


def phase_drawn_point(rows, cols, k, seed):
    """Int8 serving of a rows x cols operand drawn on the card, k, p=16,
    q=2, against the port's own 'highest' finish='project' rSVD."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(rows, cols, device="cuda", generator=gen)
    quant_ms = cuda_ms(lambda: prepare_operand(a), 3)
    a8 = prepare_operand(a)

    def call():
        return rsvd_serving(a8, k=k, p=P, q=Q)

    u, s, v, health = call()
    check(health["ok"], f"{rows}x{cols} int8 serving: unhealthy {health}")
    ms = cuda_ms(call, 5)
    u_r, s_r, v_r = rsvd(a, k=k, p=P, q=Q, method="eigh",
                         qr_method="robust", precision="highest",
                         finish="project")
    with device.ieee_fp32():
        ratio = float(reconstruction_error(a, u, s, v)
                      / reconstruction_error(a, u_r, s_r, v_r))
    out = dict(shape=[rows, cols], k=k, quantize_ms=quant_ms, ms=ms,
               err_ratio_vs_highest_project=ratio, health_ok=health["ok"],
               stored_layout_shapes=[list(x.shape) for x in a8.layouts],
               stored_bytes=sum(x.numel() for x in a8.layouts),
               profile=profile_call(lambda: rsvd_serving(
                   a8, k=k, p=P, q=Q, interior_qr="cholqr1")))
    check(ratio <= ERR_RATIO_MAX, f"{rows}x{cols} int8 serving {out}")
    del a, a8
    torch.cuda.empty_cache()
    return out


# device kernels by name: (substrings, group), first match wins
KERNEL_GROUPS = (
    (("jacobi_eigh",), "K3 jacobi_eigh"),
    (("sketch_cluster", "sum_splits"), "K4 sketch_cluster / sum_splits"),
    (("ns_cluster", "ns_iterate"), "K2 ns_cluster / ns_iterate"),
    (("quantize_u8",), "K5 quantize_u8"),
    (("eliminate",), "K1 eliminate_cluster / eliminate_wide"),
    (("gram_cluster", "gram_partials"),
     "K1/K2 Gram (gram_cluster, gram_partials)"),
    (("apply_rows", "apply_right"), "K1/K2 apply (apply_rows, apply_right)"),
    (("syevj", "syevd", "sytrd", "stedc", "ormtr", "orgtr"),
     "cuSOLVER eigh"),
    (("i8", "s8", "imma", "int8"), "int8 GEMMs"),
    (("potrf", "getrf", "trsm", "trtri", "cholesky", "syrk"),
     "cholqr1 factor and solve"),
    (("gemm", "nvjet", "xmma"), "other GEMMs"),
)


def kernel_group(name):
    name = name.lower()
    for keys, group in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return group
    return "other kernels"


def profile_call(call, reps=10):
    """One torch.profiler pass over ``reps`` calls: device time by kernel
    group, host syncs and the device idle share."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {}
    busy = 0.0
    syncs = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dur = e.time_range.elapsed_us()
            busy += dur
            key = kernel_group(e.name)
            groups[key] = groups.get(key, 0.0) + dur
        elif "Synchronize" in e.name or e.name == "aten::_local_scalar_dense":
            syncs += 1
    per_call_us = reps * 1e3
    out = {k: v / per_call_us for k, v in sorted(groups.items(),
                                                 key=lambda kv: -kv[1])}
    summary = dict(ms_per_call_by_group=out,
                   wall_ms_per_call=wall_us / per_call_us,
                   device_busy_ms_per_call=busy / per_call_us,
                   idle_share=(1.0 - busy / wall_us) if busy else None,
                   host_sync_events_per_call=syncs / reps)
    if not busy:
        log("  profiler saw no device time")
    top = sorted(((e.key, e.device_time_total if hasattr(
        e, "device_time_total") else 0.0) for e in prof.key_averages()),
        key=lambda kv: -kv[1])[:12]
    for key, t in top:
        log(f"    {t / per_call_us:9.4f} ms/call  {key[:90]}")
    return summary


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count {torch.cuda.device_count()}")

    phase("phase 1: build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"  built {[p.name for p in libs]} in "
        f"{time.perf_counter() - t0:.2f} s")
    for src, text in _build.build_logs.items():
        log(f"  nvcc {src}:\n" + "\n".join(
            "    " + line for line in text.strip().splitlines()))

    phase("phase 2: kernels against their plain versions")
    fwd_hi, (a,) = entry(device="cuda", m=M, n=N, precision="highest")
    y_main, all_panels = panels(a)
    k1 = phase_k1(y_main, all_panels)
    k2 = phase_k2(y_main, all_panels)
    del all_panels
    k3 = phase_k3(tail_gram(a))
    k4 = phase_k4(a)
    k5 = phase_k5()
    if "--kernels-only" in argv:
        phase("stopping after phase 2 (--kernels-only)")
        return 0

    phase("phase 3: main path")
    a64 = to_numpy(a).astype(np.float64)
    t0 = time.perf_counter()
    u_n, s_n, v_n = numpy_rsvd(a64, K + P, Q)
    err_np = recon_err(a64, u_n, s_n, v_n)
    log(f"  numpy f64 rSVD baseline: err {err_np:.6f} "
        f"({time.perf_counter() - t0:.1f} s)")
    fwd_def, _ = entry(device="cuda", m=M, n=N, precision="default")
    fwd_high, _ = entry(device="cuda", m=M, n=N, precision="high")
    omega = generate_omega(0, N, K + P, device="cuda")

    def fwd_polar(x):        # entry()'s configuration, polar interiors
        return rsvd_with_omega(x, omega, precision="default",
                               **dict(CONFIG, interior_qr="polar_fused"))
    launches_total = list(NONE)              # K1, K2, K3, K4, K5a, K5b
    summary = {}
    for label, prec, fwd, want in (
            ("highest", "highest", fwd_hi, launches_of(k1=Q + 1)),
            ("high", "high", fwd_high, launches_of(k1=Q + 1)),
            ("default", "default", fwd_def, launches_of(k1=Q + 1)),
            ("default, polar_fused interiors", "default", fwd_polar,
             launches_of(k1=1, k2=2))):
        launches, out = phase_main_path(label, fwd, a, a64, err_np, prec,
                                        want)
        launches_total = [t + c for t, c in zip(launches_total, launches)]
        summary[label] = out
        log(f"  main path [{label}]: " + json.dumps(out))
    summary["profile_default"] = profile_call(lambda: fwd_def(a))
    log("  profile [main path, default]: "
        + json.dumps(summary["profile_default"]))
    # the same configuration through the public rsvd()
    reset_counts()
    _, s_r, _ = rsvd(a, k=K, p=P, seed=0, precision="default",
                     **{k: v for k, v in CONFIG.items() if k != "k"})
    torch.cuda.synchronize()
    launches = counts()
    check(launches == launches_of(k1=Q + 1)
          and bool(torch.isfinite(s_r).all()),
          f"rsvd(): launches {launches}")
    launches_total[0] += launches[0]
    log(f"  rsvd() [default]: (K1, K2, K3, K4, K5a, K5b) launches {launches}, "
        f"s[0]={float(s_r[0]):.4f}")

    phase("phase 3: the three-kernel path (K4 sketch, K1 interiors, K3 tail)")
    omega_f = to_numpy(kernels.fused_sketch_omega(N, K + P, 0, "cuda"))
    u_n, s_n, v_n = numpy_rsvd(a64, K + P, Q, omega=omega_f.astype(np.float64))
    err_np_fused = recon_err(a64, u_n, s_n, v_n)
    log(f"  numpy f64 rSVD on the fused Omega: err {err_np_fused:.6f}")
    fused = {}
    for prec in ("highest", "default"):
        def fwd_fused(x, prec=prec):
            return rsvd(x, precision=prec, **FUSED)
        label = f"three kernels, {prec}"
        launches, out = phase_main_path(label, fwd_fused, a, a64,
                                        err_np_fused, prec,
                                        launches_of(k1=Q + 1, k3=1, k4=1))
        launches_total = [t + c for t, c in zip(launches_total, launches)]
        fused[prec] = out
        log(f"  main path [{label}]: " + json.dumps(out))
    fused["profile_highest"] = profile_call(
        lambda: rsvd(a, precision="highest", **FUSED))
    log("  profile [three kernels, highest]: "
        + json.dumps(fused["profile_highest"]))
    summary["three_kernels"] = fused

    phase(f"phase 3: rsvd(A, k={K}) at its defaults and the other engines")
    u_n, s_n, v_n = numpy_rsvd(a64, K + DEFAULT_P, Q)
    err_np_def = recon_err(a64, u_n, s_n, v_n)
    log(f"  numpy f64 rSVD at l={K + DEFAULT_P}: err {err_np_def:.6f}")
    engines = {}
    for method in ENGINES:
        def call(method=method):
            if method == "jacobi":
                return rsvd(a, k=K)                  # the public defaults
            return rsvd(a, k=K, method=method)
        sweeps = []
        real_core = jacobi._jacobi_core

        def spy(*args):
            out = real_core(*args)
            sweeps.append(out[3])
            return out
        reset_counts()
        with mock.patch.object(jacobi, "_jacobi_core", spy):
            u, s, v = call()
        torch.cuda.synchronize()
        launches = counts()
        check(launches == NONE, f"{method}: launches {launches}")
        check(u.shape == (M, K) and s.shape == (K,) and v.shape == (N, K)
              and all(bool(torch.isfinite(x).all()) for x in (u, s, v)),
              f"{method}: factors")
        ratio = recon_err(a64, *(to_numpy(x).astype(np.float64)
                                 for x in (u, s, v))) / err_np_def
        out = dict(err_ratio_vs_numpy=ratio, ms=cuda_ms(call, 2),
                   jacobi_sweeps=sweeps)
        engines[method] = out
        log(f"  rsvd(k={K}, method={method!r}): " + json.dumps(out))
        check(ratio <= ERR_RATIO_MAX, f"{method}: err ratio {ratio}")
    summary["defaults_and_engines"] = engines

    phase("phase 4: serving path")
    quant_ms = cuda_ms(lambda: prepare_operand(a), 10)
    a8 = prepare_operand(a)
    log(f"  prepare_operand (int8 quantization) 4096^2: {quant_ms:.4f} ms")
    serving = {"quantize_ms": quant_ms, "runs": []}
    for storage, operand in (("int8", a8), ("bf16", a), ("default", a)):
        for interior in ("cholqr1", "polar_fused"):
            n_k2, out = serving_run(storage, operand, a64, err_np, interior)
            launches_total[1] += n_k2
            serving["runs"].append(out)
            log(f"  serving [{storage}, {interior}]: " + json.dumps(out))
    serving["ragged_point"] = phase_drawn_point(*RAGGED, K, seed=3)
    log(f"  serving [int8, {RAGGED[0]}x{RAGGED[1]}, k={K}]: "
        + json.dumps(serving["ragged_point"]))
    serving["hbm_point"] = phase_drawn_point(BIG, BIG, BIG_K, seed=0)
    log(f"  serving [int8, {BIG}^2, k={BIG_K}]: "
        + json.dumps(serving["hbm_point"]))
    for interior in ("polar_fused", "cholqr1"):
        key = f"profile_int8_{interior}"
        serving[key] = profile_call(
            lambda: rsvd_serving(a8, k=K, p=P, q=Q, interior_qr=interior))
        log(f"  profile [int8, {interior}, 4096^2]: "
            + json.dumps(serving[key]))

    phase("phase 5: the image codec on the card")
    k5_launches, image_summary = phase_image()
    launches_total = [t + c for t, c in zip(launches_total, k5_launches)]

    phase("phase 6: the driver modes at 4096^2")
    modes = phase_driver_modes(a, a64, err_np)
    del a
    torch.cuda.empty_cache()

    phase("phase 7: PCA and the command lines")
    cli_launches, pca_summary = phase_pca()
    launches_total = [t + c for t, c in zip(launches_total, cli_launches)]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    pkg = "rsvd_kamaneh_raganato_terrana_tpu_torch"
    kernels_line = {"kernels": [
        dict(name="fused_cholqr1", route="cuda",
             source=f"{pkg}/csrc/cholqr1.cu",
             replaces="rsvd_kamaneh_raganato_terrana_tpu/linalg/"
                      "pallas_kernels.py:321",
             launches=launches_total[0], **k1),
        dict(name="polar_qr_fused", route="cuda",
             source=f"{pkg}/csrc/polar.cu",
             replaces="rsvd_kamaneh_raganato_terrana_tpu/linalg/"
                      "polar.py:257",
             launches=launches_total[1], **k2),
        dict(name="eigh_small", route="cuda",
             source=f"{pkg}/csrc/eigh.cu",
             replaces="rsvd_kamaneh_raganato_terrana_tpu/linalg/"
                      "pallas_kernels.py:401",
             launches=launches_total[2], **k3),
        dict(name="fused_sketch_matmul", route="cuda",
             source=f"{pkg}/csrc/sketch.cu",
             replaces="rsvd_kamaneh_raganato_terrana_tpu/linalg/"
                      "pallas_kernels.py:116",
             launches=launches_total[3], **k4),
        dict(name="quantize_uint8", route="cuda",
             source=f"{pkg}/csrc/quantize.cu",
             replaces="rsvd_kamaneh_raganato_terrana_tpu/linalg/"
                      "pallas_kernels.py:198",
             launches=launches_total[4], **k5["K5a"]),
        dict(name="quantize_uint8[stochastic]", route="cuda",
             source=f"{pkg}/csrc/quantize.cu",
             replaces="rsvd_kamaneh_raganato_terrana_tpu/linalg/"
                      "pallas_kernels.py:178",
             launches=launches_total[5], **k5["K5b"]),
    ], "main_path": summary, "serving": serving, "image": image_summary,
        "driver_modes": modes, "pca": pca_summary}
    phase("all phases done")
    log(json.dumps(kernels_line))
    log(smi.stdout.strip())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
