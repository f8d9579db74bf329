#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold every
kernel of that path to its plain PyTorch version.

Run from the repository root:  python3 chip_smoke.py  [--kernels-only]

Phases (any failure raises; nothing is caught):
1. Build every kernel from ``csrc/`` with nvcc for sm_90a.
2. Each kernel against its plain version on the card, at the main path's
   shapes and at ragged ones; a rank-deficient panel must give
   non-finite output from both.  ``--kernels-only`` stops here.
3. The main path -- ``entry()``'s rank-64 rSVD (k=64, p=16, q=2) of a
   4096 x 4096 f32 operand made from seed 0, and the same configuration
   through ``rsvd()`` -- for precision 'highest' and 'default'.  Each
   call must launch K1 exactly q + 1 = 3 times; its reconstruction error
   is compared with a numpy f64 rSVD of the same k, p and q
   (``err_ratio_vs_numpy``, as bench.py computes it); its singular values
   with the same call run through the plain version; both are timed
   with CUDA events.
4. A ``kernels`` JSON line, the card's name and power limit, and as the
   last line ``{"ok": true, "device": {...}}``.

Exits non-zero with no result line when no CUDA device is visible or
the package is not importable next to this script.
"""

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch import rsvd
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import device
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.entry import CONFIG, entry
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import _build, kernels
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    generate_omega,
)

M = N = 4096
K, P, Q = 64, 16, 2
ERR_RATIO_MAX = 1.01     # rSVD error within 1% of the f64 numpy rSVD
# max |ds| / s_1, kernel path vs plain path.  'highest' differs by fp32
# roundoff only; under 'default' an fp32-level change in Q can flip the
# bf16 rounding of single GEMM operands (bf16 eps 3.9e-3)
SIGMA_TOL = {"highest": 1e-4, "default": 5e-4}
Q_TOL = 1e-4             # max |dQ| (Q has orthonormal columns)
R_TOL = 1e-4             # max |dR| / max |R|
ORTH_TOL = 1e-4          # max |Q^T Q - I| of the kernel's Q


def log(msg):
    print(msg, flush=True)


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


def numpy_rsvd(a, l, q, seed=0):
    """The numpy baseline of bench.py:87-99, in f64."""
    rng = np.random.default_rng(seed)
    omega = rng.standard_normal((a.shape[1], l))
    q_mat, _ = np.linalg.qr(a @ omega)
    for _ in range(q):
        qz, _ = np.linalg.qr(a.T @ q_mat)
        q_mat, _ = np.linalg.qr(a @ qz)
    u_t, s, vt = np.linalg.svd(q_mat.T @ a, full_matrices=False)
    return q_mat @ u_t, s, vt.T


def recon_err(a, u, s, v):
    return float(np.linalg.norm(a - (u[:, :K] * s[:K]) @ v[:, :K].T))


def phase_kernels(a):
    """Phase 2: K1 against its plain version; returns the kernels-line
    fields measured here."""
    omega = generate_omega(0, N, K + P, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    y_main = device.matmul_at(a, omega, "highest")
    panels = {
        "main Y = A @ Omega 4096x80": y_main,
        "ragged 4099x17": torch.randn(4099, 17, device="cuda",
                                      generator=gen),
        "ragged 1000x128": torch.randn(1000, 128, device="cuda",
                                       generator=gen),
        "panel 16384x80": torch.randn(16384, 80, device="cuda",
                                      generator=gen),
    }
    worst_q = worst_r = 0.0
    for name, y in panels.items():
        q, r = kernels.fused_cholqr1(y)
        q0, r0 = kernels.fused_cholqr1_reference(y)
        torch.cuda.synchronize()
        check(q.shape == q0.shape and r.shape == r0.shape, name)
        check(bool(torch.isfinite(q).all() and torch.isfinite(r).all()),
              f"{name}: non-finite output")
        dq = float((q - q0).abs().max())
        dr = float((r - r0).abs().max())
        dr_rel = dr / float(r0.abs().max())
        with device.ieee_fp32():
            gram = q.T @ q
        orth = float((gram - torch.eye(y.shape[1], device="cuda"))
                     .abs().max())
        lower = float(torch.tril(r, -1).abs().max())
        log(f"  K1 {name}: max|dQ|={dq:.3e} max|dR|={dr:.3e} "
            f"(rel {dr_rel:.3e}) max|Q^T Q - I|={orth:.3e} "
            f"max|tril(R)|={lower:.1e}")
        check(dq <= Q_TOL and dr_rel <= R_TOL,
              f"{name}: kernel vs plain dQ={dq} dR/R={dr_rel}")
        check(orth <= ORTH_TOL and lower == 0.0,
              f"{name}: |Q^T Q - I|={orth} |tril(R)|={lower}")
        worst_q, worst_r = max(worst_q, dq), max(worst_r, dr_rel)

    y_def = torch.randn(1000, 64, device="cuda", generator=gen)
    y_def[:, 32:] = y_def[:, :32]                  # exact rank 32 < l
    for label, fn in (("kernel", kernels.fused_cholqr1),
                      ("plain", kernels.fused_cholqr1_reference)):
        q, r = fn(y_def)
        finite = bool(torch.isfinite(q).all() and torch.isfinite(r).all())
        log(f"  K1 rank-deficient 1000x64 ({label}): finite={finite}")
        check(not finite, f"rank-deficient panel gave finite {label} output")

    ms = cuda_ms(lambda: kernels.fused_cholqr1(y_main), 50)
    plain_ms = cuda_ms(lambda: kernels.fused_cholqr1_reference(y_main), 10)
    log(f"  K1 at 4096x80: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=worst_q, max_rel_err_r=worst_r, ms=ms,
                plain_ms=plain_ms)


def phase_main_path(prec, forward, a, a64, err_np):
    """Phase 3 for one precision: the counted run, accuracy, the plain
    path, timings.  Returns (K1 launches, summary dict)."""
    kernels.fused_cholqr1.launches = 0
    u, s, v = forward(a)
    torch.cuda.synchronize()
    launches = kernels.fused_cholqr1.launches
    check(launches == Q + 1, f"K1 launched {launches} times, not {Q + 1}")
    check(u.shape == (M, K) and s.shape == (K,) and v.shape == (N, K),
          f"shapes {u.shape} {s.shape} {v.shape}")
    check(all(bool(torch.isfinite(x).all()) for x in (u, s, v)),
          "non-finite factors")
    u_np, s_np, v_np = (to_numpy(x).astype(np.float64) for x in (u, s, v))
    err_ratio = recon_err(a64, u_np, s_np, v_np) / err_np
    orth = float(np.abs(u_np.T @ u_np - np.eye(K)).max())
    with mock.patch.object(kernels, "fused_cholqr1",
                           kernels.fused_cholqr1_reference):
        _, s_plain, _ = forward(a)
        plain_ms = cuda_ms(lambda: forward(a), 5)
    dsigma = float((s - s_plain).abs().max() / s_plain[0])
    ms = cuda_ms(lambda: forward(a), 10)
    out = dict(err_ratio_vs_numpy=err_ratio, max_rel_dsigma_vs_plain=dsigma,
               u_orth=orth, ms=ms, plain_ms=plain_ms, k1_launches=launches)
    check(err_ratio <= ERR_RATIO_MAX, f"err ratio {out}")
    check(dsigma <= SIGMA_TOL[prec], f"sigma vs plain {out}")
    check(orth <= 1e-3, f"U orthogonality {out}")
    return launches, out


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count {torch.cuda.device_count()}")

    log("phase 1: build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"  built {[p.name for p in libs]} in "
        f"{time.perf_counter() - t0:.2f} s")
    for src, text in _build.build_logs.items():
        log(f"  nvcc {src}:\n" + "\n".join(
            "    " + line for line in text.strip().splitlines()))

    log("phase 2: kernels against their plain versions")
    fwd_hi, (a,) = entry(device="cuda", m=M, n=N, precision="highest")
    k1 = phase_kernels(a)
    if "--kernels-only" in argv:
        log("stopping after phase 2 (--kernels-only)")
        return 0

    log("phase 3: main path")
    a64 = to_numpy(a).astype(np.float64)
    t0 = time.perf_counter()
    u_n, s_n, v_n = numpy_rsvd(a64, K + P, Q)
    err_np = recon_err(a64, u_n, s_n, v_n)
    log(f"  numpy f64 rSVD baseline: err {err_np:.6f} "
        f"({time.perf_counter() - t0:.1f} s)")
    fwd_def, _ = entry(device="cuda", m=M, n=N, precision="default")
    total_launches = 0
    summary = {}
    for prec, fwd in (("highest", fwd_hi), ("default", fwd_def)):
        launches, out = phase_main_path(prec, fwd, a, a64, err_np)
        total_launches += launches
        summary[prec] = out
        log(f"  main path [{prec}]: " + json.dumps(out))
    # the same configuration through the public rsvd()
    kernels.fused_cholqr1.launches = 0
    _, s_r, _ = rsvd(a, k=K, p=P, seed=0, precision="default",
                     **{k: v for k, v in CONFIG.items() if k != "k"})
    torch.cuda.synchronize()
    launches = kernels.fused_cholqr1.launches
    check(launches == Q + 1 and bool(torch.isfinite(s_r).all()),
          f"rsvd(): K1 launches {launches}")
    total_launches += launches
    log(f"  rsvd() [default]: K1 launches {launches}, s[0]={float(s_r[0]):.4f}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    kernels_line = {"kernels": [{
        "name": "fused_cholqr1",
        "route": "cuda",
        "source": "rsvd_kamaneh_raganato_terrana_tpu_torch/csrc/cholqr1.cu",
        "replaces": "rsvd_kamaneh_raganato_terrana_tpu/linalg/"
                    "pallas_kernels.py:321",
        "launches": total_launches,
        "max_abs_err": k1["max_abs_err"],
        "max_rel_err_r": k1["max_rel_err_r"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }], "main_path": summary}
    log(json.dumps(kernels_line))
    log(smi.stdout.strip())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
