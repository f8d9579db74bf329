"""rSVD CLI: for every MatrixMarket file of an input directory (or one
file), run the randomized SVD with l = k + p, print ``||A - U S V^T||_F``
and the wall time, and optionally write U, S and V as .mtx.  The
reference's preset is kept: k = 0, p = 16 (so l = 16), the Jacobi tail.
A is f32 on the card and f64 on the CPU, as the JAX CLI turns x64 on
off the TPU.

  python -m rsvd_kamaneh_raganato_terrana_tpu_torch rsvd data/input \
      [--k 0] [--p 16] [--q 2] [--method jacobi] [--precision highest] \
      [--save-dir data/output/rSVD/my] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="rsvd", description="randomized SVD over MatrixMarket inputs")
    ap.add_argument("input", help=".mtx file or directory of .mtx files")
    ap.add_argument("--k", type=int, default=0,
                    help="target rank (0 = all l = p components)")
    ap.add_argument("--p", type=int, default=16, help="oversampling")
    ap.add_argument("--q", type=int, default=2, help="power iterations")
    ap.add_argument("--method", default="jacobi",
                    help="small-SVD tail engine (jacobi|power|eigh|auto|...)")
    ap.add_argument("--precision", default="highest")
    ap.add_argument("--finish", default="project",
                    help="project|rowspace|utv|rowspace_utv (serving "
                         "modes -- rsvd_with_omega docstring)")
    ap.add_argument("--qr-method", default="robust",
                    help="robust|robust1|cholqr1|cholqr2|cholqr3|"
                         "householder|cholqr1_fused|polar_fused")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-dir", default=None,
                    help="write <stem>_U/S/V.mtx factor exports here")
    ap.add_argument("--device", default="cuda",
                    help="device of the factorizations (default: the card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import (
        from_numpy,
        to_numpy,
    )
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.io import (
        read_matrix_market,
        write_matrix_market,
    )
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import (
        reconstruction_error,
        rsvd,
    )

    paths = (sorted(glob.glob(os.path.join(args.input, "*.mtx")))
             if os.path.isdir(args.input) else [args.input])
    if not paths:
        print(f"no .mtx files under {args.input}", file=sys.stderr)
        return 1
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
    device = torch.device(args.device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32

    for path in paths:
        a = from_numpy(read_matrix_market(path), device=device, dtype=dtype)
        t0 = time.perf_counter()
        u, s, v = rsvd(a, k=args.k, p=args.p, q=args.q, method=args.method,
                       precision=args.precision, seed=args.seed,
                       finish=args.finish, qr_method=args.qr_method)
        float(s[0])          # force the factorization before stopping the clock
        dt = (time.perf_counter() - t0) * 1e3
        err = float(reconstruction_error(a, u, s, v))
        stem = os.path.splitext(os.path.basename(path))[0]
        print(f"{stem}: {a.shape[0]}x{a.shape[1]} l={s.shape[0]} "
              f"||A-USV^T|| = {err:.6e}  ({dt:.1f} ms)")
        if not np.isfinite(err) and args.qr_method.startswith("cholqr"):
            print(f"  hint: {args.qr_method} has no rank-deficiency "
                  "fallback (linalg/qr.py) -- rank-deficient input NaNs; "
                  "use --qr-method robust", file=sys.stderr)
        if args.save_dir:
            write_matrix_market(
                os.path.join(args.save_dir, f"{stem}_U.mtx"), to_numpy(u))
            write_matrix_market(
                os.path.join(args.save_dir, f"{stem}_S.mtx"),
                to_numpy(s)[:, None])
            write_matrix_market(
                os.path.join(args.save_dir, f"{stem}_V.mtx"), to_numpy(v))
    return 0


if __name__ == "__main__":
    sys.exit(main())
