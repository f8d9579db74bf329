"""PCA CLI: load a whitespace dataset, run the 'parallel_jacobi' PCA,
print the R-style summary and the orthogonality check, save the results.
The data is f32 on the card and f64 on the CPU.

Usage:
  python -m rsvd_kamaneh_raganato_terrana_tpu_torch pca <dataset> [yes|no]
      [--skip-cols N] [--method parallel_jacobi] [--save results.txt]
      [--device cuda]
"""

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset")
    ap.add_argument("normalize", nargs="?", default="no", choices=["yes", "no"])
    ap.add_argument("--skip-cols", type=int, default=None,
                    help="leading categorical columns (auto by filename)")
    ap.add_argument("--method", default="parallel_jacobi")
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device of the factorization (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.pca import PCA
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import (
        from_numpy,
    )
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.io import (
        load_whitespace_dataset,
    )

    skip = args.skip_cols
    if skip is None:
        # the reference loaders: tourists has 3 categorical columns,
        # athletic 1
        name = os.path.basename(args.dataset)
        skip = 3 if "tourist" in name else 1

    data, _ = load_whitespace_dataset(args.dataset, skip_cols=skip)
    print(f"dataset: {data.shape[0]} rows x {data.shape[1]} numeric cols")
    device = torch.device(args.device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    pca = PCA(from_numpy(data, device=device, dtype=dtype),
              normalize=(args.normalize == "yes"), method=args.method)
    print(pca.summary())
    print(f"orthogonality check ||V^T V - I|| = {pca.check_orthogonality():.3e}")
    if args.save:
        pca.save_results(args.save)
        print(f"saved results -> {args.save}")


if __name__ == "__main__":
    main()
