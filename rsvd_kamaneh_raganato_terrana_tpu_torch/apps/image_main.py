"""Image-compression CLI: load, downscale(2), normalize, tiled rSVD
(k = 80, a 2 x 2 grid), restore, denormalize, upscale(2), save a PNG and
an ``.rsv`` factor file, print the compression ratio and the timing.

Usage:
  python -m rsvd_kamaneh_raganato_terrana_tpu_torch image <image>
      [--k 80] [--grid 2x2] [--downscale 2] [--out-dir data/output/img]
      [--no-tile] [--color] [--device cuda]
"""

import argparse
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image")
    ap.add_argument("--k", type=int, default=80)
    ap.add_argument("--grid", default="2x2", help="tile grid, e.g. 2x2")
    ap.add_argument("--downscale", type=int, default=2)
    ap.add_argument("--out-dir", default="data/output/img")
    ap.add_argument("--no-tile", action="store_true",
                    help="whole-image rSVD instead of tiled")
    ap.add_argument("--color", action="store_true",
                    help="RGB per-channel compression (grayscale default)")
    ap.add_argument("--device", default="cuda",
                    help="device of the factorizations (default: the card)")
    args = ap.parse_args(argv)

    from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.image import Image

    stem = os.path.splitext(os.path.basename(args.image))[0]
    os.makedirs(args.out_dir, exist_ok=True)

    t0 = time.perf_counter()
    im = Image.load(args.image, color=args.color)
    print(f"loaded {args.image}: {'x'.join(str(d) for d in im.shape)}")
    if args.downscale > 1:
        im.downscale(args.downscale)
    im.normalize()

    t1 = time.perf_counter()
    if args.no_tile or args.color:
        im.compress(k=args.k, device=args.device)
    else:
        gy, gx = (int(x) for x in args.grid.split("x"))
        im.compress_tiled(k=args.k, grid=(gy, gx), device=args.device)
    t2 = time.perf_counter()

    ratio = im.compression_ratio()
    im.restore()
    im.denormalize()
    if args.downscale > 1:
        im.upscale(args.downscale)

    png = os.path.join(args.out_dir, f"{stem}_compressed.png")
    dat = os.path.join(args.out_dir, f"{stem}_factors.rsv")
    im.save(png)
    im.save_compressed(dat)
    t3 = time.perf_counter()

    print(f"compression ratio: {ratio:.2f}")
    print(f"compress: {1e3 * (t2 - t1):.1f} ms, total: "
          f"{1e3 * (t3 - t0):.1f} ms")
    print(f"wrote {png} and {dat}")


if __name__ == "__main__":
    main()
