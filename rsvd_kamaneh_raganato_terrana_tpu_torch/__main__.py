"""Command-line dispatcher of the PyTorch port.

  python -m rsvd_kamaneh_raganato_terrana_tpu_torch image <img> [...]

The JAX package's other apps (rsvd, pca, pod) are not ported yet
(ROADMAP.md, queue 1 item 16): they print so and exit with 1.
"""

import sys

_NOT_PORTED = ("rsvd", "pca", "pod")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    app, rest = argv[0], argv[1:]
    if app == "image":
        from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.image_main import (
            main as run,
        )
        run(rest)
        return 0
    if app in _NOT_PORTED:
        print(f"{app!r} is not ported to the PyTorch package yet "
              "(ROADMAP.md, queue 1 item 16)")
        return 1
    print(f"unknown app {app!r}; expected image (or rsvd|pca|pod, not "
          "ported yet)")
    return 1


if __name__ == "__main__":
    sys.exit(main())
