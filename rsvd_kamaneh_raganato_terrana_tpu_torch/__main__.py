"""Command-line dispatcher of the PyTorch port.

  python -m rsvd_kamaneh_raganato_terrana_tpu_torch rsvd <mtx-or-dir> [...]
  python -m rsvd_kamaneh_raganato_terrana_tpu_torch image <img> [...]
  python -m rsvd_kamaneh_raganato_terrana_tpu_torch pca <dataset> [yes|no] [...]

Each runs on the card unless given ``--device cpu``.  The JAX package's
``pod`` app is not ported yet (ROADMAP.md, queue 1 item 5): it prints so
and exits with 1.
"""

import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    app, rest = argv[0], argv[1:]
    if app == "rsvd":
        from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.rsvd_main import (
            main as run,
        )
        return run(rest)
    if app == "image":
        from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.image_main import (
            main as run,
        )
    elif app == "pca":
        from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.pca_main import (
            main as run,
        )
    elif app == "pod":
        print("'pod' is not ported to the PyTorch package yet (ROADMAP.md, "
              "queue 1 item 5)")
        return 1
    else:
        print(f"unknown app {app!r}; expected rsvd|image|pca (pod is not "
              "ported yet)")
        return 1
    run(rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
