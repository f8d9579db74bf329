"""The program's side of set-up: its kernels loaded and the program names
a cell's files give (``module:attribute``) resolved.  A cell's kind
(``kinds/<kind>.py``) builds its operand with them."""

from __future__ import annotations

import importlib

PKG = "rsvd_kamaneh_raganato_terrana_tpu_torch"


def resolve(target: str):
    """The attribute a ``module:attribute`` string names."""
    mod, attr = target.split(":")
    return getattr(importlib.import_module(mod), attr)


def load_kernels() -> int:
    """Build what is missing (the first run in a checkout compiles into
    the package's fixed ``build/`` directory) and load every kernel
    library; returns how many."""
    build = importlib.import_module(PKG + ".linalg._build")
    build.build_all()
    srcs = build.sources()
    for src in srcs:
        build.library(src.stem)
    return len(srcs)
