"""GB a call written by the Tucker unfoldings that copy the current core:
the program's own counter, ``rsvd/tucker.py::unfold_tally()``, its bytes
over its calls (every ``tucker`` call of the run process; a program
without the counter reads nothing)."""

import importlib

LAYER = "unfoldings"
UNIT = "GB/call"
MOVES = "call_ms"
MODULE = "rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.tucker"


def read(r):
    tally = getattr(importlib.import_module(MODULE), "unfold_tally", None)
    if tally is None:
        return None
    t = tally()
    return t["bytes"] / t["calls"] / 1e9 if t["calls"] else None
