"""Rank 0's NCCL kernel time a call, in ms."""

LAYER = "collectives"
UNIT = "ms"
MOVES = "call_ms"


def read(r):
    return r.layer_ms("collectives")
