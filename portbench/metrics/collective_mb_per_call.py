"""MB a call that rank 0 handed to collectives (``core/collectives.py``'s
tally, bytes over the traced calls)."""

LAYER = "collectives"
UNIT = "MB/call"
MOVES = "call_ms"


def read(r):
    return r.collective_bytes / 1e6 if r.collective_bytes else None
