"""Host waits for the device a call: each ``cud*Synchronize`` runtime call
and each blocking ``cudaMemcpy`` launched inside a traced call (the
harness's own synchronize after each call is outside it)."""

LAYER = "driver"
UNIT = "1/call"
MOVES = "call_ms"


def read(r):
    return r.syncs / r.calls if r.calls else None
