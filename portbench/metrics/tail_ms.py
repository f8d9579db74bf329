"""Device ms a call of the small SVD tail (the Gram, cuSOLVER's eigh or
K3, the rotations)."""

LAYER = "tail"
UNIT = "ms"
MOVES = "call_ms"


def read(r):
    return r.layer_ms("tail")
