"""Device ms a call of the orthonormalizations: K1's Gram, elimination
and apply, and the Cholesky/triangular fallbacks."""

LAYER = "orthonormalization"
UNIT = "ms"
MOVES = "call_ms"


def read(r):
    return r.layer_ms("ortho")
