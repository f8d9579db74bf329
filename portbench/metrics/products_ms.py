"""Device ms a call of the stage-A products: what runs inside the
driver's ``_mm`` (casts, cuBLAS, the int8 panel quantization and
``torch._int_mm``, cuSPARSE), or is filed there by name."""

LAYER = "stage-A products"
UNIT = "ms"
MOVES = "call_ms"


def read(r):
    return r.layer_ms("products")
