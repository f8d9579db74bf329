"""The call's least product time over ``products_ms``, in percent: the
least time is the larger of the passes' operations over the peak of the
precision they run in and their least bytes over 3.35 TB/s
(``roofline.products_least``)."""

LAYER = "stage-A products"
UNIT = "%"
MOVES = "call_ms"


def read(r):
    ms = r.layer_ms("products")
    if not ms or not r.least_products_s:
        return None
    return 100.0 * 1e3 * r.least_products_s / ms
