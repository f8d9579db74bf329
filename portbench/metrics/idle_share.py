"""Share of the traced window in which no operation ran on the device
(1 - the union of device intervals over the window), averaged over the
cards, in percent."""

LAYER = "device"
UNIT = "%"
MOVES = "call_ms"


def read(r):
    if r.window_s <= 0 or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
