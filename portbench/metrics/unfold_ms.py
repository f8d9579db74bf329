"""Device ms a call of the Tucker unfoldings that copy the current core
(what runs inside ``rsvd/tucker.py::_unfold``, the kind's ``unfold``
span)."""

LAYER = "unfoldings"
UNIT = "ms"
MOVES = "call_ms"


def read(r):
    return r.layer_ms("unfold")
