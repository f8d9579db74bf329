"""Applications built on the rSVD core (the ported part: image
compression)."""

from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.image import (  # noqa: F401
    Image,
    TileFactors,
)
