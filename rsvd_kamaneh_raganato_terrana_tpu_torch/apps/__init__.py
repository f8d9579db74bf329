"""Applications built on the rSVD core (the ported part: PCA and image
compression)."""

from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.pca import (  # noqa: F401
    PCA,
    load_athletic_dataset,
    load_tourists_dataset,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.image import (  # noqa: F401
    Image,
    TileFactors,
)
