"""Applications built on the rSVD core: PCA, image compression, kernel
PCA, POD/ROM (the advection-diffusion FOM ``advdiff``, the POD
algorithms ``pod``, the Galerkin and DEIM ROMs and their drivers
``rom``) and embedding retrieval (``retrieval``); spectral clustering
(``apps.cluster``) and the sklearn estimators (``apps.estimators``) are
imported from their modules, as in the JAX package."""

from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.pca import (  # noqa: F401
    PCA,
    load_athletic_dataset,
    load_tourists_dataset,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.image import (  # noqa: F401
    Image,
    TileFactors,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.kpca import (  # noqa: F401
    KernelPCA,
    kernel_matrix,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.pod import (  # noqa: F401
    POD,
    energy_pod,
    incremental_pod,
    make_pod,
    naive_pod,
    perform_svd,
    standard_pod,
    weight_pod,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import (  # noqa: F401
    advdiff,
    retrieval,
    rom,
)
