"""Device/precision policy (`device`), seeded RNG (`rng`), numpy
hand-over (`convert`), MatrixMarket and dataset I/O (`io`) and FLOP
counts (`profiling`)."""

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (  # noqa: F401
    fold_in_shard,
    gaussian,
    key_from_seed,
    rademacher,
    sketch_matrix,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.profiling import (  # noqa: F401
    rsvd_flops,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.io import (  # noqa: F401
    load_whitespace_dataset,
    read_matrix_market,
    write_matrix_market,
)
