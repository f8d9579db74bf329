"""Device/precision policy (`device`), device meshes and placements
(`mesh`), the process group and the sharded operand (`distributed`), the
counted collectives (`collectives`), seeded RNG (`rng`), numpy
hand-over (`convert`), MatrixMarket and dataset I/O (`io`), the
configuration dataclasses and parsers (`config`), timers, traces and
FLOP counts (`profiling`) and factor checkpoints (`checkpoint`)."""

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.mesh import (  # noqa: F401
    COLS_AXIS,
    ROWS_AXIS,
    TILE_AXES,
    col_sharding,
    local_mesh_or_none,
    make_mesh,
    make_tile_mesh,
    pad_rows_for_mesh,
    replicate,
    replicated,
    row_sharding,
    shard_rows,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (  # noqa: F401
    fold_in_shard,
    gaussian,
    key_from_seed,
    rademacher,
    sketch_matrix,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.profiling import (  # noqa: F401
    PhaseTimer,
    matmul_gflops,
    rsvd_flops,
    timeit,
    trace,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.io import (  # noqa: F401
    load_whitespace_dataset,
    read_matrix_market,
    write_matrix_market,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.config import (  # noqa: F401
    AdvDiffConfig,
    PodConfig,
    RSVDConfig,
    parse_pod_config,
    parse_prm_config,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.checkpoint import (  # noqa: F401
    export_matrix_market,
    load_factors,
    save_factors,
)
