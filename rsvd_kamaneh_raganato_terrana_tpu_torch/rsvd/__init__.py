"""Randomized SVD driver, serving preset, diagnostics and error
certificates, UTV, Frequent Directions, interpolative/CUR
decompositions, DEIM, and the randomized-NLA extensions: block Krylov,
sketched least squares, Nystrom and randomized eigh, trace and SLQ
estimators, randomized LU, CCA, DMD, robust PCA and completion, the
tensor formats (Tucker, TT, CP) and HODLR, the out-of-core streaming
drivers, and the distributed ones: ``rsvd_sharded``, the ring driver
``rsvd_ring`` and ``rsvd.multihost.rsvd_streaming_multihost``."""

from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.cca import (  # noqa: F401
    CcaResult,
    cca,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.cp import (  # noqa: F401
    cp_decompose,
    cp_reconstruct,
    khatri_rao,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.completion import (  # noqa: F401
    CompletionResult,
    TuckerCompletionResult,
    complete_lowrank,
    complete_tucker,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.rpca import (  # noqa: F401
    RpcaResult,
    rpca,
)

from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.deim import (  # noqa: F401
    Deim,
    deim_condition,
    deim_fit,
    deim_indices,
    deim_interpolate,
    deim_projector,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.diagnostics import (  # noqa: F401
    factor_health,
    factorization_error_estimate,
    principal_angles,
    range_error_estimate,
    spectral_norm_estimate,
    stable_rank_estimate,
    subspace_distance,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.dmd import (  # noqa: F401
    DmdResult,
    dmd,
    dmd_predict,
    dmd_reconstruction_error,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (  # noqa: F401
    Int8Stored,
    SparseStored,
    generate_omega,
    quantize_int8_rows,
    power_refine,
    reconstruct,
    reconstruction_error,
    adaptive_work_ratio,
    rsvd,
    rsvd_adaptive,
    rsvd_batched,
    rsvd_core,
    rsvd_image_preset,
    rsvd_onepass,
    rsvd_sharded,
    rsvd_warm,
    rsvd_with_omega,
    subspace_iteration,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.ring import (  # noqa: F401
    rsvd_ring,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.fd import (  # noqa: F401
    FrequentDirections,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.hodlr import (  # noqa: F401
    HodlrMatrix,
    hodlr_build,
    hodlr_build_implicit,
    hodlr_compression_ratio,
    hodlr_matvec,
    hodlr_reconstruct,
    hodlr_solve,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.interp import (  # noqa: F401
    column_id,
    cur,
    cur_reconstruct,
    id_reconstruct,
    leverage_sample,
    leverage_scores,
    row_id,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.krylov import (  # noqa: F401
    krylov_basis,
    rsvd_krylov,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.lstsq import (  # noqa: F401
    lstsq_residual,
    sketch_lstsq,
    sketch_minnorm,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.nystrom import (  # noqa: F401
    nystrom_pcg,
    nystrom_preconditioner,
    nystrom_psd,
    nystrom_reconstruct,
    reigh,
    reigh_generalized,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.slq import (  # noqa: F401
    lanczos_tridiag,
    logdet_psd,
    slq_trace,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.streaming import (  # noqa: F401
    SynthesizedMatrix,
    rsvd_streaming,
    rsvd_streaming_onepass,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.trace import (  # noqa: F401
    diag_estimate,
    hutchinson,
    hutchpp,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.tt import (  # noqa: F401
    tt_adaptive,
    tt_compression_ratio,
    tt_decompose,
    tt_ranks,
    tt_reconstruct,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.rlu import (  # noqa: F401
    RluResult,
    rlu,
    rlu_reconstruct,
    rlu_solve,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.serving import (  # noqa: F401
    prepare_operand,
    rsvd_serving,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.utv import (  # noqa: F401
    rutv,
    rutv_reconstruct,
    utv_rescore,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.tucker import (  # noqa: F401
    tucker,
    tucker_adaptive,
    tucker_reconstruct,
)
