"""Entry point of the port's main path: the counterpart of
``__graft_entry__.py::entry()`` with this package's configuration.

A rank-64 randomized SVD (k=64, p=16, q=2): Gaussian sketch -> q power
rounds with reorth='half' -> every orthonormalization by the fused
CholeskyQR1 kernel (K1) -> B = Q^T A -> Gram-eigh tail -> U = Q U_tilde,
with bf16-operand / f32-accumulation stage-A GEMMs (precision='default').

:func:`dryrun_multichip` is the multi-card dry run; on a machine with N
cards, ``torchrun --nproc-per-node=N -m
rsvd_kamaneh_raganato_terrana_tpu_torch.entry multichip`` runs it over
NCCL.
"""

from __future__ import annotations

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import from_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    generate_omega,
    rsvd_with_omega,
)

K, P, Q = 64, 16, 2
CONFIG = dict(q=Q, k=K, method="eigh", qr_method="cholqr1_fused",
              interior_qr="cholqr1_fused", reorth="half", finish="project")


def entry(device="cuda", m: int = 1024, n: int = 1024,
          precision: str = "default"):
    """(forward, example_args): the main-path forward step and an m x n
    f32 operand made from seed 0 on ``device``."""

    def forward(a):
        omega = generate_omega(0, a.shape[1], K + P, a.dtype,
                               device=a.device)
        return rsvd_with_omega(a, omega, precision=precision, **CONFIG)

    a = from_numpy(np.random.default_rng(0).standard_normal((m, n)),
                   device=device, dtype=torch.float32)
    return forward, (a,)


def dryrun_multichip(n_ranks: int, device="cuda") -> dict:
    """The multi-card dry run (the counterpart of ``__graft_entry__.py::
    dryrun_multichip``) on a process group of ``n_ranks`` ranks, one a
    process: started by torchrun (``initialize()`` reads its variables)
    or by the caller.  Every rank calls it; rank 0 prints a line a stage.

    1. A 2-D ('rows', 'cols') mesh, rows as many as the divisors allow, a
       2049 x 2048 f32 operand (ragged rows zero-padded), rsvd_with_omega
       at k 64, p 16, q 2: collectives issued (the tally), finite, the
       padded rows of U zero, U orthonormal.
    2. The production configuration (eigh, 'default', reorth 'half',
       'robust1' interiors) against the same call on one rank's whole
       operand: max |ds| / s_1 < 1e-4.
    3. The serving configuration ('rowspace_utv', 'cholqr1') the same
       way, held by its error: within 0.1% of the single call's.  Its
       weights are reported, not held: under 'default' numerics on the
       card (bf16 operands) a roundoff-level difference upstream moves
       the weights of this flat-spectrum operand by ~1e-4 of the first
       (``chip_smoke.py`` phase 12 measures the single call's own
       shift under a 1e-7 perturbation of Omega).
    4. ``rsvd_streaming_multihost`` of the first 2048 rows, each rank
       streaming its row block, with int8 panels (max |ds| / s_1 of the
       top 8 < 5e-2 against step 2's single call), and the streamed
       serving tail (error within 1.1x of the int8 run's 'project').
    5. ``rsvd_ring`` of a (256 P) x 2048 operand (k 64, p 16, q 1,
       'eigh') against ``rsvd`` on one rank: max |ds| / s_1 < 1e-4.
    6. ``rsvd_batched(mode='vmap')`` of a 2P x 256 x 256 stack sharded
       on its batch dim over a ('batch',) mesh (k 16, q 1): no
       collective, U, s and V sharded with two elements a rank, each
       element's sigma within 1e-3 of sigma_1 of the one-rank 'scan'
       call's.
    7. ``Image.compress_tiled(mesh=)`` of a 512^2 image on a
       (2, P / 2) grid (k 16): the tiles split over the mesh, sigma
       within 1e-3 of sigma_1 of the one-rank call's, the
       reconstructions within 1.0 (pixel scale 255) of each other.

    Returns what each stage measured; a failed check raises."""
    import math

    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
        from_dtensor,
        initialize,
    )
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.mesh import (
        distribute,
        make_mesh,
        pad_rows_for_mesh,
    )
    from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.image import Image
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
        rsvd,
        rsvd_batched,
    )
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.multihost import (
        rsvd_streaming_multihost,
    )
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.ring import rsvd_ring

    initialize()
    if dist.get_world_size() != n_ranks:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, not {n_ranks}")
    rank = dist.get_rank()
    out = {}

    def done(stage, ok, msg, **vals):
        if not ok:
            raise RuntimeError(f"dryrun_multichip {stage}: {msg} {vals}")
        out[stage] = vals
        if rank == 0:
            print(f"dryrun {stage} ok: {msg} {vals}", flush=True)

    def max_rel(s, s0):
        return float((s - s0).abs().max() / s0[0])

    rows = next(n_ranks // r for r in range(math.isqrt(n_ranks), 0, -1)
                if n_ranks % r == 0)
    mesh = make_mesh((rows, n_ranks // rows), ("rows", "cols"), device)
    m, n, k, p, q = 2049, 2048, K, P, Q
    a = from_numpy(np.random.default_rng(0).standard_normal((m, n)),
                   device=device, dtype=torch.float32)
    a_pad, _ = pad_rows_for_mesh(a, mesh)
    a_sh = distribute(a_pad, mesh, (Shard(0), Shard(1)))
    omega = generate_omega(0, n, k + p, a.dtype, device=device)

    collectives.reset()
    u, s, v = rsvd_with_omega(a_sh, omega, q=q, k=k)
    tally = collectives.tally()
    u_full = from_dtensor(u).gather()
    pad_norm = float(torch.linalg.norm(u_full[m:]))
    u_full = u_full[:m].double()
    ortho = float(torch.linalg.norm(
        u_full.T @ u_full - torch.eye(k, dtype=u_full.dtype,
                                      device=u_full.device)))
    done("2d_mesh", bool(tally) and bool(torch.isfinite(s).all())
         and pad_norm < 1e-3 and ortho < 1e-2,
         f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} A {m}x{n} "
         f"(padded {a_pad.shape[0]}) k {k}", collectives=tally,
         sum_s=float(s.sum()), pad_norm=pad_norm, orth=ortho)

    prod = dict(q=q, k=k, method="eigh", precision="default",
                reorth="half", interior_qr="robust1")
    _, s_p, _ = rsvd_with_omega(a_sh, omega, **prod)
    _, s_1, _ = rsvd_with_omega(a_pad, omega, **prod)
    ds = max_rel(s_p, s_1)
    done("production", ds < 1e-4, "eigh/default/half/robust1 vs one rank",
         max_rel_dsigma=ds, bitwise=bool(torch.equal(s_p, s_1)))

    serve = dict(q=q, k=k, precision="default", reorth="half",
                 qr_method="cholqr1", interior_qr="cholqr1",
                 finish="rowspace_utv")
    u_sv, s_sv, v_sv = rsvd_with_omega(a_sh, omega, **serve)
    u_sl, s_sl, v_sl = rsvd_with_omega(a_pad, omega, **serve)
    e_sv = float(torch.linalg.norm(
        a_pad - (from_dtensor(u_sv).gather() * s_sv) @ v_sv.T))
    e_sl = float(torch.linalg.norm(a_pad - (u_sl * s_sl) @ v_sl.T))
    done("serving", abs(e_sv / e_sl - 1.0) < 1e-3,
         "rowspace_utv/cholqr1 vs one rank, error within 0.1%",
         err_over_single=e_sv / e_sl, max_rel_dweight=max_rel(s_sv, s_sl),
         bitwise=bool(torch.equal(s_sv, s_sl)))

    block = 2048 // n_ranks
    mine = to_numpy(a[rank * block:(rank + 1) * block])

    def err(u_l, s_l, v_l):
        """||A - U S V^T||_F over every rank's rows."""
        e = torch.from_numpy(mine).to(u_l.device) - (u_l * s_l) @ v_l.T
        return math.sqrt(float(collectives.all_reduce(
            torch.sum(e.double() ** 2))))

    stream = rsvd_streaming_multihost(mine, k=k, p=p, q=2, panel_rows=512,
                                      panel_dtype="int8", device=device)
    ds = float((stream[1][:8] - s_1[:8]).abs().max() / s_1[0])
    done("multihost_streaming", ds < 5e-2, "int8 panels, top 8 vs one "
         "rank", max_rel_dsigma_top8=ds)
    served = rsvd_streaming_multihost(mine, k=k, p=p, q=2, panel_rows=512,
                                      finish="rowspace_utv",
                                      qr_method="cholqr1", device=device)
    e_su, e_ref = err(*served), err(*stream)
    done("streamed_serving", e_su < 1.1 * e_ref + 1e-6,
         "rowspace_utv+cholqr1 vs project", err=e_su, err_project=e_ref)

    a_r = from_numpy(np.random.default_rng(1).standard_normal(
        (256 * n_ranks, 2048)), device=device, dtype=torch.float32)
    _, s_r, _ = rsvd_ring(make_mesh(device=device), a_r, k=k, p=p, q=1,
                          method="eigh")
    _, s_plain, _ = rsvd(a_r, k=k, p=p, q=1, method="eigh")
    ds = max_rel(s_r, s_plain)
    done("ring", ds < 1e-4, f"mesh ({n_ranks},) A {256 * n_ranks}x2048 "
         f"k {k}", max_rel_dsigma=ds)

    batch_mesh = make_mesh((n_ranks,), ("batch",), device)
    bsz, kb = 2 * n_ranks, 16
    a_b = from_numpy(np.random.default_rng(2).standard_normal(
        (bsz, 256, 256)), device=device, dtype=torch.float32)
    collectives.reset()
    u_b, s_b, _ = rsvd_batched(distribute(a_b, batch_mesh, (Shard(0),)),
                               k=kb, q=1, mode="vmap")
    tally = collectives.tally()
    per = s_b.to_local().shape[0]
    mine = slice(rank * per, (rank + 1) * per)
    _, s_b1, _ = rsvd_batched(a_b[mine], k=kb, q=1, seed=rank * per,
                              mode="scan")
    ds = float(((s_b.to_local() - s_b1).abs() / s_b1[:, :1]).max())
    ds = float(collectives.all_reduce(torch.tensor(ds, device=a_b.device),
                                      op="max"))
    done("batched_vmap", not tally and ds < 1e-3
         and all(t.placements == (Shard(0),) for t in (u_b, s_b))
         and per * n_ranks == bsz,
         f"batch {bsz}x256x256 k {kb} sharded {per} a rank, no "
         "collectives", max_rel_dsigma=ds, collectives=tally)

    grid = (2, n_ranks // 2) if n_ranks % 2 == 0 else (1, n_ranks)
    img_data = (np.random.default_rng(3).standard_normal((512, 512))
                * 40.0 + 128.0)
    collectives.reset()
    img = Image(img_data).compress_tiled(k=16, grid=grid, mesh=batch_mesh,
                                         device=device)
    tally = collectives.tally()
    img_1 = Image(img_data).compress_tiled(k=16, grid=grid, device=device)
    s_t, s_t1 = img.tile_factors.s, img_1.tile_factors.s
    ds = float(np.max(np.abs(s_t - s_t1) / s_t1[:, :1]))
    gap = float(np.max(np.abs(img.reconstruct() - img_1.reconstruct())))
    done("tiled_image", img.last_tile_sharding == (Shard(0),)
         and set(tally) <= {"all_gather"} and ds < 1e-3 and gap < 1.0,
         f"grid {grid} tiles split over the mesh, factors gathered",
         max_rel_dsigma=ds, rec_gap=gap, collectives=tally)
    return out


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "multichip":
        import os

        dryrun_multichip(int(os.environ.get("WORLD_SIZE", "1")))
