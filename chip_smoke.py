#!/usr/bin/env python3
"""Drive the PyTorch port's main path, its three-kernel ``rsvd()``
path, ``rsvd()`` at its defaults, the serving path, the image codec,
the other driver modes, PCA, the rsvd/pca command lines, POD/ROM, the
randomized-NLA extensions (block Krylov through K1/K2/K3 among them),
the tensor and hierarchical formats, GP, checkpoints and autodiff,
sparse operands and retrieval, kernel PCA, spectral clustering, the
sklearn estimators, out-of-core streaming, the distributed half (a
one-rank NCCL group, four ranks sharing the card over gloo), the
degenerate inputs of the JAX suite's edge cases, the factor checkpoint
on ``torch.distributed.checkpoint`` and the public API on row-sharded
operands on one CUDA card, and hold every kernel of those paths to its
plain PyTorch version.

Run from the repository root:  python3 chip_smoke.py  [--kernels-only]

Phases (any failure raises; nothing is caught):
1. Build every kernel from ``csrc/`` with nvcc for sm_90a, all at once,
   and log each ptxas report.
2. Each kernel against its plain version on the card, at the paths'
   shapes and at ragged ones (K1 and K2 also on a 4096 x 160 panel, past
   their 128-wide one-tile paths; K1 also on the rsvd command line's
   100/110/140/160 x 16 panels); K2's intermediates (``stage``) against
   the plain ones; two calls of K1 or K2 on one panel must agree bitwise;
   a rank-deficient panel must give non-finite (K1) or unhealthy (K2)
   output from both.  K1 and K2 report their launch plans, a profile of
   their kernels by stage and ptxas registers; K2 is also timed with its
   iteration's cluster set to 4 (the one-block iteration), 8 and 16
   blocks, measured only.  K3 (``eigh_small``) on the
   three-kernel path's l x l tail Gram and at n in K3_SIZES (16: the
   command line's l; 144 and 240: the streaming and Krylov tails; 241
   odd on the cluster route), on an indefinite and on a rank-deficient
   matrix, bitwise at every even n on the route its plan picks (one
   block, or a thread-block cluster); timed against
   ``torch.linalg.eigh`` at n = 80, 144 and 240, each with its rounds,
   us a round, bound, route and cluster size; and every route forced at
   K3_SWEEP_N (the one-block kernel, clusters of 2 to 16 blocks), each
   bitwise its plain version, measured only.  K4
   (``fused_sketch_matmul``) on the recovered Omega (A = I) and on Y at
   4096^2 x 80, a ragged 4099 x 4001 x 17 and l = 130; its 3xTF32
   tensor-core variant is only measured (time, recovered-Omega ulps, Y
   error), never checked or counted.  K5 (``quantize_uint8``, K5a
   deterministic and K5b stochastic) bitwise against its plain version
   on the image phase's factor shapes, 1-D 1000, 3 x 5 x 7, 4099 x
   4001, a constant, the 256-level grid and 16384^2; K5b within one
   level of K5a, unbiased at 6 sigma over 64 seeds, exact on the grid.
   K6 (``cast_sketch``) at 16384 x 8192 x 144, 4099 x 1040 x 17 and
   4096^2 x 80: its copy bitwise ``a.to(torch.bfloat16)``, Y within
   K6_Y_TOL of ``torch.mm`` on the same bf16 operands and of its plain
   version; at the fit's 100000^2 x 144 the same checks in row blocks
   against ``torch.mm``, then one ``rsvd()`` call at the fit's settings
   with K6's count zeroed just before (one launch, ``stage_tally()`` one
   fused copy; the kernels line reports that count); timed there and at
   4096^2 x 80 against the pair it replaces (``a.to(torch.bfloat16)``
   and ``torch.mm``), and swept over rows at n = 100000 and 16384 (the
   routing threshold).
   Kernel, plain version and library yardsticks are timed with CUDA
   events.  ``--kernels-only`` stops here.
3. The main path -- ``entry()``'s rank-64 rSVD (k=64, p=16, q=2) of a
   4096 x 4096 f32 operand made from seed 0, and the same configuration
   through ``rsvd()`` -- for precision 'highest', 'high' and 'default'
   (K1 for every orthonormalization: q + 1 = 3 launches per call); and
   the same
   configuration with ``interior_qr='polar_fused'`` through
   ``rsvd_with_omega`` (2 K2 launches and 1 K1 launch per call), and
   one ``torch.profiler`` pass over ``entry()``'s 'default' call.  Then
   the three-kernel path, ``rsvd(sketch='fused', method='eigh_pallas')``
   with K1 interiors, 'highest' and 'default' (K4, K1, K3 launched 1, 3
   and 1 times per call), with one ``torch.profiler`` pass over the
   'highest' call; and ``rsvd(A, k=64)`` at its defaults (the Jacobi
   tail), then with method 'parallel_jacobi', 'power' and 'auto'.
   Reconstruction errors are compared with a numpy f64 rSVD of the same
   k, p and q (``err_ratio_vs_numpy``, as bench.py computes it; for the
   fused sketch on the same Omega); singular values with the same call
   through the plain versions.  On the 'highest' and 'default' calls,
   where the Gram-eigh tail's U = Q U~ loses orthogonality:
   ||X^T X - I||_F of Q alone and of U~ and U with U~ from torch's eigh
   as it comes (``eigh_nan``) and from ``core/device.py::eigh`` (the
   tail's default), each beside an f64 eigh of the same Gram; the same
   on phase 9's Krylov calls.
4. The serving path: ``rsvd_serving(prepare_operand(A), k=64, p=16,
   q=2)`` on phase 3's operand, for storage 'int8' (pre-quantized),
   'bf16' and 'default', with 'cholqr1' interiors (no kernel) and
   'polar_fused' interiors (2 K2 launches per call); each must be healthy
   and within 1% of the numpy rSVD's error.  Then int8 serving of two
   operands drawn on the card, each against the port's own 'highest'
   finish='project' rSVD: a ragged 4099 x 4001 (k=64) and the HBM-bound
   16384 x 16384 (k=128).  One ``torch.profiler`` pass over each of
   these two calls, and over the 4096^2 int8 serving call with each
   interior.
5. The image codec (``apps/image.py``) on a seeded 4096^2 grayscale
   photo, no PIL needed: the CLI's steps -- normalize,
   ``compress_tiled(k=80, grid=(2, 2))``, restore, ``save_compressed``
   and ``load_compressed`` -- and K5a/K5b on the factors (3 launches
   each), counted; each tile's error within 1% of a numpy f64 rSVD on the
   same Omega, the factors back within half a codec step, K5's bytes
   within one level of the host codec's.  Then ``compress()`` at its
   default k on a 1024^2 crop (k = 256, Jacobi tail), on a 1024^2 x 3
   color image, and ``compress_video`` of 8 frames of 1080 x 1920 at
   k = 32, each within 1% of numpy on the same Omega.
6. The driver modes, each against a numpy f64 yardstick:
   ``rsvd_batched`` of 16 x 1024^2 (k = 64) in modes 'scan' and 'vmap'
   (per element, same Omega), ``rsvd_warm`` on phase 3's operand from
   the basis of a call on A + 1e-3 noise, ``rsvd_onepass`` (k = 64,
   within 1.5x of a q = 0 rSVD) and ``rsvd_adaptive`` at tol 1e-2 on a
   geometric spectrum (the f64 error within tol).
7. PCA and the command lines.  ``PCA(X)`` at its defaults on a
   262144 x 1024 f32 factor model made on the card (a per-feature offset,
   a 0.97^i spectrum, 1% noise), then with ``normalize=True``: the block
   Jacobi engine on the 1024 x 1024 R of the robust QR, each against the
   eigenvalues of the centred Gram in f64 (singular values, variance
   ratios, ||V^T V - I||_F, ||Xc - U S V^T||_F), with its time split by
   stage and one profiler pass over a block sweep and 128 rounds of a
   polish sweep;
   ``PCA(X, use_rsvd=True, rank=64)`` against an f64 rSVD on its Omega;
   ``jacobi_svd_chunked`` on the R against the engine's singular
   values, logging every sweep; ``StreamingPCA(1024, l=128)`` over X in
   4096-row batches in f64 and in f32, each never over the true
   eigenvalues and within FD's bound.  Then ``python -m
   rsvd_kamaneh_raganato_terrana_tpu_torch rsvd`` over data/input plus a
   2048^2 f32 .mtx written and read back bitwise, and ``pca
   data/pca/tourists.txt yes``, as subprocesses; and in-process
   ``rsvd data/input --method eigh_pallas --qr-method cholqr1_fused``,
   counted: per file one K3 launch and 1 + 2q = 5 K1 launches, each
   call's input kept and its output held to the plain version's on it;
   every file's error within 1e-4 of the default flags' run, and only
   the rank-deficient sparse_matrix non-finite, with the cholqr hint.
8. POD/ROM in f64.  ``pod_test02``, the reference's published
   deployment (N = 199, dt = 5e-4, 100 steps, every 5th sampled, 5 mu,
   energy POD with the full Jacobi SVD, rank 20): ``run_pod_pipeline``
   and ``run_new_param_study`` on the card and on the CPU, each FOM
   final solution against a scipy LU loop on the same operators, the
   POD's sigma against numpy's SVD of X_h^1/2 S, the card's ROM errors
   against the CPU's where the modes sit above roundoff, errors falling
   from rom size 2 to 8, the new-param errors printed beside the
   published ones; the ``pod`` command line in new-param mode,
   in-process; ``run_convergence_study`` at N = 499 (FOM orders in
   [0.7, 1.4]).  ``pod_h100``, the same study at 4096 nodes and 32 mu
   (S 4096 x 3200, the FOM's 32 x 4096^2 operator stacks): the pipeline
   and new-param study with their timings and peak memory, a FOM final
   solution against scipy, the POD's split (X_h eigh, S^T X_h S, rSVD),
   ``incremental_pod`` over the 32 per-mu batches against numpy's SVD
   of S (sigma and principal angles), the same stream in f32 through
   ``IncrementalSVD(method='eigh_pallas')`` with every K3 launch (32)
   held bitwise to its plain version and counted, and one profiled FOM
   step and ROM step.
9. The randomized-NLA extensions, each against an f64 yardstick on the
   card.  Block Krylov (``rsvd_krylov``) on an 8192^2 f32 operand with
   sigma_i = (i + 1)^(-1/2), k = 64, p = 16, q = 2: with
   ``qr_method='cholqr1_fused'`` and ``method='eigh_pallas'`` (K1 3 and
   K3 1 launches, counted; K3's launch bitwise its plain version on the
   240 x 240 Gram it was handed, each K1 call's dQ reported), with
   ``'polar_fused'`` (K2 3 launches, counted) and at its defaults; each
   error within 1% of an f64 Krylov's on the same Omega and below
   ``rsvd``'s at equal q, sigma within 1e-4 of sigma_1 of the same call
   through the plain versions, one profiler pass over the K1/K3 call, and
   non-finite output from K1 and its plain version on an operand of rank
   below l.  The diagnostics probes on the main path's factors (the
   certificates above the true f64 2-norm error), ``spectral_norm_
   estimate``/``stable_rank_estimate``; Nystrom, ``reigh``,
   ``reigh_generalized`` and ``nystrom_pcg`` on a 16384-point RBF kernel
   matrix against f64 eigvalsh; ``sketch_lstsq`` ('gaussian'/'sparse',
   damp 0 / > 0), ``sketch_minnorm`` and ``lstsq_residual`` on a
   262144 x 512 panel against f64 lstsq, CountSketch's embedding of its
   Q; Hutchinson, Hutch++, ``diag_estimate``, SLQ and ``logdet_psd``
   (dense and matrix-free) on an 8192^2 SPD matrix; ``rlu`` at 8192^2,
   ``cca`` on 262144-row views (its rSVD branch), ``dmd`` of 65536 x 401
   snapshots, ``rpca`` at 4096^2 (f32 and f64) and ``complete_lowrank``
   at 4096^2.  No kernel is on those paths but the probes' main-path
   call (K1 3 launches): checked.
10. The tensor and hierarchical formats, each against a truth known by
   construction or an f64 run on the card.  ``tucker`` and
   ``tucker_adaptive`` (tol 2e-3, cap 96) of a 1024^3 f32 tensor of
   multilinear rank 64 plus noise at 1e-3 of its norm (error within 1%
   of the noise, factors orthonormal, adaptive ranks 64), its factors
   through ``save_tensor_factors`` and back, one call under ``trace``
   (the chrome trace names its GEMM kernels); ``tt_decompose`` and
   ``tt_adaptive`` of a 128^4 tensor of TT rank 16 plus noise;
   ``cp_decompose`` 'als' (25 sweeps, weights within 1e-3 of the
   planted ones) and 'rand' of a 512^3 tensor of CP rank 16 plus noise;
   the Tucker video codec on 64 frames of 1080 x 1920 (a pan) at ranks
   (16, 96, 96) against per-frame ``compress_video`` at equal storage;
   ``complete_tucker`` of a 256^3 rank-8 tensor from 20% of its
   entries; ``hodlr_build`` of a 16384-point RBF kernel + 0.05^2 I
   (levels 5, k 24), its matvec, reconstruction and CG solve against the
   dense matrix and a dense f64 Cholesky solve; ``GP`` at
   benchmarks/gp_scale_bench.py's configuration (32768 points, levels
   6, rank 24, the implicit build; max |mean - f| < 0.1), its HODLR
   matrix through ``save_model``/``load_model``; a gradient through
   ``rsvd_with_omega`` at 4096^2 in f64 against central differences and
   ``torch.func.vmap(grad)`` over 4 x 1024^2; the main path's factors
   through ``save_factors`` (K1 3 launches, counted; no other part
   launches a kernel, which is checked).  Each stage timed by
   ``PhaseTimer``, its CSV logged.
11. Sparse operands, retrieval, kernel PCA, clustering, the estimators
   and out-of-core streaming.  A synthetic interaction matrix of
   MovieLens-20M's shape (138,493 x 26,744, 20,000,263 ratings from seed
   0): ``rsvd`` of the sparse A against the same call on the dense A
   (same Omega) and against itself (cuSPARSE is not bitwise), its CSR
   products timed against their bytes bound beside the layouts the
   driver does not take, one profiler pass; ``factorize_interactions``,
   ``top_k_items`` and ``top_k_items_quantized`` for 1024 users against
   a dense f64 score; ``RandomizedSVD`` on the sparse A, its variance
   ratios against scipy.sparse in f64.  ``KernelPCA`` 'randomized' and
   'nystrom' at 16384 points in 64-D and 'exact' at 1024 against f64
   eigvalsh of the centred kernel, ``transform`` of 4096 new rows.
   ``spectral_cluster`` of 8 planted blobs at 16384 points ('auto':
   ``reigh``; labels the planted ones up to a permutation) and of k-NN
   half moons at 2048 ('exact').  ``RandomizedPCA(n_components=64)`` on
   phase 7's factor model against the centred Gram's f64 spectrum.
   ``rsvd_streaming`` of a 100000^2 ``SynthesizedMatrix`` (rank 128 plus
   noise) with ``qr_method='cholqr1_fused'``, ``method='eigh_pallas'``
   (K1 2q + 1 = 5 and K3 1 launches, counted, each held to its plain
   version), its error within 1% of the noise by one more streamed pass;
   and of a 65536 x 16384 f32 A in pinned host memory on each wire
   ('none', 'bfloat16', 'int8') against the in-core rSVD on the same
   Omega, with the copies' rate and overlap, ``rsvd_streaming_onepass``
   and a checkpointed run stopped after two passes and resumed bitwise.
   No other part launches a kernel, which is checked.
12. The distributed half.  (a) A one-rank NCCL group in this process
   (after checking that two NCCL ranks on this host's one card are
   refused before any connection): the main path's 4096^2 operand
   through ``rsvd_sharded`` in the production configuration (eigh,
   'default', reorth 'half', 'robust1'), the serving configuration
   ('rowspace_utv', 'cholqr1'; error within 0.1%) and the kernel
   configuration (K1 interiors on the gathered panels, K3 tail: K1 3 and
   K3 1 launches, counted, each held to its plain version), and a
   pre-quantized 16384^2 int8 operand (k 128), each against the
   single-card ``rsvd_with_omega`` on the same Omega (max |ds| / s_1 <=
   1e-4, bitwise reported), with the collectives of each call and one
   profiler pass splitting a sharded call into NCCL and compute; then
   the single-card ``rsvd_streaming`` of phase 11's planted 100000^2
   operand with 625-row panels (K1 5, K3 1, counted).  (b) Four spawned
   ranks sharing the card over gloo (any rank's non-zero exit or the
   time limit fails the script): ``dryrun_multichip(4)``; the main path
   on a (4,) and a (2, 2) mesh, the serving and kernel configurations
   (K1 3, K3 1 a rank), the ring at 4096^2, each against the
   single-card call; a profiler split of one sharded call on rank 0
   into device time and time in the collectives; ``top_k_items_sharded``
   at MovieLens-20M's 26,744 items for 1024 users against
   ``top_k_items``; ``rsvd_streaming_multihost`` of the planted 100000^2
   operand, 25000 rows a rank, through K1 (2 a rank, on the replicated Z)
   and K3 (1), each launch held to its plain version, sigma within 1e-4
   of sigma_1 of the single-card call and the error over the noise
   within 1.01.  ``dryrun_multichip(4)`` includes the batched-vmap and
   tiled-image stages.
13. Sharded operands beyond the driver.  (a) A one-rank NCCL group in
   this process, every call at its phase's full size on a sharded
   operand against the single-card call, bitwise (the codecs, whose
   sharded runs factor with Householder QR, within the JAX dry run's
   1e-3 of sigma_1),
   with its collectives and both calls' wall seconds:
   ``rsvd_batched`` of 16 x 1024^2 (k 64, p 16) sharded on its batch
   dim, 'scan' and 'vmap', each also with ``method='eigh_pallas'`` (K3
   16 launches a call, each held to its plain version in 'scan');
   ``compress_tiled(mesh=)`` of the 4096^2 photo (k 80, (2, 2)) and
   ``compress_video(mesh=)`` of 8 x 1080 x 1920 (k 32); ``hutchinson``,
   ``hutchpp`` and ``logdet_psd`` at 8192^2; ``sketch_lstsq`` at
   262144 x 512; ``tucker`` of a planted 1024^3 (ranks 64) sharded on
   mode 0; ``rutv(qr_method='cholqr1_fused')`` at 4096^2 (K1 6
   launches on the gathered panels, each held to its plain version,
   dR <= 1e-5 of max |R|); ``complete_lowrank`` and ``rpca`` at 4096^2;
   ``rlu`` at 8192^2; ``nystrom_psd`` of the 16384-point RBF kernel;
   FrequentDirections(1024, 128) over phase 7's 262144 x 1024 rows with
   its buffer column-sharded; ``deim_fit`` of phase 9's 65536 x 401
   snapshots.  (b) Four spawned ranks sharing the card over gloo, the
   same calls (FD's stream and Tucker's side cut, P13B_*), each against
   the single call on rank 0 within 1e-4 (the batched calls and the
   codecs: the dry run's 1e-3; sigma-like quantities over
   their largest, spans by their largest sine, trace estimates and
   solutions relative, DEIM and rLU indices equal, FD's S^T S over its
   largest), beside the single call's own shift when every draw is
   multiplied by 1 + 1e-7 xi.
14. Item 13's edge cases on the card, through the kernels.  (a)
   ``svd(method='eigh_pallas')`` of a 1 x 1, a 20 x 1, a 1 x 15, a zero
   10 x 6 and a constant 16 x 12 (K3 at n = 1, 6, 12); K1 and K2 on a
   30 x 1 and a zero 12 x 4 panel (K1's NaN contract on the zero one);
   ``rsvd(k=0, p=50, q=1)`` of a 10 x 8 with ``sketch='fused'`` (K4, l
   clamped to 8), alone and with K1 interiors and the K3 tail, and
   ``rsvd`` at k = min(m, n) (12 x 9, k 9, p 4) by that route: every
   launch counted and held to its plain version, each result to
   tests/test_edge_cases.py's bar against numpy's f64 sigma, or to its
   f32 equivalent (P14_*).  (b) ``rsvd`` of a 1,048,576 x 1024 f32
   operand (k 256, p 16; U 1 GiB) through ``save_factors_dcp`` /
   ``load_factors_dcp``: one process, bitwise, with the save and load
   GB/s; then four spawned gloo ranks sharing the card, each saving its
   262,144 rows of the same U as a row-sharded DTensor and loading them
   back on the (4,) mesh, bitwise, each also loading the one-process
   checkpoint resharded onto the mesh, and rank 0 loading the whole U
   plain, bitwise.  The directories are removed at the end.
15. Row-sharded operands through the public API beyond ``rsvd``.  (a)
   A one-rank NCCL group in this process, every function of the slice
   at the size of the single-card phase that runs it, on a row-sharded
   (or mode-0-sharded) DTensor: ``rsvd_adaptive`` (phase 6's rank-512
   operand), ``rsvd_onepass`` with the K3 tail, ``rsvd_warm`` through K1
   (4096^2); ``column_id``,
   ``row_id``, ``cur``, ``leverage_sample`` (4096^2, rank 64 plus
   noise); ``rsvd_krylov`` through K1 and K3 and through K2, the four
   estimates of ``diagnostics.py`` (8192^2); ``reigh``,
   ``reigh_generalized``, ``nystrom_pcg`` (the 16384-point RBF kernel);
   ``sketch_lstsq`` sparse and damped, ``sketch_minnorm``,
   ``lstsq_residual`` (262144 x 512); ``cca`` (262144 x (512, 384));
   ``dmd`` (65536 x 401); ``PCA`` ('eigh' and ``use_rsvd``) and the two
   estimators (262144 x 1024); ``KernelPCA`` and the feature maps (16384
   points); ``tucker_adaptive`` (1024^3), TT (128^4), CP 'als' and 'rand'
   (512^3).  Each call against the single-card call, bitwise (the
   sparse sketch's atomics: within 1e-4), with ms sharded, ms single and
   rank 0's ms in the collectives, its collectives by kind, and every
   K1-K4 launch recorded and held to its plain version as phase 2 holds
   it (K1 and K2 by max |dQ|, K3 bitwise at even n); each kernel a call
   names launched at least once, no other.
   (b) Four spawned ranks sharing the card over gloo, the same calls at
   P15B's cuts, each within 1e-4 of the single call on rank 0 (the
   iterative ones 1e-3), beside the single call's own shift when every
   float draw is multiplied by 1 + 1e-7 xi.
16. Row-sharded operands through the rest of the public API.  (a) A
   one-rank NCCL group in this process, at P16A's sizes: ``qr_reduced``
   of a 4096 x 80 panel by every method (K1 and K2 on the gathered
   panel, K1's dR within 1e-5 of max |R|) and the ``cholesky_qr*`` /
   ``orthonormal_basis`` functions; ``svd`` of a 65536 x 240 panel by
   'eigh_pallas' (K3 at n = 240), 'eigh', 'jacobi', 'power' and 'xla',
   ``power_svd`` and ``power_triplet``; ``subspace_iteration`` and
   ``power_refine`` through K1, ``reconstruct`` and
   ``reconstruction_error`` (4096^2); ``rsvd_serving`` int8 4096^2 with
   ``factor_health`` and ``utv_rescore``; ``lanczos_tridiag`` (8192^2,
   30 steps); the DEIM functions (phase 9's 65536 x 401 snapshots' basis,
   'qdeim' and 'deim'); ``kernel_matrix`` (16384 points);
   ``standard_pod`` and ``naive_pod`` (pod_h100's snapshots, phase 8's);
   ``IncrementalSVD(method='eigh_pallas')`` over pod_h100's 32 batches
   (K3 each update); ``hodlr_build``/``hodlr_matvec``/``hodlr_solve``
   (phase 10's 16384, levels 5, k 24); the GP (32768 points, implicit:
   fit and predict; its log-likelihood); ``spectral_cluster`` (16384
   points, 8 blobs, and the median heuristic on 2); ``complete_tucker``
   (256^3).  Each call bitwise the single call, but ``svd``'s 'power'
   and 'xla' and the GP's log-likelihood, which compute differently by
   design and are held within 1e-4 beside the single call's own shift
   under a 1 + 1e-7 xi change of its draws and inputs; ms sharded and
   single, rank 0's ms in the collectives, every K1-K3 launch held to
   its plain version.  (b) Four spawned ranks sharing the card over
   gloo at P16B's cuts, each within 1e-4 of the single call (1e-3 for
   CG, Lanczos, k-means, the completion), or 10x that shift.
17. Sparse operands split by their entries over the ranks, ``PCA.
   add_data`` on row-sharded data, the exact ``KernelPCA`` on a sharded
   fit.  (a) A one-rank NCCL group in this process: MovieLens-20M's
   shape (phase 11's operand) split by entries through ``rsvd`` (its
   defaults, and through K1 and K3), ``rsvd_adaptive``, ``rsvd_onepass``,
   ``RandomizedSVD`` and the two error certificates, each within
   SP_SIGMA_TOL of the single call (cuSPARSE is not bitwise) beside the
   single call's own run-to-run and draw shifts, every K1 and K3 launch
   held to its plain version; ``PCA(X, method='eigh').add_data(Y)`` at
   phase 7's 262144 x 1024 plus 65536 rows and ``KernelPCA`` 'auto' at
   1024 points and 'exact' at 4096 (phase 11's width), bitwise.  (b)
   Four spawned ranks sharing the card over gloo at P17B's cuts, within
   the bars of (b) above.
18. A ``kernels`` JSON line, the card's name and power limit, and as the
   last line ``{"ok": true, "device": {...}}``.

Exits non-zero with no result line when no CUDA device is visible or
the package is not importable next to this script.
"""

import contextlib
import ctypes
import functools
import importlib
import io
import json
import math
import multiprocessing
import os
import queue
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import scipy.linalg
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from rsvd_kamaneh_raganato_terrana_tpu_torch import (
    factor_health,
    prepare_operand,
    rsvd,
    rsvd_adaptive,
    rsvd_batched,
    rsvd_onepass,
    rsvd_serving,
    rsvd_warm,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch import __main__ as cli
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import image
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import (
    cluster,
    estimators,
    kpca,
    retrieval,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps import advdiff, pca, pod, rom
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.gp import GP
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.pod import make_pod
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import checkpoint
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    from_dtensor,
    initialize,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.mesh import (
    distribute,
    make_mesh,
    shard_rows,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.profiling import (
    PhaseTimer,
    trace,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.config import (
    AdvDiffConfig,
    PodConfig,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import device
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.io import (
    read_matrix_market,
    write_matrix_market,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.entry import (
    CONFIG,
    dryrun_multichip,
    entry,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import (
    _build,
    jacobi,
    kernels,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import svd as linalg_svd
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.incremental import (
    IncrementalSVD,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.polar import polar_qr
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import qr_reduced
from rsvd_kamaneh_raganato_terrana_tpu_torch.native import get_codec
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops import sketching
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.sketching import (
    countsketch_apply,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import lstsq as lstsq_mod
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import streaming
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import (
    complete_lowrank,
    complete_tucker,
    cp_decompose,
    deim_fit,
    rutv,
    tucker,
    cp_reconstruct,
    hodlr_build,
    hodlr_compression_ratio,
    hodlr_matvec,
    hodlr_reconstruct,
    hodlr_solve,
    tt_adaptive,
    tt_decompose,
    tt_reconstruct,
    tucker_adaptive,
    tucker_reconstruct,
    diag_estimate,
    dmd,
    dmd_reconstruction_error,
    factorization_error_estimate,
    hutchinson,
    hutchpp,
    logdet_psd,
    lstsq_residual,
    nystrom_pcg,
    nystrom_psd,
    range_error_estimate,
    reigh,
    reigh_generalized,
    rlu,
    rlu_reconstruct,
    rlu_solve,
    rpca,
    rsvd_krylov,
    sketch_lstsq,
    sketch_minnorm,
    slq_trace,
    spectral_norm_estimate,
    stable_rank_estimate,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    generate_omega,
    quantize_int8_rows,
    reconstruction_error,
    rsvd_sharded,
    rsvd_with_omega,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.multihost import (
    rsvd_streaming_multihost,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.ring import rsvd_ring

# the package's ``rsvd.cca`` and ``rsvd.tucker`` attributes are the
# functions of those names
cca_mod = importlib.import_module(
    "rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.cca")
cca = cca_mod.cca
tucker = importlib.import_module(
    "rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.tucker").tucker

M = N = 4096
K, P, Q = 64, 16, 2
BIG, BIG_K = 16384, 128   # the HBM-bound serving point
RAGGED = (4099, 4001)     # widths that are not multiples of 16
ERR_RATIO_MAX = 1.01     # rSVD error within 1% of the f64 numpy rSVD
# max |ds| / s_1, kernel path vs plain path.  'highest' differs by fp32
# roundoff only; under 'default' an fp32-level change in Q can flip the
# bf16 rounding of single GEMM operands (bf16 eps 3.9e-3)
# 'high' is TF32 (10-bit operands): the same flips as bf16's, at 1/4 the
# step
SIGMA_TOL = {"highest": 1e-4, "high": 5e-4, "default": 5e-4}
Q_TOL = 1e-4             # K1: max |dQ| (Q has orthonormal columns)
R_TOL = 1e-4             # K1: max |dR| / max |R|
ORTH_TOL = 1e-4          # max |Q^T Q - I| of a kernel's Q
K2_Q_TOL = 2e-4          # K2: max |dQ|, the JAX fused-vs-composed bound
K2_STAGE_TOL = 1e-4      # K2: max |d stage| / max |stage|
K2_SYM_TOL = 1e-5        # K2: max |R - R^T| / max |R|, cond ~1
K2_NORM_TOL = 1e-3       # K2: column norms of R against Y's, relative
SERVING_PLAIN_TOL = 1e-3  # polar serving, kernel vs plain K2 recon error
# 16: the rsvd command line's l; 144: the streaming and sharded tails'
# l; 240: the Krylov tail's l(q + 1); 241: an odd n on the cluster route
K3_SIZES = (1, 2, 16, 17, 128, 144, 200, 240, 241)
# K3 timed against torch.linalg.eigh at these n (80: the main path's tail
# Gram) and every route timed at K3_SWEEP_N (measured only)
K3_TIMED = (80, 144, 240)
K3_SWEEP_N = (16, 32, 48, 64, 80, 96, 128, 144, 200, 240)
K3_SWEEP_CLUSTERS = (2, 4, 8, 16)
K3_LAM_TOL = 1e-5        # K3: max |d lambda| / max |lambda| vs plain, odd n
# K3: max |V^T V - I| and ||V L V^T - G||_F / ||G||_F of the kernel's own
# factors on full-rank inputs: the JAX suite's orthogonality bound
# (tests/test_pallas.py:112).  The TPU kernel's arithmetic computes c, s
# per row of a G that is not exactly symmetric, so its rotations are not
# exactly orthogonal and the drift grows with the round count: JAX's own
# kernel gives 4.0e-4 / 2.8e-4 on the main path's l = 80 tail Gram
K3_ORTH_TOL = K3_REC_TOL = 1e-3
K4_OMEGA_ULPS = 4        # K4: recovered Omega vs plain, in ulps of |Omega|
K4_Y_TOL = 1e-5          # K4: max |dY| / max |Y| vs plain
# K6: max over Y of |dY| / (|a16| @ |Omega|), against torch.mm on the same
# bf16 operands: both add the same exact products in f32, in another
# order (expected ~1e-7 at n = 8192, the worst case n 2^-24 = 4.9e-4)
K6_Y_TOL = 1e-5
K6_CHECKS = ((16384, 8192, 144), (4099, 1040, 17), (4096, 4096, 80))
K6_MAIN = (100000, 100000, 144)    # the fit's first product
K6_NARROW = (4096, 4096, 80)       # phase 3's
K6_BLOCK_ROWS = 10000              # the row blocks of the check at K6_MAIN
# the sweep that sets driver._CAST_SKETCH_WAVES: rows at l = 144 and each
# width (the fit's n, and a narrower one)
K6_SWEEP_ROWS = (1024, 2048, 4096, 6144, 8192, 8448, 12288, 16384, 16896,
                 25600, 33792, 50000, 100000)
K6_SWEEP_COLS = (100000, 16384)
K6_FIT = dict(k=128, p=16, q=2, method="eigh", qr_method="cholqr1_fused",
              interior_qr="cholqr1_fused", reorth="half")
DEFAULT_P = 10           # rsvd()'s default oversampling
FUSED = dict(k=K, p=P, q=Q, seed=0, method="eigh_pallas", sketch="fused",
             qr_method="cholqr1_fused", interior_qr="cholqr1_fused",
             reorth="half")
ENGINES = ("jacobi", "parallel_jacobi", "power", "auto")
# the H100 SXM's published peaks: dense fp32 FLOP/s and HBM3 bytes/s
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
POLAR_ITERS = 8
K2_STAGES = ("gram", "gt", "w1", "h1", "h2", "h4", "h8")
K5_SEED = 7
IMG_SIDE, IMG_K, IMG_GRID = 4096, 80, (2, 2)   # the image CLI's defaults
COLOR_SIDE = 1024
VIDEO, VIDEO_K = (8, 1080, 1920), 32
BATCH, BATCH_SIDE = 16, 1024
ONEPASS_RATIO_MAX = 1.5   # "a constant factor behind" a q = 0 rSVD
ADAPTIVE_TOL, ADAPTIVE_RATIO = 1e-2, 0.97    # expected k = 152
PCA_ROWS, PCA_D = 262144, 1024   # X: 1 GiB f32; d > 512: the block engine
PCA_DECAY, PCA_NOISE, PCA_OFFSET = 0.97, 0.01, 5.0
PCA_SIG_TOL = 1e-4        # max |ds| / s_1 against the f64 yardstick
PCA_RATIO_TOL = 1e-4      # explained-variance ratios, absolute
PCA_ORTH_TOL = 1e-3       # check_orthogonality(): ||V^T V - I||_F
PCA_RECON_TOL = 1e-4      # ||Xc - U S V^T||_F / ||Xc||_F
PCA_RANK = 64             # the use_rsvd path
CHUNKED_TOL = 1e-5        # chunked vs single-dispatch, max |ds| / s
POLISH_PROFILE_ROUNDS = 128
STREAM_L, STREAM_K, STREAM_BATCH = 128, 64, 4096
STREAM_OVER_TOL = 1e-4    # relative slack over the true eigenvalues
MTX_SIDE = 2048
CLI_ROWS, CLI_L = (100, 110, 140, 160), 16   # data/input's m; l = k + p
CLI_ERR_TOL = 1e-4        # sparse_matrix's error over ||A||_F, f32
# PC1's variance ratio on tourists.txt, normalized (the JAX CLI: 0.8961)
TOURISTS_PC1, TOURISTS_TOL = 0.896, 1e-3
# phase 8: the reference's published POD deployment (BASELINE.md:21-23;
# mu_new as tests/test_pod.py:177 reads its file) and the same study at
# 20x its mesh and 32 parameters
POD_TEST02 = dict(
    adv=dict(N=199, deltat=5e-4, T=0.05, sample_every=5),
    pod=dict(n=5, mu_min=0.01, mu_max=0.05, mu_new=0.0025, rank=20,
             tol=1e-12, pod_type=2, svd_type=1,
             rom_sizes=(2, 4, 6, 8, 10, 20)))
POD_H100 = dict(
    adv=dict(N=4094, deltat=5e-4, T=0.05, sample_every=1, amplitude=1.0),
    pod=dict(n=32, mu_min=0.01, mu_max=0.05, mu_new=0.03, rank=20,
             tol=1e-12, pod_type=2, svd_type=4,
             rom_sizes=(2, 4, 6, 8, 10, 20)))
# published relative L2 errors of test02's new-param study
# (BASELINE.md:23), printed beside the card's for information only
PUBLISHED_TEST02 = {2: 0.3367, 4: 0.1027, 6: 0.0488, 8: 0.0117, 10: 0.00528,
                    20: 0.0107}
# tests/test_advdiff.py:53's temporal convergence configuration
CONV_ADV = dict(beta=0.2, u0_choice=0, amplitude=1.0, N=499, T=0.05,
                deltat=1e-3, theta=1.0, sample_every=1)
CONV_DTS, CONV_MU, CONV_ROM_SIZE = (5e-3, 2.5e-3, 1.25e-3), 0.05, 8
ORDER_RANGE = (0.7, 1.4)   # tests/test_advdiff.py:62
FOM_SCIPY_TOL = 1e-11     # FOM final solution vs a scipy LU loop, relative
POD_SIG_KEEP = 1e-4       # sigma_i >= 1e-4 sigma_1 are held ...
POD_SIG_TOL = 1e-7        # ... to 1e-7 of numpy's (the Gram route, f64)
ROM_MODE_KEEP = 1e-6      # rom sizes whose modes all have sigma_i >= this
ROM_CPU_TOL = 1e-6        # card vs CPU ROM errors, relative
CLI_POD_TOL = 1e-9        # the pod command line vs the in-process study
INC_SIG_TOL = 1e-6        # incremental sigma vs numpy (tests/test_incremental.py:54)
INC_ANGLE_TOL = 1e-5      # rad, incremental span vs numpy's
# phase 9: the randomized-NLA extensions
KRY_N = 8192              # block Krylov operand, sigma_i = (i + 1)^(-1/2)
KRY_L = (K + P) * (Q + 1)  # 240: the l(q+1) x l(q+1) Gram K3 factors
KRY_RATIO_MAX = 1.01      # error over the f64 Krylov's on the same Omega
KRY_RANK_DEFICIENT = (4096, 32)   # side, rank < l: K1's NaN contract
# the certificate's factor 10 sqrt(2/pi), and the bound on how far its
# probe norms (max ||E g||) can sit above ||E||_F
PROBE_FACTOR = 10.0 * math.sqrt(2.0 / math.pi)
PROBE_FRO_SLACK = 1.5
SPECTRAL_TOL = 1e-3       # spectral_norm_estimate vs sigma_1, gapped operand
NYS_POINTS, NYS_DIM, NYS_H = 16384, 8, 2.0   # RBF kernel matrix, 1 GB f32
NYS_K, NYS_OVER_TOL = 128, 1e-4   # Nystrom eigenvalues never over the true
NYS_RECON_MAX = 3.0       # ||A - U L U^T||_F / optimum (tests/test_nystrom.py:51)
REIGH_K, REIGH_TOP, REIGH_TOL = 64, 16, 1e-4
GEN_K, GEN_RESID_TOL, GEN_ORTH_TOL = 8, 1e-2, 1e-3
PCG_MU_REL, PCG_RANK, PCG_ITERS = 1e-3, 50, 30
LS_ROWS, LS_COLS, LS_RHS = 262144, 512, 4    # 512 MB f32
LS_COND, LS_NOISE, LS_DAMP_REL = 30.0, 1e-2, 1.0
LS_RESID_TOL = 1e-4       # relative residual over the f64 optimum's
LS_RES_FN_TOL = 1e-4      # lstsq_residual vs the f64 residual, relative
CS_SIZE = 16 * LS_COLS    # CountSketch rows for the embedding check
CS_RANGE = (0.5, 1.5)     # singular values of S Q
CS_CPU_TOL = 1e-5         # card vs CPU on the same S, relative (atomics)
TR_N = 8192               # SPD operand, eigenvalues logspace(0, -2)
TR_SIGMAS = 5.0           # Hutchinson / Hutch++ within 5 standard errors
TR_DIAG_OUT = 2.0 / 150   # diag outliers past 5 se (tests/test_trace.py:141)
SLQ_TRACE_TOL, LOGDET_TOL = 0.1, 0.05   # tests/test_slq.py:48-60
RLU_N, RLU_RANK, RLU_NOISE = 8192, 64, 1e-4
RLU_RATIO_MAX, RLU_SOLVE_TOL = 2.0, 1e-3
CCA_ROWS, CCA_P, CCA_Q, CCA_SHARED, CCA_K = 262144, 512, 384, 8, 8
CCA_TOL = 1e-4            # correlations vs the exact branch in f64
DMD_N, DMD_M, DMD_PAIRS = 65536, 401, 8     # 16 discrete eigenvalues
DMD_EIG_TOL = 1e-4
RPCA_N, RPCA_RANK, RPCA_FRAC, RPCA_ITERS = 4096, 8, 0.05, 40
RPCA_TOL = 1e-3
COMP_N, COMP_RANK, COMP_FRAC, COMP_ITERS = 4096, 10, 0.2, 30
COMP_TOL = 1e-2           # unobserved RMSE over the entries' RMS
# phase 10: tensor and hierarchical formats
TENSOR_NOISE = 1e-3       # planted noise norm over the signal's
NOISE_SLACK = 1.01        # ||A - A_hat||_F over the planted ||N||_F
FORMAT_ORTH_TOL = 1e-4    # max |U^T U - I| of a Tucker factor
TUCKER_N, TUCKER_R = 1024, 64          # 1024^3 f32, 4.3 GB
TUCKER_TOL, TUCKER_CAP = 2e-3, 96      # tucker_adaptive: ranks (64, 64, 64)
TT_N, TT_R, TT_TOL, TT_CAP = 128, 16, 3e-3, 24   # 128^4 f32, 1.07 GB
CP_N, CP_R, CP_SWEEPS = 512, 16, 25    # 512^3 f32, 537 MB
CP_W_TOL = 1e-3           # CP-ALS weights vs the planted ones, relative
TVIDEO, TVIDEO_RANKS, TVIDEO_TERMS = (64, 1080, 1920), (16, 96, 96), 24
CT_N, CT_R, CT_FRAC, CT_ITERS = 256, 8, 0.2, 30
CT_TOL = 1e-2             # complete_tucker: unobserved RMSE over the RMS
HODLR_N, HODLR_LEVELS, HODLR_K = 16384, 5, 24    # 1.07 GB f32 kernel
HODLR_TOL = 1e-4          # matvec / reconstruction / solve residual
GP_N, GP_LEVELS, GP_RANK, GP_NOISE = 32768, 6, 24, 0.05
GP_TEST, GP_MEAN_TOL = 512, 0.1        # benchmarks/gp_scale_bench.py:27-58
AD_N, AD_K, AD_P, AD_FD_TOL = 4096, 64, 16, 1e-6   # tests/test_autodiff.py:48
VMAP_N, VMAP_B, VMAP_TOL = 1024, 4, 1e-3
# phase 11: sparse operands, retrieval, kernel PCA, clustering, the
# estimators and out-of-core streaming
ML20M = (138493, 26744, 20000263)   # GroupLens ml-20m: users, items, ratings
ML_ZIPF = (0.4, 0.5)      # activity / popularity exponents (users, items)
ML_FACTORS = 16           # rank of the planted preference model
SP_SIGMA_TOL = 1e-4       # sparse vs dense rsvd on the same Omega, of sigma_1
RET_USERS, RET_TOPK = 1024, 10
RET_TIE = 1e-5            # f64 score gaps below this (of max |score|) excuse
RET_OVERLAP = 8           # quantized top-10 overlap (tests/test_retrieval.py)
EST_RATIO_TOL = 1e-6      # explained_variance_ratio_ vs f64, absolute
                          # (tests/test_estimators.py:37-38)
KPCA_N, KPCA_D, KPCA_K, KPCA_DECAY = 16384, 64, 16, 0.7
KPCA_NEW, KPCA_EXACT_N = 4096, 1024
KPCA_RAND_TOL = 1e-4      # 'randomized' eigenvalues vs f64, of lambda_1
KPCA_NYS_P, KPCA_NYS_TOL = 64, 1e-2   # 'nystrom' (tests/test_kpca.py:75-84)
KPCA_EXACT_TOL = 1e-5     # 'exact' (f32 eigh) vs f64, of lambda_1
KPCA_TRANSFORM_TOL = 1e-4  # transform vs its f64 evaluation, of max |z|
CL_N, CL_K, CL_D, CL_SCALE = 16384, 8, 16, 5.0
CL_GAMMA = 1.0 / (2 * CL_D)   # 1 / (2 d sigma^2) of the unit-variance blobs
MOONS_N, MOONS_NOISE, MOONS_ACC = 2048, 0.05, 0.99  # test_cluster.py:25-33
EST_PCA_P, EST_PCA_Q = 32, 3   # RandomizedPCA's sketch on the 0.97^i spectrum
EST_PCA_TOL = 1e-4        # sigma vs the centred Gram's f64, of sigma_1
NS_N, NS_RANK, NS_K, NS_P = 100000, 128, 128, 16   # BASELINE.md:29-32
NS_EDGE = 1e-2            # K1's operand: noise's spectral edge / sigma_1
HOST_M, HOST_N, HOST_RANK, HOST_K, HOST_Q = 65536, 16384, 64, 64, 1
STREAM_TOL = 1e-4         # streamed vs in-core sigma, of sigma_1


T_START = time.perf_counter()


def log(msg):
    print(msg, flush=True)


def phase(title):
    """A phase's heading, with the seconds since the script started."""
    log(f"{title} (at {time.perf_counter() - T_START:.1f} s)")


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes):
    """(bound_ms, bound_by): the least time the card could take."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def numpy_rsvd(a, l, q, seed=0, omega=None):
    """The numpy baseline of bench.py:87-99, in f64; ``omega`` replaces
    its Gaussian draw when given."""
    if omega is None:
        omega = np.random.default_rng(seed).standard_normal((a.shape[1], l))
    q_mat, _ = np.linalg.qr(a @ omega)
    for _ in range(q):
        qz, _ = np.linalg.qr(a.T @ q_mat)
        q_mat, _ = np.linalg.qr(a @ qz)
    u_t, s, vt = np.linalg.svd(q_mat.T @ a, full_matrices=False)
    return q_mat @ u_t, s, vt.T


def recon_err(a, u, s, v):
    return float(np.linalg.norm(a - (u[:, :K] * s[:K]) @ v[:, :K].T))


WRAPPERS = ("fused_cholqr1", "polar_qr_fused", "eigh_small",
            "fused_sketch_matmul", "quantize_uint8")   # K1, K2, K3, K4, K5
# (wrapper, count attribute) of each kernel: K5's wrapper launches K5a or
# K5b and counts each apart
COUNTERS = tuple((w, "launches") for w in WRAPPERS) + (
    ("quantize_uint8", "launches_stochastic"),)
NONE = (0,) * len(COUNTERS)


def plain_kernels():
    """Every kernel wrapper swapped for its plain version."""
    return mock.patch.multiple(kernels, **{
        w: getattr(kernels, f"{w}_reference") for w in WRAPPERS})


def reset_counts():
    for w, attr in COUNTERS:
        setattr(getattr(kernels, w), attr, 0)


def counts():
    """(K1, K2, K3, K4, K5a, K5b) launches since the last reset."""
    return tuple(getattr(getattr(kernels, w), attr) for w, attr in COUNTERS)


def launches_of(k1=0, k2=0, k3=0, k4=0, k5a=0, k5b=0):
    return (k1, k2, k3, k4, k5a, k5b)


def panels(a):
    """Phase 2's panels: Y = A Omega at the paths' 4096 x 80, a cond-100
    panel (tests/test_polar.py:28-33), ragged and tall ones."""
    omega = generate_omega(0, N, K + P, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    y_main = device.matmul_at(a, omega, "highest")
    u, _ = torch.linalg.qr(torch.randn(4096, 80, device="cuda",
                                       generator=gen))
    v, _ = torch.linalg.qr(torch.randn(80, 80, device="cuda", generator=gen))
    s = torch.logspace(2, 0, 80, device="cuda")
    with device.ieee_fp32():
        y_cond = (u * s) @ v.T
    return y_main, {
        "main Y = A @ Omega 4096x80": (y_main, True),
        "cond-100 4096x80": (y_cond, False),
        "ragged 4099x17": (torch.randn(4099, 17, device="cuda",
                                       generator=gen), True),
        "ragged 1000x128": (torch.randn(1000, 128, device="cuda",
                                        generator=gen), True),
        "panel 16384x80": (torch.randn(16384, 80, device="cuda",
                                       generator=gen), True),
        # past l = 128: K1's and K2's wide paths (tiled Gram and apply,
        # K1's elimination over the workspace, K2's one-block iteration)
        "wide 4096x160": (torch.randn(4096, 160, device="cuda",
                                      generator=gen), True),
    }


def cli_panels():
    """K1 at the rsvd command line's shapes: an m x 16 panel for each
    m of data/input (100, 110, 140, 160)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    return {f"cli {m}x{CLI_L}": (torch.randn(m, CLI_L, device="cuda",
                                             generator=gen), True)
            for m in CLI_ROWS}


def rank_deficient():
    y = torch.randn(1000, 64, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    y[:, 32:] = y[:, :32]                          # exact rank 32 < l
    return y


def orth_err(q):
    with device.ieee_fp32():
        gram = q.T @ q
    return float((gram - torch.eye(q.shape[1], device="cuda")).abs().max())


def panel_plan(fn, m, l, keys):
    """A panel kernel's launch plan at (m, l) as its library reports it
    (``rsvd_cholqr1_plan``, ``rsvd_polar_plan``)."""
    fn.restype = None
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_longlong)]
    out = (ctypes.c_longlong * len(keys))()
    fn(m, l, out)
    return dict(zip(keys, out))


def k1_plan(m, l):
    return panel_plan(kernels._cholqr1_lib().rsvd_cholqr1_plan, m, l,
                      ("narrow", "gram_blocks", "rows_per_split",
                       "partials", "elim_smem_bytes"))


def k2_plan(m, l):
    return panel_plan(kernels._polar_lib().rsvd_polar_plan, m, l,
                      ("cluster_path", "cluster", "band_rows",
                       "gram_blocks", "partials", "iter_smem_bytes"))


def bitwise_twice(fn, y):
    """Two calls of ``fn`` on the same panel give bitwise equal outputs."""
    first = fn(y)
    second = fn(y)
    torch.cuda.synchronize()
    return all(torch.equal(x, z) for x, z in zip(first, second))


def stage_profile(call):
    """Device ms per call by kernel group and the launch gaps (wall minus
    busy), from one profiler pass over 20 calls."""
    prof = profile_call(call, reps=20)
    return dict(prof["ms_per_call_by_group"],
                wall_ms=prof["wall_ms_per_call"],
                busy_ms=prof["device_busy_ms_per_call"])


def phase_k1(y_main, all_panels):
    """K1 against its plain version; returns its kernels-line fields."""
    worst_q = worst_r = 0.0
    for name, (y, _) in dict(all_panels, **cli_panels()).items():
        if name.startswith("cond"):
            continue
        q, r = kernels.fused_cholqr1(y)
        q0, r0 = kernels.fused_cholqr1_reference(y)
        torch.cuda.synchronize()
        check(q.shape == q0.shape and r.shape == r0.shape, name)
        check(bool(torch.isfinite(q).all() and torch.isfinite(r).all()),
              f"{name}: non-finite output")
        dq = float((q - q0).abs().max())
        dr_rel = float((r - r0).abs().max()) / float(r0.abs().max())
        orth = orth_err(q)
        lower = float(torch.tril(r, -1).abs().max())
        log(f"  K1 {name}: max|dQ|={dq:.3e} max|dR|/max|R|={dr_rel:.3e} "
            f"max|Q^T Q - I|={orth:.3e} max|tril(R)|={lower:.1e}")
        check(dq <= Q_TOL and dr_rel <= R_TOL,
              f"{name}: kernel vs plain dQ={dq} dR/R={dr_rel}")
        check(orth <= ORTH_TOL and lower == 0.0,
              f"{name}: |Q^T Q - I|={orth} |tril(R)|={lower}")
        same = bitwise_twice(kernels.fused_cholqr1, y)
        log(f"  K1 {name}: plan {k1_plan(*y.shape)}, two calls bitwise "
            f"equal: {same}")
        check(same, f"{name}: K1 not deterministic")
        worst_q, worst_r = max(worst_q, dq), max(worst_r, dr_rel)

    y_def = rank_deficient()
    for label, fn in (("kernel", kernels.fused_cholqr1),
                      ("plain", kernels.fused_cholqr1_reference)):
        q, r = fn(y_def)
        finite = bool(torch.isfinite(q).all() and torch.isfinite(r).all())
        log(f"  K1 rank-deficient 1000x64 ({label}): finite={finite}")
        check(not finite, f"rank-deficient panel gave finite {label} output")

    m, l = y_main.shape
    ms = cuda_ms(lambda: kernels.fused_cholqr1(y_main), 50)
    plain_ms = cuda_ms(lambda: kernels.fused_cholqr1_reference(y_main), 10)
    lib_ms = cuda_ms(lambda: torch.linalg.qr(y_main, mode="reduced"), 20)
    # the symmetric Gram ml(l+1), the triangular apply Y (L^-1)^T
    # ml(l+1), Cholesky and triangular inverse (2/3) l^3; Y read, Q and R
    # written.  At 4096 x 80 the two times tie within 1%
    bound_ms, bound_by = bound(2 * m * l * (l + 1) + 2 * l ** 3 / 3,
                               4 * (2 * m * l + l * l))
    nc = -(-l // 16)
    ptxas = {k: ptxas_report("cholqr1", e) for k, e in (
        ("gram", f"gram_clusterILi{nc}E"),
        ("eliminate", f"eliminate_clusterILi{-(-2 * l // 32)}E"),
        ("apply", f"apply_rowsILi{nc}ELb1ELb1E"),
        ("eliminate_wide", "eliminate_wide"))}
    stages = stage_profile(lambda: kernels.fused_cholqr1(y_main))
    log(f"  K1 at {m}x{l}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.linalg.qr {lib_ms:.4f} ms, bound {bound_ms * 1e3:.3f} us "
        f"({bound_by}); stages {json.dumps(stages)}; ptxas {ptxas}")
    return dict(max_abs_err=worst_q, max_rel_err_r=worst_r, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_us=bound_ms * 1e3, bound_by=bound_by,
                stages_ms=stages, ptxas=ptxas)


def k2_unhealthy(q, r):
    """factor_health of a polar factorization as the JAX suite reads it
    (tests/test_polar.py:87-103): U = Q, s = R's sorted column norms."""
    s = torch.sort(torch.linalg.norm(r, dim=0), descending=True).values
    return not factor_health(q, s, q)["ok"]


def phase_k2(y_main, all_panels):
    """K2 and its stages against the plain version; returns its
    kernels-line fields."""
    worst_q = worst_stage = 0.0
    for name, (y, well_conditioned) in all_panels.items():
        q, r = kernels.polar_qr_fused(y)
        q0, r0 = kernels.polar_qr_fused_reference(y)
        torch.cuda.synchronize()
        check(q.shape == q0.shape and r.shape == r0.shape, name)
        check(bool(torch.isfinite(q).all() and torch.isfinite(r).all()),
              f"{name}: non-finite K2 output")
        dq = float((q - q0).abs().max())
        sym = float((r - r.T).abs().max() / r.abs().max())
        sym0 = float((r0 - r0.T).abs().max() / r0.abs().max())
        with device.ieee_fp32():
            norms = torch.linalg.norm(r, dim=0) / torch.linalg.norm(y, dim=0)
        dnorm = float((norms - 1.0).abs().max())
        orth = orth_err(q)
        stage_err = {}
        for st in K2_STAGES:
            got = kernels.polar_qr_fused(y, stage=st)
            want = kernels.polar_qr_fused_reference(y, stage=st)
            stage_err[st] = float((got - want).abs().max()
                                  / want.abs().max())
        log(f"  K2 {name}: max|dQ|={dq:.3e} max|Q^T Q - I|={orth:.3e} "
            f"max|R-R^T|/max|R|={sym:.2e} (plain {sym0:.2e}) "
            f"max|colnorm(R)/colnorm(Y)-1|="
            f"{dnorm:.2e} stages " + " ".join(
                f"{k}={v:.1e}" for k, v in stage_err.items()))
        check(dq <= K2_Q_TOL, f"{name}: K2 vs plain dQ={dq}")
        check(not well_conditioned or orth <= ORTH_TOL,
              f"{name}: K2 |Q^T Q - I|={orth}")
        # R = W_s G is symmetric up to W_s's roundoff, which grows with
        # cond(Y)^2: held to 1e-5 when well-conditioned, else to 4x the
        # plain version's own asymmetry
        check(sym <= max(K2_SYM_TOL, 0.0 if well_conditioned else 4 * sym0)
              and dnorm <= K2_NORM_TOL,
              f"{name}: K2 R symmetry {sym} (plain {sym0}), column norms "
              f"{dnorm}")
        check(max(stage_err.values()) <= K2_STAGE_TOL,
              f"{name}: K2 stages {stage_err}")
        same = bitwise_twice(kernels.polar_qr_fused, y)
        log(f"  K2 {name}: plan {k2_plan(*y.shape)}, two calls bitwise "
            f"equal: {same}")
        check(same, f"{name}: K2 not deterministic")
        worst_q = max(worst_q, dq)
        worst_stage = max(worst_stage, max(stage_err.values()))

    y_def = rank_deficient()
    for label, fn in (("kernel", kernels.polar_qr_fused),
                      ("plain", kernels.polar_qr_fused_reference)):
        bad = k2_unhealthy(*fn(y_def))
        log(f"  K2 rank-deficient 1000x64 ({label}): unhealthy={bad}")
        check(bad, f"rank-deficient panel gave healthy {label} K2 factors")

    m, l = y_main.shape
    ms = cuda_ms(lambda: kernels.polar_qr_fused(y_main), 50)
    plain_ms = cuda_ms(lambda: kernels.polar_qr_fused_reference(y_main), 10)
    lib_ms = cuda_ms(lambda: torch.linalg.qr(y_main, mode="reduced"), 20)
    comp_ms = cuda_ms(lambda: polar_qr(y_main), 20)
    # the symmetric Gram ml(l+1) and the full apply Y W_s 2ml^2; 4 l x l
    # products of 2l^3 per step (3 in the first, plus R = W_s G); Y read,
    # Q and R written
    bound_ms, bound_by = bound(m * l * (l + 1) + 2 * m * l * l
                               + 8 * POLAR_ITERS * l ** 3,
                               4 * (2 * m * l + l * l))
    nc = -(-l // 16)
    band = k2_plan(m, l)["band_rows"]
    ptxas = {k: ptxas_report("polar", e) for k, e in (
        ("gram", f"gram_clusterILi{nc}E"),
        ("iterate", f"ns_clusterILi{band}E"),
        ("apply", f"apply_rowsILi{nc}ELb0ELb0E"),
        ("iterate_one_block", "ns_iterate"))}
    stages = stage_profile(lambda: kernels.polar_qr_fused(y_main))
    clusters = k2_cluster_sizes(y_main)
    log(f"  K2 at {m}x{l}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.linalg.qr {lib_ms:.4f} ms, polar_qr composition "
        f"{comp_ms:.4f} ms, bound {bound_ms * 1e3:.3f} us ({bound_by}); "
        f"stages {json.dumps(stages)}; cluster sizes (measured only) "
        f"{json.dumps(clusters)}; ptxas {ptxas}")
    return dict(max_abs_err=worst_q, max_rel_err_stage=worst_stage, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms,
                polar_qr_composition_ms=comp_ms, bound_ms=bound_ms,
                bound_us=bound_ms * 1e3, bound_by=bound_by,
                stages_ms=stages, cluster_sizes=clusters, ptxas=ptxas)


def k2_cluster_sizes(y):
    """K2 on y with the iteration's cluster set to 4 blocks (too few for
    the bands: the one-block iteration, ``ns_iterate``), 8 and 16
    (``rsvd_polar_set_cluster``; measured only, the default restored):
    each one's time, plan, max |dQ| against the plain version and whether
    its Q and R are bitwise those of the default."""
    set_cluster = kernels._polar_lib().rsvd_polar_set_cluster
    set_cluster.restype = ctypes.c_int
    set_cluster.argtypes = [ctypes.c_int]
    q0, _ = kernels.polar_qr_fused_reference(y)
    q_def, r_def = kernels.polar_qr_fused(y)
    out = {}
    default = set_cluster(8)
    try:
        for size in (4, 8, 16):
            set_cluster(size)
            try:
                q, r = kernels.polar_qr_fused(y)
                torch.cuda.synchronize()
                out[size] = dict(
                    ms=cuda_ms(lambda: kernels.polar_qr_fused(y), 50),
                    max_abs_err=float((q - q0).abs().max()),
                    bitwise_default=torch.equal(q, q_def)
                    and torch.equal(r, r_def),
                    plan=k2_plan(*y.shape))
            except RuntimeError as exc:     # a cluster size the card refuses
                out[size] = dict(error=str(exc))
    finally:
        set_cluster(default)
    return out


def tail_gram(a):
    """The l x l Gram the three-kernel path hands K3 for ``a``, captured
    from one call through the plain versions (no launch counted)."""
    seen = []

    def capture(g, sweeps=8):
        seen.append(g.clone())
        return kernels.eigh_small_reference(g, sweeps)

    with plain_kernels(), mock.patch.object(kernels, "eigh_small", capture):
        rsvd(a, precision="highest", **FUSED)
    return seen[0]


def k3_inputs(g_main):
    """Phase 2's symmetric matrices: the main path's tail Gram, Wishart
    matrices at K3_SIZES, an indefinite and a rank-deficient one.  The
    flag says whether the matrix has full rank."""
    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    out = {f"tail Gram B B^T {g_main.shape[0]}x{g_main.shape[0]}":
           (g_main, True)}
    with device.ieee_fp32():
        for n in K3_SIZES:
            x = randn(n, 2 * n)
            out[f"Wishart {n}x{n}"] = (x @ x.T / (2 * n), True)
        x = randn(80, 80)
        out["indefinite 80x80"] = (x + x.T, True)
        x = randn(80, 20)
        out["rank-20 Gram 80x80"] = (x @ x.T, False)
    return out


def ptxas_report(src, entry):
    """Registers, shared memory and spills that ``nvcc -Xptxas -v``
    reported for the first entry function of ``csrc/<src>.cu`` whose
    mangled name contains ``entry``; None when this process did not build
    it."""
    lines = _build.build_logs.get(src, "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            out = {"entry": line.split("'")[1]}
            for nxt in lines[i + 1:i + 4]:
                for key, pat in (("registers", r"Used (\d+) registers"),
                                 ("smem_bytes", r"(\d+) bytes smem"),
                                 ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads")):
                    hit = re.search(pat, nxt)
                    if hit:
                        out[key] = int(hit.group(1))
            return out
    return None


def k3_bound(n):
    """(rounds, bound_ms, bound_by) of K3 at n: a round rotates n_pad / 2
    pairs over G's columns, G's rows and V's columns, ~9 n_pad^2 flops; G
    read, lambda and V written."""
    n_pad = n + n % 2
    rounds = 8 * (n_pad - 1)
    return (rounds,) + bound(9 * rounds * n_pad ** 2, 4 * (2 * n * n + n))


def k3_route_sweep(known):
    """K3 at K3_SWEEP_N with each route forced (``rsvd_eigh_set_route``:
    the one-block kernel, and clusters of K3_SWEEP_CLUSTERS blocks that
    fit n), each bitwise its plain version and timed; measured only, the
    plan's choice restored.  ``known`` maps n to (G, plain lambda, plain
    V) of phase 2's full-rank inputs; other n take a Wishart matrix.
    Returns {n: {route: ms}} with the plan's own route beside."""
    lib = kernels._eigh_lib()
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    try:
        for n in K3_SWEEP_N:
            if n in known:
                g, lam0, v0 = known[n]
            else:
                x = torch.randn(n, 2 * n, device="cuda", generator=gen)
                with device.ieee_fp32():
                    g = x @ x.T / (2 * n)
                lam0, v0 = kernels.eigh_small_reference(g)
            reps = 10 if n <= 144 else 3
            row = {"plan": kernels.eigh_small_plan(n)["route"]}
            routes = [("one block", 0, 0)] + [
                (f"cluster {c}", 1, c) for c in K3_SWEEP_CLUSTERS]
            for label, route, blocks in routes:
                check(lib.rsvd_eigh_set_route(route, blocks) == 0, label)
                if kernels.eigh_small_plan(n)["smem_bytes"] == 0:
                    continue   # a cluster that does not fit n
                try:
                    lam, v = kernels.eigh_small(g)
                    torch.cuda.synchronize()
                except RuntimeError as exc:   # a cluster the card refuses
                    row[label] = str(exc)
                    continue
                check(torch.equal(lam, lam0) and torch.equal(v, v0),
                      f"K3 n={n} route {label}: not bitwise its plain "
                      f"version: max|dlam|="
                      f"{float((lam - lam0).abs().max())} "
                      f"max|dV|={float((v - v0).abs().max())}")
                row[label] = cuda_ms(lambda: kernels.eigh_small(g), reps)
            lib.rsvd_eigh_set_route(-1, 0)
            out[n] = row
            log(f"  K3 route sweep n={n} (bitwise each): " + ", ".join(
                f"{k} {v:.4f} ms" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()))
    finally:
        lib.rsvd_eigh_set_route(-1, 0)
    return out


def phase_k3(g_main):
    """K3 against its plain version; returns its kernels-line fields."""
    worst = 0.0
    bitwise = {}
    known = {}   # n -> (G, plain lambda, plain V, plain ms), full rank
    for name, (g, full_rank) in k3_inputs(g_main).items():
        lam, v = kernels.eigh_small(g)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lam0, v0 = kernels.eigh_small_reference(g)
        end.record()
        end.synchronize()
        n = g.shape[0]
        if full_rank and n not in known:
            known[n] = (g, lam0, v0, start.elapsed_time(end))
        route = kernels.eigh_small_plan(n)
        check(lam.shape == (n,) and v.shape == (n, n), name)
        check(bool(torch.isfinite(lam).all() and torch.isfinite(v).all()),
              f"{name}: non-finite K3 output")
        if n % 2 == 0:
            # the same rounded operations in the same order as the plain
            # version: bitwise at even n (odd n pads with a norm summed in
            # another order)
            same = torch.equal(lam, lam0) and torch.equal(v, v0)
            bitwise[name] = same
            check(same, f"{name}: K3 not bitwise its plain version at even "
                  f"n: max|dlam|={float((lam - lam0).abs().max())} "
                  f"max|dV|={float((v - v0).abs().max())}")
        scale = float(lam0.abs().max()) or 1.0
        dlam = float((lam - lam0).abs().max()) / scale
        dv = float((v - v0).abs().max())
        orth = orth_err(v)
        with device.ieee_fp32():
            rec = float(torch.linalg.norm((v * lam) @ v.T - g)
                        / torch.linalg.norm(g))
        ascending = bool((lam[1:] >= lam[:-1]).all())
        log(f"  K3 {name} ({route['route']}, {route['blocks']} blocks): "
            f"max|dlam|/max|lam|={dlam:.3e} max|dV|={dv:.3e} "
            f"max|V^T V - I|={orth:.3e} ||V L V^T - G||/||G||={rec:.3e} "
            f"lam in [{float(lam[0]):.4g}, {float(lam[-1]):.4g}]")
        check(dlam <= K3_LAM_TOL and ascending,
              f"{name}: K3 vs plain dlam={dlam}, ascending={ascending}")
        if full_rank:
            check(orth <= K3_ORTH_TOL and rec <= K3_REC_TOL,
                  f"{name}: K3 |V^T V - I|={orth} reconstruction {rec}")
        else:
            # the JAX suite's check (tests/test_pallas.py:128-131): no pad
            # eigenvalue leaks in, the spectrum is the f64 one
            ref = torch.linalg.eigvalsh(g.double())
            dref = float((lam.double() - ref).abs().max() / ref.abs().max())
            log(f"  K3 {name}: vs f64 eigvalsh {dref:.3e}")
            check(float(lam[0]) > -1e-3 * scale and dref <= 1e-4,
                  f"{name}: K3 lambda_min={float(lam[0])}, vs f64 {dref}")
        worst = max(worst, dlam * scale)

    # K3 against torch.linalg.eigh at K3_TIMED, in this run (80: the tail
    # Gram, which k3_inputs lists first; 144, 240: Wishart matrices); the
    # plain version's time is its one call above
    sizes = {}
    for n in K3_TIMED:
        g, _, _, plain_ms = known[n]
        ms = cuda_ms(lambda: kernels.eigh_small(g), 20 if n <= 144 else 10)
        lib_ms = cuda_ms(lambda: torch.linalg.eigh(g), 20)
        rounds, bound_ms, bound_by = k3_bound(n)
        plan = kernels.eigh_small_plan(n)
        sizes[str(n)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_us=bound_ms * 1e3, bound_by=bound_by, rounds=rounds,
            us_per_round=ms * 1e3 / rounds, over_library=ms / lib_ms,
            route=plan["route"], cluster_blocks=plan["blocks"], plan=plan)
        log(f"  K3 at n={n}: kernel {ms:.4f} ms ({rounds} rounds, "
            f"{ms * 1e3 / rounds:.3f} us each; {plan['route']}, "
            f"{plan['blocks']} blocks of {plan['threads']} threads, "
            f"{plan['smem_bytes']} B shared memory each, "
            f"{plan['barriers_per_round']} block barriers a round), plain "
            f"{plain_ms:.4f} ms, torch.linalg.eigh {lib_ms:.4f} ms "
            f"(K3 {ms / lib_ms:.3f}x), bound {bound_ms * 1e3:.3f} us "
            f"({bound_by})")
    sweep = k3_route_sweep({n: k[:3] for n, k in known.items()})
    ptxas = ptxas_report("eigh", "jacobi_eigh")
    ptxas_cluster = ptxas_report("eigh", "eigh_cluster")
    log(f"  K3 bitwise at even n: {bitwise}; ptxas {ptxas}; "
        f"ptxas eigh_cluster {ptxas_cluster}")
    main = sizes[str(g_main.shape[0])]
    return dict(max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                library_ms=main["library_ms"], bound_ms=main["bound_ms"],
                bound_us=main["bound_us"], bound_by=main["bound_by"],
                rounds=main["rounds"], us_per_round=main["us_per_round"],
                sizes=sizes, route_sweep=sweep, bitwise_even_n=bitwise,
                ptxas=ptxas, ptxas_cluster=ptxas_cluster)


def ulp(x):
    return (torch.nextafter(x, torch.full_like(x, float("inf"))) - x).abs()


def k4_plan(m, n, l):
    """K4's launch plan at (m, n, l) as ``csrc/sketch.cu`` reports it
    (``rsvd_sketch_plan``), with the draws per n l and the padded
    columns' share of the tiles."""
    lib = kernels._sketch_lib()
    lib.rsvd_sketch_plan.restype = None
    lib.rsvd_sketch_plan.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_longlong)]
    out = (ctypes.c_longlong * 7)()
    lib.rsvd_sketch_plan(m, n, l, out)
    plan = dict(zip(("cluster", "splits", "k_per_split", "blocks",
                     "tile_columns", "padded_columns", "draws"), out))
    plan.update(draws_per_nl=plan["draws"] / (n * l),
                padded_column_share=plan["padded_columns"]
                / plan["tile_columns"])
    return plan


def sketch_3xtf32(a, l, seed):
    """Y = A Omega through ``csrc/sketch.cu``'s 3xTF32 tensor-core variant
    (``rsvd_sketch_f32_3xtf32``): measured beside K4, never called by the
    package, so it has no wrapper and no launch count."""
    lib = kernels._sketch_lib()
    fn = lib.rsvd_sketch_f32_3xtf32
    fn.restype = ctypes.c_int
    fn.argtypes = lib.rsvd_sketch_f32.argtypes
    m, n = a.shape
    y = torch.empty((m, l), dtype=torch.float32, device=a.device)
    work = torch.empty(lib.rsvd_sketch_workspace_floats(m, n, l),
                       dtype=torch.float32, device=a.device)
    err = fn(a.data_ptr(), y.data_ptr(), work.data_ptr(), m, n, l,
             seed & 0xFFFFFFFF, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"3xTF32 sketch: CUDA error {err}")
    return y


def phase_k4(a):
    """K4 against its plain version; returns its kernels-line fields."""
    eye = torch.eye(1024, device="cuda")
    om = kernels.fused_sketch_matmul(eye, K + P, seed=0)
    om0 = kernels.fused_sketch_omega(1024, K + P, seed=0, device="cuda")
    ulps = float(((om - om0).abs() / ulp(om0.abs())).max())
    log(f"  K4 recovered Omega 1024x{K + P}: max |dOmega| = {ulps:.1f} ulp, "
        f"mean {float(om.mean()):+.4f}, std {float(om.std()):.4f}")
    check(ulps <= K4_OMEGA_ULPS, f"K4 Omega differs by {ulps} ulp")
    gen = torch.Generator(device="cuda").manual_seed(5)
    ragged = torch.randn(*RAGGED, device="cuda", generator=gen)
    worst = 0.0
    for name, x, l, seed in (("4096^2 x 80", a, K + P, 0),
                             (f"ragged {RAGGED[0]}x{RAGGED[1]} x 17",
                              ragged, 17, 1),
                             ("4096^2 x 130", a, 130, 2)):
        y = kernels.fused_sketch_matmul(x, l, seed)
        y0 = kernels.fused_sketch_matmul_reference(x, l, seed)
        torch.cuda.synchronize()
        check(y.shape == y0.shape == (x.shape[0], l), name)
        err = float((y - y0).abs().max())
        rel = err / float(y0.abs().max())
        log(f"  K4 {name}: max|dY|/max|Y| = {rel:.3e}")
        check(rel <= K4_Y_TOL, f"K4 {name}: {rel}")
        worst = max(worst, err)
    del ragged
    m, n = a.shape
    l = K + P
    omega = kernels.fused_sketch_omega(n, l, seed=0, device="cuda")
    ms = cuda_ms(lambda: kernels.fused_sketch_matmul(a, l, 0), 20)
    plain_ms = cuda_ms(lambda: kernels.fused_sketch_matmul_reference(a, l, 0),
                       10)
    with device.ieee_fp32():
        lib_ms = cuda_ms(lambda: torch.matmul(a, omega), 20)
    bound_ms, bound_by = bound(2 * m * n * l, 4 * (m * n + m * l))
    # the 3xTF32 variant, measured only: its recovered Omega, its Y at
    # 4096^2 x 80 and its time, beside the fp32 kernel's
    tc_om = sketch_3xtf32(eye, l, 0)
    tc_ulps = float(((tc_om - om0).abs() / ulp(om0.abs())).max())
    y0 = kernels.fused_sketch_matmul_reference(a, l, 0)
    tc_rel = float((sketch_3xtf32(a, l, 0) - y0).abs().max()
                   / y0.abs().max())
    tc_ms = cuda_ms(lambda: sketch_3xtf32(a, l, 0), 20)
    log(f"  K4 3xTF32 variant (measured only) at {m}x{n} x {l}: "
        f"{tc_ms:.4f} ms, recovered Omega {tc_ulps:.1f} ulp, "
        f"max|dY|/max|Y| = {tc_rel:.3e}; ptxas "
        f"{ptxas_report('sketch', 'sketch_clusterILi5ELb1ELb1E')}")
    plan = k4_plan(m, n, l)
    # the tile width l = 80 takes: NC = 5 columns a thread, 16-byte A loads
    ptxas = ptxas_report("sketch",
                         f"sketch_clusterILi{-(-l // 16)}ELb1ELb0E")
    log(f"  K4 at {m}x{n} x {l}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, torch.matmul(A, Omega) fp32 {lib_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.3f} us ({bound_by}); plan {plan}; ptxas {ptxas}")
    return dict(max_abs_err=worst, max_ulps_omega=ulps, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_us=bound_ms * 1e3, bound_by=bound_by, ptxas=ptxas)


def k5_inputs():
    """Phase 2's K5 inputs: the image phase's factor shapes, ragged,
    1-D and 3-D ones, a constant, the 256-level grid and the 1 GiB
    16384^2 tensor."""
    gen = torch.Generator(device="cuda").manual_seed(6)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    th = IMG_SIDE // IMG_GRID[0]
    return {
        f"tile U 4x{th}x{IMG_K}": randn(4, th, IMG_K) * 0.02,
        f"tile s 4x{IMG_K}": randn(4, IMG_K).abs() * 100.0,
        "1-D 1000": randn(1000),
        "3x5x7": randn(3, 5, 7),
        f"ragged {RAGGED[0]}x{RAGGED[1]}": randn(*RAGGED),
        "constant 33x17": torch.full((33, 17), -2.75, device="cuda"),
        "grid 0..255": torch.arange(256, dtype=torch.float32, device="cuda"),
        f"{BIG}^2": randn(BIG, BIG),
    }


def k5_equal(x, stochastic, seed=K5_SEED):
    """K5 and its plain version on x: (q, max |q - q_plain|), after
    checking scale and lo."""
    q, scale, lo = kernels.quantize_uint8(x, stochastic, seed)
    q0, scale0, lo0 = kernels.quantize_uint8_reference(x, stochastic, seed)
    torch.cuda.synchronize()
    check(q.dtype == torch.uint8 and q.shape == x.shape, "K5 output")
    check(torch.equal(scale, scale0) and torch.equal(lo, lo0),
          f"K5 scale/lo {float(scale)}/{float(lo)} vs plain "
          f"{float(scale0)}/{float(lo0)}")
    return q, int((q.int() - q0.int()).abs().max())


def k5_launch_only(x32, stochastic):
    """K5's bare launch on x32 with lo and scale computed once (no
    reduction): for timing the kernel alone."""
    lo, scale = kernels._quantize_range(x32)
    q = torch.empty(x32.shape, dtype=torch.uint8, device="cuda")
    lib = kernels._quantize_lib()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        lib.rsvd_quantize_u8_f32(x32.data_ptr(), q.data_ptr(), x32.numel(),
                                 lo.data_ptr(), scale.data_ptr(),
                                 int(stochastic), K5_SEED, stream)
    return launch


def k5_library(x):
    """``torch.quantize_per_tensor`` of ``x`` to quint8 with K5a's lo and
    scale as 0-dim tensors (the zero point round(-lo / scale)): its ms,
    and its levels against K5a's plain version.  It computes round(x /
    scale) + zero point, lo rounded to a whole step, where K5a computes
    round((x - lo) * (1 / scale)): not the same rounding, so measured
    beside K5a, never held to it."""
    lo, scale = kernels._quantize_range(x.to(torch.float32))
    zero = torch.round(-lo / scale).to(torch.int64)

    def call():
        return torch.quantize_per_tensor(x, scale, zero, torch.quint8)
    ms = cuda_ms(call, 20)
    diff = (call().int_repr().int()
            - kernels.quantize_uint8_reference(x, False)[0].int()).abs()
    return dict(call="torch.quantize_per_tensor(x, scale, zero_point, "
                "quint8)", ms=ms, max_level_diff=int(diff.max()),
                share_of_levels_differing=float(
                    (diff > 0).float().mean()))


def phase_k5():
    """K5a and K5b against their plain versions (bitwise), K5b's
    statistics; returns the kernels-line fields of K5a and K5b."""
    worst = {False: 0, True: 0}
    inputs = k5_inputs()
    for name, x in inputs.items():
        qd, bad_d = k5_equal(x, False)
        qs, bad_s = k5_equal(x, True)
        step = int((qs.int() - qd.int()).abs().max())
        log(f"  K5 {name}: max |q - q_plain|: K5a {bad_d}, K5b {bad_s}; "
            f"max |K5b - K5a| = {step} level")
        check(bad_d == 0 and bad_s == 0, f"K5 {name}: kernel != plain")
        check(step <= 1, f"K5 {name}: K5b {step} levels from K5a")
        worst = {False: max(worst[False], bad_d), True: max(worst[True],
                                                            bad_s)}
        if name.startswith("grid"):
            for q in (qd, qs):
                check(torch.equal(q.float(), x), "K5 grid values not exact")
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand(256, 256, device="cuda", generator=gen)
    acc = torch.zeros_like(x, dtype=torch.float64)
    for seed in range(64):
        q, scale, lo = kernels.quantize_uint8(x, True, seed)
        acc += q.double() * scale.double() + lo.double()
    bias = float((acc / 64 - x.double()).abs().max())
    limit = 6.0 * float(scale) / 2.0 / 8.0         # 6 sigma over 64 seeds
    log(f"  K5b 256x256 over 64 seeds: max |mean - x| = {bias:.3e} "
        f"(6 sigma {limit:.3e})")
    check(bias < limit, f"K5b biased: {bias} >= {limit}")

    big = inputs[f"{BIG}^2"]
    del inputs
    numel = big.numel()
    aminmax_ms = cuda_ms(lambda: torch.aminmax(big), 20)
    bound_ms, bound_by = bound(0, 5 * numel)       # 4 B read, 1 B written
    lib = k5_library(big)
    out = {}
    for stochastic, key in ((False, "K5a"), (True, "K5b")):
        ms = cuda_ms(lambda: kernels.quantize_uint8(big, stochastic, 7), 20)
        kernel_ms = cuda_ms(k5_launch_only(big, stochastic), 20)
        plain_ms = cuda_ms(
            lambda: kernels.quantize_uint8_reference(big, stochastic, 7), 2)
        log(f"  {key} at {BIG}^2: call {ms:.4f} ms (kernel alone "
            f"{kernel_ms:.4f} ms, torch.aminmax {aminmax_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")
        out[key] = dict(max_abs_err=worst[stochastic], ms=ms,
                        kernel_only_ms=kernel_ms, plain_ms=plain_ms,
                        library_ms=None if stochastic else lib["ms"],
                        aminmax_ms=aminmax_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        bytes_moved=5 * numel)
    out["K5a"]["library_vs_plain"] = lib
    log(f"  K5a's library call at {BIG}^2: " + json.dumps(lib))
    del big
    torch.cuda.empty_cache()
    return out



def k6_y_error(a16, omega16, y, rows=None):
    """max over Y of |Y - torch.mm(a16, Omega)| / (|a16| @ |Omega|), both
    products in f32 on the card, in blocks of ``rows`` rows (all at once
    where None)."""
    rows = rows or a16.shape[0]
    worst = 0.0
    for r in range(0, a16.shape[0], rows):
        part = a16[r:r + rows]
        want = torch.mm(part, omega16, out_dtype=torch.float32)
        scale = torch.mm(part.abs(), omega16.abs(), out_dtype=torch.float32)
        worst = max(worst, float(((y[r:r + rows] - want).abs()
                                  / scale.clamp(min=1e-30)).max()))
    return worst


def k6_copy_bitwise(a, a16, rows):
    """Whether a16 is bitwise ``a.to(torch.bfloat16)``, in row blocks."""
    return all(torch.equal(a16[r:r + rows], a[r:r + rows].to(torch.bfloat16))
               for r in range(0, a.shape[0], rows))


def k6_library(a, omega16):
    """The pair K6 replaces: the cast of A, then cuBLAS's bf16 GEMM."""
    return torch.mm(a.to(torch.bfloat16), omega16, out_dtype=torch.float32)


def k6_bound(m, n, l):
    """(bound_ms, bound_by, bytes): A read at f32, the copy written, Omega
    read and Y written once; 2 m n l operations at the bf16 peak."""
    nbytes = 6 * m * n + 2 * n * l + 4 * m * l
    t_ops, t_bytes = 2 * m * n * l / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", nbytes)


def k6_timed(a, omega16, reps, plain=True):
    """K6's, its plain version's (where asked) and the library pair's ms
    on (A, Omega), the pair's cast and GEMM apart, and the bound.  One
    bf16 copy of A is held at a time (A and two copies overfill the card
    at 100000^2)."""
    m, n = a.shape
    l = omega16.shape[1]
    omega_k = omega16.T.contiguous().T        # the driver's layout
    out = dict(shape=[m, n, l],
               ms=cuda_ms(lambda: kernels.cast_sketch(a, omega_k), reps),
               library_ms=cuda_ms(lambda: k6_library(a, omega16), reps),
               cast_ms=cuda_ms(lambda: a.to(torch.bfloat16), reps))
    a16 = a.to(torch.bfloat16)
    out["gemm_ms"] = cuda_ms(
        lambda: torch.mm(a16, omega16, out_dtype=torch.float32), reps)
    del a16
    out["plain_ms"] = (cuda_ms(lambda: kernels.cast_sketch_reference(
        a, omega_k), max(1, reps // 4)) if plain else None)
    out["bound_ms"], out["bound_by"], nbytes = k6_bound(m, n, l)
    out["tb_per_s"] = nbytes / out["ms"] / 1e9
    out["tiles"] = -(-m // 128)
    return out


def k6_checked(a, omega16, rows=None):
    """K6 once on (A, Omega): (copy bitwise ``a.to``, max |dY| against
    ``torch.mm`` on the same bf16 operands), counted."""
    before = kernels.cast_sketch.launches
    a16, y = kernels.cast_sketch(a, omega16.T.contiguous().T)
    torch.cuda.synchronize()
    check(kernels.cast_sketch.launches == before + 1, "K6 launches")
    return (k6_copy_bitwise(a, a16, rows or a.shape[0]),
            k6_y_error(a16, omega16, y, rows), a16, y)


def phase_k6():
    """K6 (``cast_sketch``) against ``a.to(torch.bfloat16)`` (bitwise) and
    against torch.mm on the same bf16 operands (``K6_Y_TOL``), and against
    its plain version, at ``K6_CHECKS`` and (without the plain version,
    which would overfill the card) at the fit's ``K6_MAIN``; one
    ``rsvd()`` call at the fit's settings there with K6's count zeroed
    just before (one launch, one fused copy); its times at ``K6_MAIN``
    and ``K6_NARROW``, and the row sweep behind
    ``driver._CAST_SKETCH_WAVES``; returns the kernels-line fields."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    for m, n, l in K6_CHECKS:
        a = torch.randn(m, n, device="cuda", generator=gen)
        omega16 = torch.randn(n, l, device="cuda",
                              generator=gen).to(torch.bfloat16)
        same, rel, a16, y = k6_checked(a, omega16)
        p16, py = kernels.cast_sketch_reference(a, omega16)
        plain_rel = float(((y - py).abs() / torch.mm(
            p16.abs(), omega16.abs(), out_dtype=torch.float32).clamp(
                min=1e-30)).max())
        log(f"  K6 {m}x{n} x {l}: copy bitwise {same}, max |dY| / "
            f"(|a16| |Omega|) = {rel:.3e} against torch.mm, {plain_rel:.3e} "
            f"against the plain version")
        check(same and torch.equal(p16, a16), f"K6 {m}x{n}: copy differs")
        check(rel <= K6_Y_TOL and plain_rel <= K6_Y_TOL,
              f"K6 {m}x{n} x {l}: {rel}, {plain_rel}")
        worst = max(worst, rel)
    del a, a16, y, p16, py

    out = {}
    m, n, l = K6_MAIN
    a = torch.randn(m, n, device="cuda", generator=gen)
    omega16 = torch.randn(n, l, device="cuda", generator=gen).to(
        torch.bfloat16)
    same, rel, a16, y = k6_checked(a, omega16, K6_BLOCK_ROWS)
    log(f"  K6 {m}x{n} x {l}: copy bitwise {same}, max |dY| / "
        f"(|a16| |Omega|) = {rel:.3e} against torch.mm (row blocks of "
        f"{K6_BLOCK_ROWS})")
    check(same and rel <= K6_Y_TOL, f"K6 {m}x{n} x {l}: {same}, {rel}")
    worst = max(worst, rel)
    del a16, y
    torch.cuda.empty_cache()

    # the main path at the fit's shape and settings, counted from zero
    kernels.cast_sketch.launches = 0
    driver.reset_stage_tally()
    _, s, _ = driver.rsvd(a, seed=3, precision="default", **K6_FIT)
    torch.cuda.synchronize()
    out["launches"] = kernels.cast_sketch.launches
    tally = driver.stage_tally()
    _, s16, _ = driver.rsvd(a, seed=3, precision="bf16", **K6_FIT)
    ds = float(((s - s16).abs() / s16[0]).max())
    out["main_path"] = dict(shape=[m, n], stage_tally=tally,
                            max_rel_ds_vs_bf16_storage=ds)
    log(f"  K6 in rsvd() at {m}x{n}, the fit's settings: launches "
        f"{out['launches']}, stage_tally {tally}, max |ds| / s_1 against "
        f"'bf16' storage {ds:.3e}")
    check(out["launches"] == 1
          and tally == {"casts": 1, "reuses": 5, "fused": 1},
          f"K6 in rsvd(): launches {out['launches']}, {tally}")
    check(ds <= 1e-4, f"K6 in rsvd(): s differs by {ds}")
    del s, s16
    torch.cuda.empty_cache()

    out["main"] = k6_timed(a, omega16, 10, plain=False)
    log(f"  K6 at {m}x{n} x {l}: " + json.dumps(out["main"]))
    sweep = []
    for cols in K6_SWEEP_COLS:
        # rows of A's first `cols` columns, copied contiguous
        rows_a = a if cols == n else a[:max(K6_SWEEP_ROWS), :cols].clone()
        om16 = omega16[:cols]
        om_k = om16.T.contiguous().T
        for rows in K6_SWEEP_ROWS:
            if rows > rows_a.shape[0]:
                continue
            part = rows_a[:rows]
            reps = max(5, int(2e10 // (rows * cols)))
            k_ms = cuda_ms(lambda: kernels.cast_sketch(part, om_k), reps)
            lib_ms = cuda_ms(lambda: k6_library(part, om16), reps)
            sweep.append(dict(rows=rows, cols=cols, tiles=-(-rows // 128),
                              ms=k_ms, library_ms=lib_ms,
                              ratio=k_ms / lib_ms))
            log(f"  K6 sweep {rows}x{cols} x {l}: " + json.dumps(sweep[-1]))
        del rows_a, part
    out["sweep"] = sweep
    del a
    torch.cuda.empty_cache()

    m, n, l = K6_NARROW
    a = torch.randn(m, n, device="cuda", generator=gen)
    omega16 = torch.randn(n, l, device="cuda", generator=gen).to(
        torch.bfloat16)
    out["narrow"] = k6_timed(a, omega16, 50)
    log(f"  K6 at {m}x{n} x {l}: " + json.dumps(out["narrow"]))
    out["max_rel_err"] = worst
    out["ptxas"] = ptxas_report("cast_sketch", "cast_sketch_kernel")
    log(f"  K6 ptxas {out['ptxas']}")
    del a
    torch.cuda.empty_cache()
    return out


def photo(shape, seed):
    """A seeded grayscale 'photo' in [0, 255] (numpy f64): gradients,
    smooth blobs, a few hard-edged rectangles and N(0, 2) noise."""
    rng = np.random.default_rng(seed)
    m, n = shape
    y = np.linspace(0.0, 1.0, m)[:, None]
    x = np.linspace(0.0, 1.0, n)[None, :]
    img = 60.0 + 90.0 * x + 40.0 * y
    for _ in range(12):
        cy, cx = rng.uniform(0, 1, 2)
        r = rng.uniform(0.03, 0.2)
        img = img + rng.uniform(-60, 60) * np.exp(
            -((y - cy) ** 2 + (x - cx) ** 2) / (2 * r * r))
    for _ in range(4):
        y0, y1 = np.sort(rng.uniform(0, 1, 2))
        x0, x1 = np.sort(rng.uniform(0, 1, 2))
        img = img + rng.uniform(-50, 50) * ((y >= y0) & (y < y1)
                                            & (x >= x0) & (x < x1))
    return np.clip(img + rng.normal(0.0, 2.0, (m, n)), 0.0, 255.0)


def capture(module, name):
    """(patch, seen): a spy on ``module.name`` keeping what it returns."""
    seen = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out)
        return out
    return mock.patch.object(module, name, spy), seen


def recon_err_k(a, u, s, v, k):
    return float(np.linalg.norm(a - (u[:, :k] * s[:k]) @ v[:, :k].T))


def f64(t):
    return to_numpy(t).astype(np.float64) if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float64)


def ratio_vs_numpy(a, factors, omega, q, k):
    """The factorization's error over a numpy f64 rSVD's on the same
    Omega, at rank k."""
    u_n, s_n, v_n = numpy_rsvd(a, omega.shape[1], q, omega=f64(omega))
    return recon_err_k(a, *(f64(x) for x in factors), k) / recon_err_k(
        a, u_n, s_n, v_n, k)


def timed(fn):
    """(result, wall seconds) of fn() ending in a synchronize."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_image():
    """The image codec on the card: the CLI's steps on a 4096^2 photo
    (the counted run, K5 on the factors included), then compress() on a
    1024^2 crop and a 1024^2 x 3 color image, and compress_video."""
    img = photo((IMG_SIDE, IMG_SIDE), seed=11)
    out = {}
    codec = get_codec()
    reset_counts()
    # -- the counted run: normalize, compress_tiled, restore, codec, K5
    im = image.Image(img).normalize()
    draws, omegas = capture(image, "sketch_matrix")
    with draws:
        _, wall = timed(lambda: im.compress_tiled(k=IMG_K, grid=IMG_GRID))
    tf = im.tile_factors
    gy, gx = IMG_GRID
    th, tw = IMG_SIDE // gy, IMG_SIDE // gx
    tiles = (im.data.reshape(gy, th, gx, tw).swapaxes(1, 2)
             .reshape(gy * gx, th, tw))
    ratios = [ratio_vs_numpy(tiles[i], (tf.u[i], tf.s[i], tf.v[i]),
                             omegas[i], 1, IMG_K) for i in range(gy * gx)]
    psnr, cratio = im.psnr(), im.compression_ratio()
    im.restore()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "factors.rsv")
        _, save_s = timed(lambda: im.save_compressed(path))
        back, load_s = timed(lambda: image.Image().load_compressed(path))
        file_bytes = os.path.getsize(path)
    round_trip = 0.0
    for orig, got in zip((tf.u, tf.s, tf.v), (back.tile_factors.u,
                                              back.tile_factors.s,
                                              back.tile_factors.v)):
        step = (float(orig.max()) - float(orig.min())) / 255.0
        round_trip = max(round_trip, float(np.abs(got - orig).max())
                         / (step / 2))
    k5 = {}
    for name, f in (("u", tf.u), ("s", tf.s), ("v", tf.v)):
        t = torch.from_numpy(f).cuda()
        q, bad = k5_equal(t, False)
        qs, bad_s = k5_equal(t, True, seed=1)
        q_host, _, _ = codec.quantize_affine(f)
        diff = (q.cpu().numpy().astype(int) - q_host.astype(int))
        k5[name] = dict(shape=list(f.shape), max_diff_vs_plain=max(bad,
                                                                   bad_s),
                        max_level_diff_vs_host=int(np.abs(diff).max()),
                        share_bytes_ne_host=float(np.mean(diff != 0)),
                        max_k5b_minus_k5a=int((qs.int() - q.int()).abs()
                                              .max()))
    launches = counts()
    tiled = dict(shape=[IMG_SIDE, IMG_SIDE], k=IMG_K, grid=list(IMG_GRID),
                 compress_tiled_s=wall, err_ratio_vs_numpy_per_tile=ratios,
                 psnr_db=psnr, compression_ratio=cratio,
                 save_compressed_s=save_s, load_compressed_s=load_s,
                 file_bytes=file_bytes,
                 round_trip_err_over_half_step=round_trip, k5_on_factors=k5,
                 launches_k1_to_k5b=list(launches))
    log("  image [CLI steps, 4096^2, tiled]: " + json.dumps(tiled))
    check(launches == launches_of(k5a=3, k5b=3),
          f"image path launches {launches}")
    check(max(ratios) <= ERR_RATIO_MAX, f"image tiles: err ratios {ratios}")
    check(round_trip <= 1 + 1e-6, f"codec round trip {round_trip}")
    check(all(v["max_diff_vs_plain"] == 0 and v["max_level_diff_vs_host"] <= 1
              and v["max_k5b_minus_k5a"] <= 1 for v in k5.values()),
          f"K5 on the factors {k5}")
    tiled["profile"] = profile_call(lambda: image.Image(img).normalize()
                                    .compress_tiled(k=IMG_K, grid=IMG_GRID),
                                    reps=1)
    log("  profile [compress_tiled, 4096^2]: " + json.dumps(tiled["profile"]))
    out["tiled"] = tiled

    # -- whole image: a 1024^2 crop at the default k, and color
    side = COLOR_SIDE
    crop = image.Image(img[:side, :side]).normalize()
    draws, omegas = capture(driver, "generate_omega")
    reset_counts()
    with draws:
        _, wall = timed(crop.compress)
    k = side // 4
    ratio = ratio_vs_numpy(crop.data, (crop.U, crop.S, crop.V), omegas[0],
                           1, k)
    out["gray_crop"] = dict(shape=[side, side], k=k, l=omegas[0].shape[1],
                            compress_s=wall, err_ratio_vs_numpy=ratio,
                            psnr_db=crop.psnr(),
                            compression_ratio=crop.compression_ratio(),
                            launches_k1_to_k5b=list(counts()))
    log("  image [compress(), 1024^2 crop]: " + json.dumps(out["gray_crop"]))
    check(counts() == NONE and ratio <= ERR_RATIO_MAX,
          f"gray crop {out['gray_crop']}")

    rng = np.random.default_rng(12)
    base = img[-side:, -side:]
    color = np.clip(np.stack([base * g + o for g, o in
                              ((1.0, 0.0), (0.8, 20.0), (0.6, 40.0))], 2)
                    + rng.normal(0.0, 2.0, (side, side, 3)), 0, 255)
    cim = image.Image(color).normalize()
    draws, omegas = capture(image, "sketch_matrix")
    reset_counts()
    with draws:
        _, wall = timed(cim.compress)
    chans = np.moveaxis(cim.data, 2, 0)
    ratios = [ratio_vs_numpy(chans[c], (cim.U[c], cim.S[c], cim.V[c]),
                             omegas[0], 1, k) for c in range(3)]
    out["color"] = dict(shape=[side, side, 3], k=k, compress_s=wall,
                        err_ratio_vs_numpy_per_channel=ratios,
                        psnr_db=cim.psnr(),
                        compression_ratio=cim.compression_ratio(),
                        launches_k1_to_k5b=list(counts()))
    log("  image [compress(), color 1024^2 x 3]: " + json.dumps(out["color"]))
    check(counts() == NONE and max(ratios) <= ERR_RATIO_MAX,
          f"color {out['color']}")

    # -- video: 8 frames of 1080 x 1920 panning over one photo
    t, h, w = VIDEO
    pan = photo((h, w + 16 * t), seed=13)
    frames = np.stack([pan[:, 16 * i:16 * i + w] + rng.normal(0, 2, (h, w))
                       for i in range(t)])
    draws, omegas = capture(image, "sketch_matrix")
    reset_counts()
    with draws:
        (u, s, v), wall = timed(lambda: image.compress_video(frames,
                                                             k=VIDEO_K))
    ratios = [ratio_vs_numpy(frames[i], (u[i], s[i], v[i]), omegas[0], 1,
                             VIDEO_K) for i in range(t)]
    rec = image.reconstruct_video(u, s, v)
    mse = float(np.mean((rec - frames) ** 2))
    out["video"] = dict(shape=list(VIDEO), k=VIDEO_K, compress_video_s=wall,
                        err_ratio_vs_numpy_per_frame=ratios,
                        psnr_db=10.0 * np.log10(255.0 ** 2 / mse),
                        compression_ratio=frames.size / (u.size + s.size
                                                         + v.size),
                        launches_k1_to_k5b=list(counts()))
    log("  image [compress_video, 8 x 1080 x 1920]: "
        + json.dumps(out["video"]))
    check(counts() == NONE and max(ratios) <= ERR_RATIO_MAX,
          f"video {out['video']}")
    return launches, out


def phase_driver_modes(a, a64, err_np):
    """rsvd_batched (both modes), rsvd_warm, rsvd_onepass and
    rsvd_adaptive, each with its error against a numpy f64 yardstick."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(8)
    stack = torch.randn(BATCH, BATCH_SIDE, BATCH_SIDE, device="cuda",
                        generator=gen)
    stack64 = to_numpy(stack).astype(np.float64)
    err_np_el = None
    for mode in ("scan", "vmap"):
        draws, omegas = capture(driver, "generate_omega")
        reset_counts()
        with draws:
            (u, s, v), wall = timed(lambda: rsvd_batched(stack, k=K,
                                                          mode=mode))
        launches = counts()
        if err_np_el is None:            # the same Omega in both modes
            err_np_el = []
            for i in range(BATCH):
                u_n, s_n, v_n = numpy_rsvd(stack64[i], omegas[i].shape[1], Q,
                                           omega=f64(omegas[i]))
                err_np_el.append(recon_err_k(stack64[i], u_n, s_n, v_n, K))
        ratios = [recon_err_k(stack64[i], f64(u[i]), f64(s[i]), f64(v[i]), K)
                  / err_np_el[i] for i in range(BATCH)]
        res = dict(batch=[BATCH, BATCH_SIDE, BATCH_SIDE], k=K, wall_s=wall,
                   ms=cuda_ms(lambda: rsvd_batched(stack, k=K, mode=mode), 2),
                   max_err_ratio_vs_numpy=max(ratios),
                   launches_k1_to_k5b=list(launches))
        log(f"  rsvd_batched [{mode}]: " + json.dumps(res))
        check(launches == NONE and max(ratios) <= ERR_RATIO_MAX,
              f"rsvd_batched {mode}: {res}")
        out[f"batched_{mode}"] = res
    del stack, stack64

    noise = torch.randn(M, N, device="cuda", generator=gen)
    u_prev, _, _ = rsvd(a + 1e-3 * noise, k=0, p=K + P, method="eigh",
                        seed=1)
    reset_counts()
    (u, s, v), wall = timed(lambda: rsvd_warm(a, u_prev, k=K, q=1))
    launches = counts()
    ratio = recon_err(a64, f64(u), f64(s), f64(v)) / err_np
    res = dict(k=K, l=K + P, q=1, wall_s=wall,
               ms=cuda_ms(lambda: rsvd_warm(a, u_prev, k=K, q=1), 3),
               err_ratio_vs_numpy_q2=ratio, launches_k1_to_k5b=list(launches))
    log("  rsvd_warm: " + json.dumps(res))
    check(launches == NONE and ratio <= ERR_RATIO_MAX, f"rsvd_warm {res}")
    out["warm"] = res

    u_n, s_n, v_n = numpy_rsvd(a64, K + P, 0)
    err_np_q0 = recon_err(a64, u_n, s_n, v_n)
    reset_counts()
    (u, s, v), wall = timed(lambda: rsvd_onepass(a, k=K))
    launches = counts()
    ratio = recon_err(a64, f64(u), f64(s), f64(v)) / err_np_q0
    res = dict(k=K, l=K + 16, wall_s=wall,
               ms=cuda_ms(lambda: rsvd_onepass(a, k=K), 3),
               err_ratio_vs_numpy_q0=ratio, launches_k1_to_k5b=list(launches))
    log("  rsvd_onepass: " + json.dumps(res))
    check(launches == NONE and ratio <= ONEPASS_RATIO_MAX,
          f"rsvd_onepass {res}")
    out["onepass"] = res

    rank = 512
    uq, _ = torch.linalg.qr(torch.randn(M, rank, device="cuda",
                                        generator=gen))
    vq, _ = torch.linalg.qr(torch.randn(N, rank, device="cuda",
                                        generator=gen))
    s_true = ADAPTIVE_RATIO ** torch.arange(rank, device="cuda",
                                            dtype=torch.float64)
    a_geo64 = (uq.double() * s_true) @ vq.double().T
    a_geo = a_geo64.float()
    reset_counts()
    (u, s, v, k, stats), wall = timed(lambda: rsvd_adaptive(
        a_geo, tol=ADAPTIVE_TOL, return_stats=True))
    launches = counts()
    rel = float(torch.linalg.norm(a_geo64 - (u.double() * s.double())
                                  @ v.double().T) / torch.linalg.norm(a_geo64))
    res = dict(spectrum=f"{ADAPTIVE_RATIO}^i, rank {rank}", tol=ADAPTIVE_TOL,
               k=k, stats=stats, wall_s=wall, rel_err_f64=rel,
               launches_k1_to_k5b=list(launches))
    log("  rsvd_adaptive: " + json.dumps(res))
    check(launches == NONE and rel <= ADAPTIVE_TOL, f"rsvd_adaptive {res}")
    out["adaptive"] = res
    return out

def pca_operand(seed=0, rows=None, d=None):
    """X = 1 mu^T + G diag(0.97^i) W^T + 0.01 E on the card (PCA_ROWS x
    PCA_D unless given): G and E Gaussian, W orthogonal, mu a
    per-feature offset of scale 5."""
    rows, d = rows or PCA_ROWS, d or PCA_D
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w, _ = torch.linalg.qr(torch.randn(d, d, device="cuda", generator=gen))
    mu = PCA_OFFSET * torch.randn(d, device="cuda", generator=gen)
    decay = PCA_DECAY ** torch.arange(d, device="cuda", dtype=torch.float32)
    x = torch.randn(rows, d, device="cuda", generator=gen) * decay
    x = device.matmul_at(x, w.T, "highest")
    x += PCA_NOISE * torch.randn(rows, d, device="cuda", generator=gen)
    return x + mu


def centred64(x, normalize=False):
    """X centred (and z-scored) in f64 on the card."""
    x64 = x.double()
    x64 -= x64.mean(dim=0)
    if normalize:
        sd = x64.std(dim=0, correction=1)
        x64 /= torch.where(sd > 0, sd, torch.ones_like(sd))
    return x64


def f64_spectrum(x, normalize=False):
    """(singular values, variance ratios) of the centred X: its Gram
    formed in f64 on the card, eigh in numpy."""
    x64 = centred64(x, normalize)
    g = to_numpy(x64.T @ x64)
    del x64
    lam = np.clip(np.linalg.eigvalsh(g)[::-1], 0.0, None)
    return np.sqrt(lam), lam / np.trace(g)


def stage_timer(stages):
    """patch(module, name, key): ``module.name`` timed into
    ``stages[key]`` (seconds, synchronized)."""
    def patch(module, name, key):
        real = getattr(module, name)

        def spy(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            stages.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return mock.patch.object(module, name, spy)
    return patch


def pca_run(x, normalize, sig_true, ratio_true):
    """One PCA(X) at its defaults, timed by stage, and its checks."""
    stages = {}
    patch = stage_timer(stages)
    with patch(pca, "svd", "svd"), patch(jacobi, "qr_reduced", "qr"), \
            patch(jacobi, "_block_jacobi_core", "core"), \
            patch(jacobi, "_block_sweep", "block"), \
            patch(jacobi, "_polish_sweep", "polish"):
        p, wall = timed(lambda: pca.PCA(x, normalize=normalize))
    s = f64(p.getS())
    dsig = float(np.abs(s - sig_true).max() / sig_true[0])
    dratio = float(np.abs(f64(p.explained_variance_ratio())
                          - ratio_true).max())
    orth = p.check_orthogonality()
    xc = x - p.mean
    if normalize:
        xc /= torch.std(xc, dim=0, correction=1)
    rec = device.matmul_at(p.getU() * p.getS(), p.getV().T, "highest")
    recon = float(torch.linalg.norm(xc - rec) / torch.linalg.norm(xc))
    del xc, rec
    block, polish = sum(stages["block"]), sum(stages["polish"])
    out = dict(
        normalize=normalize, wall_s=wall, max_rel_dsigma_vs_f64=dsig,
        max_abs_dratio_vs_f64=dratio, check_orthogonality=orth,
        recon_rel=recon, block_sweeps=len(stages["block"]),
        polish_sweeps=len(stages["polish"]),
        seconds_by_stage=dict(
            centre=wall - stages["svd"][0], qr_precondition=stages["qr"][0],
            block_sweeps=block, polish_sweeps=polish,
            engine_other=stages["core"][0] - block - polish,
            u_from_q0=stages["svd"][0] - stages["qr"][0]
            - stages["core"][0]),
        block_sweep_s=stages["block"], polish_sweep_s=stages["polish"],
        pc1_ratio=float(p.explained_variance_ratio()[0]))
    log(f"  PCA(X{', normalize=True' if normalize else ''}) "
        f"{PCA_ROWS}x{PCA_D}: " + json.dumps(out))
    check(dsig <= PCA_SIG_TOL and dratio <= PCA_RATIO_TOL
          and orth <= PCA_ORTH_TOL and recon <= PCA_RECON_TOL,
          f"PCA {out}")
    return p, out


def sweep_profile(r):
    """One torch.profiler pass over a block sweep and over the first
    POLISH_PROFILE_ROUNDS rounds of a polish sweep of the engine on R
    (after one of each as warm-up).  A polish round is the same work
    every time; the profiler's own cost grows with the ~53 launches a
    round, so the whole 1023-round sweep is not traced."""
    out = {}
    n = r.shape[1]
    for label, sched, sweep in (
            ("block_sweep", jacobi._schedule(n // 64, "cuda"),
             lambda w, v, sc: jacobi._block_sweep(w, v, sc, 64)),
            ("polish_sweep", jacobi._schedule(n, "cuda")[
                :POLISH_PROFILE_ROUNDS], jacobi._polish_sweep)):
        w, v = r.clone(), torch.eye(n, device="cuda")
        sweep(w, v, sched)
        out[label] = profile_call(lambda: sweep(w, v, sched), reps=1)
        out[label]["rounds"] = int(sched.shape[0])
        log(f"  profile [{label}, n={n}]: " + json.dumps(out[label]))
    return out


def f64_rsvd_err(x64, omega, q, k):
    """||Xc - U_k S_k V_k^T||_F of the numpy_rsvd steps in f64 on the
    card, on the same Omega."""
    qm, _ = torch.linalg.qr(x64 @ omega)
    for _ in range(q):
        qz, _ = torch.linalg.qr(x64.T @ qm)
        qm, _ = torch.linalg.qr(x64 @ qz)
    ut, s, vt = torch.linalg.svd(qm.T @ x64, full_matrices=False)
    u = qm @ ut[:, :k]
    return float(torch.linalg.norm(x64 - (u * s[:k]) @ vt[:k]))


def streaming_run(x, dtype, lam_true, fd_bound):
    """StreamingPCA(1024, l=128) over X in 4096-row batches."""
    sp = pca.StreamingPCA(PCA_D, l=STREAM_L, dtype=dtype)

    def feed():
        for i in range(0, PCA_ROWS, STREAM_BATCH):
            sp.update(x[i:i + STREAM_BATCH])
    _, wall = timed(feed)
    lam, _ = sp.finalize(STREAM_K)
    true = lam_true[:STREAM_K]
    shrinks = PCA_ROWS // STREAM_L - 1
    return dict(dtype=str(dtype), wall_s=wall, shrinks=shrinks,
                ms_per_shrink=1e3 * wall / shrinks,
                max_rel_over_true=float(np.max((lam - true) / true)),
                max_under_true_over_fd_bound=float(
                    np.max(true - lam) / fd_bound))


CLI_LINE = re.compile(r"^(\S+): (\d+)x(\d+) l=(\d+) \|\|A-USV\^T\|\| = "
                      r"(\S+)  \((\S+) ms\)")


def cli_errors(text):
    """{stem: (error, ms)} of the rsvd command line's output."""
    rows = {}
    for line in text.splitlines():
        hit = CLI_LINE.match(line)
        if hit:
            rows[hit.group(1)] = (float(hit.group(5)), float(hit.group(6)))
    return rows


def start_cli(*args):
    """``python -m rsvd_kamaneh_raganato_terrana_tpu_torch <args>`` from
    this script's directory, started; ``finish_cli`` waits for it."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    proc = subprocess.Popen(
        [sys.executable, "-m", "rsvd_kamaneh_raganato_terrana_tpu_torch",
         *args], cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return proc, args, time.perf_counter()


def finish_cli(started):
    """(stdout, seconds) of a CLI ``start_cli`` started; it must exit 0."""
    proc, args, t0 = started
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    check(proc.returncode == 0, f"CLI {args}: rc {proc.returncode}\n"
          f"{out}\n{err}")
    return out, time.perf_counter() - t0


def phase_clis():
    """The rsvd and pca command lines: two subprocesses run together,
    then the kernel flags of the rsvd one in-process, counted."""
    out = {}
    here = os.path.dirname(os.path.abspath(__file__))
    inputs = os.path.join(here, "data", "input")
    names = sorted(f for f in os.listdir(inputs) if f.endswith(".mtx"))
    gen = torch.Generator(device="cuda").manual_seed(21)
    big = to_numpy(torch.randn(MTX_SIDE, MTX_SIDE, device="cuda",
                               generator=gen))
    # both command lines at once, the pca one started first: each spends
    # most of its time starting torch and the card, and the rsvd one
    # waits for the 2048^2 .mtx
    pca_cli = start_cli("pca", os.path.join(here, "data", "pca",
                                            "tourists.txt"), "yes")
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            os.symlink(os.path.join(inputs, name), os.path.join(tmp, name))
        path = os.path.join(tmp, f"dense{MTX_SIDE}.mtx")
        _, write_s = timed(lambda: write_matrix_market(path, big))
        back, read_s = timed(lambda: read_matrix_market(path))
        check(np.array_equal(back, big.astype(np.float64))
              and np.array_equal(back.astype(np.float32), big),
              "the 2048^2 .mtx does not read back bitwise")
        rsvd_cli = start_cli("rsvd", tmp)
        text, wall = finish_cli(rsvd_cli)
        pca_text, pca_wall = finish_cli(pca_cli)
    rows = cli_errors(text)
    norms = {n[:-4]: float(np.linalg.norm(read_matrix_market(
        os.path.join(inputs, n)))) for n in names}
    out["rsvd"] = dict(subprocess_s=wall, write_2048_mtx_s=write_s,
                       read_2048_mtx_s=read_s, errors_ms=rows,
                       sparse_matrix_err_over_norm=rows["sparse_matrix"][0]
                       / norms["sparse_matrix"])
    log("  cli [rsvd data/input + 2048^2 .mtx]: " + json.dumps(out["rsvd"]))
    check(set(rows) == set(norms) | {f"dense{MTX_SIDE}"}
          and all(np.isfinite(e) for e, _ in rows.values())
          and out["rsvd"]["sparse_matrix_err_over_norm"] <= CLI_ERR_TOL,
          f"rsvd CLI {out['rsvd']}")

    ratio_line = next(ln for ln in pca_text.splitlines()
                      if ln.startswith("Proportion of Variance"))
    pc1 = float(ratio_line.split()[3])
    out["pca"] = dict(subprocess_s=pca_wall, pc1_ratio=pc1)
    log("  cli [pca tourists.txt yes]: " + json.dumps(out["pca"]))
    check(abs(pc1 - TOURISTS_PC1) <= TOURISTS_TOL, f"pca CLI {out['pca']}")

    reset_counts()
    buf, err_buf = io.StringIO(), io.StringIO()
    k1_calls, k3_calls = Recorder(kernels.fused_cholqr1), \
        Recorder(kernels.eigh_small)
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(err_buf), \
            mock.patch.object(kernels, "fused_cholqr1", k1_calls), \
            mock.patch.object(kernels, "eigh_small", k3_calls):
        rc = cli.main(["rsvd", inputs, "--method", "eigh_pallas",
                       "--qr-method", "cholqr1_fused"])
    torch.cuda.synchronize()
    launches = counts()
    want = launches_of(k1=(1 + 2 * Q) * len(names), k3=len(names))
    flagged = cli_errors(buf.getvalue())
    hints = err_buf.getvalue().count("hint: cholqr1_fused has no rank")
    nan_stems = sorted(t for t, (e, _) in flagged.items()
                       if not np.isfinite(e))
    vs_default = {t: abs(e - rows[t][0]) / abs(rows[t][0])
                  for t, (e, _) in flagged.items() if np.isfinite(e)}
    out["kernel_flags"] = dict(
        launches_k1_to_k5b=list(launches), expected=list(want),
        errors_ms=flagged, rel_err_vs_default_flags=vs_default,
        nan_files=nan_stems, cholqr_hints=hints,
        k1_vs_plain=recorded_vs_plain(k1_calls, cholqr1_vs_plain),
        k3_vs_plain=recorded_vs_plain(k3_calls, eigh_vs_plain))
    log("  cli [rsvd data/input --method eigh_pallas --qr-method "
        "cholqr1_fused, in-process]: " + json.dumps(out["kernel_flags"]))
    check(rc == 0 and launches == want,
          f"CLI kernel flags: launches {launches}, not {want}")
    check(len(k1_calls.calls) == want[0] and len(k3_calls.calls) == want[2],
          f"CLI kernel flags: {len(k1_calls.calls)} K1 and "
          f"{len(k3_calls.calls)} K3 calls recorded")
    check(set(flagged) == set(norms)
          and all(d <= SIGMA_TOL["highest"] for d in vs_default.values())
          and nan_stems in ([], ["sparse_matrix"])
          and hints == len(nan_stems),
          f"CLI kernel flags: errors against the default flags' "
          f"{out['kernel_flags']}")
    return launches, out


class Recorder:
    """A kernel wrapper that keeps each call's input and output; its
    launch count is the wrapper's own, which the wrapper adds to as it
    launches."""

    def __init__(self, wrapper):
        self.wrapper, self.calls = wrapper, []

    launches = property(lambda self: self.wrapper.launches,
                        lambda self, n: setattr(self.wrapper, "launches", n))

    def __call__(self, x, *args, **kwargs):
        x_in = x.clone()
        out = self.wrapper(x, *args, **kwargs)
        self.calls.append((x_in, args, kwargs, out))
        return out


def finite(*ts):
    return all(bool(torch.isfinite(t).all()) for t in ts)


def cholqr1_vs_plain(y, args, kwargs, out):
    """(shape, max |dQ|, max |dR| / max |R|) of one recorded K1 call
    against its plain version on the same panel; a non-finite plain
    result (a rank-deficient panel) must be non-finite from K1 too."""
    q, r = out
    q0, r0 = kernels.fused_cholqr1_reference(y, *args, **kwargs)
    if not finite(q0, r0):
        check(not finite(q, r), f"K1 {tuple(y.shape)}: finite output where "
              f"the plain version's is not")
        return tuple(y.shape), None, None
    dq = float((q - q0).abs().max())
    dr = float((r - r0).abs().max()) / float(r0.abs().max())
    check(finite(q, r) and dq <= Q_TOL and dr <= R_TOL,
          f"K1 {tuple(y.shape)} in the CLI run: dQ={dq} dR/R={dr}")
    return tuple(y.shape), dq, dr


def eigh_vs_plain(g, args, kwargs, out):
    """(n, bitwise equal, max |dlam| / max |lam|) of one recorded K3 call
    against its plain version on the same matrix: bitwise at even n."""
    lam, v = out
    lam0, v0 = kernels.eigh_small_reference(g, *args, **kwargs)
    n = g.shape[0]
    if not finite(lam0, v0):
        check(not finite(lam, v), f"K3 n={n}: finite output where the "
              f"plain version's is not")
        return n, None, None
    same = torch.equal(lam, lam0) and torch.equal(v, v0)
    dlam = float((lam - lam0).abs().max()) / (float(lam0.abs().max()) or 1.0)
    check(finite(lam, v) and dlam <= K3_LAM_TOL and (same or n % 2),
          f"K3 n={n} in the CLI run: bitwise {same}, dlam={dlam}")
    return n, same, dlam


def recorded_vs_plain(recorder, compare):
    """Every recorded call of a kernel held to its plain version."""
    torch.cuda.synchronize()
    return [compare(*call) for call in recorder.calls]


def phase_pca():
    """Phase 7: PCA, its randomized and streaming paths, the chunked
    engine and the command lines."""
    out = {}
    x, made = timed(pca_operand)
    (sig_true, ratio_true), f64_s = timed(lambda: f64_spectrum(x))
    log(f"  X {PCA_ROWS}x{PCA_D} f32 made in {made:.2f} s; f64 yardstick "
        f"{f64_s:.2f} s: s_1 = {sig_true[0]:.4f}, s_d = {sig_true[-1]:.4f}")
    p, out["default"] = pca_run(x, False, sig_true, ratio_true)
    s_engine = f64(p.getS())
    del p
    sig_n, ratio_n = f64_spectrum(x, normalize=True)
    _, out["normalize"] = pca_run(x, True, sig_n, ratio_n)

    phase("phase 7: the block engine on R (profile, chunked)")
    xc = x - x.mean(dim=0)
    _, r = qr_reduced(xc, "robust")
    del xc
    out["profile"] = sweep_profile(r)
    progress = []

    def report(phase_name, sweep, measure):
        progress.append([phase_name, sweep, measure])
        log(f"    chunked {phase_name} sweep {sweep}: {measure:.3e}")
    (_, s_c, _), wall = timed(lambda: jacobi.jacobi_svd_chunked(
        r, progress=report))
    d_chunked = float(np.max(np.abs(f64(s_c) - s_engine) / s_engine))
    out["chunked"] = dict(wall_s=wall, max_rel_dsigma_vs_engine=d_chunked,
                          progress=progress)
    log("  jacobi_svd_chunked(R): " + json.dumps(out["chunked"]))
    check(d_chunked <= CHUNKED_TOL, f"chunked {out['chunked']}")
    del r

    draws, omegas = capture(driver, "generate_omega")
    with draws:
        p, wall = timed(lambda: pca.PCA(x, use_rsvd=True, rank=PCA_RANK))
    x64 = centred64(x)
    u, s, v = (t.double() for t in (p.getU(), p.getS(), p.getV()))
    err = float(torch.linalg.norm(x64 - (u * s) @ v.T))
    err_f64 = f64_rsvd_err(x64, omegas[0].double(), Q, PCA_RANK)
    del x64, u, v, p
    out["use_rsvd"] = dict(rank=PCA_RANK, l=int(omegas[0].shape[1]),
                           wall_s=wall, err_ratio_vs_f64=err / err_f64)
    log("  PCA(X, use_rsvd=True, rank=64): " + json.dumps(out["use_rsvd"]))
    check(err / err_f64 <= ERR_RATIO_MAX, f"use_rsvd {out['use_rsvd']}")

    phase("phase 7: StreamingPCA")
    lam_true = sig_true ** 2 / (PCA_ROWS - 1)
    fd_bound = float(np.sum(lam_true[STREAM_K:]) / (STREAM_L - STREAM_K))
    out["streaming"] = {}
    for dtype in (torch.float64, torch.float32):
        res = streaming_run(x, dtype, lam_true, fd_bound)
        out["streaming"][str(dtype)] = res
        log(f"  StreamingPCA({PCA_D}, l={STREAM_L}) {dtype}: "
            + json.dumps(res))
        check(res["max_rel_over_true"] <= STREAM_OVER_TOL
              and res["max_under_true_over_fd_bound"] <= 1.0,
              f"StreamingPCA {res}")
    del x
    torch.cuda.empty_cache()
    phase("phase 7: the command lines")
    launches, out["cli"] = phase_clis()
    return launches, out


def pod_configs(spec):
    """(AdvDiffConfig, PodConfig) of one phase-8 configuration."""
    return AdvDiffConfig(**spec["adv"]), PodConfig(**spec["pod"])


def final_columns(snaps, n_mu):
    """The last snapshot of each mu's block of S: the final solution when
    the sampling stride divides the step count."""
    return snaps.reshape(snaps.shape[0], n_mu, -1)[:, :, -1].T


def scipy_fom(cfg, mu):
    """The FOM's final solution by a scipy lu_factor/lu_solve loop in f64
    on the host, on the card's own dense operators and loads."""
    mu_t = torch.tensor(mu, dtype=torch.float64, device="cuda")
    ops = advdiff.build_operators(cfg, mu_t, factor=False)
    _, f_theta = advdiff.theta_loads(cfg, mu_t, ops.nodes, torch.float64)
    lhs, rhs_mat, f = (to_numpy(x) for x in (ops.lhs, ops.rhs_mat, f_theta))
    u = to_numpy(advdiff.initial_state(cfg, ops.nodes, torch.float64))
    del ops
    lu = scipy.linalg.lu_factor(lhs)
    for i in range(cfg.n_steps):
        rhs = rhs_mat @ u + f[i]
        rhs[0] = rhs[-1] = 0.0
        u = scipy.linalg.lu_solve(lu, rhs)
    return u


def energy_sigma_np(s):
    """numpy's singular values of X_h^1/2 S for the driver's X_h =
    [-1, 2, -1], through its bidiagonal Cholesky factor: sigma(L^T S) =
    sigma(X_h^1/2 S), since L^T = Q X_h^1/2 with Q orthogonal."""
    nh = s.shape[0]
    band = np.zeros((2, nh))
    band[0], band[1, :-1] = 2.0, -1.0
    chol = scipy.linalg.cholesky_banded(band, lower=True)
    lts = chol[0][:, None] * s
    lts[:-1] += chol[1, :-1][:, None] * s[1:]
    return np.linalg.svd(lts, compute_uv=False)


def rel_dev(got, want, keep):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got[keep] - want[keep]) / np.abs(want[keep])))


def pod_sigma_check(pod, sig_np):
    """max |d sigma| / sigma over sigma_i >= 1e-4 sigma_1 against numpy."""
    sig = f64(pod.sigma)
    keep = sig_np[:len(sig)] >= POD_SIG_KEEP * sig_np[0]
    return rel_dev(sig, sig_np[:len(sig)], keep), int(keep.sum())


def rom_errors_card_vs_cpu(card, cpu, sig, rom_sizes):
    """{rom_size: max relative difference} of two runs' ROM errors, and
    the rom sizes whose modes all have sigma_i >= 1e-6 sigma_1."""
    held = [rs for rs in rom_sizes
            if rs <= len(sig) and sig[rs - 1] >= ROM_MODE_KEEP * sig[0]]
    diff = {rs: float(np.max(np.abs(np.asarray(card[rs]) - np.asarray(cpu[rs]))
                             / np.abs(np.asarray(cpu[rs]))))
            for rs in rom_sizes}
    return diff, held


def pod_test02():
    """The reference's published deployment on the card and on the CPU:
    the pipeline, the new-param study, the pod command line and the
    temporal convergence study."""
    out = {}
    adv, pcfg = pod_configs(POD_TEST02)
    n_mu = pcfg.n
    reset_counts()
    res, wall = timed(lambda: rom.run_pod_pipeline(pcfg, adv))
    rows, wall_np = timed(lambda: rom.run_new_param_study(pcfg, adv))
    launches = counts()
    (res_cpu, rows_cpu), wall_cpu = timed(lambda: (
        rom.run_pod_pipeline(pcfg, adv, device="cpu"),
        rom.run_new_param_study(pcfg, adv, device="cpu")))

    mus = res.mus
    finals = final_columns(res.snapshots, n_mu)
    fom_dev = max(float(np.linalg.norm(finals[i] - scipy_fom(adv, mu))
                        / np.linalg.norm(finals[i]))
                  for i, mu in enumerate(mus))
    sig_np = energy_sigma_np(res.snapshots)
    sig_dev, n_held = pod_sigma_check(res.pod, sig_np)
    sig = f64(res.pod.sigma)
    diff, held = rom_errors_card_vs_cpu(res.errors, res_cpu.errors, sig,
                                        pcfg.rom_sizes)
    np_diff, np_held = rom_errors_card_vs_cpu(
        {r["rom_size"]: [r["err"]] for r in rows},
        {r["rom_size"]: [r["err"]] for r in rows_cpu}, sig, pcfg.rom_sizes)
    mean_err = {rs: float(np.mean(e)) for rs, e in res.errors.items()}
    falling = [mean_err[rs] for rs in pcfg.rom_sizes if rs <= 8]
    out["pipeline"] = dict(
        wall_s=wall, cpu_runs_wall_s=wall_cpu, timings_ms=res.timings,
        pod_rank=res.pod.rank, sigma=sig.tolist(), mean_err=mean_err,
        fom_final_vs_scipy=fom_dev, sigma_vs_numpy=sig_dev,
        sigma_held=n_held, card_vs_cpu_err=diff, card_vs_cpu_held=held,
        launches_k1_to_k5b=list(launches))
    out["new_param"] = dict(
        wall_s=wall_np, rows=rows, card_vs_cpu_err=np_diff,
        card_vs_cpu_held=np_held,
        published_err=PUBLISHED_TEST02,
        note="published series for information: its beta, u0_choice and "
             "mu range are not in the repository")
    log("  pod_test02 pipeline: " + json.dumps(out["pipeline"]))
    log("  pod_test02 new-param: " + json.dumps(out["new_param"]))
    for r in rows:
        log(f"    rom {r['rom_size']:>2}: err {r['err']:.4e}  published "
            f"{PUBLISHED_TEST02.get(r['rom_size'], float('nan'))}")
    check(launches == NONE, f"pod_test02: launches {launches}")
    check(fom_dev <= FOM_SCIPY_TOL, f"pod_test02 FOM vs scipy {fom_dev}")
    check(sig_dev <= POD_SIG_TOL, f"pod_test02 sigma vs numpy {sig_dev}")
    check(all(diff[rs] <= ROM_CPU_TOL for rs in held)
          and all(np_diff[rs] <= ROM_CPU_TOL for rs in np_held),
          f"pod_test02 card vs CPU ROM errors {diff} {np_diff}")
    check(all(a > b for a, b in zip(falling, falling[1:])),
          f"pod_test02 errors do not fall from rom 2 to 8: {mean_err}")

    # the pod command line on the card, new-param mode, in-process
    with tempfile.TemporaryDirectory() as tmp:
        pod_txt, prm = os.path.join(tmp, "pod.txt"), os.path.join(tmp, "a.prm")
        with open(pod_txt, "w") as f:
            f.write("".join(f"{k} {' '.join(map(str, v)) if isinstance(v, tuple) else v}\n"
                            for k, v in POD_TEST02["pod"].items()))
        with open(prm, "w") as f:
            f.write("".join(f"set {k} = {v}\n"
                            for k, v in POD_TEST02["adv"].items()))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            (rc, cli_s) = timed(lambda: cli.main(
                ["pod", pod_txt, prm, "--mode", "new-param",
                 "--out-dir", tmp]))
    lines = buf.getvalue().splitlines()
    head = lines.index(",".join(rows[0]))
    cli_err = {int(ln.split(",")[0]): float(ln.split(",")[-1])
               for ln in lines[head + 1:]}
    cli_dev = max(abs(cli_err[r["rom_size"]] - r["err"]) / r["err"]
                  for r in rows)
    out["cli_new_param"] = dict(wall_s=cli_s, err=cli_err,
                                max_rel_vs_in_process=cli_dev)
    log("  pod CLI new-param on the card: " + json.dumps(out["cli_new_param"]))
    check(rc == 0 and cli_dev <= CLI_POD_TOL, f"pod CLI {out['cli_new_param']}")

    conv = AdvDiffConfig(**CONV_ADV)
    mus_t = torch.tensor(mus, dtype=torch.float64, device="cuda")
    reset_counts()
    (conv_out, wall_c) = timed(lambda: rom.run_convergence_study(
        conv, CONV_DTS, mu=CONV_MU,
        rom_modes=make_pod(pcfg.pod_type, advdiff.snapshot_matrix(conv, mus_t),
                           pcfg.rank, pcfg.tol, pcfg.svd_type)
        .modes[:, :CONV_ROM_SIZE]))
    launches = counts()
    out["convergence"] = dict(wall_s=wall_c, **conv_out)
    log("  convergence study (N=499, T=0.05, mu=0.05, ROM 8 modes): "
        + json.dumps(out["convergence"]))
    check(launches == NONE
          and all(ORDER_RANGE[0] <= o <= ORDER_RANGE[1]
                  for o in conv_out["fom_order"]),
          f"FOM temporal orders {conv_out['fom_order']}")
    return out


def k3_recorded_bitwise(recorder):
    """Each recorded K3 call against its plain version on its own input:
    (n, bitwise) per call."""
    torch.cuda.synchronize()
    got = []
    for g, args, kwargs, (lam, v) in recorder.calls:
        lam0, v0 = kernels.eigh_small_reference(g, *args, **kwargs)
        same = (torch.equal(torch.nan_to_num(lam), torch.nan_to_num(lam0))
                and torch.equal(torch.nan_to_num(v), torch.nan_to_num(v0)))
        got.append((int(g.shape[0]), same))
    return got


def pod_h100():
    """The same study at 20x the reference's mesh and 32 parameters."""
    out = {}
    adv, pcfg = pod_configs(POD_H100)
    n_mu = pcfg.n
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, wall = timed(lambda: rom.run_pod_pipeline(pcfg, adv))
    peak_pipeline = torch.cuda.max_memory_allocated()
    s = res.snapshots
    POD_H100_RUN.update(snapshots=s, n_mu=n_mu)      # for phase 16
    # numpy's SVDs of S run on the host while the card goes on
    pool = ThreadPoolExecutor(max_workers=2)
    svd_np = pool.submit(np.linalg.svd, s, full_matrices=False)
    energy_np = pool.submit(energy_sigma_np, s)
    rows, wall_np = timed(lambda: rom.run_new_param_study(pcfg, adv))
    launches = counts()
    check(launches == NONE, f"pod_h100: launches {launches}")
    u_scipy, scipy_s = timed(lambda: scipy_fom(adv, res.mus[0]))
    fom_dev = float(np.linalg.norm(final_columns(s, n_mu)[0] - u_scipy)
                    / np.linalg.norm(u_scipy))
    sig = f64(res.pod.sigma)
    out["pipeline"] = dict(
        wall_s=wall, timings_ms=res.timings, pod_rank=res.pod.rank,
        snapshots=list(s.shape), sigma=sig.tolist(),
        mean_err={rs: float(np.mean(e)) for rs, e in res.errors.items()},
        fom_final_vs_scipy_mu0=fom_dev, scipy_fom_s=scipy_s,
        peak_bytes=peak_pipeline)
    out["new_param"] = dict(
        wall_s=wall_np, rows=rows,
        fom_us_per_step=rows[0]["step_avg_fom_us"],
        rom_us_per_step={r["rom_size"]: r["step_avg_rom_us"] for r in rows})
    log("  pod_h100 pipeline: " + json.dumps(out["pipeline"]))
    log("  pod_h100 new-param: " + json.dumps(out["new_param"]))
    check(fom_dev <= FOM_SCIPY_TOL, f"pod_h100 FOM vs scipy {fom_dev}")

    # the POD's split, on the pipeline's S
    s_dev = torch.from_numpy(s).cuda()
    nh = s_dev.shape[0]
    xh = (torch.diag(torch.full((nh,), 2.0, dtype=torch.float64, device="cuda"))
          + torch.diag(torch.full((nh - 1,), -1.0, dtype=torch.float64,
                                  device="cuda"), 1)
          + torch.diag(torch.full((nh - 1,), -1.0, dtype=torch.float64,
                                  device="cuda"), -1))
    _, eigh_s = timed(lambda: pod._spd_sqrt(xh))
    c, gram_s = timed(lambda: device.matmul_at(
        s_dev.T, device.matmul_at(xh, s_dev)))
    _, rsvd_s = timed(lambda: pod.perform_svd(c, pcfg.svd_type, pcfg.rank))
    out["pod_split_s"] = dict(xh_eigh_and_roots=eigh_s, st_xh_s=gram_s,
                              rsvd=rsvd_s)
    del xh, c
    log("  pod_h100 POD split (s): " + json.dumps(out["pod_split_s"]))

    # incremental POD over the 32 per-mu batches, f64
    k = s.shape[1] // n_mu
    batches = [s_dev[:, i * k:(i + 1) * k] for i in range(n_mu)]
    reset_counts()
    inc, inc_s = timed(lambda: pod.incremental_pod(batches, pcfg.rank))
    launches = counts()
    (u_np, s_np, _), wait_s = timed(svd_np.result)
    keep = s_np[:pcfg.rank] >= POD_SIG_KEEP * s_np[0]
    inc_dev = rel_dev(f64(inc.sigma), s_np[:pcfg.rank], keep)
    angles = scipy.linalg.subspace_angles(f64(inc.modes)[:, keep],
                                          u_np[:, :pcfg.rank][:, keep])
    out["incremental_f64"] = dict(
        wall_s=inc_s, numpy_svd_wait_s=wait_s, sigma_vs_numpy=inc_dev,
        sigma_held=int(keep.sum()),
        max_angle_rad=float(np.max(angles)), launches_k1_to_k5b=list(launches))
    log("  pod_h100 incremental_pod (f64): " + json.dumps(out["incremental_f64"]))
    check(launches == NONE and inc_dev <= INC_SIG_TOL
          and float(np.max(angles)) <= INC_ANGLE_TOL,
          f"pod_h100 incremental {out['incremental_f64']}")

    # the same stream in f32 with the K3 tail, every launch recorded
    recorder = Recorder(kernels.eigh_small)
    batches32 = [b.float() for b in batches]
    reset_counts()
    with mock.patch.object(kernels, "eigh_small", recorder):
        (inc32, inc32_s) = timed(lambda: functools.reduce(
            lambda acc, b: acc.update(b), batches32,
            IncrementalSVD(rank=pcfg.rank, method="eigh_pallas")))
    launches = counts()
    bitwise = k3_recorded_bitwise(recorder)
    # measured only: the same f32 stream with torch's eigh in the tail
    inc32_eigh = functools.reduce(lambda acc, b: acc.update(b), batches32,
                                  IncrementalSVD(rank=pcfg.rank))
    out["incremental_f32_eigh_pallas"] = dict(
        wall_s=inc32_s, launches_k1_to_k5b=list(launches),
        k3_sizes=sorted({n for n, _ in bitwise}),
        k3_bitwise=all(same for _, same in bitwise),
        sigma_vs_numpy=rel_dev(f64(inc32.s), s_np[:pcfg.rank], keep),
        sigma_vs_numpy_f32_eigh=rel_dev(f64(inc32_eigh.s), s_np[:pcfg.rank],
                                        keep))
    log("  pod_h100 IncrementalSVD f32 eigh_pallas: "
        + json.dumps(out["incremental_f32_eigh_pallas"]))
    check(launches == launches_of(k3=n_mu) and len(bitwise) == n_mu
          and all(same for _, same in bitwise),
          f"pod_h100 K3 launches {out['incremental_f32_eigh_pallas']}")
    del batches, batches32, inc32, inc32_eigh, recorder

    sig_np, wait_s = timed(energy_np.result)
    out["pipeline"]["numpy_energy_svd_wait_s"] = wait_s
    pool.shutdown()
    dev, n_held = pod_sigma_check(res.pod, sig_np)
    out["pipeline"]["sigma_vs_numpy_energy"] = dev
    out["pipeline"]["sigma_held"] = n_held
    log(f"  pod_h100 POD sigma vs numpy (X_h-weighted, sigma_i >= 1e-4 "
        f"sigma_1, {n_held} held): {dev:.3e}")

    # one profiled FOM step and one ROM step at the full batch
    mus_t = torch.tensor(res.mus, dtype=torch.float64, device="cuda")
    ops, out["fom_build_and_lu_s"] = timed(
        lambda: advdiff.build_operators(adv, mus_t))
    u = torch.randn(n_mu, nh, dtype=torch.float64, device="cuda")
    f_t = torch.randn(n_mu, nh, dtype=torch.float64, device="cuda")
    out["profile_fom_step"] = profile_call(
        lambda: advdiff.fom_step(ops, u, f_t), keep_top=8)
    out["fom_step_bound_ms"] = 1e3 * 2 * n_mu * nh * nh * 8 / PEAK_BYTES
    log("  profile [FOM step, 32 x 4096]: "
        + json.dumps(out["profile_fom_step"]))
    del ops
    torch.cuda.empty_cache()
    rop = rom.rom_operators(adv, mus_t, res.pod.modes[:, :max(pcfg.rom_sizes)])
    out["profile_rom_step"] = profile_call(
        lambda: rom.rom_step(rop, u, f_t), keep_top=8)
    out["rom_step_bound_ms"] = 1e3 * n_mu * nh * nh * 8 / PEAK_BYTES
    log("  profile [ROM step, 32 x 4096, r = 20]: "
        + json.dumps(out["profile_rom_step"]))
    del rop
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    return out


def phase_pod():
    """Phase 8: POD/ROM on the card."""
    out = {"pod_test02": pod_test02()}
    phase("phase 8: pod_h100 (4096 nodes, 32 parameters, 100 steps)")
    out["pod_h100"] = pod_h100()
    return out


# ---- phase 9: the randomized-NLA extensions -------------------------------

def krylov_operand(n, seed):
    """An n x n f32 operand with sigma_i = (i + 1)^(-1/2) and random
    singular vectors, made on the card: a slowly decaying, full-rank
    spectrum (block Krylov's use case)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u, _ = torch.linalg.qr(torch.randn(n, n, device="cuda", generator=gen))
    v, _ = torch.linalg.qr(torch.randn(n, n, device="cuda", generator=gen))
    s = (torch.arange(n, device="cuda", dtype=torch.float32) + 1.0) ** -0.5
    with device.ieee_fp32():
        return (u * s) @ v.T


def err64(a64, u, s, v):
    """||A - U diag(s) V^T||_F in f64 on the card."""
    u, s, v = (x.double() for x in (u, s, v))
    return float(torch.linalg.norm(a64 - (u * s) @ v.T))


def same_omega(omega):
    """``driver.generate_omega`` patched to hand back ``omega`` (cast to
    the dtype asked for): an f64 yardstick on the f32 call's Omega."""
    return mock.patch.object(driver, "generate_omega",
                             lambda seed, n, l, dtype=torch.float32, *a,
                             **kw: omega.to(dtype))


def k1_calls_vs_plain(recorder):
    """(shape, max |dQ|, max |Q^T Q - I| of K1 and of the plain version)
    of each recorded K1 call: reported, not held (a deflated Krylov
    block's condition number squared scales their difference)."""
    torch.cuda.synchronize()
    out = []
    for y, args, kwargs, (q, _) in recorder.calls:
        q0, _ = kernels.fused_cholqr1_reference(y, *args, **kwargs)
        out.append([list(y.shape), float((q - q0).abs().max()),
                    orth_err(q), orth_err(q0)])
    return out


def phase_krylov():
    """Block Krylov through K1/K3 and K2, counted, against its plain
    versions and an f64 Krylov on the same Omega."""
    a = krylov_operand(KRY_N, seed=9)
    a64 = a.double()
    omega = generate_omega(0, KRY_N, K + P, device="cuda")
    with same_omega(omega):
        u, s, v = rsvd_krylov(a64, k=K, p=P, q=Q)
    err_f64 = err64(a64, u, s, v)
    u, s, v = rsvd(a, k=K, p=P, q=Q, method="eigh")
    err_rsvd = err64(a64, u, s, v)
    log(f"  f64 Krylov on the same Omega: err {err_f64:.6f}; f32 rsvd at "
        f"q={Q}: {err_rsvd:.6f}")
    out = dict(err_f64_krylov=err_f64, err_rsvd_same_q=err_rsvd)
    launches_total = list(NONE)

    def call(qr_method, method="eigh"):
        return lambda: rsvd_krylov(a, k=K, p=P, q=Q, qr_method=qr_method,
                                   method=method)

    runs = (("cholqr1_fused", "eigh_pallas", launches_of(k1=Q + 1, k3=1)),
            ("polar_fused", "eigh", launches_of(k2=Q + 1)),
            ("robust", "eigh", NONE))
    for qr_method, method, want in runs:
        label = f"{qr_method}/{method}"
        fwd = call(qr_method, method)
        rec1 = Recorder(kernels.fused_cholqr1)
        rec3 = Recorder(kernels.eigh_small)
        with mock.patch.object(kernels, "fused_cholqr1", rec1), \
                mock.patch.object(kernels, "eigh_small", rec3):
            reset_counts()
            u, s, v = fwd()
            torch.cuda.synchronize()
            launches = counts()
        check(launches == want, f"Krylov {label}: (K1, K2, K3, K4, K5a, "
              f"K5b) launches {launches}, not {want}")
        launches_total = [t + c for t, c in zip(launches_total, launches)]
        check(u.shape == (KRY_N, K) and finite(u, s, v),
              f"Krylov {label}: factors")
        err = err64(a64, u, s, v)
        run = dict(launches_k1_to_k5b=list(launches),
                   err_ratio_vs_f64=err / err_f64,
                   err_over_rsvd=err / err_rsvd,
                   u_orth=orth_err(u), ms=cuda_ms(fwd, 5))
        if launches != NONE:
            with plain_kernels():
                _, s0, _ = fwd()
                run["plain_ms"] = cuda_ms(fwd, 1)
            run["max_rel_dsigma_vs_plain"] = float(
                (s - s0).abs().max() / s0[0])
            check(run["max_rel_dsigma_vs_plain"] <= SIGMA_TOL["highest"],
                  f"Krylov {label}: sigma vs plain {run}")
        if rec3.calls:
            n, same, dlam = eigh_vs_plain(*rec3.calls[0])   # bitwise
            check(n == KRY_L, f"Krylov {label}: K3 at n = {n}, not {KRY_L}")
            g = rec3.calls[0][0]
            run.update(
                k3_n=n, k3_bitwise=same, k3_rel_dlam=dlam,
                k3_ms=cuda_ms(lambda: kernels.eigh_small(g), 5),
                torch_eigh_ms=cuda_ms(lambda: torch.linalg.eigh(g), 5))
            run["k3_rounds"] = 8 * (n - 1)
            run["k3_us_per_round"] = 1e3 * run["k3_ms"] / run["k3_rounds"]
            run["ms_with_cusolver_tail"] = cuda_ms(call(qr_method), 5)
        if rec1.calls:
            run["k1_calls_vs_plain"] = k1_calls_vs_plain(rec1)
        check(run["err_ratio_vs_f64"] <= KRY_RATIO_MAX,
              f"Krylov {label}: err ratio {run}")
        check(err < err_rsvd, f"Krylov {label}: error {err} not below "
              f"rsvd's {err_rsvd} at q={Q}")
        out[label] = run
        log(f"  rsvd_krylov [{label}]: " + json.dumps(run))
    out["fault_c"] = {f"{qr}/{meth}": fault_c_krylov(a, qr, meth)
                      for qr, meth in (("cholqr1_fused", "eigh_pallas"),
                                       ("robust", "eigh"))}
    log("  fault C [Krylov tail]: " + json.dumps(out["fault_c"]))
    out["profile_k1_k3"] = profile_call(call("cholqr1_fused", "eigh_pallas"),
                                        reps=5)
    log("  profile [Krylov, K1/K3]: " + json.dumps(out["profile_k1_k3"]))
    # K1's contract on a Krylov block of an operand of rank below l:
    # non-finite from the kernel and from its plain version (not counted)
    side, rank = KRY_RANK_DEFICIENT
    gen = torch.Generator(device="cuda").manual_seed(10)
    low = torch.randn(side, rank, device="cuda", generator=gen) @ torch.randn(
        rank, side, device="cuda", generator=gen)
    got = rsvd_krylov(low, k=K, p=P, q=Q, qr_method="cholqr1_fused")
    with plain_kernels():
        got0 = rsvd_krylov(low, k=K, p=P, q=Q, qr_method="cholqr1_fused")
    out["rank_deficient_non_finite"] = [not finite(*got), not finite(*got0)]
    check(out["rank_deficient_non_finite"] == [True, True],
          f"Krylov on a rank-{rank} operand: non-finite (kernel, plain) "
          f"{out['rank_deficient_non_finite']}")
    out["spectral_norm_gapped"] = spectral_checks(a, sigma1=1.0, gapped=True)
    del a, a64
    torch.cuda.empty_cache()
    return launches_total, out


def spec_norm64(e):
    """||E||_2 in f64: the root of the largest eigenvalue of E^T E."""
    return float(torch.linalg.eigvalsh(e.T @ e)[-1].sqrt())


def spectral_checks(a, sigma1, gapped):
    """spectral_norm_estimate and stable_rank_estimate at their defaults
    against sigma_1 and ||A||_F^2 / sigma_1^2: held to SPECTRAL_TOL on a
    gapped spectrum; on a gapless one the power iteration's 30 rounds
    leave a gap that is reported, and the estimate must stay a lower
    bound."""
    est = float(spectral_norm_estimate(a))
    srank = float(stable_rank_estimate(a))
    fro2 = float(torch.sum(a.double() ** 2))
    out = dict(sigma1=sigma1, estimate=est, rel_gap=(sigma1 - est) / sigma1,
               stable_rank=srank, stable_rank_true=fro2 / sigma1 ** 2)
    out["stable_rank_rel_err"] = srank / out["stable_rank_true"] - 1.0
    check(est <= sigma1 * (1 + 1e-5), f"spectral norm over sigma_1 {out}")
    if gapped:
        check(abs(out["rel_gap"]) <= SPECTRAL_TOL
              and abs(out["stable_rank_rel_err"]) <= 2 * SPECTRAL_TOL,
              f"spectral norm / stable rank {out}")
    return out


def phase_probes():
    """The certificates on the main path's factors (4096^2, k = 64)."""
    fwd, (a,) = entry(device="cuda", m=M, n=N, precision="highest")
    u, s, v = fwd(a)
    a64, u64, s64, v64 = (x.double() for x in (a, u, s, v))
    out = {}
    for name, est, e in (
            ("range", lambda: range_error_estimate(a, u),
             a64 - u64 @ (u64.T @ a64)),
            ("factorization",
             lambda: factorization_error_estimate(a, u, s, v),
             a64 - (u64 * s64) @ v64.T)):
        got = float(est())
        true2, fro = spec_norm64(e), float(torch.linalg.norm(e))
        ceiling = PROBE_FACTOR * PROBE_FRO_SLACK * fro
        run = dict(estimate=got, true_2norm=true2, fro=fro,
                   over_true=got / true2,
                   probe_norm_over_fro=got / (PROBE_FACTOR * fro),
                   ms=cuda_ms(est, 5))
        check(true2 <= got <= ceiling, f"{name} certificate {run}")
        out[name] = run
        log(f"  {name}_error_estimate: " + json.dumps(run))
        del e
    sigma1 = float(torch.linalg.eigvalsh(a64.T @ a64)[-1].sqrt())
    out["spectral_norm_gapless"] = spectral_checks(a, sigma1, gapped=False)
    log("  spectral_norm / stable_rank (gapless Gaussian operand): "
        + json.dumps(out["spectral_norm_gapless"]))
    return out


def rbf_kernel(points, dim, h, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(points, dim, device="cuda", generator=gen)
    with device.ieee_fp32():
        k = torch.exp(-torch.cdist(x, x) ** 2 / (2.0 * h * h))
    return 0.5 * (k + k.T)


def phase_nystrom():
    """nystrom_psd, reigh, reigh_generalized and nystrom_pcg on an RBF
    kernel matrix, against f64 eigvalsh on the card."""
    a = rbf_kernel(NYS_POINTS, NYS_DIM, NYS_H, seed=11)
    (lam,), eig_s = timed(lambda: (torch.linalg.eigvalsh(a.double()).flip(
        0),))
    out = dict(points=NYS_POINTS, f64_eigvalsh_s=eig_s,
               lam1=float(lam[0]), lam_k_over_lam1=float(lam[NYS_K - 1]
                                                         / lam[0]))
    log(f"  RBF {NYS_POINTS}^2: f64 eigvalsh {eig_s:.2f} s, lam_1 "
        f"{out['lam1']:.4f}")
    (u, lk), t = timed(lambda: nystrom_psd(a, k=NYS_K))
    opt = float(torch.sqrt(torch.sum(lam[NYS_K:] ** 2)))
    with device.ieee_fp32():
        rec = float(torch.linalg.norm(a - (u * lk) @ u.T))
    over = float(((lk.double() - lam[:NYS_K]) / lam[:NYS_K]).max())
    out["nystrom_psd"] = dict(s=t, recon_over_opt=rec / opt,
                              max_rel_over_true=over,
                              top16_rel_err=float(((lk[:16].double()
                                                    - lam[:16]).abs()
                                                   / lam[:16]).max()))
    check(over <= NYS_OVER_TOL and rec <= NYS_RECON_MAX * opt,
          f"nystrom_psd {out['nystrom_psd']}")
    (w, _), t = timed(lambda: reigh(a, k=REIGH_K))
    top = float(((w[:REIGH_TOP].double() - lam[:REIGH_TOP]).abs()
                 / lam[:REIGH_TOP]).max())
    out["reigh"] = dict(s=t, top_rel_err=top, k=REIGH_K)
    check(top <= REIGH_TOL, f"reigh {out['reigh']}")
    gen = torch.Generator(device="cuda").manual_seed(12)
    g = torch.randn(NYS_POINTS, 5, device="cuda", generator=gen)
    with device.ieee_fp32():
        b = torch.diag(1.0 + torch.rand(NYS_POINTS, device="cuda",
                                        generator=gen)) + 0.02 * g @ g.T
    (wg, vg), t = timed(lambda: reigh_generalized(a, b, k=GEN_K))
    with device.ieee_fp32():
        bv = b @ vg
        resid = torch.linalg.norm(a @ vg - bv * wg, dim=0) / (
            wg.abs() * torch.linalg.norm(bv, dim=0))
        vbv = float((vg.T @ bv - torch.eye(GEN_K, device="cuda")).abs().max())
    out["reigh_generalized"] = dict(s=t, max_rel_resid=float(resid.max()),
                                    vtbv_err=vbv)
    check(float(resid.max()) <= GEN_RESID_TOL and vbv <= GEN_ORTH_TOL,
          f"reigh_generalized {out['reigh_generalized']}")
    del b, g, bv
    mu = PCG_MU_REL * out["lam1"]
    rhs = torch.randn(NYS_POINTS, 2, device="cuda", generator=gen)
    x, t = timed(lambda: nystrom_pcg(a, rhs, mu, rank=PCG_RANK,
                                     iters=PCG_ITERS))
    x_cg = lstsq_mod._pcg_scan(
        lambda p: device.matmul_at(a, p, "highest") + mu * p, lambda r: r,
        rhs, PCG_ITERS)

    def rel_res(y):
        r = device.matmul_at(a.double(), y.double(), "highest") + mu * \
            y.double() - rhs.double()
        return float(torch.linalg.norm(r) / torch.linalg.norm(rhs.double()))
    out["nystrom_pcg"] = dict(s=t, mu=mu, iters=PCG_ITERS, rank=PCG_RANK,
                              rel_resid=rel_res(x), plain_cg_rel_resid=rel_res(
                                  x_cg), ms=cuda_ms(lambda: nystrom_pcg(
                                      a, rhs, mu, rank=PCG_RANK,
                                      iters=PCG_ITERS), 3))
    check(out["nystrom_pcg"]["rel_resid"]
          < out["nystrom_pcg"]["plain_cg_rel_resid"],
          f"nystrom_pcg {out['nystrom_pcg']}")
    log("  Nystrom: " + json.dumps(out))
    del a, lam
    torch.cuda.empty_cache()
    return out


def ls_operand(seed, rows=None, cols=None):
    """A rows x cols (LS_ROWS x LS_COLS unless given) f32 panel of
    condition LS_COND and its right-hand sides b = A X + noise (relative
    LS_NOISE), on the card."""
    rows, cols = rows or LS_ROWS, cols or LS_COLS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    v, _ = torch.linalg.qr(torch.randn(cols, cols, device="cuda",
                                       generator=gen))
    s = torch.logspace(0, -math.log10(LS_COND), cols, device="cuda")
    with device.ieee_fp32():
        a = (torch.randn(rows, cols, device="cuda", generator=gen)
             * s) @ v.T
        b0 = a @ torch.randn(cols, LS_RHS, device="cuda", generator=gen)
    noise = torch.randn(rows, LS_RHS, device="cuda", generator=gen)
    b = b0 + LS_NOISE * torch.linalg.norm(b0, dim=0) / math.sqrt(
        rows) * noise
    return a, b


def phase_lstsq():
    """sketch_lstsq ('gaussian' and 'sparse', damp 0 and > 0),
    sketch_minnorm on the transpose and lstsq_residual, against f64 on
    the card; CountSketch's embedding on the panel's Q."""
    a, b = ls_operand(seed=13)
    a64, b64 = a.double(), b.double()
    nb = torch.linalg.norm(b64, dim=0)
    x_opt = torch.linalg.lstsq(a64, b64).solution
    damp = LS_DAMP_REL * float(torch.linalg.eigvalsh(a64.T @ a64)[0])
    x_ridge = torch.linalg.solve(
        a64.T @ a64 + damp * torch.eye(LS_COLS, dtype=torch.float64,
                                       device="cuda"), a64.T @ b64)

    def rel_resid(x, damp_):
        r2 = torch.linalg.norm(a64 @ x.double() - b64, dim=0) ** 2
        return torch.sqrt(r2 + damp_ * torch.linalg.norm(x.double(),
                                                         dim=0) ** 2) / nb
    out = {"damp": damp}
    for kind in ("gaussian", "sparse"):
        for damp_ in (0.0, damp):
            def call(kind=kind, damp_=damp_):
                return sketch_lstsq(a, b, kind=kind, damp=damp_)
            x = call()
            best = rel_resid(x_opt if damp_ == 0 else x_ridge, damp_)
            got = rel_resid(x, damp_)
            run = dict(rel_resid=float(got.max()), optimum=float(best.max()),
                       over_optimum=float((got - best).max()),
                       ms=cuda_ms(call, 3))
            if damp_ == 0:
                res_fn = lstsq_residual(a, x, b).double()
                res64 = torch.linalg.norm(a64 @ x.double() - b64, dim=0)
                run["lstsq_residual_rel_err"] = float(
                    ((res_fn - res64).abs() / res64).max())
                check(run["lstsq_residual_rel_err"] <= LS_RES_FN_TOL,
                      f"lstsq_residual {run}")
            check(run["over_optimum"] <= LS_RESID_TOL,
                  f"sketch_lstsq {kind} damp={damp_}: {run}")
            out[f"{kind}_damp{'0' if damp_ == 0 else '+'}"] = run
            log(f"  sketch_lstsq [{kind}, damp={damp_:.4g}]: "
                + json.dumps(run))
    out["profile_gaussian"] = profile_call(lambda: sketch_lstsq(a, b),
                                           reps=3)
    log("  profile [sketch_lstsq gaussian]: "
        + json.dumps(out["profile_gaussian"]))
    gen = torch.Generator(device="cuda").manual_seed(14)
    c = torch.randn(LS_COLS, LS_RHS, device="cuda", generator=gen)
    x = sketch_minnorm(a.T, c)
    x_star = a64 @ torch.linalg.solve(a64.T @ a64, c.double())
    out["minnorm"] = dict(
        rel_resid=float((torch.linalg.norm(a64.T @ x.double() - c.double(),
                                           dim=0)
                         / torch.linalg.norm(c.double(), dim=0)).max()),
        rel_err_vs_pinv=float(torch.linalg.norm(x.double() - x_star)
                              / torch.linalg.norm(x_star)),
        ms=cuda_ms(lambda: sketch_minnorm(a.T, c), 3))
    check(out["minnorm"]["rel_resid"] <= LS_RESID_TOL,
          f"sketch_minnorm {out['minnorm']}")
    log("  sketch_minnorm: " + json.dumps(out["minnorm"]))
    del a64, b64, x_star
    q, _ = torch.linalg.qr(a)
    key = torch.Generator(device="cuda").manual_seed(15)
    draws = sketching._buckets_and_signs(key, LS_ROWS, CS_SIZE, 8)
    with mock.patch.object(sketching, "_buckets_and_signs",
                           lambda *args: draws):
        sq = countsketch_apply(key, q, CS_SIZE)
        draws_cpu = [(bk.cpu(), sg.cpu()) for bk, sg in draws]
    with mock.patch.object(sketching, "_buckets_and_signs",
                           lambda *args: draws_cpu):
        sq_cpu = countsketch_apply(torch.Generator().manual_seed(15),
                                   q.cpu(), CS_SIZE)
    sv = torch.linalg.svdvals(sq.double())
    out["countsketch"] = dict(
        sketch_rows=CS_SIZE, sv_max=float(sv[0]), sv_min=float(sv[-1]),
        rel_err_vs_cpu=float(torch.linalg.norm(sq.cpu() - sq_cpu)
                             / torch.linalg.norm(sq_cpu)),
        ms=cuda_ms(lambda: countsketch_apply(key, q, CS_SIZE), 3))
    check(CS_RANGE[0] <= out["countsketch"]["sv_min"]
          and out["countsketch"]["sv_max"] <= CS_RANGE[1]
          and out["countsketch"]["rel_err_vs_cpu"] <= CS_CPU_TOL,
          f"countsketch {out['countsketch']}")
    log("  countsketch: " + json.dumps(out["countsketch"]))
    del a, b, q, sq, draws
    torch.cuda.empty_cache()
    return out


def matmul_op(x, a):
    """The matrix-free operator of phase 9: A X (or A v)."""
    return device.matmul_at(a, x[:, None], "highest")[:, 0] if x.dim() == 1 \
        else device.matmul_at(a, x, "highest")


def phase_trace():
    """The trace, diagonal and SLQ estimators on an SPD matrix of known
    spectrum, dense and matrix-free, against f64 on the card."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    u, _ = torch.linalg.qr(torch.randn(TR_N, TR_N, device="cuda",
                                       generator=gen))
    lam = torch.logspace(0, -2, TR_N, device="cuda")
    with device.ieee_fp32():
        a = (u * lam) @ u.T
    a = 0.5 * (a + a.T)
    del u
    a64 = a.double()
    tr = float(torch.trace(a64))
    logdet = 2.0 * float(torch.sum(torch.log(torch.diagonal(
        torch.linalg.cholesky(a64)))))
    diag = torch.diagonal(a64)
    out = dict(n=TR_N, trace=tr, logdet=logdet)
    free = dict(n=TR_N, operands=(a,))
    est, se = hutchinson(a)
    est_op, _ = hutchinson(matmul_op, **free)
    out["hutchinson"] = dict(estimate=float(est), stderr=float(se),
                             err_in_se=abs(float(est) - tr) / float(se),
                             matrix_free_rel_diff=abs(float(est_op - est))
                             / abs(float(est)), ms=cuda_ms(
                                 lambda: hutchinson(a), 5))
    _, se96 = hutchinson(a, num_samples=96)
    pp, pp_op = float(hutchpp(a)), float(hutchpp(matmul_op, **free))
    out["hutchpp"] = dict(estimate=pp, err_in_hutchinson_se=abs(pp - tr)
                          / float(se96), matrix_free_rel_diff=abs(pp_op - pp)
                          / abs(pp), ms=cuda_ms(lambda: hutchpp(a), 5))
    d, dse = diag_estimate(a)
    d_op, _ = diag_estimate(matmul_op, **free)
    out["diag_estimate"] = dict(
        outlier_share=float(((d.double() - diag).abs()
                             > TR_SIGMAS * dse.double()).double().mean()),
        matrix_free_max_diff=float((d_op - d).abs().max()),
        ms=cuda_ms(lambda: diag_estimate(a), 5))
    st = float(slq_trace(a, lambda x: x))
    ld = float(logdet_psd(a))
    ld_op = float(logdet_psd(matmul_op, **free))
    out["slq_trace"] = dict(estimate=st, rel_err=abs(st - tr) / tr)
    out["logdet_psd"] = dict(estimate=ld, rel_err=abs(ld - logdet)
                             / abs(logdet), matrix_free_rel_diff=abs(
                                 ld_op - ld) / abs(ld),
                             ms=cuda_ms(lambda: logdet_psd(a), 3))
    log("  trace estimators: " + json.dumps(out))
    check(out["hutchinson"]["err_in_se"] <= TR_SIGMAS
          and out["hutchpp"]["err_in_hutchinson_se"] <= TR_SIGMAS
          and out["diag_estimate"]["outlier_share"] <= TR_DIAG_OUT
          and out["slq_trace"]["rel_err"] <= SLQ_TRACE_TOL
          and out["logdet_psd"]["rel_err"] <= LOGDET_TOL,
          f"trace estimators {out}")
    check(out["hutchinson"]["matrix_free_rel_diff"] <= 1e-6
          and out["hutchpp"]["matrix_free_rel_diff"] <= 1e-6
          and out["diag_estimate"]["matrix_free_max_diff"] <= 1e-6
          and out["logdet_psd"]["matrix_free_rel_diff"] <= 1e-4,
          f"matrix-free vs dense {out}")
    del a, a64
    torch.cuda.empty_cache()
    return out


def phase_rlu():
    """rlu on a rank-64 8192^2 operand plus noise, against the f64
    rSVD's error on the same Omega; rlu_solve on its factors."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    with device.ieee_fp32():
        a = torch.randn(RLU_N, RLU_RANK, device="cuda", generator=gen) @ \
            torch.randn(RLU_RANK, RLU_N, device="cuda", generator=gen)
    a = a / math.sqrt(RLU_RANK) + RLU_NOISE * torch.randn(
        RLU_N, RLU_N, device="cuda", generator=gen)
    a64 = a.double()
    omega = generate_omega(0, RLU_N, K + P, device="cuda")
    with same_omega(omega):
        u, s, v = rsvd(a64, k=K, p=P, q=Q, method="eigh")
    err_svd = err64(a64, u, s, v)
    res, t = timed(lambda: rlu(a, k=K, p=P, q=Q))
    err = float(torch.linalg.norm(a64 - rlu_reconstruct(res).double()))
    x = torch.randn(RLU_N, 2, device="cuda", generator=gen)
    with device.ieee_fp32():
        rhs = a @ x
    xh = rlu_solve(res, rhs)
    solve_res = float(torch.linalg.norm(a64 @ xh.double() - rhs.double())
                      / torch.linalg.norm(rhs.double()))
    out = dict(s=t, ms=cuda_ms(lambda: rlu(a, k=K, p=P, q=Q), 3),
               err=err, err_f64_rsvd=err_svd, ratio=err / err_svd,
               solve_rel_resid=solve_res,
               perm_dtypes=[str(res.perm_rows.dtype),
                            str(res.perm_cols.dtype)])
    log("  rlu: " + json.dumps(out))
    check(out["ratio"] <= RLU_RATIO_MAX and solve_res <= RLU_SOLVE_TOL
          and res.perm_rows.dtype == torch.int64, f"rlu {out}")
    del a, a64
    torch.cuda.empty_cache()
    return out


def phase_cca():
    """cca on two 262144-row views sharing 8 directions (the rSVD
    branch), against the exact branch in f64 on the card."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    z = torch.randn(CCA_ROWS, CCA_SHARED, device="cuda", generator=gen)
    views = []
    for d in (CCA_P, CCA_Q):
        with device.ieee_fp32():
            w = z @ torch.randn(CCA_SHARED, d, device="cuda", generator=gen)
        views.append(w + torch.randn(CCA_ROWS, d, device="cuda",
                                     generator=gen))
    x, y = views
    res, t = timed(lambda: cca(x, y, k=CCA_K))
    exact = cca_mod._cca_impl(x.double(), y.double(), CCA_K, 1e-6, 0,
                              use_rsvd=False)
    diff = float((res.correlations.double() - exact[0]).abs().max())
    out = dict(s=t, ms=cuda_ms(lambda: cca(x, y, k=CCA_K), 3),
               correlations=res.correlations.tolist(), max_abs_diff=diff)
    log("  cca: " + json.dumps(out))
    check(diff <= CCA_TOL, f"cca {out}")
    del x, y, z, views
    torch.cuda.empty_cache()
    return out


def phase_dmd():
    """dmd of 401 snapshots of a linear system with 16 known discrete
    eigenvalues, 65536 states."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    theta = torch.linspace(0.1, 2.5, DMD_PAIRS, device="cuda",
                           dtype=torch.float64)
    radius = torch.linspace(0.996, 0.9995, DMD_PAIRS, device="cuda",
                            dtype=torch.float64)
    mu = torch.polar(radius, theta)
    phi = torch.complex(*(torch.randn(DMD_N, DMD_PAIRS, device="cuda",
                                      generator=gen, dtype=torch.float64)
                          for _ in range(2)))
    t = torch.arange(DMD_M, device="cuda", dtype=torch.float64)
    snaps = (2.0 * (phi @ (mu[:, None] ** t[None, :])).real).float()
    res, secs = timed(lambda: dmd(snaps, k=2 * DMD_PAIRS))
    known = np.concatenate([to_numpy(mu), np.conj(to_numpy(mu))])
    miss = max(float(np.min(np.abs(res.eigs - z))) for z in known)
    out = dict(s=secs, max_eig_err=miss,
               reconstruction_error=dmd_reconstruction_error(res, snaps))
    log("  dmd: " + json.dumps(out))
    check(miss <= DMD_EIG_TOL, f"dmd {out}")
    del snaps
    return out


def phase_rpca_completion():
    """rpca of a rank-8 4096^2 matrix with 5% spikes (f32 and f64) and
    complete_lowrank of a rank-10 one from 20% of its entries."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    low = torch.randn(RPCA_N, RPCA_RANK, device="cuda", generator=gen) @ \
        torch.randn(RPCA_RANK, RPCA_N, device="cuda", generator=gen) / \
        math.sqrt(RPCA_RANK)
    spikes = torch.where(torch.rand(RPCA_N, RPCA_N, device="cuda",
                                    generator=gen) < RPCA_FRAC,
                         10.0 * torch.randn(RPCA_N, RPCA_N, device="cuda",
                                            generator=gen),
                         torch.zeros((), device="cuda"))
    out = {}
    for dtype in (torch.float32, torch.float64):
        m_mat = (low + spikes).to(dtype)
        res, secs = timed(lambda: rpca(m_mat, iters=RPCA_ITERS))
        rel = float(torch.linalg.norm(res.low_rank.double() - low.double())
                    / torch.linalg.norm(low.double()))
        run = dict(s=secs, rel_err=rel, rank=int(res.rank),
                   final_resid=float(res.resid[-1]))
        if dtype == torch.float32:
            run["profile"] = profile_call(
                lambda: rpca(m_mat, iters=RPCA_ITERS), reps=1)
        out[str(dtype).replace("torch.", "")] = run
        log(f"  rpca [{dtype}]: " + json.dumps(run))
        check(rel <= RPCA_TOL, f"rpca {dtype}: {run}")
    # the rank bar in f64: in f32 the estimator's 1e-6 sigma_1 threshold
    # sits at L's roundoff, which it counts
    check(out["float64"]["rank"] == RPCA_RANK, f"rpca rank {out}")
    del spikes
    low = torch.randn(COMP_N, COMP_RANK, device="cuda", generator=gen) @ \
        torch.randn(COMP_RANK, COMP_N, device="cuda", generator=gen) / \
        math.sqrt(COMP_RANK)
    mask = torch.rand(COMP_N, COMP_N, device="cuda",
                      generator=gen) < COMP_FRAC
    obs = torch.where(mask, low, torch.zeros((), device="cuda"))
    res, secs = timed(lambda: complete_lowrank(obs, mask, k=COMP_RANK,
                                               iters=COMP_ITERS))
    with device.ieee_fp32():
        x = (res.u * res.s) @ res.v.T
    hidden = ~mask
    rmse = float(torch.sqrt(torch.mean((x - low)[hidden] ** 2)))
    rms = float(torch.sqrt(torch.mean(low[hidden] ** 2)))
    out["completion"] = dict(s=secs, unobserved_rmse=rmse, entries_rms=rms,
                             ratio=rmse / rms,
                             final_obs_rmse=float(res.obs_rmse[-1]))
    log("  complete_lowrank: " + json.dumps(out["completion"]))
    check(rmse <= COMP_TOL * rms, f"completion {out['completion']}")
    return out


def phase_extensions():
    """Phase 9: every ported extension on the card.  Returns ((K1, K2,
    K3, K4, K5a, K5b) launches of its counted runs, summary): the
    Krylov calls, and the main-path call whose factors the probes
    certify (K1 q + 1 times); every other part runs no kernel, which is
    checked."""
    out = {}
    t0 = time.perf_counter()
    launches, out["krylov"] = phase_krylov()
    for name, fn, want in (
            ("probes", phase_probes, launches_of(k1=Q + 1)),
            ("nystrom", phase_nystrom, NONE), ("lstsq", phase_lstsq, NONE),
            ("trace", phase_trace, NONE), ("rlu", phase_rlu, NONE),
            ("cca", phase_cca, NONE), ("dmd", phase_dmd, NONE),
            ("rpca_completion", phase_rpca_completion, NONE)):
        phase(f"phase 9: {name}")
        reset_counts()
        out[name] = fn()
        torch.cuda.synchronize()
        got = counts()
        check(got == want, f"phase 9 {name}: (K1, K2, K3, K4, K5a, K5b) "
              f"launches {got}, not {want}")
        launches = [t + c for t, c in zip(launches, got)]
    out["s"] = time.perf_counter() - t0
    return launches, out


def planted(signal, gen):
    """signal + N, N Gaussian at TENSOR_NOISE of the signal's norm, formed
    in place; returns (A, ||N||_F)."""
    noise = torch.randn(signal.shape, device="cuda", generator=gen)
    noise *= TENSOR_NOISE * torch.linalg.vector_norm(signal) \
        / torch.linalg.vector_norm(noise)
    noise_norm = float(torch.linalg.vector_norm(noise))
    a = signal.contiguous()
    a += noise
    return a, noise_norm


def orthonormal(rows, cols, gen):
    return torch.linalg.qr(torch.randn(rows, cols, device="cuda",
                                       generator=gen))[0]


def err_over_noise(a, rec, noise_norm):
    return float(torch.linalg.vector_norm(a - rec)) / noise_norm


def max_orth_err(factors):
    with device.ieee_fp32():
        return max(float((u.T @ u - torch.eye(u.shape[1], device="cuda"))
                         .abs().max()) for u in factors)


def phase_tucker(gen, tmp):
    """tucker and tucker_adaptive of a 1024^3 tensor of multilinear rank
    64 plus 1e-3 noise; the factors' round trip through a checkpoint; one
    call under ``trace``."""
    n, r = TUCKER_N, TUCKER_R
    signal = tucker_reconstruct(
        torch.randn(r, r, r, device="cuda", generator=gen),
        [orthonormal(n, r, gen) for _ in range(3)])
    a, noise_norm = planted(signal, gen)
    ranks = (r, r, r)
    (core, factors), secs = timed(lambda: tucker(a, ranks))
    rec = tucker_reconstruct(core, factors)
    out = dict(shape=[n] * 3, ranks=list(ranks), first_call_s=secs,
               ms=cuda_ms(lambda: tucker(a, ranks), 3),
               err_over_noise=err_over_noise(a, rec, noise_norm),
               factor_orth=max_orth_err(factors))
    check(out["err_over_noise"] <= NOISE_SLACK, f"tucker {out}")
    check(out["factor_orth"] <= FORMAT_ORTH_TOL, f"tucker {out}")
    (core_a, f_a, ranks_a), secs = timed(lambda: tucker_adaptive(
        a, tol=TUCKER_TOL, rank_cap=(TUCKER_CAP,) * 3))
    out["adaptive"] = dict(
        tol=TUCKER_TOL, ranks=list(ranks_a), s=secs,
        err_over_noise=err_over_noise(a, tucker_reconstruct(core_a, f_a),
                                      noise_norm))
    check(ranks_a == ranks, f"tucker_adaptive ranks {out['adaptive']}")
    check(out["adaptive"]["err_over_noise"] <= NOISE_SLACK,
          f"tucker_adaptive {out['adaptive']}")
    # the factors' round trip: saved from the card, loaded, rebuilt
    path = os.path.join(tmp, "tucker")
    checkpoint.save_tensor_factors(path, "tucker", core=core,
                                   factors=factors, meta={"ranks": ranks})
    back = checkpoint.load_tensor_factors(path)
    check(np.array_equal(back["core"], to_numpy(core)) and all(
        np.array_equal(x, to_numpy(y))
        for x, y in zip(back["factors"], factors)), "tucker checkpoint")
    rec2 = tucker_reconstruct(torch.from_numpy(back["core"]).cuda(), [
        torch.from_numpy(f).cuda() for f in back["factors"]])
    check(torch.equal(rec2, rec), "tucker_reconstruct of the loaded factors")
    del rec, rec2
    # one call under the profiler's trace: the file names its kernels
    trace_dir = os.path.join(tmp, "trace")
    with trace(trace_dir):
        tucker(a, ranks)
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    check(len(files) == 1, f"trace files {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernel_names = {e["name"] for e in events if e.get("cat") == "kernel"}
    out["trace"] = dict(file_bytes=os.path.getsize(
        os.path.join(trace_dir, files[0])), kernel_events=sum(
        e.get("cat") == "kernel" for e in events),
        distinct_kernels=len(kernel_names),
        gemm_kernels=sum("gemm" in k.lower() or "nvjet" in k.lower()
                         for k in kernel_names))
    check(out["trace"]["gemm_kernels"] > 0, f"trace {out['trace']}")
    log("  tucker: " + json.dumps(out))
    return out


def phase_tt(gen, tmp):
    """tt_decompose and tt_adaptive of a 128^4 tensor of TT rank 16 plus
    1e-3 noise (left-orthonormal cores and a Gaussian last core)."""
    n, r = TT_N, TT_R
    cores, r_prev = [], 1
    for _ in range(3):
        cores.append(orthonormal(r_prev * n, r, gen).reshape(r_prev, n, r))
        r_prev = r
    cores.append(torch.randn(r, n, 1, device="cuda", generator=gen))
    a, noise_norm = planted(tt_reconstruct(cores), gen)
    ranks = (r, r, r)
    got, secs = timed(lambda: tt_decompose(a, ranks))
    out = dict(shape=[n] * 4, ranks=list(ranks), first_call_s=secs,
               ms=cuda_ms(lambda: tt_decompose(a, ranks), 3),
               err_over_noise=err_over_noise(a, tt_reconstruct(got),
                                             noise_norm))
    check(out["err_over_noise"] <= NOISE_SLACK, f"tt {out}")
    (got_a, ranks_a), secs = timed(lambda: tt_adaptive(
        a, tol=TT_TOL, rank_cap=TT_CAP))
    out["adaptive"] = dict(tol=TT_TOL, ranks=list(ranks_a), s=secs,
                           err_over_noise=err_over_noise(
                               a, tt_reconstruct(got_a), noise_norm))
    check(out["adaptive"]["err_over_noise"] <= NOISE_SLACK,
          f"tt_adaptive {out['adaptive']}")
    path = os.path.join(tmp, "tt")
    checkpoint.save_tensor_factors(path, "tt", cores=got)
    back = checkpoint.load_tensor_factors(path)["cores"]
    check(all(np.array_equal(x, to_numpy(y)) for x, y in zip(back, got)),
          "tt checkpoint")
    log("  tt: " + json.dumps(out))
    return out


def phase_cp(gen, tmp):
    """cp_decompose ('als' and 'rand') of a 512^3 tensor of CP rank 16
    (unit-norm Gaussian factors, weights in [1, 3]) plus 1e-3 noise."""
    n, r = CP_N, CP_R
    fs = [torch.randn(n, r, device="cuda", generator=gen) for _ in range(3)]
    fs = [f / torch.linalg.vector_norm(f, dim=0) for f in fs]
    w = torch.sort(1.0 + 2.0 * torch.rand(r, device="cuda", generator=gen),
                   descending=True)[0]
    a, noise_norm = planted(cp_reconstruct(w, fs), gen)
    a_norm = float(torch.linalg.vector_norm(a))
    out = {}
    for method in ("als", "rand"):
        def call(iters=CP_SWEEPS, method=method):
            return cp_decompose(a, r, iters=iters, method=method)
        (w_c, f_c), secs = timed(call)
        resid = float(torch.linalg.vector_norm(a - cp_reconstruct(w_c, f_c)))
        ms, ms0 = cuda_ms(call, 2), cuda_ms(lambda: call(0), 2)
        run = dict(first_call_s=secs, ms=ms, init_ms=ms0,
                   ms_per_sweep=(ms - ms0) / CP_SWEEPS,
                   fit=1.0 - resid / a_norm,
                   err_over_noise=resid / noise_norm)
        if method == "als":
            got = torch.sort(w_c.abs(), descending=True)[0]
            run["max_rel_weight_err"] = float(((got - w) / w).abs().max())
            check(run["max_rel_weight_err"] <= CP_W_TOL, f"cp als {run}")
            check(run["err_over_noise"] <= NOISE_SLACK, f"cp als {run}")
            path = os.path.join(tmp, "cp")
            checkpoint.save_tensor_factors(path, "cp", weights=w_c,
                                           factors=f_c)
            back = checkpoint.load_tensor_factors(path)
            check(np.array_equal(back["weights"], to_numpy(w_c)) and all(
                np.array_equal(x, to_numpy(y))
                for x, y in zip(back["factors"], f_c)), "cp checkpoint")
        else:
            check(math.isfinite(resid), f"cp rand {run}")
        out[method] = run
    out.update(shape=[n] * 3, rank=r, sweeps=CP_SWEEPS)
    log("  cp: " + json.dumps(out))
    return out


def video_pan(gen):
    """(T, H, W) frames of a smooth image panning 3 pixels a frame: a sum
    of TVIDEO_TERMS separable sinusoids with amplitudes 0.7^k."""
    t, h, w = TVIDEO
    y = torch.linspace(0.0, 1.0, h, device="cuda")
    x = torch.linspace(0.0, (w + 3 * t) / w, w + 3 * t, device="cuda")
    base = torch.zeros(h, w + 3 * t, device="cuda")
    for k in range(TVIDEO_TERMS):
        f, g, p1, p2 = (torch.rand(4, device="cuda", generator=gen)
                        * torch.tensor([30.0, 30.0, 6.3, 6.3],
                                       device="cuda"))
        base += 0.7 ** k * torch.sin(f * y + p1)[:, None] \
            * torch.sin(g * x + p2)[None, :]
    return torch.stack([base[:, 3 * i:3 * i + w] for i in range(t)])


def psnr(x, ref):
    mse = float(torch.mean((x - ref) ** 2))
    return 10.0 * math.log10(float(ref.max() - ref.min()) ** 2 / mse)


def phase_video():
    """The Tucker video codec on 64 frames of 1080 x 1920 (a pan) at ranks
    (16, 96, 96), against per-frame ``compress_video`` at equal
    storage."""
    gen = torch.Generator(device="cuda").manual_seed(30)
    frames = video_pan(gen)
    host = to_numpy(frames)
    (core, factors), secs = timed(lambda: image.compress_video_tucker(
        host, TVIDEO_RANKS))
    rec = torch.from_numpy(image.reconstruct_video_tucker(
        core, factors)).cuda()
    t, h, w = TVIDEO
    stored = core.size + sum(f.size for f in factors)
    k = max(stored // (t * (h + w + 1)), 1)
    (u, s_f, v), secs_f = timed(lambda: image.compress_video(host, k=k))
    with device.ieee_fp32():
        rec_f = torch.einsum("tik,tk,tjk->tij", *(torch.from_numpy(x).cuda()
                                                   for x in (u, s_f, v)))
    out = dict(frames=list(TVIDEO), ranks=list(TVIDEO_RANKS), s=secs,
               psnr=psnr(rec, frames), stored_floats=int(stored),
               ratio=t * h * w / stored,
               per_frame=dict(k=int(k), s=secs_f, psnr=psnr(rec_f, frames),
                              stored_floats=int(u.size + s_f.size + v.size),
                              ratio=t * h * w / (u.size + s_f.size
                                                 + v.size)))
    check(out["psnr"] > out["per_frame"]["psnr"], f"video tucker {out}")
    log("  video tucker: " + json.dumps(out))
    return out


def phase_complete_tucker(gen):
    """complete_tucker of a 256^3 tensor of multilinear rank 8 from 20%
    of its entries, 30 iterations."""
    n, r = CT_N, CT_R
    t = tucker_reconstruct(torch.randn(r, r, r, device="cuda", generator=gen),
                           [orthonormal(n, r, gen) for _ in range(3)])
    mask = torch.rand(t.shape, device="cuda", generator=gen) < CT_FRAC
    obs = torch.where(mask, t, torch.zeros((), device="cuda"))
    res, secs = timed(lambda: complete_tucker(obs, mask, (r, r, r),
                                              iters=CT_ITERS))
    x = tucker_reconstruct(res.core, res.factors)
    hidden = ~mask
    rmse = float(torch.sqrt(torch.mean((x - t)[hidden] ** 2)))
    rms = float(torch.sqrt(torch.mean(t[hidden] ** 2)))
    out = dict(shape=[n] * 3, ranks=[r] * 3, observed=CT_FRAC,
               iters=CT_ITERS, s=secs, unobserved_rmse=rmse,
               entries_rms=rms, ratio=rmse / rms,
               final_obs_rmse=float(res.obs_rmse[-1]))
    check(rmse <= CT_TOL * rms, f"complete_tucker {out}")
    log("  complete_tucker: " + json.dumps(out))
    return out


def rbf_points(n, gen):
    """n sorted points of U(0, 20) in f64 on the card."""
    return torch.sort(20.0 * torch.rand(n, device="cuda", generator=gen,
                                        dtype=torch.float64))[0]


def phase_hodlr(gen):
    """hodlr_build of the RBF kernel (lengthscale 0.2) of 16384 sorted
    points in [0, 20] plus 0.05^2 I, levels 5, k 24; its matvec,
    reconstruction and solve against the dense matrix, the solve against
    a dense f64 Cholesky solve."""
    x = rbf_points(HODLR_N, gen)
    k64 = torch.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.04) \
        + GP_NOISE ** 2 * torch.eye(HODLR_N, device="cuda",
                                    dtype=torch.float64)
    k32 = k64.float()
    h, secs = timed(lambda: hodlr_build(k32, levels=HODLR_LEVELS,
                                        k=HODLR_K))
    y = torch.randn(HODLR_N, device="cuda", generator=gen)
    with device.ieee_fp32():
        ky = k32 @ y
    out = dict(n=HODLR_N, levels=HODLR_LEVELS, k=HODLR_K, build_s=secs,
               build_ms=cuda_ms(lambda: hodlr_build(
                   k32, levels=HODLR_LEVELS, k=HODLR_K), 2),
               compression_ratio=hodlr_compression_ratio(h),
               matvec_rel_err=float(torch.linalg.vector_norm(
                   hodlr_matvec(h, y) - ky) / torch.linalg.vector_norm(ky)),
               matvec_ms=cuda_ms(lambda: hodlr_matvec(h, y), 20),
               dense_matvec_ms=cuda_ms(lambda: k32 @ y, 20),
               reconstruct_rel_err=float(torch.linalg.vector_norm(
                   hodlr_reconstruct(h) - k32) / torch.linalg.vector_norm(
                   k32)))
    b64 = torch.sin(x) + 0.1 * torch.cos(7.0 * x)
    b = b64.float()
    (sol, steps), secs = timed(lambda: hodlr_solve(h, b, return_steps=True))
    dense = torch.cholesky_solve(b64[:, None], torch.linalg.cholesky(k64))
    sol64 = sol.double()
    out["solve"] = dict(
        steps=int(steps[0]), first_call_s=secs,
        ms=cuda_ms(lambda: hodlr_solve(h, b), 3),
        rel_err_vs_dense_f64=float(torch.linalg.vector_norm(
            sol64 - dense[:, 0]) / torch.linalg.vector_norm(dense)),
        rel_residual_dense_f64=float(torch.linalg.vector_norm(
            k64 @ sol64 - b64) / torch.linalg.vector_norm(b64)),
        dense_f64_cholesky_solve_ms=cuda_ms(lambda: torch.cholesky_solve(
            b64[:, None], torch.linalg.cholesky(k64)), 2))
    check(out["matvec_rel_err"] <= HODLR_TOL, f"hodlr {out}")
    check(out["reconstruct_rel_err"] <= HODLR_TOL, f"hodlr {out}")
    check(bool(torch.isfinite(sol).all())
          and out["solve"]["rel_residual_dense_f64"] <= HODLR_TOL,
          f"hodlr_solve {out}")
    log("  hodlr: " + json.dumps(out))
    return out


def phase_gp():
    """GP at benchmarks/gp_scale_bench.py's configuration: 32768 points,
    levels 6, rank 24, noise 0.05, the implicit (never-dense) build;
    fit, predict at 512 points with variance, the log-marginal-likelihood
    by SLQ; max |mean - f| < 0.1 (the bench's own bar)."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, 20.0, GP_N)).astype(np.float32)
    y = (np.sin(x) + 0.1 * np.cos(7.0 * x)
         + 0.05 * rng.standard_normal(GP_N)).astype(np.float32)
    xt = np.linspace(0.5, 19.5, GP_TEST).astype(np.float32)
    truth = np.sin(xt) + 0.1 * np.cos(7.0 * xt)

    def make():
        return GP(noise=GP_NOISE, levels=GP_LEVELS, rank=GP_RANK,
                  implicit_threshold=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gp, fit_s = timed(lambda: make().fit(x, y))
    check("implicit" in gp.solver_used_, gp.solver_used_)
    (mean, var), pred_s = timed(lambda: gp.predict(xt, return_var=True))
    lml, lml_s = timed(lambda: gp.log_marginal_likelihood(num_probes=8,
                                                          steps=30))
    peak = torch.cuda.max_memory_allocated()
    (_, steps), solve_s = timed(lambda: hodlr_solve(
        gp._hodlr, gp.y_train_, return_steps=True))
    (_, steps_var), _ = timed(lambda: hodlr_solve(
        gp._hodlr, gp.kernel(torch.from_numpy(xt)[:, None].cuda(),
                             gp.x_train_).T, return_steps=True))
    err = float(np.max(np.abs(to_numpy(mean) - truth)))
    out = dict(n=GP_N, levels=GP_LEVELS, rank=GP_RANK, noise=GP_NOISE,
               solver_used=gp.solver_used_, fit_s=fit_s, predict_s=pred_s,
               lml_s=lml_s, lml=lml, max_abs_mean_err=err,
               var_range=[float(var.min()), float(var.max())],
               peak_gb=peak / 1e9, cg_steps_fit=int(steps[0]),
               cg_solve_s=solve_s, cg_steps_var_max=int(steps_var.max()),
               cg_steps_var_min=int(steps_var.min()))
    check(err < GP_MEAN_TOL, f"gp mean {out}")
    check(bool(torch.isfinite(var).all()) and math.isfinite(lml),
          f"gp {out}")
    out["profile_fit"] = profile_call(lambda: make().fit(x, y), reps=1,
                                      keep_top=8)
    out["profile_cg_solve"] = profile_call(
        lambda: hodlr_solve(gp._hodlr, gp.y_train_), reps=1, keep_top=8)
    out["host_syncs_per_cg_step"] = \
        out["profile_cg_solve"]["host_sync_events_per_call"] / int(steps[0])
    log("  gp: " + json.dumps(out))
    return out, gp


def well_separated(n, gen, dtype):
    u = torch.linalg.qr(torch.randn(n, n, device="cuda", generator=gen,
                                    dtype=dtype))[0]
    v = torch.linalg.qr(torch.randn(n, n, device="cuda", generator=gen,
                                    dtype=dtype))[0]
    s = torch.logspace(0.0, -2.0, n, device="cuda", dtype=dtype)
    return (u * s) @ v.T


def phase_autodiff():
    """grad through rsvd_with_omega at 4096^2 (k 64, p 16, q 2, 'eigh'
    tail) in f64 against central differences; vmap(grad) over a stack of
    4 x 1024^2 f32 against a loop of grads."""
    gen = torch.Generator(device="cuda").manual_seed(40)
    a = well_separated(AD_N, gen, torch.float64)
    omega = torch.randn(AD_N, AD_K + AD_P, device="cuda", generator=gen,
                        dtype=torch.float64)

    def loss(x):
        u, s, v = rsvd_with_omega(x, omega, q=Q, k=AD_K, method="eigh")
        return torch.sum(s * s) + 0.1 * torch.sum(
            driver.reconstruct(u, s, v) ** 2)

    def value_and_grad():
        x = a.detach().requires_grad_(True)
        val = loss(x)
        return val, torch.autograd.grad(val, x)[0]

    (_, g), secs = timed(value_and_grad)
    d = torch.randn(a.shape, device="cuda", generator=gen,
                    dtype=torch.float64)

    def central(eps):
        with torch.no_grad():
            return float((loss(a + eps * d) - loss(a - eps * d))
                         / (2 * eps))

    # the rSVD of this dense spectrum (sigma_i / sigma_(i+1) = 1.0011)
    # has a large third derivative: a central difference's eps^2 term is
    # ~4e-7 relative at eps 1e-6 and ~4e-5 at 1e-5, so two of them are
    # extrapolated (Richardson), which cancels it
    fd_1, fd_2 = central(1e-6), central(5e-7)
    fd = (4.0 * fd_2 - fd_1) / 3.0
    dd = float(torch.sum(g * d))
    out = dict(n=AD_N, k=AD_K, p=AD_P, q=Q, first_call_s=secs,
               value_and_grad_ms=cuda_ms(value_and_grad, 3),
               forward_ms=cuda_ms(lambda: loss(a), 3),
               directional=dd, central_difference_1e_6=fd_1,
               rel_err_central_1e_6=abs(dd - fd_1) / abs(fd_1),
               central_difference_extrapolated=fd,
               rel_err=abs(dd - fd) / abs(fd))
    check(bool(torch.isfinite(g).all()) and out["rel_err"] <= AD_FD_TOL,
          f"grad vs central differences {out}")
    stack = torch.stack([well_separated(VMAP_N, gen, torch.float32)
                         for _ in range(VMAP_B)])

    def sum_sigma(x):
        return torch.sum(rsvd(x, k=AD_K, p=AD_P, q=1, method="eigh")[1])

    batched = torch.func.vmap(torch.func.grad(sum_sigma),
                              randomness="same")
    gs, secs = timed(lambda: batched(stack))
    loop = torch.stack([torch.func.grad(sum_sigma)(m) for m in stack])
    out["vmap"] = dict(
        stack=[VMAP_B, VMAP_N, VMAP_N], first_call_s=secs,
        ms=cuda_ms(lambda: batched(stack), 3),
        loop_ms=cuda_ms(lambda: [torch.func.grad(sum_sigma)(m)
                                 for m in stack], 3),
        rel_diff_vs_loop=float(torch.linalg.vector_norm(gs - loop)
                               / torch.linalg.vector_norm(loop)))
    check(bool(torch.isfinite(gs).all())
          and out["vmap"]["rel_diff_vs_loop"] <= VMAP_TOL,
          f"vmap(grad) {out['vmap']}")
    log("  autodiff: " + json.dumps(out))
    return out


def phase_main_path_checkpoint(tmp):
    """The main path's factors (entry()'s 'default' call) saved from the
    card and loaded back; K1 runs q + 1 times."""
    fwd, (a,) = entry(device="cuda", m=M, n=N, precision="default")
    u, s, v = fwd(a)
    path = os.path.join(tmp, "main_path")
    checkpoint.save_factors(path, u, s, v, meta={"k": K})
    u2, s2, v2, meta = checkpoint.load_factors(path)
    check(all(np.array_equal(x, to_numpy(y)) for x, y in
              ((u2, u), (s2, s), (v2, v))) and meta == {"k": K},
          "main path checkpoint")
    return dict(bytes=os.path.getsize(path + ".npz"))


def phase_formats():
    """Phase 10: the tensor and hierarchical formats on the card.  Returns
    ((K1, K2, K3, K4, K5a, K5b) launches of its counted runs, summary):
    none of its parts runs a kernel but the main-path call whose factors
    are checkpointed (K1 q + 1 times), which is checked."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(10)
    timer = PhaseTimer()
    out = {}
    launches = list(NONE)
    tmp = tempfile.mkdtemp()
    try:
        for name, fn, want in (
                ("tucker", lambda: phase_tucker(gen, tmp), NONE),
                ("tt", lambda: phase_tt(gen, tmp), NONE),
                ("cp", lambda: phase_cp(gen, tmp), NONE),
                ("video_tucker", phase_video, NONE),
                ("complete_tucker", lambda: phase_complete_tucker(gen),
                 NONE),
                ("hodlr", lambda: phase_hodlr(gen), NONE),
                ("gp", phase_gp, NONE),
                ("autodiff", phase_autodiff, NONE),
                ("main_path_checkpoint",
                 lambda: phase_main_path_checkpoint(tmp),
                 launches_of(k1=Q + 1))):
            phase(f"phase 10: {name}")
            reset_counts()
            with timer.phase(name):
                res = fn()
                torch.cuda.synchronize()
            got = counts()
            check(got == want, f"phase 10 {name}: (K1, K2, K3, K4, K5a, "
                  f"K5b) launches {got}, not {want}")
            launches = [t + c for t, c in zip(launches, got)]
            if name == "gp":
                res, gp = res
            out[name] = res
            torch.cuda.empty_cache()
        # the GP's HODLR matrix through save_model / load_model
        path = os.path.join(tmp, "hodlr")
        checkpoint.save_model(path, gp._hodlr, meta={"n": GP_N})
        h2, meta = checkpoint.load_model(path)
        check(type(h2) is type(gp._hodlr) and meta == {"n": GP_N}
              and (h2.n, h2.k) == (gp._hodlr.n, gp._hodlr.k)
              and torch.equal(h2.leaves, gp._hodlr.leaves)
              and all(torch.equal(x, y) for fa, fb in zip(h2[:4],
                                                           gp._hodlr[:4])
                      for x, y in zip(fa, fb)), "hodlr save_model")
        out["checkpoint_bytes"] = {
            f: os.path.getsize(os.path.join(tmp, f))
            for f in sorted(os.listdir(tmp)) if f.endswith(".npz")}
        csv_path = os.path.join(tmp, "phase10.csv")
        timer.write_csv(csv_path)
        with open(csv_path) as f:
            log("  PhaseTimer CSV:\n" + "\n".join(
                "    " + line for line in f.read().strip().splitlines()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["stage_ms"] = {name: timer.total_ms(name) for name in timer.phases}
    out["s"] = time.perf_counter() - t0
    return launches, out


# ---- phase 11: sparse operands, retrieval, kernel PCA, clustering, the
# estimators and out-of-core streaming --------------------------------------

class Interrupted(Exception):
    """Raised into a streamed run to stop it between two passes."""


def zipf_draw(n, exponent, size, gen):
    """``size`` indices in [0, n) with P(i) ~ (i + 1)^-exponent, by
    inverse-CDF sampling on the card."""
    w = (torch.arange(n, device="cuda", dtype=torch.float64) + 1.0) \
        ** -exponent
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(size, device="cuda", dtype=torch.float64, generator=gen)
    return torch.clamp(torch.searchsorted(cdf, u), max=n - 1)


def ml20m_operand(seed=0, shape=ML20M):
    """A synthetic interaction matrix of MovieLens-20M's shape (138,493
    users x 26,744 items, 20,000,263 ratings; or ``shape``'s (users,
    items, ratings)): (user, item) pairs drawn
    from power laws of user activity and item popularity (``ML_ZIPF``),
    distinct, ratings from a rank-``ML_FACTORS`` preference model plus
    noise rounded to half stars in [0.5, 5].  A coalesced COO tensor on
    the card."""
    users, items, nnz = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draw = nnz + nnz // 10
    keys = zipf_draw(users, ML_ZIPF[0], draw, gen) * items + zipf_draw(
        items, ML_ZIPF[1], draw, gen)
    keys = torch.unique(keys)
    check(keys.numel() >= nnz, f"ml20m: {keys.numel()} distinct pairs")
    keys = torch.sort(keys[torch.randperm(keys.numel(), device="cuda",
                                          generator=gen)[:nnz]]).values
    u, i = keys // items, keys % items
    del keys
    fu = torch.randn(users, ML_FACTORS, device="cuda", generator=gen)
    fi = torch.randn(items, ML_FACTORS, device="cuda", generator=gen)
    score = 3.5 + 0.3 * torch.sum(fu[u] * fi[i], dim=1) + 0.5 * torch.randn(
        nnz, device="cuda", generator=gen)
    r = torch.clamp(torch.round(2.0 * score) / 2.0, 0.5, 5.0)
    a = torch.sparse_coo_tensor(torch.stack([u, i]), r, (users, items),
                                check_invariants=False)
    return a._coalesced_(True)


def spmm_bytes(rows, cols, nnz, l, idx_bytes=4):
    """Bytes a CSR x dense product must move: values and column indices
    once, the row pointers, the dense operand once, the output once."""
    return nnz * (4 + idx_bytes) + 4 * (rows + 1) + 4 * l * (cols + rows)


def retrieval_checks(tables, ids):
    """top_k_items and top_k_items_quantized against a dense f64 score of
    the same tables: exact ids wherever the f64 gap to a neighbouring
    score exceeds ``RET_TIE`` of the row's max |score|, quantized overlap
    >= ``RET_OVERLAP`` of ``RET_TOPK`` per user."""
    vals, top = retrieval.top_k_items(tables, ids, RET_TOPK)
    qt = retrieval.quantize_tables(tables)
    _, top_q = retrieval.top_k_items_quantized(qt, ids, RET_TOPK)
    s64 = tables.users[ids].double() @ tables.items.double().T
    v64, top64 = torch.topk(s64, RET_TOPK + 1)
    gap = torch.diff(-v64, dim=1)                       # >= 0, k columns
    tie = RET_TIE * s64.abs().amax(dim=1, keepdim=True)
    # position j is decided when the gaps on both of its sides are clear
    clear = torch.ones_like(gap[:, :RET_TOPK], dtype=torch.bool)
    clear &= gap[:, :RET_TOPK] > tie
    clear[:, 1:] &= gap[:, :RET_TOPK - 1] > tie
    same = (top == top64[:, :RET_TOPK]) | ~clear
    excused = int((~clear).sum())
    q_sets = top_q.cpu().numpy()
    f_sets = top64[:, :RET_TOPK].cpu().numpy()
    overlap = np.array([len(set(a) & set(b)) for a, b in zip(q_sets, f_sets)])
    out = dict(users=len(ids), k=RET_TOPK, ids_equal_f64=bool(same.all()),
               positions_excused_as_ties=excused,
               max_rel_score_err=float((vals.double() - v64[:, :RET_TOPK])
                                       .abs().max() / s64.abs().max()),
               quantized_overlap_min=int(overlap.min()),
               quantized_overlap_mean=float(overlap.mean()),
               quantized_ms=cuda_ms(lambda: retrieval.top_k_items_quantized(
                   qt, ids, RET_TOPK), 10),
               f32_ms=cuda_ms(lambda: retrieval.top_k_items(
                   tables, ids, RET_TOPK), 10))
    check(out["ids_equal_f64"], f"top_k_items vs f64 {out}")
    check(out["quantized_overlap_min"] >= RET_OVERLAP,
          f"top_k_items_quantized overlap {out}")
    return out


def phase_sparse(timer):
    """Sparse rSVD, retrieval and RandomizedSVD at MovieLens-20M's shape."""
    out = {}
    users, items, nnz = ML20M
    with timer.phase("sparse_build"):
        a_sp = ml20m_operand()
        st = driver.sparse_operand(a_sp)
        torch.cuda.synchronize()
    csr_bytes = sum(t.numel() * t.element_size() for c in (st.fwd, st.bwd)
                    for t in (c.values(), c.col_indices(), c.crow_indices()))
    out["operand"] = dict(shape=[users, items], nnz=int(a_sp._nnz()),
                          rating_mean=float(st.values().mean()),
                          csr_pair_bytes=csr_bytes,
                          coo_bytes=int(a_sp._nnz()) * (2 * 8 + 4))
    l = K + P
    kw = dict(k=K, p=P, q=Q)
    with timer.phase("sparse_rsvd"):
        (u, s, v), t = timed(lambda: rsvd(st, **kw))
    out["rsvd_s"] = t
    _, s2, _ = rsvd(st, **kw)
    # cuSPARSE's SpMM is not bitwise from run to run: measured, not held
    out["rsvd_twice_max_rel_dsigma"] = float((s - s2).abs().max() / s[0])
    with timer.phase("dense_rsvd"):
        dense = a_sp.to_dense()
        (_, s_d, _), t = timed(lambda: rsvd(dense, **kw))
        del dense
        torch.cuda.empty_cache()
    out["dense_rsvd_s"] = t
    out["max_rel_dsigma_vs_dense"] = float((s - s_d).abs().max() / s_d[0])
    check(finite(u, s, v) and out["max_rel_dsigma_vs_dense"] <= SP_SIGMA_TOL
          and out["rsvd_twice_max_rel_dsigma"] <= SP_SIGMA_TOL,
          f"sparse rsvd vs dense {out}")
    gen = torch.Generator(device="cuda").manual_seed(20)
    omega = torch.randn(items, l, device="cuda", generator=gen)
    qy = torch.linalg.qr(torch.randn(users, l, device="cuda",
                                     generator=gen))[0]
    omega_cm = omega.T.contiguous().T                  # column-major
    flops = 2.0 * nnz * l
    with timer.phase("spmm_timings"):
        out["spmm"] = dict(
            l=l, forward_ms=cuda_ms(lambda: driver._mm(st, omega), 20),
            forward_bound_ms=bound(flops, spmm_bytes(users, items, nnz,
                                                     l))[0],
            at_csr_ms=cuda_ms(lambda: driver._mm(qy.T, st), 20),
            at_csr_bound_ms=bound(flops, spmm_bytes(items, users, nnz,
                                                    l))[0],
            # the alternatives the driver does not take, measured only
            forward_column_major_operand_ms=cuda_ms(
                lambda: st.fwd @ omega_cm, 5),
            at_through_a_csr_transposed_ms=cuda_ms(
                lambda: st.fwd.t() @ qy, 5),
            coo_forward_ms=cuda_ms(lambda: torch.sparse.mm(a_sp, omega), 5),
            bitwise_twice=bool(torch.equal(driver._mm(st, omega),
                                           driver._mm(st, omega))))
    # one call: its Jacobi tail's many small kernels make the trace's
    # event walk take seconds a call
    with timer.phase("sparse_profile"):
        out["profile_rsvd"] = profile_call(lambda: rsvd(st, **kw), reps=1)
    log("  sparse rsvd: " + json.dumps(out))
    with timer.phase("factorize_interactions"):
        tables, t = timed(lambda: retrieval.factorize_interactions(
            a_sp, k=K))
    ids = torch.randperm(users, device="cuda", generator=gen)[:RET_USERS]
    out["factorize_s"] = t
    with timer.phase("retrieval"):
        out["retrieval"] = retrieval_checks(tables, ids)
    log("  retrieval: " + json.dumps(out["retrieval"]))
    est = estimators.RandomizedSVD(n_components=K)
    with timer.phase("randomized_svd"):
        scores, t = timed(lambda: est.fit_transform(a_sp))
    with timer.phase("randomized_svd_f64_check"):
        out["randomized_svd"] = dict(s=t, **estimator_ratio_check(
            est, scores, st))
    log("  RandomizedSVD: " + json.dumps(out["randomized_svd"]))
    del a_sp, st, tables, omega, qy
    torch.cuda.empty_cache()
    return out


def estimator_ratio_check(est, scores, st):
    """RandomizedSVD's explained_variance_ratio_ against f64 on the host:
    the f64 variance of its scores over scipy.sparse's f64 total column
    variance of the same matrix."""
    import scipy.sparse as sps

    csr = sps.csr_matrix(
        (to_numpy(st.fwd.values()).astype(np.float64),
         to_numpy(st.fwd.col_indices()), to_numpy(st.fwd.crow_indices())),
        shape=st.shape)
    m = csr.shape[0]
    mean = np.asarray(csr.mean(axis=0)).ravel()
    sq = np.asarray(csr.multiply(csr).mean(axis=0)).ravel()
    total = float(np.sum(sq - mean ** 2))
    ratio64 = np.var(scores.astype(np.float64), axis=0) / total
    # the estimator takes the scores' variance in f32 (the JAX
    # estimator's numpy arithmetic); the first score column's mean is
    # most of it, so that variance carries ~1e-4 of itself
    err = float(np.abs(est.explained_variance_ratio_ - ratio64).max())
    out = dict(ratio_top3=est.explained_variance_ratio_[:3].tolist(),
               ratio_sum=float(est.explained_variance_ratio_.sum()),
               max_abs_err_vs_f64=err, max_rel_err_vs_f64=float(np.abs(
                   est.explained_variance_ratio_ - ratio64).max()
                   / ratio64[0]), total_variance_f64=total)
    check(err <= EST_RATIO_TOL, f"RandomizedSVD ratio vs f64 {out}")
    return out


def kpca_points(n, gen):
    """n points in KPCA_D dimensions with per-axis scales 4 KPCA_DECAY^j:
    an RBF kernel (gamma 1/d) with a decaying, distinct spectrum."""
    scale = 4.0 * KPCA_DECAY ** torch.arange(KPCA_D, device="cuda",
                                              dtype=torch.float32)
    return torch.randn(n, KPCA_D, device="cuda", generator=gen) * scale


def centred_eigvalsh64(x, k):
    """The top k eigenvalues of x's centred RBF kernel, in f64."""
    km = kpca.kernel_matrix(x, x).double()
    km -= km.mean(dim=0)[None, :]
    km -= km.mean(dim=1, keepdim=True)
    return torch.linalg.eigvalsh(km).flip(0)[:k]


def phase_kpca(timer):
    """KernelPCA 'randomized' and 'nystrom' at n = 16384, transform of
    4096 new rows, 'exact' at n = 1024, against f64."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = kpca_points(KPCA_N, gen)
    with timer.phase("kpca_f64_eigvalsh"):
        lam, t = timed(lambda: centred_eigvalsh64(x, KPCA_K))
    out = dict(n=KPCA_N, d=KPCA_D, k=KPCA_K, f64_eigvalsh_s=t,
               kernel_bytes=4 * KPCA_N * KPCA_N)
    lam1 = float(lam[0])
    for solver, p, tol in (("randomized", 10, KPCA_RAND_TOL),
                           ("nystrom", KPCA_NYS_P, KPCA_NYS_TOL)):
        with timer.phase(f"kpca_{solver}"):
            kp, t = timed(lambda: kpca.KernelPCA(
                KPCA_K, solver=solver, p=p).fit(x))
        d = (kp.eigenvalues_.double() - lam) / lam1
        out[solver] = dict(p=p, s=t, max_abs_dlam_over_lam1=float(
            d.abs().max()), max_over_truth=float(d.max()))
        check(finite(kp.eigenvalues_, kp.alphas_)
              and out[solver]["max_abs_dlam_over_lam1"] <= tol,
              f"KernelPCA {solver} {out[solver]}")
        if solver == "randomized":
            y = kpca_points(KPCA_NEW, gen)
            with timer.phase("kpca_transform"):
                z, t = timed(lambda: kp.transform(y))
            z64 = kpca._transform_impl(
                y.double(), x.double(), "rbf", 1.0 / KPCA_D, 3, 1.0,
                kp._col_means.double(), kp._tot.double(),
                kp.alphas_.double(), kp._inv_sqrt.double())
            out["transform"] = dict(rows=KPCA_NEW, s=t, max_err_over_max=float(
                (z.double() - z64).abs().max() / z64.abs().max()))
            check(out["transform"]["max_err_over_max"] <= KPCA_TRANSFORM_TOL,
                  f"KernelPCA transform {out['transform']}")
    xs = kpca_points(KPCA_EXACT_N, gen)
    lam_s = centred_eigvalsh64(xs, KPCA_K)
    kp, t = timed(lambda: kpca.KernelPCA(KPCA_K, solver="exact").fit(xs))
    out["exact"] = dict(n=KPCA_EXACT_N, s=t, max_abs_dlam_over_lam1=float(
        (kp.eigenvalues_.double() - lam_s).abs().max() / lam_s[0]))
    check(out["exact"]["max_abs_dlam_over_lam1"] <= KPCA_EXACT_TOL,
          f"KernelPCA exact {out['exact']}")
    log("  KernelPCA: " + json.dumps(out))
    del x
    torch.cuda.empty_cache()
    return out


def labels_match(labels, truth, k):
    """Labels equal the truth up to a permutation: the contingency table
    has one nonzero entry in each row and column."""
    c = torch.zeros(k, k, dtype=torch.long, device=labels.device)
    c.index_put_((labels.long(), truth.long()),
                 torch.ones_like(truth, dtype=torch.long), accumulate=True)
    nz = c > 0
    return bool((nz.sum(0) == 1).all() and (nz.sum(1) == 1).all())


def half_moons(n, noise, gen):
    """sklearn's make_moons on the card: two interleaved half circles."""
    h = n // 2
    t1 = math.pi * torch.rand(h, device="cuda", generator=gen)
    t2 = math.pi * torch.rand(n - h, device="cuda", generator=gen)
    x = torch.cat([torch.stack([torch.cos(t1), torch.sin(t1)], 1),
                   torch.stack([1 - torch.cos(t2),
                                1 - torch.sin(t2) - 0.5], 1)])
    x += noise * torch.randn(n, 2, device="cuda", generator=gen)
    truth = torch.cat([torch.zeros(h, device="cuda", dtype=torch.long),
                       torch.ones(n - h, device="cuda", dtype=torch.long)])
    return x, truth


def phase_cluster(timer):
    """spectral_cluster: 8 planted blobs at n = 16384 through 'auto'
    (reigh) and k-NN half moons at n = 2048 through 'exact'."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    centers = CL_SCALE * torch.randn(CL_K, CL_D, device="cuda",
                                     generator=gen)
    truth = torch.arange(CL_N, device="cuda") % CL_K
    x = centers[truth] + torch.randn(CL_N, CL_D, device="cuda",
                                     generator=gen)
    with timer.phase("cluster_blobs"):
        res, t = timed(lambda: cluster.spectral_cluster(
            x, CL_K, gamma=CL_GAMMA))
    out = dict(blobs=dict(n=CL_N, k=CL_K, d=CL_D, gamma=CL_GAMMA, s=t,
                          eig_solver="auto (randomized)",
                          inertia=float(res.inertia),
                          exact_up_to_permutation=labels_match(
                              res.labels, truth, CL_K),
                          kmeans_peak_bytes=4 * CL_N * CL_K * CL_K))
    check(out["blobs"]["exact_up_to_permutation"], f"blobs {out['blobs']}")
    xm, tm = half_moons(MOONS_N, MOONS_NOISE, gen)
    with timer.phase("cluster_moons"):
        res, t = timed(lambda: cluster.spectral_cluster(
            xm, 2, affinity="knn", eig_solver="exact"))
    acc = float((res.labels.long() == tm).float().mean())
    out["moons"] = dict(n=MOONS_N, s=t, accuracy=max(acc, 1.0 - acc))
    check(out["moons"]["accuracy"] >= MOONS_ACC, f"moons {out['moons']}")
    log("  spectral_cluster: " + json.dumps(out))
    return out


def phase_estimator_pca(timer):
    """RandomizedPCA(n_components=64) on phase 7's factor model against
    the centred Gram's f64 eigenvalues."""
    x = pca_operand()
    sig_true, _ = f64_spectrum(x)
    out = {}
    for label, kw in (("defaults", {}),
                      ("checked", dict(p=EST_PCA_P, q=EST_PCA_Q))):
        with timer.phase(f"randomized_pca_{label}"):
            est, t = timed(lambda: estimators.RandomizedPCA(
                n_components=PCA_RANK, **kw).fit(x))
        err = float(np.abs(est.singular_values_ - sig_true[:PCA_RANK]).max()
                    / sig_true[0])
        out[label] = dict(s=t, max_rel_dsigma=err, **kw)
    check(out["checked"]["max_rel_dsigma"] <= EST_PCA_TOL,
          f"RandomizedPCA {out}")
    log("  RandomizedPCA: " + json.dumps(out))
    del x
    torch.cuda.empty_cache()
    return out


def planted_stream(m, n, rank, gen, seed, edge=None):
    """(SynthesizedMatrix, noise_fn, U diag(s), V): A = U diag(s) V^T + N
    made panel by panel on the card, s = logspace(0, -1, rank), N
    Gaussian at TENSOR_NOISE of the signal's norm or, given ``edge``,
    with its spectral edge c (sqrt(m) + sqrt(n)) at ``edge`` s_1; each
    panel's noise drawn from a generator seeded by its first row (every
    pass sees the same A)."""
    u = orthonormal(m, rank, gen)
    v = orthonormal(n, rank, gen)
    s = torch.logspace(0, -1, rank, device="cuda")
    us = u * s
    if edge is None:
        c = TENSOR_NOISE * float(torch.linalg.vector_norm(s)) \
            / math.sqrt(m * n)
    else:
        c = edge / (math.sqrt(m) + math.sqrt(n))

    def noise(start, rows):
        g = torch.Generator(device="cuda").manual_seed(seed * 7919 + start)
        return c * torch.randn(rows, n, device="cuda", generator=g)

    def panel(start, rows):
        return device.matmul_at(us[start:start + rows], v.T) + noise(
            start, rows)

    return streaming.SynthesizedMatrix((m, n), panel), noise, us, v


def streamed_k1_vs_plain(y, args, kwargs, out):
    """One recorded K1 call of the streamed run against its plain version
    on the same panel: R to ``R_TOL`` of max |R|, and Q's orthogonality
    (||Q^T Q - I||_F in f64) beside the plain Q's; max |dQ| reported (the
    panel's oversampled columns lie at the noise floor, where the two
    summation orders' Q columns differ by the panel's condition number
    squared times the rounding); K1's Q no further from orthonormal than
    twice the plain Q's (or ``ORTH_TOL``)."""
    q, r = out
    q0, r0 = kernels.fused_cholqr1_reference(y, *args, **kwargs)
    res = dict(shape=list(y.shape), max_dq=float((q - q0).abs().max()),
               max_dr_over_r=float((r - r0).abs().max() / r0.abs().max()),
               orth=fro_orth64(q), orth_plain=fro_orth64(q0))
    check(finite(q, r) and finite(q0, r0) and res["max_dr_over_r"] <= R_TOL
          and res["orth"] <= max(2.0 * res["orth_plain"], ORTH_TOL),
          f"streamed K1 vs plain {res}")
    return res


def stream_error(a, noise, u, s, v, panel_rows):
    """(||A - U diag(s) V^T||_F, ||N||_F) in one more streamed pass."""
    err_sq = noise_sq = 0.0
    us = u * s
    for start, rows in streaming._panels(a.shape[0], panel_rows):
        e = a.panel(start, rows) - device.matmul_at(us[start:start + rows],
                                                    v.T)
        err_sq += float(torch.sum(e.double() ** 2))
        noise_sq += float(torch.sum(noise(start, rows).double() ** 2))
    return math.sqrt(err_sq), math.sqrt(noise_sq)


def phase_stream_north(timer):
    """rsvd_streaming of a 100000^2 SynthesizedMatrix through K1 and K3,
    counted; each launch held to its plain version.  K1 is CholeskyQR1
    with no fallback (the JAX kernel too): its operand keeps the
    panels' condition number near s_1 / edge = 100 (noise with its
    spectral edge at ``NS_EDGE`` s_1).  With noise at 1e-3 of the
    signal's norm the co-range panels reach ~5e4, where K1 and its plain
    version both return Q ~1 from orthonormal; that operand runs through
    the default 'robust' QR and the cuSOLVER tail, error checked, no
    kernel."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    l = NS_K + NS_P
    rows = streaming._default_panel_rows(NS_N, NS_N, torch.float32)
    a, noise, _, _ = planted_stream(NS_N, NS_N, NS_RANK, gen, seed=25)
    with timer.phase("stream_north_star_robust"):
        (u, s, v), t = timed(lambda: streaming.rsvd_streaming(
            a, k=NS_K, p=NS_P, q=Q, method="eigh"))
    err, nn = stream_error(a, noise, u, s, v, rows)
    robust = dict(noise_over_signal=TENSOR_NOISE, s=t,
                  err_over_noise=err / nn, u_orth=orth_err(u))
    check(finite(u, s, v) and robust["err_over_noise"] <= NOISE_SLACK,
          f"streaming north star, robust QR {robust}")
    check(counts() == NONE, f"robust streaming run launched {counts()}")
    a, noise, _, _ = planted_stream(NS_N, NS_N, NS_RANK, gen, seed=23,
                                    edge=NS_EDGE)
    times = {}
    rec1 = Recorder(kernels.fused_cholqr1)
    rec3 = Recorder(kernels.eigh_small)
    with mock.patch.object(kernels, "fused_cholqr1", rec1), \
            mock.patch.object(kernels, "eigh_small", rec3):
        with timer.phase("stream_north_star"):
            (u, s, v), t = timed(lambda: streaming.rsvd_streaming(
                a, k=NS_K, p=NS_P, q=Q, qr_method="cholqr1_fused",
                method="eigh_pallas", phase_times=times))
        launches = counts()
    k1 = recorded_vs_plain(rec1, streamed_k1_vs_plain)
    k3 = recorded_vs_plain(rec3, eigh_vs_plain)
    # the kernels timed at the shapes this path hands them (after the
    # counts are read: these launches compare, they are not the path's)
    y = rec1.calls[-1][0]
    m1, l1 = y.shape
    g = rec3.calls[0][0]
    n3 = g.shape[0]
    timings = dict(
        k1=dict(shape=[m1, l1],
                ms=cuda_ms(lambda: kernels.fused_cholqr1(y), 10),
                plain_ms=cuda_ms(lambda: kernels.fused_cholqr1_reference(
                    y), 3),
                library_ms=cuda_ms(lambda: torch.linalg.qr(y), 5),
                bound_ms=bound(2 * m1 * l1 * (l1 + 1) + 2 * l1 ** 3 / 3,
                               4 * (2 * m1 * l1 + l1 * l1))[0]),
        k3=dict(n=n3, ms=cuda_ms(lambda: kernels.eigh_small(g), 5),
                plain_ms=cuda_ms(lambda: kernels.eigh_small_reference(g),
                                 1),
                library_ms=cuda_ms(lambda: torch.linalg.eigh(g), 5)))
    with timer.phase("stream_north_star_error_pass"):
        (err, nn), t_err = timed(lambda: stream_error(a, noise, u, s, v,
                                                      rows))
    passes = 2 * Q + 2
    pass_s = (times.get("sketch", 0.0) + times.get("power_zt", 0.0)
              + times.get("power_y", 0.0) + times.get("project", 0.0))
    gemm = bound(2.0 * NS_N * NS_N * l, 4.0 * NS_N * NS_N)[0]
    synth = bound(2.0 * NS_N * NS_N * NS_RANK, 4.0 * NS_N * NS_N)[0]
    out = dict(shape=[NS_N, NS_N], rank=NS_RANK, k=NS_K, p=NS_P, q=Q,
               noise_edge_over_s1=NS_EDGE, noise_over_signal=nn / float(
                   torch.linalg.vector_norm(torch.logspace(
                       0, -1, NS_RANK, dtype=torch.float64))),
               panel_rows=rows, s=t, phase_s=times,
               ms_per_pass=1e3 * pass_s / passes,
               gemm_bound_ms_per_pass=gemm,
               synthesis_bound_ms_per_pass=synth,
               err_over_noise=err / nn, error_pass_s=t_err,
               launches_k1_to_k5b=list(launches), k1_calls_vs_plain=k1,
               k3_calls_vs_plain=k3, kernels_at_path_shapes=timings,
               u_orth=orth_err(u), robust_qr_at_1e3_noise=robust)
    check(finite(u, s, v) and out["err_over_noise"] <= NOISE_SLACK,
          f"streaming north star {out}")
    log("  rsvd_streaming 100000^2: " + json.dumps(out))
    return out


def free_memory():
    """The host's ``free -g`` table, and its available GiB."""
    text = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          timeout=30, check=True).stdout
    avail = int(text.splitlines()[1].split()[-1])
    return text, avail


def stream_pass_times(a_host, a_dev, omega, rows, panel_dtype):
    """(copy-only, compute-only, full) seconds of one streamed Y = A Omega
    pass: the panels' host work and copies alone, the products on
    panels already on the card, and both."""
    def copy_only():
        for _ in streaming._stream_panels(a_host, rows, torch.float32,
                                          panel_dtype=panel_dtype):
            pass

    on_card = streaming.SynthesizedMatrix(
        a_dev.shape, lambda start, n: a_dev[start:start + n])
    _, t_copy = timed(copy_only)
    _, t_compute = timed(lambda: streaming._stream_right_multiply(
        on_card, omega, rows, torch.float32))
    _, t_full = timed(lambda: streaming._stream_right_multiply(
        a_host, omega, rows, torch.float32, panel_dtype=panel_dtype))
    return t_copy, t_compute, t_full


def phase_stream_host(timer, tmp):
    """rsvd_streaming of a 65536 x 16384 f32 A held in pinned host memory:
    each wire encoding against the in-core rsvd on the same Omega, the
    copies' rate and overlap, the one-pass driver, and a checkpointed
    run stopped after its second pass and resumed."""
    mem, avail = free_memory()
    log("  free -g:\n" + "\n".join("    " + x for x in mem.splitlines()))
    need = 3 * 4 * HOST_M * HOST_N / 2 ** 30
    check(avail >= need, f"host memory: {avail} GiB available, {need:.1f} "
          f"needed for the host-streamed run")
    gen = torch.Generator(device="cuda").manual_seed(24)
    signal = device.matmul_at(orthonormal(HOST_M, HOST_RANK, gen)
                              * torch.logspace(0, -1, HOST_RANK,
                                               device="cuda"),
                              orthonormal(HOST_N, HOST_RANK, gen).T)
    a_dev, _ = planted(signal, gen)
    del signal
    with timer.phase("stream_host_pin"):
        a_host = torch.empty(a_dev.shape, dtype=torch.float32,
                             pin_memory=True)
        a_host.copy_(a_dev)
    l = HOST_K + P
    rows = streaming._default_panel_rows(HOST_M, HOST_N, torch.float32)
    kw = dict(k=HOST_K, p=P, q=HOST_Q, method="eigh")
    omega = generate_omega(0, HOST_N, l, device="cuda")
    _, s_ref, _ = rsvd_with_omega(a_dev, omega, q=HOST_Q, k=HOST_K,
                                  method="eigh")
    out = dict(shape=[HOST_M, HOST_N], host_bytes=4 * HOST_M * HOST_N,
               panel_rows=rows, available_gib=avail, runs={})
    wire = {None: 4.0, "bfloat16": 2.0, "int8": 1.0 + 4.0 / HOST_N}
    for pdt in (None, "bfloat16", "int8"):
        times = {}
        name = pdt or "none"
        with timer.phase(f"stream_host_{name}"):
            (u, s, v), t = timed(lambda: streaming.rsvd_streaming(
                a_host, panel_dtype=pdt, phase_times=times, **kw))
        t_copy, t_compute, t_full = stream_pass_times(a_host, a_dev, omega,
                                                      rows, pdt)
        bytes_ = wire[pdt] * HOST_M * HOST_N
        run = dict(s=t, phase_s=times, max_rel_dsigma_vs_in_core=float(
            (s - s_ref).abs().max() / s_ref[0]),
            wire_bytes_per_pass=bytes_, copy_only_pass_s=t_copy,
            compute_only_pass_s=t_compute, full_pass_s=t_full,
            wire_gb_per_s=bytes_ / t_copy / 1e9,
            hidden_s=t_copy + t_compute - t_full,
            hidden_share_of_copy=min(1.0, max(0.0, (
                t_copy + t_compute - t_full) / t_copy)),
            hidden_share_of_compute=min(1.0, max(0.0, (
                t_copy + t_compute - t_full) / t_compute)))
        out["runs"][name] = run
        check(finite(u, s, v) and run["max_rel_dsigma_vs_in_core"]
              <= STREAM_TOL, f"host stream {name} {run}")
        log(f"  rsvd_streaming host [{name}]: " + json.dumps(run))
    out["profile_pass"] = profile_call(
        lambda: streaming._stream_right_multiply(a_host, omega, rows,
                                                 torch.float32), reps=1)
    with timer.phase("stream_host_onepass"):
        (u, s, v), t = timed(lambda: streaming.rsvd_streaming_onepass(
            a_host, k=HOST_K, p=P, method="eigh"))
    _, s1, _ = rsvd_onepass(a_dev, k=HOST_K, p=P, method="eigh")
    out["onepass"] = dict(s=t, max_rel_dsigma_vs_in_core=float(
        (s - s1).abs().max() / s1[0]))
    check(out["onepass"]["max_rel_dsigma_vs_in_core"] <= STREAM_TOL,
          f"onepass {out['onepass']}")
    # a checkpointed run stopped after its second pass, then resumed
    ckdir = os.path.join(tmp, "stream_ckpt")
    done = {"passes": 0}
    real = {name: getattr(streaming, name) for name in
            ("_stream_right_multiply", "_stream_left_t_multiply")}

    def stop_after_two(fn):
        def wrapped(*args, **kwargs):
            if done["passes"] == 2:
                raise Interrupted
            done["passes"] += 1
            return fn(*args, **kwargs)
        return wrapped

    with timer.phase("stream_host_checkpoint"):
        with mock.patch.multiple(streaming, **{
                n: stop_after_two(f) for n, f in real.items()}):
            try:
                streaming.rsvd_streaming(a_host, checkpoint_dir=ckdir, **kw)
            except Interrupted:
                pass
        saved = sorted(os.listdir(ckdir))
        resumed = streaming.rsvd_streaming(a_host, checkpoint_dir=ckdir,
                                           **kw)
        whole = streaming.rsvd_streaming(a_host, **kw)
        torch.cuda.synchronize()
    out["checkpoint"] = dict(passes_before_stop=done["passes"],
                             saved_at_stop=saved,
                             resumed_bitwise=all(torch.equal(x, y) for x, y
                                                 in zip(resumed, whole)))
    check(done["passes"] == 2 and "q0.npy" in saved
          and out["checkpoint"]["resumed_bitwise"],
          f"checkpoint resume {out['checkpoint']}")
    log("  rsvd_streaming host: " + json.dumps(
        {k: out[k] for k in ("onepass", "checkpoint")}))
    del a_host, a_dev
    torch.cuda.empty_cache()
    return out


def phase_apps_streaming():
    """Phase 11: sparse operands and retrieval, kernel PCA, spectral
    clustering, the estimators and out-of-core streaming.  Returns
    ((K1, K2, K3, K4, K5a, K5b) launches of its counted runs, summary):
    only the north-star streaming run launches kernels (K1 2q + 1 times,
    K3 once), which is checked for every part."""
    t0 = time.perf_counter()
    timer = PhaseTimer()
    out = {}
    launches = list(NONE)
    tmp = tempfile.mkdtemp()
    try:
        for name, fn, want in (
                ("sparse_retrieval", lambda: phase_sparse(timer), NONE),
                ("kernel_pca", lambda: phase_kpca(timer), NONE),
                ("spectral_cluster", lambda: phase_cluster(timer), NONE),
                ("randomized_pca", lambda: phase_estimator_pca(timer),
                 NONE),
                ("stream_north_star", lambda: phase_stream_north(timer),
                 launches_of(k1=2 * Q + 1, k3=1)),
                ("stream_host", lambda: phase_stream_host(timer, tmp),
                 NONE)):
            phase(f"phase 11: {name}")
            reset_counts()
            res = fn()
            torch.cuda.synchronize()
            # a part that times its kernels after its driven call reads
            # the counts right after that call
            got = tuple(res.get("launches_k1_to_k5b", counts()))
            check(got == want, f"phase 11 {name}: (K1, K2, K3, K4, K5a, "
                  f"K5b) launches {got}, not {want}")
            launches = [t + c for t, c in zip(launches, got)]
            out[name] = res
            torch.cuda.empty_cache()
        csv_path = os.path.join(tmp, "phase11.csv")
        timer.write_csv(csv_path)
        with open(csv_path) as f:
            log("  PhaseTimer CSV:\n" + "\n".join(
                "    " + line for line in f.read().strip().splitlines()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["stage_ms"] = {name: timer.total_ms(name) for name in timer.phases}
    out["s"] = time.perf_counter() - t0
    return launches, out


P12_RANKS = 4
P12_TIMEOUT = 420.0       # s: the four ranks' whole run
P12_SIGMA_TOL = 1e-4      # sharded vs single-card, max |ds| / s_1
P12_SERVE_TOL = 1e-3      # serving: error within 0.1% of the single call's
P12_PANEL = 625           # streamed rows a panel; divides a rank's 25000
P12_EMB = 64              # retrieval: k_emb (phase 11's k)
P12_PROD = dict(k=K, q=Q, method="eigh", precision="default",
                reorth="half", interior_qr="robust1")
P12_SERVE = dict(k=K, q=Q, precision="default", reorth="half",
                 qr_method="cholqr1", interior_qr="cholqr1",
                 finish="rowspace_utv")
P12_KERNELS = dict(CONFIG, method="eigh_pallas")   # K1 x (q + 1), K3 x 1


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def p12_dsigma(s, s0):
    return float((s - s0).abs().max() / s0[0])


def p12_operand():
    """The main path's 4096^2 f32 operand (entry()'s, seed 0) and its
    Omega (``rsvd``'s draw from seed 0)."""
    _, (a,) = entry(device="cuda", m=M, n=N)
    return a, generate_omega(0, N, K + P, device="cuda")


def p12_whole_u(u):
    """A row-sharded U as the whole tensor on every rank, gathered through
    the port's counted collectives (DTensor's own ``full_tensor`` of a
    CUDA tensor over gloo crashes with torch 2.11)."""
    return from_dtensor(u).gather()


def p12_perturbed(omega):
    """Omega times (1 + 1e-7 xi), xi Gaussian: a roundoff-level change of
    the sketch, the yardstick of a call's own sensitivity."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    return omega * (1.0 + 1e-7 * torch.randn(omega.shape, device="cuda",
                                             generator=gen))


def p12_compare(label, sharded, single, a=None, say=log, perturbed=None):
    """One sharded call against the single-card call on the same Omega:
    max |ds| / s_1 (and whether bitwise), the sharded call's collectives,
    both calls' ms; ``perturbed``, the single call on
    ``p12_perturbed(Omega)``, gives the single call's own shift beside
    it.  With ``a``, the serving check: the reconstruction error within
    ``P12_SERVE_TOL`` of the single call's (the weights reported);
    otherwise max |ds| / s_1 <= ``P12_SIGMA_TOL``."""
    collectives.reset()
    u, s, v = sharded()
    torch.cuda.synchronize()
    tally = collectives.tally()
    u0, s0, v0 = single()
    out = dict(max_rel_dsigma=p12_dsigma(s, s0),
               bitwise=bool(torch.equal(s, s0)), collectives=tally)
    if perturbed is not None:
        out["single_vs_perturbed_omega"] = p12_dsigma(perturbed()[1], s0)
    check(finite(s, v) and (a is not None
                            or out["max_rel_dsigma"] <= P12_SIGMA_TOL),
          f"phase 12 {label}: {out}")
    if a is not None:
        err = float(reconstruction_error(a, p12_whole_u(u), s, v))
        err0 = float(reconstruction_error(a, u0, s0, v0))
        out["err_over_single"] = err / err0
        check(abs(err / err0 - 1.0) <= P12_SERVE_TOL,
              f"phase 12 {label}: serving error {err} vs {err0}")
    out["ms"] = cuda_ms(sharded, 3)
    out["single_ms"] = cuda_ms(single, 3)
    say(f"  {label}: " + json.dumps(out))
    return out


def p12_kernel_path(label, sharded, single, say=log):
    """The main path's kernel configuration (K1 interiors, K3 tail) on a
    sharded operand, counted; each launch held to its plain version."""
    rec1 = Recorder(kernels.fused_cholqr1)
    rec3 = Recorder(kernels.eigh_small)
    reset_counts()
    with mock.patch.object(kernels, "fused_cholqr1", rec1), \
            mock.patch.object(kernels, "eigh_small", rec3):
        _, s, _ = sharded()
        torch.cuda.synchronize()
        launches = counts()
    check(launches == launches_of(k1=Q + 1, k3=1),
          f"phase 12 {label}: launches {launches}")
    _, s0, _ = single()
    out = dict(launches_k1_to_k5b=list(launches),
               max_rel_dsigma=p12_dsigma(s, s0),
               k1_calls_vs_plain=recorded_vs_plain(rec1, cholqr1_vs_plain),
               k3_calls_vs_plain=recorded_vs_plain(rec3, eigh_vs_plain))
    check(out["max_rel_dsigma"] <= P12_SIGMA_TOL, f"phase 12 {label} {out}")
    say(f"  {label}: " + json.dumps(out))
    return out


def p12_one_rank_nccl():
    """Phase 12a: a one-rank NCCL group in this process.  The main-path
    operand through ``rsvd_sharded`` in the production, serving and
    kernel configurations and a pre-quantized 16384^2 int8 operand, each
    against the single-card call; one profiler pass splits a sharded call
    into NCCL and compute.  Two NCCL ranks on this host's one card must
    be refused before any connection."""
    with mock.patch.dict(os.environ, {"LOCAL_WORLD_SIZE": "2"}):
        try:
            initialize("127.0.0.1:1", 2, 0, backend="nccl")
            refused = ""
        except RuntimeError as e:
            refused = str(e)
    check("one card a rank" in refused and not dist.is_initialized(),
          f"two NCCL ranks on one card were not refused: {refused!r}")
    log(f"  two NCCL ranks on one card refused: {refused}")
    initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        check(dist.get_backend() == "nccl", dist.get_backend())
        mesh = make_mesh(device="cuda")
        a, omega = p12_operand()
        out = {}
        out["production"] = p12_compare(
            "nccl x1, production (eigh/default/half/robust1)",
            lambda: rsvd_sharded(a, mesh, p=P, seed=0, **P12_PROD),
            lambda: rsvd_with_omega(a, omega, **P12_PROD))
        serve = {k: v for k, v in P12_SERVE.items() if k != "k"}
        out["serving"] = p12_compare(
            "nccl x1, serving (rowspace_utv/cholqr1)",
            lambda: rsvd_sharded(a, mesh, k=K, p=P, seed=0, **serve),
            lambda: rsvd_with_omega(a, omega, k=K, **serve), a=a)
        kern = {k: v for k, v in P12_KERNELS.items() if k != "k"}
        out["kernels"] = p12_kernel_path(
            "nccl x1, K1 interiors + K3 tail",
            lambda: rsvd_sharded(a, mesh, k=K, p=P, seed=0,
                                 precision="default", **kern),
            lambda: rsvd_with_omega(a, omega, k=K, precision="default",
                                    **kern))
        out["profile_production"] = profile_call(
            lambda: rsvd_sharded(a, mesh, p=P, seed=0, **P12_PROD), reps=5,
            keep_top=8)
        log("  profile [nccl x1, production]: "
            + json.dumps(out["profile_production"]))
        del a
        gen = torch.Generator(device="cuda").manual_seed(12)
        a8 = quantize_int8_rows(torch.randn(BIG, BIG, device="cuda",
                                            generator=gen))
        omega8 = generate_omega(0, BIG, BIG_K + P, device="cuda")
        out["int8_16384"] = p12_compare(
            f"nccl x1, int8 {BIG}^2 k={BIG_K}",
            lambda: rsvd_sharded(a8, mesh, k=BIG_K, p=P, q=Q, seed=0,
                                 method="eigh"),
            lambda: rsvd_with_omega(a8, omega8, k=BIG_K, q=Q,
                                    method="eigh", precision="int8"))
        del a8
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out["kernels"]["launches_k1_to_k5b"], out


def p12_planted(start=0, rows=NS_N):
    """Rows [start, start + rows) of phase 11's 100000^2 planted operand
    (rank 128, noise edge at 1e-2 sigma_1), made from seed 29 on every
    process alike: (SynthesizedMatrix, its noise)."""
    gen = torch.Generator(device="cuda").manual_seed(29)
    a, noise, _, _ = planted_stream(NS_N, NS_N, NS_RANK, gen, seed=29,
                                    edge=NS_EDGE)
    return (streaming.SynthesizedMatrix(
                (rows, NS_N), lambda s0, r: a.panel(start + s0, r)),
            lambda s0, r: noise(start + s0, r))


P12_STREAM = dict(k=NS_K, p=NS_P, q=Q, qr_method="cholqr1_fused",
                  method="eigh_pallas", panel_rows=P12_PANEL)


def p12_stream_reference():
    """The single-card ``rsvd_streaming`` of the planted operand with
    phase 12's panels, counted (K1 2q + 1, K3 1): the reference the
    four ranks' multi-host run is held to."""
    a, noise = p12_planted()
    reset_counts()
    (u, s, v), t = timed(lambda: streaming.rsvd_streaming(a, **P12_STREAM))
    launches = counts()
    check(launches == launches_of(k1=2 * Q + 1, k3=1),
          f"phase 12 streaming reference launches {launches}")
    err, nn = stream_error(a, noise, u, s, v, P12_PANEL)
    out = dict(s=t, err_over_noise=err / nn,
               launches_k1_to_k5b=list(launches))
    check(finite(u, s, v) and out["err_over_noise"] <= NOISE_SLACK,
          f"phase 12 streaming reference {out}")
    log("  single-card rsvd_streaming 100000^2: " + json.dumps(out))
    return launches, out, to_numpy(s)


def p12_split(call, rank, reps=3):
    """Rank 0's profiler pass over ``reps`` sharded calls (every rank runs
    them): device busy and wall ms a call, and the collectives' tally
    (``core/collectives.py``)."""
    collectives.reset()
    if rank == 0:
        prof = profile_call(call, reps=reps)
    else:
        for _ in range(reps + 1):
            call()
        torch.cuda.synchronize()
    if rank:
        return None
    return dict(wall_ms_per_call=prof["wall_ms_per_call"],
                device_busy_ms_per_call=prof["device_busy_ms_per_call"],
                collectives=collectives.tally())


def p12_top_k(mesh, rank, say):
    """``top_k_items_sharded`` at MovieLens-20M's item count against
    ``top_k_items``: scores to 1e-5 of the row's max, ids equal but at
    near-ties (``RET_TIE``)."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    items = torch.randn(ML20M[1], P12_EMB, device="cuda", generator=gen)
    users = torch.randn(RET_USERS, P12_EMB, device="cuda", generator=gen)
    tables = retrieval.EmbeddingTables(users, items, None)
    ids_all = torch.arange(RET_USERS, device="cuda")
    collectives.reset()
    vals, ids = retrieval.top_k_items_sharded(mesh, tables, users, RET_TOPK)
    torch.cuda.synchronize()
    tally = collectives.tally()
    # one more than k: a near-tie at the k-th place excuses it too
    vals0, ids0 = retrieval.top_k_items(tables, ids_all, RET_TOPK + 1)
    scale = vals0.abs().max(dim=1, keepdim=True).values
    close = (vals0[:, :-1] - vals0[:, 1:]) < RET_TIE * scale
    vals0, ids0 = vals0[:, :-1], ids0[:, :-1]
    tie = close | torch.roll(close, 1, 1) & (torch.arange(
        RET_TOPK, device="cuda") > 0)
    dval = float(((vals - vals0).abs() / scale).max())
    wrong = int(((ids != ids0) & ~tie).sum())
    out = dict(items=ML20M[1], users=RET_USERS, k=RET_TOPK,
               max_rel_dscore=dval, ids_differing_at_ties=int(
                   ((ids != ids0) & tie).sum()), collectives=tally,
               ms=cuda_ms(lambda: retrieval.top_k_items_sharded(
                   mesh, tables, users, RET_TOPK), 5),
               single_ms=cuda_ms(lambda: retrieval.top_k_items(
                   tables, ids_all, RET_TOPK), 5))
    check(dval <= 1e-5 and wrong == 0, f"phase 12 top-k {out}")
    say("  top_k_items_sharded: " + json.dumps(out))
    return out


def p12_multihost(rank, world, ref_s, say):
    """This rank's 25000 rows of the planted 100000^2 operand through
    ``rsvd_streaming_multihost`` (K1 on the replicated Z, K3 on the
    tail), counted and each launch held to its plain version; sigma and
    the error summed over the ranks against the single-card reference."""
    rows = NS_N // world
    a, noise = p12_planted(rank * rows, rows)
    rec1 = Recorder(kernels.fused_cholqr1)
    rec3 = Recorder(kernels.eigh_small)
    reset_counts()
    collectives.reset()
    with mock.patch.object(kernels, "fused_cholqr1", rec1), \
            mock.patch.object(kernels, "eigh_small", rec3):
        (u, s, v), t = timed(lambda: rsvd_streaming_multihost(
            a, **P12_STREAM))
        launches = counts()
    tally = collectives.tally()
    check(launches == launches_of(k1=Q, k3=1),
          f"phase 12 multihost launches {launches}")
    k1 = recorded_vs_plain(rec1, streamed_k1_vs_plain)
    k3 = recorded_vs_plain(rec3, eigh_vs_plain)
    err, nn = stream_error(a, noise, u, s, v, P12_PANEL)
    sq = collectives.all_reduce(torch.tensor([err * err, nn * nn],
                                             dtype=torch.float64,
                                             device="cuda"))
    s_ref = torch.from_numpy(ref_s).to(s.device)
    out = dict(rows_a_rank=rows, s=t, collectives=tally,
               max_rel_dsigma=p12_dsigma(s, s_ref),
               err_over_noise=math.sqrt(float(sq[0]) / float(sq[1])),
               launches_k1_to_k5b=list(launches), k1_calls_vs_plain=k1,
               k3_calls_vs_plain=k3)
    check(out["max_rel_dsigma"] <= STREAM_TOL
          and out["err_over_noise"] <= NOISE_SLACK,
          f"phase 12 multihost streaming {out}")
    say("  rsvd_streaming_multihost 100000^2 (rank 0): " + json.dumps(out))
    return launches, out


def p12_rank(rank, world, port, ref_s, results):
    """One of phase 12b's four ranks sharing the card over gloo (a
    spawned process; the kernels phase 1 built are loaded, not built)."""
    torch.cuda.set_device(0)
    initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    say = log if rank == 0 else (lambda msg: None)
    out, launches = {}, [0] * len(NONE)
    reset_counts()
    t0 = time.perf_counter()
    out["dryrun"] = dryrun_multichip(world, device="cuda")
    out["dryrun_s"] = time.perf_counter() - t0
    check(counts() == NONE, f"dryrun launched {counts()}")

    a, omega = p12_operand()
    mesh1 = make_mesh(device="cuda")
    mesh2 = make_mesh((2, 2), ("rows", "cols"), device="cuda")
    a1 = shard_rows(a, mesh1)
    a2 = distribute(a, mesh2, (Shard(0), Shard(1)))

    omega_p = p12_perturbed(omega)

    def single():
        return rsvd_with_omega(a, omega, **P12_PROD)

    def perturbed():
        return rsvd_with_omega(a, omega_p, **P12_PROD)
    out["production_1d"] = p12_compare(
        "gloo x4 (4,) production", lambda: rsvd_with_omega(
            a1, omega, **P12_PROD), single, say=say, perturbed=perturbed)
    out["production_2d"] = p12_compare(
        "gloo x4 (2, 2) production", lambda: rsvd_with_omega(
            a2, omega, **P12_PROD), single, say=say, perturbed=perturbed)
    out["serving_1d"] = p12_compare(
        "gloo x4 (4,) serving", lambda: rsvd_with_omega(
            a1, omega, **P12_SERVE), lambda: rsvd_with_omega(
            a, omega, **P12_SERVE), a=a, say=say,
        perturbed=lambda: rsvd_with_omega(a, omega_p, **P12_SERVE))
    out["kernels_1d"] = p12_kernel_path(
        "gloo x4 (4,) K1 interiors + K3 tail", lambda: rsvd_with_omega(
            a1, omega, precision="default", **P12_KERNELS),
        lambda: rsvd_with_omega(a, omega, precision="default",
                                **P12_KERNELS), say=say)
    launches = [x + y for x, y in zip(
        launches, out["kernels_1d"]["launches_k1_to_k5b"])]
    collectives.reset()
    u_r, s_r, v_r = rsvd_ring(mesh1, a, k=K, p=P, q=Q, method="eigh")
    torch.cuda.synchronize()
    ring_tally = collectives.tally()
    _, s0, _ = rsvd_with_omega(a, omega, k=K, q=Q, method="eigh")
    out["ring"] = dict(max_rel_dsigma=p12_dsigma(s_r, s0),
                       collectives=ring_tally,
                       ms=cuda_ms(lambda: rsvd_ring(
                           mesh1, a, k=K, p=P, q=Q, method="eigh"), 3))
    check(out["ring"]["max_rel_dsigma"] <= P12_SIGMA_TOL
          and set(ring_tally) == {"all_reduce", "send_recv"},
          f"phase 12 ring {out['ring']}")
    say("  gloo x4 ring 4096^2: " + json.dumps(out["ring"]))
    out["split_production_1d"] = p12_split(
        lambda: rsvd_with_omega(a1, omega, **P12_PROD), rank)
    say("  profile split [gloo x4 (4,) production, rank 0]: "
        + json.dumps(out["split_production_1d"]))
    del a, a1, a2
    torch.cuda.empty_cache()
    out["top_k"] = p12_top_k(mesh1, rank, say)
    mh_launches, out["multihost"] = p12_multihost(rank, world, ref_s, say)
    launches = [x + y for x, y in zip(launches, mh_launches)]
    results.put((rank, out, launches))
    dist.destroy_process_group()


def p12_four_ranks(ref_s):
    """Phase 12b: four spawned ranks sharing the card over gloo; any
    rank's non-zero exit or the time limit fails the phase, and every
    rank is stopped at its end."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=p12_rank,
                         args=(r, P12_RANKS, port, ref_s, results))
             for r in range(P12_RANKS)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + P12_TIMEOUT
    try:
        while len(got) < P12_RANKS:
            check(time.monotonic() < deadline,
                  f"phase 12 ranks gave {len(got)} results in {P12_TIMEOUT} s")
            failed = [p.exitcode for p in procs if p.exitcode]
            check(not failed, f"phase 12 rank exit codes {failed}")
            try:
                rank, out, launches = results.get(timeout=2.0)
            except queue.Empty:
                continue
            got[rank] = (out, launches)
    finally:
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(all(p.exitcode == 0 for p in procs),
          f"phase 12 rank exit codes {[p.exitcode for p in procs]}")
    launches = [sum(got[r][1][i] for r in got) for i in range(len(NONE))]
    return launches, dict(rank0=got[0][0], ranks=P12_RANKS,
                          launches_all_ranks=launches)


def phase_distributed():
    """Phase 12: the distributed half on the card.  Returns ((K1, K2,
    K3, K4, K5a, K5b) launches of its counted runs, summary)."""
    t0 = time.perf_counter()
    out = {}
    la, out["nccl_one_rank"] = p12_one_rank_nccl()
    lr, out["stream_reference"], ref_s = p12_stream_reference()
    torch.cuda.empty_cache()
    lb, out["gloo_four_ranks"] = p12_four_ranks(ref_s)
    out["s"] = time.perf_counter() - t0
    launches = [x + y + z for x, y, z in zip(la, lr, lb)]
    log(f"  phase 12: {out['s']:.1f} s, launches {launches}")
    return launches, out


P13_RANKS = 4
P13_TIMEOUT = 480.0       # s: the four ranks' whole run
P13_TOL = 1e-4            # (b): sigma-like and span tolerances, of the max
# the JAX dry run's bar of the batched and tiled-image stages
# (__graft_entry__.py:272-273, :292): K3's tail moves sigma by ~1e-4 of
# sigma_1 when Omega moves by 1e-7 (its rotations are not orthogonal)
P13_BATCH_TOL = 1e-3
P13_K1_DR = 1e-5          # K1 on the gathered panels: max |dR| / max |R|
P13_PERTURB = 1e-7        # the single call's own shift: draws x (1 + 1e-7 xi)
P13_DEIM_M = 16           # deim_fit's basis: the 16 modes of the snapshots
# phase 13 (a) runs every size as phases 5, 7, 9 and 10 do; (b)'s four
# ranks share the card and gloo's host hops, so the sizes below are its
# cuts (PERF.md lists them): (rows a rank of FD's stream, Tucker's side)
P13B_FD_ROWS, P13B_TUCKER_N = 32768, 512
# every draw of the slice's modules, for the perturbed single call
P13_DRAWS = (("rsvd.driver", "generate_omega"),
             ("rsvd.trace", "sketch_matrix"), ("rsvd.slq", "rademacher"),
             ("rsvd.lstsq", "sketch_matrix"),
             ("rsvd.tucker", "generate_omega"),
             ("rsvd.utv", "generate_omega"),
             ("rsvd.completion", "sketch_matrix"),
             ("rsvd.rpca", "sketch_matrix"), ("apps.image", "sketch_matrix"))


@contextlib.contextmanager
def p13_perturbed(draws=P13_DRAWS):
    """Every float draw of the slice's modules (``draws``: (module, name)
    pairs) times (1 + 1e-7 xi), xi Gaussian: the single call's own
    sensitivity to a roundoff-level change.  A draw that returns a tuple
    has each of its tensors shifted."""
    gen = torch.Generator(device="cuda").manual_seed(7)

    def shift(x):
        return x * (1.0 + P13_PERTURB * torch.randn(
            x.shape, device=x.device, dtype=x.dtype, generator=gen))

    with contextlib.ExitStack() as stack:
        for mod, name in draws:
            module = importlib.import_module(
                "rsvd_kamaneh_raganato_terrana_tpu_torch." + mod)

            def draw(*args, _real=getattr(module, name), **kwargs):
                x = _real(*args, **kwargs)
                return tuple(map(shift, x)) if isinstance(x, tuple) \
                    else shift(x)
            stack.enter_context(mock.patch.object(module, name, draw))
        yield


def p13_whole(x):
    """A result with every DTensor gathered whole through the counted
    collectives (its sharded dim over the mesh's first axis), tuples and
    NamedTuples walked, numpy arrays and numbers as they are."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
        is_dtensor,
    )

    if is_dtensor(x):
        group = x.device_mesh.get_group(0)
        dim = x.placements[0].dim
        return collectives.all_gather(
            x.to_local().movedim(dim, 0).contiguous(), group).movedim(0, dim)
    if isinstance(x, tuple):
        return [p13_whole(v) for v in x]
    return x


def p13_tensors(x):
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in p13_tensors(v)]
    return [torch.as_tensor(x)]


def p13_bitwise(got, want):
    return all(torch.equal(a.cpu(), b.cpu()) for a, b in
               zip(p13_tensors(got), p13_tensors(want)))


def p13_sines(x, y):
    """Largest sine of the principal angles between two column spans."""
    qx = torch.linalg.qr(x.double())[0]
    qy = torch.linalg.qr(y.double())[0]
    return float(torch.linalg.matrix_norm(qy - qx @ (qx.T @ qy), ord=2))


def p13_compare(kinds, got, want):
    """Each named quantity of one call against another's: 'sigma' max
    |d| over max |ref| (per row of a stack: its own first); 'span' the
    largest sine between the spans; 'index' equal; 'value' relative
    norm; 'gram' of S: max |d (S^T S)| over max |S^T S|."""
    out = {}
    for name, kind in kinds.items():
        a, b = (torch.as_tensor(x).double() for x in (got[name],
                                                      want[name]))
        if kind == "sigma":
            ref = b[..., :1].abs() if b.ndim > 1 else b.abs().max()
            out[name] = float(((a - b).abs() / ref).max())
        elif kind == "span":
            out[name] = max(p13_sines(x, y) for x, y in zip(
                a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:])))
        elif kind == "index":
            out[name] = bool(torch.equal(a, b))
        elif kind == "value":
            out[name] = float(torch.linalg.vector_norm(a - b)
                              / torch.linalg.vector_norm(b))
        else:
            ga, gb = a.T @ a, b.T @ b
            out[name] = float((ga - gb).abs().max() / gb.abs().max())
    return out


def p13_within(diffs, tol):
    return all(v is True or (not isinstance(v, bool) and v <= tol)
               for v in diffs.values())


class P13Item:
    """One call of the slice, on a sharded operand and on the whole one:
    ``build()`` makes the operands (every rank alike, from seeds),
    ``place(ops, meshes)`` lays them out on the meshes (with meshes
    None: as the single call takes them), ``call`` runs the port on
    what ``place`` gives; ``pick`` maps a result (DTensors gathered) to
    the named quantities that ``kinds`` says how to compare; ``kernel``
    names a wrapper whose launches in the sharded call are recorded and
    held to its plain version; ``tol`` is the bar of the four-rank
    comparison."""

    def __init__(self, name, build, call, pick, kinds, place=None,
                 kernel=None, launches=NONE, tol=P13_TOL):
        self.name, self.build, self.call = name, build, call
        self.place = place or (lambda ops, meshes: shard_rows(
            ops, meshes["rows"]) if meshes else ops)
        self.pick, self.kinds = pick, kinds
        self.kernel, self.launches, self.tol = kernel, launches, tol


def p13_run(item, meshes, rank, bitwise, say):
    """One item: the sharded call (its collectives, launches and wall
    seconds, one call on operands laid out before the clock starts), the
    single call on rank 0 (one call, after it), and their comparison:
    bitwise on one rank, within ``item.tol`` on four, beside the single
    call's own shift under perturbed draws."""
    ops = item.build()
    placed = item.place(ops, meshes)
    rec = None
    with contextlib.ExitStack() as stack:
        if item.kernel is not None:
            rec = Recorder(getattr(kernels, item.kernel))
            stack.enter_context(mock.patch.object(kernels, item.kernel, rec))
        torch.cuda.synchronize()
        reset_counts()
        collectives.reset()
        got, t_sh = timed(lambda: item.call(placed))
        launches = counts()
        tally = collectives.tally()
    got = p13_whole(got)
    out = dict(collectives=tally, sharded_s=t_sh,
               launches_k1_to_k5b=list(launches))
    check(launches == item.launches,
          f"phase 13 {item.name}: launches {launches}")
    if rec is not None and rank == 0:
        compare = (cholqr1_vs_plain if item.kernel == "fused_cholqr1"
                   else eigh_vs_plain)
        out["kernel_calls_vs_plain"] = recorded_vs_plain(rec, compare)
        if item.kernel == "fused_cholqr1":
            check(all(c[2] <= P13_K1_DR for c in
                      out["kernel_calls_vs_plain"]),
                  f"phase 13 {item.name}: K1 {out['kernel_calls_vs_plain']}")
    if rank == 0:
        whole = item.place(ops, None)
        want, out["single_s"] = timed(lambda: item.call(whole))
        diffs = p13_compare(item.kinds, item.pick(got), item.pick(want))
        out["vs_single"] = diffs
        if bitwise:
            out["bitwise"] = p13_bitwise(got, want)
            check(out["bitwise"] or item.name in ("image_tiled", "video"),
                  f"phase 13 {item.name}: not bitwise the single call")
        else:
            with p13_perturbed():
                moved = item.call(whole)
            out["single_vs_perturbed"] = p13_compare(
                item.kinds, item.pick(moved), item.pick(want))
        floats = [t for t in p13_tensors(list(item.pick(got).values()))
                  if t.is_floating_point()]
        check(finite(*floats) and p13_within(diffs, item.tol),
              f"phase 13 {item.name}: {out}")
    say(f"  {item.name}: " + json.dumps(out))
    del ops, placed
    torch.cuda.empty_cache()
    return launches, out


def p13_spd(n, seed):
    """X X^T / n + I of a Gaussian X: SPD, eigenvalues in [1, ~5]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, n, device="cuda", generator=gen)
    with device.ieee_fp32():
        a = x @ x.T / n
    a.diagonal().add_(1.0)
    return 0.5 * (a + a.T)


def p13_planted_tucker(n, seed):
    """A rank-(64, 64, 64) n^3 tensor plus noise at 1e-3 of its norm."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = TUCKER_R
    signal = tucker_reconstruct(
        torch.randn(r, r, r, device="cuda", generator=gen),
        tuple(orthonormal(n, r, gen) for _ in range(3)))
    return planted(signal, gen)[0]


def p13_low_rank(n, rank, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with device.ieee_fp32():
        return torch.randn(n, rank, device="cuda", generator=gen) @ \
            torch.randn(rank, n, device="cuda", generator=gen) \
            / math.sqrt(rank)


def p13_rpca_operand():
    gen = torch.Generator(device="cuda").manual_seed(20)
    m = p13_low_rank(RPCA_N, RPCA_RANK, 21)
    spikes = torch.rand(RPCA_N, RPCA_N, device="cuda", generator=gen)
    return m + torch.where(spikes < RPCA_FRAC, 10.0 * torch.randn(
        RPCA_N, RPCA_N, device="cuda", generator=gen), 0.0)


def p13_completion_operand():
    gen = torch.Generator(device="cuda").manual_seed(22)
    a = p13_low_rank(COMP_N, COMP_RANK, 23)
    return a, torch.rand(COMP_N, COMP_N, device="cuda",
                         generator=gen) < COMP_FRAC


def p13_snapshots(n=None):
    """Phase 9's DMD snapshot stack (DMD_N = 65536 states unless given,
    x 401, 16 modes), f32."""
    n = n or DMD_N
    gen = torch.Generator(device="cuda").manual_seed(19)
    theta = torch.linspace(0.1, 2.5, DMD_PAIRS, device="cuda",
                           dtype=torch.float64)
    radius = torch.linspace(0.996, 0.9995, DMD_PAIRS, device="cuda",
                            dtype=torch.float64)
    mu = torch.polar(radius, theta)
    phi = torch.complex(*(torch.randn(n, DMD_PAIRS, device="cuda",
                                      generator=gen, dtype=torch.float64)
                          for _ in range(2)))
    t = torch.arange(DMD_M, device="cuda", dtype=torch.float64)
    return (2.0 * (phi @ (mu[:, None] ** t[None, :])).real).float()


def p13_fd(ops, buf_placed, batch=STREAM_BATCH):
    """FrequentDirections(1024, 128) over the host rows in ``ops``, its
    buffer laid out by ``buf_placed``; (sketch, top eigenvalues)."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.fd import (
        FrequentDirections,
    )

    fd = FrequentDirections(PCA_D, STREAM_L, device="cuda")
    fd._buf = buf_placed(fd._buf)
    for i in range(0, ops.shape[0], batch):
        fd.update(ops[i:i + batch])
    return fd.sketch(), fd.eigh_estimate(STREAM_K)[0]


def p13_items(full, world=1):
    """The slice's calls at phase 13's sizes: (a) ``full``, (b) cut where
    P13B_* says; ``world`` ranks split the batch."""
    def batch_stack():
        return torch.randn(BATCH, BATCH_SIDE, BATCH_SIDE, device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(40))

    def batched_item(name, method, mode, kernel=None):
        return P13Item(
            name, batch_stack,
            lambda a: rsvd_batched(a, k=K, p=P, mode=mode, method=method),
            lambda r: dict(sigma=r[1]), dict(sigma="sigma"),
            place=lambda a, meshes: distribute(
                a, meshes["batch"], (Shard(0),)) if meshes else a,
            kernel=kernel, tol=P13_BATCH_TOL, launches=launches_of(
                k3=BATCH // world if method == "eigh_pallas" else 0))

    def with_mesh(data, meshes):            # the codecs take mesh=
        return data, meshes and meshes["batch"]

    def tiled(args):
        im = image.Image(args[0]).compress_tiled(k=IMG_K, grid=IMG_GRID,
                                                 mesh=args[1])
        return (im.tile_factors.u, im.tile_factors.s, im.tile_factors.v,
                im.reconstruct())

    def video_frames():
        t, h, w = VIDEO
        pan = photo((h, w + 16 * t), seed=13)
        return np.stack([pan[:, 16 * i:16 * i + w] for i in range(t)])

    def fd_rows():
        x = pca_operand()
        return to_numpy(x if full else x[:P13B_FD_ROWS])

    def fd_buffer(rows, meshes):            # the buffer column-sharded
        if not meshes:
            return rows, lambda buf: buf
        return rows, lambda buf: distribute(buf, meshes["rows"],
                                            (Shard(1),))

    def rows_of(*sharded):                  # which operands are row-split
        return lambda ops, meshes: tuple(
            shard_rows(x, meshes["rows"]) if meshes and split else x
            for x, split in zip(ops, sharded))

    tucker_n = TUCKER_N if full else P13B_TUCKER_N
    return [
        batched_item("rsvd_batched_scan", "eigh", "scan"),
        batched_item("rsvd_batched_vmap", "eigh", "vmap"),
        batched_item("rsvd_batched_eigh_pallas", "eigh_pallas", "scan",
                     kernel="eigh_small"),
        batched_item("rsvd_batched_vmap_eigh_pallas", "eigh_pallas",
                     "vmap"),
        P13Item("image_tiled", lambda: photo((IMG_SIDE, IMG_SIDE), seed=1),
                tiled, lambda r: dict(sigma=r[1], rec=r[3]),
                dict(sigma="sigma", rec="value"), place=with_mesh,
                tol=P13_BATCH_TOL),
        P13Item("video", video_frames,
                lambda args: image.compress_video(args[0], k=VIDEO_K,
                                                  mesh=args[1]),
                lambda r: dict(sigma=r[1]), dict(sigma="sigma"),
                place=with_mesh, tol=P13_BATCH_TOL),
        P13Item("hutchinson", lambda: p13_spd(TR_N, 16), hutchinson,
                lambda r: dict(est=r[0], se=r[1]),
                dict(est="value", se="value")),
        P13Item("hutchpp", lambda: p13_spd(TR_N, 16), hutchpp,
                lambda r: dict(est=r), dict(est="value")),
        P13Item("logdet_psd", lambda: p13_spd(TR_N, 16), logdet_psd,
                lambda r: dict(est=r), dict(est="value")),
        P13Item("sketch_lstsq", lambda: ls_operand(18),
                lambda ops: sketch_lstsq(*ops), lambda r: dict(x=r),
                dict(x="value"), place=rows_of(True, False)),
        P13Item("tucker", lambda: p13_planted_tucker(tucker_n, 30),
                lambda a: tucker(a, (TUCKER_R,) * 3),
                lambda r: dict(core=torch.linalg.svdvals(
                    torch.as_tensor(r[0]).double().reshape(TUCKER_R, -1)),
                    u0=r[1][0], u1=r[1][1], u2=r[1][2]),
                dict(core="sigma", u0="span", u1="span", u2="span")),
        P13Item("rutv_cholqr1_fused", lambda: p12_operand()[0],
                lambda a: rutv(a, k=K, p=P, qr_method="cholqr1_fused"),
                lambda r: dict(sigma=torch.diagonal(r[1])),
                dict(sigma="sigma"), kernel="fused_cholqr1",
                launches=launches_of(k1=2 * Q + 2)),
        P13Item("complete_lowrank", p13_completion_operand,
                lambda ops: complete_lowrank(*ops, k=COMP_RANK,
                                             iters=COMP_ITERS),
                lambda r: dict(sigma=r[1]), dict(sigma="sigma"),
                place=rows_of(True, True)),
        P13Item("rpca", p13_rpca_operand,
                lambda a: rpca(a, k_max=2 * RPCA_RANK, iters=RPCA_ITERS),
                lambda r: dict(low=r[0]), dict(low="value")),
        # l = the planted rank: every pivot is set by the signal, none by
        # the noise floor
        P13Item("rlu", lambda: p13_low_rank(RLU_N, RLU_RANK, 17)
                + RLU_NOISE * torch.randn(
                    RLU_N, RLU_N, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        18)),
                lambda a: rlu(a, k=RLU_RANK - P, p=P, q=Q),
                lambda r: dict(perm_rows=r[0], perm_cols=r[1],
                               l_factor=r[2], u_factor=r[3]),
                dict(perm_rows="index", perm_cols="index",
                     l_factor="value", u_factor="value")),
        P13Item("nystrom_psd", lambda: rbf_kernel(NYS_POINTS, NYS_DIM,
                                                  NYS_H, seed=11),
                lambda a: nystrom_psd(a, k=NYS_K),
                lambda r: dict(lam=r[1]), dict(lam="sigma")),
        P13Item("frequent_directions_cols", fd_rows,
                lambda args: p13_fd(*args),
                lambda r: dict(sketch=r[0], lam=r[1]),
                dict(sketch="gram", lam="sigma"), place=fd_buffer),
        P13Item("deim_fit", p13_snapshots,
                lambda a: deim_fit(a, m=P13_DEIM_M),
                lambda r: dict(indices=r[1], proj=r[2]),
                dict(indices="index", proj="value")),
    ]


def p13_meshes(device_type="cuda"):
    """The 1-D meshes of phase 13, after small batched calls on a
    batch-sharded stack that take the solver libraries' and DTensor's
    first-use set-up out of the timings."""
    meshes = dict(rows=make_mesh(device=device_type),
                  batch=make_mesh(axis_names=("batch",), device=device_type))
    small = torch.randn(2 * meshes["batch"].size(), 128, 128,
                        device=device_type)
    for mode in ("scan", "vmap"):
        rsvd_batched(distribute(small, meshes["batch"], (Shard(0),)), k=8,
                     mode=mode)
    torch.cuda.synchronize()
    return meshes


def p13_one_rank_nccl(items=p13_items, run=p13_run):
    """Phase 13a (and 15a, with its ``items`` and ``run``): a one-rank
    NCCL group in this process: every call of the slice at full size on
    a sharded operand, bitwise the single call (the codecs, whose sharded
    runs factor with Householder QR, within P13_BATCH_TOL), K3 in the
    batched calls and K1 in rutv held to their plain versions."""
    initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    out, launches = {}, list(NONE)
    try:
        meshes = p13_meshes()
        for item in items(full=True):
            got, out[item.name] = run(item, meshes, 0, True, log)
            launches = [x + y for x, y in zip(launches, got)]
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches, out


def p13_rank(rank, world, port, results, items, run):
    """One of phase 13b's (or 15b's) four ranks sharing the card over
    gloo, running ``items(full=False)`` through ``run``."""
    torch.cuda.set_device(0)
    initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    say = log if rank == 0 else (lambda msg: None)
    out, launches = {}, list(NONE)
    meshes = p13_meshes()
    for item in items(full=False):
        got, out[item.name] = run(item, meshes, rank, False, say)
        launches = [x + y for x, y in zip(launches, got)]
    results.put((rank, out, launches))
    dist.destroy_process_group()


def p13_four_ranks(items=functools.partial(p13_items, world=P13_RANKS),
                   run=p13_run, tag="phase 13", timeout=P13_TIMEOUT,
                   cuts=dict(fd_rows_a_rank_stream=P13B_FD_ROWS,
                             tucker_side=P13B_TUCKER_N)):
    """Phase 13b (or 15b): four spawned ranks sharing the card over gloo;
    any rank's non-zero exit or the time limit fails the phase."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=p13_rank, args=(r, P13_RANKS, port, results,
                                                items, run))
             for r in range(P13_RANKS)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < P13_RANKS:
            check(time.monotonic() < deadline,
                  f"{tag} ranks gave {len(got)} results in {timeout} s")
            failed = [p.exitcode for p in procs if p.exitcode]
            check(not failed, f"{tag} rank exit codes {failed}")
            try:
                rank, out, launches = results.get(timeout=2.0)
            except queue.Empty:
                continue
            got[rank] = (out, launches)
    finally:
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(all(p.exitcode == 0 for p in procs),
          f"{tag} rank exit codes {[p.exitcode for p in procs]}")
    launches = [sum(got[r][1][i] for r in got) for i in range(len(NONE))]
    return launches, dict(rank0=got[0][0], ranks=P13_RANKS,
                          launches_all_ranks=launches, cuts=cuts)


def phase_sharded_extensions():
    """Phase 13: sharded operands beyond the driver.  Returns ((K1, K2,
    K3, K4, K5a, K5b) launches of its counted runs, summary)."""
    t0 = time.perf_counter()
    out = {}
    la, out["nccl_one_rank"] = p13_one_rank_nccl()
    out["a_s"] = time.perf_counter() - t0
    lb, out["gloo_four_ranks"] = p13_four_ranks()
    out["s"] = time.perf_counter() - t0
    launches = [x + y for x, y in zip(la, lb)]
    log(f"  phase 13: {out['s']:.1f} s, launches {launches}")
    return launches, out


# --- phase 14: item 13's edge cases through the kernels; the factor
# checkpoint on torch.distributed.checkpoint at a real size -------------

# (a) tests/test_edge_cases.py's bars, f64 there and f32 on the card: the
# f32 equivalents below are stated beside the JAX bar they stand for
P14_NORM_TOL = 1e-6       # |s_0 - ||a|| | / ||a||; JAX 1e-10 (f64)
P14_CONST_TOL = 1e-6      # constant matrix: s_0 relative; JAX 1e-9 (f64)
# constant matrix, s[1:] / s_0 (JAX 1e-9, the Jacobi engine in f64): the
# Gram route rounds G's eigenvalues by ~eps lambda_1, so sigma by
# sqrt(eps) sigma_1 = 3.5e-4 sigma_1 in f32
P14_CONST_TAIL = 2e-3
P14_SIGMA_TOL = 1e-5      # rsvd at l = min(m, n): rtol on sigma; JAX 1e-6
P14_QR_TOL = 1e-5         # one-column K1/K2: ||QR - a|| / ||a||, | ||q|| - 1 |
# each launch against its plain version on the same input: K1 and K2 to
# phase 2's bounds, K3 bitwise at even n (else lambda to K3_LAM_TOL), K4
# to K4_Y_TOL, all relative to the plain output's largest entry
P14_PLAIN_TOL = {"fused_cholqr1": Q_TOL, "polar_qr_fused": K2_Q_TOL,
                 "eigh_small": K3_LAM_TOL, "fused_sketch_matmul": K4_Y_TOL}
P14_ROUTE = dict(sketch="fused", qr_method="cholqr1_fused",
                 method="eigh_pallas")
# (b) rsvd of a 1,048,576 x 1024 f32 operand (4 GiB), k 256, p 16: U is
# 1 GiB; four gloo ranks sharing the card hold 262,144 rows each
P14_ROWS, P14_COLS, P14_K, P14_P = 1 << 20, 1024, 256, 16
P14_RANKS = 4
P14_TIMEOUT = 300.0       # s: the four ranks' whole run


@contextlib.contextmanager
def p14_recorded():
    """K1-K4's wrappers, each call recorded (its input, its output)."""
    recs = {w: Recorder(getattr(kernels, w)) for w in WRAPPERS[:4]}
    with mock.patch.multiple(kernels, **recs):
        yield recs


def p14_vs_plain(name, x, args, kwargs, out):
    """One recorded launch of ``name`` against its plain version on the
    same input: a non-finite plain result must be non-finite from the
    kernel (K1's NaN contract); else bitwise, or within
    P14_PLAIN_TOL[name] of the plain output's largest entry (K3 at odd n
    on its eigenvalues only, as phase 2 holds it)."""
    plain = getattr(kernels, f"{name}_reference")(x, *args, **kwargs)
    outs = out if isinstance(out, tuple) else (out,)
    refs = plain if isinstance(plain, tuple) else (plain,)
    what = f"phase 14 {name} {tuple(x.shape)}"
    if not finite(*refs):
        check(not finite(*outs), f"{what}: finite where the plain version "
              f"is not")
        return dict(kernel=name, shape=list(x.shape), nan_contract=True)
    check(finite(*outs), f"{what}: non-finite where the plain version is "
          f"finite")
    bitwise = all(torch.equal(o, r) for o, r in zip(outs, refs))
    held = outs[:1] if name == "eigh_small" and x.shape[0] % 2 else outs
    err = max(float((o - r).abs().max()) / (float(r.abs().max()) or 1.0)
              for o, r in zip(held, refs))
    check(bitwise or (err <= P14_PLAIN_TOL[name]
                      and not (name == "eigh_small" and x.shape[0] % 2 == 0)),
          f"{what}: bitwise {bitwise}, max rel err {err}")
    return dict(kernel=name, shape=list(x.shape), bitwise=bitwise,
                max_rel_err=err)


def p14_sigma_err(s, a64):
    """max |s - s_numpy| / s_numpy over the nonzero numpy sigma."""
    s_np = np.linalg.svd(a64, compute_uv=False)
    return float(np.max(np.abs(to_numpy(s).astype(np.float64) - s_np)
                        / s_np))


def p14_edge_items(gen):
    """(label, call, check) of phase 14a: ``check(result, a64)`` returns
    the case's error, or raises."""
    def card(shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    def norm_case(a):
        def held(out, a64):
            err = abs(float(out[1][0]) - np.linalg.norm(a64)) \
                / np.linalg.norm(a64)
            check(err <= P14_NORM_TOL and finite(*out),
                  f"phase 14 svd {tuple(a.shape)}: s_0 off by {err}")
            return err
        return held

    def zero_case(out, a64):
        check(bool((out[1] == 0).all()) and finite(*out),
              f"phase 14 svd zero: s {to_numpy(out[1])}")
        return 0.0

    def const_case(out, a64):
        s = to_numpy(out[1]).astype(np.float64)
        err = abs(s[0] - 7.0 * math.sqrt(16 * 12)) / (7.0 * math.sqrt(192))
        tail = float(np.max(s[1:]) / s[0])
        check(err <= P14_CONST_TOL and tail <= P14_CONST_TAIL
              and finite(*out),
              f"phase 14 svd constant: s_0 off by {err}, tail {tail}")
        return max(err, tail)

    def qr_case(out, a64):
        q, r = (to_numpy(x).astype(np.float64) for x in out)
        if not np.isfinite(q).all() or not np.isfinite(r).all():
            return None                   # the NaN contract, held above
        err = max(np.linalg.norm(q @ r - a64) / (np.linalg.norm(a64) or 1.0),
                  abs(np.linalg.norm(q) - 1.0) if a64.any() else 0.0)
        check(err <= P14_QR_TOL, f"phase 14 qr {a64.shape}: err {err}")
        return err

    def rsvd_case(l):
        def held(out, a64):
            check(out[1].shape == (l,) and finite(*out),
                  f"phase 14 rsvd {a64.shape}: s {out[1].shape}")
            err = p14_sigma_err(out[1], a64)
            check(err <= P14_SIGMA_TOL,
                  f"phase 14 rsvd {a64.shape}: sigma rtol {err}")
            return err
        return held

    one = torch.tensor([[3.0]], device="cuda")
    col, row = card((20, 1)), card((1, 15))
    zero = torch.zeros(10, 6, device="cuda")
    const = torch.full((16, 12), 7.0, device="cuda")
    panel, zpanel = card((30, 1)), torch.zeros(12, 4, device="cuda")
    a108, a129 = card((10, 8)), card((12, 9))
    svd_pal = functools.partial(linalg_svd, method="eigh_pallas")
    return [
        ("svd 1x1", one, lambda: svd_pal(one), norm_case(one)),
        ("svd 20x1", col, lambda: svd_pal(col), norm_case(col)),
        ("svd 1x15", row, lambda: svd_pal(row), norm_case(row)),
        ("svd zero 10x6", zero, lambda: svd_pal(zero), zero_case),
        ("svd constant 16x12", const, lambda: svd_pal(const), const_case),
        ("K1 30x1", panel, lambda: kernels.fused_cholqr1(panel), qr_case),
        ("K1 zero 12x4", zpanel, lambda: kernels.fused_cholqr1(zpanel),
         qr_case),
        ("K2 30x1", panel, lambda: kernels.polar_qr_fused(panel), qr_case),
        ("K2 zero 12x4", zpanel, lambda: kernels.polar_qr_fused(zpanel),
         qr_case),
        ("rsvd 10x8 k=0 p=50 q=1 sketch='fused'", a108,
         lambda: rsvd(a108, k=0, p=50, q=1, sketch="fused"), rsvd_case(8)),
        ("rsvd 10x8 k=0 p=50 q=1 K4+K1+K3", a108,
         lambda: rsvd(a108, k=0, p=50, q=1, **P14_ROUTE), rsvd_case(8)),
        ("rsvd 12x9 k=9 p=4 q=2 K4+K1+K3", a129,
         lambda: rsvd(a129, k=9, p=4, q=2, **P14_ROUTE), rsvd_case(9)),
    ]


def p14_edge_cases():
    """Phase 14a: every case with its launches counted and each launch
    held to its plain version.  Returns ((K1..K5b) launches, summary)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    out, launches = {}, list(NONE)
    for label, a, call, held in p14_edge_items(gen):
        reset_counts()
        with p14_recorded() as recs:
            res = call()
            torch.cuda.synchronize()
        got = counts()
        vs_plain = [p14_vs_plain(name, *c) for name, r in recs.items()
                    for c in r.calls]
        check(len(vs_plain) == sum(got[:4]) and any(got[:4]),
              f"phase 14 {label}: launches {got}, {len(vs_plain)} recorded")
        err = held(res, to_numpy(a).astype(np.float64))
        out[label] = dict(err=err, launches_k1_to_k5b=list(got),
                          vs_plain=vs_plain)
        launches = [x + y for x, y in zip(launches, got)]
        log(f"  {label}: " + json.dumps(out[label]))
    return launches, out


def p14_rank(rank, world, port, tmp, results):
    """One of phase 14b's four ranks sharing the card over gloo: its
    262,144 rows of U from ``u.npy`` as a row-sharded DTensor, saved
    together, loaded back on the (4,) mesh; the one-process checkpoint
    resharded onto the mesh; rank 0 loads the four ranks' U whole."""
    from torch.distributed.tensor import DTensor

    torch.cuda.set_device(0)
    initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    mesh = make_mesh(device="cuda")
    whole = np.load(os.path.join(tmp, "u.npy"), mmap_mode="r")
    rows = whole.shape[0] // world
    mine = torch.from_numpy(np.array(
        whole[rank * rows:(rank + 1) * rows])).cuda()
    s, v = (torch.from_numpy(np.load(os.path.join(tmp, f"{x}.npy"))).cuda()
            for x in ("s", "v"))
    u = DTensor.from_local(mine, mesh, (Shard(0),), run_check=False,
                           shape=whole.shape, stride=(whole.shape[1], 1))
    path, out = os.path.join(tmp, "four"), {}
    dist.barrier()
    t0 = time.perf_counter()
    checkpoint.save_factors_dcp(path, u, s, v, meta={"ranks": world})
    out["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    u2, s2, v2, meta = checkpoint.load_factors_dcp(path, mesh=mesh)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["rows_bitwise"] = (torch.equal(u2.to_local(), mine)
                           and torch.equal(s2, s) and torch.equal(v2, v)
                           and meta == {"ranks": world})
    u3 = checkpoint.load_factors_dcp(os.path.join(tmp, "one"), mesh=mesh)[0]
    out["resharded_bitwise"] = torch.equal(u3.to_local(), mine)
    del u2, u3
    if rank == 0:
        t0 = time.perf_counter()
        uw = checkpoint.load_factors_dcp(path)[0]
        torch.cuda.synchronize()
        out["plain_load_s"] = time.perf_counter() - t0
        out["plain_bitwise"] = torch.equal(
            uw, torch.from_numpy(np.array(whole)).cuda())
        del uw
    dist.barrier()
    results.put((rank, out))
    dist.destroy_process_group()


def p14_four_ranks(tmp):
    """Phase 14b's four spawned ranks; any rank's non-zero exit or the
    time limit fails the phase."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=p14_rank,
                         args=(r, P14_RANKS, port, tmp, results))
             for r in range(P14_RANKS)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + P14_TIMEOUT
    try:
        while len(got) < P14_RANKS:
            check(time.monotonic() < deadline,
                  f"phase 14 ranks gave {len(got)} results in {P14_TIMEOUT} s")
            failed = [p.exitcode for p in procs if p.exitcode]
            check(not failed, f"phase 14 rank exit codes {failed}")
            try:
                rank, out = results.get(timeout=2.0)
            except queue.Empty:
                continue
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(all(p.exitcode == 0 for p in procs),
          f"phase 14 rank exit codes {[p.exitcode for p in procs]}")
    return got


def p14_checkpoint():
    """Phase 14b: ``rsvd`` of the 4 GiB operand, its factors through
    ``save_factors_dcp``/``load_factors_dcp`` in this process and on four
    gloo ranks, every load bitwise; the directories removed at the end.
    Returns the summary (GB/s = the factors' bytes over the host clock's
    seconds of one call)."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(14)
    a = torch.randn(P14_ROWS, P14_COLS, device="cuda", generator=gen)
    reset_counts()
    t0 = time.perf_counter()
    u, s, v = rsvd(a, k=P14_K, p=P14_P, method="eigh")
    torch.cuda.synchronize()
    out["rsvd_s"] = time.perf_counter() - t0
    check(counts() == NONE and u.shape == (P14_ROWS, P14_K)
          and finite(u, s, v), f"phase 14 rsvd: {u.shape}, {counts()}")
    del a
    torch.cuda.empty_cache()
    gb = sum(x.numel() * x.element_size() for x in (u, s, v)) / 1e9
    out["factor_gb"] = gb
    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "one")
        meta = {"k": P14_K, "p": P14_P, "rows": P14_ROWS}
        t0 = time.perf_counter()
        checkpoint.save_factors_dcp(path, u, s, v, meta=meta)
        out["one_save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        u2, s2, v2, meta2 = checkpoint.load_factors_dcp(path)
        torch.cuda.synchronize()
        out["one_load_s"] = time.perf_counter() - t0
        out["one_bitwise"] = (torch.equal(u2, u) and torch.equal(s2, s)
                              and torch.equal(v2, v) and meta2 == meta
                              and u2.device.type == "cuda")
        out["one_save_gb_s"] = gb / out["one_save_s"]
        out["one_load_gb_s"] = gb / out["one_load_s"]
        out["files"] = sorted(os.listdir(path))
        del u2, s2, v2
        log("  one process: " + json.dumps(out))
        check(out["one_bitwise"], "phase 14 one-process DCP round trip")
        for name, x in (("u", u), ("s", s), ("v", v)):
            np.save(os.path.join(tmp, f"{name}.npy"), to_numpy(x))
        del u, s, v
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = p14_four_ranks(tmp)
        r0 = ranks[0]
        four = dict(
            wall_s=time.perf_counter() - t0,
            rows_bitwise=[ranks[r]["rows_bitwise"] for r in sorted(ranks)],
            resharded_bitwise=[ranks[r]["resharded_bitwise"]
                               for r in sorted(ranks)],
            plain_bitwise=r0["plain_bitwise"],
            save_s=max(r["save_s"] for r in ranks.values()),
            load_s=max(r["load_s"] for r in ranks.values()),
            plain_load_s=r0["plain_load_s"],
            files=sorted(os.listdir(os.path.join(tmp, "four"))))
        four["save_gb_s"] = gb / four["save_s"]
        four["load_gb_s"] = gb / four["load_s"]
        four["plain_load_gb_s"] = gb / four["plain_load_s"]
        out["four_ranks"] = four
        log("  four gloo ranks: " + json.dumps(four))
        check(all(four["rows_bitwise"]) and all(four["resharded_bitwise"])
              and four["plain_bitwise"],
              f"phase 14 four-rank DCP round trips: {four}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_edge_and_checkpoint():
    """Phase 14.  Returns ((K1, K2, K3, K4, K5a, K5b) launches of its
    counted runs, summary)."""
    t0 = time.perf_counter()
    phase("phase 14a: item 13's edge cases through K1-K4")
    launches, out = p14_edge_cases()
    out = {"edge_cases": out, "launches_k1_to_k5b": launches}
    phase("phase 14b: the factor checkpoint on torch.distributed.checkpoint "
          f"({P14_ROWS} x {P14_COLS} f32, k {P14_K})")
    out["dcp"] = p14_checkpoint()
    out["s"] = time.perf_counter() - t0
    log(f"  phase 14: {out['s']:.1f} s, launches {launches}")
    return launches, out


# --- phase 15: row-sharded operands through the public API beyond rsvd ---

P15_TIMEOUT = 420.0       # s: the four ranks' whole run
P15_TOL = 1e-4            # (b): of the largest quantity, as phase 13's
# (b)'s iterative calls (CP's 25 sweeps, the sparse sketch's LSQR, PCG):
# the single call itself moves by up to ~1e-4 under a 1e-7 change of
# its draws there
P15_ITER_TOL = 1e-3
P15_CS_TOL = 1e-4         # (a) CountSketch (atomics): x relative, one rank
# (b) a quantity may also sit within this many times the single call's
# own shift under the perturbed draws (a solve whose conditioning
# amplifies roundoff past the fixed bar moves that far on one card too)
P15_SHIFT_FACTOR = 10.0
# (b) runs every function at these cut sizes (the four ranks share the
# card and gloo's host hops; PERF.md lists them beside (a)'s sizes)
P15B = dict(side=2048, kry=4096, rbf=4096, ls=(65536, 256),
            cca_rows=65536, dmd=16384, pca=(32768, 256), kpca=4096,
            tucker=256, tt=64, cp=128)
# every float draw of the slice's modules, for (b)'s perturbed call
P15_DRAWS = (("rsvd.driver", "generate_omega"), ("rsvd.driver", "gaussian"),
             ("rsvd.diagnostics", "_probes"),
             ("rsvd.interp", "gumbel_uniforms"),
             ("rsvd.lstsq", "sketch_matrix"),
             ("rsvd._modewise", "generate_omega"),
             ("rsvd.tucker", "generate_omega"),
             ("rsvd.tt", "generate_omega"), ("rsvd.cp", "generate_omega"),
             ("apps.kpca", "_rff_draws"))


def p15_mod(name):
    return importlib.import_module(
        "rsvd_kamaneh_raganato_terrana_tpu_torch." + name)


class P15Item(P13Item):
    """A phase-13 item with the kernels its sharded call must launch
    (each at least once, every other kernel never) and ``exact``: one
    rank's call bitwise the single call (False: CountSketch's atomics,
    held to P15_CS_TOL)."""

    def __init__(self, name, build, call, pick, kinds, place=None,
                 kernels_run=(), exact=True, tol=P15_TOL):
        super().__init__(name, build, call, pick, kinds, place=place,
                         tol=tol)
        self.kernels_run, self.exact = kernels_run, exact


def p15_polar_vs_plain(y, args, kwargs, out):
    """(shape, max |dQ|, R's asymmetry and the plain version's) of one
    recorded K2 call against its plain version, held to phase 2's
    bounds for a panel of any conditioning: max |dQ| <= K2_Q_TOL, R
    symmetric to max(K2_SYM_TOL, 4x the plain version's asymmetry), R's
    column norms Y's to K2_NORM_TOL."""
    q, r = out
    q0, r0 = kernels.polar_qr_fused_reference(y, *args, **kwargs)
    dq = float((q - q0).abs().max())
    sym = float((r - r.T).abs().max() / r.abs().max())
    sym0 = float((r0 - r0.T).abs().max() / r0.abs().max())
    with device.ieee_fp32():
        dnorm = float((torch.linalg.norm(r, dim=0)
                       / torch.linalg.norm(y, dim=0) - 1.0).abs().max())
    check(finite(q, r) and dq <= K2_Q_TOL
          and sym <= max(K2_SYM_TOL, 4 * sym0) and dnorm <= K2_NORM_TOL,
          f"K2 {tuple(y.shape)} in phase 15: dQ={dq} R asymmetry {sym} "
          f"(plain {sym0}) column norms {dnorm}")
    return tuple(y.shape), dq, sym, sym0


# each recorded launch of phase 15 against its plain version, as phase 2
# holds the kernel: K1 by max |dQ| and max |dR| / max |R|, K2 as above,
# K3 bitwise at even n
P15_VS_PLAIN = {"fused_cholqr1": cholqr1_vs_plain,
                "polar_qr_fused": p15_polar_vs_plain,
                "eigh_small": eigh_vs_plain}


def p15_geometric(n, rank, ratio, seed):
    """Phase 6's adaptive operand: rank ``rank``, sigma_i = ratio^i."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = orthonormal(n, rank, gen)
    v = orthonormal(n, rank, gen)
    s = ratio ** torch.arange(rank, device="cuda", dtype=torch.float32)
    with device.ieee_fp32():
        return (u * s) @ v.T


def p15_decaying(n, ratio, seed):
    """U diag(ratio^i) V^T, n x n f32 on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = orthonormal(n, n, gen)
    v = orthonormal(n, n, gen)
    s = ratio ** torch.arange(n, device="cuda", dtype=torch.float32)
    with device.ieee_fp32():
        return (u * s) @ v.T


def p15_noisy_low_rank(n, seed):
    """Rank 64 plus 1e-4 noise: every pivot of a 64-column sketch is set
    by the signal (phase 13's rlu operand)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    return p13_low_rank(n, RLU_RANK, seed) + RLU_NOISE * torch.randn(
        n, n, device="cuda", generator=gen)


def p15_spd_b(n, seed):
    """Phase 9's B of reigh_generalized: diag(1 + U(0, 1)) + 0.02 G G^T."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(n, 5, device="cuda", generator=gen)
    with device.ieee_fp32():
        return torch.diag(1.0 + torch.rand(n, device="cuda", generator=gen)) \
            + 0.02 * g @ g.T


def p15_views(rows, seed):
    """Phase 9's CCA views: 8 shared directions, 512 and 384 features."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn(rows, CCA_SHARED, device="cuda", generator=gen)
    views = []
    for d in (CCA_P, CCA_Q):
        with device.ieee_fp32():
            w = z @ torch.randn(CCA_SHARED, d, device="cuda", generator=gen)
        views.append(w + torch.randn(rows, d, device="cuda", generator=gen))
    return tuple(views)


def p15_tt_operand(n, seed):
    """Phase 10's TT operand at side n: TT rank 16 plus 1e-3 noise."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cores, r_prev = [], 1
    for _ in range(3):
        cores.append(orthonormal(r_prev * n, TT_R, gen).reshape(
            r_prev, n, TT_R))
        r_prev = TT_R
    cores.append(torch.randn(TT_R, n, 1, device="cuda", generator=gen))
    return planted(tt_reconstruct(cores), gen)[0]


def p15_cp_operand(n, seed):
    """Phase 10's CP operand at side n: CP rank 16 plus 1e-3 noise."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fs = [torch.randn(n, CP_R, device="cuda", generator=gen)
          for _ in range(3)]
    fs = [f / torch.linalg.vector_norm(f, dim=0) for f in fs]
    w = torch.sort(1.0 + 2.0 * torch.rand(CP_R, device="cuda",
                                          generator=gen), descending=True)[0]
    return planted(cp_reconstruct(w, fs), gen)[0]


def p15_rows(*split):
    """``place`` for several operands, those marked True row-sharded."""
    return lambda ops, meshes: tuple(
        shard_rows(x, meshes["rows"]) if meshes and s else x
        for x, s in zip(ops, split))


def p15_core_sigma(cores):
    """Each TT core's singular values (of its (r n) x r' unfolding),
    invariant to the cores' signs."""
    return torch.cat([torch.linalg.svdvals(
        torch.as_tensor(c).double().reshape(-1, c.shape[-1]))
        for c in cores])


def p15_items(full):
    """Phase 15's calls: (a) ``full`` at the single-card phases' sizes
    (PERF.md section 4), (b) at P15B's cuts."""
    side = M if full else P15B["side"]
    kry = KRY_N if full else P15B["kry"]
    rbf = NYS_POINTS if full else P15B["rbf"]
    ls_rows, ls_cols = (LS_ROWS, LS_COLS) if full else P15B["ls"]
    pca_rows, pca_d = (PCA_ROWS, PCA_D) if full else P15B["pca"]
    kpca_n = KPCA_N if full else P15B["kpca"]
    interp, diag, nys = (p15_mod("rsvd." + m) for m in
                         ("interp", "diagnostics", "nystrom"))
    est = estimators
    sig = dict(sigma="sigma")

    def spectral_a():
        return (p15_decaying(side, 0.97, 50),)

    def warm_ops():                    # A and a previous call's U
        a = p15_decaying(side, 0.97, 50)
        return a, rsvd(a, k=K + P, method="eigh")[0]

    def rbf_a():
        return (rbf_kernel(rbf, NYS_DIM, NYS_H, seed=11),)

    def kry_a():
        return (krylov_operand(kry, 5),)

    def diag_ops():
        a = krylov_operand(kry, 5)
        gen = torch.Generator(device="cuda").manual_seed(52)
        q = orthonormal(kry, K + P, gen)
        u, s, v = rsvd(a, k=K, method="eigh")
        return a, q, u, s, v

    def ls_ops():
        a, b = ls_operand(18, ls_rows, ls_cols)
        return a, b

    def ls_damp():
        return LS_DAMP_REL * float(ls_cols)

    def pca_x():
        return (pca_operand(0, pca_rows, pca_d),)

    def kpca_x():
        gen = torch.Generator(device="cuda").manual_seed(21)
        return kpca_points(kpca_n, gen), kpca_points(KPCA_NEW // 4, gen)

    def kpca_call(ops):
        kp = kpca.KernelPCA(KPCA_K, solver="randomized").fit(ops[0])
        return (kp.eigenvalues_, kp.alphas_, kp.scores_,
                kp.transform(ops[1]))

    def tucker_t():
        return (p13_planted_tucker(TUCKER_N if full else P15B["tucker"],
                                   30),)

    def tt_t():
        return (p15_tt_operand(TT_N if full else P15B["tt"], 31),)

    def cp_t():
        return (p15_cp_operand(CP_N if full else P15B["cp"], 32),)

    def pca_call(**kw):
        def call(ops):
            p = pca.PCA(ops[0], **kw)
            return p.getS(), p.getV(), p.scores()
        return call

    def est_call(cls):
        def call(ops):
            e = cls(n_components=K, p=EST_PCA_P, q=EST_PCA_Q)
            z = e.fit_transform(ops[0])
            return (z, e.components_, e.singular_values_,
                    e.explained_variance_ratio_)
        return call

    def tucker_sigma(r):
        core = torch.as_tensor(r[0]).double()
        return torch.linalg.svdvals(core.reshape(core.shape[0], -1))

    return [
        P15Item("rsvd_adaptive",
                lambda: (p15_geometric(side, min(512, side // 2),
                                       ADAPTIVE_RATIO, 54),),
                lambda ops: rsvd_adaptive(ops[0], tol=ADAPTIVE_TOL),
                lambda r: dict(sigma=r[1], k=torch.tensor(r[3])),
                dict(sigma="sigma", k="index"), place=p15_rows(True)),
        P15Item("rsvd_onepass_eigh_pallas", spectral_a,
                lambda ops: rsvd_onepass(ops[0], k=K, method="eigh_pallas"),
                lambda r: dict(sigma=r[1]), sig, place=p15_rows(True),
                kernels_run=("eigh_small",)),
        P15Item("rsvd_warm_cholqr1_fused",
                warm_ops,
                lambda ops: rsvd_warm(ops[0], ops[1], k=K,
                                      qr_method="cholqr1_fused"),
                lambda r: dict(sigma=r[1]), sig, place=p15_rows(True, True),
                kernels_run=("fused_cholqr1",)),
        P15Item("column_id", lambda: (p15_noisy_low_rank(side, 17),),
                lambda ops: interp.column_id(ops[0], k=RLU_RANK - P, p=P),
                lambda r: dict(cols=r[0], x=r[1]),
                dict(cols="index", x="value"), place=p15_rows(True)),
        P15Item("row_id", lambda: (p15_noisy_low_rank(side, 17),),
                lambda ops: interp.row_id(ops[0], k=RLU_RANK - P, p=P),
                lambda r: dict(rows=r[0], x=r[1]),
                dict(rows="index", x="value"), place=p15_rows(True)),
        P15Item("cur", lambda: (p15_noisy_low_rank(side, 17),),
                lambda ops: interp.cur(ops[0], k=RLU_RANK - P, p=P),
                lambda r: dict(cols=r[0], rows=r[1], u=r[2]),
                dict(cols="index", rows="index", u="value"),
                place=p15_rows(True)),
        P15Item("leverage_sample", lambda: (p15_noisy_low_rank(side, 17),),
                lambda ops: interp.leverage_sample(ops[0], k=K,
                                                   num_samples=4 * K),
                lambda r: dict(scores=r[1]), dict(scores="value"),
                place=p15_rows(True)),
        P15Item("rsvd_krylov_k1_k3", kry_a,
                lambda ops: rsvd_krylov(ops[0], k=K, p=P, q=Q,
                                        qr_method="cholqr1_fused",
                                        method="eigh_pallas"),
                lambda r: dict(sigma=r[1]), sig, place=p15_rows(True),
                kernels_run=("fused_cholqr1", "eigh_small")),
        P15Item("rsvd_krylov_k2", kry_a,
                lambda ops: rsvd_krylov(ops[0], k=K, p=P, q=Q,
                                        qr_method="polar_fused"),
                lambda r: dict(sigma=r[1]), sig, place=p15_rows(True),
                kernels_run=("polar_qr_fused",)),
        P15Item("diagnostics", diag_ops,
                lambda ops: (
                    range_error_estimate(ops[0], ops[1]),
                    factorization_error_estimate(ops[0], *ops[2:]),
                    spectral_norm_estimate(ops[0]),
                    stable_rank_estimate(ops[0])),
                lambda r: dict(range=r[0], fact=r[1], norm=r[2], srank=r[3]),
                dict(range="value", fact="value", norm="value",
                     srank="value"),
                place=p15_rows(True, True, True, False, False)),
        P15Item("reigh", rbf_a, lambda ops: reigh(ops[0], k=REIGH_K),
                lambda r: dict(w=r[0], u=r[1][:, :REIGH_TOP]),
                dict(w="sigma", u="span"), place=p15_rows(True)),
        P15Item("reigh_generalized",
                lambda: rbf_a() + (p15_spd_b(rbf, 12),),
                lambda ops: reigh_generalized(ops[0], ops[1], k=GEN_K),
                lambda r: dict(w=r[0]), dict(w="sigma"),
                place=p15_rows(True, True)),
        P15Item("nystrom_pcg",
                lambda: rbf_a() + (torch.randn(
                    rbf, 2, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        13)),),
                lambda ops: nystrom_pcg(ops[0], ops[1], 1e-2, rank=PCG_RANK,
                                        iters=PCG_ITERS),
                lambda r: dict(x=r), dict(x="value"),
                place=p15_rows(True, False), tol=P15_ITER_TOL),
        P15Item("sketch_lstsq_sparse", ls_ops,
                lambda ops: sketch_lstsq(*ops, kind="sparse"),
                lambda r: dict(x=r), dict(x="value"),
                place=p15_rows(True, False), exact=False,
                tol=P15_ITER_TOL),
        P15Item("sketch_lstsq_damped", ls_ops,
                lambda ops: sketch_lstsq(*ops, damp=ls_damp()),
                lambda r: dict(x=r), dict(x="value"),
                place=p15_rows(True, False), tol=P15_ITER_TOL),
        P15Item("sketch_minnorm",
                lambda: (ls_ops()[0].T.contiguous(),
                         torch.randn(ls_cols, LS_RHS, device="cuda",
                                     generator=torch.Generator(
                                         device="cuda").manual_seed(53))),
                lambda ops: sketch_minnorm(*ops),
                lambda r: dict(x=r), dict(x="value"),
                place=p15_rows(True, False), tol=P15_ITER_TOL),
        P15Item("lstsq_residual",
                lambda: ls_ops() + (torch.ones(ls_cols, LS_RHS,
                                               device="cuda"),),
                lambda ops: lstsq_residual(ops[0], ops[2], ops[1]),
                lambda r: dict(r=r), dict(r="value"),
                place=p15_rows(True, False, False)),
        P15Item("cca", lambda: p15_views(CCA_ROWS if full
                                         else P15B["cca_rows"], 18),
                lambda ops: cca(*ops, k=CCA_K),
                lambda r: dict(corr=r[0]), dict(corr="sigma"),
                place=p15_rows(True, True)),
        P15Item("dmd", lambda: (p13_snapshots(DMD_N if full
                                              else P15B["dmd"]),),
                lambda ops: dmd(ops[0], k=2 * DMD_PAIRS),
                lambda r: dict(sv=r[4], eig=torch.as_tensor(
                    np.sort(np.abs(r[1])))),
                dict(sv="sigma", eig="sigma"), place=p15_rows(True)),
        P15Item("pca_eigh", pca_x, pca_call(method="eigh"),
                lambda r: dict(s=r[0]), dict(s="sigma"),
                place=p15_rows(True)),
        P15Item("pca_use_rsvd", pca_x,
                pca_call(use_rsvd=True, rank=PCA_RANK),
                lambda r: dict(s=r[0], v=r[1][:, :16]),
                dict(s="sigma", v="span"), place=p15_rows(True)),
        P15Item("randomized_pca", pca_x, est_call(est.RandomizedPCA),
                lambda r: dict(s=r[2], ratio=r[3]),
                dict(s="sigma", ratio="value"), place=p15_rows(True)),
        P15Item("randomized_svd", pca_x, est_call(est.RandomizedSVD),
                lambda r: dict(s=r[2]), dict(s="sigma"),
                place=p15_rows(True)),
        P15Item("kernel_pca", kpca_x, kpca_call,
                lambda r: dict(lam=r[0]), dict(lam="sigma"),
                place=p15_rows(True, False)),
        P15Item("rff_features", lambda: kpca_x()[:1],
                lambda ops: kpca.rff_features(ops[0], n_features=512),
                lambda r: dict(z=r), dict(z="value"), place=p15_rows(True)),
        P15Item("nystrom_features",
                lambda: (lambda x, y: (x, y[:256]))(*kpca_x()),
                lambda ops: kpca.nystrom_features(*ops),
                lambda r: dict(z=r), dict(z="gram"),
                place=p15_rows(True, False)),
        P15Item("tucker_adaptive", tucker_t,
                lambda ops: tucker_adaptive(ops[0], tol=TUCKER_TOL,
                                            rank_cap=(TUCKER_CAP,) * 3),
                lambda r: dict(core=tucker_sigma(r), ranks=torch.tensor(
                    r[2]), u0=r[1][0]),
                dict(core="sigma", ranks="index", u0="span"),
                place=p15_rows(True)),
        P15Item("tt_decompose", tt_t,
                lambda ops: tt_decompose(ops[0], (TT_R,) * 3),
                lambda r: dict(cores=p15_core_sigma(r)), dict(cores="sigma"),
                place=p15_rows(True)),
        P15Item("tt_adaptive", tt_t,
                lambda ops: tt_adaptive(ops[0], tol=TT_TOL, rank_cap=TT_CAP),
                lambda r: dict(ranks=torch.tensor(r[1])),
                dict(ranks="index"), place=p15_rows(True)),
        P15Item("cp_als", cp_t,
                lambda ops: cp_decompose(ops[0], CP_R, iters=CP_SWEEPS),
                lambda r: dict(w=r[0]), dict(w="sigma"),
                place=p15_rows(True), tol=P15_ITER_TOL),
        P15Item("cp_rand", cp_t,
                lambda ops: cp_decompose(ops[0], CP_R, iters=CP_SWEEPS,
                                         method="rand"),
                lambda r: dict(w=r[0]), dict(w="sigma"),
                place=p15_rows(True), tol=P15_ITER_TOL),
    ]


def p15_run(item, meshes, rank, one_rank, say, draws=P15_DRAWS,
            tag="phase 15", vs_plain=P15_VS_PLAIN, jitter=False):
    """One item: the single call on rank 0 (the reference, and a warm
    start), the sharded call (its collectives, launches, and ms; every
    K1-K4 launch recorded and held to its plain version by ``vs_plain``),
    the single call again (ms); on one rank the sharded call bitwise the
    single one (an item not ``exact``: within P15_CS_TOL, beside the
    single call's own shift under perturbed ``draws`` and, with
    ``jitter``, float inputs), on four within ``item.tol`` beside that
    shift.  Returns (launches, summary)."""
    ops = item.build()
    placed = item.place(ops, meshes)
    whole = item.place(ops, None)
    want = item.call(whole) if rank == 0 else None
    torch.cuda.synchronize()
    with p14_recorded() as recs:
        reset_counts()
        collectives.reset()
        got, t_sh = timed(lambda: item.call(placed))
        launches = counts()
        tally = collectives.tally()
    got = p13_whole(got)
    out = dict(sharded_ms=1e3 * t_sh, collectives=tally,
               launches_k1_to_k5b=list(launches))
    named = {w: launches[WRAPPERS.index(w)] for w in WRAPPERS[:4]}
    check(all(n >= 1 for w, n in named.items() if w in item.kernels_run)
          and all(n == 0 for w, n in named.items()
                  if w not in item.kernels_run) and launches[4:] == (0, 0),
          f"{tag} {item.name}: launches {launches}")
    if rank == 0:
        out["kernel_calls_vs_plain"] = [
            (w,) + vs_plain[w](*call) for w, rec in recs.items()
            for call in rec.calls]
        again, t_si = timed(lambda: item.call(whole))
        out["single_ms"] = 1e3 * t_si
        diffs = p13_compare(item.kinds, item.pick(got), item.pick(want))
        out["vs_single"] = diffs
        bars = {name: item.tol for name in diffs}
        if not item.exact:
            out["single_repeat"] = p13_compare(
                item.kinds, item.pick(again), item.pick(want))
        if not one_rank or not item.exact:
            with p13_perturbed(draws):
                moved = item.call(item.place(p16_jittered(ops), None)
                                  if jitter else whole)
            shift = p13_compare(item.kinds, item.pick(moved),
                                item.pick(want))
            out["single_vs_perturbed"] = shift
        if one_rank:
            out["bitwise"] = p13_bitwise(got, want)
            out["single_repeat_bitwise"] = p13_bitwise(again, want)
            check(out["bitwise"] if item.exact else p13_within(
                diffs, P15_CS_TOL),
                  f"{tag} {item.name}: not the single call ({diffs})")
        else:
            bars = {name: bar if isinstance(shift[name], bool) else max(
                bar, P15_SHIFT_FACTOR * shift[name])
                for name, bar in bars.items()}
        floats = [t for t in p13_tensors(list(item.pick(got).values()))
                  if t.is_floating_point()]
        check(finite(*floats) and all(
            v is True or (not isinstance(v, bool) and v <= bars[name])
            for name, v in diffs.items()), f"{tag} {item.name}: {out}")
    say(f"  {item.name}: " + json.dumps(out))
    del ops, placed, whole, want, got
    torch.cuda.empty_cache()
    return launches, out


def phase_sharded_api():
    """Phase 15: row-sharded operands through the public API beyond
    rsvd.  Returns ((K1, K2, K3, K4, K5a, K5b) launches of its counted
    runs, summary)."""
    t0 = time.perf_counter()
    out = {}
    la, out["nccl_one_rank"] = p13_one_rank_nccl(p15_items, p15_run)
    out["a_s"] = time.perf_counter() - t0
    lb, out["gloo_four_ranks"] = p13_four_ranks(
        p15_items, p15_run, "phase 15", P15_TIMEOUT, P15B)
    out["s"] = time.perf_counter() - t0
    launches = [x + y for x, y in zip(la, lb)]
    log(f"  phase 15: {out['s']:.1f} s, launches {launches}")
    return launches, out


# --- phase 16: row-sharded operands through the rest of the public API ---

P16_TIMEOUT = 420.0       # s: the four ranks' whole run
P16_TOL = 1e-4            # (a) the by-design routes, (b): of the largest
P16_ITER_TOL = 1e-3       # (b) CG, Lanczos, k-means, the completion sweeps
P16_K1_DR = 1e-5          # K1 on a phase-16 QR panel: max |dR| / max |R|
P16_QR_METHODS = ("robust", "robust1", "cholqr1", "cholqr2", "cholqr3",
                  "householder", "polar", "cholqr1_fused", "polar_fused")
# (a) sizes: phase 2's panel, a 65536 x 240 panel (K3 at n = 240), the
# 4096^2 driver operand, an 8192^2 RBF kernel, phase 9's snapshots,
# 16384 kernel-PCA points, pod_h100's snapshots, phase 10's HODLR and GP,
# phase 11's blobs, complete_tucker's 256^3; (b) cuts them (the four
# ranks share the card and gloo's host hops; PERF.md lists both)
P16A = dict(panel=(4096, 80), tall=(65536, 240), side=M, lanczos=8192,
            snaps=DMD_N, kmat=KPCA_N, hodlr=HODLR_N, gp=GP_N, cluster=CL_N,
            tucker=CT_N)
P16B = dict(panel=(4096, 80), tall=(16384, 120), side=2048, lanczos=4096,
            snaps=16384, kmat=4096, pod=(1024, 32, 26), hodlr=4096, gp=4096,
            cluster=4096, tucker=128)
P16_LANCZOS_STEPS = 30
P16_POWER_R = 16          # svd(method='power'): the leading triplets
P16_SPAN = 16             # spans compared: the leading columns (svd)
P16_POD_SPAN = 8          # (POD and the incremental SVD: their modes)
# every float draw of the slice's modules, for the perturbed single call
P16_DRAWS = (("rsvd.driver", "generate_omega"),
             ("rsvd.hodlr", "generate_omega"),
             ("linalg.power", "gaussian"), ("rsvd.slq", "rademacher"),
             ("rsvd.tucker", "generate_omega"),
             ("rsvd._modewise", "generate_omega"))
# pod_h100's snapshots (nodes x 32 parameters x 101 steps, f64) and its
# parameter count, kept by phase 8 for phase 16's POD calls
POD_H100_RUN = {}


def p16_k1_vs_plain(y, args, kwargs, out):
    """Phase 2's K1 bounds, and max |dR| / max |R| within P16_K1_DR."""
    shape, dq, dr = cholqr1_vs_plain(y, args, kwargs, out)
    check(dr is None or dr <= P16_K1_DR,
          f"K1 {shape} in phase 16: dR/R={dr}")
    return shape, dq, dr


def p16_k2_vs_plain(y, args, kwargs, out):
    """Phase 15's K2 bounds, with max |dR| / max |R| reported."""
    r0 = kernels.polar_qr_fused_reference(y, *args, **kwargs)[1]
    dr = float((out[1] - r0).abs().max()) / float(r0.abs().max())
    return p15_polar_vs_plain(y, args, kwargs, out) + (dr,)


P16_VS_PLAIN = dict(P15_VS_PLAIN, fused_cholqr1=p16_k1_vs_plain,
                    polar_qr_fused=p16_k2_vs_plain)


def p16_panel(rows, cols, seed, decades=2.0):
    """A rows x cols f32 panel of condition 10^decades (geometric
    spectrum)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    s = torch.logspace(0.0, -decades, cols, device="cuda")
    with device.ieee_fp32():
        return (orthonormal(rows, cols, gen) * s) @ orthonormal(
            cols, cols, gen).T


def p16_tall(rows, cols, seed):
    """A rows x cols f32 panel whose P16_SPAN leading singular values
    fall from 1 to 0.5 and the rest from 0.1 to 0.01: the leading span
    has a gap behind it.  An f32 SVD's singular vectors inside a dense
    spectrum move by ~1e-4 with the route (the direct SVD against R's:
    1.1e-4 at condition 100, 4.0e-4 at condition 10 on a geometric
    spectrum), the span across a gap does not."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    s = torch.cat([torch.logspace(0.0, math.log10(0.5), P16_SPAN,
                                  device="cuda"),
                   torch.logspace(-1.0, -2.0, cols - P16_SPAN,
                                  device="cuda")])
    with device.ieee_fp32():
        return (orthonormal(rows, cols, gen) * s) @ orthonormal(
            cols, cols, gen).T


def p16_pod_snapshots(full):
    """(snapshots, parameter count): (a) pod_h100's (phase 8's run, or
    the pipeline again when phase 8 did not run in this process), f64;
    (b) P16B's nodes x parameters x steps of 12 decaying synthetic modes
    (fewer than the POD rank of 20: a rank-20 truncation of more modes
    leaves the f32 K3 incremental SVD's trailing directions, and with
    them its leading span, to roundoff, on one card too)."""
    if not full:
        nodes, n_mu, steps = P16B["pod"]
        gen = torch.Generator(device="cuda").manual_seed(40)
        modes = orthonormal(nodes, 12, gen).double()
        coeff = torch.randn(12, n_mu * steps, device="cuda", generator=gen,
                            dtype=torch.float64) * 0.6 ** torch.arange(
            12, device="cuda", dtype=torch.float64)[:, None]
        return modes @ coeff, n_mu
    if not POD_H100_RUN:
        adv, pcfg = pod_configs(POD_H100)
        POD_H100_RUN.update(snapshots=rom.run_pod_pipeline(
            pcfg, adv).snapshots, n_mu=pcfg.n)
        torch.cuda.empty_cache()
    return (torch.from_numpy(POD_H100_RUN["snapshots"]).cuda(),
            POD_H100_RUN["n_mu"])


def p16_gp_data(n, dtype):
    """Phase 10's GP data at n points (unsorted: fit sorts), its test
    points, in ``dtype``."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 20.0, n)
    y = np.sin(x) + 0.1 * np.cos(7.0 * x) + 0.05 * rng.standard_normal(n)
    xt = np.linspace(0.5, 19.5, GP_TEST)
    return tuple(torch.from_numpy(v).to("cuda", dtype) for v in (x, y, xt))


def p16_blobs(n, k=CL_K):
    """Phase 11's planted blobs at n points (``k`` of them)."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    centers = CL_SCALE * torch.randn(k, CL_D, device="cuda",
                                     generator=gen)
    truth = torch.arange(n, device="cuda") % k
    return centers[truth] + torch.randn(n, CL_D, device="cuda",
                                        generator=gen)


def p16_items(full):
    """Phase 16's calls: (a) ``full`` at P16A's sizes, (b) at P16B's."""
    z = P16A if full else P16B
    # (b) runs the kernel systems in f64: in f32 their CG stops on
    # roundoff (at 4096 GP points the single call's own alpha moved by
    # 3.2x under a 1e-7 change of its input), which leaves nothing to
    # hold the sharded route to
    kdtype = torch.float32 if full else torch.float64
    qr_mod, svd_mod, power, slq, deim, hodlr, gp_mod, inc = (
        p15_mod(m) for m in ("linalg.qr", "linalg.svd", "linalg.power",
                             "rsvd.slq", "rsvd.deim", "rsvd.hodlr",
                             "apps.gp", "linalg.incremental"))
    utv = p15_mod("rsvd.utv")

    def panel():                      # condition 10: CholeskyQR1's Q
        return (p16_panel(*z["panel"], 60, 1.0),)   # keeps 1e-5 on f32

    def tall():
        return (p16_tall(*z["tall"], 62),)

    def side_a():
        return (p15_decaying(z["side"], 0.97, 50),)

    def omega_ops():
        a = side_a()[0]
        return a, driver.generate_omega(0, z["side"], K + P, a.dtype,
                                        device="cuda")

    def refine_ops():
        a, om = omega_ops()
        return a, driver.subspace_iteration(a, om, 0)

    def factor_ops():
        a = side_a()[0]
        return (a,) + tuple(rsvd(a, k=K, method="eigh"))

    def lanczos_ops():
        gen = torch.Generator(device="cuda").manual_seed(62)
        return (rbf_kernel(z["lanczos"], NYS_DIM, NYS_H, seed=11),
                torch.randn(z["lanczos"], device="cuda", generator=gen))

    def deim_basis():
        return (rsvd(p13_snapshots(z["snaps"]), k=P13_DEIM_M, q=1,
                     method="eigh")[0],)

    def deim_call(method):
        def call(ops):
            idx = deim.deim_indices(ops[0], method)
            return (idx, deim.deim_projector(ops[0], idx),
                    deim.deim_condition(ops[0], idx))
        return call

    def kmat_ops():
        x = kpca_points(z["kmat"], torch.Generator(
            device="cuda").manual_seed(21))
        return x, x

    def pod_call(name):
        def call(ops):
            res = getattr(pod, name)(ops[0], rank=POD_H100["pod"]["rank"],
                                     svd_type=POD_H100["pod"]["svd_type"])
            return res.modes, res.sigma
        return call

    def pod_batches():
        s, n_mu = p16_pod_snapshots(full)
        k = s.shape[1] // n_mu
        return tuple(s[:, i * k:(i + 1) * k].float() for i in range(n_mu))

    def inc_call(ops):
        acc = inc.IncrementalSVD(rank=POD_H100["pod"]["rank"],
                                 method="eigh_pallas")
        for b in ops:
            acc.update(b)
        return acc.factors()

    def hodlr_ops():
        gen = torch.Generator(device="cuda").manual_seed(63)
        x = rbf_points(z["hodlr"], gen)
        k = torch.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.04) \
            + GP_NOISE ** 2 * torch.eye(z["hodlr"], device="cuda",
                                        dtype=torch.float64)
        return (k.to(kdtype), torch.randn(z["hodlr"], device="cuda",
                                          generator=gen, dtype=kdtype),
                (torch.sin(x) + 0.1 * torch.cos(7.0 * x)).to(kdtype))

    def hodlr_call(ops):
        h = hodlr.hodlr_build(ops[0], levels=HODLR_LEVELS, k=HODLR_K)
        x, steps = hodlr.hodlr_solve(h, ops[2], return_steps=True)
        return hodlr.hodlr_matvec(h, ops[1]), x, steps

    def gp_make():
        return gp_mod.GP(noise=GP_NOISE, levels=GP_LEVELS, rank=GP_RANK,
                         implicit_threshold=1)

    def gp_call(ops):
        g = gp_make().fit(ops[0], ops[1])
        mean, var = g.predict(ops[2], return_var=True)
        return g.alpha_, mean, var

    def gp_lml(ops):
        g = gp_make().fit(ops[0], ops[1])
        return torch.tensor(g.log_marginal_likelihood(num_probes=8,
                                                      steps=30))

    def cluster_call(gamma, k=CL_K):
        def call(ops):
            r = cluster.spectral_cluster(ops[0], k, gamma=gamma)
            return r.labels, r.embedding, r.centers, r.inertia
        return call

    def tucker_ops():
        gen = torch.Generator(device="cuda").manual_seed(64)
        n, r = z["tucker"], CT_R
        t = tucker_reconstruct(torch.randn(r, r, r, device="cuda",
                                           generator=gen),
                               [orthonormal(n, r, gen) for _ in range(3)])
        mask = torch.rand(t.shape, device="cuda", generator=gen) < CT_FRAC
        return torch.where(mask, t, torch.zeros((), device="cuda")), mask

    def qr_item(method):
        run = {"cholqr1_fused": ("fused_cholqr1",),
               "polar_fused": ("polar_qr_fused",)}.get(method, ())
        return P15Item(f"qr_{method}", panel,
                       lambda ops: qr_mod.qr_reduced(ops[0], method),
                       lambda r: dict(q=r[0], r=r[1]),
                       dict(q="value", r="value"), place=p15_rows(True),
                       kernels_run=run)

    def svd_item(method, exact=True):
        r = P16_POWER_R if method == "power" else 0
        run = ("eigh_small",) if method == "eigh_pallas" else ()
        return P15Item(f"svd_{method}", tall,
                       lambda ops: svd_mod.svd(ops[0], method, r),
                       lambda r_: dict(s=r_[1], u=r_[0][:, :P16_SPAN]),
                       dict(s="sigma", u="span"), place=p15_rows(True),
                       kernels_run=run, exact=exact)

    iter_tol = P16_TOL if full else P16_ITER_TOL
    return [qr_item(m) for m in P16_QR_METHODS] + [
        P15Item("cholesky_qr_family", panel,
                lambda ops: (qr_mod.cholesky_qr(ops[0])[0],
                             qr_mod.cholesky_qr2(ops[0])[0],
                             qr_mod.cholesky_qr3(ops[0])[0],
                             qr_mod.orthonormal_basis(ops[0])),
                lambda r: dict(q1=r[0], q2=r[1], q3=r[2], qb=r[3]),
                dict(q1="value", q2="value", q3="value", qb="value"),
                place=p15_rows(True)),
        svd_item("eigh_pallas"), svd_item("eigh"), svd_item("jacobi"),
        svd_item("power", exact=False), svd_item("xla", exact=False),
        P15Item("power_svd", tall,      # (b): gloo's ~7 ms all-reduces
                lambda ops: power.power_svd(ops[0], k=8 if full else 2),
                lambda r: dict(s=r[1], u=r[0]), dict(s="sigma", u="span"),
                place=p15_rows(True), tol=iter_tol),
        P15Item("power_triplet", lambda: tall() + (torch.ones(
                    z["tall"][1], device="cuda"),),
                lambda ops: power.power_triplet(ops[0], ops[1], 200),
                lambda r: dict(s=r[0], u=r[1][:, None]),
                dict(s="sigma", u="span"), place=p15_rows(True, False),
                tol=iter_tol),
        P15Item("subspace_iteration_k1", omega_ops,
                lambda ops: driver.subspace_iteration(
                    ops[0], ops[1], Q, qr_method="cholqr1_fused"),
                lambda r: dict(q=r), dict(q="span"),
                place=p15_rows(True, False), kernels_run=("fused_cholqr1",)),
        P15Item("power_refine_k1", refine_ops,
                lambda ops: driver.power_refine(ops[0], ops[1], Q,
                                                qr_method="cholqr1_fused"),
                lambda r: dict(q=r), dict(q="span"),
                place=p15_rows(True, True), kernels_run=("fused_cholqr1",)),
        P15Item("reconstruct_and_error", factor_ops,
                lambda ops: (driver.reconstruct(*ops[1:]),
                             driver.reconstruction_error(*ops)),
                lambda r: dict(a_k=r[0], err=r[1]),
                dict(a_k="value", err="value"),
                place=p15_rows(True, True, False, False)),
        P15Item("serving_health_rescore", side_a,
                lambda ops: (lambda r: r[:3] + tuple(utv.utv_rescore(
                    *r[:3])) + (torch.tensor([r[3][k] for k in (
                        "u_col_err", "v_orth_err", "s_min")]),))(
                    rsvd_serving(ops[0], k=K)),
                lambda r: dict(s=r[1], sigma=r[4], u=r[3], health=r[6]),
                dict(s="sigma", sigma="sigma", u="span", health="value"),
                place=p15_rows(True)),
        P15Item("lanczos_tridiag", lanczos_ops,
                lambda ops: slq.lanczos_tridiag(ops[0], ops[1],
                                                P16_LANCZOS_STEPS),
                lambda r: dict(alpha=r[0], beta=r[1]),
                dict(alpha="value", beta="value"),
                place=p15_rows(True, True), tol=iter_tol),
        P15Item("deim_qdeim", deim_basis, deim_call("qdeim"),
                lambda r: dict(idx=r[0], proj=r[1], cond=r[2]),
                dict(idx="index", proj="value", cond="value"),
                place=p15_rows(True)),
        P15Item("deim_classic", deim_basis, deim_call("deim"),
                lambda r: dict(idx=r[0], proj=r[1], cond=r[2]),
                dict(idx="index", proj="value", cond="value"),
                place=p15_rows(True)),
        P15Item("kernel_matrix", kmat_ops,
                lambda ops: kpca.kernel_matrix(ops[0], ops[1]),
                lambda r: dict(k=r), dict(k="value"),
                place=p15_rows(True, False)),
        P15Item("standard_pod", lambda: (p16_pod_snapshots(full)[0],),
                pod_call("standard_pod"),
                lambda r: dict(sigma=r[1], w=r[0][:, :P16_POD_SPAN]),
                dict(sigma="sigma", w="span"), place=p15_rows(True)),
        P15Item("naive_pod", lambda: (p16_pod_snapshots(full)[0],),
                pod_call("naive_pod"),
                lambda r: dict(sigma=r[1], w=r[0][:, :P16_POD_SPAN]),
                dict(sigma="sigma", w="span"), place=p15_rows(True)),
        P15Item("incremental_svd_k3", pod_batches, inc_call,
                lambda r: dict(s=r[1], u=r[0][:, :P16_POD_SPAN]),
                dict(s="sigma", u="span"),
                place=lambda ops, meshes: tuple(
                    shard_rows(b, meshes["rows"]) for b in ops)
                if meshes else ops, kernels_run=("eigh_small",)),
        P15Item("hodlr_build_solve", hodlr_ops, hodlr_call,
                # the CG steps: on one rank bitwise with the rest of the
                # result; on four f32 CG may stop a step apart
                lambda r: dict(y=r[0], x=r[1]), dict(y="value", x="value"),
                place=p15_rows(True, True, True), tol=iter_tol),
        P15Item("gp_fit_predict",
                lambda: p16_gp_data(z["gp"], kdtype), gp_call,
                lambda r: dict(alpha=r[0], mean=r[1], var=r[2]),
                dict(alpha="value", mean="value", var="value"),
                place=p15_rows(True, True, False), tol=iter_tol),
        P15Item("gp_lml", lambda: p16_gp_data(z["gp"], kdtype), gp_lml,
                lambda r: dict(lml=r), dict(lml="value"),
                place=p15_rows(True, True, False), exact=False,
                tol=iter_tol),
        P15Item("spectral_cluster", lambda: (p16_blobs(z["cluster"]),),
                cluster_call(CL_GAMMA),
                lambda r: dict(labels=r[0], z=r[1], inertia=r[3]),
                dict(labels="index", z="span", inertia="value"),
                place=p15_rows(True), tol=iter_tol),
        # the median heuristic's gamma (two blobs: its wide kernel leaves
        # eight blobs' k-means labels to roundoff, on one card too)
        P15Item("spectral_cluster_median",
                lambda: (p16_blobs(z["cluster"], 2),), cluster_call(None, 2),
                lambda r: dict(labels=r[0], z=r[1], inertia=r[3]),
                dict(labels="index", z="span", inertia="value"),
                place=p15_rows(True), tol=iter_tol),
        P15Item("complete_tucker", tucker_ops,
                lambda ops: complete_tucker(ops[0], ops[1], (CT_R,) * 3,
                                            iters=CT_ITERS),
                lambda r: dict(rmse=r[2], u0=r[1][0]),
                dict(rmse="value", u0="span"),
                place=p15_rows(True, True), tol=iter_tol),
    ]


def p16_jittered(ops):
    """The float tensors of ``ops`` times (1 + 1e-7 xi), xi Gaussian: a
    call with no draws (a QR, an SVD, the incremental SVD) moves under
    this roundoff-level change of its input as far as its conditioning
    lets it."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    return tuple(x * (1.0 + P13_PERTURB * torch.randn(
        x.shape, device=x.device, dtype=x.dtype, generator=gen))
        if torch.is_tensor(x) and x.is_floating_point() else x
        for x in ops)


P16_RUN = functools.partial(p15_run, draws=P16_DRAWS, tag="phase 16",
                            vs_plain=P16_VS_PLAIN, jitter=True)


def phase_sharded_rest():
    """Phase 16: row-sharded operands through the rest of the public API.
    Returns ((K1, K2, K3, K4, K5a, K5b) launches of its counted runs,
    summary)."""
    t0 = time.perf_counter()
    out = {}
    la, out["nccl_one_rank"] = p13_one_rank_nccl(p16_items, P16_RUN)
    out["a_s"] = time.perf_counter() - t0
    lb, out["gloo_four_ranks"] = p13_four_ranks(
        p16_items, P16_RUN, "phase 16", P16_TIMEOUT, P16B)
    out["s"] = time.perf_counter() - t0
    launches = [x + y for x, y in zip(la, lb)]
    out["launches_k1_to_k5b"] = launches
    log(f"  phase 16: {out['s']:.1f} s ((a) {out['a_s']:.1f} s), "
        f"launches {launches}")
    return launches, out


# --- phase 17: sparse operands split by entries, PCA.add_data, exact KPCA --

P17_TIMEOUT = 420.0       # s: the four ranks' whole run
# (a) a split sparse call against the single call: cuSPARSE's products are
# not bitwise from run to run (phase 11), so sigma within SP_SIGMA_TOL of
# sigma_1, beside the single call's own run-to-run and draw shifts
P17_TOL = SP_SIGMA_TOL
# (b) cuts (the four ranks share the card and gloo's host hops; PERF.md
# lists them): a quarter of ML-20M's users and ratings at its full item
# width, P15B's PCA with a quarter as many new rows, 1024 and 2048
# kernel-PCA points
P17B = dict(ml=(34624, 26744, 5000066), pca=(32768, 256), pca_new=8192,
            kpca=(1024, 2048))
P17_PCA_NEW = 65536       # (a): rows appended to phase 7's 262144
P17_ADAPTIVE = dict(tol=1e-2, k0=K, k_max=2 * K)   # stops at k_max
P17_DRAWS = (("rsvd.driver", "generate_omega"), ("rsvd.driver", "gaussian"),
             ("rsvd.diagnostics", "_probes"))
P17_ML = {}               # the ML-20M operand of this process, made once


def p17_ml(shape):
    """The ML-20M-shaped operand (``ml20m_operand``), made once a process
    and kept: every sparse item reads the same one."""
    if shape not in P17_ML:
        P17_ML.clear()
        P17_ML[shape] = ml20m_operand(shape=shape)
    return P17_ML[shape]


def p17_split(*split):
    """``place`` for a sparse operand and others: the sparse one split by
    its entries (``shard_rows`` of a sparse tensor) on the mesh, or as
    the single call's ``SparseStored`` (its CSRs built outside the
    timed call, as the split's are); those marked True row-sharded."""
    def place(ops, meshes):
        if not meshes:
            return (driver.sparse_operand(ops[0]),) + tuple(ops[1:])
        return (shard_rows(ops[0], meshes["rows"]),) + tuple(
            shard_rows(x, meshes["rows"]) if s else x
            for x, s in zip(ops[1:], split + (False,) * len(ops)))
    return place


def p17_items(full):
    """Phase 17's calls: (a) ``full`` at phases 7 and 11's sizes, (b) at
    P17B's cuts."""
    ml = ML20M if full else P17B["ml"]
    pca_rows, pca_d = (PCA_ROWS, PCA_D) if full else P17B["pca"]
    pca_new = P17_PCA_NEW if full else P17B["pca_new"]
    kpca_n = (KPCA_EXACT_N, 4 * KPCA_EXACT_N) if full else P17B["kpca"]
    diag = p15_mod("rsvd.diagnostics")
    sig = dict(sigma="sigma")
    sparse_kw = dict(k=K, p=P, q=Q)

    def ml_a():
        return (p17_ml(ml),)

    def ml_factors():
        a = p17_ml(ml)
        u, s, v = rsvd(driver.sparse_operand(a), **sparse_kw)
        return a, u, s, v

    def pca_ops():
        return (pca_operand(0, pca_rows, pca_d),
                pca_operand(1, pca_new, pca_d))

    def pca_add(ops):
        p = pca.PCA(ops[0], method="eigh")
        p.add_data(ops[1])
        return p.getS(), p.getV(), p.scores()

    def kpca_ops(n):
        def build():
            gen = torch.Generator(device="cuda").manual_seed(23)
            return (kpca_points(n, gen), kpca_points(KPCA_NEW // 4, gen))
        return build

    def kpca_call(solver):
        def call(ops):
            kp = kpca.KernelPCA(KPCA_K, solver=solver).fit(ops[0])
            return (kp.eigenvalues_, kp.alphas_, kp.scores_,
                    kp.transform(ops[1]))
        return call

    def est_call(ops):
        e = estimators.RandomizedSVD(n_components=K)
        z = e.fit_transform(ops[0])
        return (z, e.components_, e.singular_values_,
                e.explained_variance_ratio_)

    def item(name, build, call, pick, kinds, **kw):
        kw.setdefault("place", p17_split())
        return P15Item(name, build, call, pick, kinds, exact=False,
                       tol=P17_TOL, **kw)

    return [
        item("sparse_rsvd", ml_a, lambda ops: rsvd(ops[0], **sparse_kw),
             lambda r: dict(sigma=r[1]), sig),
        item("sparse_rsvd_cholqr1_fused_eigh_pallas", ml_a,
             lambda ops: rsvd(ops[0], qr_method="cholqr1_fused",
                              method="eigh_pallas", **sparse_kw),
             lambda r: dict(sigma=r[1]), sig,
             kernels_run=("fused_cholqr1", "eigh_small")),
        item("sparse_rsvd_adaptive", ml_a,
             lambda ops: rsvd_adaptive(ops[0], **P17_ADAPTIVE),
             lambda r: dict(sigma=r[1], k=torch.tensor(r[3])),
             dict(sigma="sigma", k="index")),
        item("sparse_rsvd_onepass", ml_a,
             lambda ops: rsvd_onepass(ops[0], k=K),
             lambda r: dict(sigma=r[1]), sig),
        item("sparse_randomized_svd", ml_a, est_call,
             lambda r: dict(s=r[2], ratio=r[3]),
             dict(s="sigma", ratio="value")),
        item("sparse_range_error_estimate", lambda: ml_factors()[:2],
             lambda ops: diag.range_error_estimate(ops[0], ops[1]),
             lambda r: dict(bound=r), dict(bound="value")),
        item("sparse_factorization_error_estimate", ml_factors,
             lambda ops: diag.factorization_error_estimate(*ops),
             lambda r: dict(bound=r), dict(bound="value")),
        # the scores' row norms are the centred rows' (every component is
        # kept): they hold the rows' global order [X; Y]
        P15Item("pca_add_data", pca_ops, pca_add,
                lambda r: dict(s=r[0], rows=torch.linalg.norm(r[2], dim=1)),
                dict(s="sigma", rows="value"), place=p15_rows(True, True)),
        P15Item("kernel_pca_auto", kpca_ops(kpca_n[0]), kpca_call("auto"),
                lambda r: dict(lam=r[0], z=r[3]), dict(lam="sigma",
                                                      z="gram"),
                place=p15_rows(True, False)),
        P15Item("kernel_pca_exact", kpca_ops(kpca_n[1]),
                kpca_call("exact"),
                lambda r: dict(lam=r[0], z=r[3]), dict(lam="sigma",
                                                      z="gram"),
                place=p15_rows(True, False)),
    ]


P17_RUN = functools.partial(p15_run, draws=P17_DRAWS, tag="phase 17",
                            vs_plain=P16_VS_PLAIN)


def phase_sharded_last():
    """Phase 17: sparse operands split by entries, ``PCA.add_data`` on
    row-sharded data, the exact ``KernelPCA`` on a sharded fit.  Returns
    ((K1, K2, K3, K4, K5a, K5b) launches of its counted runs, summary)."""
    t0 = time.perf_counter()
    out = {}
    la, out["nccl_one_rank"] = p13_one_rank_nccl(p17_items, P17_RUN)
    P17_ML.clear()
    torch.cuda.empty_cache()
    out["a_s"] = time.perf_counter() - t0
    lb, out["gloo_four_ranks"] = p13_four_ranks(
        p17_items, P17_RUN, "phase 17", P17_TIMEOUT, P17B)
    out["s"] = time.perf_counter() - t0
    launches = [x + y for x, y in zip(la, lb)]
    out["launches_k1_to_k5b"] = launches
    log(f"  phase 17: {out['s']:.1f} s ((a) {out['a_s']:.1f} s), "
        f"launches {launches}")
    return launches, out


def phase_main_path(label, forward, a, a64, err_np, prec, want):
    """Phase 3 for one configuration: the counted run, accuracy, the plain
    path, timings.  ``want`` = (K1, K2, K3, K4, K5a, K5b) launches per
    call.  Returns (those launches, summary dict)."""
    reset_counts()
    u, s, v = forward(a)
    torch.cuda.synchronize()
    launches = counts()
    check(launches == want, f"{label}: (K1, K2, K3, K4, K5a, K5b) launches "
          f"{launches}, not {want}")
    check(u.shape == (M, K) and s.shape == (K,) and v.shape == (N, K),
          f"shapes {u.shape} {s.shape} {v.shape}")
    check(all(bool(torch.isfinite(x).all()) for x in (u, s, v)),
          "non-finite factors")
    u_np, s_np, v_np = (to_numpy(x).astype(np.float64) for x in (u, s, v))
    err_ratio = recon_err(a64, u_np, s_np, v_np) / err_np
    orth = float(np.abs(u_np.T @ u_np - np.eye(K)).max())
    with plain_kernels():
        _, s_plain, _ = forward(a)
        plain_ms = cuda_ms(lambda: forward(a), 5)
    dsigma = float((s - s_plain).abs().max() / s_plain[0])
    ms = cuda_ms(lambda: forward(a), 10)
    out = dict(err_ratio_vs_numpy=err_ratio, max_rel_dsigma_vs_plain=dsigma,
               u_orth=orth, ms=ms, plain_ms=plain_ms,
               launches_k1_to_k5b=list(launches))
    check(err_ratio <= ERR_RATIO_MAX, f"err ratio {out}")
    check(dsigma <= SIGMA_TOL[prec], f"sigma vs plain {out}")
    check(orth <= 1e-3, f"U orthogonality {out}")
    return launches, out


def gram_of(b):
    """The tail's Gram of B (l x n, l <= n), as ``_gram_eigh_svd``
    forms it."""
    return device.matmul_at(b, b.T, "highest")


def fro_orth64(x):
    """||X^T X - I||_F in f64."""
    x = x.double()
    return float(torch.linalg.norm(
        x.T @ x - torch.eye(x.shape[1], dtype=x.dtype, device=x.device)))


def tail_orthogonality(q_mat, b, eighs):
    """Fault C: where U = Q U~ of a Gram-eigh tail loses orthogonality.
    For each ``eighs`` entry (name -> the (lam, U~) the tail would take
    from B's Gram, ascending), ||U~^T U~ - I||_F, ||U^T U - I||_F with
    U = Q U~ formed as the driver forms it, and the eigenvalues against
    an f64 eigh of the same Gram; beside them ||Q^T Q - I||_F of Q alone
    and both norms from the f64 eigenvectors."""
    g = gram_of(b)
    lam64, u64 = torch.linalg.eigh(g.double())
    top = float(lam64[-1])
    out = {"q": fro_orth64(q_mat), "l": int(g.shape[0]),
           "f64": dict(tail=fro_orth64(u64),
                       u=fro_orth64(q_mat.double() @ u64))}
    for name, (lam, ut) in eighs.items():
        u = device.matmul_at(q_mat, ut, "highest")
        out[name] = dict(
            tail=fro_orth64(ut), u=fro_orth64(u),
            max_rel_dlam=float((lam.double() - lam64).abs().max()) / top)
    return out


def tail_capture(module_names):
    """Patches that record the basis and the projected B of one call:
    ``_range_finder`` / ``_krylov_basis`` return Q, ``small_svd`` takes
    B."""
    seen = {}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            res = fn(*args, **kwargs)
            seen[name] = args[0] if name == "b" else res
            return res
        return wrapped
    stack = contextlib.ExitStack()
    for mod, attr, key in module_names:
        stack.enter_context(mock.patch.object(
            mod, attr, spy(key, getattr(mod, attr))))
    return stack, seen


def fault_c_main_path(a, forward):
    """Fault C on one main-path call: its Q and B, the tail with
    ``eigh_nan`` (torch's eigh as it comes) and with ``core/device.py::
    eigh`` (one Newton-Schulz step), each against f64."""
    stack, seen = tail_capture(((driver, "_range_finder", "q"),
                                (driver, "small_svd", "b")))
    with stack:
        forward(a)
    torch.cuda.synchronize()
    return tail_orthogonality(seen["q"], seen["b"], {
        "eigh_nan": device.eigh_nan(gram_of(seen["b"])),
        "eigh": device.eigh(gram_of(seen["b"]))})


def fault_c_krylov(a, qr_method, method):
    """Fault C on one block-Krylov call (l(q+1) = 240): as
    :func:`fault_c_main_path`, plus the eigenvectors the call's tail took
    where it ran K3 (recorded, not launched again)."""
    krylov = importlib.import_module(
        "rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.krylov")
    stack, seen = tail_capture(((krylov, "_krylov_basis", "q"),
                                (krylov, "small_svd", "b")))
    rec3 = Recorder(kernels.eigh_small)
    with stack, mock.patch.object(kernels, "eigh_small", rec3):
        rsvd_krylov(a, k=K, p=P, q=Q, qr_method=qr_method, method=method)
    torch.cuda.synchronize()
    g = gram_of(seen["b"])
    eighs = {"eigh_nan": device.eigh_nan(g), "eigh": device.eigh(g)}
    if rec3.calls:
        eighs["k3_as_run"] = rec3.calls[0][3]
    return tail_orthogonality(seen["q"], seen["b"], eighs)


def serving_run(label, operand, a64, err_np, interior):
    """One counted serving call and its checks; returns (K2 launches,
    summary dict)."""
    storage = label

    def call():
        return rsvd_serving(operand, k=K, p=P, q=Q, interior_qr=interior,
                            storage=storage)

    reset_counts()
    u, s, v, health = call()
    torch.cuda.synchronize()
    launches = counts()
    k2 = launches[1]
    want = 2 if interior == "polar_fused" else 0
    check(launches == launches_of(k2=want),
          f"serving {label}/{interior}: launches {launches}")
    check(health["ok"], f"serving {label}/{interior}: unhealthy {health}")
    u_np, s_np, v_np = (to_numpy(x).astype(np.float64) for x in (u, s, v))
    err = recon_err(a64, u_np, s_np, v_np)
    out = dict(storage=storage, interior_qr=interior,
               err_ratio_vs_numpy=err / err_np, health=health,
               ms=cuda_ms(call, 10), k2_launches=k2)
    if interior == "polar_fused":
        with plain_kernels():
            u0, s0, v0, _ = call()
            out["plain_ms"] = cuda_ms(call, 5)
        err0 = recon_err(a64, *(to_numpy(x).astype(np.float64)
                                for x in (u0, s0, v0)))
        out["rel_err_diff_vs_plain"] = abs(err / err0 - 1.0)
        check(out["rel_err_diff_vs_plain"] <= SERVING_PLAIN_TOL,
              f"serving {label}: kernel vs plain K2 {out}")
    check(out["err_ratio_vs_numpy"] <= ERR_RATIO_MAX,
          f"serving {label}/{interior}: err ratio {out}")
    return k2, out


def phase_drawn_point(rows, cols, k, seed):
    """Int8 serving of a rows x cols operand drawn on the card, k, p=16,
    q=2, against the port's own 'highest' finish='project' rSVD."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(rows, cols, device="cuda", generator=gen)
    quant_ms = cuda_ms(lambda: prepare_operand(a), 3)
    a8 = prepare_operand(a)

    def call():
        return rsvd_serving(a8, k=k, p=P, q=Q)

    u, s, v, health = call()
    check(health["ok"], f"{rows}x{cols} int8 serving: unhealthy {health}")
    ms = cuda_ms(call, 5)
    u_r, s_r, v_r = rsvd(a, k=k, p=P, q=Q, method="eigh",
                         qr_method="robust", precision="highest",
                         finish="project")
    with device.ieee_fp32():
        ratio = float(reconstruction_error(a, u, s, v)
                      / reconstruction_error(a, u_r, s_r, v_r))
    out = dict(shape=[rows, cols], k=k, quantize_ms=quant_ms, ms=ms,
               err_ratio_vs_highest_project=ratio, health_ok=health["ok"],
               stored_layout_shapes=[list(x.shape) for x in a8.layouts],
               stored_bytes=sum(x.numel() for x in a8.layouts),
               profile=profile_call(lambda: rsvd_serving(
                   a8, k=k, p=P, q=Q, interior_qr="cholqr1")))
    check(ratio <= ERR_RATIO_MAX, f"{rows}x{cols} int8 serving {out}")
    del a, a8
    torch.cuda.empty_cache()
    return out


# device kernels by name: (substrings, group), first match wins
KERNEL_GROUPS = (
    (("nccl",), "NCCL collectives"),
    (("jacobi_eigh", "eigh_cluster"), "K3 jacobi_eigh / eigh_cluster"),
    (("sketch_cluster", "sum_splits"), "K4 sketch_cluster / sum_splits"),
    (("ns_cluster", "ns_iterate"), "K2 ns_cluster / ns_iterate"),
    (("quantize_u8",), "K5 quantize_u8"),
    (("eliminate",), "K1 eliminate_cluster / eliminate_wide"),
    (("gram_cluster", "gram_partials"),
     "K1/K2 Gram (gram_cluster, gram_partials)"),
    (("apply_rows", "apply_right"), "K1/K2 apply (apply_rows, apply_right)"),
    (("syevj", "syevbj", "row_rotate", "column_rotate", "syevd", "sytrd",
      "stedc", "ormtr", "orgtr"), "cuSOLVER eigh"),
    (("i8", "s8", "imma", "int8"), "int8 GEMMs"),
    (("potrf", "getrf", "trsm", "trtri", "cholesky", "syrk"),
     "cholqr1 factor and solve"),
    (("gemm", "nvjet", "xmma"), "other GEMMs"),
)


def kernel_group(name):
    name = name.lower()
    for keys, group in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return group
    return "other kernels"


def profile_call(call, reps=10, keep_top=0):
    """One torch.profiler pass over ``reps`` calls: device time by kernel
    group, host syncs and the device idle share; with ``keep_top``, also
    that many device kernels by name and time."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {}
    by_name = {}
    busy = 0.0
    syncs = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dur = e.time_range.elapsed_us()
            busy += dur
            key = kernel_group(e.name)
            groups[key] = groups.get(key, 0.0) + dur
            by_name[e.name] = by_name.get(e.name, 0.0) + dur
        elif "Synchronize" in e.name or e.name == "aten::_local_scalar_dense":
            syncs += 1
    per_call_us = reps * 1e3
    out = {k: v / per_call_us for k, v in sorted(groups.items(),
                                                 key=lambda kv: -kv[1])}
    summary = dict(ms_per_call_by_group=out,
                   wall_ms_per_call=wall_us / per_call_us,
                   device_busy_ms_per_call=busy / per_call_us,
                   idle_share=(1.0 - busy / wall_us) if busy else None,
                   host_sync_events_per_call=syncs / reps)
    if not busy:
        log("  profiler saw no device time")
    top = sorted(((e.key, e.device_time_total if hasattr(
        e, "device_time_total") else 0.0) for e in prof.key_averages()),
        key=lambda kv: -kv[1])[:12]
    for key, t in top:
        log(f"    {t / per_call_us:9.4f} ms/call  {key[:90]}")
    if keep_top:
        summary["top_kernels_ms_per_call"] = [
            [key[:90], t / per_call_us] for key, t in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:keep_top]]
    return summary


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count {torch.cuda.device_count()}")

    phase("phase 1: build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"  built {[p.name for p in libs]} in "
        f"{time.perf_counter() - t0:.2f} s")
    for src, text in _build.build_logs.items():
        log(f"  nvcc {src}:\n" + "\n".join(
            "    " + line for line in text.strip().splitlines()))

    phase("phase 2: kernels against their plain versions")
    fwd_hi, (a,) = entry(device="cuda", m=M, n=N, precision="highest")
    y_main, all_panels = panels(a)
    k1 = phase_k1(y_main, all_panels)
    k2 = phase_k2(y_main, all_panels)
    del all_panels
    k3 = phase_k3(tail_gram(a))
    k4 = phase_k4(a)
    k5 = phase_k5()
    k6 = phase_k6()
    if "--kernels-only" in argv:
        phase("stopping after phase 2 (--kernels-only)")
        return 0

    phase("phase 3: main path")
    a64 = to_numpy(a).astype(np.float64)
    t0 = time.perf_counter()
    u_n, s_n, v_n = numpy_rsvd(a64, K + P, Q)
    err_np = recon_err(a64, u_n, s_n, v_n)
    log(f"  numpy f64 rSVD baseline: err {err_np:.6f} "
        f"({time.perf_counter() - t0:.1f} s)")
    fwd_def, _ = entry(device="cuda", m=M, n=N, precision="default")
    fwd_high, _ = entry(device="cuda", m=M, n=N, precision="high")
    omega = generate_omega(0, N, K + P, device="cuda")

    def fwd_polar(x):        # entry()'s configuration, polar interiors
        return rsvd_with_omega(x, omega, precision="default",
                               **dict(CONFIG, interior_qr="polar_fused"))
    launches_total = list(NONE)              # K1, K2, K3, K4, K5a, K5b
    summary = {}
    for label, prec, fwd, want in (
            ("highest", "highest", fwd_hi, launches_of(k1=Q + 1)),
            ("high", "high", fwd_high, launches_of(k1=Q + 1)),
            ("default", "default", fwd_def, launches_of(k1=Q + 1)),
            ("default, polar_fused interiors", "default", fwd_polar,
             launches_of(k1=1, k2=2))):
        launches, out = phase_main_path(label, fwd, a, a64, err_np, prec,
                                        want)
        launches_total = [t + c for t, c in zip(launches_total, launches)]
        summary[label] = out
        log(f"  main path [{label}]: " + json.dumps(out))
    summary["fault_c"] = {label: fault_c_main_path(a, fwd)
                          for label, fwd in (("highest", fwd_hi),
                                             ("default", fwd_def))}
    log("  fault C [main path tail]: " + json.dumps(summary["fault_c"]))
    summary["profile_default"] = profile_call(lambda: fwd_def(a))
    log("  profile [main path, default]: "
        + json.dumps(summary["profile_default"]))
    # the same configuration through the public rsvd()
    reset_counts()
    _, s_r, _ = rsvd(a, k=K, p=P, seed=0, precision="default",
                     **{k: v for k, v in CONFIG.items() if k != "k"})
    torch.cuda.synchronize()
    launches = counts()
    check(launches == launches_of(k1=Q + 1)
          and bool(torch.isfinite(s_r).all()),
          f"rsvd(): launches {launches}")
    launches_total[0] += launches[0]
    log(f"  rsvd() [default]: (K1, K2, K3, K4, K5a, K5b) launches {launches}, "
        f"s[0]={float(s_r[0]):.4f}")

    phase("phase 3: the three-kernel path (K4 sketch, K1 interiors, K3 tail)")
    omega_f = to_numpy(kernels.fused_sketch_omega(N, K + P, 0, "cuda"))
    u_n, s_n, v_n = numpy_rsvd(a64, K + P, Q, omega=omega_f.astype(np.float64))
    err_np_fused = recon_err(a64, u_n, s_n, v_n)
    log(f"  numpy f64 rSVD on the fused Omega: err {err_np_fused:.6f}")
    fused = {}
    for prec in ("highest", "default"):
        def fwd_fused(x, prec=prec):
            return rsvd(x, precision=prec, **FUSED)
        label = f"three kernels, {prec}"
        launches, out = phase_main_path(label, fwd_fused, a, a64,
                                        err_np_fused, prec,
                                        launches_of(k1=Q + 1, k3=1, k4=1))
        launches_total = [t + c for t, c in zip(launches_total, launches)]
        fused[prec] = out
        log(f"  main path [{label}]: " + json.dumps(out))
    fused["profile_highest"] = profile_call(
        lambda: rsvd(a, precision="highest", **FUSED))
    log("  profile [three kernels, highest]: "
        + json.dumps(fused["profile_highest"]))
    summary["three_kernels"] = fused

    phase(f"phase 3: rsvd(A, k={K}) at its defaults and the other engines")
    u_n, s_n, v_n = numpy_rsvd(a64, K + DEFAULT_P, Q)
    err_np_def = recon_err(a64, u_n, s_n, v_n)
    log(f"  numpy f64 rSVD at l={K + DEFAULT_P}: err {err_np_def:.6f}")
    engines = {}
    for method in ENGINES:
        def call(method=method):
            if method == "jacobi":
                return rsvd(a, k=K)                  # the public defaults
            return rsvd(a, k=K, method=method)
        sweeps = []
        real_core = jacobi._jacobi_core

        def spy(*args):
            out = real_core(*args)
            sweeps.append(out[3])
            return out
        reset_counts()
        with mock.patch.object(jacobi, "_jacobi_core", spy):
            u, s, v = call()
        torch.cuda.synchronize()
        launches = counts()
        check(launches == NONE, f"{method}: launches {launches}")
        check(u.shape == (M, K) and s.shape == (K,) and v.shape == (N, K)
              and all(bool(torch.isfinite(x).all()) for x in (u, s, v)),
              f"{method}: factors")
        ratio = recon_err(a64, *(to_numpy(x).astype(np.float64)
                                 for x in (u, s, v))) / err_np_def
        out = dict(err_ratio_vs_numpy=ratio, ms=cuda_ms(call, 2),
                   jacobi_sweeps=sweeps)
        engines[method] = out
        log(f"  rsvd(k={K}, method={method!r}): " + json.dumps(out))
        check(ratio <= ERR_RATIO_MAX, f"{method}: err ratio {ratio}")
    summary["defaults_and_engines"] = engines

    phase("phase 4: serving path")
    quant_ms = cuda_ms(lambda: prepare_operand(a), 10)
    a8 = prepare_operand(a)
    log(f"  prepare_operand (int8 quantization) 4096^2: {quant_ms:.4f} ms")
    serving = {"quantize_ms": quant_ms, "runs": []}
    for storage, operand in (("int8", a8), ("bf16", a), ("default", a)):
        for interior in ("cholqr1", "polar_fused"):
            n_k2, out = serving_run(storage, operand, a64, err_np, interior)
            launches_total[1] += n_k2
            serving["runs"].append(out)
            log(f"  serving [{storage}, {interior}]: " + json.dumps(out))
    serving["ragged_point"] = phase_drawn_point(*RAGGED, K, seed=3)
    log(f"  serving [int8, {RAGGED[0]}x{RAGGED[1]}, k={K}]: "
        + json.dumps(serving["ragged_point"]))
    serving["hbm_point"] = phase_drawn_point(BIG, BIG, BIG_K, seed=0)
    log(f"  serving [int8, {BIG}^2, k={BIG_K}]: "
        + json.dumps(serving["hbm_point"]))
    for interior in ("polar_fused", "cholqr1"):
        key = f"profile_int8_{interior}"
        serving[key] = profile_call(
            lambda: rsvd_serving(a8, k=K, p=P, q=Q, interior_qr=interior))
        log(f"  profile [int8, {interior}, 4096^2]: "
            + json.dumps(serving[key]))

    phase("phase 5: the image codec on the card")
    k5_launches, image_summary = phase_image()
    launches_total = [t + c for t, c in zip(launches_total, k5_launches)]

    phase("phase 6: the driver modes at 4096^2")
    modes = phase_driver_modes(a, a64, err_np)
    del a
    torch.cuda.empty_cache()

    phase("phase 7: PCA and the command lines")
    cli_launches, pca_summary = phase_pca()
    launches_total = [t + c for t, c in zip(launches_total, cli_launches)]

    phase("phase 8: POD/ROM on the card (pod_test02)")
    pod_summary = phase_pod()
    launches_total[2] += pod_summary["pod_h100"][
        "incremental_f32_eigh_pallas"]["launches_k1_to_k5b"][2]

    phase("phase 9: randomized NLA extensions (block Krylov through K1/K2/K3)")
    ext_launches, ext_summary = phase_extensions()
    launches_total = [t + c for t, c in zip(launches_total, ext_launches)]

    phase("phase 10: tensor and hierarchical formats, GP, checkpoints, "
          "autodiff")
    fmt_launches, fmt_summary = phase_formats()
    launches_total = [t + c for t, c in zip(launches_total, fmt_launches)]

    phase("phase 11: sparse operands and retrieval, kernel PCA, spectral "
          "clustering, the estimators, out-of-core streaming")
    app_launches, app_summary = phase_apps_streaming()
    launches_total = [t + c for t, c in zip(launches_total, app_launches)]

    phase("phase 12: the distributed half (one-rank NCCL group; four ranks "
          "sharing the card over gloo)")
    dist_launches, dist_summary = phase_distributed()
    launches_total = [t + c for t, c in zip(launches_total, dist_launches)]

    phase("phase 13: sharded operands beyond the driver (one-rank NCCL "
          "group; four ranks sharing the card over gloo)")
    ext_sh_launches, ext_sh_summary = phase_sharded_extensions()
    launches_total = [t + c for t, c in zip(launches_total, ext_sh_launches)]

    phase("phase 14: item 13's edge cases on the card; the factor "
          "checkpoint on torch.distributed.checkpoint")
    edge_launches, edge_summary = phase_edge_and_checkpoint()
    launches_total = [t + c for t, c in zip(launches_total, edge_launches)]

    phase("phase 15: row-sharded operands through the public API beyond "
          "rsvd (one-rank NCCL group; four ranks sharing the card over "
          "gloo)")
    api_launches, api_summary = phase_sharded_api()
    launches_total = [t + c for t, c in zip(launches_total, api_launches)]

    phase("phase 16: row-sharded operands through the rest of the public "
          "API (one-rank NCCL group; four ranks sharing the card over "
          "gloo)")
    rest_launches, rest_summary = phase_sharded_rest()
    launches_total = [t + c for t, c in zip(launches_total, rest_launches)]

    phase("phase 17: sparse operands split by entries, PCA.add_data on "
          "row-sharded data, the exact KernelPCA on a sharded fit (one-rank "
          "NCCL group; four ranks sharing the card over gloo)")
    last_launches, last_summary = phase_sharded_last()
    launches_total = [t + c for t, c in zip(launches_total, last_launches)]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    pkg = "rsvd_kamaneh_raganato_terrana_tpu_torch"
    kernels_line = {"kernels": [
        dict(name="fused_cholqr1", route="cuda",
             source=f"{pkg}/csrc/cholqr1.cu",
             replaces="rsvd_kamaneh_raganato_terrana_tpu/linalg/"
                      "pallas_kernels.py:321",
             launches=launches_total[0], **k1),
        dict(name="polar_qr_fused", route="cuda",
             source=f"{pkg}/csrc/polar.cu",
             replaces="rsvd_kamaneh_raganato_terrana_tpu/linalg/"
                      "polar.py:257",
             launches=launches_total[1], **k2),
        dict(name="eigh_small", route="cuda",
             source=f"{pkg}/csrc/eigh.cu",
             replaces="rsvd_kamaneh_raganato_terrana_tpu/linalg/"
                      "pallas_kernels.py:401",
             launches=launches_total[2], **k3),
        dict(name="fused_sketch_matmul", route="cuda",
             source=f"{pkg}/csrc/sketch.cu",
             replaces="rsvd_kamaneh_raganato_terrana_tpu/linalg/"
                      "pallas_kernels.py:116",
             launches=launches_total[3], **k4),
        dict(name="quantize_uint8", route="cuda",
             source=f"{pkg}/csrc/quantize.cu",
             replaces="rsvd_kamaneh_raganato_terrana_tpu/linalg/"
                      "pallas_kernels.py:198",
             launches=launches_total[4], **k5["K5a"]),
        dict(name="quantize_uint8[stochastic]", route="cuda",
             source=f"{pkg}/csrc/quantize.cu",
             replaces="rsvd_kamaneh_raganato_terrana_tpu/linalg/"
                      "pallas_kernels.py:178",
             launches=launches_total[5], **k5["K5b"]),
        dict(name="cast_sketch", route="cuda",
             source=f"{pkg}/csrc/cast_sketch.cu", replaces=None, **k6),
    ], "main_path": summary, "serving": serving, "image": image_summary,
        "driver_modes": modes, "pca": pca_summary, "pod": pod_summary,
        "extensions": ext_summary, "formats": fmt_summary,
        "apps_streaming": app_summary, "distributed": dist_summary,
        "sharded_extensions": ext_sh_summary,
        "edge_and_checkpoint": edge_summary, "sharded_api": api_summary,
        "sharded_rest": rest_summary, "sharded_last": last_summary}
    phase("all phases done")
    log(json.dumps(kernels_line))
    log(smi.stdout.strip())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
