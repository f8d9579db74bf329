"""Which public functions take a row-sharded operand, in the JAX package
and in the port (not collected by pytest; the audit table of ROADMAP.md).

Every public callable of the JAX package's ``rsvd``, ``apps`` and
``linalg`` exports that takes a matrix or tensor operand (and the
estimators, spectral clustering and the GP named beside them) is called
twice on small f64 inputs: the JAX function on operands row-sharded over
an 8-device CPU mesh (tensors on mode 0), and the port's twin on the
same operands as row-sharded DTensors of 4 gloo ranks
(``tests/_torch_ranks.py``).  A call "runs" when it returns; the first
line of what it raised is recorded otherwise.

The rows marked ``sparse`` hand each driver, diagnostic, estimator and
retrieval function that takes a sparse operand on one card a sparse
operand placed with the row sharding: on the JAX side a BCOO given
``NamedSharding(mesh, P('rows'))``, which JAX applies to the leaves of
the BCOO (its data and indices, split by nonzero entries, so nse must
divide the devices: it is padded to a multiple of 8; the
``sparse_nse`` row leaves nse as ``fromdense`` makes it); on the port
side a sparse COO tensor split by its entries over the ranks
(``core/mesh.py::shard_rows``).  A class row made on its operands may
name a method called after it on operands of its own
(``PCA.add_data``).  Run from the repo root:

    env PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_sharded_audit.py [out.json [label]]

(~1 min; prints one line a function, the port's column headed by
``label``, and writes the table as JSON).
"""

import json
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402


def operands():
    """The named inputs, f64 from one seed (rows divide 8 and 4)."""
    g = np.random.default_rng(0)
    a = g.standard_normal((64, 48))
    q, _ = np.linalg.qr(g.standard_normal((64, 64)))
    spd = (q * (0.8 ** np.arange(64) + 0.1)) @ q.T
    u4 = np.linalg.qr(a)[0][:, :4]
    _, s, vt = np.linalg.svd(a, full_matrices=False)
    t = g.standard_normal((16, 6, 5))
    return dict(
        A=a, S=spd, B=np.eye(64) + 0.1 * spd, T=t, M=g.random((64, 48)) < .7,
        TM=g.random((16, 6, 5)) < 0.7, SN=g.standard_normal((64, 21)),
        Q=np.linalg.qr(g.standard_normal((64, 8)))[0], U4=u4, s4=s[:4],
        V4=vt[:4].T, b=g.standard_normal(64), W=g.standard_normal((16, 64)),
        bw=g.standard_normal(16), om=g.standard_normal((48, 8)),
        x48=g.standard_normal(48), X2=g.standard_normal((64, 10)),
        Y2=g.standard_normal((64, 7)), P2=g.standard_normal((64, 2)),
        idx=np.arange(4), X4=g.standard_normal((4, 48)), E4=np.eye(4),
        v0=g.standard_normal(64), y1=g.standard_normal(64),
        C4=g.standard_normal((64, 4)), Y16=g.standard_normal((16, 48)),
        SP=a * (g.random((64, 48)) < 0.2))


# (module:callable, operand names, which are row-sharded, keywords
# [, init keywords, method]): a class is made with ``init`` and
# ``method`` called on the operands; with ``init`` None it is made on the
# operands and ``method`` is (name, operand names, layouts)
R = "rows"
SP = "sparse"
CALLS = [
    ("rsvd.driver:rsvd", "A", (R,), {}),
    ("rsvd.driver:rsvd_with_omega", "A om", (R,), {}),
    ("rsvd.driver:rsvd_adaptive", "A", (R,), dict(tol=0.1)),
    ("rsvd.driver:rsvd_onepass", "A", (R,), dict(k=4)),
    ("rsvd.driver:rsvd_warm", "A Q", (R, R), {}),
    ("rsvd.driver:rsvd_image_preset", "A", (R,), {}),
    ("rsvd.driver:subspace_iteration", "A om", (R,), dict(q=1)),
    ("rsvd.driver:power_refine", "A Q", (R, R), dict(q=1)),
    ("rsvd.driver:reconstruct", "U4 s4 V4", (R,), {}),
    ("rsvd.driver:reconstruction_error", "A U4 s4 V4", (R, R), {}),
    ("rsvd.driver:quantize_int8_rows", "A", (R,), {}),
    ("rsvd.serving:prepare_operand", "A", (R,), {}),
    ("rsvd.serving:rsvd_serving", "A", (R,), dict(k=4)),
    ("rsvd.diagnostics:range_error_estimate", "A Q", (R, R), {}),
    ("rsvd.diagnostics:factorization_error_estimate", "A U4 s4 V4", (R, R),
     {}),
    ("rsvd.diagnostics:spectral_norm_estimate", "A", (R,), {}),
    ("rsvd.diagnostics:stable_rank_estimate", "A", (R,), {}),
    ("rsvd.diagnostics:factor_health", "U4 s4 V4", (R,), {}),
    ("rsvd.diagnostics:principal_angles", "Q C4", (R, R), {}),
    ("rsvd.diagnostics:subspace_distance", "Q C4", (R, R), {}),
    ("rsvd.krylov:krylov_basis", "A om", (R,), dict(q=1)),
    ("rsvd.krylov:rsvd_krylov", "A", (R,), {}),
    ("rsvd.interp:column_id", "A", (R,), dict(k=4)),
    ("rsvd.interp:row_id", "A", (R,), dict(k=4)),
    ("rsvd.interp:cur", "A", (R,), dict(k=4)),
    ("rsvd.interp:id_reconstruct", "A idx X4", (R,), {}),
    ("rsvd.interp:cur_reconstruct", "A idx idx E4", (R,), {}),
    ("rsvd.interp:leverage_scores", "A", (R,), dict(k=4)),
    ("rsvd.interp:leverage_sample", "A", (R,), dict(k=4, num_samples=8)),
    ("rsvd.nystrom:nystrom_psd", "S", (R,), dict(k=4)),
    ("rsvd.nystrom:reigh", "S", (R,), dict(k=4)),
    ("rsvd.nystrom:reigh_generalized", "S B", (R, R), dict(k=4)),
    ("rsvd.nystrom:nystrom_pcg", "S b", (R,), dict(mu=0.1, iters=5)),
    ("rsvd.lstsq:sketch_lstsq", "A b", (R,), {}),
    ("rsvd.lstsq:sketch_lstsq", "A b", (R,), dict(kind="sparse")),
    ("rsvd.lstsq:sketch_lstsq", "A b", (R,), dict(damp=0.1)),
    ("rsvd.lstsq:sketch_minnorm", "W bw", (R,), {}),
    ("rsvd.lstsq:lstsq_residual", "A x48 b", (R,), {}),
    ("rsvd.trace:hutchinson", "S", (R,), {}),
    ("rsvd.trace:hutchpp", "S", (R,), {}),
    ("rsvd.trace:diag_estimate", "S", (R,), {}),
    ("rsvd.slq:logdet_psd", "S", (R,), dict(steps=5)),
    ("rsvd.slq:lanczos_tridiag", "S v0", (R,), dict(steps=5)),
    ("rsvd.rlu:rlu", "A", (R,), dict(k=4)),
    ("rsvd.utv:rutv", "A", (R,), {}),
    ("rsvd.utv:utv_rescore", "U4 s4 V4", (R,), {}),
    ("rsvd.cca:cca", "X2 Y2", (R, R), {}),
    ("rsvd.dmd:dmd", "SN", (R,), dict(k=4)),
    ("rsvd.rpca:rpca", "A", (R,), dict(k_max=4, iters=3)),
    ("rsvd.completion:complete_lowrank", "A M", (R, R), dict(k=2,
                                                               iters=3)),
    ("rsvd.completion:complete_tucker", "T TM", (R, R),
     dict(ranks=(2, 2, 2), iters=2)),
    ("rsvd.deim:deim_fit", "SN", (R,), dict(m=4)),
    ("rsvd.deim:deim_indices", "U4", (R,), {}),
    ("rsvd.deim:deim_projector", "U4 idx", (R,), {}),
    ("rsvd.deim:deim_condition", "U4 idx", (R,), {}),
    ("rsvd.hodlr:hodlr_build", "S", (R,), dict(levels=2, k=4)),
    ("rsvd.tucker:tucker", "T", (R,), dict(ranks=(2, 2, 2))),
    ("rsvd.tucker:tucker_adaptive", "T", (R,), dict(tol=0.5)),
    ("rsvd.tt:tt_decompose", "T", (R,), dict(ranks=(2, 2))),
    ("rsvd.tt:tt_adaptive", "T", (R,), dict(tol=0.5)),
    ("rsvd.cp:cp_decompose", "T", (R,), dict(rank=2, iters=3)),
    ("rsvd.cp:cp_decompose", "T", (R,), dict(rank=2, iters=3,
                                             method="rand")),
    ("apps.pca:PCA", "A", (R,), {}),
    ("apps.kpca:KernelPCA", "A", (R,), {}, dict(n_components=4,
                                                solver="randomized"),
     "fit"),
    ("apps.kpca:kernel_matrix", "A A", (R,), {}),
    ("apps.kpca:nystrom_features", "A X4", (R,), {}),
    ("apps.kpca:rff_features", "A", (R,), dict(n_features=16)),
    ("apps.estimators:RandomizedSVD", "A", (R,), {},
     dict(n_components=4), "fit_transform"),
    ("rsvd.driver:rsvd", "SP", (SP,), dict(k=4)),
    ("rsvd.driver:rsvd", "SP", ("sparse_nse",), dict(k=4)),
    ("rsvd.driver:rsvd_with_omega", "SP om", (SP,), {}),
    ("rsvd.driver:rsvd_adaptive", "SP", (SP,), dict(tol=0.1)),
    ("rsvd.driver:rsvd_onepass", "SP", (SP,), dict(k=4)),
    ("rsvd.driver:rsvd_warm", "SP Q", (SP,), {}),
    ("rsvd.driver:rsvd_image_preset", "SP", (SP,), {}),
    ("rsvd.driver:subspace_iteration", "SP om", (SP,), dict(q=1)),
    ("rsvd.driver:power_refine", "SP Q", (SP,), dict(q=1)),
    ("rsvd.diagnostics:range_error_estimate", "SP Q", (SP,), {}),
    ("rsvd.diagnostics:factorization_error_estimate", "SP U4 s4 V4",
     (SP,), {}),
    ("rsvd.diagnostics:spectral_norm_estimate", "SP", (SP,), {}),
    ("rsvd.diagnostics:stable_rank_estimate", "SP", (SP,), {}),
    ("apps.estimators:RandomizedSVD", "SP", (SP,), {},
     dict(n_components=4), "fit_transform"),
    ("apps.retrieval:factorize_interactions", "SP", (SP,), dict(k=4)),
    ("apps.pca:PCA", "A", (R,), {}, None, ("add_data", "Y16", (R,))),
    ("apps.kpca:KernelPCA", "A", (R,), {}, dict(n_components=4,
                                                solver="exact"), "fit"),
    ("apps.estimators:RandomizedPCA", "A", (R,), {},
     dict(n_components=4), "fit_transform"),
    ("apps.cluster:spectral_cluster", "P2", (R,), dict(n_clusters=2)),
    ("apps.gp:GP", "P2 y1", (R, R), {}, {}, "fit"),
    ("apps.pod:perform_svd", "SN", (R,), dict(svd_type=1)),
    ("apps.pod:standard_pod", "SN", (R,), dict(rank=4)),
    ("apps.pod:naive_pod", "SN", (R,), dict(rank=4)),
    ("linalg.incremental:IncrementalSVD", "SN", (R,), {},
     dict(rank=4), "update"),
    ("linalg.svd:svd", "A", (R,), {}),
    ("linalg.svd:SVD", "A", (R,), {}),
    ("linalg.jacobi:jacobi_svd", "A", (R,), {}),
    ("linalg.power:power_svd", "A", (R,), dict(k=2)),
    ("linalg.power:power_triplet", "A x48", (R,), dict(num_iters=3)),
    ("linalg.qr:qr_reduced", "A", (R,), {}),
    ("linalg.qr:orthonormal_basis", "A", (R,), {}),
    ("linalg.qr:cholesky_qr", "A", (R,), {}),
    ("linalg.qr:cholesky_qr2", "A", (R,), {}),
    ("linalg.qr:cholesky_qr3", "A", (R,), {}),
    ("linalg.qr:qr_full", "A", (R,), {}),
]


def _label(call):
    fn, _, lays, kw = call[:4]
    name = fn.split(":")[1]
    if len(call) > 4 and call[4] is None:
        name += "." + call[5][0]
    extra = [f"{k}={v}" for k, v in kw.items()
             if k in ("kind", "damp", "method")]
    if len(call) > 4 and call[4] and "solver" in call[4]:
        extra.append(f"solver={call[4]['solver']}")
    extra += [lay for lay in lays if lay.startswith("sparse")]
    return name + (f"[{','.join(extra)}]" if extra else "")


def _jax_operand(x, lay, mesh):
    """``x`` on the JAX side: row-sharded, a sparse BCOO given the row
    sharding (nse padded to a multiple of 8, or as ``fromdense`` makes
    it), or whole."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse
    from jax.sharding import NamedSharding, PartitionSpec

    rows = NamedSharding(mesh, PartitionSpec("rows"))
    if lay in ("sparse", "sparse_nse"):
        nse = int(np.count_nonzero(x))
        bcoo = jsparse.BCOO.fromdense(
            jnp.asarray(x), nse=-(-nse // 8) * 8 if lay == "sparse" else nse)
        return jax.device_put(bcoo, rows)
    return jax.device_put(jnp.asarray(x), rows) if lay else jnp.asarray(x)


def _first_line(exc):
    return (type(exc).__name__ + ": " + str(exc).strip().split("\n")[0])[:160]


def jax_side(ops):
    import importlib

    import jax
    from jax.sharding import Mesh

    jax.config.update("jax_enable_x64", True)
    mesh = Mesh(np.array(jax.devices()[:8]), ("rows",))
    out = {}
    for call in CALLS:
        fn, names, lays, kw = call[:4]
        module, name = fn.split(":")
        obj = getattr(importlib.import_module(
            "rsvd_kamaneh_raganato_terrana_tpu." + module), name)
        lays = tuple(lays) + (None,) * (len(names.split()) - len(lays))
        print("jax:", _label(call), file=sys.stderr, flush=True)
        try:
            args = [_jax_operand(ops[n], lay, mesh)
                    for n, lay in zip(names.split(), lays)]
            if len(call) > 4 and call[4] is None:
                method, more, more_lays = call[5]
                more_lays = tuple(more_lays) + (None,) * len(more.split())
                res = getattr(obj(*args, **kw), method)(
                    *(_jax_operand(ops[n], lay, mesh)
                      for n, lay in zip(more.split(), more_lays)))
            else:
                if len(call) > 4:
                    obj = getattr(obj(**call[4]), call[5])
                res = obj(*args, **kw)
            jax.block_until_ready(jax.tree_util.tree_leaves(res))
            out[_label(call)] = None
        except Exception as exc:  # noqa: BLE001 -- recorded
            out[_label(call)] = _first_line(exc)
    return out


def port_side(ops):
    from _torch_ranks import RankGroup

    group = RankGroup(4)
    out = {}
    try:
        for call in CALLS:
            fn, names, lays, kw = call[:4]
            extra = {}
            if len(call) > 4 and call[4] is None:
                method, more, more_lays = call[5]
                extra = dict(then=(method, tuple(ops[n] for n in
                                                 more.split()), more_lays))
            elif len(call) > 4:
                extra = dict(cls_init=call[4], cls_method=call[5])
            res = group.run("raises", fn=fn, args=tuple(
                ops[n] for n in names.split()), layouts=lays, timeout=120,
                **extra, **kw)[0]
            out[_label(call)] = None if res is None else (
                res["type"] + ": " + res["message"].split("\n")[0])[:160]
    finally:
        group.close()
    return out


if __name__ == "__main__":
    ops = operands()
    port = port_side(ops)
    jx = jax_side(ops)
    label = sys.argv[2] if len(sys.argv) > 2 else "this tree"
    table = {k: {"jax": jx[k], "port, " + label: port[k]} for k in port}
    print(f"{'function':44s} jax, 8-device mesh | port, {label}")
    for k in table:
        print(f"{k:44s} {'runs' if jx[k] is None else 'FAILS: ' + jx[k]}"
              f" | {'runs' if port[k] is None else 'FAILS: ' + port[k]}")
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(table, f, indent=1)
