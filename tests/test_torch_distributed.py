"""The port's distributed half (``core/mesh.py``, ``core/distributed.py``,
``core/collectives.py``, the sharded primitives, ``rsvd`` on sharded
operands, ``rsvd_sharded``, ``rsvd_ring`` and ``top_k_items_sharded``)
against the JAX package on the CPU.

The JAX side runs in this process on conftest's 8-device CPU mesh
(``mesh8``, or the JAX tests' own meshes).  The port side runs in P = 4
gloo ranks (``tests/_torch_ranks.py``, one group for the file), with a
(2, 2) mesh for the 2-D cases; the ranks import the port only and get
NumPy inputs.  Both get the same explicit Omega (JAX's draw): through
``rsvd_with_omega``, or patched into the port's ``generate_omega``.

Tolerances, the JAX tests' own: in f64, sigma rtol 1e-9 against JAX's
sharded result and against the port's single-rank call, U and V atol
1e-8 after aligning column signs; the f32, bf16 and int8 cases at their
JAX tests' bars (1e-5, 1e-4, 1e-5).  Where the JAX tests read
collectives from the HLO, these read the port's tally
(``core/collectives.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from rsvd_kamaneh_raganato_terrana_tpu.apps import retrieval as jret
from rsvd_kamaneh_raganato_terrana_tpu.core.distributed import (
    make_pod_mesh as jax_pod_mesh,
    row_spec_for as jax_row_spec_for,
)
from rsvd_kamaneh_raganato_terrana_tpu.core.mesh import (
    make_mesh as jax_make_mesh,
    shard_rows as jax_shard_rows,
)
from rsvd_kamaneh_raganato_terrana_tpu.ops import primitives as jprim
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import driver as jdrv
from rsvd_kamaneh_raganato_terrana_tpu.rsvd.ring import rsvd_ring as jax_ring
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import distributed
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import shard_block
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.mesh import (
    local_mesh_or_none,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdrv

from _torch_ranks import RankGroup

RANKS = 4


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(RANKS)
    yield group
    group.close()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_omega(seed, n, l, dtype=jnp.float64):
    return np.asarray(jdrv.generate_omega(seed, n, l, dtype))


def aligned(x, ref):
    """``x`` with each column's sign flipped to agree with ``ref``'s."""
    signs = np.sign(np.sum(x * ref, axis=0))
    return x * np.where(signs == 0, 1.0, signs)


def single(a, omega, **kwargs):
    """The port's single-rank call on the CPU: (U, s, V) as numpy."""
    return tuple(x.numpy() for x in tdrv.rsvd_with_omega(
        torch.from_numpy(a), torch.from_numpy(omega), **kwargs))


def check_factors(port, want, rtol=1e-9, atol=1e-8, uv=True):
    """σ to ``rtol``; U and V to ``atol`` after aligning signs."""
    u, s, v = port
    u0, s0, v0 = (np.asarray(x) for x in want)
    np.testing.assert_allclose(s, s0, rtol=rtol)
    if uv:
        np.testing.assert_allclose(aligned(u, u0), u0, atol=atol)
        np.testing.assert_allclose(aligned(v, v0), v0, atol=atol)


def factors(res):
    return res["u"], res["s"], res["v"]


def same_on_every_rank(results, *keys):
    for r in results[1:]:
        for key in keys:
            np.testing.assert_array_equal(r[key], results[0][key])


# --- tests/test_distributed.py ----------------------------------------------


def test_sharded_rsvd_contains_collectives(mesh8, rng, ranks):
    """A row-sharded rSVD issues all-reduces (JAX: the compiled HLO holds
    collectives)."""
    a = rng.standard_normal((512, 64))
    omega = jax_omega(0, 64, 16)
    text = jax.jit(lambda x: jdrv.rsvd_with_omega(
        x, jnp.asarray(omega), q=1, k=8)).lower(
        jax_shard_rows(jnp.asarray(a), mesh8)).compile().as_text()
    assert "all-reduce" in text or "all-gather" in text
    res = ranks.run("rsvd", a=a, layout="rows", omega=omega, q=1, k=8)
    tally = res[0]["tally"]
    assert tally["all_reduce"]["calls"] > 0
    assert "all_gather" not in tally and "send_recv" not in tally
    check_factors(factors(res[0]), single(a, omega, q=1, k=8))


def test_sharded_rsvd_numerically_matches(mesh8, rng, ranks):
    a = rng.standard_normal((512, 64))
    omega = jax_omega(0, 64, 16)
    want = jax.jit(lambda x: jdrv.rsvd_with_omega(
        x, jnp.asarray(omega), q=2, k=8))(
        jax_shard_rows(jnp.asarray(a), mesh8))
    res = ranks.run("rsvd", a=a, layout="rows", omega=omega, q=2, k=8)
    same_on_every_rank(res, "u", "s", "v")
    check_factors(factors(res[0]), want)
    check_factors(factors(res[0]), single(a, omega, q=2, k=8))
    for r, out in enumerate(res):        # each rank's rows of U
        np.testing.assert_allclose(
            out["u_local"], shard_block(out["u"], r, RANKS), atol=0)


def test_2d_sharded_rsvd(rng, ranks):
    """Rows x cols: both matrix dimensions sharded (JAX (4, 2) mesh, the
    port's (2, 2))."""
    mesh = jax_make_mesh((4, 2), ("rows", "cols"))
    a = rng.standard_normal((256, 128))
    omega = jax_omega(0, 128, 16)
    want = jax.jit(lambda x: jdrv.rsvd_with_omega(
        x, jnp.asarray(omega), q=2, k=8))(
        jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("rows",
                                                            "cols"))))
    res = ranks.run("rsvd", a=a, layout="rows_cols", omega=omega, q=2, k=8)
    check_factors(factors(res[0]), want)
    tally = res[0]["tally"]
    assert tally["all_reduce"]["calls"] > 0          # rows and cols sums
    assert tally["all_gather"]["calls"] > 0          # Z over the cols


def test_sharded_gram_is_partitioned(mesh8, rng, ranks):
    """The Gram of a row-sharded panel is a local k x k product and ONE
    all-reduce of k x k, no gather."""
    a = rng.standard_normal((512, 32))
    want = np.asarray(jprim.gram(jax_shard_rows(jnp.asarray(a), mesh8)))
    res = ranks.run("primitive", name="gram_sharded", args=(a,))
    np.testing.assert_allclose(res[0]["out"], want, rtol=1e-12)
    assert res[0]["tally"] == {"all_reduce": dict(
        calls=1, bytes=32 * 32 * 8, staged=0)}


def test_rsvd_ring_matches_plain(mesh8, rng, ranks):
    a = rng.standard_normal((256, 160))
    omega = jax_omega(5, 160, 16)
    want = jax_ring(mesh8, jnp.asarray(a), k=12, p=4, q=2, method="eigh",
                    seed=5)
    res = ranks.run("ring", a=a, omega=omega, k=12, p=4, q=2,
                    method="eigh", seed=5)
    u, s, v = factors(res[0])
    np.testing.assert_allclose(s, np.asarray(want[1]), rtol=1e-9)
    rec0 = np.asarray((want[0] * want[1][None, :]) @ want[2].T)
    np.testing.assert_allclose((u * s) @ v.T, rec0, atol=1e-8)
    check_factors(factors(res[0]),
                  single(a, omega, q=2, k=12, method="eigh"))


def test_rsvd_ring_collective_structure(rng, ranks):
    """Large operands move by point-to-point exchanges only; the only
    all-reduces are the l x l QR Grams (JAX: collective-permute, no
    all-gather).  Each exchange moves an n/P x l or m/P x l block."""
    m, n, l, q = 256, 160, 16, 1
    res = ranks.run("ring", a=rng.standard_normal((m, n)),
                    omega=jax_omega(0, n, l), k=12, p=4, q=q,
                    method="eigh", qr_method="cholqr2")
    tally = res[0]["tally"]
    assert set(tally) == {"send_recv", "all_reduce"}
    ar = tally["all_reduce"]
    assert ar["bytes"] == ar["calls"] * l * l * 8
    hops = RANKS - 1
    sketches, zs = q + 1, q + 1
    assert tally["send_recv"]["calls"] == hops * (sketches + zs)
    assert tally["send_recv"]["bytes"] == hops * (
        sketches * n // RANKS + zs * n // RANKS) * l * 8


def test_rsvd_sharded_ragged_rows(mesh8, rng, ranks):
    """rsvd_sharded pads 131 rows to 132 and crops U back: U is held as
    DTensor's uneven split (33, 33, 33, 32) and equals the single call."""
    a = rng.standard_normal((131, 96))
    omega = jax_omega(3, 96, 16)
    want = jdrv.rsvd_sharded(jnp.asarray(a), mesh8, k=8, p=8, q=2,
                             method="eigh", seed=3)
    res = ranks.run("rsvd", a=a, layout="rows", call="rsvd_sharded",
                    omega=omega, k=8, p=8, q=2, method="eigh", seed=3)
    assert res[0]["u"].shape == (131, 8)
    assert [r["u_local"].shape[0] for r in res] == [33, 33, 33, 32]
    check_factors(factors(res[0]), want)
    check_factors(factors(res[0]), single(a, omega, k=8, q=2,
                                          method="eigh"))


# --- tests/test_pod_mesh.py -------------------------------------------------


def test_initialize_is_noop_single_host(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    distributed.initialize()                    # must not raise or hang
    assert not torch.distributed.is_initialized()
    assert local_mesh_or_none("cpu") is None


def test_pod_mesh_single_host(ranks):
    """One host (no LOCAL_WORLD_SIZE): the pod mesh is the 1-D mesh, and
    ``row_spec_for`` shards rows over it."""
    facts = ranks.run("mesh_facts", rows=130)[0]
    assert facts["pod_shape"] == (RANKS,) and facts["pod_names"] == ("rows",)
    assert facts["pod_placements"] == ["S(0)"]


def test_rsvd_on_pod_mesh(rng, ranks):
    mesh = jax_pod_mesh()
    a = rng.standard_normal((256, 64))
    omega = jax_omega(0, 64, 16)
    want = jax.jit(lambda x: jdrv.rsvd_with_omega(
        x, jnp.asarray(omega), q=1, k=8))(jax.device_put(
            jnp.asarray(a), NamedSharding(mesh, jax_row_spec_for(mesh))))
    res = ranks.run("rsvd", a=a, layout="pod", omega=omega, q=1, k=8)
    check_factors(factors(res[0]), want)


# --- core/mesh.py ------------------------------------------------------------


def test_mesh_helpers(ranks):
    """make_mesh / make_tile_mesh / placements / shard_rows (raising on
    ragged rows, as JAX) / pad_rows_for_mesh / replicate, on 4 ranks."""
    facts = ranks.run("mesh_facts", rows=130)
    f = facts[0]
    assert f["world"] == RANKS
    assert f["mesh_shape"] == (RANKS,) and f["mesh_names"] == ("rows",)
    assert f["tile_shape"] == (2, 2) and f["tile_names"] == ("bx", "by")
    assert f["row_placements"] == ["S(0)"]
    assert f["col_placements"] == ["S(1)"]
    assert f["ragged_raises"]
    assert (f["padded_rows"], f["orig_rows"], f["pad_zero"]) == (132, 130,
                                                                True)
    whole = np.arange(130 * 3, dtype=np.float32).reshape(130, 3)
    whole = np.concatenate([whole, np.zeros((2, 3), np.float32)])
    for r, fr in enumerate(facts):
        np.testing.assert_array_equal(fr["local"],
                                      shard_block(whole, r, RANKS))
        np.testing.assert_array_equal(fr["whole"], whole)
        np.testing.assert_array_equal(fr["rep_local"], whole[:130])
        assert fr["local_mesh"]


# --- the sharded primitives (ops/primitives.py) ------------------------------

def _prim_cases(rng):
    x = rng.standard_normal((64, 32))
    return {
        "matvec_sharded": ((x, rng.standard_normal(32)), "all_gather"),
        "matmul_sharded": ((x, rng.standard_normal((32, 5))), None),
        "norm_sharded": ((x,), "all_reduce"),
        "normalize_sharded": ((rng.standard_normal(64),), "all_reduce"),
        "transpose_sharded": ((x,), "all_to_all"),
        "gram_sharded": ((x,), "all_reduce"),
        "matmul_reduce_scatter": ((rng.standard_normal((64, 32)),
                                   rng.standard_normal((32, 8))),
                                  "reduce_scatter"),
        "sketch_ring_pipelined": ((x, rng.standard_normal((32, 8))),
                                  "send_recv"),
        "power_zt_ring": ((x, rng.standard_normal((64, 8))), "send_recv"),
    }


@pytest.mark.parametrize("name", list(_prim_cases(np.random.default_rng(0))))
def test_sharded_primitive_matches_jax(name, mesh8, ranks):
    """Each sharded primitive against JAX's on mesh8, with the collective
    JAX spells out for it (and no other)."""
    args, kind = _prim_cases(np.random.default_rng(0))[name]
    want = np.asarray(getattr(jprim, name)(
        mesh8, *(jnp.asarray(x) for x in args)))
    res = ranks.run("primitive", name=name, args=args)
    np.testing.assert_allclose(res[0]["out"], want, rtol=1e-12,
                               atol=1e-12)
    assert set(res[0]["tally"]) == ({kind} if kind else set())


def test_ring_shift_rows(rng, ranks):
    """Each row block moves ``shift`` ranks around the ring."""
    x = rng.standard_normal((64, 8))
    block = 64 // RANKS
    for shift in (1, 3):
        res = ranks.run("primitive", name="ring_shift_rows", args=(x,),
                        shift=shift)
        np.testing.assert_array_equal(res[0]["out"],
                                      np.roll(x, shift * block, axis=0))
        assert set(res[0]["tally"]) == {"send_recv"}


def test_generate_gaussian_sharded_equals_unsharded(ranks):
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
        gaussian,
        key_from_seed,
    )

    res = ranks.run("primitive", name="generate_gaussian_sharded",
                    args=(7, (64, 8)), dtype=torch.float64)
    want = gaussian(key_from_seed(7, "cpu"), (64, 8), torch.float64)
    np.testing.assert_array_equal(res[0]["out"], want.numpy())
    assert res[0]["tally"] == {}


# --- tests/test_rsvd.py's sharded cases --------------------------------------


def test_rsvd_sharded_matches_single(mesh8, rng, ranks):
    """``rsvd`` on a row-sharded operand (Omega patched to JAX's draw)."""
    a = rng.standard_normal((256, 64))
    want = jdrv.rsvd(jax_shard_rows(jnp.asarray(a), mesh8), k=8, p=8, q=2)
    omega = jax_omega(0, 64, 16)
    res = ranks.run("rsvd", a=a, layout="rows", call="rsvd", omega=omega,
                    k=8, p=8, q=2)
    check_factors(factors(res[0]), want)
    check_factors(factors(res[0]), single(a, omega, k=8, q=2))


def test_bf16_storage_sharded_matches_single(mesh8, rng, ranks):
    a = rng.standard_normal((256, 64)).astype(np.float32)
    omega = jax_omega(0, 64, 16, jnp.float32)
    want = jdrv.rsvd(jax_shard_rows(jnp.asarray(a), mesh8), k=8, p=8, q=2,
                     precision="bf16")
    res = ranks.run("rsvd", a=a, layout="rows", call="rsvd", omega=omega,
                    k=8, p=8, q=2, precision="bf16")
    np.testing.assert_allclose(res[0]["s"], np.asarray(want[1]), rtol=1e-4)
    np.testing.assert_allclose(
        res[0]["s"], single(a, omega, k=8, q=2, precision="bf16")[1],
        rtol=1e-4)


def test_rowspace_sharded_matches_single(mesh8, rng, ranks):
    a = rng.standard_normal((256, 64)).astype(np.float32)
    omega = jax_omega(0, 64, 16, jnp.float32)
    want = jdrv.rsvd(jax_shard_rows(jnp.asarray(a), mesh8), k=8, p=8, q=2,
                     finish="rowspace")
    res = ranks.run("rsvd", a=a, layout="rows", call="rsvd", omega=omega,
                    k=8, p=8, q=2, finish="rowspace")
    np.testing.assert_allclose(res[0]["s"], np.asarray(want[1]), rtol=1e-5)
    np.testing.assert_allclose(
        res[0]["s"], single(a, omega, k=8, q=2, finish="rowspace")[1],
        rtol=1e-5)


@pytest.mark.parametrize("fin", ["utv", "rowspace_utv"])
def test_serving_finishes_sharded_match_single(fin, mesh8, rng, ranks):
    a = rng.standard_normal((256, 96))
    omega = jax_omega(0, 96, 16)
    want = jdrv.rsvd(jax_shard_rows(jnp.asarray(a), mesh8), k=8, p=8, q=2,
                     finish=fin)
    res = ranks.run("rsvd", a=a, layout="rows", call="rsvd", omega=omega,
                    k=8, p=8, q=2, finish=fin)
    check_factors(factors(res[0]), want)
    check_factors(factors(res[0]), single(a, omega, k=8, q=2, finish=fin))


@pytest.mark.parametrize("qr_method, method, interior", [
    ("robust", "eigh", None), ("robust1", "eigh", None),
    ("cholqr1", "eigh", None), ("cholqr2", "eigh_pallas", None),
    ("householder", "eigh", None), ("cholqr1_fused", "eigh", None),
    ("polar_fused", "xla", None), ("cholqr2", "eigh", "none")])
def test_sharded_qr_and_tail_match_single(qr_method, method, interior, rng,
                                          ranks):
    """Every QR of a row-sharded panel (and the column normalization of
    interior_qr='none') and the tails on the replicated B equal the
    single call; the CholeskyQR family splits by rows (Grams
    all-reduced, nothing gathered), Householder and the fused kernels
    (their plain versions here) gather the panel first."""
    a = rng.standard_normal((256, 64))
    omega = jax_omega(1, 64, 16)
    kw = dict(q=2, k=8, qr_method=qr_method, method=method,
              interior_qr=interior)
    res = ranks.run("rsvd", a=a, layout="rows", omega=omega, **kw)
    gathers = qr_method in ("householder", "cholqr1_fused", "polar_fused")
    check_factors(factors(res[0]), single(a, omega, **kw))
    assert ("all_gather" in res[0]["tally"]) == gathers


# --- tests/test_int8_serving.py's sharded cases ------------------------------


def _decaying(m, n, seed=0):
    r = np.random.default_rng(seed)
    u, _ = np.linalg.qr(r.standard_normal((m, min(m, n))))
    v, _ = np.linalg.qr(r.standard_normal((n, min(m, n))))
    s = np.geomspace(1.0, 1e-3, min(m, n))
    return ((u * s) @ v.T).astype(np.float32)


def test_sharded_int8_matches_replicated(ranks):
    """An Int8Stored of row-sharded DTensors: the integers of every
    product equal the single call's, so the factors do."""
    from jax.sharding import NamedSharding as NS

    a = _decaying(512, 96)
    mesh = jax_make_mesh((8,), ("rows",))
    st = jdrv.quantize_int8_rows(jnp.asarray(a))
    st_sh = jdrv.Int8Stored(
        jax.device_put(st.q8, NS(mesh, P("rows", None))),
        jax.device_put(st.row_scale, NS(mesh, P("rows"))))
    kw = dict(k=8, p=8, q=2, method="eigh", precision="int8")
    want = jdrv.rsvd(st_sh, **kw)
    omega = jax_omega(0, 96, 16, jnp.float32)
    res = ranks.run("rsvd", a=a, layout="int8", call="rsvd", omega=omega,
                    **kw)
    check_factors(factors(res[0]), want, rtol=1e-5, atol=1e-5)
    port1 = single(a, omega, **{k: v for k, v in kw.items() if k != "p"})
    np.testing.assert_allclose(res[0]["s"], port1[1], rtol=1e-6)


def test_rsvd_sharded_accepts_prequantized_operand(mesh8, ranks):
    """rsvd_sharded on a pre-quantized operand with RAGGED rows (515 on 4
    ranks): int8 rows padded with zeros, scales with ones."""
    m = 64 * 8 + 3
    a = _decaying(m, 96, seed=21)
    want = jdrv.rsvd_sharded(jdrv.quantize_int8_rows(jnp.asarray(a)), mesh8,
                             k=8, p=8, q=2, method="eigh")
    omega = jax_omega(0, 96, 16, jnp.float32)
    res = ranks.run("rsvd", a=a, layout="rows", call="rsvd_sharded",
                    omega=omega, int8=True, k=8, p=8, q=2, method="eigh")
    assert res[0]["u"].shape == (m, 8)
    assert [r["u_local"].shape[0] for r in res] == [129, 129, 129, 128]
    check_factors(factors(res[0]), want, rtol=1e-5, atol=1e-5)


# --- tests/test_retrieval.py:54 ----------------------------------------------


def test_sharded_top_k_matches_single_device(mesh8, rng, ranks):
    a = (rng.random((64, 128)) < 0.2) * rng.integers(1, 6, (64, 128))
    tables = jret.factorize_interactions(
        jax_shard_rows(jnp.asarray(a.astype(np.float64)), mesh8), k=8)
    users = np.asarray(tables.users[:4])
    items = np.asarray(tables.items)
    vals_j, ids_j = jret.top_k_items_sharded(mesh8, tables,
                                             jnp.asarray(users), k=7)
    res = ranks.run("top_k", items=items, users=users, k=7)
    same_on_every_rank(res, "vals", "ids")
    scores = users @ items.T
    expect = np.argsort(-scores, axis=1)[:, :7]
    np.testing.assert_array_equal(res[0]["ids"], expect)
    np.testing.assert_array_equal(res[0]["ids"], np.asarray(ids_j))
    np.testing.assert_allclose(res[0]["vals"], np.asarray(vals_j),
                               rtol=1e-10)
    assert set(res[0]["tally"]) == {"all_gather"}


# --- core/distributed.py's guard and core/collectives.py's tally ------------


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    """NCCL takes one card a rank: more NCCL ranks on a host than cards
    raise before any connection (never a silent switch to gloo)."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    cards = torch.cuda.device_count()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: min(cards, 1))
    with pytest.raises(RuntimeError, match="one card a rank"):
        distributed.initialize("127.0.0.1:1", 2, 0, backend="nccl")
    assert not torch.distributed.is_initialized()


def test_tally_counts_kinds_and_bytes(ranks):
    """Every primitive's collectives land in the tally by kind, with the
    bytes each rank handed in (rows x cols x 8 of its block)."""
    x = np.random.default_rng(3).standard_normal((64, 32))
    res = ranks.run("primitive", name="matvec_sharded",
                    args=(x, np.ones(32)))
    t = res[0]["tally"]["all_gather"]
    assert (t["calls"], t["bytes"], t["staged"]) == (1, 16 * 8, 0)
    res = ranks.run("primitive", name="ring_shift_rows", args=(x,))
    t = res[0]["tally"]["send_recv"]
    assert (t["calls"], t["bytes"], t["staged"]) == (1, 16 * 32 * 8, 0)


# --- the factor checkpoint on torch.distributed.checkpoint --------------


def test_dcp_checkpoint_of_a_row_sharded_u(rng, ranks, tmp_path):
    """``rsvd`` of a row-sharded operand, saved by every rank (its own
    rows of U), loaded back on the (4,) mesh (each rank's rows bitwise)
    and whole by each rank alone (bitwise the gathered U); S and V
    bitwise on every rank."""
    from torch.distributed.tensor import Shard

    a = rng.standard_normal((256, 48))
    omega = jax_omega(0, 48, 12)
    res = ranks.run("dcp", ckdir=str(tmp_path / "ck"), a=a, omega=omega,
                    q=1, k=8)
    for r, out in enumerate(res):
        got = out["mesh"]["u"]
        assert got["placements"] == [str(Shard(0))]
        np.testing.assert_array_equal(got["local"], out["saved_local"])
        np.testing.assert_array_equal(out["saved_local"],
                                      shard_block(out["saved"], r, RANKS))
        for load in ("mesh", "plain"):
            np.testing.assert_array_equal(out[load]["s"], out["s"])
            np.testing.assert_array_equal(out[load]["v"], out["v"])
            assert out[load]["meta"] == {"k": 8}
        np.testing.assert_array_equal(out["plain"]["u"], out["saved"])
        np.testing.assert_array_equal(got["whole"], out["saved"])


def test_dcp_checkpoint_of_one_process_reshards(rng, ranks, tmp_path):
    """A checkpoint written by one process (no process group) loads on
    the four ranks' mesh: each rank gets its block of rows, bitwise."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.checkpoint import (
        save_factors_dcp,
    )

    u, s, v = (torch.from_numpy(rng.standard_normal(shape))
               for shape in ((40, 6), (6,), (30, 6)))
    save_factors_dcp(str(tmp_path / "ck"), u, s, v)
    res = ranks.run("dcp", ckdir=str(tmp_path / "ck"))
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["mesh"]["u"]["local"],
                                      shard_block(u.numpy(), r, RANKS))
        np.testing.assert_array_equal(out["plain"]["u"], u.numpy())
        np.testing.assert_array_equal(out["mesh"]["v"], v.numpy())
        assert out["mesh"]["meta"] == {}
