"""The 'default' call's stage-A operand rounded to bf16 once a call
(``rsvd/driver.py::Bf16OnFirstUse``).

On the CPU: the staged products equal a cast in each product bit for
bit, in every orientation; a call makes one copy and reads it again in
each later pass (``driver.stage_tally``); the finish releases it; and
``_stage_operand`` holds only an f32 CUDA tensor at 'default' so.  On a
card (the ``card`` marker; skipped without one): a 4096^2 call at the
fit's settings gives the factors of the 'bf16' storage mode bitwise,
launches one bf16 copy of A (by ``a.to``: too few row tiles for K6), and
leaves no memory behind, on a single tensor and on a row-sharded one.  Imports torch and the port only, never
JAX, so that the card test runs where JAX is not installed.
"""

import pytest
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import matmul_at
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    from_dtensor,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.mesh import (
    make_mesh,
    shard_rows,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver

from _torch_ranks import one_rank_group

# the dense cells' settings (portbench/configs/dense_100k.json)
FIT = dict(method="eigh", qr_method="cholqr1_fused",
           interior_qr="cholqr1_fused", reorth="half")
FINISH_PASSES = {"project": 2, "utv": 2, "rowspace": 1, "rowspace_utv": 1}


def _operand(m=96, n=72, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(m, n, generator=g)


def _panel(rows, cols, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, cols, generator=g)


def _bits(x, y):
    return all(torch.equal(a, b) for a, b in zip(x, y))


@pytest.mark.parametrize("orient", ["a_x", "at_x", "xt_a"])
def test_staged_products_equal_a_cast_each_product(orient):
    a = _operand()
    staged, a16 = driver.Bf16OnFirstUse(a), a.to(torch.bfloat16)
    m, n = a.shape
    if orient == "a_x":
        x = _panel(n, 12)
        want = matmul_at(a16, x.to(torch.bfloat16), "default",
                         out_dtype=torch.float32)
        got = driver._mm(staged, x, "default")
    elif orient == "at_x":
        x = _panel(m, 12)
        want = matmul_at(a.T.to(torch.bfloat16), x.to(torch.bfloat16),
                         "default", out_dtype=torch.float32)
        got = driver._mm(staged.T, x, "default")
    else:
        x = _panel(m, 12)
        want = matmul_at(x.T.to(torch.bfloat16), a16, "default",
                         out_dtype=torch.float32)
        got = driver._mm(x.T, staged, "default")
    assert got.dtype == torch.float32 and torch.equal(got, want)
    # the 'bf16' storage mode's product (A cast once, eagerly)
    assert torch.equal(got, {"a_x": lambda: driver._mm(a16, x, "bf16"),
                             "at_x": lambda: driver._mm(a16.T, x, "bf16"),
                             "xt_a": lambda: driver._mm(x.T, a16, "bf16"),
                             }[orient]())
    # beside an f64 panel A is promoted unrounded, as it is unstaged
    x64 = x.double()
    if orient == "xt_a":
        assert torch.equal(driver._mm(x64.T, staged, "default"),
                           driver._mm(x64.T, a, "default"))
    else:
        op = staged if orient == "a_x" else staged.T
        plain = a if orient == "a_x" else a.T
        assert torch.equal(driver._mm(op, x64, "default"),
                           driver._mm(plain, x64, "default"))


@pytest.mark.parametrize("finish", sorted(FINISH_PASSES))
def test_a_call_casts_once_and_releases(finish):
    """2q + 2 passes ('project', 'utv') or 2q + 1 (the rowspace finishes):
    one cast and every other pass a reuse; the copy gone after the call;
    the factors those of the 'bf16' storage mode, bit for bit."""
    a = _operand()
    q, l = 2, 16
    omega = _panel(a.shape[1], l, seed=2)
    staged = driver.Bf16OnFirstUse(a)
    driver.reset_stage_tally()
    got = driver.rsvd_with_omega(staged, omega, q=q, k=8, precision="default",
                                 finish=finish, **FIT)
    passes = 2 * q + FINISH_PASSES[finish]
    assert driver.stage_tally() == {"casts": 1, "reuses": passes - 1,
                                    "fused": 0}
    assert staged._held[0] is None
    want = driver.rsvd_with_omega(a, omega, q=q, k=8, precision="bf16",
                                  finish=finish, **FIT)
    assert _bits(got, want)
    driver.reset_stage_tally()
    assert driver.stage_tally() == {"casts": 0, "reuses": 0, "fused": 0}


def test_transpose_shares_one_copy_and_release_drops_it():
    a = _operand()
    staged = driver.Bf16OnFirstUse(a)
    assert staged.shape == (96, 72) and staged.T.shape == (72, 96)
    assert staged.dtype == torch.float32 and staged.device == a.device
    driver.reset_stage_tally()
    first = staged.T.bf16()                   # the transposed view first
    again = staged.bf16()
    assert first.data_ptr() == again.data_ptr()
    assert torch.equal(again, a.to(torch.bfloat16))
    # the strides .to() gives A^T: the GEMMs see today's layouts
    assert first.stride() == a.T.to(torch.bfloat16).stride()
    assert driver.stage_tally() == {"casts": 1, "reuses": 1, "fused": 0}
    staged.T.release()                        # either view releases
    assert staged._held[0] is None
    staged.bf16()
    assert driver.stage_tally() == {"casts": 2, "reuses": 1, "fused": 0}


def test_stage_operand_holds_only_an_f32_card_tensor_at_default():
    a = _operand()
    # on the CPU 'default' keeps its f32 products (JAX's DEFAULT there)
    for precision in ("default", "DEFAULT", "highest", "high"):
        assert driver._stage_operand(a, precision) is a
    assert driver._stage_operand(a, "bf16").dtype == torch.bfloat16
    assert driver._stage_operand(a, "bfloat16").dtype == torch.bfloat16
    a8 = driver._stage_operand(a, "int8")
    assert isinstance(a8, driver.Int8Stored)
    for precision in ("default", "bf16", "int8"):
        assert driver._stage_operand(a8, precision) is a8
    sp = driver._stage_operand(a.to_sparse(), "default")
    assert isinstance(sp, driver.SparseStored)
    assert driver._stage_operand(sp, "default") is sp
    staged = driver.Bf16OnFirstUse(a)
    assert driver._stage_operand(staged, "default") is staged
    # the condition is matmul_at's cast: f32, on a card, at 'default'
    assert not driver._rounded_each_pass(a, "default")
    assert not driver._rounded_each_pass(a.double(), "default")
    driver.reset_stage_tally()
    driver.rsvd(a, k=8, p=8, q=2, seed=3, precision="default", **FIT)
    driver.rsvd(driver.quantize_int8_rows(a), k=8, p=8, q=2, seed=3, **FIT)
    driver.rsvd(a.to_sparse(), k=8, p=8, q=2, seed=3, precision="default",
                **FIT)
    assert driver.stage_tally() == {"casts": 0, "reuses": 0, "fused": 0}


def test_row_sharded_block_casts_once():
    """One gloo rank in this process: the staged block goes through the
    sharded products (``_sharded_mm``, ``_t_mm_split``) to the bit of the
    'bf16' storage mode's block, with one cast a call."""
    a = _operand(128, 72)
    omega = _panel(72, 16, seed=4)
    with one_rank_group():
        view = from_dtensor(shard_rows(a, make_mesh(device="cpu")))
        staged = view.with_block(driver.Bf16OnFirstUse(view.local))
        driver.reset_stage_tally()
        got = driver.rsvd_with_omega(staged, omega, q=2, k=8,
                                     precision="default", **FIT)
        assert driver.stage_tally() == {"casts": 1, "reuses": 5, "fused": 0}
        assert staged.local._held[0] is None
        want = driver.rsvd_with_omega(view, omega, q=2, k=8,
                                      precision="bf16", **FIT)
        assert _bits([got[0].full_tensor(), *got[1:]],
                     [want[0].full_tensor(), *want[1:]])


# --- on a card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    return "cuda"


def _copies_of(prof, shape):
    """The bf16 casts of a ``shape`` f32 tensor the profiled calls made."""
    return sum(1 for e in prof.events() if e.name == "aten::_to_copy"
               and e.input_shapes and list(e.input_shapes[0]) == list(shape))


def _check_on_card(a, call):
    """``call(precision)`` at 'default' against 'bf16': bitwise factors,
    one bf16 copy of A launched, no memory left behind."""
    from torch.profiler import ProfilerActivity, profile

    want = call("bf16")
    call("default")                                  # warm-up
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    driver.reset_stage_tally()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        got = call("default")
        torch.cuda.synchronize()
    assert driver.stage_tally() == {"casts": 1, "reuses": 5, "fused": 0}
    assert _copies_of(prof, a.shape) == 1
    assert _bits(got, want)
    del got
    assert torch.cuda.memory_allocated() == before


@pytest.mark.card
def test_default_call_on_card_is_bf16_storage_bitwise(card):
    gen = torch.Generator(device=card).manual_seed(7)
    a = torch.randn(4096, 4096, device=card, generator=gen)
    _check_on_card(a, lambda precision: driver.rsvd(
        a, k=128, p=16, q=2, seed=11, precision=precision, **FIT))


@pytest.mark.card
def test_row_sharded_default_call_on_card(card):
    """A one-rank group on the card (gloo takes CUDA tensors for its
    all-reduces): the row-sharded operand as the single one."""
    gen = torch.Generator(device=card).manual_seed(8)
    a = torch.randn(4096, 4096, device=card, generator=gen)
    with one_rank_group():
        dt = shard_rows(a, make_mesh(device=card))

        def call(precision):
            u, s, v = driver.rsvd(dt, k=128, p=16, q=2, seed=12,
                                  precision=precision, **FIT)
            return u.to_local(), s, v

        _check_on_card(a, call)
