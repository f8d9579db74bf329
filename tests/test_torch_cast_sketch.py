"""Kernel K6 ``cast_sketch`` (``csrc/cast_sketch.cu``): bf16(A) and the
sketch Y = bf16(A) Omega in one pass over A, and the driver's route to it
(``rsvd/driver.py::_cast_in_sketch``).

On the CPU: the plain version's copy is bitwise ``a.to(torch.bfloat16)``
and its Y the widened-f32 product of the two bf16 operands, at ragged
shapes; the wrapper takes the plain version for a CPU tensor; the route
decides by shape; the fused first product (device and SM count patched
in, the plain version computing) makes one copy a call that the later
passes reuse, and the factors of the 'bf16' storage mode.  On a card (the
``card`` marker; skipped without one): K6 against ``a.to`` (bitwise) and
``torch.mm`` on the same bf16 operands, and one routed ``rsvd()`` call.
Imports torch and the port only, never JAX, so that the card tests run
where JAX is not installed.
"""

import pytest
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import kernels
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver

# the dense cells' settings (portbench/configs/dense_100k.json)
FIT = dict(method="eigh", qr_method="cholqr1_fused",
           interior_qr="cholqr1_fused", reorth="half")
H100_SMS = 132
# K6 against torch.mm on the same bf16 operands: both add the same exact
# products in f32 in another order, so |dY| is held to this share of
# (|a16| @ |Omega|), far above the ~1e-7 a sum of 8192 terms gives and far
# below any error of the operands or of the layout
Y_TOL = 1e-5


def _operands(m, n, l, seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(m, n, generator=g, device=device)
    omega = torch.randn(n, l, generator=g, device=device)
    return a, omega.to(torch.bfloat16)


def _y_error(a16, omega16, y, want):
    scale = a16.double().abs() @ omega16.double().abs()
    return float(((y.double() - want.double()).abs()
                  / scale.clamp(min=1e-30)).max())


@pytest.mark.parametrize("m, n, l", [(4099, 1037, 17), (1000, 4096, 144),
                                     (1, 8, 1)])
def test_plain_version_copy_and_product(m, n, l):
    a, omega16 = _operands(m, n, l)
    a16, y = kernels.cast_sketch_reference(a, omega16)
    assert a16.dtype == torch.bfloat16 and a16.stride() == a.stride()
    assert torch.equal(a16, a.to(torch.bfloat16))
    assert y.dtype == torch.float32 and y.shape == (m, l)
    assert torch.equal(y, a16.to(torch.float32) @ omega16.to(torch.float32))
    # the f32 sums against f64 sums of the same exact products
    assert _y_error(a16, omega16, y, a16.double() @ omega16.double()) < Y_TOL


def test_wrapper_takes_the_plain_version_on_the_cpu():
    a, omega16 = _operands(300, 64, 20, seed=1)
    before = kernels.cast_sketch.launches
    got = kernels.cast_sketch(a, omega16.T.contiguous().T)
    want = kernels.cast_sketch_reference(a, omega16)
    assert all(torch.equal(x, w) for x, w in zip(got, want))
    assert kernels.cast_sketch.launches == before
    with pytest.raises(TypeError):
        kernels.cast_sketch(a.double(), omega16)
    with pytest.raises(TypeError):
        kernels.cast_sketch(a, omega16.float())
    with pytest.raises(ValueError):
        kernels.cast_sketch(a, omega16[:32])


def _staged(m, n, transposed=False, dtype=torch.float32):
    a = torch.empty((m, n), dtype=dtype, device="meta")
    stage = driver.Bf16OnFirstUse(a)
    return stage.T if transposed else stage


@pytest.mark.parametrize("case, stage, width, routed", [
    ("fit", lambda: _staged(100000, 100000), 144, True),
    ("four-card local block", lambda: _staged(100000, 100000), 144, True),
    ("tall and narrow", lambda: _staged(400000, 64), 144, True),
    ("4096^2", lambda: _staged(4096, 4096), 80, False),
    ("4097 rows, 33 tiles", lambda: _staged(32 * 128 + 1, 100000), 144,
     True),
    ("4096 rows, 32 tiles", lambda: _staged(32 * 128, 100000), 144, False),
    ("odd n", lambda: _staged(100000, 99999), 144, False),
    ("n % 8 != 0", lambda: _staged(100000, 100004), 144, False),
    ("transposed first use", lambda: _staged(100000, 100000, True), 144,
     False),
    ("l = 300", lambda: _staged(100000, 100000), 300, False),
    ("l = 145", lambda: _staged(100000, 100000), 145, False),
    ("l = 80", lambda: _staged(100000, 100000), 80, True),
    ("f64", lambda: _staged(100000, 100000, dtype=torch.float64), 144,
     False),
])
def test_route_by_shape(case, stage, width, routed):
    assert driver._cast_in_sketch(stage(), width, H100_SMS) is routed, case


def test_route_refuses_a_strided_operand():
    a = torch.empty((100000, 200000), device="meta")[:, :100000]
    assert not driver._cast_in_sketch(driver.Bf16OnFirstUse(a), 144,
                                      H100_SMS)


def test_fused_copy_is_reused_and_released():
    a, omega16 = _operands(96, 72, 12, seed=2)
    staged = driver.Bf16OnFirstUse(a)
    driver.reset_stage_tally()
    y = staged.bf16_times(omega16)
    assert torch.equal(y, kernels.cast_sketch_reference(a, omega16)[1])
    again = staged.T.bf16()
    assert again.data_ptr() == staged._held[0].data_ptr()
    assert torch.equal(again, a.T.to(torch.bfloat16))
    assert again.stride() == a.T.to(torch.bfloat16).stride()
    assert driver.stage_tally() == {"casts": 1, "reuses": 1, "fused": 1}
    staged.release()
    assert staged._held[0] is None


@pytest.mark.parametrize("finish", ["project", "rowspace"])
def test_fused_first_product_in_a_call(monkeypatch, finish):
    """The driver's fused branch on the CPU: the operand is made to look
    like one on a card of one SM (so that every shape fills it), and the
    wrapper computes with the plain version.  One copy a call, made by
    the first product and reused by every later pass; the factors those
    of the 'bf16' storage mode."""
    monkeypatch.setattr(driver.Bf16OnFirstUse, "device",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(driver, "_sm_count", lambda device: 1)
    a, _ = _operands(96, 72, 1, seed=3)
    omega = torch.randn(72, 16, generator=torch.Generator().manual_seed(4))
    staged = driver.Bf16OnFirstUse(a)
    driver.reset_stage_tally()
    got = driver.rsvd_with_omega(staged, omega, q=2, k=8,
                                 precision="default", finish=finish, **FIT)
    passes = 2 * 2 + (2 if finish == "project" else 1)
    assert driver.stage_tally() == {"casts": 1, "reuses": passes - 1,
                                    "fused": 1}
    assert staged._held[0] is None
    want = driver.rsvd_with_omega(a, omega, q=2, k=8, precision="bf16",
                                  finish=finish, **FIT)
    assert all(torch.equal(x, w) for x, w in zip(got, want))


# --- on a card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    return "cuda"


@pytest.mark.card
@pytest.mark.parametrize("m, n, l", [(16384, 8192, 144), (4099, 1040, 17),
                                     (4096, 4096, 80)])
def test_kernel_on_card_against_cast_and_mm(card, m, n, l):
    a, omega16 = _operands(m, n, l, seed=5, device=card)
    before = kernels.cast_sketch.launches
    a16, y = kernels.cast_sketch(a, omega16.T.contiguous().T)
    torch.cuda.synchronize()
    assert kernels.cast_sketch.launches == before + 1
    assert torch.equal(a16, a.to(torch.bfloat16))
    want = torch.mm(a16, omega16, out_dtype=torch.float32)
    assert _y_error(a16, omega16, y, want) <= Y_TOL
    plain16, plain_y = kernels.cast_sketch_reference(a, omega16)
    assert torch.equal(plain16, a16)
    assert _y_error(a16, omega16, y, plain_y) <= Y_TOL


@pytest.mark.card
def test_routed_rsvd_call_on_card(card):
    gen = torch.Generator(device=card).manual_seed(6)
    rows = 128 * torch.cuda.get_device_properties(0).multi_processor_count
    a = torch.randn(rows, 4096, device=card, generator=gen)
    before = kernels.cast_sketch.launches
    driver.reset_stage_tally()
    _, s, _ = driver.rsvd(a, k=128, p=16, q=2, seed=7, precision="default",
                          **FIT)
    torch.cuda.synchronize()
    assert kernels.cast_sketch.launches == before + 1
    assert driver.stage_tally() == {"casts": 1, "reuses": 5, "fused": 1}
    _, s16, _ = driver.rsvd(a, k=128, p=16, q=2, seed=7, precision="bf16",
                            **FIT)
    assert float(((s - s16).abs() / s16[0]).max()) <= 1e-4
