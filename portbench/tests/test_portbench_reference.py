"""The plain references against NumPy at tiny sizes, and the frozen
rounding rules."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import operands
from portbench.reference import compare, quant, rsvd_f64
from portbench.reference.operand import DenseRef, SparseRef


def _dense(a, numerics="exact", block=5):
    t = torch.as_tensor(a, dtype=torch.float32)

    def blocks():
        for r0 in range(0, t.shape[0], block):
            yield r0, t[r0:r0 + block]
    return DenseRef(blocks, t.shape[0], t.shape[1], numerics)


def test_project_matches_numpy_svd():
    """On a matrix of exact rank l the rSVD is the truncated SVD."""
    rng = np.random.default_rng(0)
    m, n, l, k = 40, 30, 8, 6
    a = (rng.standard_normal((m, l)) * np.logspace(1, 0, l)) \
        @ rng.standard_normal((l, n))
    a = a.astype(np.float32).astype(np.float64)
    omega = rsvd_f64.draw_omega(5, n, l, "cpu")
    u, s, v = rsvd_f64.rsvd(_dense(a), omega, 2, "project")
    u, s, v = u[:, :k], s[:k], v[:, :k]
    un, sn, vtn = np.linalg.svd(a)
    np.testing.assert_allclose(s.numpy(), sn[:k], rtol=1e-10)
    np.testing.assert_allclose(np.abs(u.numpy().T @ un[:, :k]),
                               np.eye(k), atol=1e-8)
    np.testing.assert_allclose((u * s) @ v.T, (un[:, :k] * sn[:k])
                               @ vtn[:k], atol=1e-9 * sn[0])


def test_rowspace_utv_semantics():
    """U has unit columns, V = qr(A^T Q) with R's diagonal positive,
    s are the column norms of A V, sorted; A V = U diag(s)."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((50, 20)).astype(np.float32)
    ref = _dense(a)
    omega = rsvd_f64.draw_omega(9, 20, 10, "cpu")
    u, s, v = rsvd_f64.rsvd(ref, omega, 2, "rowspace_utv")
    a64 = torch.as_tensor(a, dtype=torch.float64)
    assert torch.allclose(torch.linalg.norm(u, dim=0),
                          torch.ones(10, dtype=torch.float64))
    assert torch.all(s[:-1] >= s[1:])
    assert torch.allclose(v.T @ v, torch.eye(10, dtype=torch.float64),
                          atol=1e-12)
    assert torch.allclose(a64 @ v, u * s, atol=1e-10)
    _, r = rsvd_f64.qr_pos(a64 @ v)
    assert torch.all(torch.diagonal(r) >= 0)


def test_sparse_reference_is_the_dense_one():
    gen = torch.Generator().manual_seed(3)
    dense = (torch.rand(30, 20, generator=gen) < 0.3) * torch.randn(
        30, 20, generator=gen)
    idx = dense.nonzero().T
    sp = SparseRef(idx, dense[idx[0], idx[1]], (30, 20))
    x = torch.randn(20, 4, dtype=torch.float64, generator=gen)
    y = torch.randn(30, 4, dtype=torch.float64, generator=gen)
    assert torch.allclose(sp.mm(x), dense.double() @ x)
    assert torch.allclose(sp.tmm(y), dense.double().T @ y)


def test_int8_rule_and_controls():
    gen = torch.Generator().manual_seed(4)
    blk = torch.randn(6, 50, generator=gen)
    q8, scale = quant.int8_rows(blk)
    assert q8.dtype == torch.int8 and int(q8.abs().max()) == 127
    assert torch.equal(scale, blk.abs().amax(1) / 127.0)
    assert torch.equal(q8, torch.round(blk / scale[:, None]).to(torch.int8))
    codes, s4 = quant.rows_codes(blk, 7)
    assert float(codes.abs().max()) == 7.0
    x = torch.randn(50, 3, dtype=torch.float64, generator=gen)
    assert quant.cols_rounded(x, 127).unique().numel() <= 3 * 255
    t = quant.tf32(torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 0.5]))
    assert t.tolist() == [1.0, 1.0 + 4 * 2 ** -11, 0.5]     # ties to even


def test_controls_read_lower_precision():
    """The int8 / int4 / TF32 views differ from the exact one by about
    their rounding, and the int4 one by more than the int8 one."""
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(64, 48, generator=gen)
    x = torch.randn(48, 5, dtype=torch.float64, generator=gen)
    exact = _dense(a).mm(x)
    err = {nm: float(torch.linalg.norm(_dense(a, nm).mm(x) - exact)
                     / torch.linalg.norm(exact))
           for nm in ("int8", "int4", "tf32", "int8_rows")}
    assert 1e-4 < err["tf32"] < 2e-3
    assert 1e-3 < err["int8"] < err["int4"] < 0.5
    y = torch.randn(64, 5, dtype=torch.float64, generator=gen)
    texact = _dense(a).tmm(y)
    terr = float(torch.linalg.norm(_dense(a, "int4").tmm(y) - texact)
                 / torch.linalg.norm(texact))
    assert 1e-2 < terr < 0.5


def test_gaps_by_hand():
    u = torch.eye(4, 2, dtype=torch.float64)
    v = torch.eye(3, 2, dtype=torch.float64)
    s = torch.tensor([2.0, 1.0], dtype=torch.float64)
    from portbench.reference.operand import Comm
    assert compare.factor_gap(u, s, v, u, s, v, Comm()) == 0.0
    s2 = torch.tensor([2.0, 1.5], dtype=torch.float64)
    assert compare.s_gap(s2, s) == pytest.approx(0.25)
    assert compare.factor_gap(u, s2, v, u, s, v, Comm()) == \
        pytest.approx(0.5 / 5 ** 0.5)
    assert compare.health(u, s, v) is True
    assert compare.health(u, s.flip(0), v) is False
    assert compare.s_rms(s2, s) == pytest.approx(0.25 / 2 ** 0.5)
    s_all = torch.tensor([10.0, 9.0, 8.9, 5.0, 4.9, 4.8], dtype=torch.float64)
    assert compare.lead_cut(s_all, 4) == 3         # (8.9 - 5) / 8.9 widest
    assert compare.lead_cut(s_all, 2) == 1


def test_operands_repeat_from_the_seed():
    op = {"rows": 40, "cols": 30, "parts": 2, "rank": 5, "sigma_1": 50.0,
          "decay": 2.0, "noise": 1.0, "block_rows": 7}
    a = operands.planted_part(op, 12345678901, 1, "cpu")
    b = torch.cat([blk.clone() for _, blk in operands.planted_blocks(
        op, 12345678901, 1, "cpu")])
    assert torch.equal(a, b) and a.shape == (20, 30)
    assert not torch.equal(a, operands.planted_part(op, 12345678901, 0,
                                                    "cpu"))
    ml = {"users": 300, "items": 80, "ratings": 2000, "zipf": [0.4, 0.5],
          "factors": 4}
    i1, v1, _ = operands.ml20m(ml, 2 ** 31 + 5, "cpu")
    i2, v2, _ = operands.ml20m(ml, 2 ** 31 + 5, "cpu")
    assert torch.equal(i1, i2) and torch.equal(v1, v2)
    keys = i1[0] * 80 + i1[1]
    assert torch.all(keys[1:] > keys[:-1])             # distinct, sorted
    assert set(v1.unique().tolist()) <= {x / 2 for x in range(1, 11)}
