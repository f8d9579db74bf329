"""Kind ``tucker``: a dense tensor in, ``(core, factors)`` out, held to the
plain f64 ST-HOSVD on the same tensor and sketches
(``reference/tucker_f64.py``).

The operand (configuration ``operand``, ``kind`` "planted_tucker") is
a planted Tucker tensor plus noise, made on the device from the seed:
a Gaussian core of multilinear rank ``core_rank`` whose entries are
scaled by ``scale`` and, along each mode i, by exp(-j / decay_i) at
index j; Gaussian factors n_i x R_i / sqrt(n_i); then N(0, noise^2)
added.  The tensor is made in blocks of ``block`` mode-0 slices, each
the mode-0 factor's rows times (core x_1 F_1 x_2 F_2 ...) plus its
noise, in IEEE f32.  The program reads it as it is, and so does the
reference (``held`` is the same tensor).

Readings, each the worst over the sampled calls (k0 per mode from
``compare.lead_cut`` on the square roots of the reference's
projected-Gram eigenvalues):

- ``err_gap``: |eps - eps_r| / eps_r, eps = sqrt(||A||^2 - ||G||^2) /
  ||A|| the relative error the orthonormal factors imply, in f64;
- ``fit_gap``: |eps_t - eps_r| / eps_r, eps_t = ||A - [G; U]||_F / ||A||
  the true relative error of the core and factors together, in f64 from
  the held tensor (``tucker_f64.held_inner``): it sees every factor and
  stays as it is where a basis turns inside a near-tie.  The exact
  reference's factors are orthonormal and its core their contraction,
  so its true error is eps_r;
- ``orth_gap``: max_i ||U_i^T U_i - I||_F / sqrt(r_i), the program's
  factors alone;
- ``lead_gap``: over the modes, the largest ||P_k0 - P_r,k0||_F /
  sqrt(k0), P_k0 the projector on the factor's leading k0 columns.

``eps_ref`` (the reference's eps) is a diagnosis, not compared.
"""

from __future__ import annotations

import math

import torch

from portbench import check, operands, roofline
from portbench.reference import compare, tucker_f64

F64 = torch.float64

SPANS = {
    "products": ["rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._modewise:_mm"],
    "unfold": ["rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.tucker:_unfold"],
    "tail": ["rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._modewise:eigh"],
}


# -- the program's operand ------------------------------------------------

def _mode_mul(t, mat, mode):
    """t x_mode mat (mat: n x R contracts t's size-R axis ``mode``)."""
    moved = t.movedim(mode, -1)
    return (moved @ mat.T).movedim(-1, mode)


def planted(op: dict, seed: int, device) -> torch.Tensor:
    """The planted tensor of the module docstring (f32, contiguous)."""
    shape, ranks = op["shape"], op["core_rank"]
    gen = operands.generator(operands.mix(seed, 0), device)
    with operands.ieee_f32():
        core = torch.randn(ranks, generator=gen, device=device)
        for i, (r, tau) in enumerate(zip(ranks, op["decay"])):
            d = torch.exp(-torch.arange(r, device=device,
                                        dtype=torch.float32) / tau)
            view = [1] * len(ranks)
            view[i] = r
            core.mul_(d.view(view))
        core.mul_(op["scale"])
        factors = [torch.randn(n, r, generator=gen, device=device)
                   / math.sqrt(n) for n, r in zip(shape, ranks)]
        right = core
        del core
        for i in range(1, len(shape)):
            right = _mode_mul(right, factors[i], i)
        right = right.reshape(ranks[0], -1)
        a = torch.empty(shape, device=device)
        flat = a.view(shape[0], -1)
        noise = operands.generator(operands.mix(seed, 1), device)
        for r0 in range(0, shape[0], op["block"]):
            blk = flat[r0:r0 + op["block"]]
            blk.normal_(generator=noise)
            if op["noise"] != 1.0:
                blk.mul_(op["noise"])
            blk.addmm_(factors[0][r0:r0 + op["block"]], right)
        del right
    return a


def build(wl: dict, cfg: dict, seed: int, device, rank: int = 0,
          mesh=None):
    """(the tensor the entry reads, the same tensor for the reference)."""
    a = planted(cfg["operand"], seed, device)
    return a, a


# -- one call's output ----------------------------------------------------

def sample(out):
    """(core and factors kept for the check, 0-d non-finite flag on the
    device, False: ``tucker`` has no health verdict)."""
    core, factors = out
    total = core.sum() + sum(f.sum() for f in factors)
    return dict(core=core, factors=list(factors)), ~torch.isfinite(total), \
        False


# -- the readings ---------------------------------------------------------

def _eps(a_sq: float, core) -> float:
    g_sq = float(torch.sum(torch.square(core.to(F64))))
    return math.sqrt(max(a_sq - g_sq, 0.0) / a_sq)


def _lead(u, ur, k0: int) -> float:
    """||P_k0 - P_r,k0||_F / sqrt(k0) of the leading k0 columns."""
    u = u[:, :k0].to(device=ur.device, dtype=F64)
    ur = ur[:, :k0].to(F64)
    sq = (torch.sum(torch.square(u.T @ u)) + k0
          - 2.0 * torch.sum(torch.square(u.T @ ur)))
    return float(torch.sqrt(torch.clamp(sq, min=0.0))) / math.sqrt(k0)


def _fit(held, core, factors, a_sq: float) -> float:
    """||A - [G; U]||_F / ||A|| in f64: ||A||^2 - 2 <A, [G; U]> +
    <[G; U], [G; U]>, never building [G; U]."""
    sq = (a_sq - 2.0 * tucker_f64.held_inner(held, core, factors)
          + tucker_f64.inner(core, factors, core, factors))
    return math.sqrt(max(sq, 0.0) / a_sq)


def _orth(factors) -> float:
    """max_i ||U_i^T U_i - I||_F / sqrt(r_i), in f64."""
    worst = 0.0
    for u in factors:
        u = u.to(F64)
        eye = torch.eye(u.shape[1], dtype=F64, device=u.device)
        worst = max(worst, float(torch.linalg.norm(u.T @ u - eye))
                    / math.sqrt(u.shape[1]))
    return worst


def gaps(core, factors, ref: tucker_f64.Result, a_sq: float,
         held) -> dict:
    """The readings (and ``eps_ref``) of one call's output against the
    reference's; NaN where the shapes disagree."""
    nan = float("nan")
    eps_r = _eps(a_sq, ref.core)
    if tuple(core.shape) != tuple(ref.core.shape) or any(
            tuple(u.shape) != tuple(ur.shape)
            for u, ur in zip(factors, ref.factors)):
        return dict(err_gap=nan, fit_gap=nan, orth_gap=nan, lead_gap=nan,
                    eps_ref=eps_r)
    lead = 0.0
    for u, ur, w in zip(factors, ref.factors, ref.spectra):
        r = ur.shape[1]
        s = torch.sqrt(torch.clamp(w, min=0.0))
        k0 = compare.lead_cut(s, r) if r < s.numel() else r
        lead = check.worst(lead, _lead(u, ur, k0))
    return dict(err_gap=abs(_eps(a_sq, core) - eps_r) / eps_r,
                fit_gap=abs(_fit(held, core, factors, a_sq) - eps_r) / eps_r,
                orth_gap=_orth(factors), lead_gap=lead, eps_ref=eps_r)


def _fold(acc: dict, new: dict):
    for key, val in new.items():
        acc[key] = check.worst(acc.get(key), val)


def readings(wl: dict, cfg: dict, samples, held, seed: int, device,
             comm, control=None):
    """{number: worst reading over the samples} of the program's core
    and factors against the reference at the cell's
    ``reference.operand`` numerics, each sample's reference taking the
    program's factor signs (``tucker_f64``'s ``gauge``); with
    ``control`` also the reference at those numerics, in the reference's
    gauge, read against it: (program, control)."""
    s = cfg["settings"]
    a_sq = tucker_f64.norm_sq(held)
    numerics = wl["reference"]["operand"]
    prog, ctl = {}, {}
    for smp in samples:
        ref = tucker_f64.sthosvd(held, s["ranks"], s["p"], s["q"],
                                 smp["seed"], numerics, smp["factors"])
        _fold(prog, gaps(smp["core"], smp["factors"], ref, a_sq, held))
        if control is not None:
            low = tucker_f64.sthosvd(held, s["ranks"], s["p"], s["q"],
                                     smp["seed"], control, ref.factors)
            _fold(ctl, gaps(low.core, low.factors, ref, a_sq, held))
            del low
        del ref
    return prog if control is None else (prog, ctl)


# -- least time -----------------------------------------------------------

def mode_passes(shape, ranks, p: int):
    """[(mode, n, rest, l, r)] in the order the program takes the modes,
    with the effective ranks (``tucker_f64.effective_ranks``)."""
    eff = tucker_f64.effective_ranks(shape, ranks)
    cur, out = list(shape), []
    for mode in tucker_f64.order(shape):
        n = cur[mode]
        rest = math.prod(cur) // n
        l = min(eff[mode] + p, n, rest)
        out.append((mode, n, rest, l, eff[mode]))
        cur[mode] = eff[mode]
    return out


def products_work(shape, ranks, p: int, q: int, itemsize: int = 4):
    """(operations, bytes) of a call's stage-A and tightening products at
    the tensor's width: in each mode the sketch X Omega, q rounds of
    X^T Q and X Z, B = Q^T X, its Gram B B^T and C = U^T X, each reading
    its operands once and writing its output once."""
    ops = nbytes = 0.0
    for _, n, rest, l, r in mode_passes(shape, ranks, p):
        x = n * rest
        passes = [(l, rest * l, n * l)]                     # X Omega
        passes += [(l, n * l, rest * l), (l, rest * l, n * l)] * q
        passes += [(l, n * l, l * rest), (r, n * r, r * rest)]  # B, C
        for width, panel, written in passes:
            ops += 2.0 * x * width
            nbytes += itemsize * (x + panel + written)
        ops += 2.0 * l * l * rest                           # B B^T
        nbytes += itemsize * (l * rest + l * l)
    return ops, nbytes


def least(wl: dict, cfg: dict, world: int):
    """(least seconds, bound-by) of one call's products at the f32 peak
    (IEEE f32 at 'highest')."""
    s, op = cfg["settings"], cfg["operand"]
    ops, nbytes = products_work(op["shape"], s["ranks"], s["p"], s["q"])
    return roofline.bound(ops, nbytes, "fp32")
