"""Out-of-core (streaming) randomized SVD (the JAX package's
``rsvd/streaming.py``).

For a matrix too large for the card, A stays in host memory (a numpy
array, an ``np.memmap`` or a CPU tensor) and streams through the card in
row panels.  Every product runs on the card; the host only slices and,
with ``panel_dtype``, encodes.  Pass structure per power round (A is
m x n, panels of ``panel_rows``):

  Y = A Omega      one streamed pass: per panel Y_p = A_p Omega
  Z = A^T Q        one streamed pass: Z += A_p^T Q_p (Z, n x l, stays on
                   the card)
  Y = A Z_q        one streamed pass

The orthonormalizations (``linalg.qr.qr_reduced``: ``qr_method=
'cholqr1_fused'`` is kernel K1) and the l x n tail (``method=
'eigh_pallas'`` runs its eigh as kernel K3) work on small operands on
the card.  (2q + 2) streamed passes in all; ``finish='rowspace'`` takes
2q + 1, and :func:`rsvd_streaming_onepass` one (a two-sided sketch).

**Transfers.**  On the card, each host panel is copied by a worker
thread on a side ``torch.cuda.Stream`` from pinned memory (the panel
itself where the source is a pinned CPU tensor, else a pinned staging
buffer filled on the host), with ``non_blocking=True``; an event
recorded after the copy is what the compute stream waits on, and the
panel is marked used by the compute stream (``record_stream``) so the
caching allocator cannot hand its memory to the next copy while a GEMM
still reads it.  So the copy of panel i+1 overlaps the GEMMs on panel i.
``prefetch`` panels are in flight at most: before a copy is issued, the
host waits until the compute of the panel ``prefetch + 1`` back is done,
which bounds the card's memory at prefetch + 1 panels.

**Compressed panels** (``panel_dtype``): 'bfloat16' halves the bytes on
the wire (a host round-to-nearest-even cast, widened back on the card),
'int8' quarters them (per-ROW absmax scaling on the host, 1 byte an
entry and 4 bytes a row; dequantized on the card).  The card widens a
compressed panel to the compute dtype before its product, as the JAX
module does, so no int8 product (and no int32 accumulation) is
involved.  Host encodes use torch's CPU kernels; two workers encode when
``panel_dtype`` is set.

Inputs may also be a :class:`SynthesizedMatrix`, an implicit operator
whose panels are made by a function (on the card, typically): no host
copy, no encoding.

Checkpointing (``checkpoint_dir``): every finished streamed pass stores
its small result (``.npy``, moved to the host first), keyed by the
parameters and a fingerprint of the data; a resumed run replays only
the missing passes, and its factors equal an uninterrupted run's bit for
bit (every reduction here runs in a fixed order).

Entry points run on the card unless the caller passes ``device='cpu'``.
"""

from __future__ import annotations

import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import matmul_at
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.profiling import _sync
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
    gaussian,
    key_from_seed,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import qr_reduced
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.svd import (
    SVDMethod,
    svd as small_svd,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import _fold_weights


class SynthesizedMatrix:
    """An implicit m x n matrix whose row panels are computed on demand.

    ``panel_fn(start, rows)`` returns the dense rows ``[start,
    start + rows)`` as a tensor (on the card, or on the host) or a host
    array.  The streaming drivers treat it like a host array, minus the
    host-to-card copy when a panel is already on the card."""

    def __init__(self, shape: Tuple[int, int],
                 panel_fn: Callable[[int, int], torch.Tensor]):
        self.shape = tuple(shape)
        self._panel_fn = panel_fn

    def panel(self, start: int, rows: int):
        return self._panel_fn(start, rows)


def _panels(m: int, panel_rows: int):
    for start in range(0, m, panel_rows):
        yield start, min(panel_rows, m - start)


def _decode(a_panel, scale, dtype):
    """Widen a wire-compressed panel back to the compute dtype."""
    a = a_panel.to(dtype) if a_panel.dtype != dtype else a_panel
    if scale is not None:
        a = a * scale[:, None].to(dtype)
    return a


def _panel_matmul(a_panel, b, scale=None, precision=DOT_PRECISION):
    return matmul_at(_decode(a_panel, scale, b.dtype), b, precision)


def _panel_t_matmul_acc(acc, a_panel, q_panel, scale=None,
                        precision=DOT_PRECISION):
    # A_p = diag(scale) P  =>  A_p^T Q_p = P^T (diag(scale) Q_p): scaling
    # the SMALL operand (rows x l, not rows x n) costs rows * l flops
    a = a_panel.to(acc.dtype) if a_panel.dtype != acc.dtype else a_panel
    q = q_panel if scale is None else q_panel * scale[:, None].to(acc.dtype)
    return acc + matmul_at(a.T, q, precision)


def _host_tensor(x) -> torch.Tensor:
    """A CPU tensor viewing ``x`` (a numpy array, a memmap slice or a CPU
    tensor), not copied.  A read-only memmap is only ever read here, so
    torch's warning that it is not writable does not apply."""
    if isinstance(x, torch.Tensor):
        return x
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(x))


def _encode_panel(np_panel, panel_dtype):
    """Host-side wire compression of one row panel: (payload,
    per-row scale or None), CPU tensors.  'bfloat16' is a
    round-to-nearest-even cast (2 bytes an entry); 'int8' per-row absmax
    affine quantization, rounding half to even as ``np.rint`` (1 byte an
    entry + 4 bytes a row)."""
    if panel_dtype in ("bfloat16", "bf16"):
        return _host_tensor(np_panel).to(torch.bfloat16), None
    if panel_dtype == "int8":
        p = _host_tensor(np_panel)
        absmax = torch.amax(torch.abs(p), dim=1, keepdim=True)
        scale = torch.where(absmax > 0, absmax / 127.0,
                            torch.ones_like(absmax)).to(torch.float32)
        q = torch.round(p / scale).to(torch.int8)
        return q, scale[:, 0]
    raise ValueError(f"unknown panel_dtype {panel_dtype!r} "
                     "(use None, 'bfloat16' or 'int8')")


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """``t`` in page-locked host memory (itself if it is already)."""
    if t.is_pinned():
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _host_panel(a_src, span, dtype, panel_dtype, pin: bool):
    """(payload, scale) of one host panel, as CPU tensors: encoded with
    ``panel_dtype``, else cast to ``dtype``; in pinned memory when
    ``pin``.  A pinned source panel of the right dtype is used as it
    is."""
    start, rows = span
    x = a_src[start:start + rows]
    if panel_dtype is not None:
        payload, scale = _encode_panel(x, panel_dtype)
        if pin:
            payload = _pinned(payload)
            scale = None if scale is None else _pinned(scale)
        return payload, scale
    t = _host_tensor(x)
    if t.dtype == dtype and (not pin or t.is_pinned()):
        return t, None
    out = torch.empty(t.shape, dtype=dtype, pin_memory=pin)
    out.copy_(t)
    return out, None


def _stream_panels(a_src, panel_rows, dtype, prefetch: int = 2,
                   panel_dtype=None, device=None):
    """Yield (start, rows, device_panel, scale), the next panels' host
    slice, encode and copy running ahead on worker threads (the module
    docstring's transfers).  ``scale`` is the per-row dequantization
    factor of an int8 panel, else None.  :class:`SynthesizedMatrix`
    panels are made in order on the calling thread and never encoded."""
    device = torch.device(device or "cuda")
    m = a_src.shape[0]
    spans = list(_panels(m, panel_rows))
    if hasattr(a_src, "panel"):
        for start, rows in spans:
            p = a_src.panel(start, rows)
            if not isinstance(p, torch.Tensor):
                p = _host_tensor(p)
            yield start, rows, p.to(device=device, dtype=dtype), None
        return
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def load(span):
        payload, scale = _host_panel(a_src, span, dtype, panel_dtype, cuda)
        if not cuda:
            return payload.to(device), (None if scale is None
                                        else scale.to(device)), None
        with torch.cuda.stream(side):
            dev = payload.to(device, non_blocking=True)
            dscale = (None if scale is None
                      else scale.to(device, non_blocking=True))
            ready = torch.cuda.Event()
            ready.record(side)
        return dev, dscale, ready

    # Two workers when encoding: the host encode of panel i+2 overlaps
    # the copy of panel i+1.  Results are consumed in submit order.
    workers = 2 if panel_dtype is not None else 1
    done = []                       # compute-done events, one a panel
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futures = []
        idx = 0
        while futures or idx < len(spans):
            while idx < len(spans) and len(futures) < prefetch:
                if cuda and idx > prefetch:
                    # bound the card's memory at prefetch + 1 panels
                    done[idx - prefetch - 1].synchronize()
                futures.append((spans[idx], ex.submit(load, spans[idx])))
                idx += 1
            (start, rows), fut = futures.pop(0)
            panel, scale, ready = fut.result()
            if cuda:
                compute = torch.cuda.current_stream(device)
                compute.wait_event(ready)
                panel.record_stream(compute)
                if scale is not None:
                    scale.record_stream(compute)
            yield start, rows, panel, scale
            if cuda:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(device))
                done.append(ev)


def _stream_right_multiply(a_src, b_dev, panel_rows, dtype,
                           precision=DOT_PRECISION, panel_dtype=None):
    """Y = A B, streaming A by row panels; Y is assembled on the card."""
    chunks = []
    for _, _, panel, scale in _stream_panels(
            a_src, panel_rows, dtype, panel_dtype=panel_dtype,
            device=b_dev.device):
        chunks.append(_panel_matmul(panel, b_dev, scale,
                                    precision=precision))
    return torch.cat(chunks, dim=0)


def _stream_left_t_multiply(a_src, q_dev, panel_rows, dtype,
                            precision=DOT_PRECISION, panel_dtype=None):
    """Z = A^T Q, streaming A by row panels; Z (n x l) accumulates on the
    card, panel after panel."""
    n = a_src.shape[1]
    acc = torch.zeros((n, q_dev.shape[1]), dtype=dtype,
                      device=q_dev.device)
    for start, rows, panel, scale in _stream_panels(
            a_src, panel_rows, dtype, panel_dtype=panel_dtype,
            device=q_dev.device):
        acc = _panel_t_matmul_acc(acc, panel, q_dev[start:start + rows],
                                  scale, precision=precision)
    return acc


def _default_panel_rows(m, n, dtype):
    """~256 MB panels."""
    return max(1, min(m, (256 << 20) // max(1, n * dtype.itemsize)))


def _tail_svd(b, q_mat, method: str):
    u_t, s, v = small_svd(b, method)
    return matmul_at(q_mat, u_t, DOT_PRECISION), s, v


def _tail_utv(z, q_mat, qr_method: str):
    """UTV serving tail from the streamed co-range block Z = A^T Q
    (n x l): B = Q^T A = L V^T by a thin QR of Z = B^T, the triangular
    middle folded into the weights; no l x l eigh (the driver's
    finish='utv' contract: s are weights, U has unit columns)."""
    v, r = qr_reduced(z, qr_method)
    el = r.T                                       # B = L V^T
    s, safe = _fold_weights(el)
    u = matmul_at(q_mat, el / safe[None, :], DOT_PRECISION)
    order = torch.argsort(-s, stable=True)
    return u[:, order], s[order], v[:, order]


def _tail_rowspace_utv(c, z_q, qr_method: str):
    """The last pass C = A Z_q factored by one thin QR (no eigh):
    A ~ (Q_c T / ||T_col||) diag(||T_col||) Z_q^T (the driver's
    finish='rowspace_utv' contract)."""
    q_c, t = qr_reduced(c, qr_method)
    s, safe = _fold_weights(t)
    u = matmul_at(q_c, t / safe[None, :], DOT_PRECISION)
    order = torch.argsort(-s, stable=True)
    return u[:, order], s[order], z_q[:, order]


def _onepass_solve(q_mat, psi, w, method: str):
    p_mat = matmul_at(psi.T, q_mat, DOT_PRECISION)              # s x l
    qp, rp = qr_reduced(p_mat, "householder")
    x = torch.linalg.solve_triangular(
        rp, matmul_at(qp.T, w, DOT_PRECISION), upper=True)      # l x n
    u_t, sv, v = small_svd(x, method)
    return matmul_at(q_mat, u_t, DOT_PRECISION), sv, v


class _PhaseClock:
    """Optional per-phase wall timing: waits for the card at each mark
    (``core/profiling.py::_sync`` on the phase's results), so that each
    bucket holds its own phase's work."""

    def __init__(self, sink: Optional[dict]):
        self._sink = sink
        self._t = time.perf_counter() if sink is not None else 0.0

    def mark(self, name: str, *arrays):
        if self._sink is None:
            return
        _sync(arrays)
        now = time.perf_counter()
        self._sink[name] = self._sink.get(name, 0.0) + (now - self._t)
        self._t = now


def _host_row(row) -> np.ndarray:
    """One row (1 x n) as a host f64 numpy array."""
    if isinstance(row, torch.Tensor):
        return to_numpy(row).astype(np.float64)
    return np.asarray(row, np.float64)


def _data_fingerprint(a_host) -> str:
    """Cheap identity fingerprint of the input, stored in the checkpoint
    meta so that identical hyperparameters on DIFFERENT data at the same
    ``checkpoint_dir`` invalidate the stale factors.

    memmaps are identified by (path, size, mtime): no read.  Other
    inputs hash a fixed sample of entries (3 rows, <= 64 strided entries
    each, as f64 bytes)."""
    import hashlib
    import os

    m, n = a_host.shape
    fname = getattr(a_host, "filename", None)
    if isinstance(a_host, np.memmap) and fname:
        st = os.stat(fname)
        return (f"memmap:{os.path.abspath(fname)}"
                f":{st.st_size}:{st.st_mtime_ns}")
    h = hashlib.sha1(f"{m}x{n}".encode())
    step = max(1, n // 64)
    for i in sorted({0, m // 2, m - 1}):
        if hasattr(a_host, "panel"):          # SynthesizedMatrix protocol
            row = a_host.panel(i, 1)
        else:
            row = a_host[i:i + 1]
        row = _host_row(row)[0, ::step][:64]
        h.update(row.tobytes())
    return "sample:" + h.hexdigest()


class _StreamCheckpoint:
    """Pass-level checkpoints of the streamed driver: each finished
    streamed pass saves its small result, so a killed run resumes from
    the last finished pass.  Stale checkpoints (any parameter or
    data-fingerprint mismatch) are deleted and overwritten; only
    l-sized factors are stored."""

    def __init__(self, directory: str, meta: dict, device):
        import json
        import os

        self._dir = directory
        self._device = device
        os.makedirs(directory, exist_ok=True)
        self._meta_path = os.path.join(directory, "meta.json")
        meta = {k: str(v) for k, v in meta.items()}
        self._valid = False
        if os.path.exists(self._meta_path):
            try:
                with open(self._meta_path) as f:
                    self._valid = json.load(f) == meta
            except Exception:  # noqa: BLE001 -- corrupt meta = no resume
                self._valid = False
        if not self._valid:
            for f in os.listdir(directory):
                if f.endswith(".npy") or f == "meta.json":
                    os.remove(os.path.join(directory, f))
            with open(self._meta_path, "w") as f:
                json.dump(meta, f)
            self._valid = True

    def _path(self, stage: str) -> str:
        import os

        return os.path.join(self._dir, f"{stage}.npy")

    def has(self, stage: str) -> bool:
        import os

        return os.path.exists(self._path(stage))

    def load(self, stage: str):
        import os

        path = self._path(stage)
        if os.path.exists(path):
            return torch.from_numpy(np.load(path)).to(self._device)
        return None

    def save(self, stage: str, arr) -> None:
        import os

        tmp = self._path(stage) + ".tmp"
        with open(tmp, "wb") as f:  # np.save(path) would append .npy
            np.save(f, to_numpy(arr))
        os.replace(tmp, self._path(stage))  # atomic: no torn files


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def rsvd_streaming(
    a_host,
    k: int,
    p: int = 16,
    q: int = 2,
    method=SVDMethod.Jacobi,
    panel_rows: Optional[int] = None,
    seed: int = 0,
    dtype=torch.float32,
    precision: str = "highest",
    phase_times: Optional[dict] = None,
    panel_dtype: Optional[str] = None,
    finish: str = "project",
    checkpoint_dir: Optional[str] = None,
    qr_method: str = "robust",
    device=None,
):
    """Rank-k rSVD of a host-resident (or implicit) matrix streamed
    through the card.

    ``a_host``: numpy array / ``np.memmap`` / CPU tensor (pinned for
    copies that overlap compute without a staging buffer) /
    :class:`SynthesizedMatrix` (m x n).  ``panel_rows`` defaults to
    ~256 MB panels.  ``precision`` is that of the streamed panel GEMMs.
    ``panel_dtype`` ('bfloat16' | 'int8') compresses the host-to-card
    copies.  ``finish='rowspace'`` (q >= 1) ends stage A at the last
    co-range block and factors C = A Z_q: 2q + 1 streamed passes instead
    of 2q + 2.  ``finish='utv'`` / ``'rowspace_utv'`` carry the serving
    tails out of core (thin-QR folds instead of the l x l eigh; s are
    weights, U has unit columns).  ``qr_method`` is every QR's variant
    on the streamed path ('cholqr1_fused' is kernel K1).  ``method`` is
    the tail's engine ('eigh_pallas' is kernel K3).
    ``checkpoint_dir`` enables pass-level resume.  Omega is the driver's
    ``generate_omega(seed)`` on ``device`` (the card unless named).
    Returns (U, s, V) on the card (m x k, k, n x k)."""
    method = SVDMethod.parse(method)
    device = torch.device(device or "cuda")
    m, n = a_host.shape
    l = min(k + p, min(m, n))
    if panel_rows is None:
        panel_rows = _default_panel_rows(m, n, dtype)
    if finish not in ("project", "rowspace", "utv", "rowspace_utv"):
        raise ValueError(f"unknown finish {finish!r}")
    rowspace_like = finish in ("rowspace", "rowspace_utv")
    if rowspace_like and q < 1:
        raise ValueError(f"finish={finish!r} needs q >= 1")
    ckpt = None
    if checkpoint_dir is not None:
        ckpt = _StreamCheckpoint(checkpoint_dir, {
            "m": m, "n": n, "k": k, "p": p, "q": q, "seed": seed,
            "dtype": _dtype_name(dtype), "precision": precision,
            "panel_dtype": panel_dtype, "finish": finish,
            "method": method.value, "qr_method": qr_method,
            "data": _data_fingerprint(a_host),
        }, device)

    omega = driver.generate_omega(seed, n, l, dtype, device=device)
    prec = precision
    clock = _PhaseClock(phase_times)
    # stage A: Y = A Omega, Q = qr(Y), q power refinements
    q_mat = ckpt.load("q0") if ckpt else None
    if q_mat is None:
        y = _stream_right_multiply(a_host, omega, panel_rows, dtype, prec,
                                   panel_dtype)
        clock.mark("sketch", y)
        q_mat, _ = qr_reduced(y, qr_method)
        clock.mark("qr", q_mat)
        if ckpt:
            ckpt.save("q0", q_mat)
    rounds = q - 1 if rowspace_like else q
    for i in range(rounds):
        cached = ckpt.load(f"round{i}") if ckpt else None
        if cached is not None:
            q_mat = cached
            continue
        z = _stream_left_t_multiply(a_host, q_mat, panel_rows, dtype, prec,
                                    panel_dtype)
        clock.mark("power_zt", z)
        z_q, _ = qr_reduced(z, qr_method)
        clock.mark("qr", z_q)
        y = _stream_right_multiply(a_host, z_q, panel_rows, dtype, prec,
                                   panel_dtype)
        clock.mark("power_y", y)
        q_mat, _ = qr_reduced(y, qr_method)
        clock.mark("qr", q_mat)
        if ckpt:
            ckpt.save(f"round{i}", q_mat)

    if rowspace_like:
        # final half-round: Z = A^T Q (pass 2q), orth, C = A Z_q (pass
        # 2q+1), then factor C directly: A ~ C Z_q^T
        z_q = ckpt.load("zq_final") if ckpt else None
        if z_q is None:
            z = _stream_left_t_multiply(a_host, q_mat, panel_rows, dtype,
                                        prec, panel_dtype)
            clock.mark("power_zt", z)
            z_q, _ = qr_reduced(z, qr_method)
            clock.mark("qr", z_q)
            if ckpt:
                ckpt.save("zq_final", z_q)
        c = ckpt.load("c_final") if ckpt else None
        if c is None:
            c = _stream_right_multiply(a_host, z_q, panel_rows, dtype, prec,
                                       panel_dtype)
            clock.mark("power_y", c)
            if ckpt:
                ckpt.save("c_final", c)
        if finish == "rowspace_utv":
            u, s, v = _tail_rowspace_utv(c, z_q, qr_method)
        else:
            # small_svd(c.T) gives c = v_small s u_t^T; _tail_svd's GEMM
            # then builds z_q @ u_t -- our V, while v_small is our U
            v, s, u = _tail_svd(c.T, z_q, method.value)
        clock.mark("tail", u, s, v)
        return u[:, :k], s[:k], v[:, :k]

    # stage B tail input: Z_b = A^T Q (n x l), streamed (= B^T)
    zb = ckpt.load("zb_final") if ckpt else None
    if zb is None:
        zb = _stream_left_t_multiply(a_host, q_mat, panel_rows, dtype, prec,
                                     panel_dtype)
        clock.mark("project", zb)
        if ckpt:
            ckpt.save("zb_final", zb)
    if finish == "utv":
        u, s, v = _tail_utv(zb, q_mat, qr_method)
    else:
        u, s, v = _tail_svd(zb.T, q_mat, method.value)
    clock.mark("tail", u, s, v)
    return u[:, :k], s[:k], v[:, :k]


def _panel_onepass(a_panel, omega, psi_panel, w_acc, scale=None,
                   precision=DOT_PRECISION):
    """One panel's range contribution Y_p = A_p Omega and co-range
    accumulation W += Psi_p^T A_p."""
    a = _decode(a_panel, scale, omega.dtype)
    y_p = matmul_at(a, omega, precision)
    w = w_acc + matmul_at(psi_panel.T, a, precision)
    return y_p, w


def _onepass_draws(seed, n: int, l: int, m: int, s: int, dtype, device):
    """(Omega n x l, Psi m x s), in that order from one generator seeded
    with ``seed`` on ``device``."""
    key = key_from_seed(seed, device)
    return gaussian(key, (n, l), dtype), gaussian(key, (m, s), dtype)


def rsvd_streaming_onepass(
    a_host,
    k: int,
    p: int = 16,
    s_factor: int = 2,
    method="eigh",
    panel_rows: Optional[int] = None,
    seed: int = 0,
    dtype=torch.float32,
    precision: str = "highest",
    phase_times: Optional[dict] = None,
    panel_dtype: Optional[str] = None,
    device=None,
):
    """Rank-k rSVD in a SINGLE streamed pass over A (the two-sided sketch
    of Tropp, Yurtsever, Udell & Cevher 2017):

      one pass:   Y = A Omega   (m x l range sketch)
                  W = Psi^T A   (s x n co-range sketch, s = s_factor l + 1)
      then        Q = orth(Y),  X = (Psi^T Q)^+ W,   A ~ Q X,
                  SVD(X) -> (U_t, sigma, V),  U = Q U_t.

    Accuracy is a constant factor behind one power iteration: the trade
    for reading A once over a slow link.  Runs on ``device`` (the card
    unless named)."""
    method = SVDMethod.parse(method)
    device = torch.device(device or "cuda")
    m, n = a_host.shape
    l = min(k + p, min(m, n))
    s = min(s_factor * l + 1, m)
    if panel_rows is None:
        panel_rows = _default_panel_rows(m, n, dtype)

    omega, psi = _onepass_draws(seed, n, l, m, s, dtype, device)
    clock = _PhaseClock(phase_times)
    w = torch.zeros((s, n), dtype=dtype, device=device)
    chunks = []
    for start, rows, panel, scale in _stream_panels(
            a_host, panel_rows, dtype, panel_dtype=panel_dtype,
            device=device):
        y_p, w = _panel_onepass(panel, omega, psi[start:start + rows], w,
                                scale, precision=precision)
        chunks.append(y_p)
    y = torch.cat(chunks, dim=0)
    clock.mark("sketch_pass", y, w)

    q_mat, _ = qr_reduced(y, "robust")
    u, sv, v = _onepass_solve(q_mat, psi, w, method.value)
    clock.mark("solve_tail", u, sv, v)
    return u[:, :k], sv[:k], v[:, :k]
