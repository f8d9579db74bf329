"""Low-rank image compression: the JAX package's ``apps/image.py`` on the
card.

Grayscale or RGB load/save (PIL, imported when used), downscale/upscale,
[0, 1] normalization, rSVD compression (whole image, per color channel
with one shared sketch, or per tile), the uint8 factor file (RSV2 layout,
byte for byte the JAX package's, through the host codec of ``native/``),
the reference's raw ``.dat`` layout, reconstruction, the compression
ratio mn / (l (m + n + 1)) and PSNR.  Factors come back as numpy arrays,
as in the JAX package; the factorizations run on ``device`` (the card
unless the caller names another).

Where JAX maps one compiled program over channels, tiles or frames
(``lax.map``), a Python loop runs :func:`rsvd_with_omega` per matrix.
With ``mesh=`` (a ``DeviceMesh``) the tiles or frames are split over
the mesh's first axis when their count divides (the tiles: every rank
of the mesh; the frames: the first axis), each rank factoring its own
with the Householder QR, as the JAX package's vmapped sharded run does,
and with the sketch of the one-card call.  The factorizations
communicate nothing; the factors come back whole on every rank, as the
JAX package's host arrays do, by one counted all-gather a factor over
the first axis.  Otherwise every rank runs the one-card path.
The Tucker video codec runs the randomized Tucker of ``rsvd/tucker.py``.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import (
    from_numpy,
    to_numpy,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.mesh import row_sharding
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
    fold_in_shard,
    key_from_seed,
    sketch_matrix,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.native import get_codec
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    rsvd,
    rsvd_with_omega,
)

_MAGIC = b"RSV2"
_MODES = {"affine": 0, "truncate": 1}


def _device(device) -> torch.device:
    return torch.device(device or "cuda")


def _mesh_split(mesh, count: int, whole_mesh: bool):
    """(first, last) of this rank's block of ``count`` tiles or frames on
    ``mesh``'s first axis, or None (every rank runs all of them) when
    there is no mesh or ``count`` does not divide the mesh's ranks
    (``whole_mesh``) or its first axis' ranks."""
    if mesh is None:
        return None
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh= takes a torch DeviceMesh, not "
                        f"{type(mesh).__name__}")
    if count % (mesh.size() if whole_mesh else mesh.size(0)):
        return None
    per = count // mesh.size(0)
    first = mesh.get_local_rank(0) * per
    return first, first + per


def _stacked_numpy(factors, mesh=None):
    """((U_i, s_i, V_i) per matrix) -> numpy (U, s, V) stacked on axis 0;
    with ``mesh``, the factors of this rank's block, gathered in order
    over the mesh's first axis."""
    stacked = (torch.stack(parts) for parts in zip(*factors))
    if mesh is None:
        return tuple(to_numpy(t) for t in stacked)
    group = mesh.get_group(0)
    return tuple(to_numpy(collectives.all_gather(t, group)) for t in stacked)


@dataclass
class TileFactors:
    """Per-tile factor triple for tiled compression.

    ``shape`` is the original (pre-padding) image shape: non-dividing
    grids pad with edge replication and reconstruction crops back."""

    u: np.ndarray  # (tiles, th, l)
    s: np.ndarray  # (tiles, l)
    v: np.ndarray  # (tiles, tw, l)
    grid: Tuple[int, int]
    shape: Optional[Tuple[int, int]] = None


class Image:
    """Grayscale or RGB image container and low-rank codec."""

    def __init__(self, data: Optional[np.ndarray] = None):
        self._data = None if data is None else np.asarray(data,
                                                          dtype=np.float64)
        self._normalized = False
        self.U = self.S = self.V = None
        self.tile_factors: Optional[TileFactors] = None
        # device layout of the last tiled run's factor batch, as the JAX
        # package keeps it (its multichip dry run reads it)
        self.last_tile_sharding = None

    # -- I/O ------------------------------------------------------------
    @classmethod
    def load(cls, path: str, color: bool = False) -> "Image":
        """Load any PIL-readable image as float: grayscale by default, RGB
        with ``color=True``."""
        from PIL import Image as PILImage

        img = PILImage.open(path).convert("RGB" if color else "L")
        return cls(np.asarray(img, dtype=np.float64))

    @property
    def is_color(self) -> bool:
        return self._data.ndim == 3

    def save(self, path: str) -> None:
        from PIL import Image as PILImage

        data = self._data
        if self._normalized:
            data = data * 255.0
        arr = np.clip(np.round(data), 0, 255).astype(np.uint8)
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        # a 2-D uint8 array is mode "L", an (h, w, 3) one "RGB"
        PILImage.fromarray(arr).save(path)

    # -- geometry / scaling ---------------------------------------------
    @property
    def data(self) -> np.ndarray:
        return self._data

    @property
    def shape(self):
        return self._data.shape

    def downscale(self, factor: int = 2) -> "Image":
        """Strided subsampling."""
        self._data = self._data[::factor, ::factor]
        return self

    def upscale(self, factor: int = 2) -> "Image":
        """Block replication."""
        self._data = self._data.repeat(factor, axis=0).repeat(factor, axis=1)
        return self

    def normalize(self) -> "Image":
        """Scale pixels to [0, 1]."""
        if not self._normalized:
            self._data = self._data / 255.0
            self._normalized = True
        return self

    def denormalize(self) -> "Image":
        """Back to [0, 255]."""
        if self._normalized:
            self._data = self._data * 255.0
            self._normalized = False
        return self

    # -- compression -----------------------------------------------------
    def compress(self, k: int = -1, p: int = 10, q: int = 1, seed: int = 0,
                 dtype=torch.float32, device=None) -> "Image":
        """Whole-image rSVD (default k = min(m, n) / 4, p = 10, q = 1).
        Color images compress per channel with one shared sketch drawn
        from ``seed``."""
        dev = _device(device)
        m, n = self._data.shape[:2]
        if k < 0:
            k = min(m, n) // 4
        if self.is_color:
            chans = from_numpy(np.moveaxis(self._data, 2, 0), device=dev,
                               dtype=dtype)
            l = min(k + p, min(m, n))
            omega = sketch_matrix(key_from_seed(seed, dev), n, l, dtype)
            self.U, self.S, self.V = _stacked_numpy(
                rsvd_with_omega(c, omega, q=q, k=k) for c in chans)
        else:
            a = from_numpy(self._data, device=dev, dtype=dtype)
            self.U, self.S, self.V = (to_numpy(x) for x in
                                      rsvd(a, k=k, p=p, q=q, seed=seed))
        self.tile_factors = None
        return self

    def compress_tiled(self, k: int, grid: Tuple[int, int] = (2, 2),
                       p: int = 10, q: int = 1, seed: int = 0,
                       dtype=torch.float32, mesh=None,
                       device=None) -> "Image":
        """Tile-parallel compression: split into ``grid`` tiles and run an
        independent rSVD per tile, tile i sketching with a stream of its
        own (``fold_in_shard(key, i)``).  Grids that do not divide the
        image pad with edge replication, and reconstruction crops back.

        ``mesh`` (a ``DeviceMesh``) splits the tiles over its first axis
        when their count divides the mesh's ranks (the module docstring);
        ``last_tile_sharding`` then holds their placements on the mesh,
        and stays None when every rank ran every tile."""
        if self.is_color:
            raise ValueError("tiled compression supports grayscale only; "
                             "use compress() for color images")
        dev = _device(device)
        gy, gx = grid
        m, n = self._data.shape
        th, tw = -(-m // gy), -(-n // gx)
        data = self._data
        pad_m, pad_n = gy * th - m, gx * tw - n
        if pad_m or pad_n:
            data = np.pad(data, ((0, pad_m), (0, pad_n)), mode="edge")
        tiles = (
            data
            .reshape(gy, th, gx, tw)
            .swapaxes(1, 2)
            .reshape(gy * gx, th, tw)
        )
        l = min(k + p, min(th, tw))
        key = key_from_seed(seed, dev)
        split = _mesh_split(mesh, gy * gx, whole_mesh=True)
        first, last = split or (0, gy * gx)
        tiles_dev = from_numpy(tiles[first:last], device=dev, dtype=dtype)
        # a split run factors with Householder QR, as the JAX package's
        # vmapped one does (a lax.cond under vmap runs both branches)
        qr = dict(qr_method="householder") if split else {}
        u, s, v = _stacked_numpy(
            (rsvd_with_omega(t, sketch_matrix(fold_in_shard(key, i), tw, l,
                                              dtype), q=q, k=k, **qr)
             for i, t in enumerate(tiles_dev, start=first)),
            mesh if split else None)
        self.tile_factors = TileFactors(u, s, v, (gy, gx), (m, n))
        self.last_tile_sharding = (
            row_sharding(mesh, mesh.mesh_dim_names[0]) if split else None)
        self.U = self.S = self.V = None
        return self

    def reconstruct(self) -> np.ndarray:
        """U diag(S) V^T, or the tile-wise assembly."""
        if self.tile_factors is not None:
            tf = self.tile_factors
            gy, gx = tf.grid
            tiles = np.einsum("bik,bk,bjk->bij", tf.u, tf.s, tf.v)
            th, tw = tiles.shape[1:]
            full = (
                tiles.reshape(gy, gx, th, tw).swapaxes(1, 2)
                .reshape(gy * th, gx * tw)
            )
            if tf.shape is not None:  # crop any edge-replication padding
                full = full[: tf.shape[0], : tf.shape[1]]
            return full
        if self.U is None:
            raise RuntimeError("compress() first")
        if self.U.ndim == 3:  # color: (3, m, k) x (3, k) x (3, n, k)
            rec = np.einsum("cik,ck,cjk->cij", self.U, self.S, self.V)
            return np.moveaxis(rec, 0, 2)
        return (self.U * self.S[None, :]) @ self.V.T

    def restore(self) -> "Image":
        self._data = self.reconstruct()
        return self

    def compression_ratio(self) -> float:
        """mn / (l (m + n + 1)); for tiled or color factors, pixels over
        the total element count of the factors."""
        m, n = self._data.shape[:2]
        pixels = self._data.size
        if self.tile_factors is not None:
            tf = self.tile_factors
            return pixels / (tf.u.size + tf.s.size + tf.v.size)
        if self.U is None:
            raise RuntimeError("compress() first")
        if self.U.ndim == 3:
            return pixels / (self.U.size + self.S.size + self.V.size)
        l = self.S.shape[0]
        return m * n / (l * (m + n + 1))

    def psnr(self, other: Optional[np.ndarray] = None) -> float:
        """Peak signal-to-noise ratio of the reconstruction against the
        image (or ``other``)."""
        ref = self._data if other is None else np.asarray(other)
        rec = self.reconstruct()
        peak = 1.0 if self._normalized else 255.0
        mse = float(np.mean((ref - rec) ** 2))
        return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak
                                                             / mse)

    # -- serialization ---------------------------------------------------
    def save_compressed(self, path: str, mode: str = "affine") -> None:
        """1-byte/entry factor file.  ``affine`` = reversible uint8
        quantization; ``truncate`` = the reference's bytes.

        Layout (v2): magic 'RSV2', mode u8, tiled u8, count i32,
        [if tiled: gy gx m n as i64 -- exact, not quantized], then per
        tensor: ndim i32, dims i64[ndim], scale f64, offset f64,
        payload u8[prod(dims)]."""
        if mode not in _MODES:
            raise ValueError(f"unknown mode {mode!r} (use 'affine' or "
                             "'truncate')")
        factors = self._gather_factors()
        codec = get_codec()
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        tiled = self.tile_factors is not None
        with open(path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<BBi", _MODES[mode], 1 if tiled else 0,
                                len(factors)))
            if tiled:
                tf = self.tile_factors
                shape = tf.shape if tf.shape is not None else (-1, -1)
                f.write(struct.pack("<4q", *tf.grid, *shape))
            for arr in factors:
                arr64 = np.ascontiguousarray(arr, dtype=np.float64)
                f.write(struct.pack("<i", arr64.ndim))
                f.write(struct.pack(f"<{arr64.ndim}q", *arr64.shape))
                if mode == "affine":
                    q8, scale, offset = codec.quantize_affine(arr64)
                else:
                    scale, offset = 1.0, 0.0
                    q8 = codec.quantize_truncate(arr64)
                f.write(struct.pack("<dd", scale, offset))
                f.write(q8.tobytes())

    def load_compressed(self, path: str) -> "Image":
        codec = get_codec()
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic == b"RSV1":
                raise ValueError(
                    f"{path}: legacy RSV1 factor file (tile metadata was "
                    "quantized and unreliable); re-save with the current "
                    "version")
            if magic != _MAGIC:
                raise ValueError(f"{path}: not an {_MAGIC.decode()} factor "
                                 "file")
            mode, tiled, count = struct.unpack("<BBi", f.read(6))
            tile_header = None
            if tiled:
                tile_header = struct.unpack("<4q", f.read(32))
            factors = []
            for _ in range(count):
                (ndim,) = struct.unpack("<i", f.read(4))
                shape = struct.unpack(f"<{ndim}q", f.read(8 * ndim))
                scale, offset = struct.unpack("<dd", f.read(16))
                q8 = np.frombuffer(
                    f.read(int(np.prod(shape))), dtype=np.uint8
                ).reshape(shape)
                if mode == 0:
                    factors.append(codec.dequantize_affine(q8, scale, offset))
                else:
                    factors.append(codec.dequantize_truncate(q8))
        self._scatter_factors(factors, tile_header)
        return self

    # -- reference binary interop ---------------------------------------
    def save_compressed_reference(self, path: str) -> None:
        """Write the reference's binary factor layout: five native int32s
        ``rows_U cols_U size_S rows_V cols_V`` followed by row-major
        1-byte entries ``(int)value & 0xFF`` for U, S, V.  Faithful
        including the quirk that truncation wrecks factors whose entries
        are not integers in [0, 255]; use save_compressed() for a
        reversible codec."""
        if self.tile_factors is not None:
            raise ValueError("reference .dat layout holds a single 2-D "
                             "factor triple; tiled factors need "
                             "save_compressed()")
        u, s, v = self._gather_factors()
        if u.ndim != 2:
            raise ValueError("reference .dat layout is grayscale-only")
        header = np.array(
            [u.shape[0], u.shape[1], s.size, v.shape[0], v.shape[1]],
            dtype="<i4",
        )
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        with open(path, "wb") as f:
            f.write(header.tobytes())
            for arr in (u, s, v):
                f.write(_truncate_byte(arr).tobytes())

    def load_compressed_reference(self, path: str) -> "Image":
        """Read a reference-layout ``.dat`` factor file: each byte becomes
        ``double(unsigned char)``."""
        with open(path, "rb") as f:
            header = np.frombuffer(f.read(20), dtype="<i4")
            if header.size != 5 or np.any(header < 0):
                raise ValueError(f"{path}: not a reference factor file")
            rows_u, cols_u, size_s, rows_v, cols_v = (int(x) for x in header)
            total = rows_u * cols_u + size_s + rows_v * cols_v
            payload = np.frombuffer(f.read(total), dtype=np.uint8)
            if payload.size != total:
                raise ValueError(f"{path}: truncated reference factor file")
        u_end = rows_u * cols_u
        s_end = u_end + size_s
        self.U = payload[:u_end].astype(np.float64).reshape(rows_u, cols_u)
        self.S = payload[u_end:s_end].astype(np.float64)
        self.V = payload[s_end:].astype(np.float64).reshape(rows_v, cols_v)
        self.tile_factors = None
        return self

    def _gather_factors(self) -> List[np.ndarray]:
        if self.tile_factors is not None:
            tf = self.tile_factors
            return [tf.u, tf.s, tf.v]
        if self.U is None:
            raise RuntimeError("compress() first")
        return [self.U, self.S, self.V]

    def _scatter_factors(self, factors: List[np.ndarray],
                         tile_header=None) -> None:
        if tile_header is not None:
            gy, gx, m, n = tile_header
            shape = (m, n) if m >= 0 else None
            self.tile_factors = TileFactors(
                factors[0], factors[1], factors[2], (gy, gx), shape)
            self.U = self.S = self.V = None
        else:
            self.U, self.S, self.V = factors
            self.tile_factors = None


def compress_video(frames, k: int, p: int = 10, q: int = 1, seed: int = 0,
                   dtype=torch.float32, mesh=None, device=None):
    """Low-rank compression of a frame stack (T, H, W): per-frame rSVD
    with one shared sketch drawn from ``seed``.  Returns k-truncated host
    factors (U (T, H, k), S (T, k), V (T, W, k)).  ``mesh`` (a
    ``DeviceMesh``) splits the frames over its first axis when T divides
    that axis' ranks (the module docstring)."""
    dev = _device(device)
    frames = np.asarray(frames)
    t, h, w = frames.shape
    l = min(k + p, min(h, w))
    omega = sketch_matrix(key_from_seed(seed, dev), w, l, dtype)
    split = _mesh_split(mesh, t, whole_mesh=False)
    first, last = split or (0, t)
    stack = from_numpy(frames[first:last], device=dev, dtype=dtype)
    qr = dict(qr_method="householder") if split else {}
    return _stacked_numpy((rsvd_with_omega(f, omega, q=q, k=k, **qr)
                           for f in stack), mesh if split else None)


def reconstruct_video(u, s, v) -> np.ndarray:
    """Inverse of :func:`compress_video`: (T, H, W) frame stack."""
    return np.einsum("tik,tk,tjk->tij", np.asarray(u), np.asarray(s),
                     np.asarray(v))


def compress_video_tucker(frames, ranks, p: int = 10, q: int = 1,
                          seed: int = 0, dtype=torch.float32, device=None):
    """Tucker (ST-HOSVD) compression of a frame stack (T, H, W) with
    multilinear ``ranks = (rt, rh, rw)``, on ``device`` (the card unless
    the caller names another).

    Unlike :func:`compress_video` (independent per-frame factors), the
    Tucker core captures TEMPORAL redundancy too: storage is
    rt*rh*rw + T*rt + H*rh + W*rw floats, so for slowly varying video the
    same reconstruction error costs a fraction of per-frame rSVD.
    Returns host-side ``(core, (Ut, Uh, Uw))``."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.tucker import tucker

    core, factors = tucker(from_numpy(np.asarray(frames), device=_device(
        device), dtype=dtype), tuple(ranks), p=p, q=q, seed=seed)
    return to_numpy(core), tuple(to_numpy(f) for f in factors)


def reconstruct_video_tucker(core, factors, device=None) -> np.ndarray:
    """Inverse of :func:`compress_video_tucker`: (T, H, W) frame stack,
    contracted on ``device`` (the card unless the caller names
    another)."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.tucker import (
        tucker_reconstruct,
    )

    dev = _device(device)
    return to_numpy(tucker_reconstruct(
        from_numpy(core, device=dev),
        tuple(from_numpy(f, device=dev) for f in factors)))


def _truncate_byte(x: np.ndarray) -> np.ndarray:
    """The reference's byte mapping ``(char)(static_cast<int>(x) & 0xFF)``:
    truncate toward zero, keep the low byte."""
    return (np.ascontiguousarray(x, dtype=np.float64)
            .astype(np.int64) & 0xFF).astype(np.uint8)


def _quantize_affine_np(x: np.ndarray):
    """The JAX package's numpy stand-in for the affine codec, kept for
    reference; nothing here calls it.  It divides by ``scale`` where
    ``codec.cpp`` multiplies by ``1 / scale``, so its bytes can differ
    from the codec's by one level where (x - lo) / scale lands near a
    half-integer."""
    lo, hi = float(x.min()), float(x.max())
    scale = (hi - lo) / 255.0 or 1.0
    q = np.clip(np.rint((x - lo) / scale), 0, 255).astype(np.uint8)
    return q, scale, lo
