"""Spectral clustering on the randomized eigensolver (the JAX package's
``apps/cluster.py``).

The spectral embedding is the top-k eigenspace of the normalized
affinity D^{-1/2} W D^{-1/2}, computed by the randomized symmetric
eigensolver (``rsvd/nystrom.py::reigh``) or, for small graphs, an exact
eigh (``core/device.py::eigh``, whose eigenvectors are orthogonal to
working precision as ``jnp.linalg.eigh``'s are); then row normalization
(Ng-Jordan-Weiss 2002) and Lloyd's k-means with a fixed iteration count
and greedy farthest-point initialization.

k-means keeps the JAX arithmetic, ``(z[:, None] - c[None]) ** 2`` summed
over the embedding axis: n k k entries, 4 MB at n = 16384 and k = 8 in
f32.  Its first centre comes from a ``torch.Generator`` seeded with
``seed`` (:func:`_first_center`); JAX's ``jax.random.randint`` stream
cannot be matched.  ``torch.topk`` (the k-NN graph) and
``jax.lax.top_k`` may pick differently among tied distances.  The
median heuristic of :func:`rbf_affinity` averages the two middle
distances of an even count, as ``jnp.nanmedian`` does (``torch.
nanmedian`` would take the lower one).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    eigh,
    matmul_at,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import key_from_seed
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    Sharded,
    row_dtensor,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _argmax,
    _local,
    _reduce,
    _row_split,
    _sharded_view,
    _take_rows,
    _transpose,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.nystrom import reigh


class ClusterResult(NamedTuple):
    labels: torch.Tensor      # int32[n]
    embedding: torch.Tensor   # n x k row-normalized spectral coordinates
    centers: torch.Tensor     # k x k k-means centres in embedding space
    inertia: torch.Tensor     # final within-cluster sum of squares


def _sq_dists(points):
    """||x_i||^2 + ||x_j||^2 - 2 <x_i, x_j> (not clamped)."""
    sq = torch.sum(points * points, dim=1)
    return (sq[:, None] + sq[None, :]
            - 2.0 * matmul_at(points, points.T, DOT_PRECISION))


def _median(x):
    """numpy's median of a flat tensor, as ``jnp.nanmedian`` forms it:
    0.5 lo + 0.5 hi of the two middle values of an even count."""
    n = x.numel()
    v = torch.sort(x).values
    lo = v[(n - 1) // 2]
    if n % 2:
        return lo
    return 0.5 * lo + 0.5 * v[n // 2]


def rbf_affinity(points, gamma: Optional[float] = None,
                 device=None) -> torch.Tensor:
    """W_ij = exp(-gamma ||x_i - x_j||^2), zero diagonal.  gamma defaults
    to 1/(2 median^2) of the pairwise distances off the diagonal (the
    median heuristic)."""
    points = as_tensor(points, device)
    d2 = torch.clamp(_sq_dists(points), min=0.0)
    n = d2.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)
    if gamma is None:
        med = _median(torch.sqrt(d2[~eye]))
        gamma_v = 1.0 / (2.0 * torch.clamp(med, min=1e-12) ** 2)
    else:
        gamma_v = gamma
    w = torch.exp(-gamma_v * d2)
    return w * (1.0 - eye.to(w.dtype))


def knn_affinity(points, n_neighbors: int = 10,
                 device=None) -> torch.Tensor:
    """Symmetrized k-nearest-neighbour connectivity graph (0/1 weights,
    W = max(W, W^T), zero diagonal): the locality graph that separates
    manifold-shaped clusters (two moons) where any full RBF kernel
    bridges the gap."""
    points = as_tensor(points, device)
    n = points.shape[0]
    d2 = _sq_dists(points)
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)
    d2 = torch.where(eye, torch.full_like(d2, float("inf")), d2)
    _, idx = torch.topk(-d2, min(n_neighbors, n - 1))
    w = torch.zeros((n, n), dtype=points.dtype, device=points.device)
    w.scatter_(1, idx, 1.0)
    return torch.maximum(w, w.T)


def _first_center(seed, n: int, device):
    """The index of k-means' first centre, uniform on [0, n)."""
    key = key_from_seed(seed, device)
    return torch.randint(0, n, (), generator=key, device=key.device)


def _kmeans(zs, k: int, iters: int, seed: int):
    """Lloyd's iterations after greedy farthest-point initialization:
    deterministic given (data, seed).  No host sync.  A row-split ``zs``
    (:class:`Sharded`) keeps its points and labels on their ranks: the
    farthest point is a global argmax, the chosen points come from the
    ranks that hold them, and each Lloyd step's centroid sums and counts
    are all-reduced."""
    z = _local(zs)
    n = zs.shape[0]
    centers = torch.zeros((k, z.shape[1]), dtype=z.dtype, device=z.device)
    centers[0] = _take_rows(zs, _first_center(seed, n, z.device)[None])[0]
    ar = torch.arange(k, device=z.device)
    inf = torch.tensor(float("inf"), dtype=z.dtype, device=z.device)
    for i in range(k - 1):
        d2_all = torch.sum((z[:, None, :] - centers[None, :, :]) ** 2,
                           dim=-1)                         # (n, k)
        chosen = (ar <= i)[None, :]
        dmin = torch.amin(torch.where(chosen, d2_all, inf), dim=1)
        centers[i + 1] = _take_rows(zs, _argmax(dmin, zs)[None])[0]
    labels = torch.zeros((z.shape[0],), dtype=torch.int32, device=z.device)
    for _ in range(iters):
        d2 = torch.sum((z[:, None, :] - centers[None, :, :]) ** 2, dim=-1)
        labels = torch.argmin(d2, dim=1).to(torch.int32)
        one_hot = torch.nn.functional.one_hot(
            labels.long(), k).to(z.dtype)
        hits = _reduce(torch.sum(one_hot, dim=0), zs)
        counts = torch.clamp(hits, min=1.0)
        new_centers = _reduce(matmul_at(one_hot.T, z, DOT_PRECISION),
                              zs) / counts[:, None]
        # keep empty clusters where they were
        centers = torch.where((hits > 0)[:, None], new_centers, centers)
    inertia = _reduce(torch.sum((z - centers[labels.long()]) ** 2), zs)
    return labels, centers, inertia


def spectral_cluster(
    points_or_affinity,
    n_clusters: int,
    affinity: str = "rbf",
    gamma: Optional[float] = None,
    n_neighbors: int = 10,
    kmeans_iters: int = 50,
    eig_solver: str = "auto",
    seed: int = 0,
    device=None,
) -> ClusterResult:
    """Normalized spectral clustering (Ng-Jordan-Weiss).

    ``affinity='rbf'`` treats the input as points (n x d) and builds the
    median-heuristic RBF graph; ``'knn'`` the symmetrized
    ``n_neighbors``-nearest-neighbour connectivity graph (for
    manifold-shaped clusters); ``'precomputed'`` takes a symmetric
    non-negative affinity matrix.

    ``eig_solver``: graph spectra are the randomized solver's worst
    case (the cluster-indicator eigenvalues sit at 1, the first mixing
    one can be 1 - O(1/n^2) away), so 'auto' takes the exact eigh up to
    n = 2048 and the randomized ``reigh`` above; force 'exact' for
    elongated chains.  A tensor stays on its device; any other array
    goes to ``device`` (the card unless named).

    A DTensor whose rows are sharded is read by its rows (points or the
    precomputed affinity): each rank builds its rows of W against the
    points gathered once (n x d, as kernel PCA gathers them), the median
    heuristic selects its two middle distances over the ranks
    (:func:`_median_split`), the knn graph reads W^T by one all-to-all,
    the degrees are gathered (n values), and the randomized ``reigh``
    runs on the row-split operator; 'auto' takes it at every n, since
    the exact eigh would need the n x n operator whole, and 'exact'
    refuses.  k-means keeps the embedding's rows on their ranks
    (:func:`_kmeans`).  The labels and the embedding come back
    row-sharded, equal to the single call's with
    ``eig_solver='randomized'``."""
    x = _row_split(points_or_affinity, device)
    if isinstance(x, Sharded):
        return _spectral_split(x, n_clusters, affinity, gamma, n_neighbors,
                               kmeans_iters, eig_solver, seed)
    if affinity == "rbf":
        w = rbf_affinity(x, gamma, device)
    elif affinity == "knn":
        w = knn_affinity(x, n_neighbors, device)
    elif affinity == "precomputed":
        w = x
    else:
        raise ValueError(f"unknown affinity {affinity!r}")
    d = torch.clamp(torch.sum(w, dim=1), min=1e-12)
    d_isqrt = 1.0 / torch.sqrt(d)
    m = w * d_isqrt[:, None] * d_isqrt[None, :]
    n = m.shape[0]
    mode = eig_solver
    if mode == "auto":
        mode = "exact" if n <= 2048 else "randomized"
    if mode == "exact":
        lam_all, u_all = eigh(m)                   # ascending
        lam = lam_all[-n_clusters:].flip(0)
        u = u_all[:, -n_clusters:].flip(1)
    elif mode == "randomized":
        # reigh selects by |lambda|: near-bipartite graphs put modes at
        # lambda ~ -1 that would displace the +1 indicator eigenvectors.
        # Shift to I + M (spectrum [0, 2]: magnitude order == algebraic
        # order), then shift the eigenvalues back.
        lam, u = reigh(m + torch.eye(n, dtype=m.dtype, device=m.device),
                       k=n_clusters, q=4, seed=seed)
        lam = lam - 1.0
        order = torch.argsort(-lam, stable=True)
        lam, u = lam[order], u[:, order]
    else:
        raise ValueError(f"unknown eig_solver {eig_solver!r}")
    z = u / torch.clamp(torch.linalg.norm(u, dim=1, keepdim=True),
                        min=1e-12)
    labels, centers, inertia = _kmeans(z, n_clusters, kmeans_iters, seed)
    return ClusterResult(labels, z, centers, inertia)


def _median_split(t, x, count: int):
    """``_median`` of the non-negative values spread over the ranks (this
    rank's ``t``, ``count`` of them in all), never gathered: each middle
    value is selected by its bit pattern, high bit first, a counted
    all-reduce of the ranks' counts a bit (non-negative floats order as
    their patterns), so the median is the single call's to the bit."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}[t.dtype]
    bits = (t.flatten() + 0.0).view(ints)             # -0.0 -> +0.0
    want = torch.tensor([(count - 1) // 2, count // 2], device=t.device)
    ans = torch.zeros(2, dtype=ints, device=t.device)
    for b in reversed(range(bits.element_size() * 8 - 1)):
        cand = ans + (1 << b)
        below = _reduce(torch.sum(bits[None, :] < cand[:, None], dim=1), x)
        ans = torch.where(below <= want, cand, ans)
    lo, hi = ans.view(t.dtype)
    return lo if count % 2 else 0.5 * lo + 0.5 * hi


def _spectral_split(x, n_clusters, affinity, gamma, n_neighbors,
                    kmeans_iters, eig_solver, seed):
    """:func:`spectral_cluster` of a row-split ``x`` (its docstring)."""
    n, rows = x.shape[0], x.local.shape[0]
    mine = torch.arange(rows, device=x.device)
    diag = (mine[:, None] + x.row_start
            == torch.arange(n, device=x.device)[None, :])   # this rank's I
    if affinity in ("rbf", "knn"):
        pts = x.gather()
        sq = torch.sum(pts * pts, dim=1)
        d2 = (torch.sum(x.local * x.local, dim=1)[:, None] + sq[None, :]
              - 2.0 * matmul_at(x.local, pts.T, DOT_PRECISION))
    if affinity == "rbf":
        d2 = torch.clamp(d2, min=0.0)
        if gamma is None:
            med = _median_split(torch.sqrt(d2[~diag]), x, n * (n - 1))
            gamma = 1.0 / (2.0 * torch.clamp(med, min=1e-12) ** 2)
        w = torch.exp(-gamma * d2) * (1.0 - diag.to(d2.dtype))
    elif affinity == "knn":
        d2 = torch.where(diag, torch.full_like(d2, float("inf")), d2)
        _, idx = torch.topk(-d2, min(n_neighbors, n - 1))
        w = torch.zeros_like(d2)
        w.scatter_(1, idx, 1.0)
        w = torch.maximum(w, _transpose(x.with_local(w)).local)
    elif affinity == "precomputed":
        w = x.local
    else:
        raise ValueError(f"unknown affinity {affinity!r}")
    d_isqrt = 1.0 / torch.sqrt(torch.clamp(torch.sum(w, dim=1), min=1e-12))
    d_all = x.with_local(d_isqrt[:, None]).gather()[:, 0]
    m = w * d_isqrt[:, None] * d_all[None, :]
    if eig_solver == "exact":
        raise ValueError("spectral_cluster of a row-sharded operand takes "
                         "the randomized eigensolver: the exact eigh "
                         "needs the n x n operator whole")
    if eig_solver not in ("auto", "randomized"):
        raise ValueError(f"unknown eig_solver {eig_solver!r}")
    lam, u = reigh(x.with_local(m + diag.to(m.dtype)), k=n_clusters, q=4,
                   seed=seed)
    u = _sharded_view(u)
    lam = lam - 1.0
    order = torch.argsort(-lam, stable=True)
    u = u.local[:, order]
    z = x.with_local(u / torch.clamp(
        torch.linalg.norm(u, dim=1, keepdim=True), min=1e-12))
    labels, centers, inertia = _kmeans(z, n_clusters, kmeans_iters, seed)
    return ClusterResult(row_dtensor(labels, z.mesh, z.rows, n),
                         z.to_dtensor(), centers, inertia)
