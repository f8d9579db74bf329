"""Embedding factorization and top-k inner-product retrieval (the JAX
package's ``apps/retrieval.py``).

Factor a user x item interaction matrix (dense, or sparse: a torch
sparse tensor goes through the driver's :class:`SparseStored` path) into
rank-k embedding tables -- U_k S_k for users, V_k for items -- with
:func:`rsvd`, then serve top-k item retrieval as an inner-product lookup:
f32 scores (:func:`score`, :func:`top_k_items`) or int8 tables with
per-row scales (:func:`quantize_tables`, :func:`score_quantized`), whose
int8 x int8 -> int32 product is the driver's (``torch._int_mm`` on the
card, operands padded to 16, contractions chunked past ~133,000 terms).

``torch.topk`` and ``jax.lax.top_k`` may order tied scores differently;
values agree, and ids wherever no tie exists.  :func:`top_k_items_sharded`
serves the items split over a device mesh.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import matmul_at
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    mesh_axis,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION,
    local_block,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    _int8_padded,
    _int8_product,
    rsvd,
)


class EmbeddingTables(NamedTuple):
    users: torch.Tensor   # (n_users, k) = U_k diag(S_k)
    items: torch.Tensor   # (n_items, k) = V_k
    sigma: torch.Tensor   # (k,)


def factorize_interactions(a, k: int, p: int = 16, q: int = 2,
                           method: str = "jacobi",
                           seed: int = 0) -> EmbeddingTables:
    """Rank-k embedding tables with <users[u], items[i]> ~ A[u, i]
    (U S V^T split as (U S) V^T).  A tensor (dense or sparse) stays on
    its device; any other array goes to the card."""
    u, s, v = rsvd(a, k=k, p=p, q=q, method=method, seed=seed)
    return EmbeddingTables(u * s[None, :], v, s)


def _ids(user_ids, device):
    """User ids as an int64 index tensor on ``device``."""
    if isinstance(user_ids, torch.Tensor):
        return user_ids.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(user_ids), dtype=torch.int64,
                           device=device)


def score(tables: EmbeddingTables, user_ids) -> torch.Tensor:
    """Dense score rows for a batch of users (one row for a scalar id)."""
    u = tables.users[_ids(user_ids, tables.users.device)]
    return matmul_at(u, tables.items.T, DOT_PRECISION)


def top_k_items(tables: EmbeddingTables, user_ids,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-card top-k retrieval: (scores, item ids), both (batch, k),
    scores descending."""
    return torch.topk(score(tables, user_ids), k)


class QuantizedTables(NamedTuple):
    """int8 embedding tables with per-row scales: a 4x memory cut for the
    serving path; scores from an int8 -> int32 product, then rescaled."""

    users_q: torch.Tensor      # (n_users, k) int8
    users_scale: torch.Tensor  # (n_users,)
    items_q: torch.Tensor      # (n_items, k) int8
    items_scale: torch.Tensor  # (n_items,)


def _quant_rows(x):
    """Symmetric per-row int8 quantization: (Q8, f32 scales)."""
    scale = torch.clamp(torch.amax(torch.abs(x), dim=1), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def quantize_tables(tables: EmbeddingTables) -> QuantizedTables:
    """Symmetric per-row int8 quantization of both embedding tables."""
    uq, us = _quant_rows(tables.users)
    iq, is_ = _quant_rows(tables.items)
    return QuantizedTables(uq, us, iq, is_)


def score_quantized(qt: QuantizedTables, user_ids) -> torch.Tensor:
    """Score rows from int8 tables: the exact int32 product of the int8
    rows, rescaled per user and per item.  Accepts a scalar id or a
    batch, like :func:`score`.  The item table is the product's big,
    row-major operand and the users' rows its small one (the driver's
    fast layout on the card)."""
    ids = _ids(user_ids, qt.users_q.device)
    scalar = ids.dim() == 0
    ids = ids.reshape(-1)
    uq = qt.users_q[ids]
    raw = _int8_product(_int8_padded(qt.items_q),
                        uq.T)[:qt.items_q.shape[0]].T
    out = (raw.to(torch.float32) * qt.users_scale[ids][:, None]
           * qt.items_scale[None, :])
    return out[0] if scalar else out


def top_k_items_quantized(qt: QuantizedTables, user_ids, k: int):
    """Top-k retrieval from the quantized tables."""
    return torch.topk(score_quantized(qt, user_ids), k)


def top_k_items_sharded(mesh, tables: EmbeddingTables, user_batch, k: int,
                        axis="rows") -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed retrieval: the items split over ``axis`` (the item
    table a row-sharded DTensor, or the whole table on every rank, whose
    block each rank takes); each rank scores its items, takes a local
    top-k with GLOBAL item ids, the (value, id) pairs are all-gathered
    (ranks x k a user instead of n_items) and a final top-k runs on every
    rank.  ``user_batch`` is the (batch, k_emb) slice of user embeddings,
    replicated (the query side of serving).  Returns (scores, item ids),
    (batch, k) each, the same on every rank."""
    ax = mesh_axis(mesh, axis)
    n_items = tables.items.shape[0]
    if n_items % ax.size:
        raise ValueError(f"n_items={n_items} must divide over {ax.size} "
                         "ranks (pad the item table)")
    items = local_block(tables.items, ax)
    blk = items.shape[0]
    scores = matmul_at(user_batch, items.T, DOT_PRECISION)
    vals, ids = torch.topk(scores, min(k, blk))
    ids = ids + ax.index * blk
    # (ranks, batch, k') -> (batch, ranks k'), rank-major as JAX's tiled
    # all_gather along axis 1
    all_vals = collectives.all_gather(vals[None], ax.group)
    all_ids = collectives.all_gather(ids[None], ax.group)
    all_vals = all_vals.permute(1, 0, 2).reshape(vals.shape[0], -1)
    all_ids = all_ids.permute(1, 0, 2).reshape(ids.shape[0], -1)
    final_vals, pos = torch.topk(all_vals, k)
    return final_vals, torch.gather(all_ids, 1, pos)
