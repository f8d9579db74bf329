"""Shared pieces of the port's sharded-operand tests
(tests/test_torch_distributed_extensions.py, tests/test_torch_sharded_api.py
and tests/test_torch_sharded_api_apps.py): one P = 4 gloo ``RankGroup``
a test file, the port's sharded and single calls, the collectives
checks, and the JAX draws and signs patched into the port's single call
for parity with the JAX package on conftest's 8-device mesh.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.core.mesh import (
    shard_rows as jax_shard_rows,
)
from rsvd_kamaneh_raganato_terrana_tpu.rsvd import driver as jdriver
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import device as tdevice
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy

from _torch_ranks import RankGroup

RANKS = 4
RTOL = 1e-10
TUCKER_RTOL = 1e-9
ITER_RTOL = 1e-8
from_numpy = functools.partial(convert.from_numpy, device="cpu")


def _port(name):
    return importlib.import_module(
        "rsvd_kamaneh_raganato_terrana_tpu_torch." + name)


def _jax(name):
    return importlib.import_module("rsvd_kamaneh_raganato_terrana_tpu."
                                   + name)


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


def sharded(ranks, fn, *args, layouts=("rows",), **kwargs):
    """Rank 0's packed result of the port's ``fn`` on ``args`` placed by
    ``layouts`` over the four ranks, and its tally."""
    res = ranks.run("call", fn=fn, args=args, layouts=layouts, **kwargs)
    return res[0]["out"], res[0]["tally"]


def whole(x):
    """A packed DTensor's whole tensor, or the array as it is."""
    return x["whole"] if isinstance(x, dict) else x


def single(fn, *args, **kwargs):
    """The port's single-rank call on CPU tensors, as NumPy (tuples as
    lists)."""
    module, name = fn.split(":")
    out = getattr(_port(module), name)(
        *(from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a
          for a in args), **kwargs)
    return _numpy(out)


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    if isinstance(x, tuple):
        return [_numpy(v) for v in x]
    return x


def no_whole_gather(tally, a):
    """No all-gather of the call handed in a block as large as this
    rank's block of A."""
    g = tally.get("all_gather")
    assert g is None or g["bytes"] / g["calls"] < a.nbytes / RANKS


def shard_rows8(mesh8, a):
    return jax_shard_rows(jnp.asarray(a), mesh8)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def _queue(monkeypatch, module, name, values):
    """``module.name`` answering with ``values`` in order, one a call."""
    queue = [from_numpy(np.asarray(v)) for v in values]
    monkeypatch.setattr(module, name, lambda *a, **k: queue.pop(0))
    return queue


def _jax_omega(seed, n, l, dtype=None, kind="gaussian", device=None):
    return from_numpy(np.asarray(jdriver.generate_omega(
        int(seed), n, l, jnp.float64, kind)))


def _jax_signed_eigh(g):
    """The port's eigh, each eigenvector signed as ``jnp.linalg.eigh``'s
    of the same matrix (tests/test_torch_tucker_tt_cp.py)."""
    lam, vecs = tdevice.eigh(g)
    _, vj = jnp.linalg.eigh(jnp.asarray(to_numpy(g)))
    sign = np.where(np.sum(to_numpy(vecs) * np.asarray(vj), axis=0) < 0,
                    -1.0, 1.0)
    return lam, vecs * from_numpy(sign, dtype=vecs.dtype)
