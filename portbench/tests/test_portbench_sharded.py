"""The four-rank cell on the CPU: four processes over gloo at a tiny
size, as ``run.py`` starts them on four cards over NCCL.  A sound run is
correct; with the exchange between ranks left out (every all-reduce
returns its own rank's part) it is not."""

from __future__ import annotations

import io
import multiprocessing as mp

import pytest

from portbench.tests.conftest import make_tiny_root

WORKLOAD = "dense_400k_rows.sharded4"


def _rank(rank, port, root, fault, queue):
    import torch
    torch.set_num_threads(1)
    from portbench import run
    if fault:
        from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
        collectives.all_reduce = \
            lambda t, group=None, op="sum": t.contiguous()
    args = run.parse(["--workload", WORKLOAD, "--seed", "3000000077",
                      "--seconds", "0.5", "--trace", "0"])
    res = run.run_rank(rank, 4, args, port, device="cpu", backend="gloo",
                       root=root, out=io.StringIO())
    queue.put((rank, res))


@pytest.mark.parametrize("fault", [False, True],
                         ids=["sound", "exchange_left_out"])
def test_four_ranks(tmp_path, fault):
    from portbench.run import _free_port
    root = make_tiny_root(tmp_path)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, str(root), fault,
                                             queue)) for r in range(4)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=240) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    assert all(p.exitcode == 0 for p in procs)
    res = got[0]
    assert all(got[r] is None for r in (1, 2, 3))
    assert res["device"]["count"] == 4
    assert res["correct"] is (not fault)
