#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's runs).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--calls 2] [--no-control] [--set KEY=JSON ...]

For each seed, at the cell's own size and on its own path (a cell on
several cards starts one process a card, as ``run.py`` does): the
operand made from the seed by the cell's kind (``kinds/<kind>.py``), the
cell's entry called on the first ``--calls`` sketch seeds of a run
(those of calls 0, 1, ...), each call's output held to the kind's plain
reference (the program's readings), then the reference itself computed
at the control's lower precision in the program's place (the control's
readings: they have to come out above a limit).  One JSON line a seed on
standard output, then the largest program reading and the smallest
control reading of each number.
"""

from __future__ import annotations

import gc
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import argparse  # noqa: E402

from portbench import check, forms, loader, operands  # noqa: E402
from portbench.reference.operand import Comm, DistComm  # noqa: E402


def seed_readings(wl, cfg, seed, device, calls, control=True, rank=0,
                  mesh=None, comm=None, root=loader.ROOT):
    """(program readings, control readings or None) of one seed."""
    import torch
    comm = comm or Comm()
    kind = loader.kind(wl, root)
    operand, held = kind.build(wl, cfg, seed, device, rank, mesh)
    entry = forms.resolve(wl["entry"])
    kwargs = {**cfg["settings"], **wl["kwargs"]}
    samples = []
    for i in range(calls):
        s = operands.call_seed(seed, i)
        out = entry(operand, seed=s, **kwargs)
        samples.append(dict(seed=s, **kind.sample(out)[0]))
    del operand, out
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    if not control:
        return kind.readings(wl, cfg, samples, held, seed, device,
                             comm), None
    return kind.readings(wl, cfg, samples, held, seed, device, comm,
                         wl["reference"]["control"])


def _seeds(args, wl, cfg, device, rank=0, mesh=None, comm=None,
           out=sys.stdout, root=loader.ROOT):
    hi, lo = {}, {}
    for seed in (int(x) for x in args.seeds.split(",")):
        prog, ctl = seed_readings(wl, cfg, seed, device, args.calls,
                                  not args.no_control, rank, mesh, comm,
                                  root)
        if rank == 0:
            print(json.dumps({"seed": seed, "program": prog,
                              "control": ctl}), file=out, flush=True)
        for k, v in prog.items():
            hi[k] = check.worst(hi.get(k), v)
        for k, v in (ctl or {}).items():
            lo[k] = v if k not in lo else min(lo[k], v)
    summary = {"workload": args.workload, "set": args.set,
               "program_max": hi, "control_min": lo}
    if rank == 0:
        print(json.dumps(summary), file=out, flush=True)
    return summary


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=JSON",
                    help="override one of the entry's keyword arguments "
                    "(a diagnosis of where a gap comes from; limits are "
                    "never set from such readings)")
    return ap.parse_args(argv)


def _cell(args, root):
    wl = loader.workload(args.workload, root)
    cfg = loader.config(wl["config"], root)
    for kv in args.set:
        key, val = kv.split("=", 1)
        wl["kwargs"][key] = json.loads(val)
    return wl, cfg


def _rank(rank, world, port, argv, root, device, backend):
    import torch
    import torch.distributed as dist
    args = _parse(argv)
    wl, cfg = _cell(args, Path(root))
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        if device == "cuda":
            forms.load_kernels()
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh(device, (world,), mesh_dim_names=("rows",))
        return _seeds(args, wl, cfg, device, rank, mesh, DistComm(),
                      root=Path(root))
    finally:
        dist.destroy_process_group()


def main(argv=None, root=None, device="cuda", out=sys.stdout):
    argv = sys.argv[1:] if argv is None else argv
    args = _parse(argv)
    root = Path(root) if root else loader.ROOT
    wl, cfg = _cell(args, root)
    chips = int(wl["chips"])
    if device == "cuda":
        import torch
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise SystemExit(f"control.py needs {chips} CUDA card(s)")
    if chips == 1:
        if device == "cuda":
            forms.load_kernels()
        return _seeds(args, wl, cfg, device, out=out, root=root)
    import multiprocessing as mp
    from portbench.run import _free_port
    if device == "cuda":
        forms.load_kernels()           # build once, before the ranks load
    ctx = mp.get_context("spawn")
    port = _free_port()
    backend = "nccl" if device == "cuda" else "gloo"
    kids = [ctx.Process(target=_rank, args=(r, chips, port, argv, str(root),
                                            device, backend))
            for r in range(1, chips)]
    for k in kids:
        k.start()
    try:
        return _rank(0, chips, port, argv, str(root), device, backend)
    finally:
        for k in kids:
            k.join(timeout=300)
            if k.is_alive():
                k.terminate()
                k.join(timeout=30)


if __name__ == "__main__":
    main()
