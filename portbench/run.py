#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up loads the port's kernels (built on the first run in a checkout,
into the package's fixed ``build/`` directory), makes the cell's operand
on the card from the seed, and warms up the cell's calls.  The window is
a closed loop with one caller: the cell's entry called back to back on
the stored operand, each call with its own sketch seed and ended by
``torch.cuda.synchronize()``.  The cell's kind (``kinds/<kind>.py``)
builds the operand, keeps what the check needs of each call's output,
holds it to the kind's plain reference and counts the least time of a
call's products.  With ``--trace 1`` the window runs under
``torch.profiler`` for the cell's ``trace_seconds`` and the per-layer
metrics are printed instead of the end-to-end ones.  After the window a
sample of the calls, drawn from the seed, is held to the kind's plain
reference (``check.py``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(with ``--trace 1`` also ``breakdown``) and ``checks``; the checks are
also the last lines of standard error.  A cell on several cards starts
one process a card (NCCL), rank 0 in this one; rank 0 prints.

Exits non-zero, printing no result, without as many CUDA cards as the
cell asks for, and if JAX or the JAX package is loaded in this process
once the window has closed.
"""

from __future__ import annotations

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (from /proc, 10 ms steps)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROC = time.perf_counter() - _process_age()

from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
# every kernel cache at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, str(REPO / "build" / "portbench-cache"
                                    / _sub))
os.environ.setdefault("USE_FLAX", "0")

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402

from portbench import loader, operands, stats  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rsvd_kamaneh_raganato_terrana_tpu")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list:
    """Top-level names in ``sys.modules`` (before the first dot, compared
    whole) that belong to JAX or the JAX package."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


class Group:
    """The ranks of a multi-card cell: NCCL for the program, a gloo group
    beside it for the harness's own messages (no device work)."""

    def __init__(self, rank, world, port, backend):
        import torch.distributed as dist
        self.dist, self.rank, self.world = dist, rank, world
        if world == 1:
            self.ctrl = None
            return
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        self.ctrl = dist.new_group(backend="gloo")

    def make_mesh(self, device_type):
        if self.world == 1:
            return None
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(device_type, (self.world,),
                                mesh_dim_names=("rows",))

    def barrier(self):
        if self.world > 1:
            self.dist.barrier(group=self.ctrl)

    def agree(self, go: bool) -> bool:
        """Rank 0's decision, on every rank."""
        if self.world == 1:
            return go
        import torch
        flag = torch.tensor([int(go)])
        self.dist.broadcast(flag, 0, group=self.ctrl)
        return bool(flag.item())

    def gather(self, obj):
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        self.dist.all_gather_object(out, obj, group=self.ctrl)
        return out

    def close(self):
        if self.world > 1:
            self.dist.barrier(group=self.ctrl)
            self.dist.destroy_process_group()


def _window(call, sample, seed, seconds, n_sample, group, device):
    """The closed loop: (latencies, samples, failures, non-finite flag
    count on the device, window seconds).  ``sample``: the kind's."""
    import torch
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rng = random.Random(operands.mix(seed, 7))
    nonfinite = torch.zeros((), dtype=torch.int64, device=device)
    lat, samples, failed, i = [], [], 0, 0
    t_start = time.perf_counter()
    while group.agree(time.perf_counter() - t_start < seconds):
        s = operands.call_seed(seed, i)
        t0 = time.perf_counter()
        try:
            out = call(s)
            sync()
        except (RuntimeError, ValueError, FloatingPointError) as e:
            sync()
            out = None
            failed += 1
            if failed == 1:
                log(f"call {i} failed: {type(e).__name__}: {e}")
        lat.append(time.perf_counter() - t0)
        if out is not None:
            kept, bad, unhealthy = sample(out)
            nonfinite += bad
            if unhealthy:
                failed += 1         # the program's health verdict tripped
            smp = dict(index=i, seed=s, **kept)
            # reservoir sample of the calls, drawn from the seed
            if len(samples) < n_sample:
                samples.append(smp)
            else:
                j = rng.randrange(i + 1)
                if j < n_sample:
                    samples[j] = smp
            del out, kept, bad, smp
        i += 1
    sync()
    return lat, samples, failed, nonfinite, time.perf_counter() - t_start


def run_rank(rank, world, args, port, device="cuda", backend="nccl",
             root=None, out=sys.stdout):
    """Set-up, window and check of one rank; rank 0 prints the result
    line and returns it.  ``root`` (the benchmark folder) and ``device``
    let the CPU tests drive a run at a small size; the benchmark's runs
    never pass them."""
    import torch
    from portbench import check, forms, trace
    from portbench.reference.operand import Comm, DistComm

    root = Path(root) if root else loader.ROOT
    bench_root = root.parent if root != loader.ROOT else loader.REPO
    wl, cfg, e2e, per_layer = loader.cell(args.workload, root, bench_root)
    kind = loader.kind(wl, root)
    loop = wl["loop"]
    marks = {"imports": time.perf_counter()}
    if device == "cuda":
        torch.cuda.set_device(rank)
    group = Group(rank, world, port, backend)
    if device == "cuda":
        if rank == 0:
            n = forms.load_kernels()
        group.barrier()
        if rank:
            n = forms.load_kernels()
        log(f"rank {rank}: {n} kernel libraries loaded")
    marks["kernels"] = time.perf_counter()
    mesh = group.make_mesh(device)
    operand, held = kind.build(wl, cfg, args.seed, device, rank, mesh)
    if device == "cuda":
        torch.cuda.synchronize()
    marks["operand"] = time.perf_counter()

    entry = forms.resolve(wl["entry"])
    kwargs = {**cfg["settings"], **wl["kwargs"]}

    def call(s):
        return entry(operand, seed=s, **kwargs)

    warm_failed = 0
    for j in range(loop["warmup_calls"]):
        try:
            call(operands.call_seed(args.seed, -1 - j))
        except (RuntimeError, ValueError, FloatingPointError) as e:
            warm_failed += 1          # counted in `failed`: not correct
            log(f"warm-up call {j} failed: {type(e).__name__}: {e}")
    gc.collect()
    peak_setup = 0
    if device == "cuda":
        torch.cuda.synchronize()
        peak_setup = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    group.barrier()
    marks["warmup"] = time.perf_counter()
    setup_s = marks["warmup"] - T_PROC

    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
    red = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device == "cuda" else [])
        seconds = min(args.seconds, loop["trace_seconds"])
        with trace.layer_spans(root, getattr(kind, "SPANS", None)):
            with profile(activities=acts) as prof:
                call(operands.call_seed(args.seed, -100))    # CUPTI warm-up
                if device == "cuda":
                    torch.cuda.synchronize()
                collectives.reset()
                from torch.profiler import record_function

                def traced(s):
                    with record_function(trace.CALL):
                        return call(s)
                lat, samples, failed, bad, window_s = _window(
                    traced, kind.sample, args.seed, seconds,
                    loop["sample_calls"], group, device)
        red = trace.reduce(*trace.events_from_profiler(prof))
        del prof
    else:
        collectives.reset()
        lat, samples, failed, bad, window_s = _window(
            call, kind.sample, args.seed, args.seconds, loop["sample_calls"],
            group, device)
    tally = collectives.tally()
    peak_window = peak_all = 0
    if device == "cuda":
        torch.cuda.synchronize()
        peak_window = torch.cuda.max_memory_allocated()
        peak_all = max(peak_setup, peak_window)
    failed += int(bad.item()) + warm_failed

    # the program's state goes before the reference runs
    del operand, call
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    comm = DistComm() if world > 1 else Comm()
    t_ref = time.perf_counter()
    found = kind.readings(wl, cfg, samples, held, args.seed, device, comm)
    ref_s = time.perf_counter() - t_ref
    if rank == 0:
        log(f"sampled calls {[smp['index'] for smp in samples]}: "
            + json.dumps(found))
    del held, samples

    mine = dict(peak=peak_window, peak_all=peak_all, failed=failed,
                busy=(red or {}).get("busy_s", 0.0),
                coll=sum(v["bytes"] for v in tally.values()))
    every = group.gather(mine)
    group.close()
    if rank:
        return None

    ok, rows = check.verdict(wl["limits"], found)
    failed = sum(m["failed"] for m in every)
    attempted = len(lat)
    correct = bool(ok and failed == 0 and attempted > 0)
    gib = max(m["peak"] for m in every) / 2 ** 30
    if args.trace:
        metrics = _per_layer(per_layer, root, red, every,
                             kind.least(wl, cfg, world), world)
    else:
        values = {"call_ms": stats.per_call_ms(window_s, attempted),
                  "call_ms_p95": 1e3 * stats.percentile(lat, 95.0),
                  "peak_mem_gib": gib, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e if m["name"] in values}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else device, "count": world,
           "memory_peak_bytes": max(m["peak_all"] for m in every)}
    if args.trace:
        dev["busy_s"] = sum(m["busy"] for m in every) / world
        dev["window_s"] = red.get("window_s", 0.0)
    log(f"set-up {setup_s:.3f} s: process start to imports "
        f"{marks['imports'] - T_PROC:.3f}, kernel load "
        f"{marks['kernels'] - marks['imports']:.3f}, operand "
        f"{marks['operand'] - marks['kernels']:.3f}, warm-up "
        f"{marks['warmup'] - marks['operand']:.3f}")
    if device == "cuda":
        log(f"device {dev['kind']} x {world}; nvidia-smi name, power.limit:"
            f" {power_limit()}")
    log(f"window {window_s:.3f} s, {attempted} calls, {failed} failed; "
        f"reference {ref_s:.3f} s; collectives {json.dumps(tally)}")
    if red:
        log("trace: " + json.dumps({k: v for k, v in red.items()
                                    if k not in ("device_ops", "idle_gaps")}))
    found_mods = forbidden_modules()
    if found_mods:
        log(f"forbidden modules loaded: {found_mods}")
        raise SystemExit(3)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if red and red.get("calls"):
        result["breakdown"] = {"device_ops": red["device_ops"],
                               "idle_gaps": red["idle_gaps"]}
    # a reading that is missing or not finite is printed as null (failed)
    result["checks"] = {n: {"value": v if math.isfinite(v) else None,
                            "limit": lim} for n, v, lim in rows}
    for n, v, lim in rows:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return result


def _per_layer(per_layer, root, red, every, least_by, world):
    from portbench import trace
    least, by = least_by
    log(f"products' least time {1e3 * least:.4f} ms a call, bound by {by}")
    calls = red.get("calls", 0)
    reading = trace.Reading(red, sum(x["busy"] for x in every) / world,
                            least, every[0]["coll"] / calls if calls else None)
    out = {}
    for m in per_layer:
        reader = loader.metric(m["name"], root)
        value = reader.read(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": reader.UNIT}
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child(rank, world, argv, port):
    run_rank(rank, world, parse(argv), port)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    wl = loader.workload(args.workload)
    chips = int(wl["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); torch.cuda.is_available() = "
            f"{torch.cuda.is_available()}, device_count() = "
            f"{torch.cuda.device_count()}: no result")
        return 2
    if chips == 1:
        run_rank(0, 1, args, None)
        return 0
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    port = _free_port()
    kids = [ctx.Process(target=_child, args=(r, chips, argv, port))
            for r in range(1, chips)]
    for k in kids:
        k.start()
    try:
        run_rank(0, chips, args, port)
    finally:
        for k in kids:
            k.join(timeout=120)
        for k in kids:
            if k.is_alive():
                k.terminate()
                k.join(timeout=30)
    bad = [k.exitcode for k in kids if k.exitcode != 0]
    if bad:
        log(f"rank exit codes {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
