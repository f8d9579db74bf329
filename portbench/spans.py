#!/usr/bin/env python3
"""The program's own spans in a run of a cell: what they add to the
reduction of ``trace.py``, and a runner that turns them on.

The port opens ``rsvd/<name>`` spans where its work happens
(``core/profiling.py``: the call, its stages, each product, cast, QR,
tail, collective and deliberate host read) when they are switched on.
On the profiler's timeline each is a host event on the clock of the
card's kernels; a launch inside it is tied to its kernel by correlation
id, as ``trace.reduce`` ties launches to the harness's own
``portbench/<layer>`` spans.  This module reads, over the traced calls:

- ``span_s``: device seconds of the operations launched under each
  innermost ``rsvd/`` span, by its name (each span's self time on the
  device), and ``span_incl_s`` the same under each span at any depth;
- ``host_waits``: each runtime wait inside a call (the events
  ``trace.reduce`` counts as ``syncs``), by innermost ``rsvd/`` span,
  innermost torch op and runtime call, as a count a call;
- ``idle_by_span``: device-idle seconds in the window, by the innermost
  ``rsvd/`` span open on the host at the gap's midpoint.

The profiler also copies each span to the device timeline
(``gpu_user_annotation``); :func:`harness_reduce` drops those copies
before ``trace.reduce`` sees them, so that a run with the program's
spans on reads what one without them reads.

    python3 -m portbench.spans --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> [--spans <0|1>] [--out <file>]

runs the cell as ``run.py`` does (every rank), with the program's spans
on for the whole run where ``--spans 1`` (the default); with ``--trace
1`` it writes this module's reading of rank 0's trace to ``--out``
(default ``results/spans_<cell>_<seed>.json``) beside the result
line ``run.py`` prints.
"""

from __future__ import annotations

import argparse
import bisect
import functools
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import run, trace  # noqa: E402

PREFIX = "rsvd/"
ROOT = PREFIX + "call"
NO_SPAN = "(no program span)"
OUTSIDE = "(between calls)"


def program_span(name: str) -> bool:
    return name.startswith(PREFIX)


_harness = trace.reduce


def harness_reduce(cpu, gpu, top: int = 10) -> dict:
    """``trace.reduce`` of the events with the device copies of the
    program's spans left out."""
    return _harness(cpu, [g for g in gpu if not program_span(g[0])], top)


def _chain(nested, t):
    """Labels of every interval of ``nested`` (a ``trace.Nested``) that
    holds ``t``, innermost first."""
    i = bisect.bisect_right(nested.starts, t) - 1
    out = []
    while i >= 0:
        if nested.items[i][1] >= t:
            out.append(nested.items[i][2])
        i = nested.parent[i]
    return out


def reduce(cpu, gpu, top: int = 10) -> dict:
    """This module's reading (the module docstring) of one rank's trace:
    calls, span_s, span_incl_s, host_waits (count a call), idle_by_span
    (seconds over the window, the ``top`` largest) and how many waits
    inside calls lay under no program span below the root."""
    calls = [(s, e) for n, s, e, _, _ in cpu if n == trace.CALL]
    if not calls:
        return {"calls": 0}
    tid = next(t for n, _, _, _, t in cpu if n == trace.CALL)
    w0, w1 = min(s for s, _ in calls), max(e for _, e in calls)
    in_call = trace.Nested([(s, e, True) for s, e in calls])
    mine = trace.Nested([(s, e, n) for n, s, e, _, t in cpu
                         if t == tid and program_span(n)])
    ops = trace.Nested([(s, e, n) for n, s, e, _, t in cpu
                        if t == tid and not trace._is_runtime(n)
                        and not program_span(n)
                        and not n.startswith(trace.SPAN)])
    runtime = {c: s for n, s, _, c, _ in cpu if trace._is_runtime(n)}
    launched = {c: s for n, s, _, c, _ in cpu if not trace._is_runtime(n)}

    span_s, incl_s, busy = {}, {}, []
    for name, s, e, linked, corr in gpu:
        if trace._annotation(name) or program_span(name):
            continue
        launch = runtime.get(corr, launched.get(linked))
        when = launch if launch is not None else s
        if not in_call.at(when):
            continue
        busy.append((s, e))
        chain = _chain(mine, launch) if launch is not None else []
        inner = chain[0] if chain else NO_SPAN
        span_s[inner] = span_s.get(inner, 0.0) + (e - s) * 1e-9
        for label in set(chain) or {NO_SPAN}:
            incl_s[label] = incl_s.get(label, 0.0) + (e - s) * 1e-9

    waits, unowned = {}, 0
    for n, s, _, _, t in cpu:
        if not (trace._is_runtime(n) and trace._is_wait(n)
                and in_call.at(s)):
            continue
        inner, op = (mine.at(s), ops.at(s)) if t == tid else (None, None)
        unowned += inner in (None, ROOT)
        key = f"{inner or NO_SPAN} / {op or '-'} / {n}"
        waits[key] = waits.get(key, 0) + 1

    idle, prev = {}, w0
    for s, e in trace._union(busy, w0, w1) + [[w1, w1]]:
        if s > prev:
            mid = (prev + s) // 2
            label = (mine.at(mid) or NO_SPAN) if in_call.at(mid) \
                else OUTSIDE
            idle[label] = idle.get(label, 0.0) + (s - prev) * 1e-9
        prev = max(prev, e)
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])  # noqa
    n_calls = len(calls)
    return {
        "calls": n_calls, "span_s": span_s, "span_incl_s": incl_s,
        "host_waits": [[k, v / n_calls] for k, v in rank(waits)],
        "waits_outside_stages": unowned,
        "idle_by_span": [[k, v] for k, v in rank(idle)[:top]],
    }


def span_ms(red: dict, name: str, inclusive: bool = False):
    """Device ms a call under span ``rsvd/<name>`` (innermost, or at any
    depth); None where nothing ran under it."""
    t = red.get("span_incl_s" if inclusive else "span_s", {}).get(
        PREFIX + name)
    return 1e3 * t / red["calls"] if t and red.get("calls") else None


# -- the runner -------------------------------------------------------------

_found = {}


def reading_into(found: dict):
    """A stand-in for ``trace.reduce``: :func:`harness_reduce`, keeping
    :func:`reduce`'s reading of the same events in ``found``."""
    def both(cpu, gpu, top=10):
        found.update(reduce(cpu, gpu, top))
        return harness_reduce(cpu, gpu, top)
    return both


def _read_spans():
    trace.reduce = reading_into(_found)


def _child(rank, world, argv, port, spans=1):
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import profiling

    _read_spans()
    with profiling.spans(bool(spans)):
        run.run_rank(rank, world, run.parse(argv), port)


def main(argv=None) -> int:
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core import profiling

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    cell = run.parse(rest)
    _read_spans()
    # the other ranks of a multi-card cell, spawned by run.main: by this
    # module's importable name, which ``python3 -m`` does not give it here
    from portbench import spans as importable
    run._child = functools.partial(importable._child, spans=args.spans)
    with profiling.spans(bool(args.spans)):
        rc = run.main(rest)
    if cell.trace and _found.get("calls"):
        out = Path(args.out or REPO / "results"
                   / f"spans_{cell.workload}_{cell.seed}.json")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(_found, indent=1))
        run.log("program spans: " + json.dumps({
            "span_ms": {k: 1e3 * v / _found["calls"]
                        for k, v in _found["span_s"].items()},
            "waits_outside_stages": _found["waits_outside_stages"]}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
