"""Time entry()'s main path ('default' and 'highest', 4096^2 f32, k = 64;
5 x 50 calls each, CUDA events) and a lone 80 x 80 eigh: torch's, through
``core/device.py::eigh_nan`` and through ``core/device.py::eigh`` (with
its Newton-Schulz step), on the package tree at <tree>, on one CUDA
card.  Prints one JSON line.  To compare two commits, unpack each with
``git archive`` into a gitignored directory and run, in one call,
parent, change, change, parent:

    python3 ab_main_path.py <tree>
"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from rsvd_kamaneh_raganato_terrana_tpu_torch.entry import entry


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


out = {"tree": sys.argv[1]}
for prec in ("default", "highest"):
    fwd, (a,) = entry(device="cuda", m=4096, n=4096, precision=prec)
    fwd(a)
    out[prec] = [cuda_ms(lambda: fwd(a), 50) for _ in range(5)]
g = torch.randn(80, 160, device="cuda")
g = g @ g.T
out["linalg_eigh_80_ms"] = cuda_ms(lambda: torch.linalg.eigh(g), 200)
try:
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import eigh_nan
    out["eigh_nan_80_ms"] = cuda_ms(lambda: eigh_nan(g), 200)
    from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import eigh
    out["eigh_80_ms"] = cuda_ms(lambda: eigh(g), 200)
except ImportError:
    pass
print(json.dumps(out))
