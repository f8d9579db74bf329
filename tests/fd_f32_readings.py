"""f32 StreamingPCA of the JAX package and of the port on the CPU, fed the
same seeded stream of chip_smoke.py's phase-7 PCA model (ROWS x 1024: a
per-feature mean of scale 5, a 0.97^i spectrum under a random rotation,
1% noise), made batch by batch and never held whole.

For each it prints the largest overshoot of the top 64 eigenvalues over
the true ones (relative) and the largest shortfall over FD's bound
||Xc - Xc_64||_F^2 / (l - 64) at l = 128.  'port, f32 shrink' runs the
shrink in the buffer's dtype, the JAX package's arithmetic, in place of
the port's f64 shrink.

    env JAX_PLATFORMS=cpu python tests/fd_f32_readings.py [ROWS] [SEED]

ROWS defaults to 262144, chip_smoke.py's size.  Not a test: pytest does
not collect it.
"""

import sys
import time
from unittest import mock

import numpy as np
import torch

import jax
import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.apps.pca import StreamingPCA as JaxPCA
from rsvd_kamaneh_raganato_terrana_tpu_torch.apps.pca import StreamingPCA
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import fd

D, L, K, BATCH = 1024, 128, 64, 4096


def shrink_in_buffer_dtype(buf, l):
    """The JAX package's shrink: Gram, eigh and product in buf's dtype."""
    g = buf @ buf.T
    w, q = fd.eigh(0.5 * (g + g.T))
    w, q = torch.clamp(w.flip(0), min=0.0), q.flip(1)
    shrunk = torch.sqrt(torch.clamp(w - w[l], min=0.0))
    sigma = torch.sqrt(w)
    scale = torch.where(sigma > 0, shrunk / torch.clamp(sigma, min=1e-30),
                        torch.zeros_like(sigma))
    return (q * scale[None, :]).T @ buf


def main(rows=262144, seed=0):
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(4)
    rng = np.random.default_rng(seed)
    w = np.linalg.qr(rng.standard_normal((D, D)))[0]
    mu = 5.0 * rng.standard_normal(D)
    decay = 0.97 ** np.arange(D)
    runs = {"jax": (JaxPCA(D, l=L, dtype=jnp.float32), None),
            "port": (StreamingPCA(D, l=L, device="cpu"), None),
            "port, f32 shrink": (StreamingPCA(D, l=L, device="cpu"),
                                 shrink_in_buffer_dtype)}
    seconds = dict.fromkeys(runs, 0.0)
    gram, total = np.zeros((D, D)), np.zeros(D)
    for _ in range(rows // BATCH):
        x = ((rng.standard_normal((BATCH, D)) * decay) @ w.T
             + 0.01 * rng.standard_normal((BATCH, D)) + mu)
        x = x.astype(np.float32)
        x64 = x.astype(np.float64)
        gram += x64.T @ x64
        total += x64.sum(axis=0)
        for name, (sp, shrink) in runs.items():
            t0 = time.perf_counter()
            with mock.patch.object(fd, "_shrink", shrink or fd._shrink):
                sp.update(x)
            seconds[name] += time.perf_counter() - t0
    mean = total / rows
    cov = (gram - rows * np.outer(mean, mean)) / (rows - 1)
    lam_true = np.clip(np.linalg.eigvalsh(cov)[::-1], 0.0, None)
    bound = lam_true[K:].sum() / (L - K)
    true = lam_true[:K]
    for name, (sp, _) in runs.items():
        lam = sp.finalize(K)[0]
        print(f"{name}: rows={rows} seed={seed} "
              f"max_rel_over_true={np.max((lam - true) / true):.4e} "
              f"max_under_true_over_fd_bound="
              f"{np.max(true - lam) / bound:.4f} ({seconds[name]:.1f} s)",
              flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
