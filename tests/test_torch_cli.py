"""The port's command lines (``__main__.py`` with the ``rsvd`` and ``pca``
apps) against the JAX package's, in-process on the CPU.

The JAX rsvd CLI runs in f64 on the CPU (it turns x64 on there) and the
port's with ``--device cpu`` runs in f64 too; the port draws JAX's
sketch through a patched ``generate_omega``, as
tests/test_torch_image.py does.  Printed errors are compared to the
digits printed, or to f64 rounding of ||A||_F where the error itself is
rounding."""

import os
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsvd_kamaneh_raganato_terrana_tpu.apps import pca_main as jpca_main
from rsvd_kamaneh_raganato_terrana_tpu.apps import rsvd_main as jrsvd_main
from rsvd_kamaneh_raganato_terrana_tpu.core.io import read_matrix_market
from rsvd_kamaneh_raganato_terrana_tpu.rsvd.driver import (
    generate_omega as jax_generate_omega,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch import __main__ as tmain
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import convert
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import kernels
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver as tdriver

from conftest import DATA_DIR

REPO = str(Path(__file__).resolve().parent.parent)
INPUT = os.path.join(DATA_DIR, "input")
TOURISTS = os.path.join(DATA_DIR, "pca", "tourists.txt")
LINE = re.compile(r"^(\S+): (\d+)x(\d+) l=(\d+) \|\|A-USV\^T\|\| = (\S+)")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_omega(key_or_seed, n, l, dtype=None, kind="gaussian", device=None):
    return convert.from_numpy(np.asarray(jax_generate_omega(
        key_or_seed, n, l, jnp.float64, kind)), device="cpu")


def _results(out):
    """{stem: (m, n, l, err)} of an rsvd CLI's output."""
    rows = {}
    for line in out.splitlines():
        hit = LINE.match(line)
        if hit:
            stem, m, n, l, err = hit.groups()
            rows[stem] = (int(m), int(n), int(l), float(err))
    return rows


def _run_both(capsys, tmp_path, *flags):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    with mock.patch.object(tdriver, "generate_omega", _jax_omega):
        assert tmain.main(["rsvd", INPUT, "--device", "cpu",
                           "--save-dir", str(port_dir), *flags]) == 0
    port = _results(capsys.readouterr().out)
    assert jrsvd_main.main([INPUT, "--save-dir", str(jax_dir), *flags]) == 0
    return port, _results(capsys.readouterr().out), port_dir, jax_dir


def test_rsvd_cli_matches_jax(capsys, tmp_path):
    port, jax_rows, port_dir, jax_dir = _run_both(capsys, tmp_path)
    assert sorted(port) == sorted(jax_rows) == \
        sorted(p[:-4] for p in os.listdir(INPUT))
    for stem, (m, n, l, err) in port.items():
        a = read_matrix_market(os.path.join(INPUT, stem + ".mtx"))
        jm, jn, jl, jerr = jax_rows[stem]
        assert (m, n, l) == (jm, jn, jl) == (a.shape[0], a.shape[1], 16)
        assert np.isfinite(err)
        assert abs(err - jerr) <= max(1e-6 * jerr,
                                      1e-12 * np.linalg.norm(a))
        factors = {}
        for d in (port_dir, jax_dir):
            u, s, v = (read_matrix_market(str(d / f"{stem}_{x}.mtx"))
                       for x in "USV")
            factors[d] = (u, s[:, 0], v)
        (pu, ps, pv), (ju, js, jv) = factors[port_dir], factors[jax_dir]
        assert np.abs(ps - js).max() <= 1e-12 * js[0]
        assert np.linalg.norm((pu * ps) @ pv.T - (ju * js) @ jv.T) <= \
            1e-12 * np.linalg.norm(a)


def test_rsvd_cli_kernel_flags_count_one_k3_and_five_k1_per_file(capsys):
    """``--method eigh_pallas --qr-method cholqr1_fused`` at the CLI's
    defaults (q = 2, reorth 'full'): the basis of Y = A Omega, then per
    power round the Z and the Y side -- 1 + 2q = 5 'cholqr1_fused'
    orthonormalizations, each K1 on the card's f32 -- and one K3 eigh a
    file (its plain version on the CPU)."""
    calls = {"k1": 0, "k3": 0}
    real_basis, real_k3 = tdriver.orthonormal_basis, kernels.eigh_small

    def basis(y, method="robust"):
        calls["k1"] += method == "cholqr1_fused"
        return real_basis(y, method)

    def k3(*args, **kw):
        calls["k3"] += 1
        return real_k3(*args, **kw)
    with mock.patch.object(tdriver, "orthonormal_basis", basis), \
            mock.patch.object(kernels, "eigh_small", k3):
        assert tmain.main(["rsvd", INPUT, "--device", "cpu", "--method",
                           "eigh_pallas", "--qr-method",
                           "cholqr1_fused"]) == 0
    captured = capsys.readouterr()
    files = len(os.listdir(INPUT))
    assert calls == {"k1": 5 * files, "k3": files}
    assert len(_results(captured.out)) == files
    # sparse_matrix is rank 2: pure CholeskyQR breaks down, as in JAX
    assert "has no rank-deficiency fallback" in captured.err


def test_rsvd_cli_single_file_and_empty_dir(capsys, tmp_path):
    path = os.path.join(INPUT, "sparse_matrix110.mtx")
    with mock.patch.object(tdriver, "generate_omega", _jax_omega):
        assert tmain.main(["rsvd", path, "--device", "cpu", "--k", "4",
                           "--p", "6", "--q", "1"]) == 0
    port = _results(capsys.readouterr().out)
    assert jrsvd_main.main([path, "--k", "4", "--p", "6", "--q", "1"]) == 0
    jax_rows = _results(capsys.readouterr().out)
    assert port.keys() == jax_rows.keys() == {"sparse_matrix110"}
    assert port["sparse_matrix110"][:3] == jax_rows["sparse_matrix110"][:3] \
        == (110, 110, 4)
    assert abs(port["sparse_matrix110"][3] - jax_rows["sparse_matrix110"][3]) \
        <= 1e-6 * jax_rows["sparse_matrix110"][3]
    assert tmain.main(["rsvd", str(tmp_path), "--device", "cpu"]) == 1
    assert "no .mtx files" in capsys.readouterr().err


@pytest.mark.parametrize("normalize", ["yes", "no"])
def test_pca_cli_matches_jax(capsys, tmp_path, normalize):
    port_file, jax_file = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert tmain.main(["pca", TOURISTS, normalize, "--device", "cpu",
                       "--save", str(port_file)]) == 0
    port = capsys.readouterr().out.splitlines()
    jpca_main.main([TOURISTS, normalize, "--save", str(jax_file)])
    jax_lines = capsys.readouterr().out.splitlines()
    orth = [ln for ln in port if ln.startswith("orthogonality check")]
    assert len(orth) == 1 and float(orth[0].split("=")[1]) < 1e-12
    assert [ln for ln in port if ln not in orth and "saved" not in ln] == \
        [ln for ln in jax_lines
         if not ln.startswith("orthogonality check") and "saved" not in ln]
    cum = [np.array(f.read_text().splitlines()[1].split(), float)
           for f in (port_file, jax_file)]
    np.testing.assert_allclose(cum[0], cum[1], rtol=1e-12)
    if normalize == "yes":
        assert any(ln.split()[:3] == ["Proportion", "of", "Variance"]
                   and ln.split()[3] == "0.8961" for ln in port)


def test_dispatcher_messages(capsys):
    assert tmain.main(["pod", "x.txt", "y.prm"]) == 1
    assert "queue 1 item 5" in capsys.readouterr().out
    assert tmain.main(["nope"]) == 1
    assert "expected rsvd|image|pca" in capsys.readouterr().out
    assert tmain.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "rsvd <mtx-or-dir>" in out and "pca <dataset>" in out


def test_python_dash_m_runs_the_pca_app():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "rsvd_kamaneh_raganato_terrana_tpu_torch",
         "pca", TOURISTS, "yes", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
        check=True)
    assert "Importance of components:" in out.stdout
