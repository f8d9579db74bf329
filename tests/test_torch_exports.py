"""The PyTorch port's package ``__init__`` files against the JAX
package's: every name a JAX ``__init__`` exports, and that the port
defines somewhere in its own package, is exported by the port's twin
``__init__`` too.

The JAX side is read as source (the names its ``__init__`` imports), so
this needs neither JAX's runtime nor its heavy modules; the port's side
is imported."""

import ast
import importlib
from pathlib import Path

import pytest

import rsvd_kamaneh_raganato_terrana_tpu as jax_pkg
import rsvd_kamaneh_raganato_terrana_tpu_torch as torch_pkg

JAX_ROOT = Path(jax_pkg.__file__).resolve().parent
TORCH_ROOT = Path(torch_pkg.__file__).resolve().parent
SUBPACKAGES = ("", "rsvd", "linalg", "core", "apps", "ops")


def init_exports(root: Path, sub: str) -> set:
    """Public names that ``<root>/<sub>/__init__.py`` imports."""
    tree = ast.parse((root / sub / "__init__.py").read_text())
    return {alias.asname or alias.name
            for node in tree.body if isinstance(node, ast.ImportFrom)
            for alias in node.names if not alias.name.startswith("_")}


def port_definitions() -> set:
    """Top-level functions, classes and assigned names of every module of
    the port (``__init__`` files excluded)."""
    names = set()
    for path in TORCH_ROOT.rglob("*.py"):
        if path.name == "__init__.py":
            continue
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
    return names


def port_module(sub: str):
    name = torch_pkg.__name__ + (f".{sub}" if sub else "")
    return importlib.import_module(name)


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top")
def test_port_init_exports_what_jax_exports_and_port_defines(sub):
    wanted = init_exports(JAX_ROOT, sub) & port_definitions()
    module = port_module(sub)
    missing = sorted(n for n in wanted if not hasattr(module, n))
    assert not missing, f"{module.__name__} lacks {missing}"


@pytest.mark.parametrize("sub, name", [
    ("rsvd", "power_refine"),
    ("rsvd", "subspace_iteration"),
    ("", "cholesky_qr2"),
    ("core", "fold_in_shard"),
    ("core", "gaussian"),
    ("core", "key_from_seed"),
    ("core", "rademacher"),
    ("core", "sketch_matrix"),
    ("core", "rsvd_flops"),
    ("", "read_matrix_market"),
    ("", "write_matrix_market"),
    ("core", "read_matrix_market"),
    ("core", "write_matrix_market"),
    ("core", "load_whitespace_dataset"),
    ("apps", "PCA"),
    ("apps", "load_tourists_dataset"),
    ("apps", "load_athletic_dataset"),
    ("rsvd", "FrequentDirections"),
    ("ops", "matvec"),
    ("ops", "frobenius_norm"),
    ("ops", "normalize"),
    ("ops", "transpose"),
    ("ops", "countsketch_apply"),
    ("rsvd", "range_error_estimate"),
    ("rsvd", "factorization_error_estimate"),
    ("rsvd", "spectral_norm_estimate"),
    ("rsvd", "stable_rank_estimate"),
    ("rsvd", "rsvd_krylov"),
    ("rsvd", "sketch_lstsq"),
    ("rsvd", "nystrom_pcg"),
    ("rsvd", "hutchpp"),
    ("rsvd", "logdet_psd"),
    ("rsvd", "rlu_solve"),
    ("rsvd", "cca"),
    ("rsvd", "dmd"),
    ("rsvd", "rpca"),
    ("rsvd", "complete_lowrank"),
    ("rsvd", "complete_tucker"),
    ("rsvd", "tucker"),
    ("rsvd", "tucker_adaptive"),
    ("rsvd", "tucker_reconstruct"),
    ("rsvd", "tt_decompose"),
    ("rsvd", "tt_reconstruct"),
    ("rsvd", "tt_ranks"),
    ("rsvd", "tt_compression_ratio"),
    ("rsvd", "tt_adaptive"),
    ("rsvd", "cp_decompose"),
    ("rsvd", "cp_reconstruct"),
    ("rsvd", "khatri_rao"),
    ("rsvd", "HodlrMatrix"),
    ("rsvd", "hodlr_build"),
    ("rsvd", "hodlr_build_implicit"),
    ("rsvd", "hodlr_matvec"),
    ("rsvd", "hodlr_reconstruct"),
    ("rsvd", "hodlr_compression_ratio"),
    ("rsvd", "hodlr_solve"),
    ("core", "PhaseTimer"),
    ("core", "timeit"),
    ("core", "trace"),
    ("core", "matmul_gflops"),
    ("core", "save_factors"),
    ("core", "load_factors"),
    ("core", "export_matrix_market"),
])
def test_named_exports(sub, name):
    assert name in init_exports(JAX_ROOT, sub)
    assert name in init_exports(TORCH_ROOT, sub)
    assert callable(getattr(port_module(sub), name))


@pytest.mark.parametrize("module, name", [
    ("apps.pca", "StreamingPCA"),
    ("linalg.jacobi", "jacobi_svd_chunked"),
    ("apps.gp", "GP"),
    ("apps.gp", "rbf_kernel"),
    ("apps.image", "compress_video_tucker"),
    ("apps.image", "reconstruct_video_tucker"),
    ("core.checkpoint", "save_tensor_factors"),
    ("core.checkpoint", "load_tensor_factors"),
    ("core.checkpoint", "save_model"),
    ("core.checkpoint", "load_model"),
    ("rsvd._modewise", "tighten_contract"),
    ("rsvd._modewise", "mode_spectrum"),
    ("rsvd._modewise", "mode_contract"),
    ("rsvd.tucker", "mode_dot"),
])
def test_names_jax_keeps_in_their_modules(module, name):
    """Names the JAX package leaves out of its ``__init__`` files: the
    port defines them in the same modules."""
    jax_module = (JAX_ROOT / module.replace(".", "/")).with_suffix(".py")
    assert any(isinstance(node, (ast.FunctionDef, ast.ClassDef))
               and node.name == name
               for node in ast.parse(jax_module.read_text()).body)
    assert callable(getattr(port_module(module), name))
