"""The port's MatrixMarket and dataset I/O (``core/io.py`` and the host
library ``native/mmio.cpp``, both copies of the JAX package's) against
the JAX package's ``core/io.py``.  The port builds its own copy of
``mmio.cpp`` with the host ``c++`` into its ``build/``."""

import os
from pathlib import Path

import numpy as np
import pytest

from rsvd_kamaneh_raganato_terrana_tpu.core import io as jio
from rsvd_kamaneh_raganato_terrana_tpu_torch import native
from rsvd_kamaneh_raganato_terrana_tpu_torch.core import io as tio

from conftest import DATA_DIR

INPUTS = sorted(p.name for p in Path(DATA_DIR, "input").glob("*.mtx"))


def test_mmio_is_a_copy_of_the_jax_source():
    jax_src = Path(jio.__file__).parent.parent / "native" / "mmio.cpp"
    port_src = Path(native.__file__).parent / "mmio.cpp"
    assert port_src.read_bytes() == jax_src.read_bytes()
    assert native.library_path("mmio").name.startswith("libmmio-")


@pytest.mark.parametrize("name", INPUTS)
def test_reference_inputs_bitwise_jax(name):
    path = os.path.join(DATA_DIR, "input", name)
    got = tio.read_matrix_market(path)
    want = jio.read_matrix_market(path)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tio._read_python(path))


def test_native_reader_against_python(tmp_path):
    a = np.random.default_rng(0).standard_normal((31, 8))
    a[3] = 0.0
    path = str(tmp_path / "n.mtx")
    tio.write_matrix_market(path, a, comment="seeded")
    np.testing.assert_array_equal(native.read_mtx(path),
                                  tio._read_python(path))
    np.testing.assert_allclose(native.read_mtx(path), a, rtol=0, atol=1e-15)


def test_array_format(tmp_path):
    path = tmp_path / "arr.mtx"
    path.write_text("%%MatrixMarket matrix array real general\n"
                    "% column-major\n2 3\n1\n4\n2\n5\n3\n6\n")
    want = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    np.testing.assert_array_equal(tio.read_matrix_market(str(path)), want)
    np.testing.assert_array_equal(tio._read_python(str(path)), want)


@pytest.mark.parametrize("symmetry, sign", [("symmetric", 1.0),
                                            ("skew-symmetric", -1.0)])
def test_symmetric_files_are_mirrored(tmp_path, symmetry, sign):
    path = str(tmp_path / "sym.mtx")
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate real {symmetry}\n")
        f.write("3 3 3\n2 1 5.0\n3 2 -1.0\n3 1 2.5\n")
    lower = np.array([[0.0, 0, 0], [5.0, 0, 0], [2.5, -1.0, 0]])
    want = lower + sign * lower.T
    for reader in (tio.read_matrix_market, tio._read_python,
                   jio.read_matrix_market):
        np.testing.assert_array_equal(reader(path), want)


def test_write_read_round_trip_and_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((17, 9))
    a[:, 4] = 0.0
    port, jax_file = str(tmp_path / "port.mtx"), str(tmp_path / "jax.mtx")
    tio.write_matrix_market(port, a, comment="round trip")
    jio.write_matrix_market(jax_file, a, comment="round trip")
    assert Path(port).read_bytes() == Path(jax_file).read_bytes()
    np.testing.assert_array_equal(tio.read_matrix_market(port), a)
    v = rng.standard_normal(5)                       # a vector: one column
    tio.write_matrix_market(port, v)
    np.testing.assert_array_equal(tio.read_matrix_market(port), v[:, None])
    f32 = tio.read_matrix_market(port, dtype=np.float32)
    assert f32.dtype == np.float32


def test_native_writer_round_trip(tmp_path):
    a = np.random.default_rng(2).standard_normal((12, 7))
    path = str(tmp_path / "native.mtx")
    native.write_mtx(path, a)
    np.testing.assert_array_equal(tio._read_python(path), a)
    with pytest.raises(ValueError, match="2-D"):
        native.write_mtx(path, a[0])


def test_read_errors(tmp_path):
    with pytest.raises(OSError, match="cannot open"):
        tio.read_matrix_market(str(tmp_path / "missing.mtx"))
    bad = tmp_path / "bad.mtx"
    bad.write_text("not a matrix\n")
    with pytest.raises(ValueError, match="not a MatrixMarket"):
        tio.read_matrix_market(str(bad))
    packed = tmp_path / "packed.mtx"
    packed.write_text("%%MatrixMarket matrix array real symmetric\n2 2\n1\n2\n3\n")
    with pytest.raises(ValueError, match="unsupported"):
        tio.read_matrix_market(str(packed))
    with pytest.raises(ValueError, match="array-format symmetric"):
        tio._read_python(str(packed))


@pytest.mark.parametrize("name, skip", [("tourists.txt", 3),
                                        ("dataset_athletic.txt", 1)])
def test_load_whitespace_dataset_equals_jax(name, skip):
    path = os.path.join(DATA_DIR, "pca", name)
    data, labels = tio.load_whitespace_dataset(path, skip_cols=skip)
    jdata, jlabels = jio.load_whitespace_dataset(path, skip_cols=skip)
    np.testing.assert_array_equal(data, jdata)
    assert labels == jlabels
    assert tio._split_quoted('a "b c" d') == jio._split_quoted('a "b c" d') \
        == ["a", "b c", "d"]
