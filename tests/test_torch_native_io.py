"""The port's native CSV reader (lvae_torch/csrc/csv_reader.cpp, bound by
lvae_torch/utils/native_io.py) against lvae_tpu's (``native/csv_reader.cc``
through ``utils/native_io.read_csv_native``, its library checked in) and
against numpy's reader (``data/datasets.read_csv_plain``), on the CPU.

* Seeded CSVs with negatives, exponents, ``nan``/``NaN`` and empty fields,
  a header row, no trailing newline and CRLF line ends: the three readers
  give the same bits.
* ``load_healthmnist`` on the generator's files equals the JAX package's.
* What the reader refuses raises: a missing file, rows of unequal width, a
  failed build (with the compiler's output); nothing falls back.
"""

import os

import numpy as np
import pytest

from lvae_tpu.data import datasets as jds
from lvae_tpu.utils import native_io as jio
from lvae_torch.data import datasets as tds
from lvae_torch.data import healthmnist as thm
from lvae_torch.kernels_cuda import build
from lvae_torch.utils import native_io as tio

# the file's shape: (rows, cols, header, line end, trailing newline, holes)
CASES = {
    "integers": (40, 1296, False, "\n", True, False),
    "signed_exponents": (25, 17, False, "\n", True, False),
    "holes_and_header": (30, 8, True, "\n", True, True),
    "crlf_no_final_newline": (12, 9, True, "\r\n", False, True),
}


def write_csv(path, rows, cols, header, end, final, holes, seed):
    """A seeded numeric CSV; with ``holes`` some fields are empty, ``nan``
    or ``NaN`` (an empty field also at a line's end)."""
    rng = np.random.default_rng(seed)
    if cols == 1296:
        values = rng.integers(0, 256, size=(rows, cols)).astype(str)
    else:
        x = rng.normal(scale=10.0 ** rng.integers(-8, 9, size=(rows, cols)))
        fmt = np.where(rng.uniform(size=(rows, cols)) < 0.5, "%.17g", "%.6e")
        values = np.array([[f % v for f, v in zip(fr, xr)] for fr, xr in zip(fmt, x)])
    if holes:
        pick = rng.uniform(size=(rows, cols))
        values[pick < 0.08] = ""
        values[(pick >= 0.08) & (pick < 0.12)] = "nan"
        values[(pick >= 0.12) & (pick < 0.15)] = "NaN"
        values[0, -1] = ""
    lines = [",".join(f"c{j}" for j in range(cols))] if header else []
    lines += [",".join(row) for row in values]
    with open(path, "w", newline="") as f:
        f.write(end.join(lines) + (end if final else ""))


def bits(a):
    return np.ascontiguousarray(a, dtype=np.float64).view(np.uint64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_is_bit_equal_to_jax_and_to_numpy(tmp_path, case):
    rows, cols, header, end, final, holes = CASES[case]
    path = str(tmp_path / f"{case}.csv")
    write_csv(path, rows, cols, header, end, final, holes, seed=len(case))
    got = tds.read_csv(path, header=header)
    assert got.shape == (rows, cols) and got.dtype == np.float64
    want_jax = jio.read_csv_native(path, skip_header=int(header))
    assert want_jax is not None  # the JAX package's library loads here
    want_plain = tds.read_csv_plain(path, header=header)
    np.testing.assert_array_equal(bits(got), bits(want_jax))
    np.testing.assert_array_equal(bits(got), bits(want_plain))
    assert np.isnan(got).any() == holes


def test_load_healthmnist_equals_jax(tmp_path):
    thm.generate_healthmnist(2, 1, missing=30.0, num_timepoints=6, seed=5,
                             destination=str(tmp_path))
    names = ("health_MNIST_data_masked.csv", "health_MNIST_label.csv", "mask.csv")
    got = tds.load_healthmnist(*names, root_dir=str(tmp_path))
    want = jds.load_healthmnist(*names, root_dir=str(tmp_path))
    for name in ("data", "labels", "mask"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


def test_refusals_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        tds.read_csv(str(tmp_path / "missing.csv"))
    (tmp_path / "ragged.csv").write_text("1,2,3\n4,5\n")
    with pytest.raises(ValueError, match="narrower"):
        tds.read_csv(str(tmp_path / "ragged.csv"))
    (tmp_path / "wide.csv").write_text("1,2\n3,4,5\n")
    with pytest.raises(ValueError, match="wider"):
        tds.read_csv(str(tmp_path / "wide.csv"))
    (tmp_path / "header_only.csv").write_text("a,b\n")
    with pytest.raises(ValueError, match="no row"):
        tds.read_csv(str(tmp_path / "header_only.csv"), header=True)


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "GXX_FLAGS", build.GXX_FLAGS + ("--not-a-flag-of-gxx",))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    (tmp_path / "x.csv").write_text("1,2\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for csrc/csv_reader.cpp(.|\n)*"
                                           "not-a-flag-of-gxx"):
        tds.read_csv(str(tmp_path / "x.csv"))
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".so")]


def test_library_is_built_once_into_the_build_directory(tmp_path):
    (tmp_path / "x.csv").write_text("1,2\n")
    np.testing.assert_array_equal(tio.read_csv_native(str(tmp_path / "x.csv")), [[1.0, 2.0]])
    target = build._target("csv_reader")
    assert target.parent == build.BUILD_DIR and target.exists()
    assert target.name.startswith("csv_reader-")
    assert build.load("csv_reader") is build.load("csv_reader")
