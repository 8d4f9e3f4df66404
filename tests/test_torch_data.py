"""The port's data layer (lvae_torch/data/healthmnist.py, datasets.py)
against lvae_tpu's, on the CPU.

* The Health MNIST generator: at one seed the port's frames, masked frames,
  mask and labels equal JAX's exactly (the same numpy draws and scipy
  ``ndimage`` calls over the same glyph raster), and the label CSV reads
  back the same in both packages.
* The loaders: Health MNIST CSVs written by either generator, a CSV with
  pixel values outside 0..255 (the ``uint8`` wrap) and empty label fields
  (NaN → 0), Rotated MNIST ``.npy`` (integer and float data) and a Physionet
  ``.npz``, each loaded by both packages: equal arrays.
* No pandas, no matplotlib and no PIL on the port's path: a fresh
  interpreter with all three blocked generates (procedural and from the
  committed real-image fixtures, ``--source``), loads and saves a
  generation grid with its PDF; another, with JAX blocked too, imports
  every lvae_torch module and runs ``python -m lvae_torch.cli generate``.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from lvae_tpu.data import datasets as jds
from lvae_tpu.data import healthmnist as jhm
from lvae_torch.data import datasets as tds
from lvae_torch.data import healthmnist as thm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same_dataset(got, want):
    for name in ("data", "labels", "mask"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("digit", ["3", "6"])
def test_glyph_equals_jax_rendering(digit):
    np.testing.assert_array_equal(thm.digit_template(digit), jhm._render_digit_template(digit))


def test_generator_matches_jax(tmp_path):
    want = jhm.generate_healthmnist(2, 1, missing=30.0, num_timepoints=6, seed=7,
                                    destination=str(tmp_path / "jax"))
    got = thm.generate_healthmnist(2, 1, missing=30.0, num_timepoints=6, seed=7,
                                   destination=str(tmp_path / "torch"))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[3], want[3].to_numpy(dtype=np.float64))
    assert np.isnan(got[3][:, 4]).any()  # healthy subjects' disease_time
    for name in ("health_MNIST_data.csv", "health_MNIST_data_masked.csv", "mask.csv"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "torch" / name).read_bytes()
    for d in ("jax", "torch"):
        labels = jds._read_csv_fast(str(tmp_path / d / "health_MNIST_label.csv"), header=True)
        np.testing.assert_array_equal(labels, want[3].to_numpy(dtype=np.float64))


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("conv", [True, False])
def test_healthmnist_loader_matches_jax(tmp_path, writer, conv):
    gen = jhm if writer == "jax" else thm
    gen.generate_split(str(tmp_path), num_3=1, num_6=1, seed=3,
                       splits=(("", 1.0), ("test", 1.0)))
    for suffix in ("", "_test"):
        args = (f"health_MNIST_data_masked{suffix}.csv", f"health_MNIST_label{suffix}.csv",
                f"mask{suffix}.csv", str(tmp_path))
        assert_same_dataset(tds.load_healthmnist(*args, conv=conv),
                            jds.load_healthmnist(*args, conv=conv))


def test_healthmnist_uint8_wrap_and_empty_labels(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.integers(-20, 280, size=(6, 1296))
    np.savetxt(tmp_path / "d.csv", data, fmt="%d", delimiter=",")
    rows = ["subject,digit,angle,disease,disease_time,gender,time_age,location"]
    for i in range(6):
        dt = "" if i % 2 else f"{i - 3.0}"
        rows.append(f"{i // 3},{3 if i < 3 else 6},{rng.normal():.17g},{i % 2},{dt},1,{i},0")
    (tmp_path / "l.csv").write_text("\n".join(rows) + "\n")
    for mask_file in (None, "d.csv"):
        got = tds.load_healthmnist("d.csv", "l.csv", mask_file, str(tmp_path))
        want = jds.load_healthmnist("d.csv", "l.csv", mask_file, str(tmp_path))
        assert_same_dataset(got, want)
    assert got.data.max() <= 1.0 and (got.labels[1::2, 1] == 0).all()


@pytest.mark.parametrize("kind", [np.uint8, np.float32])
def test_rotatedmnist_loader_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, size=(2, 3, 784))
    np.save(tmp_path / "x.npy", raw.astype(kind))
    np.save(tmp_path / "y.npy", rng.normal(size=(4, 6)))
    np.save(tmp_path / "m.npy", (rng.uniform(size=(6, 784)) > 0.5).astype(np.float64))
    for mask in (None, "m.npy"):
        for conv in (True, False):
            args = ("x.npy", "y.npy", mask, str(tmp_path))
            assert_same_dataset(tds.load_rotatedmnist(*args, conv=conv),
                                jds.load_rotatedmnist(*args, conv=conv))


def test_physionet_loader_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    np.savez(tmp_path / "p.npz", data_readings=rng.normal(size=(3, 4, 5)),
             outcome_attrib=rng.normal(size=(3, 4, 10)) + 30,
             data_mask=rng.integers(0, 2, size=(3, 4, 5)),
             outcome_mask=rng.integers(0, 2, size=(3, 4, 2)))
    assert_same_dataset(tds.load_physionet("p.npz", str(tmp_path)),
                        jds.load_physionet("p.npz", str(tmp_path)))


def test_load_dataset_dispatch(tmp_path):
    from lvae_torch.config import LVAEConfig

    thm.generate_split(str(tmp_path), num_3=1, num_6=1, splits=(("", 1.0), ("test", 1.0)))
    cfg = LVAEConfig(data_source_path=str(tmp_path), csv_file_data="health_MNIST_data.csv",
                     csv_file_label="health_MNIST_label.csv", mask_file="mask.csv",
                     csv_file_test_data="health_MNIST_data_test.csv",
                     csv_file_test_label="health_MNIST_label_test.csv")
    train = tds.load_dataset(cfg, "train")
    assert train.data.shape == (40, 36, 36, 1) and train.num_covariates == 6
    assert tds.load_dataset(cfg, "test").mask.shape == (40, 1296)
    assert tds.load_dataset(cfg, "validation") is None
    with pytest.raises(ValueError, match="dataset_type"):
        tds.load_dataset(LVAEConfig(csv_file_data="x", dataset_type="MNIST"), "train")


def test_full_size_csv_reads_in_seconds(tmp_path):
    """A 2000 × 1296 integer CSV (the config file's cohort) loads in a few
    seconds through the native reader."""
    data = np.random.default_rng(3).integers(0, 256, size=(2000, 1296))
    np.savetxt(tmp_path / "big.csv", data, fmt="%d", delimiter=",")
    t0 = time.perf_counter()
    got = tds.read_csv(str(tmp_path / "big.csv"))
    seconds = time.perf_counter() - t0
    np.testing.assert_array_equal(got, data)
    assert seconds < 15.0, seconds


def test_port_data_path_needs_no_pandas_or_matplotlib(tmp_path):
    source = os.path.join(ROOT, "tests", "fixtures", "torch_source_digits")
    code = f"""
import sys
for blocked in ("pandas", "matplotlib", "PIL"):
    sys.modules[blocked] = None
import numpy as np
from lvae_torch.data import datasets, healthmnist
from lvae_torch.evaluation.generation import save_grid
healthmnist.main(["--destination", {str(tmp_path)!r}, "--num_3", "1", "--num_6", "1"])
ds = datasets.load_healthmnist("health_MNIST_data_masked.csv", "health_MNIST_label.csv",
                               "mask.csv", {str(tmp_path)!r})
assert ds.data.shape == (40, 36, 36, 1), ds.data.shape
healthmnist.main(["--destination", {str(tmp_path / "real")!r}, "--num_3", "2", "--num_6", "1",
                  "--source", {source!r}])
real = datasets.load_healthmnist("health_MNIST_data_masked.csv", "health_MNIST_label.csv",
                                 "mask.csv", {str(tmp_path / "real")!r})
assert real.data.shape == (60, 36, 36, 1), real.data.shape
path = save_grid({str(tmp_path / "grid.pdf")!r}, np.zeros((3, 20, 36, 36)), np.zeros((3, 20), bool))
assert "pandas" not in sys.modules or sys.modules["pandas"] is None
print("OK", path)
"""
    out = subprocess.run([sys.executable, "-c", code], env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout
    assert (tmp_path / "grid.npz").exists() and (tmp_path / "grid.pdf").exists()
    assert (tmp_path / "grid.pdf").read_bytes().startswith(b"%PDF-")


def test_every_module_imports_without_pandas_or_matplotlib(tmp_path):
    """Every lvae_torch module imports with pandas, matplotlib, PIL and JAX
    blocked, and ``python -m lvae_torch.cli generate`` runs so."""
    code = f"""
import importlib, pkgutil, runpy, sys
for blocked in ("pandas", "matplotlib", "PIL", "jax", "flax", "optax", "lvae_tpu"):
    sys.modules[blocked] = None
import lvae_torch
names = [m.name for m in pkgutil.walk_packages(lvae_torch.__path__, "lvae_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("cli", "pipeline", "data.datasets", "data.healthmnist", "data.image_io", "utils.pdf",
             "train.pretrain",
             "evaluation.validate", "evaluation.testing", "evaluation.generation",
             "utils.checkpoint", "utils.metrics", "utils.debug", "kernels_cuda.block_pair"):
    assert "lvae_torch." + name in names, name
sys.argv = ["lvae_torch.cli", "--device=cpu", "generate", "--destination", {str(tmp_path)!r},
            "--num_3", "1", "--num_6", "1"]
try:
    runpy.run_module("lvae_torch.cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
"""
    out = subprocess.run([sys.executable, "-c", code], env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "Saved! Number of samples: 40" in out.stdout
    assert (tmp_path / "health_MNIST_label.csv").exists()
