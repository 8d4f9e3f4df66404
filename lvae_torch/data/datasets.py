"""Array-backed datasets (port of lvae_tpu.data.datasets).

Each dataset is loaded once into contiguous numpy arrays; the trainers move
them to the device whole. CSV files are read by the port's native reader
(``utils/native_io.py``, C++ built with g++ at first use; no pandas);
:func:`read_csv_plain`, numpy's reader, is its oracle in the tests. The
label semantics are the reference's:

* Health MNIST label columns are reordered to
  ``[time_age, disease_time, subject, gender, disease, location]``
  (``HEALTH_LABEL_ORDER``) with NaN → 0 (``disease_time`` of healthy
  subjects is an empty field in the CSV);
* pixel values go through ``uint8`` before the ``/255`` scaling, so values
  outside 0..255 wrap modulo 256 as the reference's loader makes them;
* Physionet labels get ``label[8] -= 24`` and the outcome mask appended.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

from lvae_torch.utils.native_io import read_csv_native

HEALTH_LABEL_ORDER = [6, 4, 0, 5, 3, 7]


class ArrayDataset(NamedTuple):
    """A fully materialised longitudinal dataset.

    ``data``   — float32 ``[N, ...]`` in [0, 1]; images are ``[N, H, W, 1]``
                 (NHWC) for conv models, flat ``[N, D]`` otherwise.
    ``labels`` — float ``[N, Q]`` auxiliary covariates (reordered, NaN→0).
    ``mask``   — float32 ``[N, D]`` observation mask (1 = observed).
    """

    data: np.ndarray
    labels: np.ndarray
    mask: np.ndarray

    def __len__(self) -> int:
        return self.data.shape[0]

    @property
    def num_dim(self) -> int:
        return int(np.prod(self.data.shape[1:]))

    @property
    def num_covariates(self) -> int:
        return self.labels.shape[1]

    def flat_data(self) -> np.ndarray:
        return self.data.reshape(len(self), -1)


def _field(s: str) -> float:
    s = s.strip()
    return float(s) if s else np.nan


def read_csv(path: str, header: bool = False) -> np.ndarray:
    """A numeric CSV as float64 ``[rows, cols]``, through the native reader;
    with ``header`` the first line is skipped. ``nan``/``NaN`` and empty
    fields read as NaN."""
    return read_csv_native(path, skip_header=1 if header else 0)


def read_csv_plain(path: str, header: bool = False) -> np.ndarray:
    """:func:`read_csv` through numpy's reader: the oracle the native
    reader is held to. Empty fields take a per-field Python converter."""
    skip = 1 if header else 0
    try:
        return np.loadtxt(path, delimiter=",", dtype=np.float64, skiprows=skip, ndmin=2)
    except ValueError:
        return np.loadtxt(path, delimiter=",", dtype=np.float64, skiprows=skip, ndmin=2,
                          converters=_field)


def load_healthmnist(
    csv_file_data: str,
    csv_file_label: str,
    mask_file: Optional[str] = None,
    root_dir: str = ".",
    conv: bool = True,
) -> ArrayDataset:
    """Health MNIST: a headerless ``[N, 1296]`` pixel CSV, a label CSV with
    a header row, and an optional headerless mask CSV."""
    data = read_csv(os.path.join(root_dir, csv_file_data))
    n = data.shape[0]
    labels = np.nan_to_num(
        read_csv(os.path.join(root_dir, csv_file_label), header=True)[:, HEALTH_LABEL_ORDER]
    )
    if mask_file is not None:
        mask = read_csv(os.path.join(root_dir, mask_file)).astype(np.float32)
    else:
        mask = np.ones_like(data, dtype=np.float32)
    # through uint8 before the /255, as the reference's loader does: values
    # outside 0..255 in reference-made CSVs wrap modulo 256 (a no-op for
    # this package's generator, which clips)
    x = (data.astype(np.uint8) / 255.0).astype(np.float32)
    if conv:
        x = x.reshape(n, 36, 36, 1)
    return ArrayDataset(data=x, labels=labels, mask=mask)


def load_rotatedmnist(
    data_file: str,
    label_file: str,
    mask_file: Optional[str] = None,
    root_dir: str = ".",
    conv: bool = True,
) -> ArrayDataset:
    """Rotated MNIST from ``.npy`` files. Integer data is scaled by 1/255,
    float data passes unscaled (torchvision's ``ToTensor`` rule)."""
    data = np.load(os.path.join(root_dir, data_file))
    data = data.reshape(-1, data.shape[-1])
    label = np.load(os.path.join(root_dir, label_file))
    labels = label.reshape(label.shape[0], -1).T.astype(np.float64)
    if mask_file is not None:
        mask = np.load(os.path.join(root_dir, mask_file)).astype(np.float32)
        mask = mask.reshape(data.shape)
    else:
        mask = np.ones_like(data, dtype=np.float32)
    if np.issubdtype(data.dtype, np.integer):
        x = (data.astype(np.uint8) / 255.0).astype(np.float32)
    else:
        x = data.astype(np.float32)
    if conv:
        x = x.reshape(-1, 28, 28, 1)
    return ArrayDataset(data=x, labels=labels, mask=mask)


def load_physionet(data_file: str, root_dir: str = ".") -> ArrayDataset:
    """Physionet 2012 from one ``.npz`` bundle."""
    bundle = np.load(os.path.join(root_dir, data_file))
    data = bundle["data_readings"].reshape(-1, bundle["data_readings"].shape[-1])
    labels = bundle["outcome_attrib"].reshape(-1, bundle["outcome_attrib"].shape[-1])
    mask = bundle["data_mask"].reshape(-1, bundle["data_mask"].shape[-1])
    label_mask = bundle["outcome_mask"].reshape(-1, bundle["outcome_mask"].shape[-1])
    labels = labels.astype(np.float64).copy()
    labels[:, 8] = labels[:, 8] - 24.0
    full_labels = np.concatenate([labels, label_mask.astype(np.float64)], axis=1)
    return ArrayDataset(
        data=data.astype(np.float32),
        labels=full_labels,
        mask=mask.astype(np.float32),
    )


def load_dataset(cfg, which: str = "train", conv: Optional[bool] = None) -> Optional[ArrayDataset]:
    """The dataset the config names for ``which`` ∈ {train, test,
    prediction, validation, generation}, or None when it names none."""
    prefix = {
        "train": "",
        "test": "test_",
        "prediction": "prediction_",
        "validation": "validation_",
        "generation": "generation_",
    }[which]
    if which == "train":
        data_f = cfg.csv_file_data
        label_f = cfg.csv_file_label
        mask_f = cfg.mask_file
    else:
        data_f = getattr(cfg, f"csv_file_{which}_data")
        label_f = getattr(cfg, f"csv_file_{which}_label")
        mask_f = getattr(cfg, f"{prefix}mask_file")
    if data_f is None:
        return None
    if conv is None:
        conv = cfg.type_nnet == "conv"
    if cfg.dataset_type == "HealthMNIST":
        return load_healthmnist(data_f, label_f, mask_f, cfg.data_source_path, conv=conv)
    if cfg.dataset_type == "RotatedMNIST":
        return load_rotatedmnist(data_f, label_f, mask_f, cfg.data_source_path, conv=conv)
    if cfg.dataset_type == "Physionet":
        return load_physionet(data_f, cfg.data_source_path)
    raise ValueError(f"Unknown dataset_type {cfg.dataset_type!r}")
