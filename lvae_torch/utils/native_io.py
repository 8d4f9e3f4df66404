"""The data layer's native CSV reader (``csrc/csv_reader.cpp``), bound with ctypes.

The library is built with ``g++`` at its first use into
``build/lvae_torch/`` (``kernels_cuda/build.py``, keyed on a hash of the
source and the flags). A failed build raises with the compiler's output; a
file the reader cannot parse raises too. There is no fallback:
``data/datasets.read_csv_plain`` is the reader's oracle in the tests only.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from lvae_torch.kernels_cuda import build

# the C entry points' return codes
_ERRORS = {1: "cannot be opened or is empty", 2: "has no row after the header",
           3: "has a row wider than the first", 4: "has a row narrower than the first"}


def _library() -> ctypes.CDLL:
    lib = build.load("csv_reader")
    lib.lvae_csv_dims.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
    lib.lvae_csv_dims.restype = ctypes.c_int
    lib.lvae_csv_read.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_double), ctypes.c_long]
    lib.lvae_csv_read.restype = ctypes.c_int
    return lib


def read_csv_native(path: str, skip_header: int = 0) -> np.ndarray:
    """The numeric CSV at ``path`` as float64 ``[rows, cols]``, after
    ``skip_header`` lines: ``nan``/``NaN`` and empty fields read as NaN."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no CSV file at {path}")
    lib = _library()
    name = os.fsencode(path)
    rows, cols = ctypes.c_long(0), ctypes.c_long(0)
    rc = lib.lvae_csv_dims(name, skip_header, ctypes.byref(rows), ctypes.byref(cols))
    if rc == 0:
        out = np.empty((rows.value, cols.value), dtype=np.float64)
        rc = lib.lvae_csv_read(name, skip_header,
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), out.size)
        if rc == 0:
            return out
    raise ValueError(f"CSV {path} {_ERRORS.get(rc, f'failed to read (code {rc})')}")
