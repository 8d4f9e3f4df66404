"""Build the package's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/lvae_torch/<name>-<hash>.so`` under the repository root, where
``<hash>`` is taken over the source, the shared headers ``csrc/*.cuh`` and
the compiler flags (an edited header rebuilds every source), and loaded with
``ctypes``. Nothing is built when a module is imported: the CPU tests import
every module on a host without ``nvcc``. :func:`build_all` starts one
``nvcc`` per source, all at once, and waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lvae_torch"
SOURCES = ("chol_inv", "b_chain", "kernel_matrix", "adam")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under $CUDA_HOME/bin): the "
            "CUDA kernels build only where the CUDA toolkit is installed"
        )
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


class _Build(NamedTuple):
    proc: subprocess.Popen
    tmp: Path
    target: Path


def _start(name: str) -> Optional[_Build]:
    """Start nvcc for ``name`` unless its library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return _Build(proc, tmp, target)


def _finish(name: str, build: _Build) -> str:
    out, _ = build.proc.communicate()
    if build.proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(build.tmp, build.target)  # a concurrent loader sees all or nothing
    return out


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source in parallel; returns nvcc's output per
    source (resource usage from ``-Xptxas -v``), empty when already built."""
    names = list(names)
    builds = {name: _start(name) for name in names}
    logs: Dict[str, str] = {}
    errors: List[str] = []
    for name, build in builds.items():
        if build is None:
            logs[name] = ""
            continue
        try:
            logs[name] = _finish(name, build)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
