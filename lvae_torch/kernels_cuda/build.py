"""Build the package's native sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``, and each
host source ``csrc/<name>.cpp`` (the CSV reader) by ``g++``, into
``build/lvae_torch/<name>-<hash>.so`` under the repository root, where
``<hash>`` is taken over the source, for a CUDA source the shared headers
``csrc/*.cuh`` (an edited header rebuilds every kernel), and the compiler
flags, and loaded with ``ctypes``. Nothing is built when a module is
imported: the CPU tests import every module on a host without ``nvcc``.
:func:`build_all` starts one compiler per source, all at once, and waits
for them; a failed build raises with the compiler's output.
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
SOURCES = ("chol_inv", "b_chain", "kernel_matrix", "adam", "block_pair")  # CUDA kernels
HOST_SOURCES = ("csv_reader",)  # host C++
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

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


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH: the host sources build only with it")
    return found


def _source(name: str) -> Path:
    cuda = CSRC / f"{name}.cu"
    return cuda if cuda.exists() else CSRC / f"{name}.cpp"


def _target(name: str) -> Path:
    source = _source(name)
    h = hashlib.sha256(source.read_bytes())
    if source.suffix == ".cu":
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
    else:
        h.update(" ".join(GXX_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


class _Build(NamedTuple):
    proc: subprocess.Popen
    tmp: Path
    target: Path


def _start(name: str) -> Optional[_Build]:
    """Start the compiler for ``name`` unless its library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    source = _source(name)
    compiler = (_nvcc(), *NVCC_FLAGS) if source.suffix == ".cu" else (_gxx(), *GXX_FLAGS)
    cmd = [*compiler, "-o", str(tmp), str(source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return _Build(proc, tmp, target)


def _finish(name: str, build: _Build) -> str:
    out, _ = build.proc.communicate()
    if build.proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(build.proc.args[0])} failed for "
                           f"csrc/{_source(name).name}:\n{out}")
    os.replace(build.tmp, build.target)  # a concurrent loader sees all or nothing
    return out


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source in parallel; returns the compiler's output
    per source (for a kernel, resource usage from ``-Xptxas -v``), empty when
    already built."""
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
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp``, built on first
    use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
