"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each kernel source under ``ops/csrc/`` compiles with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), in ``build/kernels/`` at the root of the checkout. A library's
file name carries a hash of its sources and flags, so a changed source
rebuilds and an unchanged one is loaded as it is. A missing ``nvcc`` or a
failed build raises :class:`KernelBuildError`; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# Never --use_fast_math: the divide plans need correctly rounded division.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Kernel library name -> its sources (the first is compiled; all are hashed).
SOURCES: Dict[str, tuple] = {
    "stencil_fused": ("stencil_fused.cu", "stencil_tile.cuh"),
    "stencil_resident": ("stencil_resident.cu", "stencil_tile.cuh"),
    "stencil_valid": ("stencil_valid.cu", "stencil_tile.cuh"),
}

_LOADED: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """A kernel library could not be built or loaded."""


def nvcc_path() -> str:
    """The ``nvcc`` to build with: on PATH, else under CUDA_HOME or
    /usr/local/cuda. Raises KernelBuildError when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise KernelBuildError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "cannot be built"
    )


def library_path(name: str) -> Path:
    """Where the library for ``name`` lives once built (hash-named)."""
    if name not in SOURCES:
        raise KeyError(f"unknown kernel library {name!r}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES[name]:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Build every library of ``names`` not built yet, one ``nvcc`` per
    source, all started together. Returns name -> library path. Each
    build's compiler output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``<lib>.log``."""
    names = list(names)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n][0])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        p = todo[n]
        p.with_name(p.name + ".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}:\n{out[-4000:]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, p)
    if failed:
        raise KernelBuildError("kernel build failed\n" + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler output of the last build of ``name`` ('' if none)."""
    log = library_path(name).with_name(library_path(name).name + ".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build([name])[name]
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
        _LOADED[name] = lib
    return lib
