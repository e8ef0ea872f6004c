"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each kernel source under ``ops/csrc/`` compiles with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), in ``build/kernels/`` at the root of the checkout. A library's
file name carries a hash of its sources and flags, so a changed source
rebuilds and an unchanged one is loaded as it is. A missing ``nvcc`` or a
failed build raises :class:`KernelBuildError`; nothing falls back.

One library is host code: ``crc32c`` (``csrc/crc32c.cpp``, the stream
engine's checksum of every frame) builds with the host C++ compiler
(``g++``/``c++`` on PATH) and :data:`HOST_FLAGS`, into the same directory
under the same naming; :data:`NVCC_FLAGS` stay the kernels' alone.

A library may be built as a *variant*: the same source compiled with a tuple
of ``-D`` defines (``("LAB_BODY=3", "LAB_NO_MASK=1")``), hashed into the
file name with the sources and flags. A target is a library name or a
``(name, defines)`` pair; :func:`build` starts one ``nvcc`` per target, all
together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple, Union

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# Never --use_fast_math: the divide plans need correctly rounded division.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Flags of the host-code libraries (HOST_LIBS).
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

# Library name -> its sources (the first is compiled; all are hashed).
SOURCES: Dict[str, tuple] = {
    "stencil_fused": ("stencil_fused.cu", "stencil_tile.cuh",
                      "stencil_regs.cuh"),
    "stencil_resident": ("stencil_resident.cu", "stencil_tile.cuh"),
    "stencil_valid": ("stencil_valid.cu", "stencil_tile.cuh"),
    "stencil_lab": ("stencil_lab.cu", "stencil_tile.cuh"),
    "halo_fill": ("halo_fill.cu",),
    "op_chain": ("op_chain.cu",),
    "crc32c": ("crc32c.cpp",),
}

# K1's register body's index (STENCIL_BODY_REGS in csrc/stencil_regs.cuh).
REGS_BODY = 3

# The libraries of host code, built with the host compiler.
HOST_LIBS = ("crc32c",)

# The libraries the job's path launches (what :func:`build` builds when
# given no targets, and what :func:`fingerprint` names).
JOB_KERNELS = ("stencil_fused", "stencil_resident", "stencil_valid")

# A build target: a library name, or (name, defines).
Target = Union[str, Tuple[str, Tuple[str, ...]]]

_LOADED: Dict[Target, ctypes.CDLL] = {}


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


def host_compiler() -> list:
    """The command that compiles a host library: ``g++`` (or ``c++``) on
    PATH, with :data:`HOST_FLAGS` (``nvcc`` needs one too, so a machine
    that builds the kernels has it). Raises KernelBuildError when there is
    none."""
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return [found, *HOST_FLAGS]
    raise KernelBuildError(
        "no host C++ compiler (g++, c++) on PATH: the host libraries "
        "cannot be built")


def _split(target: Target) -> Tuple[str, Tuple[str, ...]]:
    if isinstance(target, str):
        return target, ()
    name, defines = target
    return name, tuple(defines)


def library_path(name: str, defines: Iterable[str] = ()) -> Path:
    """Where the library for ``name`` built with ``defines`` lives once
    built: the file name carries a hash of the flags, the sources and the
    defines."""
    if name not in SOURCES:
        raise KeyError(f"unknown kernel library {name!r}")
    flags = HOST_FLAGS if name in HOST_LIBS else NVCC_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    for src in SOURCES[name]:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    for d in defines:
        h.update(f" -D{d}".encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def fingerprint(names: Iterable[str] = JOB_KERNELS) -> str:
    """A short hash naming the sources and flags of the libraries
    ``names``: it changes whenever one of them would be rebuilt."""
    joined = "".join(library_path(n).name for n in names)
    return hashlib.sha256(joined.encode()).hexdigest()[:12]


def build(targets: Iterable[Target] = JOB_KERNELS) -> Dict[Target, Path]:
    """Build every library of ``targets`` not built yet, one compiler per
    target (``nvcc``, or the host compiler for :data:`HOST_LIBS`), all
    started together. Returns target -> library path. Each
    build's compiler output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``<lib>.log``, ending with the
    line ``# build_seconds S`` (the ``nvcc`` wall time)."""
    targets = list(targets)
    paths = {t: library_path(*_split(t)) for t in targets}
    todo = {t: p for t, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    kernels = [t for t in todo if _split(t)[0] not in HOST_LIBS]
    nvcc = nvcc_path() if kernels else None
    host = host_compiler() if len(kernels) < len(todo) else None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n, p in todo.items():
        name, defines = _split(n)
        tmp = p.with_name(
            f"{p.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        compiler = host if name in HOST_LIBS else [nvcc, *NVCC_FLAGS]
        cmd = [*compiler, *(f"-D{d}" for d in defines), "-o",
               str(tmp), str(CSRC / SOURCES[name][0])]
        procs[n] = (tmp, cmd[0], subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for n, (tmp, exe, proc) in procs.items():
        out, _ = proc.communicate()
        p = todo[n]
        p.with_name(p.name + ".log").write_text(
            f"{out}# build_seconds {time.perf_counter() - t0:.3f}\n")
        if proc.returncode != 0:
            failed.append(f"{n}: {os.path.basename(exe)} exited "
                          f"{proc.returncode}:\n{out[-4000:]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, p)
    if failed:
        raise KernelBuildError("kernel build failed\n" + "\n".join(failed))
    return paths


def build_log(name: str, defines: Iterable[str] = ()) -> str:
    """The compiler output of the last build of ``name`` ('' if none)."""
    path = library_path(name, defines)
    log = path.with_name(path.name + ".log")
    return log.read_text() if log.exists() else ""


def build_seconds(name: str, defines: Iterable[str] = ()) -> Optional[float]:
    """The ``nvcc`` wall time of the last build of ``name``, from its log
    (None when it was not built here)."""
    m = re.search(r"^# build_seconds ([0-9.]+)$", build_log(name, defines),
                  re.M)
    return float(m.group(1)) if m else None


def ptxas_instances(log: str) -> Dict[tuple, dict]:
    """Registers and spills of every template instance of a tile kernel
    (``stencil_fused``, ``stencil_resident``, ``stencil_valid``), from its
    ``-Xptxas -v`` build log: ``(filter size, body index) -> {"registers":
    N, "spill": "..."}``, filter size 0 being the instance that reads it at
    run time; K1's register body (``stencil_fused_regs_kernel<k, C>``) as
    ``(filter size, REGS_BODY, channels)``. Other kernels' lines are
    skipped: K1's direct body (``stencil_fused_regs_direct_kernel<C,
    MIRRORED, MULHI>``), whose instance the library picks
    (:func:`cuda_stencil.instance_attributes` reads it from the card), and
    kernels of one template argument."""
    out: Dict[tuple, dict] = {}
    key = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"'_Z\d+(\w+?_kernel)ILi(\d+)ELi(\d+)E", ln)
            key = None
            if m:
                a, b = int(m.group(2)), int(m.group(3))
                key = ((a, REGS_BODY, b)
                       if m.group(1).endswith("_regs_kernel") else (a, b))
                out[key] = {}
        elif key and "registers" in ln:
            out[key]["registers"] = int(re.search(r"Used (\d+) registers",
                                                  ln).group(1))
        elif key and "spill" in ln:
            out[key]["spill"] = ln.strip()
    return out


def load(name: str, defines: Iterable[str] = ()) -> ctypes.CDLL:
    """The loaded library for ``name`` (built with ``defines``), building
    it first if needed."""
    target = (name, tuple(defines)) if defines else name
    lib = _LOADED.get(target)
    if lib is None:
        path = build([target])[target]
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
        _LOADED[target] = lib
    return lib
