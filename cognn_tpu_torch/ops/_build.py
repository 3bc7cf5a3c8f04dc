"""Build and load the native libraries of ``cognn_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` (a CUDA kernel, :data:`SOURCES`) is compiled by
``nvcc`` for ``sm_90a`` (Hopper), and each ``csrc/<name>.cpp`` (host code,
:data:`HOST_SOURCES`: the graph file parser) by the host C++ compiler
(``$CXX``, else ``g++``), into a shared library with a plain C interface,
loaded with ``ctypes``. Libraries go to ``cognn_tpu_torch/_build/``, named
by a hash of the sources and flags, so a changed source is rebuilt and an
unchanged one is reused. Nothing is compiled at import time: the first use
builds, or :func:`build` does it up front. A missing compiler or a compile
error raises, with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("spmm", "ring_matmul", "spmm_merged", "sddmm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
HOST_SOURCES = ("graph_io",)
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None or shutil.which(cxx) is None:
        raise RuntimeError(f"no host C++ compiler ({cxx or 'g++'} not "
                           "found): set CXX to one")
    return cxx


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` (or, for a name of
    :data:`HOST_SOURCES`, ``csrc/<name>.cpp``) lives for the current
    sources."""
    if name in HOST_SOURCES:
        flags, sources = HOST_FLAGS, [CSRC / f"{name}.cpp"]
    else:  # .cu and shared .cuh headers
        flags, sources = NVCC_FLAGS, sorted(CSRC.glob("*.cu*"))
    digest = hashlib.sha256(" ".join(flags).encode())
    for f in sources:
        digest.update(f.name.encode() + f.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _compile(command, src: Path, out: Path) -> str:
    """Run ``command`` + ``-o <tmp> src`` and move the library to ``out``
    (written whole or not at all). Returns the compiler's output; raises
    with it if the compile fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    r = subprocess.run([*command, "-o", str(tmp), str(src)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{Path(command[0]).name} failed for "
                           f"{src.name}:\n{r.stdout}")
    os.replace(tmp, out)
    return r.stdout


def compile_cu(src: Path, out: Path) -> str:
    """Compile the CUDA source ``src`` into the shared library ``out``.
    Returns the compiler's output (register and spill counts from
    ``-Xptxas=-v``); raises if the compile fails."""
    return _compile([_nvcc(), *NVCC_FLAGS], src, out)


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (``.cpp`` for :data:`HOST_SOURCES`)
    unless its library is built already. Returns the compiler's output
    (empty when the library was reused); raises if the compile fails."""
    out = lib_path(name)
    if out.exists():
        return ""
    if name in HOST_SOURCES:
        return _compile([_cxx(), *HOST_FLAGS], CSRC / f"{name}.cpp", out)
    return compile_cu(CSRC / f"{name}.cu", out)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built first if needed."""
    build(name)
    return ctypes.CDLL(str(lib_path(name)))
