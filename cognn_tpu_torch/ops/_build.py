"""Build and load the CUDA kernels of ``cognn_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into
a shared library with a plain C interface, loaded with ``ctypes``. Libraries
go to ``cognn_tpu_torch/_build/``, named by a hash of the sources and flags,
so a changed source is rebuilt and an unchanged one is reused. Nothing is
compiled at import time: the first launch builds, or :func:`build` does it up
front. A compile error raises.
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


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for the current sources."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):  # .cu and shared .cuh headers
        digest.update(f.name.encode() + f.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def compile_cu(src: Path, out: Path) -> str:
    """Compile the CUDA source ``src`` into the shared library ``out``
    (written whole or not at all). Returns the compiler's output (register
    and spill counts from ``-Xptxas=-v``); raises if the compile fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{r.stdout}")
    os.replace(tmp, out)
    return r.stdout


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is built already.
    Returns the compiler's output (empty when the library was reused);
    raises if the compile fails."""
    out = lib_path(name)
    if out.exists():
        return ""
    return compile_cu(CSRC / f"{name}.cu", out)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build(name)
    return ctypes.CDLL(str(lib_path(name)))
