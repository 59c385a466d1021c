"""Build and load the port's CUDA kernels.

Each kernel is one file csrc/<name>.cu with a plain C interface.  At first
use it is compiled with nvcc for sm_90a into build/xeve_tpu_torch/ at the
root of the checkout, and loaded with ctypes.  A library older than its
source is rebuilt.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "xeve_tpu_torch")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                       "kernels are built on the machine with the card")


def compile_cu(src: str, out: str, extra=()) -> str:
    """nvcc one .cu source into the shared library `out` (written under a
    temporary name, then renamed into place); returns nvcc's stderr."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                        *extra, "-o", tmp, src],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr}")
    os.replace(tmp, out)
    return r.stderr


def build(name: str) -> str:
    """Compile csrc/<name>.cu into lib<name>.so if it is missing or older
    than its source; returns the library's path."""
    src = os.path.join(CSRC, name + ".cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if not (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(src)):
        compile_cu(src, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(build(name))
    return lib
