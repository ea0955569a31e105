"""Build and load a CUDA kernel of the package.

A kernel is one ``csrc/<name>.cu`` file with a plain C interface. At first
use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``sequitr_tpu_torch/_build/`` and loaded with ``ctypes``; the
library is rebuilt when it is older than its source. A failed build raises
and leaves no file behind: no caller falls back to a plain version for a
CUDA tensor. A study may build a variant of a kernel beside it (``defines``,
``variant``): the same source with preprocessor switches set.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Sequence

__all__ = ["build", "load"]

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC_DIR = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")

_COMMON_HEAD = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
_COMMON_TAIL = ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# nvcc flags per kernel. The histogram forbids fused multiply-add: its bucket
# must round the subtract and the multiply separately, as the plain version
# does; so do the int8 conv's dequantizing epilogue and the Euler steps. The
# 3x3 convolution's accumulation is made of fused multiply-adds.
NVCC_FLAGS = {
    "histogram": _COMMON_HEAD + ("-fmad=false",) + _COMMON_TAIL,
    "conv3x3": _COMMON_HEAD + _COMMON_TAIL,
    "mma_rate": _COMMON_HEAD + _COMMON_TAIL,
    "qconv": _COMMON_HEAD + ("-fmad=false",) + _COMMON_TAIL,
    "flows": _COMMON_HEAD + ("-fmad=false",) + _COMMON_TAIL,
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from source at first use"
    )


def _paths(name: str, variant: str = ""):
    tail = f"-{variant}" if variant else ""
    return os.path.join(_SRC_DIR, f"{name}.cu"), os.path.join(_BUILD_DIR, f"lib{name}{tail}.so")


def build(name: str, force: bool = False, defines: Sequence[str] = (), variant: str = "") -> str:
    """Compile ``csrc/<name>.cu`` unless its library is up to date (or
    ``force``); returns nvcc's output (the ``-Xptxas -v`` register and
    shared-memory report), ``""`` when nothing was built. ``defines`` are
    preprocessor names to set (``-D``), for a library named after ``variant``."""
    if name not in NVCC_FLAGS:
        raise ValueError(f"unknown kernel {name!r}: one of {sorted(NVCC_FLAGS)}")
    if bool(defines) != bool(variant):
        raise ValueError("a variant has a name and defines, the kernel itself neither")
    src, lib = _paths(name, variant)
    if not force and os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return ""
    nvcc = _nvcc()  # before any file is made: without it nothing is left behind
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # compile to a unique name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS[name], *(f"-D{d}" for d in defines), "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"CUDA kernel build failed: {name} (nvcc exit {proc.returncode}):\n{proc.stdout}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout


def load(name: str, defines: Sequence[str] = (), variant: str = "") -> ctypes.CDLL:
    """The kernel's shared library, built first if it is missing or stale."""
    build(name, defines=defines, variant=variant)
    return ctypes.CDLL(_paths(name, variant)[1])
