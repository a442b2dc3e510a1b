"""Builds the package's CUDA sources with `nvcc` into plain shared libraries
(an `extern "C"` launcher each) and loads them with ctypes.

A library is built at first use into `build/kernels/` at the repository
root, named by a hash of its source and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load", "BUILD_DIR", "CSRC", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 600

_loaded: "dict[str, ctypes.CDLL]" = {}
build_log: "dict[str, str]" = {}  # source name -> nvcc's output (ptxas register and spill lines)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home}/bin)")
    return nvcc


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from csrc/`name`, building it if needed."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / name
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{src.stem}-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, timeout=NVCC_TIMEOUT_S,
                              check=False)
        build_log[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{build_log[name]}")
        os.replace(tmp, so)
    _loaded[name] = ctypes.CDLL(str(so))
    return _loaded[name]
