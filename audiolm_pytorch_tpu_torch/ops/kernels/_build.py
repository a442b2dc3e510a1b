"""Builds the package's CUDA sources with `nvcc` into plain shared libraries
(an `extern "C"` launcher each) and loads them with ctypes.

A library is built at first use into `build/kernels/` at the repository
root, named by a digest of its source, every header in `csrc/` (`*.cuh`,
which any source may include) and the flags, so an edited source or header
is rebuilt and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["load", "built_with", "library_path", "source_digest", "sass_counts",
           "sass_counts_of", "BUILD_DIR", "CSRC", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 600

_loaded: "dict[tuple[str, tuple[str, ...]], ctypes.CDLL]" = {}
build_log: "dict[str, str]" = {}  # source name -> nvcc's output (ptxas register and spill lines)


def _tool(name: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which(name) or os.path.join(cuda_home, "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found (looked on PATH and in {cuda_home}/bin)")
    return path


def source_digest(src: Path, flags, csrc: Path = CSRC) -> str:
    """16 hex digits over the source's bytes, each header's name and bytes in
    `csrc` (sorted by name) and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _flags(defines) -> "list[str]":
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(name: str, defines=()) -> Path:
    """Where csrc/`name` built with `defines` (macro names) lives."""
    src = CSRC / name
    suffix = "".join(f"-{d}" for d in defines)
    return BUILD_DIR / f"{src.stem}{suffix}-{source_digest(src, _flags(defines))}.so"


_variant: "tuple[str, ...]" = ()  # the macros `load` takes by default; see built_with


@contextlib.contextmanager
def built_with(defines):
    """Within the block every wrapper launches its kernel from the build with
    the extra macros `defines` (a test's variant, such as plain TF32)."""
    global _variant
    saved, _variant = _variant, tuple(defines)
    try:
        yield
    finally:
        _variant = saved


def load(name: str, defines=None) -> ctypes.CDLL:
    """The loaded library built from csrc/`name`, building it if needed;
    `defines` are extra macros (-D) of a variant, such as a test's (by
    default those of the enclosing `built_with`, none outside one)."""
    defines = _variant if defines is None else tuple(defines)
    key = (name, defines)
    if key in _loaded:
        return _loaded[key]
    src = CSRC / name
    so = library_path(name, defines)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_tool("nvcc"), *_flags(defines), "-I", str(CSRC), "-o", str(tmp),
                               str(src)],
                              capture_output=True, text=True, timeout=NVCC_TIMEOUT_S,
                              check=False)
        log_key = name if not defines else f"{name} {' '.join(defines)}"
        build_log[log_key] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {log_key}:\n{build_log[log_key]}")
        os.replace(tmp, so)
    _loaded[key] = ctypes.CDLL(str(so))
    return _loaded[key]


def sass_counts(name: str) -> "dict[str, dict[str, int]]":
    """{kernel's mangled name: {"HMMA": n, "HGMMA": n, "UTMALDG": n, "FFMA":
    n}} in the SASS of the built library of csrc/`name` (built first if need
    be), by `cuobjdump -sass`: HMMA is a warp's tensor-core product
    (mma.sync), HGMMA a warpgroup's (wgmma), UTMALDG a TMA tile load, FFMA a
    float32 FMA."""
    load(name)
    return sass_counts_of(library_path(name))


def sass_counts_of(so: Path) -> "dict[str, dict[str, int]]":
    """`sass_counts` of the library at `so` (another checkout's, say)."""
    proc = subprocess.run([_tool("cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, timeout=300, check=True)
    counts: "dict[str, dict[str, int]]" = {}
    current = None
    for line in proc.stdout.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            current = counts.setdefault(fn.group(1),
                                        {"HMMA": 0, "HGMMA": 0, "UTMALDG": 0, "FFMA": 0})
        elif current is not None:
            op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
            if op and op.group(1) in current:
                current[op.group(1)] += 1
    return counts
