"""ctypes bindings of the port's native audio decoders, its copies of the
JAX package's `data/native_loader.py` and C++ sources: `csrc/audioload.cpp`
(WAV and FLAC, a batch decoded by threads, mono downmix, seeded crop or
pad) and `csrc/ffdecode.cpp` (the FFmpeg formats, linked against
libavformat, libavcodec, libavutil and libswresample).

Each library is built with g++ at first use into `build/native/` at the
repository root, named by a digest of its source (a stale or foreign build
is never loaded), and loaded once. A failed build is remembered with
g++'s output: `native_available()` / `ff_available()` say whether the build
worked, and every decode raises with that output when it did not. Nothing
falls back to another decoder.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["native_available", "ff_available", "load_batch", "probe", "ff_decode", "ff_encode",
           "build_error", "library_path", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parent / "build" / "native"
_SOURCES = {"audioload": (_PKG / "csrc" / "audioload.cpp", ["-lpthread"]),
            "ffdecode": (_PKG / "csrc" / "ffdecode.cpp",
                         ["-lavformat", "-lavcodec", "-lavutil", "-lswresample"])}
GXX_TIMEOUT_S = 300

_lock = threading.Lock()
_libs: "dict[str, ctypes.CDLL | None]" = {}
_errors: "dict[str, str]" = {}


def library_path(name: str) -> Path:
    """Where the library of csrc/`name`.cpp lives: named by its source's
    sha256."""
    src, _ = _SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}.{digest}.so"


def _build(name: str) -> ctypes.CDLL:
    src, link = _SOURCES[name]
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp),
                               str(src), *link],
                              capture_output=True, text=True, timeout=GXX_TIMEOUT_S, check=False)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def _declare(name: str, lib: ctypes.CDLL):
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    if name == "audioload":
        lib.al_load_batch.restype = ctypes.c_int
        lib.al_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long, ctypes.c_ulonglong,
            f32, np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"), ctypes.c_int]
        lib.al_probe.restype = ctypes.c_int
        lib.al_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                                 ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    else:
        lib.ffd_decode_alloc.restype = ctypes.c_int
        lib.ffd_decode_alloc.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)]
        lib.ffd_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.ffd_encode.restype = ctypes.c_int
        lib.ffd_encode.argtypes = [ctypes.c_char_p, f32, ctypes.c_long, ctypes.c_int]


def _get(name: str) -> "ctypes.CDLL | None":
    """The loaded library, built on the first call; None if its build failed
    (`build_error(name)` holds why)."""
    with _lock:
        if name not in _libs:
            try:
                lib = _build(name)
                _declare(name, lib)
                _libs[name] = lib
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _libs[name], _errors[name] = None, str(e)
        return _libs[name]


def _require(name: str, what: str) -> ctypes.CDLL:
    lib = _get(name)
    if lib is None:
        raise RuntimeError(f"{what} needs the native library built from "
                           f"csrc/{name}.cpp, whose build failed: {_errors[name]}")
    return lib


def build_error(name: str) -> "str | None":
    """Why the build of csrc/`name`.cpp failed, or None."""
    _get(name)
    return _errors.get(name)


def native_available() -> bool:
    """Whether the WAV/FLAC decoder (csrc/audioload.cpp) built."""
    return _get("audioload") is not None


def ff_available() -> bool:
    """Whether the FFmpeg decoder (csrc/ffdecode.cpp) built."""
    return _get("ffdecode") is not None


def probe(path):
    """(samples, rate, channels) of a WAV or FLAC file."""
    lib = _require("audioload", "probing audio")
    length, rate, ch = ctypes.c_long(), ctypes.c_int(), ctypes.c_int()
    if lib.al_probe(str(path).encode(), ctypes.byref(length), ctypes.byref(rate),
                    ctypes.byref(ch)) != 0:
        raise IOError(f"failed to probe {path}")
    return int(length.value), int(rate.value), int(ch.value)


def load_batch(paths, max_length: int, *, seed: int = 0, num_threads: int = 8):
    """Decode, downmix to mono and crop (seeded by `seed` and the file's
    index) or zero-pad a batch of WAV/FLAC files in parallel. Returns (out
    (n, max_length) float32, lengths (n,) int64, rates (n,) int32)."""
    lib = _require("audioload", "decoding WAV/FLAC")
    n = len(paths)
    out = np.zeros((n, max_length), np.float32)
    lengths = np.zeros((n,), np.int64)
    rates = np.zeros((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.al_load_batch(arr, n, max_length, seed, out, lengths, rates, num_threads)
    if rc != 0:
        raise IOError(f"failed to decode {paths[rc - 1]}")
    return out, lengths, rates


def ff_decode(path):
    """Any FFmpeg-supported audio file -> (mono float32 (T,), rate)."""
    lib = _require("ffdecode", "decoding FFmpeg formats")
    buf = ctypes.POINTER(ctypes.c_float)()
    n, rate = ctypes.c_long(), ctypes.c_int()
    rc = lib.ffd_decode_alloc(str(path).encode(), ctypes.byref(buf), ctypes.byref(n),
                              ctypes.byref(rate))
    if rc != 0:
        raise IOError(f"FFmpeg failed to decode {path} (code {rc})")
    out = np.ctypeslib.as_array(buf, shape=(n.value,)).copy()
    lib.ffd_free(buf)
    return out, int(rate.value)


def ff_encode(path, pcm, rate: int):
    """Encode mono float32 PCM with the container's default codec (.mp3 ->
    lame, .webm -> opus, .ogg -> vorbis); for test fixtures."""
    lib = _require("ffdecode", "encoding FFmpeg formats")
    pcm = np.ascontiguousarray(pcm, np.float32)
    rc = lib.ffd_encode(str(path).encode(), pcm, len(pcm), int(rate))
    if rc != 0:
        raise IOError(f"FFmpeg failed to encode {path} (code {rc})")
