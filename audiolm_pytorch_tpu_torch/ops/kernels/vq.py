"""Nearest-code search of vector quantization: the wrapper of the
hand-written Hopper kernel `csrc/vq.cu` and its plain PyTorch version.

Replaces the JAX package's Pallas kernel `ops/pallas/vq.py::_kernel`
(`vq_nearest_code`), which `VectorQuantizeEMA.encode` takes on the TPU:
argmin over the codes of -2 x.e + |e|^2 in float32, the first index on
ties, without writing the (N, C) scores. A search is one launch: the kernel
sums |e|^2 itself from the code tiles it streams, and its blocks meet in a
thread-block cluster, with no scratch and no second kernel. The JAX package
gates its kernel to at least 8 rows and a codebook of at most 8 MiB (the
TPU's VMEM); this one tiles over the codes and takes every shape. On a CUDA tensor the wrapper
launches the kernel or raises; only a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load

__all__ = ["vq_nearest_code", "vq_nearest_code_ref", "SOURCE", "launches"]

SOURCE = "vq.cu"
launches = 0  # kernel launches, counted where the kernel is launched

_P, _I = ctypes.c_void_p, ctypes.c_int


def _fn():
    fn = load(SOURCE).vq_nearest
    if fn.argtypes is None:
        fn.argtypes = [_P] * 3 + [_I] * 3 + [_P]
        fn.restype = ctypes.c_int
    return fn


def _check(x, codebook):
    if x.ndim != 2 or codebook.ndim != 2 or x.shape[1] != codebook.shape[1]:
        raise ValueError(f"x must be (N, D) and the codebook (C, D), not {tuple(x.shape)} "
                         f"and {tuple(codebook.shape)}")
    if x.device != codebook.device:
        raise ValueError("x and the codebook must lie on one device")
    if not (x.is_floating_point() and codebook.is_floating_point()):
        raise TypeError("x and the codebook must be floating point")


def vq_nearest_code_ref(x, codebook):
    """Plain PyTorch version of the kernel, in float32: the index (int32) of
    the code minimising -2 x.e + |e|^2 for each row of x (N, D)."""
    x, e = x.float(), codebook.float()
    e2 = e.square().sum(-1)
    return torch.addmm(e2, x, e.t(), alpha=-2).argmin(-1).to(torch.int32)


def vq_nearest_code(x, codebook):
    """x (N, D), codebook (C, D) -> int32 (N,) nearest-code indices: the
    kernel on a CUDA tensor, `vq_nearest_code_ref` on the CPU."""
    _check(x, codebook)
    if x.device.type == "cpu":
        return vq_nearest_code_ref(x, codebook)
    if x.device.type != "cuda":
        raise ValueError(f"no nearest-code path for device {x.device}")
    n, d = x.shape
    c = codebook.shape[0]
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=x.device)
    xf = x.float().contiguous()
    e = codebook.float().contiguous()
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    err = _fn()(xf.data_ptr(), e.data_ptr(), out.data_ptr(), n, c, d,
                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vq_nearest launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out
