"""Nearest-code search of vector quantization: the wrapper of the
hand-written Hopper kernel `csrc/vq.cu` and its plain PyTorch version.

Replaces the JAX package's Pallas kernel `ops/pallas/vq.py::_kernel`
(`vq_nearest_code`), which `VectorQuantizeEMA.encode` takes on the TPU:
argmin over the codes of -2 x.e + |e|^2 in float32, the first index on
ties, without writing the (N, C) scores. A search is one launch: the kernel
sums |e|^2 itself from the code tiles it streams; the ranks of a
thread-block cluster that split the dimensions add their partial scores in
rank order, and the code groups of a row tile meet in the last block to
arrive, with no second kernel. The JAX package gates its kernel to at least
8 rows and a codebook of at most 8 MiB (the TPU's VMEM); this one tiles
over the rows, the codes and the dimensions and takes every shape. The
kernel loads its tiles by TMA, which needs rows of a multiple of 16 bytes
and 16-byte aligned bases: the wrapper copies other inputs into such
tensors, with zero columns added (which change no score); the port's paths
(D = 512 and 128) never need it. On a CUDA tensor the wrapper launches the
kernel or raises; only a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load

__all__ = ["vq_nearest_code", "vq_nearest_code_ref", "vq_plan", "vq_block_work",
           "vq_plan_built", "SOURCE", "launches", "PLAN_SMS"]

SOURCE = "vq.cu"
launches = 0  # kernel launches, counted where the kernel is launched

_P, _I = ctypes.c_void_p, ctypes.c_int

# K6's launch plan, as its C launcher computes it (csrc/vq.cu `vq_plan`): a
# pure function, so the CPU tests can check what the card runs
PLAN_SMS = 132  # the H100's SMs, which the plan fills
_ROWS = 64      # rows of x a tile (wgmma's M)
_CODES = 64     # codes a tile
_CHUNK = 32     # dimensions a chunk (one 128-byte row of float32)
_MAX_CLUSTER = 8


def vq_plan(n, c, d):
    """K6's launch for x (n, d) against c codes: the cluster (`ksplit`
    ranks that split the dimensions' chunks and add their partial scores in
    rank order), the code `groups` of a row tile (group g takes code tiles
    g, g + groups, ...; with more than one, the row tile's last block merges
    their minima), and the grid (ksplit, groups, row tiles). Where row tiles
    x code tiles is under PLAN_SMS, every code tile is a group and the
    smallest cluster of 2, 4 or 8 (at most one rank a chunk) that fills the
    card splits the chunks; else no split, and the fewest groups (doubling)
    that fill it."""
    chunks = -(-(-(-d // 4) * 4) // _CHUNK)
    rts, cts = -(-n // _ROWS), -(-c // _CODES)
    ksplit = groups = 1
    if rts * cts < PLAN_SMS:
        groups = cts
        while ksplit < _MAX_CLUSTER and 2 * ksplit <= chunks and rts * cts * ksplit < PLAN_SMS:
            ksplit *= 2
    else:
        while groups < cts and rts * groups < PLAN_SMS:
            groups *= 2
        groups = min(groups, cts)
    return {"ksplit": ksplit, "groups": groups, "chunks": chunks,
            "grid": (ksplit, groups, rts)}


def vq_block_work(plan, c, rank, group, row_tile):
    """What block (rank, group, row tile) of the plan covers: (its rows as a
    range, its code tiles' first codes in the order it takes them, its
    chunks' first dimensions)."""
    ksplit, groups, chunks = plan["ksplit"], plan["groups"], plan["chunks"]
    lo, hi = rank * chunks // ksplit, (rank + 1) * chunks // ksplit
    cts = -(-c // _CODES)
    return (range(row_tile * _ROWS, (row_tile + 1) * _ROWS),
            [t * _CODES for t in range(group, cts, groups)],
            [k * _CHUNK for k in range(lo, hi)])


def _fn(name, argtypes):
    fn = getattr(load(SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def vq_plan_built(n, c, d):
    """K6's plan as the built library computes it: (cluster, code groups)."""
    out = (ctypes.c_int * 2)()
    if _fn("vq_nearest_plan", [_I] * 3 + [_P])(n, c, d, out) != 0:
        raise ValueError(f"no K6 plan for n={n} c={c} d={d}")
    return tuple(out)


def _tma_ready(t):
    """t as a float32 tensor whose rows TMA reads: contiguous, 16-byte
    aligned, a multiple of 4 columns (added columns are zeros)."""
    t = t.float().contiguous()
    d = t.shape[1]
    if d % 4 == 0 and t.data_ptr() % 16 == 0:
        return t
    padded = torch.zeros(t.shape[0], -(-d // 4) * 4, dtype=torch.float32, device=t.device)
    padded[:, :d] = t
    return padded


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
    xf, e = _tma_ready(x), _tma_ready(codebook)
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    err = _fn("vq_nearest", [_P] * 3 + [_I] * 3 + [_P])(
        xf.data_ptr(), e.data_ptr(), out.data_ptr(), n, c, xf.shape[1],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vq_nearest launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out
