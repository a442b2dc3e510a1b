"""Flash-attention forward: the wrapper of the hand-written Hopper kernel
`csrc/flash_fwd.cu` and its plain PyTorch version.

Replaces the JAX package's Pallas kernel `ops/pallas/flash_attention.py::
_kernel` (entries `flash_attention` and `_flash_forward`). The rel-pos bias
comes in as its (2N-1, H) distance table and is read inside the kernel's
tiles, bias[h, q, k] = tab[q - k + N - 1, h]; the (H, N, N) bias is never
built. On a CUDA tensor the wrapper launches the kernel or raises; only a
CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..relpos import toeplitz_expand
from ._build import load

__all__ = ["flash_attention", "flash_attention_ref", "launches", "SOURCE", "HEAD_DIMS"]

SOURCE = "flash_fwd.cu"
HEAD_DIMS = (64,)
_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # launches of the kernel, counted where it is launched


def _lib():
    lib = load(SOURCE)
    fn = lib.flash_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, bias_tab, key_mask, causal):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, H, N, D), (B, Hk, M, D), (B, Hk, M, D)")
    b, h, n, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % hk:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype in {list(_DTYPES)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if (causal or bias_tab is not None) and n != m:
        raise ValueError("causal attention and the bias table need N == M")
    if bias_tab is not None and (bias_tab.shape != (2 * n - 1, h)
                                 or bias_tab.device != q.device):
        raise ValueError(f"bias_tab must be (2N-1, H) = {(2 * n - 1, h)} on q's device")
    if key_mask is not None and (key_mask.shape != (b, m) or key_mask.dtype != torch.bool
                                 or key_mask.device != q.device):
        raise ValueError(f"key_mask must be bool (B, M) = {(b, m)} on q's device")


def flash_attention(q, k, v, *, bias_tab=None, key_mask=None, causal: bool = False,
                    scale: "float | None" = None, return_lse: bool = False):
    """q: (B, H, N, D); k, v: (B, Hk, M, D) with Hk dividing H (MQA: the kv
    head of query head h is h // (H // Hk)). bias_tab: (2N-1, H) rel-pos
    distance table or None. key_mask: (B, M) bool, True = attend. Returns
    out (B, H, N, D) in q's dtype [and lse (B, H, N) float32]."""
    _check(q, k, v, bias_tab, key_mask, causal)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, bias_tab=bias_tab, key_mask=key_mask,
                                   causal=causal, scale=scale, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention path for device {q.device}")
    b, h, n, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError("B * H exceeds the grid's y limit of 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    tab = None
    if bias_tab is not None:
        tab = bias_tab.float().contiguous()
    kmask = key_mask.to(torch.int8).contiguous() if key_mask is not None else None
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    fn = _lib()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             tab.data_ptr() if tab is not None else None,
             kmask.data_ptr() if kmask is not None else None,
             out.data_ptr(), lse.data_ptr(), b * h, h, h // hk, n, m, d, scale,
             int(causal), _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed with CUDA error {err}")
    global launches
    launches += 1
    return (out, lse) if return_lse else out


def flash_attention_ref(q, k, v, *, bias_tab=None, key_mask=None, causal: bool = False,
                        scale: "float | None" = None, return_lse: bool = False):
    """Plain PyTorch version of the kernel, in float32 (the counterpart of the
    JAX package's `_math_reference`): same arguments, same results."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    h, n, m = q.shape[1], q.shape[2], k.shape[2]
    group = h // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    sim = torch.matmul(q.float() * scale, kf.transpose(-1, -2))
    if bias_tab is not None:
        sim = sim + toeplitz_expand(bias_tab.float(), n, m)
    if key_mask is not None:
        sim = sim.masked_fill(~key_mask[:, None, None, :], _NEG_INF)
    if causal:
        keep = torch.ones(n, m, dtype=torch.bool, device=q.device).tril(m - n)
        sim = sim.masked_fill(~keep, _NEG_INF)
    out = torch.matmul(sim.softmax(-1), vf).to(q.dtype)
    return (out, sim.logsumexp(-1)) if return_lse else out
