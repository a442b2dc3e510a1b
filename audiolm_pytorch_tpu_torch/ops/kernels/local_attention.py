"""Blocked causal local attention: the wrapper of the hand-written Hopper
kernel `csrc/local_attn.cu`, its plain PyTorch version, and the
`torch.autograd.Function` that joins them.

Replaces the JAX package's Pallas kernel `ops/pallas/local_attention.py::
_kernel` (`local_attention_pallas`) and computes the function of the JAX
model's path, `ops/attention.py::local_attention`, which the codec's
`LocalMHA` calls: each query of window i attends the keys of windows i-1
and i at or before it; T is padded to a multiple of the window and the
padded keys are masked; a disallowed pair scores -1e9 before the softmax,
and window 0 looks back on zero keys and values. The two JAX versions differ
only for a query of window 0 whose every key is masked (the Pallas kernel
looks back on window 0 itself); the port follows the model's path.

The kernel reads q, k and v through their (batch, head, time) strides, so
`LocalMHA`'s transposed views of (B, T, H, D) projections reach it without a
copy, and writes its output in q's layout. The backward recomputes through
the plain version under autograd, as the JAX package's custom VJP goes to
its XLA version. On a CUDA tensor the forward launches the kernel or raises;
only a CPU tensor takes the plain version. The kernel takes any window w >=
1 and any T (a one-dimensional grid); its blocks are 64-query tiles, each
walking the keys from its first row's look-back to its last query. It
takes every head dim: it is built for 32, 64 and 128, and over 128 runs a
column-sliced form for any multiple of 64 (a block owns one 64-wide slice
of the output and recomputes S over the whole depth, 64 columns at a time);
another D is zero-padded into the next of those (with the scale of the true
D) and the output sliced back, as the flash kernels' wrappers do.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import load
from .flash_attention import HEAD_DIMS, native_head_dim

__all__ = ["local_attention", "local_attention_ref", "SOURCE", "HEAD_DIMS", "launches"]

SOURCE = "local_attn.cu"
_MASKED = -1e9  # the JAX model path's score of a disallowed pair
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0  # kernel launches, counted where the kernel is launched

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn():
    fn = load(SOURCE).local_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 5 + [_F, _I, _P]
        fn.restype = ctypes.c_int
    return fn


def _readable(x):
    """x itself where the kernel can read it through its strides (the last
    dimension contiguous; the (batch, head, time) strides and the address
    multiples of 16 bytes, as its 16-byte copies need), else a contiguous
    copy."""
    step, st = 16 // x.element_size(), x.stride()
    if st[3] != 1 or st[0] % step or st[1] % step or st[2] % step or x.data_ptr() % 16:
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _check(q, k, v, window_size, mask, attn_bias):
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be (B, H, T, D) alike, not {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, t, _ = q.shape
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if mask is not None and (mask.shape != (b, t) or mask.dtype != torch.bool
                             or mask.device != q.device):
        raise ValueError(f"mask must be bool (B, T) = {(b, t)} on q's device")
    w = window_size
    if w < 1:
        raise ValueError(f"the window must be at least 1, not {w}")
    if attn_bias is not None and (attn_bias.shape != (h, w, 2 * w)
                                  or attn_bias.device != q.device):
        raise ValueError(f"attn_bias must be (H, w, 2w) = {(h, w, 2 * w)} on q's device")


def local_attention_ref(q, k, v, *, window_size: int, mask=None, attn_bias=None,
                        scale: "float | None" = None):
    """Plain PyTorch version of the kernel, in float32 (float64 for float64
    inputs): the JAX model path's `local_attention`, with q scaled and the
    probabilities kept in float32 (the JAX version rounds both to a bf16
    input's type). Returns (B, H, T, D) in q's dtype."""
    b, h, n, d = q.shape
    w = window_size
    scale = scale if scale is not None else d ** -0.5
    pad = (-n) % w
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        valid = mask if mask is not None else torch.ones(b, n, dtype=torch.bool,
                                                         device=q.device)
        mask = F.pad(valid, (0, pad), value=False)
    nt = n + pad
    nw = nt // w
    ct = torch.promote_types(q.dtype, torch.float32)
    qw = (q.to(ct) * scale).reshape(b, h, nw, w, d)
    kw = k.to(ct).reshape(b, h, nw, w, d)
    vw = v.to(ct).reshape(b, h, nw, w, d)
    # keys and values of window i: windows i-1 (zeros before window 0) and i
    k2 = torch.cat([F.pad(kw, (0, 0, 0, 0, 1, 0))[:, :, :-1], kw], dim=3)
    v2 = torch.cat([F.pad(vw, (0, 0, 0, 0, 1, 0))[:, :, :-1], vw], dim=3)
    sim = torch.matmul(qw, k2.transpose(-1, -2))  # (B, H, nw, w, 2w)
    if attn_bias is not None:
        sim = sim + attn_bias[None, :, None].to(ct)
    qpos = torch.arange(w, device=q.device)[:, None]
    kpos = torch.arange(2 * w, device=q.device)[None, :]
    win = torch.arange(nw, device=q.device)[:, None, None]
    allowed = (kpos <= qpos + w)[None] & ((win > 0) | (kpos[None] >= w))  # (nw, w, 2w)
    if mask is not None:
        mw = mask.reshape(b, nw, w)
        key_valid = torch.cat([F.pad(mw, (0, 0, 1, 0), value=False)[:, :-1], mw], dim=2)
        allowed = (allowed[None] & key_valid[:, :, None, :])[:, None]
    sim = sim.masked_fill(~allowed, _MASKED)
    out = torch.matmul(sim.softmax(-1), v2).reshape(b, h, nt, d)
    return out[:, :, :n].to(q.dtype)


def _forward(q, k, v, window_size, mask, attn_bias, scale):
    if q.device.type == "cpu":
        return local_attention_ref(q, k, v, window_size=window_size, mask=mask,
                                   attn_bias=attn_bias, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no local-attention path for device {q.device}")
    b, h, t, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype in {list(_DTYPES)}")
    dn = native_head_dim(d)
    if dn != d:
        q, k, v = (F.pad(x, (0, dn - d)) for x in (q, k, v))
    q, k, v = (_readable(x) for x in (q, k, v))
    bias = attn_bias.float().contiguous() if attn_bias is not None else None
    kmask = mask.to(torch.int8).contiguous() if mask is not None else None
    out = torch.empty_like(q)  # q's layout where q is dense, else contiguous
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                kmask.data_ptr() if kmask is not None else None, out.data_ptr(), strides,
                b * h, h, t, dn, window_size, scale, _DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"local_attn_fwd launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out[..., :d]


class _LocalAttention(torch.autograd.Function):
    """Forward K7; backward through the plain version under autograd (the
    port's counterpart of the JAX package's custom VJP, whose backward is
    XLA's)."""

    @staticmethod
    def forward(ctx, q, k, v, attn_bias, mask, window_size, scale):
        ctx.save_for_backward(q, k, v, attn_bias, mask)
        ctx.window_size, ctx.scale = window_size, scale
        return _forward(q, k, v, window_size, mask, attn_bias, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, attn_bias, mask = ctx.saved_tensors
        inputs = [x.detach().requires_grad_() for x in (q, k, v)]
        if attn_bias is not None:
            inputs.append(attn_bias.detach().requires_grad_())
        with torch.enable_grad():
            out = local_attention_ref(*inputs[:3], window_size=ctx.window_size, mask=mask,
                                      attn_bias=inputs[3] if attn_bias is not None else None,
                                      scale=ctx.scale)
            grads = torch.autograd.grad(out, inputs, g)
        dbias = grads[3] if attn_bias is not None else None
        return grads[0], grads[1], grads[2], dbias, None, None, None


def local_attention(q, k, v, *, window_size: int, mask=None, attn_bias=None,
                    scale: "float | None" = None):
    """q, k, v: (B, H, T, D). mask: (B, T) bool, True = a valid key.
    attn_bias: additive (H, w, 2w) over (query in window, key in the two
    windows). Returns (B, H, T, D) in q's dtype, differentiable in q, k, v
    and the bias."""
    _check(q, k, v, window_size, mask, attn_bias)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    return _LocalAttention.apply(q, k, v, attn_bias, mask, int(window_size), scale)
