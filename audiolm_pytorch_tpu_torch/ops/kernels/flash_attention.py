"""Flash attention, forward and backward: the wrappers of the hand-written
Hopper kernels `csrc/flash_fwd.cu` and `csrc/flash_bwd.cu`, the
`torch.autograd.Function` that joins them, and their plain PyTorch versions.

Replaces the JAX package's Pallas kernels in `ops/pallas/flash_attention.py`:
the forward `_kernel`, and the backward `_dq_kernel`, `_dkv_kernel` and
`_dblocks_kernel` behind its `jax.custom_vjp`. The rel-pos bias comes in as
its (2N-1, H) distance table and is read inside the kernels' tiles,
bias[h, q, k] = tab[q - k + N - 1, h]; its gradient is reduced along the
diagonals straight into a (2N-1, H) table. The (H, N, N) bias is never built,
in either direction. On a CUDA tensor the wrappers launch the kernels or
raise; only a CPU tensor takes the plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from ..relpos import toeplitz_expand
from ._build import load

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_bwd",
           "flash_attention_bwd_ref", "bwd_dq", "bwd_dkv", "SOURCE",
           "SOURCE_BWD", "HEAD_DIMS", "launches", "launches_dq", "launches_dkv",
           "launches_dtab"]

SOURCE = "flash_fwd.cu"
SOURCE_BWD = "flash_bwd.cu"
HEAD_DIMS = (64,)
_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel, counted where it is launched
launches = 0       # forward (K1)
launches_dq = 0    # dq (K2)
launches_dkv = 0   # dk, dv (K3)
launches_dtab = 0  # bias-table gradient (K4, fused into K2's launch)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn(source, name, argtypes):
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _fwd_fn():
    return _fn(SOURCE, "flash_fwd", [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P])


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


def _check_cuda(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention path for device {q.device}")
    b, h, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError("B * H exceeds the grid's y limit of 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")


def _kernel_args(bias_tab, key_mask):
    """The table as float32 and the key mask as int8, contiguous, or None."""
    tab = bias_tab.float().contiguous() if bias_tab is not None else None
    kmask = key_mask.to(torch.int8).contiguous() if key_mask is not None else None
    return tab, kmask


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward(q, k, v, bias_tab, key_mask, causal, scale):
    """(out, lse): the kernel on a CUDA tensor, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, bias_tab=bias_tab, key_mask=key_mask,
                                   causal=causal, scale=scale, return_lse=True)
    _check_cuda(q, k, v)
    b, h, n, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    tab, kmask = _kernel_args(bias_tab, key_mask)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    err = _fwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(tab), _ptr(kmask),
                    out.data_ptr(), lse.data_ptr(), b * h, h, h // hk, n, m, d, scale,
                    int(causal), _DTYPES[q.dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """Forward K1; backward K2 (dq) with K4 (the table's gradient) in the
    same launch, and K3 (dk, dv), recomputing P from the forward's logsumexp
    (the port's counterpart of the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, bias_tab, key_mask, causal, scale):
        out, lse = _forward(q, k, v, bias_tab, key_mask, causal, scale)
        ctx.save_for_backward(q, k, v, bias_tab, key_mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, bias_tab, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv, dtab = flash_attention_bwd(q, k, v, bias_tab, key_mask, out, lse, g,
                                               causal=ctx.causal, scale=ctx.scale)
        if dtab is not None:
            dtab = dtab.to(bias_tab.dtype)
        return dq, dk, dv, dtab, None, None, None


def flash_attention(q, k, v, *, bias_tab=None, key_mask=None, causal: bool = False,
                    scale: "float | None" = None, return_lse: bool = False):
    """q: (B, H, N, D); k, v: (B, Hk, M, D) with Hk dividing H (MQA: the kv
    head of query head h is h // (H // Hk)). bias_tab: (2N-1, H) rel-pos
    distance table or None. key_mask: (B, M) bool, True = attend. Returns
    out (B, H, N, D) in q's dtype [and lse (B, H, N) float32], differentiable
    in q, k, v and bias_tab."""
    _check(q, k, v, bias_tab, key_mask, causal)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    out, lse = _FlashAttention.apply(q, k, v, bias_tab, key_mask, bool(causal), scale)
    return (out, lse) if return_lse else out


def flash_attention_ref(q, k, v, *, bias_tab=None, key_mask=None, causal: bool = False,
                        scale: "float | None" = None, return_lse: bool = False):
    """Plain PyTorch version of the forward kernel, in float32 (the
    counterpart of the JAX package's `_math_reference`): same arguments, same
    results."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    sim = _scores(q, k, bias_tab, key_mask, causal, scale)
    vf = v.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    out = torch.matmul(sim.softmax(-1), vf).to(q.dtype)
    return (out, sim.logsumexp(-1)) if return_lse else out


def _scores(q, k, bias_tab, key_mask, causal, scale):
    """(B, H, N, M) float32 logits with the bias added and masked entries at
    -1e30, as the kernels form them."""
    n, m = q.shape[2], k.shape[2]
    kf = k.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    sim = torch.matmul(q.float() * scale, kf.transpose(-1, -2))
    if bias_tab is not None:
        sim = sim + toeplitz_expand(bias_tab.float(), n, m)
    if key_mask is not None:
        sim = sim.masked_fill(~key_mask[:, None, None, :], _NEG_INF)
    if causal:
        keep = torch.ones(n, m, dtype=torch.bool, device=q.device).tril(m - n)
        sim = sim.masked_fill(~keep, _NEG_INF)
    return sim


def flash_attention_bwd_ref(q, k, v, bias_tab, key_mask, out, lse, g, *,
                            causal: bool, scale: float):
    """Plain PyTorch version of the backward kernels, in float32: P is
    recomputed from the forward's `lse` (rows with lse <= -5e29, the fully
    masked ones, get p = 0), Delta = rowsum(dO * O), dS = P * (dP - Delta).
    Returns dq, dk, dv in their inputs' dtypes and dtab (2N-1, H) float32, or
    None without a table."""
    b, h, n, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    group = h // hk
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    gf = g.float()
    p = torch.exp(_scores(q, k, bias_tab, key_mask, causal, scale) - lse[..., None])
    p = p.masked_fill(~(lse > _NEG_INF / 2)[..., None], 0.0)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (gf * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = scale * torch.matmul(ds, kf)
    # the query heads of one kv head sum into it (MQA)
    dk = (scale * torch.matmul(ds.transpose(-1, -2), q.float())).view(b, hk, group, m, d).sum(2)
    dv = torch.matmul(p.transpose(-1, -2), gf).view(b, hk, group, m, d).sum(2)
    dtab = None
    if bias_tab is not None:
        delta_idx = (torch.arange(n, device=q.device)[:, None]
                     - torch.arange(m, device=q.device)[None, :] + (m - 1))
        dtab = torch.zeros(2 * n - 1, h, dtype=torch.float32, device=q.device)
        dtab.index_add_(0, delta_idx.reshape(-1), ds.sum(0).permute(1, 2, 0).reshape(n * m, h))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dtab


def _bwd_launch(name, outs, q, k, v, g, lse, delta, tab, kmask, causal, scale):
    b, h, n, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    # q k v g lse delta tab kmask, the two outputs, b heads hk n m d, scale, causal dtype stream
    fn = _fn(SOURCE_BWD, name, [_P] * 10 + [_I] * 6 + [_F, _I, _I, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), _ptr(tab), _ptr(kmask), *(_ptr(o) for o in outs),
             b, h, hk, n, m, d, scale, int(causal), _DTYPES[q.dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def bwd_dq(q, k, v, g, lse, delta, tab, kmask, *, causal: bool, scale: float):
    """K2 on prepared arguments (contiguous; tab float32 and kmask int8 or
    None; lse and delta (B, H, N) float32): dq in q's dtype, and with a table
    K4 in the same launch, the (2N-1, H) float32 gradient of the table summed
    over the batch by atomics into a zeroed buffer; else None."""
    dq = torch.empty_like(q)
    dtab = torch.zeros_like(tab) if tab is not None else None
    _bwd_launch("flash_bwd_dq", (dq, dtab), q, k, v, g, lse, delta, tab, kmask, causal, scale)
    global launches_dq, launches_dtab
    launches_dq += 1
    if dtab is not None:
        launches_dtab += 1
    return dq, dtab


def bwd_dkv(q, k, v, g, lse, delta, tab, kmask, *, causal: bool, scale: float):
    """K3 on prepared arguments: dk, dv in k's dtype, the query heads of each
    kv head summed in the kernel."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_bwd_dkv", (dk, dv), q, k, v, g, lse, delta, tab, kmask, causal, scale)
    global launches_dkv
    launches_dkv += 1
    return dk, dv


def flash_attention_bwd(q, k, v, bias_tab, key_mask, out, lse, g, *, causal: bool,
                        scale: float):
    """dq, dk, dv and (with a table) dtab: K2 with K4, then K3 on a CUDA
    tensor, `flash_attention_bwd_ref` on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, bias_tab, key_mask, out, lse, g,
                                       causal=causal, scale=scale)
    _check_cuda(q, k, v)
    g = g.to(q.dtype).contiguous()
    # Delta = rowsum(dO * O) is a torch reduction, as the JAX package leaves it to XLA
    delta = (g.float() * out.float()).sum(-1)
    tab, kmask = _kernel_args(bias_tab, key_mask)
    args = (q, k, v, g, lse, delta, tab, kmask)
    kw = dict(causal=causal, scale=scale)
    dq, dtab = bwd_dq(*args, **kw)
    dk, dv = bwd_dkv(*args, **kw)
    return dq, dk, dv, dtab
