"""Flash attention, forward and backward: the wrappers of the hand-written
Hopper kernels `csrc/flash_fwd.cu` and `csrc/flash_bwd.cu`, the
`torch.autograd.Function` that joins them, and their plain PyTorch versions.

Replaces the JAX package's Pallas kernels in `ops/pallas/flash_attention.py`:
the forward `_kernel`, and the backward `_dq_kernel`, `_dkv_kernel`,
`_dblocks_kernel` and `_dbias_kernel` behind its `jax.custom_vjp`: the
backward is two launches, dq (K2, which also gives the bias's gradient, K4
or K5) and dk/dv (K3). The bias comes in one of two forms. The Semantic
LM's rel-pos bias is its (2N-1, H) distance table, read inside the kernels'
tiles as bias[h, q, k] = tab[q - k + N - 1, h]; its gradient is reduced
along the diagonals straight into a (2N-1, H) table, and the (H, N, N) bias
is never built. The Coarse and Fine LMs' bias is a materialised (H, N, M)
float tensor shared over the batch: each tile reads its (64, 64) block of
bias[h], and K2's launch gives its gradient, the batch sum of dS over a
thread-block cluster of the batch rows. A per-batch (B, H, N, M) bias has
the plain versions only. On a CUDA tensor the wrappers launch the kernels
or raise; only a CPU tensor takes the plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from ..relpos import toeplitz_expand
from ._build import built_with, load

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_bwd",
           "flash_attention_bwd_ref", "bwd_dq", "bwd_dkv", "built_with", "SOURCE",
           "SOURCE_BWD", "HEAD_DIMS", "launches", "launches_dq", "launches_dkv",
           "launches_dtab", "launches_dbias"]

SOURCE = "flash_fwd.cu"
SOURCE_BWD = "flash_bwd.cu"
HEAD_DIMS = (64,)
_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel, counted where it is launched
launches = 0       # forward (K1)
launches_dq = 0    # dq (K2)
launches_dkv = 0   # dk, dv (K3)
launches_dtab = 0  # bias-table gradient (K4: partial sums in K2's launch, then its second pass)
launches_dbias = 0  # (H, N, M) bias gradient (K5, fused into K2's launch)
# K5's cluster holds at most this many batch rows; beyond it the clusters of
# one tile add their partial sums by atomics into a zeroed dbias
_MAX_CLUSTER = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn(source, name, argtypes):
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _fwd_fn():
    return _fn(SOURCE, "flash_fwd", [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P])


def _check(q, k, v, bias_tab, key_mask, causal, bias=None):
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
    if bias is not None:
        if bias_tab is not None:
            raise ValueError("pass bias or bias_tab, not both")
        if bias.shape not in ((h, n, m), (b, h, n, m)) or bias.device != q.device \
                or not bias.is_floating_point():
            raise ValueError(f"bias must be float (H, N, M) = {(h, n, m)} or (B, H, N, M) "
                             f"on q's device, not {tuple(bias.shape)}")
    if key_mask is not None and (key_mask.shape != (b, m) or key_mask.dtype != torch.bool
                                 or key_mask.device != q.device):
        raise ValueError(f"key_mask must be bool (B, M) = {(b, m)} on q's device")


def _check_cuda(q, k, v, bias=None):
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention path for device {q.device}")
    if bias is not None and bias.ndim == 4:
        raise ValueError("a per-batch (B, H, N, M) bias has no kernel: only the plain "
                         "version on the CPU takes it")
    b, h, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError("B * H exceeds the grid's y limit of 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start 16-byte aligned: the kernels copy rows 16 bytes "
                         "at a time")


def _kernel_args(bias_tab, key_mask, bias=None):
    """The table and the bias as float32 and the key mask as int8, each
    contiguous, or None."""
    tab = bias_tab.float().contiguous() if bias_tab is not None else None
    kmask = key_mask.to(torch.int8).contiguous() if key_mask is not None else None
    dense = bias.float().contiguous() if bias is not None else None
    return tab, kmask, dense


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward(q, k, v, bias_tab, bias, key_mask, causal, scale):
    """(out, lse): the kernel on a CUDA tensor, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, bias_tab=bias_tab, bias=bias, key_mask=key_mask,
                                   causal=causal, scale=scale, return_lse=True)
    _check_cuda(q, k, v, bias)
    b, h, n, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    tab, kmask, dense = _kernel_args(bias_tab, key_mask, bias)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    err = _fwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(tab), _ptr(dense),
                    _ptr(kmask), out.data_ptr(), lse.data_ptr(), b * h, h, h // hk, n, m, d,
                    scale, int(causal), _DTYPES[q.dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """Forward K1; backward K2 (dq) with the bias's gradient in the same
    launch (K4 for the table, K5 for an (H, N, M) bias) and K3 (dk, dv),
    recomputing P from the forward's logsumexp (the port's counterpart of
    the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, bias_tab, bias, key_mask, causal, scale):
        out, lse = _forward(q, k, v, bias_tab, bias, key_mask, causal, scale)
        ctx.save_for_backward(q, k, v, bias_tab, bias, key_mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, bias_tab, bias, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = flash_attention_bwd(q, k, v, bias_tab, key_mask, out, lse, g,
                                                bias=bias, causal=ctx.causal, scale=ctx.scale)
        given = bias_tab if bias_tab is not None else bias
        if dbias is not None:
            dbias = dbias.to(given.dtype)
        if bias_tab is not None:
            return dq, dk, dv, dbias, None, None, None, None
        return dq, dk, dv, None, dbias, None, None, None


def flash_attention(q, k, v, *, bias_tab=None, bias=None, key_mask=None,
                    causal: bool = False, scale: "float | None" = None,
                    return_lse: bool = False):
    """q: (B, H, N, D); k, v: (B, Hk, M, D) with Hk dividing H (MQA: the kv
    head of query head h is h // (H // Hk)). bias_tab: (2N-1, H) rel-pos
    distance table, or bias: additive (H, N, M) float bias shared over the
    batch ((B, H, N, M) on the CPU only), or neither. key_mask: (B, M) bool,
    True = attend. Returns out (B, H, N, D) in q's dtype [and lse (B, H, N)
    float32], differentiable in q, k, v and the bias."""
    _check(q, k, v, bias_tab, key_mask, causal, bias)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    out, lse = _FlashAttention.apply(q, k, v, bias_tab, bias, key_mask, bool(causal), scale)
    return (out, lse) if return_lse else out


def flash_attention_ref(q, k, v, *, bias_tab=None, bias=None, key_mask=None,
                        causal: bool = False, scale: "float | None" = None,
                        return_lse: bool = False):
    """Plain PyTorch version of the forward kernel, in float32, or in float64
    for float64 inputs (the counterpart of the JAX package's
    `_math_reference`): same arguments, same results."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    sim = _scores(q, k, bias_tab, key_mask, causal, scale, bias)
    vf = v.to(sim.dtype).repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    out = torch.matmul(sim.softmax(-1), vf).to(q.dtype)
    return (out, sim.logsumexp(-1)) if return_lse else out


def _scores(q, k, bias_tab, key_mask, causal, scale, bias=None):
    """(B, H, N, M) logits, float32 (float64 for float64 q), with the bias
    added and masked entries at -1e30, as the kernels form them."""
    n, m = q.shape[2], k.shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(ct).repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    sim = torch.matmul(q.to(ct) * scale, kf.transpose(-1, -2))
    if bias_tab is not None:
        sim = sim + toeplitz_expand(bias_tab.to(ct), n, m)
    if bias is not None:
        sim = sim + bias.to(ct)
    if key_mask is not None:
        sim = sim.masked_fill(~key_mask[:, None, None, :], _NEG_INF)
    if causal:
        keep = torch.ones(n, m, dtype=torch.bool, device=q.device).tril(m - n)
        sim = sim.masked_fill(~keep, _NEG_INF)
    return sim


def flash_attention_bwd_ref(q, k, v, bias_tab, key_mask, out, lse, g, *,
                            causal: bool, scale: float, bias=None):
    """Plain PyTorch version of the backward kernels, in float32 (float64 for
    float64 inputs): P is recomputed from the forward's `lse` (rows with
    lse <= -5e29, the fully masked ones, get p = 0), Delta = rowsum(dO * O),
    dS = P * (dP - Delta). Returns dq, dk, dv in their inputs' dtypes and the
    float32 (or float64) gradient of the bias given: dtab (2N-1, H) for a table, dbias = sum over the batch of
    dS (H, N, M) for a shared bias, dS itself (B, H, N, M) for a per-batch
    one; None without a bias."""
    b, h, n, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    group = h // hk
    ct = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(ct).repeat_interleave(group, dim=1)
    vf = v.to(ct).repeat_interleave(group, dim=1)
    gf = g.to(ct)
    p = torch.exp(_scores(q, k, bias_tab, key_mask, causal, scale, bias) - lse[..., None])
    p = p.masked_fill(~(lse > _NEG_INF / 2)[..., None], 0.0)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (gf * out.to(ct)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = scale * torch.matmul(ds, kf)
    # the query heads of one kv head sum into it (MQA)
    dk = (scale * torch.matmul(ds.transpose(-1, -2), q.to(ct))).view(b, hk, group, m, d).sum(2)
    dv = torch.matmul(p.transpose(-1, -2), gf).view(b, hk, group, m, d).sum(2)
    dbias = None
    if bias_tab is not None:
        delta_idx = (torch.arange(n, device=q.device)[:, None]
                     - torch.arange(m, device=q.device)[None, :] + (m - 1))
        dbias = torch.zeros(2 * n - 1, h, dtype=ct, device=q.device)
        dbias.index_add_(0, delta_idx.reshape(-1), ds.sum(0).permute(1, 2, 0).reshape(n * m, h))
    elif bias is not None:
        dbias = ds if bias.ndim == 4 else ds.sum(0)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _bwd_launch(name, outs, q, k, v, g, lse, delta, tab, kmask, *, causal, scale, bias=None):
    """outs: K2's (dq, the bias's gradient, K4's scratch) or K3's (dk, dv),
    each a tensor or None."""
    b, h, n, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    # q k v g lse delta tab bias kmask, the outputs, b heads hk n m d, scale, causal
    # dtype stream
    fn = _fn(SOURCE_BWD, name, [_P] * (9 + len(outs)) + [_I] * 6 + [_F, _I, _I, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), _ptr(tab), _ptr(bias), _ptr(kmask), *(_ptr(o) for o in outs),
             b, h, hk, n, m, d, scale, int(causal), _DTYPES[q.dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def bwd_dq(q, k, v, g, lse, delta, tab, kmask, *, causal: bool, scale: float, bias=None):
    """K2 on prepared arguments (contiguous; tab and bias float32 and kmask
    int8 or None; lse and delta (B, H, N) float32): dq in q's dtype, and in
    the same launch the float32 gradient of the bias given, summed over the
    batch: with a table K4, the (2N-1, H) gradient, its partial sums in K2's
    launch and added in a fixed order by a second launch (the same bits every
    run); with an (H, N, M) bias K5, its (H, N, M) gradient, summed over a
    cluster of the batch rows in a fixed order (by atomics between clusters,
    into a zeroed buffer, only for B > 8); else None."""
    dq = torch.empty_like(q)
    dgrad = part = None
    if tab is not None:
        dgrad = torch.empty_like(tab)
        b, h, n, _ = q.shape
        tiles = -(-n // 64), -(-k.shape[2] // 64)  # 64-row query and key tiles
        part = torch.empty(b * h * tiles[0] * 64 * (tiles[1] + 1), device=q.device)
    elif bias is not None:
        dgrad = torch.zeros_like(bias) if q.shape[0] > _MAX_CLUSTER else torch.empty_like(bias)
    _bwd_launch("flash_bwd_dq", (dq, dgrad, part), q, k, v, g, lse, delta, tab, kmask,
                causal=causal, scale=scale, bias=bias)
    global launches_dq, launches_dtab, launches_dbias
    launches_dq += 1
    if tab is not None:
        launches_dtab += 1
    elif bias is not None:
        launches_dbias += 1
    return dq, dgrad


def bwd_dkv(q, k, v, g, lse, delta, tab, kmask, *, causal: bool, scale: float, bias=None):
    """K3 on prepared arguments: dk, dv in k's dtype, the query heads of each
    kv head summed in the kernel."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_bwd_dkv", (dk, dv), q, k, v, g, lse, delta, tab, kmask,
                causal=causal, scale=scale, bias=bias)
    global launches_dkv
    launches_dkv += 1
    return dk, dv


def flash_attention_bwd(q, k, v, bias_tab, key_mask, out, lse, g, *, causal: bool,
                        scale: float, bias=None):
    """dq, dk, dv and the bias's gradient (dtab with a table, dbias with an
    (H, N, M) bias, else None): two launches on a CUDA tensor, K2 with K4 or
    K5 and K3; `flash_attention_bwd_ref` on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, bias_tab, key_mask, out, lse, g,
                                       causal=causal, scale=scale, bias=bias)
    _check_cuda(q, k, v, bias)
    g = g.to(q.dtype).contiguous()
    if g.data_ptr() % 16:  # a view into a larger buffer: K3 copies its rows 16 bytes at a time
        g = g.clone()
    # Delta = rowsum(dO * O) is a torch reduction, as the JAX package leaves it to XLA
    delta = (g.float() * out.float()).sum(-1)
    tab, kmask, dense = _kernel_args(bias_tab, key_mask, bias)
    args = (q, k, v, g, lse, delta, tab, kmask)
    kw = dict(causal=causal, scale=scale, bias=dense)
    dq, dgrad = bwd_dq(*args, **kw)
    dk, dv = bwd_dkv(*args, **kw)
    return dq, dk, dv, dgrad
