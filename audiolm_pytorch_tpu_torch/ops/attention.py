"""Attention ops held against the JAX package's `ops/attention.py`: masked
scaled-dot-product attention in plain PyTorch (the math path of `attend`,
which KV-cached prefill and decode take, as they do in JAX, and a train step
with attention dropout, which needs the weights), and the codec's
windowed attention: `rotary_xpos`, `DynamicPositionBias`, `LocalMHA` and
`LocalTransformer`, whose blocked local attention is K7
(`ops/kernels/local_attention.py`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import FeedForward, LayerNorm, Linear
from ..parallel.mesh import local_rows
from .kernels.local_attention import local_attention

__all__ = ["attend", "draw_keep", "rotary_xpos", "DynamicPositionBias", "LocalMHA",
           "LocalTransformer"]

_NEG_INF = -1e9  # finite mask value: fully masked rows stay NaN-free


def draw_keep(generator, shape, p: float, device):
    """Dropout's keep mask: bool `shape` on `device`, each True with
    probability 1 - p (the JAX package's bernoulli(1 - p)), drawn from
    `generator` on its own device. Under data parallelism the mask is drawn
    for the whole batch and cut to this rank's rows (`parallel.mesh.local_rows`),
    so the ranks together draw what one process would."""
    gen_device = generator.device if generator is not None else "cpu"
    keep = local_rows(lambda s: torch.rand(s, generator=generator, device=gen_device) < 1 - p,
                      shape)
    return keep.to(device)


def attend(q, k, v, *, mask=None, attn_bias=None, causal: bool = False,
           scale: "float | None" = None, dropout: float = 0.0,
           generator: "torch.Generator | None" = None, dropout_heads=None):
    """q: (B, H, N, D); k, v: (B, Hk, M, D) with Hk in {1, H}. mask broadcasts
    to (B, H, N, M), True = attend; attn_bias is additive (H, N, M) or
    (B, H, N, M). Products accumulate in float32 and the softmax runs in
    float32, as the JAX path does. With dropout > 0 and a generator, the
    weights after the softmax are kept with probability 1 - dropout
    (`draw_keep`; with `dropout_heads` (rank, world), q holding a
    tensor-parallel rank's part of the heads, the mask is drawn for all the
    heads and cut to its part, so the ranks drop what one process drops) and
    scaled by 1 / (1 - dropout); autograd saves the mask for the backward.
    Returns (B, H, N, D) in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if attn_bias is not None:
        sim = sim + attn_bias.float()
    if causal:
        n, m = sim.shape[-2:]
        keep = torch.ones(n, m, dtype=torch.bool, device=sim.device).tril(m - n)
        sim = sim.masked_fill(~keep, _NEG_INF)
    if mask is not None:
        sim = sim.masked_fill(~mask, _NEG_INF)
    attn = sim.softmax(-1)
    if dropout > 0 and generator is not None:
        if dropout_heads is None:
            keep = draw_keep(generator, attn.shape, dropout, attn.device)
        else:
            rank, world = dropout_heads
            b, h, *rest = attn.shape
            keep = draw_keep(generator, (b, h * world, *rest), dropout,
                             attn.device)[:, rank * h:(rank + 1) * h]
        attn = torch.where(keep, attn / (1 - dropout), 0.0)
    return torch.matmul(attn.to(v.dtype).float(), v.float()).to(q.dtype)


def rotary_xpos(t, *, scale_base: float, invert_scale: bool = False):
    """Rotary embedding over the halves of the last dim of t (..., N, D), in
    float32, with the xpos length-extrapolating scale (inverted for keys)."""
    d, n = t.shape[-1], t.shape[-2]
    half = d // 2
    dev = t.device
    ar = torch.arange(0, half, dtype=torch.float32, device=dev)
    freqs = 1.0 / (10000 ** (ar / half))
    pos = torch.arange(n, dtype=torch.float32, device=dev)
    ang = pos[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    power = (pos - n // 2) / scale_base
    scale = ((ar + 0.4 * half) / (1.4 * half))[None, :] ** power[:, None]
    if invert_scale:
        scale = 1.0 / scale
    t1, t2 = t[..., :half].float(), t[..., half:].float()
    out1 = (t1 * cos - t2 * sin) * scale
    out2 = (t2 * cos + t1 * sin) * scale
    return torch.cat([out1, out2], dim=-1).to(t.dtype)


def _rms(t, eps: float = 1e-8):
    tf = t.float()
    return (tf * torch.rsqrt(tf.square().mean(-1, keepdim=True) + eps)).to(t.dtype)


class LocalMHA(nn.Module):
    """Windowed causal multi-head attention as the codec configures it:
    prenorm, qk-RMSNorm with the cosine-similarity temperature 8 / dim_head,
    xpos rotary (unless a dynamic position bias comes in), K7, and per-head
    sigmoid gates on the values."""

    def __init__(self, *, dim: int, heads: int = 8, dim_head: int = 64,
                 window_size: int = 128, use_xpos: bool = True,
                 xpos_scale_base: "float | None" = None,
                 generator: "torch.Generator | None" = None):
        super().__init__()
        inner = heads * dim_head
        self.norm = LayerNorm(dim)
        self.to_qkv = Linear(dim, inner * 3, bias=False, generator=generator)
        self.to_out = Linear(inner, dim, bias=False, generator=generator)
        self.to_gate = Linear(dim, heads, bias=False, generator=generator)
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.heads, self.dim_head = heads, dim_head
        self.window_size = window_size
        self.use_xpos = use_xpos
        self.xpos_scale_base = xpos_scale_base if xpos_scale_base is not None \
            else window_size // 2

    def forward(self, x, *, mask=None, attn_bias=None):
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        inp = self.norm(x)
        q, k, v = (a.reshape(b, n, h, dh).transpose(1, 2)
                   for a in self.to_qkv(inp).chunk(3, dim=-1))
        q = _rms(q) * self.q_scale.to(q.dtype)
        k = _rms(k) * self.k_scale.to(k.dtype)
        if self.use_xpos:
            q = rotary_xpos(q, scale_base=self.xpos_scale_base)
            k = rotary_xpos(k, scale_base=self.xpos_scale_base, invert_scale=True)
        out = local_attention(q, k, v, window_size=self.window_size, mask=mask,
                              attn_bias=attn_bias, scale=8.0 / dh)
        out = out * torch.sigmoid(self.to_gate(inp)).transpose(1, 2)[..., None]
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * dh))


class DynamicPositionBias(nn.Module):
    """An MLP over relative distance: the (H, w, 2w) additive bias of the
    local attention."""

    def __init__(self, *, dim: int, heads: int, generator: "torch.Generator | None" = None):
        super().__init__()
        self.l1 = Linear(1, dim, generator=generator)
        self.l2 = Linear(dim, dim, generator=generator)
        self.l3 = Linear(dim, heads, generator=generator)

    def forward(self, window_size: int, total_size: int):
        dev = self.l1.weight.device
        rel = torch.arange(total_size, dtype=torch.float32, device=dev) \
            - (total_size - window_size)
        qpos = torch.arange(window_size, dtype=torch.float32, device=dev)
        dist = qpos[:, None] - rel[None, :] + (total_size - window_size)
        hid = F.silu(self.l1(dist.reshape(-1, 1)))
        hid = F.silu(self.l2(hid))
        return self.l3(hid).reshape(window_size, total_size, -1).permute(2, 0, 1)


class LocalTransformer(nn.Module):
    """depth (LocalMHA, FeedForward) residual pairs at the codec's
    bottleneck; with dynamic_pos_bias, a DynamicPositionBias in place of
    xpos."""

    def __init__(self, *, dim: int, depth: int, heads: int, window_size: int,
                 dim_head: int = 64, xpos_scale_base: "float | None" = None,
                 dynamic_pos_bias: bool = False, generator: "torch.Generator | None" = None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([LocalMHA(dim=dim, heads=heads, dim_head=dim_head,
                                    window_size=window_size, use_xpos=not dynamic_pos_bias,
                                    xpos_scale_base=xpos_scale_base, generator=generator),
                           FeedForward(dim, generator=generator)])
            for _ in range(depth))
        self.pos_bias = DynamicPositionBias(dim=dim // 2, heads=heads, generator=generator) \
            if dynamic_pos_bias else None
        self.window_size = window_size

    def forward(self, x, *, mask=None):
        w = self.window_size
        attn_bias = self.pos_bias(w, 2 * w) if self.pos_bias is not None else None
        for attn, ff in self.layers:
            x = attn(x, mask=mask, attn_bias=attn_bias) + x
            x = ff(x) + x
        return x
