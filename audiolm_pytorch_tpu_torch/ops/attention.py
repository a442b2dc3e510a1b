"""Masked scaled-dot-product attention in plain PyTorch: the math path of the
JAX package's `ops/attention.py::attend`. KV-cached prefill and decode take
it, as they do in JAX."""
from __future__ import annotations

import torch

__all__ = ["attend"]

_NEG_INF = -1e9  # finite mask value: fully masked rows stay NaN-free


def attend(q, k, v, *, mask=None, attn_bias=None, causal: bool = False,
           scale: "float | None" = None):
    """q: (B, H, N, D); k, v: (B, Hk, M, D) with Hk in {1, H}. mask broadcasts
    to (B, H, N, M), True = attend; attn_bias is additive (H, N, M) or
    (B, H, N, M). Products accumulate in float32 and the softmax runs in
    float32, as the JAX path does. Returns (B, H, N, D) in q's dtype."""
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
    attn = sim.softmax(-1).to(v.dtype)
    return torch.matmul(attn.float(), v.float()).to(q.dtype)
