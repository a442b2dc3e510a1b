"""Decoder-only transformer of the Semantic LM, held against the JAX package's
`models/transformer.py`: continuous rel-pos bias, a preallocated KV cache,
multi-query causal attention with value residuals, dynamic hyper-connections
over S residual streams, GEGLU feed-forward.

Attention dispatch: uncached self-attention, in scoring and in training,
goes through the flash-attention kernels with the rel-pos bias as its
(2N-1, H) table and the key mask (the forgetful causal mask in training); the
table's gradient flows back into the bias MLP through autograd. The
KV-cached prefill and decode steps take the plain `attend`, as the JAX
package does. Cross attention, prefix conditioning and dropout are not part
of this port: dropout > 0 raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..nn.layers import FeedForward, LayerNorm, Linear
from ..ops.attention import attend
from ..ops.kernels.flash_attention import flash_attention
from ..ops.relpos import table_rows
from ..ops.sampling import grad_shrink

__all__ = ["RelativePositionBias", "KVCache", "Attention", "HyperConnection",
           "TransformerLayer", "Transformer"]


class RelativePositionBias(nn.Module):
    """MLP over signed distance -> per-head bias."""

    def __init__(self, *, dim: int, heads: int, layers: int = 3,
                 generator: "torch.Generator | None" = None):
        super().__init__()
        self.in_layer = Linear(1, dim, generator=generator)
        self.mid_layers = nn.ModuleList(
            [Linear(dim, dim, generator=generator) for _ in range(layers - 1)])
        self.out_layer = Linear(dim, heads, generator=generator)

    def table(self, j: int):
        """All 2j-1 distances -j+1 .. j-1 -> (2j-1, heads)."""
        x = torch.arange(-j + 1, j, dtype=torch.float32,
                         device=self.out_layer.weight.device)[:, None]
        h = F.silu(self.in_layer(x))
        for layer in self.mid_layers:
            h = F.silu(layer(h))
        return self.out_layer(h)


@dataclass
class KVCache:
    """Preallocated per-layer cache, k and v (layers, B, max_len, dim_head),
    and the fill position. The transformer writes it in place."""
    k: torch.Tensor
    v: torch.Tensor
    pos: int = 0

    @classmethod
    def create(cls, layers: int, batch: int, max_len: int, dim_head: int, *,
               dtype=torch.float32, device: "str | torch.device" = "cuda"):
        device = resolve_device(device)
        shape = (layers, batch, max_len, dim_head)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


class Attention(nn.Module):
    """Causal multi-query attention: per-head q, one shared k/v head, prenorm
    on the queries only, value residual."""

    def __init__(self, dim: int, *, heads: int = 8, dim_head: int = 64,
                 generator: "torch.Generator | None" = None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.norm = LayerNorm(dim)
        self.to_q = Linear(dim, heads * dim_head, bias=False, generator=generator)
        self.to_kv = Linear(dim, dim_head * 2, bias=False, generator=generator)
        self.to_out = Linear(heads * dim_head, dim, bias=False, generator=generator)

    def forward(self, x, *, mask=None, bias_tab=None, cache_bias=None,
                value_residual=None, cache_kv=None, cache_pos: int = 0):
        """x: (B, N, D). Without a cache: causal self-attention with
        bias_tab (2N-1, H) and key mask (B, N). With cache_kv (k, v views of
        (B, max_len, dh)): the new k/v are written at cache_pos and the
        queries attend over the whole buffer, cache_bias (H, N, max_len) and
        mask (B, max_len) applied. Returns (out, values before the residual)."""
        b, n, _ = x.shape
        q = self.to_q(self.norm(x)).view(b, n, self.heads, self.dim_head).transpose(1, 2)
        k, v = self.to_kv(x).chunk(2, dim=-1)  # (B, N, dh): from the raw input
        orig_v = v
        if value_residual is not None:
            v = 0.5 * (v + value_residual)

        if cache_kv is None:
            out = flash_attention(q.contiguous(), k[:, None].contiguous(),
                                  v[:, None].contiguous(), bias_tab=bias_tab,
                                  key_mask=mask, causal=True)
        else:
            ck, cv = cache_kv
            ck[:, cache_pos:cache_pos + n] = k.to(ck.dtype)
            cv[:, cache_pos:cache_pos + n] = v.to(cv.dtype)
            max_len = ck.shape[1]
            q_pos = cache_pos + torch.arange(n, device=x.device)
            valid = torch.arange(max_len, device=x.device)[None, :] <= q_pos[:, None]
            full_mask = valid[None, None] if mask is None else valid & mask[:, None, None, :]
            out = attend(q, ck[:, None], cv[:, None], mask=full_mask, attn_bias=cache_bias)
        out = out.transpose(1, 2).reshape(b, n, -1)
        return self.to_out(out), orig_v


class HyperConnection(nn.Module):
    """Dynamic hyper-connection (arXiv:2409.19606) wrapping one branch over S
    residual streams (S, B, N, D). Static part: read stream layer_index % S,
    identity mixing, write to all streams. Dynamic part: tanh(rmsnorm(x) @ W)
    * scale, with W zero at init."""

    def __init__(self, *, dim: int, num_streams: int, layer_index: int):
        super().__init__()
        s = num_streams
        self.alpha_in = nn.Parameter(F.one_hot(torch.tensor(layer_index % s), s).float())
        self.alpha_mix = nn.Parameter(torch.eye(s))
        self.beta = nn.Parameter(torch.ones(s))
        self.dyn_alpha_w = nn.Parameter(torch.zeros(dim, s + 1))
        self.dyn_alpha_scale = nn.Parameter(torch.tensor(1e-2))
        self.dyn_beta_w = nn.Parameter(torch.zeros(dim))
        self.dyn_beta_scale = nn.Parameter(torch.tensor(1e-2))
        self.num_streams = s

    def forward(self, streams, branch_fn):
        dt, s = streams.dtype, self.num_streams
        # rmsnorm factors out of the projection: tanh(x @ W * rsqrt(mean(x^2)))
        inv = torch.rsqrt(streams.float().square().mean(-1, keepdim=True) + 1e-6)
        w = torch.cat([self.dyn_alpha_w, self.dyn_beta_w[:, None]], dim=1).to(dt)
        proj = torch.tanh(torch.matmul(streams, w).float() * inv)  # (S, B, N, S+2)
        dyn_a = (proj[..., : s + 1] * self.dyn_alpha_scale).to(dt)
        dyn_b = (proj[..., s + 1] * self.dyn_beta_scale).to(dt)
        coef = torch.cat([
            (self.alpha_in.to(dt)[:, None, None] + dyn_a[..., 0])[..., None],
            self.alpha_mix.to(dt)[:, None, None, :] + dyn_a[..., 1:]], dim=-1)
        # slot 0: the branch input; slots 1..S: the mixed streams
        both = torch.einsum("sbnt,sbnd->tbnd", coef, streams)
        branch_in, mixed = both[0], both[1:]
        beta_eff = self.beta.to(dt)[:, None, None] + dyn_b  # (S, B, N)
        out, *rest = branch_fn(branch_in)
        return (mixed + beta_eff[..., None] * out[None], *rest)


class TransformerLayer(nn.Module):
    def __init__(self, dim: int, *, heads: int, dim_head: int, num_streams: int,
                 index: int, generator: "torch.Generator | None" = None):
        super().__init__()
        self.attn = Attention(dim, heads=heads, dim_head=dim_head, generator=generator)
        self.ff = FeedForward(dim, generator=generator)
        if num_streams > 1:
            self.hc_attn = HyperConnection(dim=dim, num_streams=num_streams,
                                           layer_index=3 * index)
            self.hc_ff = HyperConnection(dim=dim, num_streams=num_streams,
                                         layer_index=3 * index + 2)
        else:
            self.hc_attn = self.hc_ff = None

    @staticmethod
    def _residual(hc, h, branch_fn):
        if hc is not None:
            return hc(h, branch_fn)
        out, *rest = branch_fn(h)
        return (out + h, *rest)

    def forward(self, h, attn_kwargs):
        h, values = self._residual(self.hc_attn, h, lambda x: self.attn(x, **attn_kwargs))
        h, = self._residual(self.hc_ff, h, lambda x: (self.ff(x),))
        return h, values


class Transformer(nn.Module):
    """The layer stack. Weights are drawn from `generator` on the CPU and then
    moved to `device`."""

    def __init__(self, *, dim: int, depth: int, heads: int, dim_head: int = 64,
                 num_residual_streams: int = 4, rel_pos_bias: bool = True,
                 grad_shrink_alpha: float = 0.1, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0,
                 generator: "torch.Generator | None" = None,
                 device: "str | torch.device" = "cuda"):
        super().__init__()
        if attn_dropout > 0 or ff_dropout > 0:
            # the JAX package sends dropout > 0 to the math path
            # (models/transformer.py:236-240); neither is ported yet
            raise NotImplementedError("attn_dropout / ff_dropout > 0 is not ported")
        device = resolve_device(device)
        self.depth, self.heads, self.dim_head = depth, heads, dim_head
        self.num_residual_streams = num_residual_streams
        self.grad_shrink_alpha = grad_shrink_alpha
        self.layers = nn.ModuleList([
            TransformerLayer(dim, heads=heads, dim_head=dim_head,
                             num_streams=num_residual_streams, index=d, generator=generator)
            for d in range(depth)])
        self.final_norm = LayerNorm(dim)
        self.rel_pos_bias = RelativePositionBias(dim=dim // 2, heads=heads, generator=generator) \
            if rel_pos_bias else None
        self.to(device)

    def forward(self, x, *, self_attn_mask=None, kv_cache: "KVCache | None" = None):
        """x: (B, N, D); with kv_cache, only the new tokens after kv_cache.pos,
        whose k/v are written into the cache in place (pos advances by N)."""
        n = x.shape[1]
        x = grad_shrink(x, self.grad_shrink_alpha)
        kw = dict(mask=self_attn_mask)
        if kv_cache is not None:
            kw["cache_pos"] = kv_cache.pos
            if self.rel_pos_bias is not None:
                # O(L) decode bias: only the rows of the current positions
                max_len = kv_cache.k.shape[2]
                q_pos = kv_cache.pos + torch.arange(n, device=x.device)
                kw["cache_bias"] = table_rows(self.rel_pos_bias.table(max_len), q_pos, max_len)
        elif self.rel_pos_bias is not None:
            kw["bias_tab"] = self.rel_pos_bias.table(n)

        s = self.num_residual_streams
        h = x.expand(s, *x.shape) if s > 1 else x
        value_residual = None
        for li, layer in enumerate(self.layers):
            if kv_cache is not None:
                kw["cache_kv"] = (kv_cache.k[li], kv_cache.v[li])
            h, values = layer(h, dict(kw, value_residual=value_residual))
            if value_residual is None:  # the first layer's values feed every later layer
                value_residual = values
        if kv_cache is not None:
            kv_cache.pos += n
        return self.final_norm(h.sum(0) if s > 1 else h)
