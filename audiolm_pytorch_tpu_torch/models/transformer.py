"""Decoder-only transformer of the three LMs, held against the JAX package's
`models/transformer.py`: continuous rel-pos bias, a preallocated KV cache,
multi-query causal attention with value residuals, dynamic hyper-connections
over S residual streams, GEGLU feed-forward.

Attention dispatch: uncached self-attention, in scoring and in training,
goes through the flash-attention kernels with the key mask (the forgetful
causal mask in training) and either the rel-pos bias as its (2N-1, H) table
(the Semantic LM) or a caller's materialised (H, N, N) bias that replaces it
(`attn_bias`, the Coarse and Fine LMs; or a (B, H, N, N) one, a bias a
batch row); either bias's gradient flows back through autograd. A KV-cached prefill (from cache position 0) attends over
its own keys alone, through the flash kernel with the bias's first N
columns; the decode steps take the plain `attend` over the cache, as the
JAX package does. Text conditioning: cross attention over
the context with one null key/value (flash attention, not causal, with the
context's key mask), or the context as a prefix of the self-attention's
keys (flash attention, causal with M = P + N keys aligned to the bottom
right, the bias materialised as (H, N, P + N)).

Dropout, as the JAX package's: attention dropout drops the attention weights
after the softmax, so a train step with attn_dropout > 0 (a generator
given) takes the plain `attend`, each layer expanding the rel-pos table to
its (H, N, N) bias, as JAX sends a keyed dropout step to its math path;
without a generator (eval, scoring, generation) nothing is dropped and the
flash kernels run as they do without dropout. ff_dropout drops the
feed-forward's output. The self-attention, cross attention and feed-forward
of a layer draw their masks in that order (`ops/attention.py::draw_keep`).

Tensor parallelism (`parallel/tp.py::apply_tp_sharding`): a sharded
Attention holds its rank's heads of `to_q` and `to_out`; its queries' input
and the replicated k and v (after the value residual and the null key)
pass through `copy_in`, so the norm, `to_kv`, the null key and the first
layer's values get the gradient of every rank's heads, and its output's
partial products are summed (`reduce_out`). The Transformer cuts the
rel-pos table to the rank's heads (`cut`, whose backward sums the ranks'
parts, so every rank's MLP gets the whole gradient); an `attn_bias` given
to it must be the rank's already (the LMs cut theirs). Dropout draws the
mask of all the heads and keeps the rank's.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..nn.layers import FeedForward, LayerNorm, Linear, init_normal
from ..ops import attention as attention_ops
from ..ops.attention import attend
from ..ops.kernels.flash_attention import flash_attention
from ..ops.relpos import table_rows, toeplitz_expand
from ..ops.sampling import grad_shrink
from ..parallel.tp import copy_in, cut, reduce_out

__all__ = ["RelativePositionBias", "KVCache", "Attention", "HyperConnection",
           "TransformerLayer", "Transformer", "maybe_dropout"]


def maybe_dropout(x, p: float, generator):
    """x with each element kept with probability 1 - p and scaled by
    1 / (1 - p) (`draw_keep`), or x itself when p is 0 or there is no
    generator."""
    if p <= 0 or generator is None:
        return x
    keep = attention_ops.draw_keep(generator, x.shape, p, x.device)
    return torch.where(keep, x / (1 - p), 0.0)


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
    """Multi-query attention: per-head q, one shared k/v head, prenorm on the
    queries only, value residual. Self-attention is causal; with
    `dim_context` it attends over a context instead (cross attention, not
    causal), optionally layer-normed (`norm_context`), with `num_null_kv`
    learned null keys/values in front (classifier-free guidance: a row with
    its whole context masked still attends to them). With dropout > 0 and a
    generator in the call, the weights are dropped on the plain path. `tp`
    is the model group of a tensor-parallel one, which holds heads / world
    of the heads (None: all)."""

    def __init__(self, dim: int, *, heads: int = 8, dim_head: int = 64,
                 dim_context: "int | None" = None, norm_context: bool = False,
                 num_null_kv: int = 0, causal: bool = True, dropout: float = 0.0,
                 generator: "torch.Generator | None" = None):
        super().__init__()
        dim_context = dim_context if dim_context is not None else dim
        self.heads, self.dim_head, self.causal = heads, dim_head, causal
        self.dropout = dropout
        self.norm = LayerNorm(dim)
        self.to_q = Linear(dim, heads * dim_head, bias=False, generator=generator)
        self.to_kv = Linear(dim_context, dim_head * 2, bias=False, generator=generator)
        self.to_out = Linear(heads * dim_head, dim, bias=False, generator=generator)
        self.context_norm = LayerNorm(dim_context) if norm_context else None
        self.num_null_kv = num_null_kv
        self.null_kv = nn.Parameter(init_normal((2, num_null_kv, dim_head), 0.02, generator)) \
            if num_null_kv > 0 else None
        self.tp = None

    def forward(self, x, *, context=None, mask=None, bias_tab=None, bias=None,
                cache_bias=None, value_residual=None, cache_kv=None, cache_pos: int = 0,
                prefix_context=None, prefix_context_mask=None, generator=None):
        """x: (B, N, D). Without a cache: attention over the keys of x (causal,
        with bias_tab (2N-1, H) or bias (H, N, N), and key mask (B, N)), or of
        `context` (B, L, Dc) with its key mask (B, L). With prefix_context
        (B, P, D), its keys come first (key mask prefix_context_mask (B, P)),
        causal attention is aligned to the bottom right (every query sees the
        whole prefix) and `bias` is zero-padded over the prefix's keys. With
        cache_kv (k, v views of (B, max_len, dh)): the new k/v are written at
        cache_pos and the queries attend over the whole buffer, cache_bias
        (H, N, max_len) and mask (B, max_len) applied. With `generator` and
        dropout > 0 (a train step), the uncached attention runs on the plain
        path with its weights dropped, bias_tab expanded to (H, N, N) there.
        Returns (out, values before the residual)."""
        b, n, _ = x.shape
        if context is not None and self.context_norm is not None:
            context = self.context_norm(context)
        kv_input = context if context is not None else x
        if prefix_context is not None:
            p = prefix_context.shape[1]
            kv_input = torch.cat([prefix_context.to(x.dtype), x], dim=1)
            base = mask if mask is not None else x.new_ones(b, n, dtype=torch.bool)
            pmask = prefix_context_mask if prefix_context_mask is not None \
                else x.new_ones(b, p, dtype=torch.bool)
            mask = torch.cat([pmask, base], dim=-1)
            if bias is not None:
                bias = F.pad(bias, (p, 0))
        tp = self.tp
        heads = self.heads // tp.world if tp is not None else self.heads
        q = self.to_q(copy_in(self.norm(x), tp)).view(b, n, heads, self.dim_head).transpose(1, 2)
        k, v = self.to_kv(kv_input).chunk(2, dim=-1)  # (B, M, dh): from the raw input
        orig_v = v
        if value_residual is not None:
            v = 0.5 * (v + value_residual)

        if cache_kv is None:
            if self.null_kv is not None:
                nk, nv = (t.to(k.dtype).expand(b, -1, -1) for t in self.null_kv)
                k, v = torch.cat([nk, k], dim=1), torch.cat([nv, v], dim=1)
                if mask is not None:
                    mask = F.pad(mask, (self.num_null_kv, 0), value=True)
                if bias is not None:
                    bias = F.pad(bias, (self.num_null_kv, 0))
            k, v = copy_in(k, tp), copy_in(v, tp)
            if self.dropout > 0 and generator is not None:
                if bias_tab is not None:
                    bias = toeplitz_expand(bias_tab, n, n)
                out = attend(q, k[:, None], v[:, None],
                             mask=None if mask is None else mask[:, None, None, :],
                             attn_bias=bias, causal=self.causal, dropout=self.dropout,
                             generator=generator,
                             dropout_heads=None if tp is None else (tp.rank, tp.world))
            else:
                out = flash_attention(q.contiguous(), k[:, None].contiguous(),
                                      v[:, None].contiguous(), bias_tab=bias_tab, bias=bias,
                                      key_mask=mask, causal=self.causal)
        else:
            if self.null_kv is not None or context is not None or prefix_context is not None:
                raise ValueError("the KV cache is for causal self-attention only")
            ck, cv = cache_kv
            k, v = copy_in(k, tp), copy_in(v, tp)
            ck[:, cache_pos:cache_pos + n] = k.to(ck.dtype)
            cv[:, cache_pos:cache_pos + n] = v.to(cv.dtype)
            max_len = ck.shape[1]
            q_pos = cache_pos + torch.arange(n, device=x.device)
            valid = torch.arange(max_len, device=x.device)[None, :] <= q_pos[:, None]
            if cache_pos == 0:
                # the prefill sees its own n keys alone: causal flash attention (K1)
                out = flash_attention(
                    q.contiguous(), ck[:, None, :n].contiguous(), cv[:, None, :n].contiguous(),
                    bias=None if cache_bias is None else cache_bias[..., :n].contiguous(),
                    key_mask=None if mask is None else mask[:, :n].contiguous(), causal=True)
            else:
                full_mask = valid[None, None] if mask is None else valid & mask[:, None, None, :]
                out = attend(q, ck[:, None], cv[:, None], mask=full_mask, attn_bias=cache_bias)
        out = out.transpose(1, 2).reshape(b, n, -1)
        return reduce_out(self.to_out(out), tp), orig_v


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
        # the projection accumulates into float32, unrounded (JAX's
        # preferred_element_type=float32): a product of two bfloat16 values
        # is exact in float32
        proj = torch.tanh(torch.matmul(streams.float(), w.float()) * inv)  # (S, B, N, S+2)
        dyn_a = (proj[..., : s + 1] * self.dyn_alpha_scale.float()).to(dt)
        dyn_b = (proj[..., s + 1] * self.dyn_beta_scale.float()).to(dt)
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
    """Causal self-attention, then (with cross_attend) cross attention over
    the context with one null key/value and a normed context, then the
    feed-forward (its output dropped with ff_dropout), each in a
    hyper-connection over the residual streams."""

    def __init__(self, dim: int, *, heads: int, dim_head: int, num_streams: int,
                 index: int, cross_attend: bool = False, dim_context: "int | None" = None,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 generator: "torch.Generator | None" = None):
        super().__init__()
        self.attn = Attention(dim, heads=heads, dim_head=dim_head, dropout=attn_dropout,
                              generator=generator)
        self.ff = FeedForward(dim, generator=generator)
        self.ff_dropout = ff_dropout
        self.cross = Attention(dim, heads=heads, dim_head=dim_head, dim_context=dim_context,
                               norm_context=True, num_null_kv=1, causal=False,
                               dropout=attn_dropout, generator=generator) \
            if cross_attend else None
        if num_streams > 1:
            self.hc_attn = HyperConnection(dim=dim, num_streams=num_streams,
                                           layer_index=3 * index)
            self.hc_cross = HyperConnection(dim=dim, num_streams=num_streams,
                                            layer_index=3 * index + 1) if cross_attend else None
            self.hc_ff = HyperConnection(dim=dim, num_streams=num_streams,
                                         layer_index=3 * index + 2)
        else:
            self.hc_attn = self.hc_cross = self.hc_ff = None

    @staticmethod
    def _residual(hc, h, branch_fn):
        if hc is not None:
            return hc(h, branch_fn)
        out, *rest = branch_fn(h)
        return (out + h, *rest)

    def forward(self, h, attn_kwargs, cross_kwargs=None, generator=None):
        """Returns (h, the self-attention's values, the cross attention's
        values or None). `generator` draws the dropout masks of a train
        step."""
        h, values = self._residual(self.hc_attn, h,
                                   lambda x: self.attn(x, **attn_kwargs, generator=generator))
        cross_values = None
        if self.cross is not None:
            h, cross_values = self._residual(
                self.hc_cross, h, lambda x: self.cross(x, **cross_kwargs, generator=generator))
        h, = self._residual(self.hc_ff, h, lambda x: (
            maybe_dropout(self.ff(x), self.ff_dropout, generator),))
        return h, values, cross_values


class Transformer(nn.Module):
    """The layer stack. Weights are drawn from `generator` on the CPU and then
    moved to `device`. Conditioning, as the JAX package's: `cross_attend`
    adds a cross-attention branch over a context (B, L, dim_context) to
    every layer; `cond_as_self_attn_prefix` puts the context's keys in
    front of the self-attention's instead (the rel-pos bias then comes
    materialised, zero over the prefix, and there is no KV cache).
    attn_dropout and ff_dropout act in a call given a generator. `tp` is the
    model group when its attention is tensor-parallel: its rel-pos tables
    are then cut to the rank's heads (`rel_table`)."""

    def __init__(self, *, dim: int, depth: int, heads: int, dim_head: int = 64,
                 num_residual_streams: int = 4, rel_pos_bias: bool = True,
                 grad_shrink_alpha: float = 0.1, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, add_value_residual: bool = True,
                 cross_attend: bool = False, cond_as_self_attn_prefix: bool = False,
                 dim_context: "int | None" = None,
                 generator: "torch.Generator | None" = None,
                 device: "str | torch.device" = "cuda"):
        super().__init__()
        if cross_attend and cond_as_self_attn_prefix:
            raise ValueError("cross_attend and cond_as_self_attn_prefix exclude each other")
        device = resolve_device(device)
        self.depth, self.heads, self.dim_head = depth, heads, dim_head
        self.num_residual_streams = num_residual_streams
        self.grad_shrink_alpha = grad_shrink_alpha
        self.add_value_residual = add_value_residual
        self.cross_attend = cross_attend
        self.cond_as_self_attn_prefix = cond_as_self_attn_prefix
        self.layers = nn.ModuleList([
            TransformerLayer(dim, heads=heads, dim_head=dim_head,
                             num_streams=num_residual_streams, index=d,
                             cross_attend=cross_attend, dim_context=dim_context,
                             attn_dropout=attn_dropout, ff_dropout=ff_dropout,
                             generator=generator)
            for d in range(depth)])
        self.final_norm = LayerNorm(dim)
        self.rel_pos_bias = RelativePositionBias(dim=dim // 2, heads=heads, generator=generator) \
            if rel_pos_bias else None
        self.tp = None
        self.to(device)

    def rel_table(self, j: int):
        """The rel-pos MLP's (2j-1, heads) table, cut to this rank's heads
        under tensor parallelism."""
        return cut(self.rel_pos_bias.table(j), 1, self.tp)

    def forward(self, x, *, self_attn_mask=None, attn_bias=None,
                kv_cache: "KVCache | None" = None, context=None, context_mask=None,
                generator: "torch.Generator | None" = None):
        """x: (B, N, D); with kv_cache, only the new tokens after kv_cache.pos,
        whose k/v are written into the cache in place (pos advances by N).
        attn_bias: an additive (H, L, L) bias that replaces the rel-pos bias,
        L = N uncached (or uncached a (B, H, N, N) bias, one a batch row);
        with a cache, L = the cache's length and the rows of the new
        positions are taken from it. context (B, L, Dc) with its
        key mask context_mask (B, L): the cross attention's context, or the
        self-attention's prefix. `generator` draws the dropout masks of a
        train step (none without one)."""
        n = x.shape[1]
        x = grad_shrink(x, self.grad_shrink_alpha)
        kw = dict(mask=self_attn_mask)
        if (self.cross_attend or self.cond_as_self_attn_prefix) and context is None:
            raise ValueError("a conditioned transformer needs its context")
        if self.cond_as_self_attn_prefix:
            if kv_cache is not None:
                raise ValueError("prefix conditioning runs without a KV cache (the JAX "
                                 "package turns its cache off there too)")
            kw.update(prefix_context=context, prefix_context_mask=context_mask)
            if attn_bias is None and self.rel_pos_bias is not None:
                attn_bias = toeplitz_expand(self.rel_table(n), n, n)
        if kv_cache is not None:
            kw["cache_pos"] = kv_cache.pos
            if attn_bias is not None:
                # rows of the current positions (H, n, L); an (H, n, L) bias passes as it is
                kw["cache_bias"] = attn_bias if attn_bias.shape[1] == n else \
                    attn_bias[:, kv_cache.pos:kv_cache.pos + n]
            elif self.rel_pos_bias is not None:
                # O(L) decode bias: only the rows of the current positions
                max_len = kv_cache.k.shape[2]
                q_pos = kv_cache.pos + torch.arange(n, device=x.device)
                kw["cache_bias"] = table_rows(self.rel_table(max_len), q_pos, max_len)
        elif attn_bias is not None:
            kw["bias"] = attn_bias
        elif self.rel_pos_bias is not None:
            kw["bias_tab"] = self.rel_table(n)
        cross_kw = dict(context=context, mask=context_mask) if self.cross_attend else None

        s = self.num_residual_streams
        h = x.expand(s, *x.shape) if s > 1 else x
        value_residual = cross_residual = None
        for li, layer in enumerate(self.layers):
            if kv_cache is not None:
                kw["cache_kv"] = (kv_cache.k[li], kv_cache.v[li])
            h, values, cross_values = layer(
                h, dict(kw, value_residual=value_residual),
                None if cross_kw is None else dict(cross_kw, value_residual=cross_residual),
                generator=generator)
            if self.add_value_residual and value_residual is None:
                value_residual = values  # the first layer's values feed every later layer
            if self.add_value_residual and cross_residual is None:
                cross_residual = cross_values  # so do its cross attention's
        if kv_cache is not None:
            kv_cache.pos += n
        return self.final_norm(h.sum(0) if s > 1 else h)
