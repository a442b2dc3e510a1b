"""The three LMs, held against the JAX package's `models/lm.py`
(`SemanticTransformer`, `CoarseTransformer`, `FineTransformer`), with text
conditioning, and their checkpoint loaders.

The Semantic LM's attention takes its rel-pos bias as a (2N-1, H) table. The
Coarse and Fine LMs build a materialised (H, L, L) bias with learned parts
(`build_attn_bias`) that replaces the transformer's rel-pos bias: the
flash-attention kernels read it tile by tile, and its gradient (K5) flows
back into `cross_attn_bias`, the rel-pos MLP, `null_pos_bias` and the 2-D
position MLP through autograd.

Text conditioning (`has_condition`; `audio_text_condition` conditions on
embeddings of the model's own width): T5 embeddings (or a caller's
`text_embeds`), their mask recovered as any(embeds != 0), projected to the
model's width, and attended by cross attention in every layer, or, with
`cond_as_self_attn_prefix`, put in front of the self-attention's keys. In
training a row's condition is dropped with probability `cond_drop_prob`
(`draw_cond_keep`, from an explicit generator, which draws the dropout
masks too); `forward_with_cond_scale`
runs classifier-free guidance as one stacked [cond | uncond] batch.

Under tensor parallelism (`parallel/tp.py::apply_tp_sharding`) an LM holds
its rank's part of the cut parameters: its embeddings are looked up
(`_lookup`) and its logits computed (`logits`, `quantizer_logits`,
`head_logits`) through `parallel.tp.embedding` and `parallel.tp.project`,
which give the full rows and logits on every rank, the logit bias added
once after the sum; the per-head tensors computed from replicated
parameters (`cross_attn_bias`, `null_pos_bias`, the position MLPs' tables)
are cut to the rank's heads with `parallel.tp.cut`.
"""
from __future__ import annotations

import functools
import inspect

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..nn.layers import Linear, init_normal
from ..ops.relpos import toeplitz_expand
from ..parallel.mesh import local_rows
from ..parallel.tp import cut, embedding, project
from ..ops.sampling import get_embeds
from ..weights import read_npz, state_dict_from_jax
from .t5 import DEFAULT_T5_NAME, get_encoded_dim, t5_encode_text
from .transformer import Transformer

__all__ = ["SemanticTransformer", "CoarseTransformer", "FineTransformer",
           "load_semantic_transformer", "load_coarse_transformer", "load_fine_transformer",
           "draw_cond_keep"]


def _jax_config(args: dict) -> dict:
    """The JAX package's `configs` of an LM from the port's constructor
    arguments: the attention dispatch at JAX's default; `add_value_residual`
    only when off (JAX's transformer has it on)."""
    cfg = {k: v for k, v in args.items() if k not in ("self", "__class__", "seed", "device")}
    if cfg.get("add_value_residual", True):
        cfg.pop("add_value_residual", None)
    cfg.update(flash_attn="auto")
    return dict(sorted(cfg.items()))


def draw_cond_keep(batch: int, keep_prob: float, generator, device):
    """(batch,) bool: True where a row keeps its condition, each with
    probability keep_prob, drawn from `generator` (the JAX package's
    prob_mask_like: uniform < keep_prob); under data parallelism this
    rank's rows of the whole batch's draw (`parallel.mesh.local_rows`)."""
    gen_device = generator.device if generator is not None else "cpu"
    keep = local_rows(lambda s: torch.rand(s, generator=generator, device=gen_device)
                      < keep_prob, (batch,))
    return keep.to(device)


class _TensorParallel:
    """What the three LMs share under tensor parallelism: `tp` (the model
    group; None when whole) and `tp_dims` ({state_dict key: the dim cut}),
    both set by `parallel.tp.apply_tp_sharding` (the class defaults are
    replaced, never changed)."""

    tp = None
    tp_dims: dict = {}

    def _param(self, key):
        return functools.reduce(getattr, key.split("."), self)

    def _lookup(self, key, idx):
        """Rows `idx` of the table parameter `key`, whole on every rank."""
        return embedding(self._param(key), idx, self.tp_dims.get(key), self.tp)

    def _project(self, key, x, product):
        """product(x, w) of the weight parameter `key` (w the rank's part),
        whole on every rank: its last dim is the inputs' (x's last)."""
        w = self._param(key)
        dim = self.tp_dims.get(key)
        return project(x, lambda a: product(a, w), None if dim is None else dim == w.ndim - 1,
                       self.tp)

    def _heads_cut(self, t, dim):
        """t's part of this rank's heads (along dim) when the attention is
        tensor-parallel."""
        return cut(t, dim, self.transformer.tp)

    def embed_semantic(self, ids):
        """(B, N) semantic ids -> (B, N, D), pad -1 embedding to 0 (the
        Semantic and Coarse LMs)."""
        return get_embeds(functools.partial(self._lookup, "semantic_embedding"), ids)

    def quantizer_logits(self, key, tokens):
        """(B, N, C) logits of tokens (B, N, D) through the (Q, C, D) heads
        `key`, position i through head i % Q."""
        return self._project(key, tokens,
                             lambda x, w: _per_quantizer_logits(x, w, w.shape[0]))

    def head_logits(self, key, hidden, q: int):
        """(B, C) logits of hidden (B, D) through head q of `key`."""
        return self._project(key, hidden, lambda x, w: x @ w[q].t().to(x.dtype))


class _Conditioned:
    """Text conditioning shared by the three LMs (the JAX package's
    `_process_text_condition`, `_proj_text`, `embed_text`)."""

    def _setup_condition(self, dim, *, has_condition, audio_text_condition,
                         cond_as_self_attn_prefix, cond_drop_prob, t5_name, cond_dim, generator):
        if audio_text_condition:
            has_condition = True
            cond_dim = cond_dim if cond_dim is not None else dim
        self.has_condition = has_condition
        self.cond_as_self_attn_prefix = cond_as_self_attn_prefix
        self.cond_drop_prob = cond_drop_prob
        self.t5_name = t5_name
        text_dim = cond_dim if cond_dim is not None else get_encoded_dim(t5_name)
        # an unconditioned model holds the projection too, so its checkpoints load whole
        self.proj_text_embed = Linear(text_dim, dim, bias=False, generator=generator) \
            if text_dim != dim else None
        return dict(cross_attend=has_condition and not cond_as_self_attn_prefix,
                    cond_as_self_attn_prefix=cond_as_self_attn_prefix)

    def _proj_text(self, t):
        return self.proj_text_embed(t) if self.proj_text_embed is not None else t

    def embed_text(self, text):
        """T5 embeddings (B, L, dim_t5) of a list of strings, on the model's device."""
        return t5_encode_text(text, name=self.t5_name, device=next(self.parameters()).device)

    def _condition(self, text, text_embeds, text_mask, cond_drop_prob, generator, batch):
        """(projected text embeddings, their key mask) or (None, None): the
        mask recovered as any(embeds != 0) when not given, then with
        probability cond_drop_prob a row's mask cleared (its condition
        dropped; 1 clears every row)."""
        has_text = text is not None or text_embeds is not None
        if self.has_condition != has_text:
            raise ValueError("has_condition and the presence of text / text_embeds must agree")
        if not has_text:
            return None, None
        if text_embeds is None:
            text_embeds = self.embed_text(text)
        if text_mask is None:
            text_mask = (text_embeds != 0).any(-1)
        text_embeds = self._proj_text(text_embeds)
        cond_drop_prob = self.cond_drop_prob if cond_drop_prob is None else cond_drop_prob
        if cond_drop_prob >= 1:
            text_mask = torch.zeros_like(text_mask)
        elif cond_drop_prob > 0:
            if generator is None:
                raise ValueError("cond_drop_prob in (0, 1) needs a generator")
            keep = draw_cond_keep(batch, 1 - cond_drop_prob, generator, text_mask.device)
            text_mask = keep[:, None] & text_mask
        return text_embeds, text_mask

    def _with_cond_scale(self, fn, tiled, cond_scale, text_embeds, text_mask, kwargs):
        """fn(*tiled, text_embeds=..., text_mask=..., cond_drop_prob=0,
        **kwargs) with classifier-free guidance: the batch stacked as
        [cond | uncond] (the uncond half's text mask cleared) in one call,
        each output null + (cond - null) * cond_scale."""
        if cond_scale == 1 or not self.has_condition:
            return fn(*tiled, text_embeds=text_embeds, text_mask=text_mask, cond_drop_prob=0.0,
                      **kwargs)
        if text_mask is None and text_embeds is not None:
            text_mask = (text_embeds != 0).any(-1)
        two = [torch.cat([a, a]) for a in tiled]
        if kwargs.get("self_attn_mask") is not None:
            kwargs = dict(kwargs, self_attn_mask=torch.cat([kwargs["self_attn_mask"]] * 2))
        out = fn(*two, text_embeds=torch.cat([text_embeds, text_embeds]),
                 text_mask=torch.cat([text_mask, torch.zeros_like(text_mask)]),
                 cond_drop_prob=0.0, **kwargs)

        def combine(logits):
            if logits is None:
                return None
            cond, null = logits.chunk(2)
            return null + (cond - null) * cond_scale

        return tuple(map(combine, out)) if isinstance(out, tuple) else combine(out)


class SemanticTransformer(_Conditioned, _TensorParallel, nn.Module):
    """LM over semantic token ids plus EOS (= num_semantic_tokens). Weights
    are drawn from `seed` on the CPU and then moved to `device`; `config`
    holds the arguments as the JAX package's checkpoints store them."""

    def __init__(self, *, dim: int, depth: int, num_semantic_tokens: int,
                 heads: int = 8, dim_head: int = 64, num_residual_streams: int = 4,
                 rel_pos_bias: bool = True, grad_shrink_alpha: float = 0.1,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 add_value_residual: bool = True,
                 t5_name: str = DEFAULT_T5_NAME, cond_dim: "int | None" = None,
                 has_condition: bool = False, audio_text_condition: bool = False,
                 cond_as_self_attn_prefix: bool = False, cond_drop_prob: float = 0.5,
                 seed: int = 0, device: "str | torch.device" = "cuda"):
        config = _jax_config(locals())
        super().__init__()
        self.config = config
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.num_semantic_tokens = num_semantic_tokens
        self.eos_id = num_semantic_tokens
        self.start_token = nn.Parameter(init_normal((dim,), 1.0, g))
        self.semantic_embedding = nn.Parameter(init_normal((num_semantic_tokens + 1, dim), 0.02, g))
        cond = self._setup_condition(
            dim, has_condition=has_condition, audio_text_condition=audio_text_condition,
            cond_as_self_attn_prefix=cond_as_self_attn_prefix, cond_drop_prob=cond_drop_prob,
            t5_name=t5_name, cond_dim=cond_dim, generator=g)
        self.transformer = Transformer(
            dim=dim, depth=depth, heads=heads, dim_head=dim_head,
            num_residual_streams=num_residual_streams, rel_pos_bias=rel_pos_bias,
            grad_shrink_alpha=grad_shrink_alpha, attn_dropout=attn_dropout,
            ff_dropout=ff_dropout, add_value_residual=add_value_residual,
            **cond, generator=g, device="cpu")
        self.to_logits = Linear(dim, num_semantic_tokens + 1, generator=g)
        self.to(device)

    def embed_ids(self, ids):
        """[start] + ids (B, N), pad -1 embedding to 0 -> (B, N+1, D)."""
        tokens = self.embed_semantic(ids)
        start = self.start_token.to(tokens.dtype).expand(ids.shape[0], 1, -1)
        return torch.cat([start, tokens], dim=1)

    def logits(self, h):
        """(B, N, V) logits of the transformer's output h (B, N, D)."""
        if self.tp is None:
            return self.to_logits(h)
        out = self._project("to_logits.weight", h, lambda x, w: F.linear(x, w.to(x.dtype)))
        return out + self.to_logits.bias.to(out.dtype)

    def forward(self, ids, *, self_attn_mask=None, return_loss: bool = False, text=None,
                text_embeds=None, text_mask=None, cond_drop_prob=None, generator=None):
        """Logits (B, N+1, V) for [start] + ids, or (B, N, V) for [start] +
        ids[:, :-1] with return_loss (the loss itself is the wrapper's).
        self_attn_mask: (B, N) bool key mask over the ids, True = attend; the
        start token is always attended. A conditioned model takes `text` or
        `text_embeds` (B, L, cond dim) with its mask (B, L), the condition
        dropped per row with cond_drop_prob (default the model's), drawn
        from `generator`, which also draws the dropout masks (attn_dropout,
        ff_dropout: none without a generator)."""
        context, context_mask = self._condition(text, text_embeds, text_mask, cond_drop_prob,
                                                generator, ids.shape[0])
        if return_loss:
            ids = ids[:, :-1]
        if self_attn_mask is not None:
            self_attn_mask = torch.nn.functional.pad(self_attn_mask, (1, 0), value=True)
        return self.logits(self.transformer(self.embed_ids(ids), self_attn_mask=self_attn_mask,
                                            context=context, context_mask=context_mask,
                                            generator=generator))

    def forward_with_cond_scale(self, ids, *, cond_scale: float = 3.0, text_embeds=None,
                                text_mask=None, **kwargs):
        """Logits with classifier-free guidance at cond_scale: one forward of
        the stacked [cond | uncond] batch."""
        return self._with_cond_scale(self.forward, (ids,), cond_scale, text_embeds, text_mask,
                                     kwargs)


def _tile_offsets(num_q: int, length: int, stride: int):
    """[0, stride, 2*stride, ...] cycling over the quantizers, `length` long."""
    return (np.arange(length) % num_q) * stride


def _per_quantizer_logits(tokens, logit_weights, num_q: int):
    """tokens (B, N, D), logit_weights (Q, C, D) -> (B, N, C), position i
    through head i % Q; one product over the whole groups of Q positions and
    one over the remainder, so no (N, C, D) weight gather is built."""
    b, n, d = tokens.shape
    w = logit_weights.to(tokens.dtype)
    nq = n - n % num_q
    group = tokens[:, :nq].reshape(b, nq // num_q, num_q, d)
    logits = torch.einsum("qcd,bnqd->bnqc", w, group).reshape(b, nq, -1)
    if nq == n:
        return logits
    rest = torch.einsum("qcd,bqd->bqc", w[:n - nq], tokens[:, nq:])
    return torch.cat([logits, rest], dim=1)


def _start(token, b, dtype):
    return token.to(dtype).expand(b, 1, -1)


def _pad_cached(out, kv_cache_pos: int):
    """Outputs of the positions after a cache's fill position, padded with
    zeros in front to their absolute positions (the JAX package's LM-level
    cache convenience)."""
    if not kv_cache_pos:
        return out
    pad = out.new_zeros(out.shape[0], kv_cache_pos, out.shape[-1])
    return torch.cat([pad, out], dim=1)


class CoarseTransformer(_Conditioned, _TensorParallel, nn.Module):
    """Joint LM over [semantic start, semantic ids, coarse start, coarse
    codes] with per-quantizer embeddings (offset stride codebook_size + 1,
    so each quantizer has its own EOS row) and heads. Weights are drawn from
    `seed` on the CPU and then moved to `device`."""

    def __init__(self, *, codebook_size: int, num_coarse_quantizers: int, dim: int, depth: int,
                 num_semantic_tokens: int, heads: int = 8, dim_head: int = 64,
                 num_residual_streams: int = 4, rel_pos_bias: bool = True,
                 grad_shrink_alpha: float = 0.1, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, add_value_residual: bool = True,
                 project_semantic_logits: bool = True, t5_name: str = DEFAULT_T5_NAME,
                 cond_dim: "int | None" = None, has_condition: bool = False,
                 audio_text_condition: bool = False, cond_as_self_attn_prefix: bool = False,
                 cond_drop_prob: float = 0.5, seed: int = 0,
                 device: "str | torch.device" = "cuda"):
        config = _jax_config(locals())
        super().__init__()
        self.config = config
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.num_semantic_tokens = num_semantic_tokens
        self.semantic_eos_id = num_semantic_tokens
        self.coarse_eos_id = codebook_size
        self.codebook_size = codebook_size
        self.num_coarse_quantizers = num_coarse_quantizers
        cb_eos = codebook_size + 1
        self.semantic_start_token = nn.Parameter(init_normal((dim,), 1.0, g))
        self.coarse_start_token = nn.Parameter(init_normal((dim,), 1.0, g))
        self.semantic_embedding = nn.Parameter(init_normal((num_semantic_tokens + 1, dim), 0.02, g))
        self.coarse_embedding = nn.Parameter(
            init_normal((num_coarse_quantizers * cb_eos, dim), 0.02, g))
        self.coarse_quantize_embedding = nn.Parameter(
            init_normal((num_coarse_quantizers, dim), 0.02, g))
        cond = self._setup_condition(
            dim, has_condition=has_condition, audio_text_condition=audio_text_condition,
            cond_as_self_attn_prefix=cond_as_self_attn_prefix, cond_drop_prob=cond_drop_prob,
            t5_name=t5_name, cond_dim=cond_dim, generator=g)
        self.cross_attn_bias = nn.Parameter(torch.zeros(heads, 1, 1)) if rel_pos_bias else None
        self.transformer = Transformer(
            dim=dim, depth=depth, heads=heads, dim_head=dim_head,
            num_residual_streams=num_residual_streams, rel_pos_bias=rel_pos_bias,
            grad_shrink_alpha=grad_shrink_alpha, attn_dropout=attn_dropout,
            ff_dropout=ff_dropout, add_value_residual=add_value_residual,
            **cond, generator=g, device="cpu")
        self.to_semantic_logits = Linear(dim, num_semantic_tokens + 1, generator=g) \
            if project_semantic_logits else None
        self.coarse_logit_weights = nn.Parameter(
            init_normal((num_coarse_quantizers, cb_eos, dim), 0.02, g))
        self.to(device)

    def embed_coarse(self, coarse_token_ids):
        """(B, Nc) -> (B, Nc, D): per-quantizer rows, -1 embeds to 0, plus the
        quantizer embedding."""
        n = coarse_token_ids.shape[-1]
        dev = coarse_token_ids.device
        qpos = torch.arange(n, device=dev) % self.num_coarse_quantizers
        pad = coarse_token_ids < 0
        emb = self._lookup("coarse_embedding", coarse_token_ids.masked_fill(pad, 0)
                           + qpos * (self.codebook_size + 1))
        return emb.masked_fill(pad[..., None], 0.0) + \
            self._lookup("coarse_quantize_embedding", qpos)

    def embed_code(self, code, q: int):
        """(B,) codes of quantizer q -> (B, D), with its quantizer embedding."""
        return self._lookup("coarse_embedding", code + q * (self.codebook_size + 1)) + \
            self._lookup("coarse_quantize_embedding", q)

    def build_attn_bias(self, semantic_seq_len: int, total_len: int):
        """(H, L, L) rel-pos bias with the learned `cross_attn_bias` scalar of
        each head across the semantic/coarse boundary, or None."""
        rel = self.transformer.rel_pos_bias
        if rel is None:
            return None
        bias = toeplitz_expand(self.transformer.rel_table(total_len), total_len, total_len)
        is_semantic = torch.arange(total_len, device=bias.device) < semantic_seq_len + 1
        is_cross = is_semantic[:, None] ^ is_semantic[None, :]
        return torch.where(is_cross[None], self._heads_cut(self.cross_attn_bias, 0), bias)

    def forward(self, semantic_token_ids, coarse_token_ids, *, self_attn_mask=None,
                return_only_coarse_logits: bool = False, kv_cache=None, text=None,
                text_embeds=None, text_mask=None, cond_drop_prob=None, generator=None):
        """(semantic logits (B, S, num_semantic_tokens + 1) or None, coarse
        logits (B, Nc + 1, codebook_size + 1)) for [start, semantic ids, start,
        coarse codes]; self_attn_mask (B, L) is a key mask over all L
        positions. With kv_cache, only the positions after its fill position
        run, against a bias as long as the cache; the outputs before them are
        zeros. The condition as the Semantic LM's."""
        b = semantic_token_ids.shape[0]
        context, context_mask = self._condition(text, text_embeds, text_mask, cond_drop_prob,
                                                generator, b)
        sem = semantic_token_ids.reshape(b, -1)
        coarse = coarse_token_ids.reshape(b, -1)
        sem_tokens = self.embed_semantic(sem)
        coarse_tokens = self.embed_coarse(coarse)
        sem_len = sem.shape[1]
        tokens = torch.cat([_start(self.semantic_start_token, b, sem_tokens.dtype), sem_tokens,
                            _start(self.coarse_start_token, b, coarse_tokens.dtype),
                            coarse_tokens], dim=1)
        pos = kv_cache.pos if kv_cache is not None else 0
        bias_len = kv_cache.k.shape[2] if kv_cache is not None else tokens.shape[1]
        out = self.transformer(tokens[:, pos:], self_attn_mask=self_attn_mask,
                               attn_bias=self.build_attn_bias(sem_len, bias_len),
                               kv_cache=kv_cache, context=context, context_mask=context_mask,
                               generator=generator)
        out = _pad_cached(out, pos)
        semantic_logits = None
        if not return_only_coarse_logits and self.to_semantic_logits is not None:
            semantic_logits = self.to_semantic_logits(out[:, :sem_len])
        coarse_logits = self.quantizer_logits("coarse_logit_weights", out[:, sem_len + 1:])
        return semantic_logits, coarse_logits

    def forward_with_cond_scale(self, semantic_token_ids, coarse_token_ids, *,
                                cond_scale: float = 3.0, text_embeds=None, text_mask=None,
                                **kwargs):
        """Both logits with classifier-free guidance, one stacked forward."""
        return self._with_cond_scale(self.forward, (semantic_token_ids, coarse_token_ids),
                                     cond_scale, text_embeds, text_mask, kwargs)


@functools.lru_cache(maxsize=16)
def _fine_bias_layout(qc: int, qf: int, coarse_len: int, fine_len: int):
    """The layout of the Fine LM's 2-D position bias over [coarse start,
    coarse, fine start, fine] (L = coarse_len + fine_len + 2): the MLP's
    (rel time step, rel quantizer) inputs, each position's (time step,
    quantizer) (L, 2), the (L,) start-token flags, and the two offsets that
    turn a pair's difference into its row of the MLP's table."""
    coarse_seq = -(-coarse_len // qc)
    fine_seq = -(-fine_len // qf) if fine_len else 0
    max_seq = max(coarse_seq, fine_seq, 1)
    num_offsets = qc + qf
    coarse_pos = np.repeat(np.arange(coarse_seq), qc)[:coarse_len]
    fine_pos = np.repeat(np.arange(max(fine_seq, 1)), qf)[:fine_len]
    seq_positions = np.concatenate([[-1], coarse_pos, [-1], fine_pos])
    seq_offsets = np.concatenate([[0], _tile_offsets(qc, coarse_len, 1),
                                  [0], _tile_offsets(qf, fine_len, 1) + qc])
    pos_inp = np.stack([np.maximum(seq_positions, 0), seq_offsets], axis=-1)
    rel_seq_len, rel_offsets = 2 * max_seq - 1, 2 * num_offsets - 1
    mlp_inputs = np.stack([np.repeat(np.arange(rel_seq_len), rel_offsets),
                           np.tile(np.arange(rel_offsets), rel_seq_len)], -1).astype(np.float32)
    return mlp_inputs, pos_inp, seq_positions == -1, (max_seq - 1, num_offsets - 1)


class FineTransformer(_Conditioned, _TensorParallel, nn.Module):
    """Joint LM over [coarse start, coarse codes, fine start, fine codes]
    with a 2-D (time step, quantizer) MLP position bias, `null_pos_bias` on
    the start tokens' rows and columns, and per-quantizer embeddings (offset
    stride codebook_size) and heads. Weights are drawn from `seed` on the CPU
    and then moved to `device`."""

    def __init__(self, *, num_coarse_quantizers: int, num_fine_quantizers: int,
                 codebook_size: int, dim: int, depth: int, heads: int = 8, dim_head: int = 64,
                 num_residual_streams: int = 4, rel_pos_bias: bool = True,
                 grad_shrink_alpha: float = 0.1, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, add_value_residual: bool = True,
                 project_coarse_logits: bool = True, pad_id: int = -1,
                 t5_name: str = DEFAULT_T5_NAME, cond_dim: "int | None" = None,
                 has_condition: bool = False, audio_text_condition: bool = False,
                 cond_as_self_attn_prefix: bool = False, cond_drop_prob: float = 0.5,
                 seed: int = 0, device: "str | torch.device" = "cuda"):
        config = _jax_config(locals())
        super().__init__()
        self.config = config
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.num_coarse_quantizers = num_coarse_quantizers
        self.num_fine_quantizers = num_fine_quantizers
        self.codebook_size = codebook_size
        self.pad_id = pad_id
        self.eos_id = codebook_size
        self.coarse_start_token = nn.Parameter(init_normal((dim,), 1.0, g))
        self.fine_start_token = nn.Parameter(init_normal((dim,), 1.0, g))
        self.coarse_embedding = nn.Parameter(
            init_normal((num_coarse_quantizers * codebook_size, dim), 0.02, g))
        self.fine_embedding = nn.Parameter(
            init_normal((num_fine_quantizers * codebook_size, dim), 0.02, g))
        self.coarse_quantize_embedding = nn.Parameter(
            init_normal((num_coarse_quantizers, dim), 0.02, g))
        self.fine_quantize_embedding = nn.Parameter(
            init_normal((num_fine_quantizers, dim), 0.02, g))
        cond = self._setup_condition(
            dim, has_condition=has_condition, audio_text_condition=audio_text_condition,
            cond_as_self_attn_prefix=cond_as_self_attn_prefix, cond_drop_prob=cond_drop_prob,
            t5_name=t5_name, cond_dim=cond_dim, generator=g)
        self.transformer = Transformer(
            dim=dim, depth=depth, heads=heads, dim_head=dim_head,
            num_residual_streams=num_residual_streams, rel_pos_bias=False,
            grad_shrink_alpha=grad_shrink_alpha, attn_dropout=attn_dropout,
            ff_dropout=ff_dropout, add_value_residual=add_value_residual,
            **cond, generator=g, device="cpu")
        if rel_pos_bias:
            self.null_pos_bias = nn.Parameter(init_normal((heads, 1, 1), 1.0, g))
            pd = dim // 2
            self.pos_bias_l1 = Linear(2, pd, generator=g)
            self.pos_bias_l2 = Linear(pd, pd, generator=g)
            self.pos_bias_l3 = Linear(pd, heads, generator=g)
        else:
            self.null_pos_bias = self.pos_bias_l1 = self.pos_bias_l2 = self.pos_bias_l3 = None
        self.coarse_logit_weights = nn.Parameter(
            init_normal((num_coarse_quantizers, codebook_size, dim), 0.02, g)) \
            if project_coarse_logits else None
        self.fine_logit_weights = nn.Parameter(
            init_normal((num_fine_quantizers, codebook_size, dim), 0.02, g))
        self.to(device)

    def _pos_bias_mlp(self, x):
        h = torch.nn.functional.silu(self.pos_bias_l1(x))
        h = torch.nn.functional.silu(self.pos_bias_l2(h))
        return self.pos_bias_l3(h)

    def build_attn_bias(self, coarse_len: int, fine_len: int):
        """(H, L, L) bias over [coarse start, coarse, fine start, fine], L =
        coarse_len + fine_len + 2: the MLP of each pair's (rel time step, rel
        quantizer), `null_pos_bias` on the start tokens' rows and columns; or
        None."""
        if self.pos_bias_l1 is None:
            return None
        mlp_inputs, pos, is_start, (seq_off, q_off) = _fine_bias_layout(
            self.num_coarse_quantizers, self.num_fine_quantizers, coarse_len, fine_len)
        dev = self.null_pos_bias.device
        # (R, H), or this rank's heads of it
        table = self._heads_cut(self._pos_bias_mlp(torch.from_numpy(mlp_inputs).to(dev)), 1)
        # the (L, L) pair index is formed on the device from the (L, 2) positions
        pos = torch.from_numpy(pos).to(dev)
        rel = pos[:, None, :] - pos[None, :, :]
        idx = (rel[..., 0] + seq_off) * (2 * q_off + 1) + rel[..., 1] + q_off
        bias = table[idx].permute(2, 0, 1)  # (H, L, L)
        start = torch.from_numpy(is_start).to(dev)
        return torch.where((start[:, None] | start[None, :])[None],
                           self._heads_cut(self.null_pos_bias, 0), bias)

    def _embed(self, kind, ids, num_q):
        qpos = torch.arange(ids.shape[-1], device=ids.device) % num_q
        return self._lookup(f"{kind}_embedding", ids + qpos * self.codebook_size) + \
            self._lookup(f"{kind}_quantize_embedding", qpos)

    def embed_coarse(self, coarse_token_ids):
        return self._embed("coarse", coarse_token_ids, self.num_coarse_quantizers)

    def embed_fine(self, fine_token_ids):
        return self._embed("fine", fine_token_ids, self.num_fine_quantizers)

    def embed_code(self, code, q: int):
        """(B,) fine codes of quantizer q -> (B, D), with its quantizer embedding."""
        return self._lookup("fine_embedding", code + q * self.codebook_size) + \
            self._lookup("fine_quantize_embedding", q)

    def coarse_key_mask(self, coarse_token_ids, n_fine: int):
        """(B, Nc + Nf + 2) key mask that drops the coarse pad and EOS codes,
        and the coarse ids with those codes set to 0."""
        ok = (coarse_token_ids != self.pad_id) & (coarse_token_ids != self.eos_id)
        mask = torch.nn.functional.pad(ok, (1, n_fine + 1), value=True)
        return mask, coarse_token_ids.masked_fill(~ok, 0)

    def forward(self, coarse_token_ids, fine_token_ids, *, self_attn_mask=None,
                return_only_fine_logits: bool = False, kv_cache=None, text=None,
                text_embeds=None, text_mask=None, cond_drop_prob=None, generator=None):
        """(coarse logits (B, Nc, cb) or None, fine logits (B, Nf + 1, cb)) for
        [start, coarse codes, start, fine codes]; the coarse pad and EOS codes
        are masked out of attention. With kv_cache, only the positions after
        its fill position run, against the bias of the cache's whole fine
        budget; the outputs before them are zeros. The condition as the
        Semantic LM's."""
        b = coarse_token_ids.shape[0]
        context, context_mask = self._condition(text, text_embeds, text_mask, cond_drop_prob,
                                                generator, b)
        coarse = coarse_token_ids.reshape(b, -1)
        fine = fine_token_ids.reshape(b, -1)
        n_coarse, n_fine = coarse.shape[-1], fine.shape[-1]
        cmask, coarse = self.coarse_key_mask(coarse, n_fine)
        self_attn_mask = cmask if self_attn_mask is None else self_attn_mask & cmask
        coarse_tokens = self.embed_coarse(coarse)
        fine_tokens = self.embed_fine(fine)
        tokens = torch.cat([_start(self.coarse_start_token, b, coarse_tokens.dtype),
                            coarse_tokens, _start(self.fine_start_token, b, fine_tokens.dtype),
                            fine_tokens], dim=1)
        pos = kv_cache.pos if kv_cache is not None else 0
        fine_budget = kv_cache.k.shape[2] - n_coarse - 2 if kv_cache is not None else n_fine
        out = self.transformer(tokens[:, pos:], self_attn_mask=self_attn_mask,
                               attn_bias=self.build_attn_bias(n_coarse, fine_budget),
                               kv_cache=kv_cache, context=context, context_mask=context_mask,
                               generator=generator)
        out = _pad_cached(out, pos)
        coarse_logits = None
        if not return_only_fine_logits and self.coarse_logit_weights is not None:
            coarse_logits = self.quantizer_logits("coarse_logit_weights", out[:, :n_coarse])
        fine_logits = self.quantizer_logits("fine_logit_weights", out[:, n_coarse + 1:])
        return coarse_logits, fine_logits

    def forward_with_cond_scale(self, coarse_token_ids, fine_token_ids, *,
                                cond_scale: float = 3.0, text_embeds=None, text_mask=None,
                                **kwargs):
        """Both logits with classifier-free guidance, one stacked forward."""
        return self._with_cond_scale(self.forward, (coarse_token_ids, fine_token_ids),
                                     cond_scale, text_embeds, text_mask, kwargs)


# checkpoint config keys that cannot change what the port computes: the
# attention dispatch (each choice computes the same function)
_INERT_KEYS = ("flash_attn",)


def _load(cls, path, device):
    """A `cls` built from the config in a JAX `.npz` checkpoint and loaded
    with its weights. Raises on any config key the port does not honour."""
    device = resolve_device(device)
    meta, arrays = read_npz(path)
    cfg = {k: v for k, v in meta["config"].items() if k not in _INERT_KEYS}
    unknown = sorted(set(cfg) - set(inspect.signature(cls).parameters) - {"seed", "device"})
    if unknown:
        raise NotImplementedError(f"{path}: config keys {unknown} are not honoured by the port")
    model = cls(**cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(arrays))
    return model.to(device)


def load_semantic_transformer(path, *, device: "str | torch.device" = "cuda"):
    """A SemanticTransformer from a JAX `.npz` checkpoint."""
    return _load(SemanticTransformer, path, device)


def load_coarse_transformer(path, *, device: "str | torch.device" = "cuda"):
    """A CoarseTransformer from a JAX `.npz` checkpoint."""
    return _load(CoarseTransformer, path, device)


def load_fine_transformer(path, *, device: "str | torch.device" = "cuda"):
    """A FineTransformer from a JAX `.npz` checkpoint."""
    return _load(FineTransformer, path, device)
