"""T5-v1.1 text encoder for classifier-free-guidance text conditioning,
held against the JAX package's `models/t5.py`.

No pretrained T5 weights or sentencepiece files are in the repository, so
the encoder runs at a published T5-v1.1 width from seeded random weights
(`load_torch_state_dict` takes the HF `T5EncoderModel` key layout when
weights are at hand), and text is tokenised by the JAX package's
deterministic word-hash fallback, with its warning: the conditioning path
keeps its shapes and contract, but its text is not read for meaning.

T5's attention is a plain product here, as in the JAX package (outside
any Pallas kernel): unscaled logits plus the bucketed relative-position
bias, masked keys at -1e9, a float32 softmax; the feed-forward is a gated
tanh-GELU.

Contract, as the JAX package's: `t5_encode_text(texts, name)` -> (B, L,
dim) float32 with the padding positions zeroed; downstream recovers the
mask as `any(embed != 0)`. `get_encoded_dim(name)` is the encoder width.
"""
from __future__ import annotations

import functools
import hashlib
import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..nn.layers import Linear, init_normal

__all__ = ["T5Encoder", "t5_encode_text", "tokenize_text", "get_encoded_dim",
           "DEFAULT_T5_NAME", "T5_CONFIGS", "MAX_LENGTH"]

DEFAULT_T5_NAME = "google/t5-v1_1-base"
MAX_LENGTH = 256

# the published T5-v1.1 encoder widths
T5_CONFIGS = {
    "google/t5-v1_1-small": dict(dim=512, heads=6, dim_head=64, ff=1024, layers=8, vocab=32128),
    "google/t5-v1_1-base": dict(dim=768, heads=12, dim_head=64, ff=2048, layers=12, vocab=32128),
    "google/t5-v1_1-large": dict(dim=1024, heads=16, dim_head=64, ff=2816, layers=24,
                                 vocab=32128),
}


def get_encoded_dim(name: str) -> int:
    if name in T5_CONFIGS:
        return T5_CONFIGS[name]["dim"]
    raise ValueError(f"unknown t5 model {name}")


class _T5RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
        return (xf * self.weight.float()).to(x.dtype)


@functools.lru_cache(maxsize=16)
def _t5_rel_bucket(n: int, num_buckets: int = 32, max_distance: int = 128):
    """T5's bidirectional relative-position buckets of memory_pos - query_pos
    over n positions, (n, n) int64."""
    rel_pos = np.arange(n)[None, :] - np.arange(n)[:, None]
    num_buckets //= 2
    ret = (rel_pos > 0).astype(np.int32) * num_buckets
    dist = np.abs(rel_pos)
    max_exact = num_buckets // 2
    val_large = max_exact + (
        np.log(np.maximum(dist, 1) / max_exact) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).astype(np.int32)
    val_large = np.minimum(val_large, num_buckets - 1)
    return torch.from_numpy((ret + np.where(dist < max_exact, dist, val_large)).astype(np.int64))


class _T5Block(nn.Module):
    def __init__(self, dim, heads, dim_head, ff, *, generator):
        super().__init__()
        inner = heads * dim_head
        self.ln1 = _T5RMSNorm(dim)
        self.q = Linear(dim, inner, bias=False, generator=generator)
        self.k = Linear(dim, inner, bias=False, generator=generator)
        self.v = Linear(dim, inner, bias=False, generator=generator)
        self.o = Linear(inner, dim, bias=False, generator=generator)
        self.ln2 = _T5RMSNorm(dim)
        self.wi0 = Linear(dim, ff, bias=False, generator=generator)
        self.wi1 = Linear(dim, ff, bias=False, generator=generator)
        self.wo = Linear(ff, dim, bias=False, generator=generator)
        self.heads, self.dim_head = heads, dim_head

    def forward(self, x, bias, mask):
        b, n, _ = x.shape
        h = self.ln1(x)
        q, k, v = (proj(h).view(b, n, self.heads, self.dim_head).transpose(1, 2).float()
                   for proj in (self.q, self.k, self.v))
        sim = torch.matmul(q, k.transpose(-1, -2)) + bias  # T5 applies no 1/sqrt(d) scaling
        sim = sim.masked_fill(~mask[:, None, None, :], -1e9)
        out = torch.matmul(sim.softmax(-1), v).to(x.dtype)
        x = x + self.o(out.transpose(1, 2).reshape(b, n, -1))
        h = self.ln2(x)
        return x + self.wo(F.gelu(self.wi0(h), approximate="tanh") * self.wi1(h))


class T5Encoder(nn.Module):
    """A T5-v1.1 encoder at `name`'s published width. Weights are drawn on
    the CPU from `seed` (by default one derived from the name, as the JAX
    package derives its key) and moved to `device`."""

    def __init__(self, name: str = DEFAULT_T5_NAME, *, seed: "int | None" = None,
                 device: "str | torch.device" = "cuda"):
        super().__init__()
        cfg = T5_CONFIGS[name]
        device = resolve_device(device)
        if seed is None:
            seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")
        g = torch.Generator().manual_seed(seed)
        self.token_embed = nn.Parameter(init_normal((cfg["vocab"], cfg["dim"]), 0.02, g))
        self.rel_bias = nn.Parameter(init_normal((32, cfg["heads"]), 0.02, g))
        self.blocks = nn.ModuleList(
            _T5Block(cfg["dim"], cfg["heads"], cfg["dim_head"], cfg["ff"], generator=g)
            for _ in range(cfg["layers"]))
        self.final_norm = _T5RMSNorm(cfg["dim"])
        self.name, self.dim, self.heads = name, cfg["dim"], cfg["heads"]
        self.to(device)

    @torch.no_grad()
    def load_torch_state_dict(self, sd):
        """Take the weights of an HF `T5EncoderModel` state dict (tensors or
        numpy arrays), the layout the JAX package's `load_torch_state_dict`
        reads."""
        def put(param, key):
            param.copy_(torch.as_tensor(np.asarray(sd[key])))

        put(self.token_embed, "shared.weight")
        put(self.rel_bias, "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight")
        for i, blk in enumerate(self.blocks):
            p = f"encoder.block.{i}.layer"
            for name in ("q", "k", "v", "o"):
                put(getattr(blk, name).weight, f"{p}.0.SelfAttention.{name}.weight")
            put(blk.ln1.weight, f"{p}.0.layer_norm.weight")
            put(blk.wi0.weight, f"{p}.1.DenseReluDense.wi_0.weight")
            put(blk.wi1.weight, f"{p}.1.DenseReluDense.wi_1.weight")
            put(blk.wo.weight, f"{p}.1.DenseReluDense.wo.weight")
            put(blk.ln2.weight, f"{p}.1.layer_norm.weight")
        put(self.final_norm.weight, "encoder.final_layer_norm.weight")

    def forward(self, ids, mask):
        """ids (B, L) int, mask (B, L) bool -> (B, L, dim), padding zeroed."""
        n = ids.shape[1]
        x = self.token_embed[ids]
        buckets = _t5_rel_bucket(n).to(ids.device)
        bias = self.rel_bias.float()[buckets].permute(2, 0, 1)[None]  # (1, H, n, n)
        for blk in self.blocks:
            x = blk(x, bias, mask)
        return self.final_norm(x).masked_fill(~mask[..., None], 0.0)


_warned_fallback = False


def _fallback_tokenize(texts, max_length: int):
    """The JAX package's deterministic word-hash tokenizer: each lower-cased
    word to 1000 + (the first 4 bytes of its sha256, little-endian) % 31000,
    then EOS = 1; padded with 0 to the longest row."""
    global _warned_fallback
    if not _warned_fallback:
        _warned_fallback = True
        warnings.warn(
            "T5 tokenizer assets are not in the repository: falling back to a "
            "deterministic hash tokenizer. Text conditioning is NOT semantically "
            "meaningful in this mode; real sentencepiece tokenization needs the "
            "tokenizer's files.", RuntimeWarning, stacklevel=3)
    batch_ids, batch_mask = [], []
    for text in texts:
        words = text.lower().split()[: max_length - 1]
        ids = [1000 + int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little") % 31000
               for w in words]
        ids.append(1)  # </s>
        pad = max_length - len(ids)
        batch_ids.append(ids + [0] * pad)
        batch_mask.append([True] * len(ids) + [False] * pad)
    ids = np.asarray(batch_ids, np.int64)
    mask = np.asarray(batch_mask, bool)
    longest = int(mask.sum(-1).max())
    return ids[:, :longest], mask[:, :longest]


def tokenize_text(texts, name: str = DEFAULT_T5_NAME, max_length: int = MAX_LENGTH):
    """(ids (B, L) int64, mask (B, L) bool) numpy arrays of `texts`, by the
    hash fallback (no tokenizer files are in the repository)."""
    if name not in T5_CONFIGS:
        raise ValueError(f"unknown t5 model {name}")
    return _fallback_tokenize(texts, max_length)


_ENCODERS: "dict[tuple[str, str], T5Encoder]" = {}


def get_t5_encoder(name: str = DEFAULT_T5_NAME, device: "str | torch.device" = "cuda"):
    """The encoder of `name` on `device`, built once per (name, device)."""
    device = resolve_device(device)
    key = (name, str(device))
    if key not in _ENCODERS:
        _ENCODERS[key] = T5Encoder(name, device=device).eval()
    return _ENCODERS[key]


@torch.no_grad()
def t5_encode_text(texts, name: str = DEFAULT_T5_NAME, max_length: int = MAX_LENGTH, *,
                   device: "str | torch.device" = "cuda"):
    """list[str] -> (B, L, dim) float32 on `device`, padding positions zeroed."""
    enc = get_t5_encoder(name, device)
    ids, mask = tokenize_text(texts, name, max_length)
    dev = enc.token_embed.device
    return enc(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)).float()
