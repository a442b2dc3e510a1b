"""The Semantic LM, held against the JAX package's `models/lm.py::
SemanticTransformer` (without text conditioning)."""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..nn.layers import Linear, init_normal
from ..ops.sampling import get_embeds
from ..weights import read_npz, state_dict_from_jax
from .transformer import Transformer

__all__ = ["SemanticTransformer", "load_semantic_transformer"]

# encoder widths of the T5 models the JAX package knows; an unconditioned
# model still holds the text projection, so its checkpoints load whole
_T5_DIMS = {"google/t5-v1_1-small": 512, "google/t5-v1_1-base": 768,
            "google/t5-v1_1-large": 1024}


class SemanticTransformer(nn.Module):
    """LM over semantic token ids plus EOS (= num_semantic_tokens). Weights
    are drawn from `seed` on the CPU and then moved to `device`."""

    def __init__(self, *, dim: int, depth: int, num_semantic_tokens: int,
                 heads: int = 8, dim_head: int = 64, num_residual_streams: int = 4,
                 rel_pos_bias: bool = True, grad_shrink_alpha: float = 0.1,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 t5_name: str = "google/t5-v1_1-base", cond_dim: "int | None" = None,
                 seed: int = 0, device: "str | torch.device" = "cuda"):
        super().__init__()
        if attn_dropout > 0 or ff_dropout > 0:
            raise NotImplementedError("attn_dropout / ff_dropout > 0 is not ported")
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.num_semantic_tokens = num_semantic_tokens
        self.eos_id = num_semantic_tokens
        self.start_token = nn.Parameter(init_normal((dim,), 1.0, g))
        self.semantic_embedding = nn.Parameter(init_normal((num_semantic_tokens + 1, dim), 0.02, g))
        text_dim = cond_dim if cond_dim is not None else _T5_DIMS[t5_name]
        self.proj_text_embed = Linear(text_dim, dim, bias=False, generator=g) \
            if text_dim != dim else None
        self.transformer = Transformer(
            dim=dim, depth=depth, heads=heads, dim_head=dim_head,
            num_residual_streams=num_residual_streams, rel_pos_bias=rel_pos_bias,
            grad_shrink_alpha=grad_shrink_alpha, generator=g, device="cpu")
        self.to_logits = Linear(dim, num_semantic_tokens + 1, generator=g)
        self.to(device)

    def embed_ids(self, ids):
        """[start] + ids (B, N), pad -1 embedding to 0 -> (B, N+1, D)."""
        tokens = get_embeds(self.semantic_embedding, ids)
        start = self.start_token.to(tokens.dtype).expand(ids.shape[0], 1, -1)
        return torch.cat([start, tokens], dim=1)

    def forward(self, ids, *, self_attn_mask=None, return_loss: bool = False):
        """Logits (B, N+1, V) for [start] + ids, or (B, N, V) for [start] +
        ids[:, :-1] with return_loss (the loss itself is the wrapper's).
        self_attn_mask: (B, N) bool key mask over the ids, True = attend; the
        start token is always attended."""
        if return_loss:
            ids = ids[:, :-1]
        if self_attn_mask is not None:
            self_attn_mask = torch.nn.functional.pad(self_attn_mask, (1, 0), value=True)
        return self.to_logits(self.transformer(self.embed_ids(ids),
                                               self_attn_mask=self_attn_mask))


_UNPORTED = {"has_condition": False, "audio_text_condition": False,
             "cond_as_self_attn_prefix": False}
_CONFIG_KEYS = ("dim", "depth", "num_semantic_tokens", "heads", "dim_head",
                "num_residual_streams", "rel_pos_bias", "grad_shrink_alpha",
                "t5_name", "cond_dim")


def load_semantic_transformer(path, *, device: "str | torch.device" = "cuda"):
    """A SemanticTransformer built from the config in a JAX `.npz` checkpoint
    and loaded with its weights."""
    device = resolve_device(device)
    meta, arrays = read_npz(path)
    cfg = meta["config"]
    for key, value in _UNPORTED.items():
        if cfg.get(key, value) != value:
            raise NotImplementedError(f"{path}: {key}={cfg[key]} is not ported")
    model = SemanticTransformer(**{k: cfg[k] for k in _CONFIG_KEYS if k in cfg},
                                device="cpu")
    model.load_state_dict(state_dict_from_jax(arrays))
    return model.to(device)
