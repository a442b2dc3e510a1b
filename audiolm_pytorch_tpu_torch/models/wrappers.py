"""Scoring, the training loss and KV-cached generation for the Semantic LM,
held against the JAX package's `models/wrappers.py` (`masked_cross_entropy`,
`_sample_from_logits`, `_semantic_generate_jit`, `SemanticTransformerWrapper`)."""
from __future__ import annotations

import torch
from torch import nn

from ..ops.sampling import (append_eos_id, batch_unique_consecutive,
                            generate_mask_with_prob, get_embeds, gumbel_sample,
                            mask_out_after_eos_id, top_k)
from .lm import SemanticTransformer
from .transformer import KVCache

__all__ = ["SemanticTransformerWrapper", "masked_cross_entropy", "sample_from_logits"]


def masked_cross_entropy(logits, labels, ignore_index: int = -1):
    """Mean cross entropy over positions whose label is not ignore_index."""
    mask = labels != ignore_index
    ll = logits.float().log_softmax(-1)
    nll = -ll.gather(-1, labels.masked_fill(~mask, 0)[..., None].long())[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def sample_from_logits(logits, filter_thres: float, temperature: float, *,
                       generator: "torch.Generator | None" = None):
    return gumbel_sample(top_k(logits, thres=filter_thres), temperature,
                         generator=generator)


class SemanticTransformerWrapper(nn.Module):
    """Scores semantic token sequences, gives the training loss and samples
    continuations."""

    def __init__(self, *, transformer: SemanticTransformer, pad_id: int = -1,
                 unique_consecutive: bool = True, mask_prob: float = 0.15):
        super().__init__()
        self.transformer = transformer
        self.pad_id = pad_id
        self.eos_id = transformer.eos_id
        self.unique_consecutive = unique_consecutive
        self.mask_prob = mask_prob

    def forward(self, semantic_token_ids, *, return_loss: bool = False, train: bool = False,
                generator: "torch.Generator | None" = None):
        """Logits (B, N, V) of the ids, or with return_loss the mean next-token
        cross entropy. With train, EOS is appended first and the forgetful
        causal mask (mask_prob of the keys dropped per row, drawn from
        `generator`) is applied. Consecutive repeats are dropped after EOS is
        appended."""
        ids = semantic_token_ids.reshape(semantic_token_ids.shape[0], -1)
        if train:
            ids = append_eos_id(ids, self.eos_id)
        if self.unique_consecutive:
            ids = batch_unique_consecutive(ids, pad_value=self.pad_id)
        input_ids = ids[:, :-1] if return_loss else ids
        mask = None
        if train and self.mask_prob > 0:
            mask = generate_mask_with_prob(input_ids.shape, self.mask_prob,
                                           generator=generator, device=input_ids.device)
        logits = self.transformer(input_ids, self_attn_mask=mask)
        if not return_loss:
            return logits
        return masked_cross_entropy(logits, ids, self.pad_id)

    @torch.no_grad()
    def generate(self, *, max_length: int, prime_ids=None, batch_size: int = 1,
                 filter_thres: float = 0.9, temperature: float = 1.0,
                 generator: "torch.Generator | None" = None, return_logits: bool = False):
        """Sample up to max_length ids after the prompt `prime_ids` (B, P),
        stopping once every row holds EOS; the EOS and what follows become
        pad. One prefill of [start] + prompt, then one cached step per token.
        With return_logits, also the (B, max_length + 1, V) logits each
        position was sampled from (zeros past the last step)."""
        tr = self.transformer
        device = tr.start_token.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        ids = prime_ids.to(device) if prime_ids is not None else \
            torch.zeros((batch_size, 0), dtype=torch.long, device=device)
        if self.unique_consecutive and ids.shape[-1] > 0:
            ids = batch_unique_consecutive(ids, pad_value=self.pad_id)
        b, p = ids.shape
        vocab = tr.num_semantic_tokens + 1
        t = tr.transformer
        cache = KVCache.create(t.depth, b, max_length + 1, t.dim_head,
                               dtype=tr.start_token.dtype, device=device)

        logits = tr.to_logits(t(tr.embed_ids(ids), kv_cache=cache))  # (B, P+1, V)
        ids_buf = torch.full((b, max_length), self.pad_id, dtype=torch.long, device=device)
        ids_buf[:, :p] = ids
        logits_buf = torch.zeros((b, max_length + 1, vocab), dtype=logits.dtype, device=device)
        logits_buf[:, : p + 1] = logits
        last_idx = (ids != self.pad_id).sum(-1)
        rows = torch.arange(b, device=device)
        for pos in range(p, max_length):
            if bool((ids_buf == self.eos_id).any(-1).all()):
                break
            sampled = sample_from_logits(logits_buf[rows, last_idx], filter_thres,
                                         temperature, generator=generator)
            ids_buf[:, pos] = sampled
            out = t(get_embeds(tr.semantic_embedding, sampled[:, None]), kv_cache=cache)
            logits_buf[:, pos + 1] = tr.to_logits(out)[:, 0]
            last_idx += 1
        ids_out = mask_out_after_eos_id(ids_buf, self.eos_id, mask_value=self.pad_id,
                                        keep_eos=False)
        return (ids_out, logits_buf) if return_logits else ids_out
