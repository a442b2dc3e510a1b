"""Sampling and token-stream helpers the Semantic LM needs, held against the
JAX package's `ops/sampling.py`. Randomness comes from an explicit
`torch.Generator`."""
from __future__ import annotations

import torch

__all__ = ["gumbel_noise", "gumbel_sample", "top_k", "mask_out_after_eos_id",
           "append_eos_id", "batch_unique_consecutive", "generate_mask_with_prob",
           "grad_shrink", "get_embeds"]


def gumbel_noise(shape, *, generator: "torch.Generator | None" = None,
                 device=None) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=1e-20)
    return -torch.log(-torch.log(u))


def gumbel_sample(logits, temperature: float = 1.0, *,
                  generator: "torch.Generator | None" = None):
    """Temperature-scaled gumbel-max sampling over the last axis."""
    noise = gumbel_noise(logits.shape, generator=generator, device=logits.device)
    return (logits / max(temperature, 1e-10) + noise).argmax(-1)


def top_k(logits, thres: float = 0.5):
    """Keep the top (1 - thres) fraction of logits; the rest become -inf."""
    k = max(int((1 - thres) * logits.shape[-1]), 1)
    kth = logits.topk(k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def mask_out_after_eos_id(t, eos_id: int, mask_value: int = -1, keep_eos: bool = True):
    """Replace every token after the first EOS (and the EOS too unless keep_eos)."""
    eos = (t == eos_id).int()
    if keep_eos:
        eos = torch.nn.functional.pad(eos, (1, 0))[..., :-1]
    return t.masked_fill(eos.cumsum(-1) > 0, mask_value)


def append_eos_id(ids, eos_id: int):
    return torch.cat([ids, ids.new_full((ids.shape[0], 1), eos_id)], dim=-1)


def batch_unique_consecutive(t, pad_value: int = -1):
    """Drop consecutive repeats per row, left-pack, pad to the original width.
    Positions already equal to pad_value count as padding and are dropped."""
    b, n = t.shape
    keep = torch.ones_like(t, dtype=torch.bool)
    keep[:, 1:] = t[:, 1:] != t[:, :-1]
    keep &= t != pad_value
    dest = torch.where(keep, keep.long().cumsum(1) - 1, n)  # dropped -> overflow slot
    out = t.new_full((b, n + 1), pad_value)
    out.scatter_(1, dest, torch.where(keep, t, pad_value))
    return out[:, :n]


def generate_mask_with_prob(shape, mask_prob: float, *,
                            generator: "torch.Generator | None" = None, device=None):
    """Forgetful causal mask (True = keep) on `device`: in each row exactly
    min(int(n * mask_prob), n - 1) positions are dropped, never position 0.
    The draws come from `generator`, on the generator's device, so one
    generator gives the same mask on every device; they are not the bits JAX
    draws."""
    n = shape[-1]
    num_mask = min(int(n * mask_prob), n - 1)
    if num_mask <= 0:
        return torch.ones(shape, dtype=torch.bool, device=device)
    rand = torch.randn(shape, generator=generator,
                       device=generator.device if generator is not None else device)
    rand[..., 0] = float("-inf")
    kth = rand.topk(num_mask, dim=-1).values[..., -1:]
    return (rand < kth).to(device)


def grad_shrink(t, alpha: float = 0.1):
    """Same value; gradient scaled by alpha."""
    return t * alpha + t.detach() * (1 - alpha)


def get_embeds(table, codes, pad_id: int = -1, mask_pad_pos_to: float = 0.0):
    """Rows of `table` (V, D) for `codes`; `pad_id` positions embed to
    `mask_pad_pos_to`."""
    pad = codes == pad_id
    embeds = table[codes.masked_fill(pad, 0)]
    return embeds.masked_fill(pad[..., None], mask_pad_pos_to)
