"""The LM train step, held against the JAX package's
`training/trainer.py::_TransformerTrainerBase` (`_build_step` and the update
part of `train_step`), with the JAX trainer's defaults.

One step takes grad_accum_every micro-batches: each gives its loss through
the wrapper's train path (EOS appended, unique-consecutive, the forgetful
causal mask), its gradient is scaled by 1 / grad_accum_every and summed;
then the global-norm clip and one optimizer update. Every parameter gets a
gradient, zero where the loss does not reach it (the text projection of an
unconditioned model), as `jax.value_and_grad` gives one, so weight decay
touches the same parameters as in JAX. The dataset, wav2vec tokenisation,
validation and checkpoints are not ported yet.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .optimizer import clip_by_global_norm_, get_optimizer

__all__ = ["TransformerTrainStep"]


class TransformerTrainStep:
    """Trains the transformer of `wrapper` (a Semantic, Coarse or Fine
    wrapper) on `device`; a codec the wrapper holds stays as it is. The
    forgetful masks are drawn from a generator seeded with `seed`."""

    def __init__(self, wrapper, *, lr: float = 3e-4, wd: float = 0.0,
                 max_grad_norm: "float | None" = 0.5, grad_accum_every: int = 1,
                 warmup_steps: int = 0, cosine_decay: bool = False,
                 num_train_steps: "int | None" = None, seed: int = 42,
                 device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        self.wrapper = wrapper.to(self.device)
        self.params = [p for p in wrapper.transformer.parameters() if p.requires_grad]
        self.optimizer, self.scheduler = get_optimizer(
            self.params, lr, wd, warmup_steps=warmup_steps, total_steps=num_train_steps,
            cosine_decay=cosine_decay)
        self.max_grad_norm = max_grad_norm
        self.grad_accum_every = grad_accum_every
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def step(self, *token_ids) -> float:
        """One update from the wrapper's batch: one or more id tensors, each
        (grad_accum_every * B, ...) (the Semantic wrapper's ids; the Coarse
        wrapper's semantic ids and coarse codes; the Fine wrapper's coarse
        and fine codes). Each is split into grad_accum_every micro-batches
        along its first axis. Returns the mean loss of the micro-batches."""
        accum = self.grad_accum_every
        batches = [ids.to(self.device) for ids in token_ids]
        for ids in batches:
            if ids.shape[0] % accum:
                raise ValueError(f"batch {ids.shape[0]} is not a multiple of "
                                 f"grad_accum_every {accum}")
        for p in self.params:
            p.grad = torch.zeros_like(p)
        losses = []
        for micro in zip(*(ids.reshape(accum, -1, *ids.shape[1:]) for ids in batches)):
            loss = self.wrapper(*micro, return_loss=True, train=True, generator=self.generator)
            (loss / accum).backward()
            losses.append(loss.detach())
        if self.max_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in self.params], self.max_grad_norm)
        self.optimizer.step()
        self.scheduler.step()
        return torch.stack(losses).mean().item()
