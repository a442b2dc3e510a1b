"""Exponential moving average of a whole model, held against the JAX
package's `training/ema.py` (`ema_init`, `ema_update`): the shadow copies
the model for the first `update_after_step` updates, then moves towards it
by 1 - beta every `update_every`-th update; integer and bool state (the
quantizers' `initted`) tracks the model at every update."""
from __future__ import annotations

import copy

import torch

__all__ = ["EMA"]


class EMA:
    """The shadow of `model` (a deep copy, without gradients) and the count
    of updates, `step`."""

    def __init__(self, model, *, beta: float = 0.995, update_after_step: int = 500,
                 update_every: int = 10):
        self.shadow = copy.deepcopy(model).requires_grad_(False)
        self.step = 0
        self.beta = beta
        self.update_after_step = update_after_step
        self.update_every = update_every

    @torch.no_grad()
    def update(self, model):
        """One update from `model`'s parameters and buffers."""
        self.step += 1
        warm = self.step <= self.update_after_step
        should = not warm and self.step % self.update_every == 0
        beta = self.beta
        for s, m in zip(self.shadow.state_dict().values(), model.state_dict().values()):
            if warm or not s.is_floating_point():
                s.copy_(m)
            elif should:
                s.copy_(beta * s + (1.0 - beta) * m)
