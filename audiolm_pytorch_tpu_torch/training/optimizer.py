"""Optimizer and learning-rate schedule of the LM trainers, held against the
JAX package's `training/optimizer.py` (an optax chain) step for step.

What the port keeps from optax:
- Adam with betas (0.9, 0.99), not torch's default (0.9, 0.999);
- weight decay only on parameters with ndim >= 2, decoupled (optax's
  `add_decayed_weights` after `scale_by_adam`, which is what `AdamW` does);
- the schedule is read at the count before its increment, so with warmup
  the first update has learning rate 0;
- the global-norm clip scales by max_norm / norm only when norm >= max_norm,
  with no epsilon (`clip_grad_norm_` adds 1e-6).
"""
from __future__ import annotations

import math

import torch

from ..parallel.tp import sum_over

__all__ = ["separate_weight_decayable_params", "get_optimizer", "lr_schedule",
           "clip_by_global_norm_"]


def separate_weight_decayable_params(params):
    """(decayed, not decayed): parameters with ndim >= 2, and the rest."""
    params = list(params)
    return [p for p in params if p.ndim >= 2], [p for p in params if p.ndim < 2]


def lr_schedule(lr: float, *, warmup_steps: int = 0, total_steps: "int | None" = None,
                cosine_decay: bool = False):
    """count -> learning rate, as optax: a constant without warmup; a linear
    warmup from 0 (`linear_schedule`), followed with cosine_decay and
    total_steps by a cosine decay to 0 (`warmup_cosine_decay_schedule`)."""
    if warmup_steps <= 0:
        return lambda count: lr

    def warmup(count):
        return lr * min(max(count, 0), warmup_steps) / warmup_steps

    if not (cosine_decay and total_steps):
        return warmup
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError("total_steps must exceed warmup_steps for the cosine decay")

    def schedule(count):
        if count < warmup_steps:
            return warmup(count)
        t = min(count - warmup_steps, decay_steps)
        return lr * 0.5 * (1 + math.cos(math.pi * t / decay_steps))

    return schedule


def get_optimizer(params, lr: float = 1e-4, wd: float = 0.0, betas=(0.9, 0.99),
                  eps: float = 1e-8, *, warmup_steps: int = 0,
                  total_steps: "int | None" = None, cosine_decay: bool = False):
    """(optimizer, scheduler): `torch.optim.AdamW` over two groups (weight
    decay wd on the ndim >= 2 parameters, none on the rest) and a `LambdaLR`
    that sets each step's learning rate from `lr_schedule`. Call
    `optimizer.step()` and then `scheduler.step()` once per update."""
    decay, no_decay = separate_weight_decayable_params(params)
    groups = [dict(params=decay, weight_decay=wd), dict(params=no_decay, weight_decay=0.0)]
    opt = torch.optim.AdamW(groups, lr=lr, betas=tuple(betas), eps=eps)
    schedule = lr_schedule(lr, warmup_steps=warmup_steps, total_steps=total_steps,
                           cosine_decay=cosine_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(opt, lambda count: schedule(count) / lr)
    return opt, scheduler


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float, *, sharded=None, tp=None):
    """Scale the tensors `grads` in place by max_norm / norm when their global
    norm is >= max_norm (optax `clip_by_global_norm`). Returns the norm.
    Under tensor parallelism (`tp`, the model group, and `sharded`, a flag a
    tensor: the rank's part of a cut parameter's gradient) the norm is the
    whole model's: the squares of the cut gradients summed over the group,
    each replicated one counted once."""
    grads = list(grads)
    squares = [g.float().square().sum() for g in grads]
    if tp is None:
        norm = torch.stack(squares).sum().sqrt()
    else:
        zero = grads[0].new_zeros((), dtype=torch.float32)
        cut = sum((sq for sq, s in zip(squares, sharded) if s), zero)
        whole = sum((sq for sq, s in zip(squares, sharded) if not s), zero)
        norm = (sum_over(cut, tp) + whole).sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm
