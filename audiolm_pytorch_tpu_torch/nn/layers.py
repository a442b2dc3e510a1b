"""Core layers, held against the JAX package's `nn/layers.py`: bias-free
Linear, gamma-only LayerNorm (eps 1e-5), RMSNorm, exact-erf GEGLU and the
GEGLU FeedForward.

Parameters are float32. Initialisation follows the JAX package's
distributions from an explicit `torch.Generator`; the numbers differ from
JAX's, so parity tests copy weights across instead.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Linear", "LayerNorm", "RMSNorm", "GEGLU", "FeedForward", "init_uniform", "init_normal"]


def init_uniform(shape, lim: float, generator: "torch.Generator | None") -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2 - 1) * lim


def init_normal(shape, std: float, generator: "torch.Generator | None") -> torch.Tensor:
    return torch.randn(shape, generator=generator) * std


class Linear(nn.Module):
    """y = x @ W.T (+ b); W is (out, in). Weights are cast to x's dtype."""

    def __init__(self, dim_in: int, dim_out: int, *, bias: bool = True,
                 generator: "torch.Generator | None" = None):
        super().__init__()
        self.weight = nn.Parameter(init_uniform((dim_out, dim_in), 1 / math.sqrt(dim_in), generator))
        self.bias = nn.Parameter(torch.zeros(dim_out)) if bias else None

    def forward(self, x):
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.Module):
    """gamma-only layernorm (beta fixed at zero), statistics in float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        out = F.layer_norm(x.float(), x.shape[-1:], self.gamma, None, 1e-5)
        return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        out = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-8) * self.gamma
        return out.to(x.dtype)


class GEGLU(nn.Module):
    def forward(self, x):
        x, gate = x.chunk(2, dim=-1)
        return F.gelu(gate, approximate="none") * x


class FeedForward(nn.Module):
    """LayerNorm -> Linear(dim, 2*inner) -> GEGLU -> LayerNorm -> Linear(inner, dim),
    inner = int(dim * 2 * mult / 3)."""

    def __init__(self, dim: int, mult: float = 4.0, *,
                 generator: "torch.Generator | None" = None):
        super().__init__()
        inner = int(dim * 2 * mult / 3)
        self.pre_norm = LayerNorm(dim)
        self.proj_in = Linear(dim, inner * 2, bias=False, generator=generator)
        self.act = GEGLU()
        self.norm = LayerNorm(inner)
        self.proj_out = Linear(inner, dim, bias=False, generator=generator)

    def forward(self, x):
        return self.proj_out(self.norm(self.act(self.proj_in(self.pre_norm(x)))))
