"""Causal 1-D convolutions of the codec, held against the JAX package's
`ops/conv.py`.

The public functions take JAX's channels-last layout, x (B, T, C), and
PyTorch's weight layouts: (out, in, K) for a convolution and (in, out, K)
for a transposed one; they transpose to (B, C, T) inside. The left padding
of a causal convolution, dilation * (K - 1) + 1 - stride samples, takes
`pad_mode` as the JAX package gives it to `jnp.pad`: "reflect" (the
default) as numpy's `pad(mode="reflect")` does, again and again when the
pad is as long as the input or longer, where `F.pad` refuses, so a decode
of fewer frames than the pad matches the JAX package; "constant" (zeros);
"edge" (the first sample repeated, `F.pad`'s "replicate"). Any other mode
raises where the convolution is built. The convolutions
are cuDNN's, as the JAX package leaves them to XLA. Weights are cast to
the input's dtype (`conv`): a bfloat16 input convolves in bfloat16, on the
card; on the CPU in float32, its output rounded to bfloat16 (XLA's CPU
does the same), because PyTorch's CPU bfloat16 convolution gives wrong
values for some strided shapes (kernel 8, stride 4: errors of the size of
the output).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import init_uniform

__all__ = ["conv", "causal_conv1d", "causal_conv_transpose1d", "CausalConv1d",
           "CausalConvTranspose1d", "reflect_pad_left", "pad_left", "check_pad_mode",
           "PAD_MODES"]

# the modes of the JAX package's `jnp.pad` that the port pads with
PAD_MODES = ("reflect", "constant", "edge")


def conv(fn, x, weight, bias=None, **kwargs):
    """fn (F.conv1d, F.conv_transpose1d, F.conv2d) of x, with weight and
    bias cast to x's dtype; a bfloat16 x on the CPU convolves in float32
    and the output is rounded to bfloat16."""
    weight = weight.to(x.dtype)
    bias = bias.to(x.dtype) if bias is not None else None
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return fn(x.float(), weight.float(), None if bias is None else bias.float(),
                  **kwargs).to(torch.bfloat16)
    return fn(x, weight, bias, **kwargs)


def reflect_pad_left(x, pad: int):
    """x (B, T, C) with `pad` samples in front, mirrored about the first
    sample again and again, as numpy's `pad(mode="reflect")` gives them."""
    n = x.shape[1]
    pos = torch.arange(-pad, n, device=x.device)
    if n == 1:
        idx = torch.zeros_like(pos)
    else:
        period = 2 * (n - 1)
        idx = pos.abs() % period
        idx = torch.where(idx > n - 1, period - idx, idx)
    return x.index_select(1, idx)


def check_pad_mode(pad_mode: str) -> str:
    if pad_mode not in PAD_MODES:
        raise NotImplementedError(f"pad_mode={pad_mode!r} is not ported: one of {PAD_MODES}")
    return pad_mode


def pad_left(x, pad: int, pad_mode: str = "reflect"):
    """x (B, T, C) with `pad` samples in front, as `jnp.pad(mode=pad_mode)`
    gives them."""
    if check_pad_mode(pad_mode) == "reflect":
        return reflect_pad_left(x, pad)
    if pad_mode == "constant":
        return torch.cat([x.new_zeros(x.shape[0], pad, *x.shape[2:]), x], dim=1)
    return torch.cat([x[:, :1].expand(-1, pad, *x.shape[2:]), x], dim=1)


def causal_conv1d(x, weight, bias=None, *, stride: int = 1, dilation: int = 1,
                  pad_mode: str = "reflect"):
    """x: (B, T, Cin); weight: (Cout, Cin, K). Returns (B, T', Cout)."""
    k = weight.shape[-1]
    pad = dilation * (k - 1) + (1 - stride)
    if pad > 0:
        x = pad_left(x, pad, pad_mode)
    elif pad < 0:
        x = x[:, -pad:]
    y = conv(F.conv1d, x.transpose(1, 2), weight, stride=stride, dilation=dilation)
    y = y.transpose(1, 2)
    return y + bias.to(y.dtype) if bias is not None else y


def causal_conv_transpose1d(x, weight, bias=None, *, stride: int):
    """x: (B, T, Cin); weight: (Cin, Cout, K). Returns (B, T * stride, Cout):
    the transposed convolution, cropped to T * stride (the JAX package's
    input-dilated convolution with the kernel flipped)."""
    n = x.shape[1]
    y = conv(F.conv_transpose1d, x.transpose(1, 2), weight, stride=stride)
    y = y[..., : n * stride].transpose(1, 2)
    return y + bias.to(y.dtype) if bias is not None else y


class CausalConv1d(nn.Module):
    def __init__(self, chan_in: int, chan_out: int, kernel_size: int, *, stride: int = 1,
                 dilation: int = 1, pad_mode: str = "reflect",
                 generator: "torch.Generator | None" = None):
        super().__init__()
        lim = 1.0 / math.sqrt(chan_in * kernel_size)
        self.weight = nn.Parameter(init_uniform((chan_out, chan_in, kernel_size), lim, generator))
        self.bias = nn.Parameter(torch.zeros(chan_out))
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.pad_mode = check_pad_mode(pad_mode)

    def forward(self, x):
        return causal_conv1d(x, self.weight, self.bias, stride=self.stride,
                             dilation=self.dilation, pad_mode=self.pad_mode)


class CausalConvTranspose1d(nn.Module):
    def __init__(self, chan_in: int, chan_out: int, kernel_size: int, *, stride: int,
                 generator: "torch.Generator | None" = None):
        super().__init__()
        lim = 1.0 / math.sqrt(chan_in * kernel_size)
        self.weight = nn.Parameter(init_uniform((chan_in, chan_out, kernel_size), lim, generator))
        self.bias = nn.Parameter(torch.zeros(chan_out))
        self.kernel_size, self.stride = kernel_size, stride

    def forward(self, x):
        return causal_conv_transpose1d(x, self.weight, self.bias, stride=self.stride)
