"""Polyphase windowed-sinc resampling, held against the JAX package's
`ops/resample.py` (torchaudio.functional.resample's kernel): the filter bank
is built once on the host in float64 and applied as one strided float32
convolution, (B, 1, L) -> (B, new, frames), whose phases interleave into
the output."""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resample"]


@lru_cache(maxsize=None)
def _sinc_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int, rolloff: float):
    """(new_freq, 1, K) float32 filter bank and its half width."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t *= np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel *= window * base_freq / orig_freq
    return torch.from_numpy(np.ascontiguousarray(kernel[:, None, :], np.float32)), width


def resample(x, orig_freq: int, new_freq: int, *, lowpass_filter_width: int = 6,
             rolloff: float = 0.99):
    """x (..., L) at orig_freq -> (..., ceil(L * new_freq / orig_freq)) at
    new_freq, in x's dtype (computed in float32)."""
    if orig_freq == new_freq:
        return x
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // g, int(new_freq) // g
    kernel, width = _sinc_kernel(orig, new, lowpass_filter_width, rolloff)
    shape, length = x.shape, x.shape[-1]
    xf = F.pad(x.reshape(-1, 1, length).float(), (width, width + orig))
    y = F.conv1d(xf, kernel.to(xf.device), stride=orig)  # (B, new, frames)
    y = y.transpose(1, 2).reshape(xf.shape[0], -1)
    target_len = int(math.ceil(new_freq * length / orig_freq))
    return y[:, :target_len].reshape(*shape[:-1], target_len).to(x.dtype)
