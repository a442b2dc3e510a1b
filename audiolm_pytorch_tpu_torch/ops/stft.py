"""STFT and mel spectrogram of the codec's losses and its STFT
discriminator, held against the JAX package's `ops/stft.py`: torch.stft's
layout and a periodic Hann window, frames from a reflect-padded signal, the
spectrum by a DFT matrix product (the JAX package's default, so that the
two agree term by term, and twice differentiable for the discriminator's
gradient penalty), and an HTK mel filterbank without norm (torchaudio's
defaults). The real and imaginary parts are kept apart: `stft` returns
(real, imag), each (..., n_fft // 2 + 1, frames). The window, the DFT
matrices and the filterbank are made once per size and device and kept
(a copy from the host each call would stall the card).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["hann_window", "frame_signal", "stft", "spectrogram", "mel_filterbank",
           "melspectrogram"]


def hann_window(win_length: int) -> np.ndarray:
    """torch.hann_window (periodic) as float32 numpy."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2 * np.pi * n / win_length)).astype(np.float32)


def _reflect_index(length: int, pad: int, device) -> torch.Tensor:
    """Indices of x padded by `pad` on both sides, mirrored about the ends
    again and again, as numpy's `pad(mode="reflect")` does."""
    pos = torch.arange(-pad, length + pad, device=device)
    if length == 1:
        return torch.zeros_like(pos)
    period = 2 * (length - 1)
    idx = pos.abs() % period
    return torch.where(idx > length - 1, period - idx, idx)


def frame_signal(x, n_fft: int, hop_length: int, center: bool = True):
    """x (..., L) -> frames (..., n_frames, n_fft), centred by a reflect pad."""
    if center:
        x = x.index_select(-1, _reflect_index(x.shape[-1], n_fft // 2, x.device))
    n_frames = 1 + (x.shape[-1] - n_fft) // hop_length
    return x.unfold(-1, n_fft, hop_length)[..., :n_frames, :]


@functools.lru_cache(maxsize=None)
def _dft_matrices(n_fft: int, win_length: int, device) -> "tuple[torch.Tensor, ...]":
    """(window centred in n_fft, cos, sin) float32 on `device`; read only."""
    window = hann_window(win_length)
    if win_length < n_fft:  # centred in n_fft, as torch.stft pads it
        lp = (n_fft - win_length) // 2
        window = np.pad(window, (lp, n_fft - win_length - lp))
    k = np.arange(n_fft // 2 + 1)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = -2 * np.pi * k * n / n_fft
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in (window, np.cos(ang), np.sin(ang)))


def stft(x, n_fft: int, hop_length: "int | None" = None, win_length: "int | None" = None,
         center: bool = True, normalized: bool = False):
    """(real, imag) of the STFT of x (..., L) in float32, each (..., n_fft //
    2 + 1, frames)."""
    hop_length = hop_length or n_fft // 4
    window, cos_m, sin_m = _dft_matrices(n_fft, win_length or n_fft, x.device)
    frames = frame_signal(x.float(), n_fft, hop_length, center) * window
    re, im = frames @ cos_m, frames @ sin_m
    if normalized:
        re, im = re / math.sqrt(n_fft), im / math.sqrt(n_fft)
    return re.transpose(-1, -2), im.transpose(-1, -2)


def spectrogram(x, n_fft: int, hop_length: "int | None" = None,
                win_length: "int | None" = None, power: float = 2.0, normalized: bool = False,
                center: bool = True):
    """|STFT|^power; normalized divides by the window's norm, as torchaudio."""
    re, im = stft(x, n_fft, hop_length, win_length, center=center)
    if normalized:
        norm = float(np.sqrt((hann_window(win_length or n_fft) ** 2).sum()))
        re, im = re / norm, im / norm
    mag2 = re * re + im * im
    return mag2 if power == 2.0 else mag2 ** (power / 2)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                   f_max: "float | None" = None) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) float32 triangular HTK filterbank."""
    f_max = f_max or sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.ascontiguousarray(np.maximum(0.0, np.minimum(down, up)).T, np.float32)


def melspectrogram(x, sample_rate: int, n_fft: int, hop_length: "int | None" = None,
                   win_length: "int | None" = None, n_mels: int = 128, power: float = 2.0,
                   normalized: bool = False):
    """(..., n_mels, frames): torchaudio.transforms.MelSpectrogram's."""
    spec = spectrogram(x, n_fft, hop_length, win_length, power=power, normalized=normalized)
    return torch.matmul(_mel_filterbank_on(sample_rate, n_fft, n_mels, x.device), spec)


@functools.lru_cache(maxsize=None)
def _mel_filterbank_on(sample_rate: int, n_fft: int, n_mels: int, device) -> torch.Tensor:
    """mel_filterbank on `device`; read only."""
    return torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels)).to(device)
