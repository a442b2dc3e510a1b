"""Audio quality metrics, held against the JAX package's `utils/metrics.py`:
SI-SNR and the L1 log-mel distance on the device, STOI on the host (numpy
and scipy, as in JAX)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.stft import melspectrogram

__all__ = ["si_snr", "mel_distance", "stoi"]


def si_snr(est, ref, eps: float = 1e-8):
    """Scale-invariant SNR in dB of est against ref, both (..., T). Higher
    is better."""
    est = est - est.mean(-1, keepdim=True)
    ref = ref - ref.mean(-1, keepdim=True)
    proj = ((est * ref).sum(-1, keepdim=True) / ((ref * ref).sum(-1, keepdim=True) + eps)) * ref
    noise = est - proj
    ratio = ((proj * proj).sum(-1) + eps) / ((noise * noise).sum(-1) + eps)
    return 10.0 * torch.log10(ratio)


def mel_distance(est, ref, sample_rate: int, n_fft: int = 1024, hop_length: int = 256,
                 n_mels: int = 64, eps: float = 1e-5):
    """Mean L1 distance of the log-mel spectrograms of est and ref, both
    (..., T). Lower is better."""
    me = melspectrogram(est, sample_rate, n_fft, hop_length, n_mels=n_mels)
    mr = melspectrogram(ref, sample_rate, n_fft, hop_length, n_mels=n_mels)
    return (torch.log(me + eps) - torch.log(mr + eps)).abs().mean()


# STOI's constants (Taal et al. 2011)
_FS = 10000            # the metric's own rate
_N_FRAME = 256         # 25.6 ms window, 50% overlap
_N_FFT = 512
_NUM_BANDS = 15        # one-third octave bands from 150 Hz
_MIN_FREQ = 150.0
_SEG = 30              # 384 ms analysis segments
_BETA = -15.0          # lower SDR clip bound (dB)
_DYN_RANGE = 40.0      # silent-frame removal threshold (dB)


def stoi(est, ref, sample_rate: int) -> float:
    """Short-Time Objective Intelligibility of est against ref, (T,) or
    (B, T) arrays or tensors at `sample_rate` (resampled to 10 kHz inside),
    in float64 on the host: about 0 to 1, higher is better; the mean over
    the rows of a batch; NaN when fewer than 30 non-silent frames remain."""
    from scipy.signal import resample_poly

    est = np.asarray(est.detach().cpu() if isinstance(est, torch.Tensor) else est, np.float64)
    ref = np.asarray(ref.detach().cpu() if isinstance(ref, torch.Tensor) else ref, np.float64)
    if est.ndim == 2:
        return float(np.mean([stoi(e, r, sample_rate) for e, r in zip(est, ref)]))
    if sample_rate != _FS:
        g = math.gcd(int(sample_rate), _FS)
        est = resample_poly(est, _FS // g, sample_rate // g)
        ref = resample_poly(ref, _FS // g, sample_rate // g)

    # drop the frames where the clean signal is silent
    win = np.hanning(_N_FRAME + 2)[1:-1]
    hop = _N_FRAME // 2
    n_frames = (len(ref) - _N_FRAME) // hop + 1
    if n_frames < _SEG:
        return float("nan")
    idx = np.arange(_N_FRAME)[None, :] + hop * np.arange(n_frames)[:, None]
    ref_f, est_f = ref[idx] * win, est[idx] * win
    energy = 20 * np.log10(np.linalg.norm(ref_f, axis=1) + 1e-12)
    keep = energy > (energy.max() - _DYN_RANGE)
    ref_f, est_f = ref_f[keep], est_f[keep]
    if ref_f.shape[0] < _SEG:
        return float("nan")

    x_pow = np.abs(np.fft.rfft(ref_f, _N_FFT, axis=1)) ** 2
    y_pow = np.abs(np.fft.rfft(est_f, _N_FFT, axis=1)) ** 2
    cf = _MIN_FREQ * 2.0 ** (np.arange(_NUM_BANDS) / 3.0)
    lo, hi = cf * 2 ** (-1 / 6), cf * 2 ** (1 / 6)
    freqs = np.fft.rfftfreq(_N_FFT, 1.0 / _FS)
    bands = np.stack([(freqs >= a) & (freqs < b) for a, b in zip(lo, hi)])
    xb = np.sqrt(x_pow @ bands.T + 1e-12)  # (frames, bands)
    yb = np.sqrt(y_pow @ bands.T + 1e-12)

    scores = []
    clip = 10 ** (-_BETA / 20.0)
    for m in range(_SEG, xb.shape[0] + 1):
        x, y = xb[m - _SEG: m], yb[m - _SEG: m]  # (SEG, bands)
        alpha = np.linalg.norm(x, axis=0) / (np.linalg.norm(y, axis=0) + 1e-12)
        y = np.minimum(y * alpha, x * (1 + clip))
        xn, yn = x - x.mean(0), y - y.mean(0)
        num = np.sum(xn * yn, axis=0)
        den = np.linalg.norm(xn, axis=0) * np.linalg.norm(yn, axis=0) + 1e-12
        scores.append(np.mean(num / den))
    return float(np.mean(scores))
